"""ModernBERT's work counts for the yardstick: the model operations of a
text, the operations and bytes of each attention and GeGLU launch, and the
exact token count of a page of the long-ingest traffic.

FLOPs are the model's (2 a multiply-add), at the widths of the
configuration's published keys: the projections take 2·(3H² + H² + 2HI +
IH) a token and layer (220.6 M a token over ModernBERT-base's 22 layers),
and the scores and the weighted sum 4·H for each key a token attends to:
every key of its sequence in a global layer (layer i % n == 0), the keys
within local_attention // 2 positions in a local one, the band cut at the
sequence's edges.
"""

from __future__ import annotations

import numpy as np

from benchmark import texts


def band_keys(n: int, window: int | None) -> int:
    """Keys the n tokens of a sequence attend to, over all of them."""
    if window is None:
        return n * n
    i = np.arange(n)
    return int((np.minimum(i + window, n - 1) - np.maximum(i - window, 0)
                + 1).sum())


def layer_kinds(config: dict) -> tuple[int, int]:
    """(global layers, local layers)."""
    L, every = config["num_hidden_layers"], config["global_attn_every_n_layers"]
    n_global = (L + every - 1) // every
    return n_global, L - n_global


def projection_flops(config: dict) -> int:
    """Operations of one token's projections through every layer."""
    H, I = config["hidden_size"], config["intermediate_size"]
    return 2 * config["num_hidden_layers"] * (4 * H * H + 3 * H * I)


def encoder_flops(n_tokens: int, config: dict) -> int:
    """Model operations of one text of n tokens through the encoder."""
    H = config["hidden_size"]
    n_global, n_local = layer_kinds(config)
    w = config["local_attention"] // 2
    return (n_tokens * projection_flops(config)
            + 4 * H * (n_global * band_keys(n_tokens, None)
                       + n_local * band_keys(n_tokens, w)))


def attention_work(keys: int, real: int, B: int, S: int, H: int
                   ) -> tuple[float, float]:
    """(operations, bytes) of one attention launch over a (B, S) batch
    whose `real` tokens attend to `keys` keys in all: 4·H a key; q, k and
    v of the real tokens read once and the (B, S) context written once,
    in bf16."""
    return 4.0 * H * keys, 2.0 * H * (3 * real + B * S)


def geglu_work(B: int, S: int, config: dict) -> tuple[float, float]:
    """(operations, bytes) of one GeGLU FFN's launches at (B, S): its two
    projections (H -> 2I, I -> H) over every row; Wi and Wo2 in bf16, the
    normalized input (bf16) read, the GeGLU's (M, I) bf16 written and read
    back, the f32 residual read and written, the next norm's bf16
    written."""
    H, I = config["hidden_size"], config["intermediate_size"]
    M = B * S
    flops = 2.0 * M * 3 * H * I
    weights = 2.0 * 3 * H * I
    acts = M * (2 * H + 2 * 2 * I + 4 * H + 4 * H + 2 * H)
    return flops, weights + acts


# -- tokens of a page of warc-ingest-long, by construction ---------------

def token_count(text: str, words: frozenset) -> int:
    """Byte-level BPE pieces of `text` under the synthetic tokenizer.json
    (kinds/warc_ingest_long.py::tokenizer_json): its merges join a space
    and a word of `words` (any prefix of one: its merges build each word a
    letter at a time) into one piece and nothing else, so every other byte
    is a piece of its own. `text` holds ASCII
    letters, digits, spaces, newlines and punctuation only; the
    pre-tokenizer's runs are GPT-2's (a space leads a run of letters,
    digits or punctuation; a run of spaces before a non-space leaves its
    last space to that run)."""
    n, i, count = len(text), 0, 0
    while i < n:
        c = text[i]
        if c.isspace():
            j = i
            while j < n and text[j].isspace():
                j += 1
            if j == n:
                count += j - i
                i = j
                continue
            if j - i > 1:
                count += j - i - 1
            i = j - 1
            if text[i] != " ":
                count += 1
                i += 1
                continue
            lead = 1
            c = text[i + 1]
        else:
            lead = 0
        j = i + lead
        kind = c.isalpha(), c.isdigit()
        while j < n and not text[j].isspace() and \
                (text[j].isalpha(), text[j].isdigit()) == kind:
            j += 1
        run = text[i + lead:j]
        k = 0  # the longest prefix of the run that a merge chain joins
        if lead and kind[0]:
            k = next((k for k in range(len(run), 0, -1)
                      if run[:k] in words), 0)
        count += 1 + len(run) - k if k else lead + len(run.encode())
        i = j
    return count


def page_tokens(prompt: str, title: str, text: str, words: frozenset,
                max_len: int) -> int:
    """Tokens the node encodes for a stored page: [CLS], the document
    prompt, the title, a newline and the text, [SEP], cut at max_len."""
    return min(max_len, token_count(f"{prompt}{title}\n{text}", words) + 2)


def vocab_words() -> frozenset:
    """The words that the synthetic tokenizer makes one piece after a
    space, and every prefix of them (its merges build each word a letter
    at a time)."""
    out = set()
    for w in texts.STOPWORDS + tuple(texts.words()):
        for k in range(1, len(w) + 1):
            out.add(w[:k])
    return frozenset(out)
