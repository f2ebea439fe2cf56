"""Qwen3 (models/qwen3.py) on the port's CPU route, at a small size with
seeded weights: H 256, 2 query heads of 128 over 1 key/value head, I 384,
3 layers, S up to 40 with ragged lengths.

- reference/qwen3_plain.py against HF's Qwen3Model (eager attention, the
  same weights): the last hidden state within 1e-5, so the reference is
  held to the published code;
- the port's CPU route (the plain twins, f32) against the reference: the
  embeddings within 1e-5 (both f32; the port applies each input norm's
  row scale after its product, and sums in another order);
- a page alone gives its embedding in a padded batch; planted faults (no
  QK-norm, the wrong key/value head, a bidirectional mask, the first
  token pooled) each miss the reference by more than 100x the bound;
- the weights loader with and without HF's `model.` prefix (lm_head
  ignored), from F32 and BF16 files; the configs it refuses;
- the encoder's padding rows and budgets: the dispatch budget and the
  insert batch follow from the model's FLOPs, ModernBERT's plan and both
  existing cells' insert batches unchanged; the ingest pipeline cuts and
  merges by it; a node serving a Qwen3 model_dir over HTTP.
"""

import dataclasses
import json
import os
import struct
import sys
import urllib.parse
import urllib.request

import numpy as np
import pytest
import torch

from dawnsearch_tpu_torch.config import Config
from dawnsearch_tpu_torch.models import encoder as E
from dawnsearch_tpu_torch.models import qwen3 as M
from dawnsearch_tpu_torch.models.weights import config_from_hf, load_params
from dawnsearch_tpu_torch.ops import qwen3 as q3

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from reference import qwen3_plain as R  # noqa: E402

torch.set_num_threads(2)
BOUND = 1e-5
HF = dict(vocab_size=300, hidden_size=256, num_hidden_layers=3,
          num_attention_heads=2, num_key_value_heads=1, head_dim=128,
          intermediate_size=384, max_position_embeddings=128,
          rms_norm_eps=1e-6, rope_theta=1000000.0, hidden_act="silu",
          attention_bias=False, use_sliding_window=False,
          tie_word_embeddings=False)
# four query heads over two key/value heads: a wrong pairing shows
HF_GQA = dict(HF, hidden_size=512, num_attention_heads=4,
              num_key_value_heads=2)
LENS = (40, 17, 3)
EOS = 299


def _weights(hf=HF, seed: int = 0) -> dict:
    """HF-named tensors (bare): matrices std 0.1 (so each layer moves the
    state), norm weights 1 + N(0, 0.1)."""
    g = torch.Generator().manual_seed(seed)
    cfg = M.config_from_hf(hf, "test")
    return {name: (1 + 0.1 * torch.randn(shape, generator=g))
            if len(shape) == 1 else 0.1 * torch.randn(shape, generator=g)
            for name, shape in M.hf_shapes(cfg).items()}


def _batch(seed: int = 1):
    """Right-padded ids, each row ending in EOS at its length."""
    g = torch.Generator().manual_seed(seed)
    S = max(LENS)
    mask = (torch.arange(S)[None] < torch.tensor(LENS)[:, None]).long()
    ids = torch.randint(5, HF["vocab_size"] - 1, (len(LENS), S), generator=g)
    for r, n in enumerate(LENS):
        ids[r, n - 1] = EOS
    return torch.where(mask.bool(), ids, EOS), mask


def _port(W, hf=HF, **cfg_over):
    cfg = dataclasses.replace(M.config_from_hf(hf, "test"), **cfg_over)
    return M.Qwen3Model(cfg, M.from_hf_tensors(W, cfg), device="cpu")


def _ref(W, hf, ids, mask):
    return R.embed(W, hf, [ids[r, :int(mask[r].sum())].tolist()
                           for r in range(ids.shape[0])])


@pytest.mark.parametrize("seed", [0, 1])
def test_reference_matches_hf(seed):
    transformers = pytest.importorskip("transformers")
    cfg = transformers.Qwen3Config(**HF, attn_implementation="eager")
    hf = transformers.Qwen3Model(cfg).eval()
    W = _weights(seed=seed)
    hf.load_state_dict(W)
    ids, mask = _batch(seed)
    for r, n in enumerate(LENS):
        with torch.no_grad():
            want = hf(input_ids=ids[r:r + 1, :n]).last_hidden_state[0]
        got = R.hidden_states(W, HF, ids[r, :n])
        assert float((got - want).abs().max()) <= BOUND


@pytest.mark.parametrize("seed", [0, 1])
def test_port_cpu_route_matches_reference(seed):
    W = _weights(seed=seed)
    ids, mask = _batch(seed)
    got = _port(W)(ids, mask)
    assert got.dtype == torch.float32 and got.shape == (3, 256)
    assert float((got - _ref(W, HF, ids, mask)).abs().max()) <= BOUND


def test_a_page_alone_equals_it_in_a_padded_batch():
    W = _weights()
    ids, mask = _batch()
    model = _port(W)
    batch = model(ids, mask)
    for r, n in enumerate(LENS):
        alone = model(ids[r:r + 1, :n], mask[r:r + 1, :n])
        assert float((alone[0] - batch[r]).abs().max()) <= 1e-6


def _no_qk_norm(a, ssq, w, qn, kn, cos, sin, S, nh, nkv, eps):
    return q3.qkv_norm_rope_plain(a, ssq, w, torch.ones_like(qn),
                                  torch.ones_like(kn), cos, sin, S, nh, nkv,
                                  1e30)


def _wrong_kv_head(qkv, lens, B, S, nh, nkv):
    hd = q3.HEAD_DIM
    t = qkv.view(B, S, nh + 2 * nkv, hd)
    kv = t[:, :, nh:].view(B, S, 2, nkv, hd).flip(3).reshape(B, S, -1, hd)
    return q3.attention_plain(torch.cat((t[:, :, :nh], kv), 2).reshape(
        B * S, -1), lens, B, S, nh, nkv)


def _bidirectional(qkv, lens, B, S, nh, nkv):
    hd = q3.HEAD_DIM
    t = qkv.float().view(B, S, nh + 2 * nkv, hd).transpose(1, 2)
    q, k, v = t[:, :nh], t[:, nh:nh + nkv], t[:, nh + nkv:]
    k = k.repeat_interleave(nh // nkv, 1)
    v = v.repeat_interleave(nh // nkv, 1)
    keep = torch.arange(S)[None, :] < lens.long()[:, None]
    s = (q @ k.transpose(-1, -2)) / hd ** 0.5
    s = s.masked_fill(~keep[:, None, None], float("-inf"))
    return (torch.softmax(s, -1) @ v).transpose(1, 2).reshape(B * S, -1)


def _first_token(x, lens, S, w, eps):
    return q3.last_pool_plain(x, torch.ones_like(lens), S, w, eps)


@pytest.mark.parametrize("fault,fn", [
    ("qkv_norm_rope", _no_qk_norm), ("attention", _wrong_kv_head),
    ("attention", _bidirectional), ("last_pool", _first_token)])
def test_planted_faults_miss_the_reference(fault, fn, monkeypatch):
    W = _weights(HF_GQA)
    ids, mask = _batch()
    model = _port(W, HF_GQA)
    want = _ref(W, HF_GQA, ids, mask)
    assert float((model(ids, mask) - want).abs().max()) <= BOUND
    monkeypatch.setattr(q3, fault, fn)
    assert float((model(ids, mask) - want).abs().max()) > 100 * BOUND


def test_causal_twin_counts_its_keys():
    B, S, nh, nkv = 2, 24, 4, 2
    g = torch.Generator().manual_seed(3)
    qkv = torch.randn(B * S, (nh + 2 * nkv) * 128, generator=g)
    lens = torch.tensor([24, 13], dtype=torch.int32)
    got = q3.attention_plain(qkv, lens, B, S, nh, nkv)
    live = (torch.arange(S)[None] < lens[:, None]).reshape(-1)
    assert not got[~live].any()
    # row 0 of each sequence attends to itself alone: its v head
    for b in range(B):
        row = qkv[b * S].view(nh + 2 * nkv, 128)
        for j in range(nh):
            assert torch.allclose(got[b * S, j * 128:(j + 1) * 128],
                                  row[nh + nkv + j // 2], atol=1e-6)
    assert M.causal_keys(13) == 13 * 14 // 2


def _write_safetensors(tensors: dict, path, bf16: bool) -> None:
    header, blobs, off = {}, [], 0
    for name, t in tensors.items():
        if bf16:
            raw = (t.float().contiguous().view(torch.int32) >> 16).to(
                torch.int16).numpy().tobytes()
        else:
            raw = t.float().contiguous().numpy().tobytes()
        header[name] = {"dtype": "BF16" if bf16 else "F32",
                        "shape": list(t.shape),
                        "data_offsets": [off, off + len(raw)]}
        blobs.append(raw)
        off += len(raw)
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)) + head + b"".join(blobs))


def _model_dir(tmp_path, prefix: str = "", bf16: bool = False):
    W = _weights()
    if bf16:  # bf16 values, which the file then holds exactly
        W = {k: (v.float().view(torch.int32) >> 16 << 16).view(torch.float32)
             for k, v in W.items()}
    d = tmp_path / "model"
    d.mkdir()
    (d / "config.json").write_text(json.dumps(dict(HF, model_type="qwen3")))
    extra = {"lm_head.weight": torch.zeros(HF["vocab_size"], 256)}
    _write_safetensors({**{prefix + k: v for k, v in W.items()}, **extra},
                       d / "model.safetensors", bf16)
    return d, W


@pytest.mark.parametrize("prefix,bf16", [("", False), ("model.", False),
                                         ("", True), ("model.", True)])
def test_loader_reads_hf_names(tmp_path, prefix, bf16):
    d, W = _model_dir(tmp_path, prefix, bf16)
    params, pretrained, cfg = load_params(str(d))
    assert pretrained and cfg.model_type == "qwen3"
    assert (cfg.num_layers, cfg.num_kv_heads, cfg.head_dim) == (3, 1, 128)
    assert sorted(params) == sorted(M.hf_shapes(cfg))
    for name, t in params.items():
        assert torch.equal(M.to_device(t, "cpu", torch.float32), W[name])
    model = M.Qwen3Model(cfg, params, device="cpu")
    ids, mask = _batch()
    assert float((model(ids, mask) - _ref(W, HF, ids, mask)).abs().max()) \
        <= BOUND


@pytest.mark.parametrize("bad", [{"attention_bias": True},
                                 {"use_sliding_window": True},
                                 {"hidden_act": "gelu"},
                                 {"head_dim": 64},
                                 {"rope_scaling": {"type": "yarn"}}])
def test_config_refuses_what_the_port_does_not_compute(tmp_path, bad):
    (tmp_path / "config.json").write_text(json.dumps(dict(
        HF, model_type="qwen3", **bad)))
    with pytest.raises(ValueError, match="Qwen3|supported|head"):
        config_from_hf(str(tmp_path))


def test_card_routes_refuse_f32_and_the_per_op_path():
    cfg = M.config_from_hf(HF, "test")
    with pytest.raises(ValueError, match="bf16"):
        M.route(cfg, "cuda")
    with pytest.raises(ValueError, match="layer_impl"):
        M.route(dataclasses.replace(cfg, layer_impl="ops",
                                    dtype=torch.bfloat16), "cuda")
    assert M.route(cfg, "cpu") == "plain"


# -- the encoder: padding rows, budgets, the insert batch ------------------

class _Tok:
    """A tokenizer with Qwen3's template: pieces, then <|endoftext|>."""
    pad_id = cls_id = sep_id = EOS
    lead = False

    def encode(self, text, max_len=None):
        return self.encode_counted(text, max_len)[0]

    def encode_counted(self, text, max_len=None):
        ids = [5 + (hash(w) % 200) for w in text.split()]
        n = len(ids) + 1
        ids = ids if max_len is None else ids[:max_len - 1]
        return [*ids, EOS], n


def _encoder(buckets=(16, 32, 64), **kw):
    cfg = M.config_from_hf(dict(HF, max_position_embeddings=max(buckets)),
                           "t")
    return E.SentenceEncoder(M.init_params(torch.Generator().manual_seed(0),
                                           cfg), _Tok(), cfg=cfg,
                             seq_buckets=buckets, device="cpu", **kw)


def test_padding_rows_and_warmup_hold_the_closing_special_alone():
    enc = _encoder()
    ids, mask, real = enc.pad_counted([[7, 8, EOS]] * 3)
    assert ids.shape == (8, 16) and real == 9
    assert (ids[3:, 0] == EOS).all() and (mask[3:].sum(1) == 1).all()
    assert enc.padding_row() == [EOS]
    assert enc.warmup(max_batch=8) == 6
    emb = enc.encode(["a b c", "d"])
    assert np.allclose(np.linalg.norm(emb, axis=1), 1.0, atol=1e-5)


def test_the_dispatch_budget_and_insert_batch_follow_the_model():
    """DISPATCH_FLOPS binds for Qwen3-Embedding-8B (13.9 GFLOP a token:
    65,536 padded tokens, 8 rows of 8,192) and not for ModernBERT-base
    (0.22 G: TOKEN_BUDGET's 524,288, its plan as before); an insert batch
    holds INSERT_DISPATCHES dispatches of Qwen3's real tokens and never
    binds for ModernBERT's 2,048 pages at 8,192."""
    from dawnsearch_tpu_torch.models.modernbert import MODERNBERT_BASE
    Q = M.QWEN3_EMBEDDING_8B
    assert E.projection_flops(Q) == 2 * 36 * (4096 * 6144 + 4096 * 4096
                                              + 3 * 4096 * 12288)
    assert E.token_budget(Q, 8192) == 65536
    assert E.token_budget(MODERNBERT_BASE, 8192) == E.TOKEN_BUDGET == 524288
    assert E.insert_tokens(Q) == 4 * 10 ** 15 // E.projection_flops(Q)
    assert 250_000 < E.insert_tokens(Q) < 300_000
    assert E.insert_tokens(MODERNBERT_BASE) > 2048 * 8192
    enc = _encoder((16, 64, 512, 1024))
    assert enc.long_grid and enc.insert_tokens == E.insert_tokens(enc.cfg)
    assert _encoder((16, 64, 512)).insert_tokens is None


def test_qwen3_plan_keeps_the_model_budget(monkeypatch):
    monkeypatch.setattr(E, "DISPATCH_FLOPS",
                        2048 * E.projection_flops(M.config_from_hf(HF, "t")))
    enc = _encoder((16, 64, 512, 1024))
    assert enc.token_budget == 2048
    rng = np.random.default_rng(1)
    lengths = [int(x) for x in rng.integers(2, 1024, 300)]
    plan = enc.plan_dispatches(list(range(300)), lengths, 1024)
    assert sorted(r for p in plan for r in p) == list(range(300))
    for p in plan:
        S = enc._bucket(enc.seq_buckets, max(lengths[r] for r in p))
        assert enc._bucket(enc.batch_buckets, len(p)) * S <= 2048


def test_fused_ingest_spans_carry_the_host_lengths():
    """A Qwen3 encoder through the fused ingest path while spans are
    recorded: each layer gives an encoder.proj span of kind qkv and one of
    kind out, an encoder.attn span of kind causal whose `real` and `keys`
    are summed from the batch's host lengths (n(n + 1) / 2 a text), and
    an encoder.ffn span, all under the dispatch's encoder.forward."""
    from dawnsearch_tpu_torch.index.flat import FlatIndex
    from dawnsearch_tpu_torch.serving.fused import FusedIngestPath
    from dawnsearch_tpu_torch.utils.logging import SPANS
    enc = _encoder((16, 32, 64))
    texts = [" ".join(["w"] * n) for n in (40, 17, 3, 9, 25, 1, 60, 12)]
    lengths = [len(i) for i in enc.tokenize_texts(texts)]
    path = FusedIngestPath(enc, FlatIndex(dim=enc.dim, device="cpu"))
    SPANS.start()
    try:
        path.ingest(texts)
    finally:
        SPANS.stop()
        events, _ = SPANS.take()
    args = {}
    for name, *_, a, _ph in events:
        args.setdefault(name, []).append(a)
    assert args["encoder.forward"] == [{"B": 8, "S": 64,
                                        "real": sum(lengths)}]
    L = HF["num_hidden_layers"]
    assert [a["kind"] for a in args["encoder.proj"]] == ["qkv", "out"] * L
    assert args["encoder.ffn"] == [{"B": 8, "S": 64}] * L
    assert args["encoder.attn"] == [{
        "kind": "causal", "B": 8, "S": 64, "heads": 2, "kv_heads": 1,
        "real": sum(lengths),
        "keys": sum(M.causal_keys(n) for n in lengths)}] * L


class _Service:
    def __init__(self):
        self.max_ingest_batch = 1024
        self.batches = []

    def insert_pages(self, pages, token_ids=None):
        self.batches.append((len(pages), sum(map(len, token_ids or []))))


@pytest.mark.parametrize("limit", [None, 100])
def test_insert_thread_cuts_and_merges_by_work(limit):
    """With a token limit, waiting batches merge only while their tokens
    fit it and a batch past it is cut into inserts that fit it (a page
    alone may pass it); without one (a short grid, or ModernBERT, whose
    limit no batch reaches) batches merge up to coalesce_max pages as
    before."""
    from dawnsearch_tpu_torch.ingest.extraction_service import \
        ExtractionService
    svc = _Service()
    ex = ExtractionService(svc, source=object(), batch_size=8,
                           insert_tokens=limit)
    assert ex.insert_tokens == limit and ex.coalesce_max == 2048
    sizes = [[30, 30, 30, 30], [10, 10], [150], [20]]
    for k, lens in enumerate(sizes):
        triples = [(f"u{k}.{i}", "", "") for i in range(len(lens))]
        ex._ready.put(("batch", f"f{k}", triples, [[1] * n for n in lens],
                       (k,)))
    ex._ready.put(("mark", "", None, None, ()))  # ends the last merge
    ex._ready.put(None)
    ex._insert_loop()
    if limit is None:
        assert svc.batches == [(8, 310)]
    else:
        assert svc.batches == [(3, 90), (1, 30), (2, 20), (1, 150), (1, 20)]
        assert ex._cuts([[1] * 60] * 5, 5) == [(0, 1), (1, 2), (2, 3),
                                               (3, 4), (4, 5)]


# -- a node ----------------------------------------------------------------

def _http(url, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def qwen_tokenizer_json(vocab_size: int, eos: int, words) -> dict:
    """A tokenizer.json of Qwen3's layout: the NFC normalizer, a Split on
    Qwen2's pattern before a ByteLevel without its regex, the template
    `$A <|endoftext|>`; 256 byte tokens and merges that make each word
    (alone and after a space) one token, <|endoftext|> at `eos`."""
    from dawnsearch_tpu_torch.models.tokenizer_bpe import (QWEN2_PATTERN,
                                                           byte_to_unicode)
    b2u = byte_to_unicode()
    vocab = {b2u[b]: b for b in range(256)}
    merges = []
    for w in words:
        for lead in ("", " "):
            prev = ""
            for ch in "".join(b2u[b] for b in (lead + w).encode()):
                if prev and prev + ch not in vocab:
                    merges.append(f"{prev} {ch}")
                    vocab[prev + ch] = len(vocab)
                prev += ch
    assert len(vocab) <= eos < vocab_size
    special = {"id": "<|endoftext|>", "type_id": 0}
    return {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": [{"id": eos, "content": "<|endoftext|>",
                          "single_word": False, "lstrip": False,
                          "rstrip": False, "normalized": False,
                          "special": True}],
        "normalizer": {"type": "NFC"},
        "pre_tokenizer": {"type": "Sequence", "pretokenizers": [
            {"type": "Split", "pattern": {"Regex": QWEN2_PATTERN},
             "behavior": "Isolated", "invert": False},
            {"type": "ByteLevel", "add_prefix_space": False,
             "trim_offsets": False, "use_regex": False}]},
        "post_processor": {
            "type": "TemplateProcessing",
            "single": [{"Sequence": {"id": "A", "type_id": 0}},
                       {"SpecialToken": special}],
            "pair": [{"Sequence": {"id": "A", "type_id": 0}},
                     {"Sequence": {"id": "B", "type_id": 1}},
                     {"SpecialToken": special}],
            "special_tokens": {"<|endoftext|>": {
                "id": "<|endoftext|>", "ids": [eos],
                "tokens": ["<|endoftext|>"]}}},
        "decoder": {"type": "ByteLevel", "add_prefix_space": False,
                    "trim_offsets": False, "use_regex": False},
        "model": {"type": "BPE", "dropout": None, "unk_token": None,
                  "continuing_subword_prefix": "", "end_of_word_suffix": "",
                  "fuse_unk": False, "byte_fallback": False,
                  "ignore_merges": False, "vocab": vocab, "merges": merges}}


def test_node_serves_a_qwen3_model_dir(tmp_path):
    """A node on a model_dir of config.json (model_type qwen3),
    model.safetensors (BF16) and a tokenizer.json of Qwen3's layout, with
    the query prompt set: make_encoder builds Qwen3Model and the BPE with
    Qwen2's pre-tokenizer and no leading special, and an inserted page
    comes back at rank 1 for its own text under the prompt."""
    from dawnsearch_tpu_torch.node import DawnNode
    d, _ = _model_dir(tmp_path, "model.", bf16=True)
    words = ("the", "cat", "dog", "sat", "on", "mat", "log", "ran")
    (d / "tokenizer.json").write_text(json.dumps(
        qwen_tokenizer_json(HF["vocab_size"], EOS, words)))
    cfg = Config(device="cpu", web=True, web_listen_address="127.0.0.1:0",
                 accept_insert=True, data_dir=str(tmp_path / "data"),
                 model_dir=str(d), compute_dtype="f32",
                 seq_buckets=(16, 32, 64), document_prompt="",
                 query_prompt="Instruct: find the page\nQuery:")
    texts = ["the cat sat on the mat " * (k + 1) + "ran" * k
             for k in range(6)] + ["dog log ran " * 5, "mat on log sat"]
    node = DawnNode(cfg).start()
    try:
        enc = node.encoder
        assert isinstance(enc.model, M.Qwen3Model)
        assert enc.tokenizer.lead is False and enc.tokenizer.sep_id == EOS
        assert enc.tokenize_texts(["the cat"])[0][-1] == EOS
        base = f"http://127.0.0.1:{node.http_port}"
        pages = [{"url": f"https://m/{i}", "title": "", "text": t}
                 for i, t in enumerate(texts)]
        assert len(_http(base + "/api/insert",
                         {"pages": pages})["inserted"]) == len(texts)
        got = _http(base + "/api/search?q=" + urllib.parse.quote(texts[6]))
        assert got["results"][0]["url"] == "https://m/6"
    finally:
        node.stop()
