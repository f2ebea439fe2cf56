"""The reference against HF transformers' BertModel and MPNetModel at
small widths on the CPU, on the harness's own seeded weights and vocab:
the same mean-pooled, normalized embeddings, and the frozen WordPiece
against the vocab's rule."""

import numpy as np
import pytest
import torch

from benchmark import texts, weights
from benchmark.kinds import warc_ingest
from benchmark.reference import encoder
from benchmark.reference.search import exact_topk
from benchmark.reference.wordpiece import WordPiece
from benchmark.tests.conftest import TRAFFIC

torch.set_num_threads(2)

SMALL = {
    "bert": {"model_type": "bert", "hidden_size": 64, "num_hidden_layers": 2,
             "num_attention_heads": 4, "intermediate_size": 128,
             "max_position_embeddings": 512, "type_vocab_size": 2,
             "layer_norm_eps": 1e-12, "pad_token_id": 0,
             "vocab_size": 30522},
    "mpnet": {"model_type": "mpnet", "hidden_size": 64,
              "num_hidden_layers": 2, "num_attention_heads": 4,
              "intermediate_size": 128, "max_position_embeddings": 514,
              "layer_norm_eps": 1e-5, "pad_token_id": 1,
              "relative_attention_num_buckets": 32, "vocab_size": 30527}}
TEXTS = ["the lighthouse keeper climbed the stairs", "coffee",
         "a storm over the black rocks near the harbor at night, again!",
         " ".join(["river"] * 200)]


def _hf(kind: str, cfg: dict, W: dict):
    transformers = pytest.importorskip("transformers")
    if kind == "bert":
        hf_cfg = transformers.BertConfig(**{k: v for k, v in cfg.items()
                                            if k != "model_type"},
                                         hidden_act="gelu")
        model = transformers.BertModel(hf_cfg, add_pooling_layer=False)
    else:
        hf_cfg = transformers.MPNetConfig(**{k: v for k, v in cfg.items()
                                             if k != "model_type"},
                                          hidden_act="gelu")
        model = transformers.MPNetModel(hf_cfg, add_pooling_layer=False)
    missing, _ = model.load_state_dict(W, strict=False)
    assert not [m for m in missing if "position_ids" not in m], missing
    return model.eval()


@pytest.mark.parametrize("kind", ["bert", "mpnet"])
def test_reference_matches_transformers(kind):
    cfg = SMALL[kind]
    W = weights.make(cfg, 1234, torch.device("cpu"))
    tok = WordPiece(texts.vocab_for(cfg))
    ids = [tok.encode(t) for t in TEXTS]
    got = encoder.embed(W, cfg, ids, torch.device("cpu"), tok.pad_id,
                        batch_tokens=600)
    model = _hf(kind, cfg, W)
    for row, t in zip(got, ids):
        x = torch.tensor([t])
        with torch.no_grad():
            h = model(input_ids=x, attention_mask=torch.ones_like(x))[0]
        want = torch.nn.functional.normalize(h.mean(1), dim=-1)[0]
        assert torch.allclose(row, want, atol=2e-6), (row - want).abs().max()


def test_padding_leaves_each_row_as_alone():
    cfg = SMALL["mpnet"]
    W = weights.make(cfg, 7, torch.device("cpu"))
    tok = WordPiece(texts.vocab_for(cfg))
    ids = [tok.encode(t) for t in TEXTS]
    together = encoder.embed(W, cfg, ids, "cpu", tok.pad_id)
    for j, t in enumerate(ids):
        alone = encoder.embed(W, cfg, [t], "cpu", tok.pad_id)[0]
        assert torch.allclose(together[j], alone, atol=1e-6)


def test_wordpiece_counts_by_the_vocab_rule():
    tok = WordPiece(texts.vocab_for({"model_type": "bert",
                                     "vocab_size": 30522}))
    mix = TRAFFIC["tiny-ingest"]
    pages = texts.Pages(3, 80, **{k: mix[k] for k in warc_ingest.PAGE_KEYS})
    for i in np.flatnonzero(pages.kept()).tolist():
        _, title, text = pages.stored(i)
        assert len(tok.encode(f"{title}\n{text}")) == \
            texts.combined_tokens(title, text)
    assert tok.encode("Rock, near Zanzibar!")[1:-1] == [
        tok.vocab["rock"], tok.vocab[","], tok.vocab["near"], tok.unk_id,
        tok.vocab["!"]]


def test_mpnet_vocab_specials():
    tok = WordPiece(texts.vocab_for(SMALL["mpnet"]))
    assert (tok.cls_id, tok.pad_id, tok.sep_id) == (0, 1, 2)
    assert tok.unk_id == 4 + 100  # the body's [UNK], as HF MPNetTokenizer


def test_exact_topk_blocks_agree_with_a_full_sort():
    g = torch.Generator().manual_seed(0)
    store = torch.nn.functional.normalize(torch.randn(1000, 16, generator=g),
                                          dim=1)
    q = torch.nn.functional.normalize(torch.randn(3, 16, generator=g), dim=1)
    d, i = exact_topk(store, q, 10, block=128)
    want = torch.sort(1 - q @ store.T, dim=1).values[:, :10]
    assert torch.allclose(d, want)
    assert np.array_equal(np.sort(i.numpy(), 1),
                          np.sort(torch.topk(q @ store.T, 10).indices.numpy(),
                                  1))
