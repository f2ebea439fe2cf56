"""compute_dtype = "f32" through the port's node, against the reference.

A node set to f32 builds every encoder kernel's f32 instance on a card;
on the CPU each wrapper runs its plain twin, which is what is held to the
reference here. A small checkpoint (H=128, 4 heads of 32, I=256, 2
layers, inside the whole-layer kernel's envelope) is written to a
model_dir from one seeded numpy tree (params_from_numpy, the port's
safetensors writer), in the BERT and in the MPNet family. The port's
make_encoder and the reference's make_encoder load it with
compute_dtype = "f32" on each route and embed the same texts: K1 (and
MPNet's K1 with rel_bias), the per-op route with and without the K8 pool,
at the reference's f32 tolerance (atol 1e-4, tests/test_bert.py); K4 at
K4's f32 bound (per-row cosine >= 0.99995, tests/test_torch_layer_i8.py).

Also: the f32 node answers a text search with the page at rank 1; the
node refuses a compute_dtype it does not know; and the fixed-order
attention twin on f32 qkv (the contract of K4's f32 attention kernel) is
bit-equal to a numpy loop that rounds each product and each sum on its
own.
"""

import json
import math
import os

import numpy as np
import pytest
import torch

from dawnsearch_tpu.config import Config as RefConfig
from dawnsearch_tpu.node import make_encoder as ref_make_encoder
from dawnsearch_tpu_torch.config import Config
from dawnsearch_tpu_torch.models.bert import BertConfig
from dawnsearch_tpu_torch.models.tokenizer import build_vocab_from_corpus
from dawnsearch_tpu_torch.models.weights import (params_from_numpy,
                                                 save_safetensors)
from dawnsearch_tpu_torch.node import DawnNode, check_config, make_encoder
from dawnsearch_tpu_torch.ops import attention, ffn, layer

torch.set_num_threads(2)

VOCAB, H, NH, I, L, P = 600, 128, 4, 256, 2, 64
SEQ = (16, 32)
COS_K4_F32 = 0.99995  # K4's f32 bound (tests/test_torch_layer_i8.py)

_rng = np.random.default_rng(6)
WORDS = sorted({"".join(_rng.choice(list("abcdefghijklmnopqrstuvwxyz"), n))
                for n in _rng.integers(3, 9, 200)})
TEXTS = [" ".join(_rng.choice(WORDS, n)) for n in (12, 3, 25, 7, 18, 9)]

FAMILIES = {
    "bert": dict(model_type="bert", pad_token_id=0, layer_norm_eps=1e-12),
    "mpnet": dict(model_type="mpnet", pad_token_id=1, layer_norm_eps=1e-5),
}


def _tree(family: str, rng: np.random.Generator) -> dict:
    def w(*shape):
        return rng.standard_normal(shape, np.float32) * 0.05

    def v(*shape, base=0.0):
        return (base + rng.standard_normal(shape, np.float32) * 0.1
                ).astype(np.float32)
    emb = {"word": w(VOCAB, H), "position": w(P + 2, H),
           "ln_scale": v(H, base=1.0), "ln_bias": v(H)}
    if family == "bert":
        emb["token_type"] = w(2, H)
    tree = {"embeddings": emb,
            "layers": {"qkv_w": w(L, H, 3 * H), "qkv_b": v(L, 3 * H),
                       "attn_out_w": w(L, H, H), "attn_out_b": v(L, H),
                       "attn_ln_scale": v(L, H, base=1.0),
                       "attn_ln_bias": v(L, H), "ffn_in_w": w(L, H, I),
                       "ffn_in_b": v(L, I), "ffn_out_w": w(L, I, H),
                       "ffn_out_b": v(L, H), "ffn_ln_scale": v(L, H, base=1.0),
                       "ffn_ln_bias": v(L, H)}}
    if family == "mpnet":
        tree["rel_bias"] = rng.standard_normal((32, NH), np.float32) * 0.5
    return tree


def _vocab(family: str) -> list:
    """VOCAB lines: the texts' WordPiece vocab ([PAD] first), behind
    MPNet's <s> <pad> </s> <unk> for that family, then filler."""
    words = build_vocab_from_corpus(TEXTS, size=VOCAB - 5)
    body = sorted(words, key=words.get)
    if family == "mpnet":
        body = ["<s>", "<pad>", "</s>", "<unk>", *body]
    return body + [f"[unused{i}]" for i in range(VOCAB - len(body))]


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def model_dir(request, tmp_path_factory):
    """A checkpoint as a user drops one into model_dir."""
    family = request.param
    d = tmp_path_factory.mktemp(f"f32-{family}")
    fam = FAMILIES[family]
    cfg = BertConfig(vocab_size=VOCAB, hidden_size=H, num_layers=L,
                     num_heads=NH, intermediate_size=I,
                     max_position_embeddings=P + 2,
                     type_vocab_size=2 if family == "bert" else 0, **fam)
    save_safetensors(params_from_numpy(_tree(family, np.random.default_rng(3))),
                     str(d / "model.safetensors"), cfg)
    config = {"model_type": family, "hidden_act": "gelu", "hidden_size": H,
              "num_hidden_layers": L, "num_attention_heads": NH,
              "intermediate_size": I, "vocab_size": VOCAB,
              "max_position_embeddings": P + 2,
              "pad_token_id": fam["pad_token_id"],
              "layer_norm_eps": fam["layer_norm_eps"]}
    if family == "mpnet":
        config["relative_attention_num_buckets"] = 32
    else:
        config["type_vocab_size"] = 2
    with open(d / "config.json", "w") as f:
        json.dump(config, f)
    (d / "vocab.txt").write_text("\n".join(_vocab(family)) + "\n",
                                 encoding="utf-8")
    return family, str(d)


ROUTES = {"layer": dict(layer_impl="layer"),
          "layer_i8": dict(layer_impl="layer_i8"),
          "ops": dict(layer_impl="ops"),
          "ops+fused pool": dict(layer_impl="ops", pool_impl="fused")}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_f32_node_encoder_matches_reference(model_dir, route):
    """make_encoder at compute_dtype="f32" embeds the texts as the
    reference's make_encoder does on the same checkpoint."""
    family, path = model_dir
    kw = dict(model_dir=path, compute_dtype="f32", seq_buckets=SEQ,
              **ROUTES[route])
    enc = make_encoder(Config(device="cpu", **kw))
    assert enc.model.cfg.dtype == torch.float32
    assert enc.model.cfg.model_type == family
    got = enc.encode(TEXTS)
    want = np.asarray(ref_make_encoder(RefConfig(**kw)).encode(TEXTS))
    assert got.shape == want.shape == (len(TEXTS), H)
    assert np.isfinite(got).all()
    if route == "layer_i8":
        cos = np.sum(got * want, axis=-1)
        assert cos.min() >= COS_K4_F32, cos
    else:
        np.testing.assert_allclose(got, want, atol=1e-4)


def test_f32_node_serves_a_page_at_rank_1(model_dir, tmp_path):
    """DawnNode with compute_dtype="f32" on the CPU: its encoder is f32,
    its kernel wrappers run their plain twins (no launch is counted), and
    a page's own text finds it first."""
    _, path = model_dir
    cfg = Config(device="cpu", data_dir=str(tmp_path), model_dir=path,
                 compute_dtype="f32", seq_buckets=SEQ)
    check_config(cfg)
    before = [dict(m.launches) for m in (layer, attention, ffn)]
    node = DawnNode(cfg).start()
    try:
        assert node.encoder.model.cfg.dtype == torch.float32
        assert node.encoder.model.layers[0].qkv_w.dtype == torch.float32
        pages = [(f"https://p/{i}", f"T{i}", t) for i, t in enumerate(TEXTS)]
        node.service.insert_pages(pages)
        got = node.service.text_search(TEXTS[5])
        assert got.pages[0].url == "https://p/5"
    finally:
        node.stop()
    assert [dict(m.launches) for m in (layer, attention, ffn)] == before


@pytest.mark.parametrize("value", ["f16", "fp32"])
def test_node_refuses_an_unknown_compute_dtype(tmp_path, value):
    """The reference reads anything but "bf16" as f32; the port refuses a
    dtype it does not know, before the data dir is touched."""
    cfg = Config(device="cpu", data_dir=str(tmp_path), compute_dtype=value)
    with pytest.raises(ValueError, match=f"unknown compute_dtype '{value}'"):
        DawnNode(cfg)
    assert not os.listdir(tmp_path)


def _numpy_fixed_order(qkv, bias, B, S, H, nh):
    """The fixed-order contract written as numpy f32 loops: every product
    and every sum rounded on its own, sums in ascending order."""
    hd = H // nh
    f = np.float32
    t = qkv.reshape(B, S, 3, nh, hd).transpose(2, 0, 3, 1, 4)  # (3,B,nh,S,hd)
    q, k, v = t[0], t[1], t[2]
    s = np.zeros((B, nh, S, S), f)
    for d in range(hd):
        s = s + q[..., d:d + 1] * k[..., d][:, :, None, :]
    s = s * f(1.0 / math.sqrt(hd))
    s = s + bias[:, None, None, :]
    # exp is the one library function the contract leaves to the platform:
    # it is taken from torch, as the twin takes it
    p = torch.exp(torch.from_numpy(s - s.max(axis=-1, keepdims=True))).numpy()
    l = np.zeros((B, nh, S, 1), f)
    o = np.zeros((B, nh, S, hd), f)
    for j in range(S):
        l = l + p[..., j:j + 1]
        o = o + p[..., j:j + 1] * v[:, :, j:j + 1, :]
    o = o * (f(1.0) / l)
    return o.transpose(0, 2, 1, 3).reshape(B * S, H)


@pytest.mark.parametrize("B,S,nh,hd", [(2, 16, 4, 32), (1, 32, 2, 26)])
def test_fixed_order_attention_is_bit_equal_to_a_numpy_loop(B, S, nh, hd):
    rng = np.random.default_rng(S + hd)
    H = nh * hd
    qkv = rng.standard_normal((B * S, 3 * H), np.float32)
    bias = np.where(np.arange(S)[None, :] < np.array([S, S // 2])[:B, None],
                    0.0, -1e30).astype(np.float32)
    got = layer.attention_f32_plain(torch.from_numpy(qkv),
                                    torch.from_numpy(bias), B, S, H, nh)
    assert got.dtype == torch.float32
    want = _numpy_fixed_order(qkv, bias, B, S, H, nh)
    np.testing.assert_array_equal(got.numpy(), want)
