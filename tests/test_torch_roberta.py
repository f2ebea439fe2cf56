"""The RoBERTa family in the port vs the reference and HF transformers.

RoBERTa is BERT's layer stack with offset position ids (pad id + the
token's 1-based index among real tokens; padding at the pad id) and a
one-row token-type table; it serves on K1 (layer_impl="layer") and K4
(layer_impl="layer_i8") unchanged. One seeded numpy tree feeds the
reference's encode_batch (its Pallas kernels in interpret mode) and,
through params_from_numpy, the port's BertModel, at H=128, 4 heads, 2
layers, S=32 with ragged masks whose padding moves the position ids.
Checked:

- encode_batch on every route (K1, K4, per-op, attn_impl="xla", K8 pool),
  f32 and bf16, against the reference's (f32 atol 1e-4, bf16 pooled cosine
  > 0.999, K4's route >= 0.9999 against the reference's K4 route, as
  tests/test_torch_mpnet.py);
- the port against a seeded HF RobertaModel at f32 atol 2e-4, also with
  all-distilroberta-v1's 50,265-row table and S = 512 (positions up to
  513);
- K1's and K4's wrapper envelope takes all-distilroberta-v1's shapes;
- the weights round-trip through HF names (bare and `roberta.`-prefixed)
  and load into HF RobertaModel and the reference's loader;
- make_encoder on an all-distilroberta-v1 model dir (its config.json at 2
  layers, vocab.json + merges.txt) tokenizes natively with the
  reference's ids and gives the reference's embeddings; a pad id that
  disagrees with config.json is refused;
- the port's node serves /api/search on that dir on the CPU, on K1's and
  K4's routes.
"""

import dataclasses
import json
import logging
import shutil
import urllib.parse
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dawnsearch_tpu.config import Config as RefConfig
from dawnsearch_tpu.models import bert as ref_bert
from dawnsearch_tpu.models import weights as ref_weights
from dawnsearch_tpu.node import make_encoder as ref_make_encoder
from dawnsearch_tpu_torch.config import Config
from dawnsearch_tpu_torch.models import bert, weights
from dawnsearch_tpu_torch.models.tokenizer_bpe import train_bpe
from dawnsearch_tpu_torch.models.tokenizer_bpe_native import \
    NativeByteLevelBPETokenizer
from dawnsearch_tpu_torch.models.weights import params_from_numpy
from dawnsearch_tpu_torch.node import DawnNode, make_encoder
from dawnsearch_tpu_torch.ops import attention, ffn, layer
from tests.test_bpe_tokenizer import CORPUS
from tests.test_roberta import ROBERTA_CONFIG

torch.set_num_threads(2)

VOCAB, H, NH, I, L, P = 300, 128, 4, 256, 2, 68
B, S, PAD = 4, 32, 1
SHAPE = dict(vocab_size=VOCAB, hidden_size=H, num_layers=L, num_heads=NH,
             intermediate_size=I, max_position_embeddings=P,
             type_vocab_size=1, layer_norm_eps=1e-5, model_type="roberta",
             pad_token_id=PAD)
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
TEXTS = ["The quick brown fox jumps over the lazy dog",
         "a distributed semantic web search engine",
         "lighthouse keeper storms the winding stairs",
         "don't stop me now", "numbers 123 and café ☃"]
PAGES = ["the lighthouse keeper climbed the spiral stairs every night",
         "quantum error correction spreads one logical qubit across many",
         "knead the sourdough for ten minutes then let it rise overnight",
         "the mountain railway climbs through seven tunnels to the pass",
         "anglerfish in the midnight zone lure their prey with a light",
         "the treaty ended the war and fixed the border along the river",
         "a binary heap keeps its smallest key at the root of the tree",
         "monarch butterflies migrate to the same fir forests in mexico"]


def params_tree(rng: np.random.Generator, vocab: int = VOCAB,
                positions: int = P, layers: int = L) -> dict:
    def w(*shape):
        return rng.standard_normal(shape, np.float32) * 0.05

    def v(*shape, base=0.0):
        return (base + rng.standard_normal(shape, np.float32) * 0.1).astype(np.float32)

    return {
        "embeddings": {"word": w(vocab, H), "position": w(positions, H),
                       "token_type": w(1, H), "ln_scale": v(H, base=1.0),
                       "ln_bias": v(H)},
        "layers": {"qkv_w": w(layers, H, 3 * H), "qkv_b": v(layers, 3 * H),
                   "attn_out_w": w(layers, H, H), "attn_out_b": v(layers, H),
                   "attn_ln_scale": v(layers, H, base=1.0),
                   "attn_ln_bias": v(layers, H),
                   "ffn_in_w": w(layers, H, I), "ffn_in_b": v(layers, I),
                   "ffn_out_w": w(layers, I, H), "ffn_out_b": v(layers, H),
                   "ffn_ln_scale": v(layers, H, base=1.0),
                   "ffn_ln_bias": v(layers, H)},
    }


def _jax(tree):
    if isinstance(tree, dict):
        return {k: _jax(v) for k, v in tree.items()}
    return jnp.asarray(tree)


def ragged(rng: np.random.Generator, vocab: int, b: int, s: int,
           lengths: list[int]):
    ids = rng.integers(4, vocab, (b, s)).astype(np.int32)
    mask = (np.arange(s)[None, :] < np.array(lengths)[:, None]).astype(np.int32)
    ids[mask == 0] = PAD  # HF and the reference derive positions from pads
    return ids, mask


@pytest.fixture(scope="module")
def tree():
    return params_tree(np.random.default_rng(0))


@pytest.fixture(scope="module")
def batch():
    return ragged(np.random.default_rng(1), VOCAB, B, S, [S, 10, 27, 5])


# -- the encoder on every route --------------------------------------------------

ROUTES = {
    "layer": dict(layer_impl="layer"),
    "layer_i8": dict(layer_impl="layer_i8"),
    "ops": dict(layer_impl="ops"),
    "attn_xla": dict(attn_impl="xla"),
    "layer_pool_fused": dict(pool_impl="fused"),
}
# the kernel wrappers each route calls (per layer, and the pool once)
CALLS = {
    "layer": {"fused_bert_layer"},
    "layer_i8": {"fused_bert_layer_i8"},
    "ops": {"fused_attention_packed", "fused_ffn"},
    "attn_xla": {"fused_ffn"},
    "layer_pool_fused": {"fused_bert_layer", "fused_mean_pool"},
}


def _configs(route: str, dtype: str, **shape):
    jdt, tdt = DTYPES[dtype]
    shape = {**SHAPE, **shape}
    return (ref_bert.BertConfig(**shape, **ROUTES[route], dtype=jdt),
            bert.BertConfig(**shape, **ROUTES[route], dtype=tdt))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("route", list(ROUTES))
def test_encode_batch_matches_reference(tree, batch, route, dtype):
    ref_cfg, cfg = _configs(route, dtype)
    ids, mask = batch
    want = np.asarray(ref_bert.encode_batch(
        _jax(tree), jnp.asarray(ids), jnp.asarray(mask), cfg=ref_cfg))
    model = bert.BertModel(cfg, params_from_numpy(tree), device="cpu")
    got = bert.encode_batch(model, torch.from_numpy(ids).long(),
                            torch.from_numpy(mask)).numpy()
    assert got.shape == want.shape == (B, H)
    cos = np.sum(got * want, axis=-1)
    if route == "layer_i8":
        assert cos.min() >= 0.9999, cos
    elif dtype == "f32":
        np.testing.assert_allclose(got, want, atol=1e-4)
    else:
        assert np.all(cos > 0.999), cos


def test_positions_follow_the_padding(tree, batch):
    """The same tokens give the same embeddings with padding after them
    or in front of them: the offset position ids count real tokens only
    (BERT's arange positions would shift with leading padding). The
    offset matters: the same row read as BERT differs."""
    cfg = bert.BertConfig(**SHAPE)
    model = bert.BertModel(cfg, params_from_numpy(tree), device="cpu")
    ids, mask = batch
    row = torch.from_numpy(ids[2:3, :27]).long()
    short = model(row, torch.ones_like(row))[0].numpy()
    padded = torch.cat([row, torch.full((1, 5), PAD)], dim=1)
    pad_mask = torch.cat([torch.ones_like(row), torch.zeros(1, 5, dtype=row.dtype)], 1)
    np.testing.assert_allclose(model(padded, pad_mask)[0, :27].numpy(), short,
                               atol=1e-5)
    front = torch.cat([torch.full((1, 5), PAD), row], dim=1)
    moved = model(front, torch.cat([pad_mask[:, 27:], pad_mask[:, :27]], 1))
    np.testing.assert_allclose(moved[0, 5:].numpy(), short, atol=1e-5)
    as_bert = bert.BertModel(dataclasses.replace(cfg, model_type="bert"),
                             params_from_numpy(tree), device="cpu")
    assert np.abs(as_bert(row, torch.ones_like(row))[0].numpy()
                  - short).max() > 1e-2


@pytest.mark.parametrize("route", list(ROUTES))
def test_each_route_calls_its_kernels(tree, batch, route, monkeypatch):
    """RoBERTa takes BERT's routes: K1 or K4 per layer (no rel_bias), the
    per-op kernels, K8; on the CPU no launch counter moves."""
    _, cfg = _configs(route, "bf16")
    called = []
    for name in ("fused_attention_packed", "fused_attention", "fused_ffn",
                 "fused_bert_layer", "fused_bert_layer_i8", "fused_mean_pool"):
        real = getattr(bert, name)
        monkeypatch.setattr(bert, name, lambda *a, _n=name, _f=real, **kw:
                            called.append((_n, kw.get("rel_bias") is not None))
                            or _f(*a, **kw))
    counts = [dict(m.launches) for m in (attention, ffn, layer)]
    model = bert.BertModel(cfg, params_from_numpy(tree), device="cpu")
    ids, mask = batch
    bert.encode_batch(model, torch.from_numpy(ids).long(),
                      torch.from_numpy(mask))
    assert {n for n, _ in called} == CALLS[route]
    assert not any(has_rel for _, has_rel in called)
    assert [dict(m.launches) for m in (attention, ffn, layer)] == counts


@pytest.mark.parametrize("S_", [16, 128, 512])
@pytest.mark.parametrize("what", ["K1", "K4"])
def test_wrapper_envelope_takes_distilroberta_shapes(what, S_):
    """K1's and K4's wrapper checks at all-distilroberta-v1's width (768,
    12 heads of 64, I = 3072) and every seq bucket up to 512."""
    x = torch.zeros(2, S_, 768, dtype=torch.bfloat16)
    bias, rel = layer._check_layer(what, x, None, None, 12, 3072)
    assert tuple(bias.shape) == (2, S_) and rel is None


# -- HF transformers --------------------------------------------------------------

def _hf_model(vocab=VOCAB, positions=P, layers=L, seed=17):
    transformers = pytest.importorskip("transformers")
    cfg = transformers.RobertaConfig(
        vocab_size=vocab, hidden_size=H, num_hidden_layers=layers,
        num_attention_heads=NH, intermediate_size=I,
        max_position_embeddings=positions, type_vocab_size=1,
        pad_token_id=PAD, layer_norm_eps=1e-5, hidden_act="gelu")
    torch.manual_seed(seed)
    return transformers.RobertaModel(cfg, add_pooling_layer=False).eval()


def _match_hf(m, cfg, ids, mask, atol=2e-4):
    model = bert.BertModel(cfg, weights.from_hf_tensors(
        {k: v.numpy() for k, v in m.state_dict().items()}, cfg), device="cpu")
    idt, mt = torch.from_numpy(ids).long(), torch.from_numpy(mask)
    with torch.no_grad():
        theirs = m(input_ids=idt, attention_mask=mt).last_hidden_state.numpy()
    ours = model(idt, mt).numpy()
    # HF leaves padded queries unmasked; compare real tokens
    for b in range(ids.shape[0]):
        n = int(mask[b].sum())
        np.testing.assert_allclose(ours[b, :n], theirs[b, :n], atol=atol)


@pytest.mark.parametrize("route", ["layer", "ops"])
def test_matches_hf_roberta_model(batch, route):
    ids, mask = batch
    _match_hf(_hf_model(), bert.BertConfig(**SHAPE, **ROUTES[route]), ids, mask)


def test_full_vocab_and_positions_match_hf():
    """all-distilroberta-v1's 50,265-row table and 514 positions: a full
    S = 512 row reaches position 513, the top id is looked up."""
    shape = dict(SHAPE, vocab_size=50265, max_position_embeddings=514,
                 num_layers=1)
    ids, mask = ragged(np.random.default_rng(2), 50265, 2, 512, [512, 300])
    ids[0, 7] = 50264
    _match_hf(_hf_model(50265, 514, 1), bert.BertConfig(**shape), ids, mask)


def test_weights_round_trip_and_load_in_hf_and_reference(tree):
    cfg = bert.BertConfig(**SHAPE)
    hf = weights.to_hf_tensors(params_from_numpy(tree), cfg)
    assert hf["embeddings.token_type_embeddings.weight"].shape == (1, H)
    assert "encoder.layer.1.attention.self.key.weight" in hf
    back = weights.from_hf_tensors(
        {**{"roberta." + k: v for k, v in hf.items()},
         "roberta.embeddings.position_ids": np.arange(P)[None],
         "lm_head.dense.weight": np.zeros((H, H), np.float32)}, cfg)
    for group in ("embeddings", "layers"):
        assert sorted(back[group]) == sorted(tree[group])
        for k, v in tree[group].items():
            np.testing.assert_array_equal(back[group][k].numpy(), v)
    ref = ref_weights.from_hf_tensors(hf, ref_bert.BertConfig(**SHAPE))
    np.testing.assert_array_equal(np.asarray(ref["layers"]["qkv_w"]),
                                  tree["layers"]["qkv_w"])
    m = _hf_model()
    missing, unexpected = m.load_state_dict(
        {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in hf.items()},
        strict=False)
    assert not unexpected and set(missing) <= {"embeddings.position_ids"}


# -- an all-distilroberta-v1 model dir: make_encoder and the node -----------------

@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    """all-distilroberta-v1's config.json at 2 layers, seeded HF weights
    (the hub file's key set, pooler included) written by the port's
    safetensors writer, and a trained mini-BPE in the HF file layout."""
    transformers = pytest.importorskip("transformers")
    d = tmp_path_factory.mktemp("all-distilroberta-v1")
    config = dict(ROBERTA_CONFIG, num_hidden_layers=2)
    (d / "config.json").write_text(json.dumps(config))
    train_bpe(CORPUS, size=600).save(str(d))
    torch.manual_seed(23)
    m = transformers.RobertaModel(transformers.RobertaConfig(**{
        k: v for k, v in config.items() if k != "architectures"}))
    weights.write_safetensors({k: v.numpy() for k, v in m.state_dict().items()},
                              str(d / "model.safetensors"))
    return str(d)


def test_make_encoder_matches_reference(model_dir, caplog):
    with caplog.at_level(logging.INFO, logger="dawnsearch"):
        enc = make_encoder(Config(device="cpu", model_dir=model_dir,
                                  seq_buckets=(16, 32)))
    ref = ref_make_encoder(RefConfig(model_dir=model_dir, seq_buckets=(16, 32)))
    assert isinstance(enc.tokenizer, NativeByteLevelBPETokenizer)
    assert any("tokenizer=NativeByteLevelBPETokenizer)" in r.getMessage()
               for r in caplog.records)
    assert (enc.cfg.model_type, enc.cfg.pad_token_id, enc.cfg.num_layers,
            enc.cfg.layer_norm_eps) == ("roberta", 1, 2, 1e-5)
    assert (enc.tokenizer.pad_id, enc.tokenizer.cls_id,
            enc.tokenizer.sep_id) == (1, 0, 2)
    assert enc.tokenize_texts(TEXTS) == ref.tokenize_texts(TEXTS)
    got, want = enc.encode(TEXTS), np.asarray(ref.encode(TEXTS), np.float32)
    assert got.shape == want.shape == (len(TEXTS), 768)
    cos = np.sum(got * want, axis=1)
    assert np.all(cos > 0.999), cos


def test_pad_id_mismatch_refused(model_dir, tmp_path):
    """A vocab.json whose <pad> id disagrees with config.json's
    pad_token_id would shift every position id: refused, as the reference
    refuses it (tests/test_roberta.py:195)."""
    d = tmp_path / "bad"
    shutil.copytree(model_dir, d)
    vocab = json.loads((d / "vocab.json").read_text(encoding="utf-8"))
    vocab["<pad>"], vocab["<s>"] = vocab["<s>"], vocab["<pad>"]
    (d / "vocab.json").write_text(json.dumps(vocab), encoding="utf-8")
    with pytest.raises(ValueError, match="pad id 0 != config.json "
                                         "pad_token_id 1"):
        make_encoder(Config(device="cpu", model_dir=str(d)))


def _http(url, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


@pytest.mark.parametrize("layer_impl", ["layer", "layer_i8"])
def test_node_serves_roberta(model_dir, tmp_path, layer_impl):
    """The node on the model dir, on K1's and K4's routes (their plain
    twins on the CPU): a 768-wide index, an inserted page back at rank 1."""
    cfg = Config(device="cpu", web=True, web_listen_address="127.0.0.1:0",
                 accept_insert=True, data_dir=str(tmp_path / "data"),
                 model_dir=model_dir, layer_impl=layer_impl,
                 seq_buckets=(16, 32))
    node = DawnNode(cfg).start()
    try:
        mcfg = node.encoder.model.cfg
        assert (mcfg.model_type, mcfg.layer_impl) == ("roberta", layer_impl)
        assert bert.layer_route(mcfg) == layer_impl
        assert node.provider.index.dim == 768
        base = f"http://127.0.0.1:{node.http_port}"
        pages = [{"url": f"https://r/{i}", "title": "", "text": t}
                 for i, t in enumerate(PAGES)]
        assert len(_http(base + "/api/insert", {"pages": pages})["inserted"]) \
            == len(PAGES)
        for j in (1, 6):
            got = _http(base + "/api/search?q=" + urllib.parse.quote(PAGES[j]))
            assert got["results"][0]["url"] == f"https://r/{j}"
    finally:
        node.stop()
