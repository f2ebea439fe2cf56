"""The MPNet family in the port vs the reference and HF transformers.

One seeded numpy parameter tree (non-trivial biases, LayerNorm parameters
and relative-position table) feeds the reference's MPNet encode_batch (its
Pallas kernels in interpret mode, as tests/test_mpnet.py runs them) and,
through params_from_numpy, the port's MPNetModel, at H=128, 4 heads,
2 layers, S=32 with ragged masks. Checked:

- the bucket matrix and the offset position ids equal the reference's and
  HF's; the gathered (nh, S, S) bias equals the reference's;
- K1's and K4's plain twins with rel_bias match the reference's kernels
  with rel_bias (f32 atol 1e-4 and bf16 pooled cosine > 0.999 for K1, as
  tests/test_torch_layer.py; K4's per-token cosine bounds, as
  tests/test_torch_layer_i8.py);
- encode_batch on every route (K1, K4, per-op, attn_impl="xla", K8 pool)
  matches the reference's (f32 atol 1e-4, bf16 cosine > 0.999; K4's route
  >= 0.9999 against the reference on the same route), and the per-op
  route never reaches K5 or K6, which would drop the bias;
- the port matches HF MPNetModel at atol 2e-4 in f32;
- the weights round-trip through to_hf_tensors / from_hf_tensors and load
  into HF MPNetModel and the reference's loader unchanged.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dawnsearch_tpu.models import bert as ref_bert
from dawnsearch_tpu.models import mpnet as ref_mpnet
from dawnsearch_tpu.models import weights as ref_weights
from dawnsearch_tpu.ops.layer import fused_bert_layer as ref_layer
from dawnsearch_tpu.ops.layer import fused_bert_layer_i8 as ref_layer_i8
from dawnsearch_tpu_torch.models import bert, mpnet, weights
from dawnsearch_tpu_torch.models.weights import params_from_numpy
from dawnsearch_tpu_torch.ops import attention, ffn, layer

torch.set_num_threads(2)

VOCAB, H, NH, I, L, P, NB = 300, 128, 4, 256, 2, 68, 32
B, S, PAD = 4, 32, 1
SHAPE = dict(vocab_size=VOCAB, hidden_size=H, num_layers=L, num_heads=NH,
             intermediate_size=I, max_position_embeddings=P,
             type_vocab_size=0, layer_norm_eps=1e-5, model_type="mpnet",
             pad_token_id=PAD)
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
COS_F32, COS_BF16 = 0.99995, 0.9999  # K4's bounds, tests/test_torch_layer_i8.py


def params_tree(rng: np.random.Generator) -> dict:
    def w(*shape):
        return rng.standard_normal(shape, np.float32) * 0.05

    def v(*shape, base=0.0):
        return (base + rng.standard_normal(shape, np.float32) * 0.1).astype(np.float32)

    return {
        "embeddings": {"word": w(VOCAB, H), "position": w(P, H),
                       "ln_scale": v(H, base=1.0), "ln_bias": v(H)},
        "layers": {"qkv_w": w(L, H, 3 * H), "qkv_b": v(L, 3 * H),
                   "attn_out_w": w(L, H, H), "attn_out_b": v(L, H),
                   "attn_ln_scale": v(L, H, base=1.0), "attn_ln_bias": v(L, H),
                   "ffn_in_w": w(L, H, I), "ffn_in_b": v(L, I),
                   "ffn_out_w": w(L, I, H), "ffn_out_b": v(L, H),
                   "ffn_ln_scale": v(L, H, base=1.0), "ffn_ln_bias": v(L, H)},
        "rel_bias": (rng.standard_normal((NB, NH), np.float32) * 0.5),
    }


def _jax(tree):
    if isinstance(tree, dict):
        return {k: _jax(v) for k, v in tree.items()}
    return jnp.asarray(tree)


@pytest.fixture(scope="module")
def tree():
    return params_tree(np.random.default_rng(0))


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(1)
    ids = rng.integers(4, VOCAB, (B, S)).astype(np.int32)
    mask = np.ones((B, S), np.int32)
    mask[1, 10:] = 0
    mask[3, 5:] = 0
    ids[mask == 0] = PAD
    return ids, mask


# -- positions ----------------------------------------------------------------

@pytest.mark.parametrize("S_", [8, 24, 129, 200])
def test_bucket_matrix_matches_reference_and_hf(S_):
    got = mpnet._bucket_matrix(S_, NB)
    np.testing.assert_array_equal(got, ref_mpnet._bucket_matrix(S_, NB))
    modeling = pytest.importorskip("transformers.models.mpnet.modeling_mpnet")
    rel = torch.arange(S_)[None, :] - torch.arange(S_)[:, None]
    np.testing.assert_array_equal(
        got, modeling.MPNetEncoder.relative_position_bucket(
            rel, num_buckets=NB).numpy())


def test_position_ids_match_reference_and_hf(batch):
    ids, _ = batch
    got = mpnet.mpnet_position_ids(torch.from_numpy(ids), PAD).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(ref_mpnet.mpnet_position_ids(jnp.asarray(ids), PAD)))
    assert got[3, 4] == PAD + 5 and got[3, 5] == PAD  # real i -> pad + 1 + i
    modeling = pytest.importorskip("transformers.models.mpnet.modeling_mpnet")
    np.testing.assert_array_equal(got, modeling.create_position_ids_from_input_ids(
        torch.from_numpy(ids).long(), PAD).numpy())


def test_position_bias_matches_reference(tree):
    table = tree["rel_bias"]
    got = mpnet.position_bias(torch.from_numpy(table), S, NH, NB)
    assert got.dtype == torch.float32 and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        ref_mpnet.position_bias(jnp.asarray(table), S, NH, NB)))
    with pytest.raises(ValueError, match="relative-position table"):
        mpnet.position_bias(torch.from_numpy(table), S, NH + 1, NB)


# -- K1 and K4 with rel_bias ----------------------------------------------------

def _layer_inputs(seed: int):
    """x, mask, f32 key bias, one layer's f32 weights and a (nh, S, S)
    rel_bias gathered from a seeded table."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H), np.float32)
    lengths = rng.integers(2, S + 1, B)
    lengths[0] = S
    mask = np.arange(S)[None, :] < lengths[:, None]
    bias = np.where(mask, 0.0, -1e30).astype(np.float32)
    t = params_tree(rng)
    lay = t["layers"]
    w = [lay[k][0] for k in ("qkv_w", "qkv_b", "attn_out_w", "attn_out_b",
                             "attn_ln_scale", "attn_ln_bias", "ffn_in_w",
                             "ffn_in_b", "ffn_out_w", "ffn_out_b",
                             "ffn_ln_scale", "ffn_ln_bias")]
    rel = mpnet.position_bias(torch.from_numpy(t["rel_bias"]), S, NH, NB)
    return x, mask, bias, w, rel.numpy()


def _token_cos(got, want, mask):
    g, w = got[mask], want[mask]
    return np.sum(g * w, -1) / (np.linalg.norm(g, axis=-1) *
                                np.linalg.norm(w, axis=-1))


def _pool(y, mask):
    m = mask[..., None].astype(np.float32)
    p = (y * m).sum(1) / m.sum(1)
    return p / np.linalg.norm(p, axis=-1, keepdims=True)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_k1_plain_with_rel_matches_reference_kernel(dtype):
    x, mask, bias, w, rel = _layer_inputs(2)
    jdt, tdt = DTYPES[dtype]
    want = np.asarray(ref_layer(
        jnp.asarray(x, jdt), jnp.asarray(bias), *[jnp.asarray(a) for a in w],
        nh=NH, eps=1e-5, rel_bias=jnp.asarray(rel))).astype(np.float32)
    got = layer.bert_layer_plain(
        torch.from_numpy(x).to(tdt), torch.from_numpy(bias),
        *[torch.from_numpy(a) for a in w], nh=NH, eps=1e-5,
        rel_bias=torch.from_numpy(rel)).float().numpy()
    if dtype == "f32":
        np.testing.assert_allclose(got, want, atol=1e-4)
        without = layer.bert_layer_plain(
            torch.from_numpy(x), torch.from_numpy(bias),
            *[torch.from_numpy(a) for a in w], nh=NH, eps=1e-5).numpy()
        assert np.abs(without - want).max() > 1e-2  # the bias matters here
    else:
        cos = np.sum(_pool(got, mask) * _pool(want, mask), axis=-1)
        assert np.all(cos > 0.999), cos


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_k4_plain_with_rel_matches_reference_kernel(dtype):
    x, mask, bias, w, rel = _layer_inputs(3)
    jdt, tdt = DTYPES[dtype]
    want = np.asarray(ref_layer_i8(
        jnp.asarray(x, jdt), jnp.asarray(bias), *[jnp.asarray(a) for a in w],
        nh=NH, eps=1e-5, rel_bias=jnp.asarray(rel))).astype(np.float32)
    pw = [torch.from_numpy(a) for a in w]
    for i in (0, 2, 6, 8):
        pw[i] = layer.i8_weight(pw[i])
    got = layer.bert_layer_i8_plain(
        torch.from_numpy(x).to(tdt), torch.from_numpy(bias), *pw, nh=NH,
        eps=1e-5, rel_bias=torch.from_numpy(rel))
    assert got.dtype == tdt
    cos = _token_cos(got.float().numpy(), want, mask)
    assert cos.min() >= (COS_F32 if dtype == "f32" else COS_BF16), cos.min()


@pytest.mark.parametrize("fn", ["bert_layer_plain", "bert_layer_i8_plain"])
def test_zero_rel_equals_no_rel_and_wrappers_launch_nothing(fn):
    """A zero rel_bias adds exact zeros; on the CPU the wrappers run the
    plain twins with the operand and count no launch."""
    x, _, bias, w, rel = _layer_inputs(4)
    args = [torch.from_numpy(a) for a in w]
    if fn == "bert_layer_i8_plain":
        for i in (0, 2, 6, 8):
            args[i] = layer.i8_weight(args[i])
    plain = getattr(layer, fn)
    wrapper = {"bert_layer_plain": layer.fused_bert_layer,
               "bert_layer_i8_plain": layer.fused_bert_layer_i8}[fn]
    xt, bt = torch.from_numpy(x).bfloat16(), torch.from_numpy(bias)
    assert torch.equal(plain(xt, bt, *args, nh=NH),
                       plain(xt, bt, *args, nh=NH,
                             rel_bias=torch.zeros(NH, S, S)))
    before = dict(layer.launches)
    relt = torch.from_numpy(rel)
    assert torch.equal(wrapper(xt, bt, *args, nh=NH, rel_bias=relt),
                       plain(xt, bt, *args, nh=NH, rel_bias=relt))
    assert layer.launches == before


# -- the encoder on every route --------------------------------------------------

ROUTES = {
    "layer": dict(layer_impl="layer"),
    "layer_i8": dict(layer_impl="layer_i8"),
    "ops": dict(layer_impl="ops"),
    "attn_xla": dict(attn_impl="xla"),
    "layer_pool_fused": dict(pool_impl="fused"),
    "ops_pool_fused": dict(layer_impl="ops", pool_impl="fused"),
}
# the kernel wrappers each route calls (per layer, and the pool once)
CALLS = {
    "layer": {"fused_bert_layer"},
    "layer_i8": {"fused_bert_layer_i8"},
    "ops": {"fused_ffn"},
    "attn_xla": {"fused_ffn"},
    "layer_pool_fused": {"fused_bert_layer", "fused_mean_pool"},
    "ops_pool_fused": {"fused_ffn", "fused_mean_pool"},
}


def _configs(route: str, dtype: str):
    jdt, tdt = DTYPES[dtype]
    return (ref_bert.BertConfig(**SHAPE, **ROUTES[route], dtype=jdt),
            bert.BertConfig(**SHAPE, **ROUTES[route], dtype=tdt))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("route", list(ROUTES))
def test_encode_batch_matches_reference(tree, batch, route, dtype):
    ref_cfg, cfg = _configs(route, dtype)
    ids, mask = batch
    want = np.asarray(ref_bert.encode_batch(
        _jax(tree), jnp.asarray(ids), jnp.asarray(mask), cfg=ref_cfg))
    model = mpnet.MPNetModel(cfg, params_from_numpy(tree), device="cpu")
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


@pytest.mark.parametrize("route", list(ROUTES))
def test_each_route_calls_its_kernels_never_k5_or_k6(tree, batch, route,
                                                     monkeypatch):
    """Under MPNet's bias the reference bypasses the packed (K5) and
    head-major (K6) attention kernels (bert.py:125-126, :139): a K5 or K6
    call would drop the bias. The whole-layer kernels take it. On the CPU
    no launch counter moves."""
    _, cfg = _configs(route, "bf16")
    called = []
    for name in ("fused_attention_packed", "fused_attention", "fused_ffn",
                 "fused_bert_layer", "fused_bert_layer_i8", "fused_mean_pool"):
        real = getattr(bert, name)
        monkeypatch.setattr(bert, name, lambda *a, _n=name, _f=real, **kw:
                            called.append((_n, kw.get("rel_bias") is not None))
                            or _f(*a, **kw))
    counts = [dict(m.launches) for m in (attention, ffn, layer)]
    model = mpnet.MPNetModel(cfg, params_from_numpy(tree), device="cpu")
    ids, mask = batch
    bert.encode_batch(model, torch.from_numpy(ids).long(),
                      torch.from_numpy(mask))
    assert {n for n, _ in called} == CALLS[route]
    assert all(has_rel for n, has_rel in called if n.startswith("fused_bert"))
    per_layer = CALLS[route] - {"fused_mean_pool"}
    assert len(called) == L * len(per_layer) + (
        "fused_mean_pool" in CALLS[route])
    assert [dict(m.launches) for m in (attention, ffn, layer)] == counts


# -- HF transformers --------------------------------------------------------------

def _hf_model():
    transformers = pytest.importorskip("transformers")
    cfg = transformers.MPNetConfig(
        vocab_size=VOCAB, hidden_size=H, num_hidden_layers=L,
        num_attention_heads=NH, intermediate_size=I,
        max_position_embeddings=P, relative_attention_num_buckets=NB,
        layer_norm_eps=1e-5, pad_token_id=PAD)
    torch.manual_seed(11)
    return transformers.MPNetModel(cfg).eval()


@pytest.mark.parametrize("route", ["layer", "ops"])
def test_matches_hf_mpnet_model(batch, route):
    m = _hf_model()
    hf_tensors = {k: v.numpy() for k, v in m.state_dict().items()}
    cfg = bert.BertConfig(**SHAPE, **ROUTES[route])
    model = mpnet.MPNetModel(cfg, weights.from_hf_tensors(hf_tensors, cfg),
                             device="cpu")
    ids, mask = batch
    idt, mt = torch.from_numpy(ids).long(), torch.from_numpy(mask)
    with torch.no_grad():
        theirs = m(input_ids=idt, attention_mask=mt).last_hidden_state.numpy()
    ours = model(idt, mt).numpy()
    # HF leaves padded queries unmasked; compare real tokens
    for b in range(B):
        n = int(mask[b].sum())
        np.testing.assert_allclose(ours[b, :n], theirs[b, :n], atol=2e-4)


def test_weights_round_trip_and_load_in_hf_and_reference(tree):
    cfg = bert.BertConfig(**SHAPE)
    params = params_from_numpy(tree)
    hf = weights.to_hf_tensors(params, cfg)
    assert hf["encoder.relative_attention_bias.weight"].shape == (NB, NH)
    assert hf["encoder.layer.1.attention.attn.k.weight"].shape == (H, H)
    assert "encoder.layer.0.attention.LayerNorm.bias" in hf
    assert not any("token_type" in k for k in hf)
    back = weights.from_hf_tensors(
        {**{"mpnet." + k: v for k, v in hf.items()},
         "mpnet.embeddings.position_ids": np.arange(P)[None],
         "pooler.dense.weight": np.zeros((H, H), np.float32)}, cfg)
    assert sorted(back) == ["embeddings", "layers", "rel_bias"]
    for group in ("embeddings", "layers"):
        assert sorted(back[group]) == sorted(tree[group])
        for k, v in tree[group].items():
            np.testing.assert_array_equal(back[group][k].numpy(), v)
    np.testing.assert_array_equal(back["rel_bias"].numpy(), tree["rel_bias"])
    ref = ref_weights.from_hf_tensors(hf, ref_bert.BertConfig(**SHAPE))
    np.testing.assert_array_equal(np.asarray(ref["rel_bias"]), tree["rel_bias"])
    np.testing.assert_array_equal(np.asarray(ref["layers"]["qkv_w"]),
                                  tree["layers"]["qkv_w"])
    m = _hf_model()
    missing, unexpected = m.load_state_dict(
        {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in hf.items()},
        strict=False)
    assert not unexpected
    assert set(missing) <= {"pooler.dense.weight", "pooler.dense.bias",
                            "embeddings.position_ids"}


def test_init_params_shapes_match_reference():
    import jax
    cfg = bert.BertConfig(**SHAPE)
    got = weights.init_params(torch.Generator().manual_seed(0), cfg)
    want = ref_weights.init_params(jax.random.PRNGKey(0),
                                   ref_bert.BertConfig(**SHAPE))
    assert sorted(got) == sorted(want) == ["embeddings", "layers", "rel_bias"]
    assert "token_type" not in got["embeddings"]
    for group in ("embeddings", "layers"):
        assert {k: tuple(v.shape) for k, v in got[group].items()} == \
            {k: tuple(v.shape) for k, v in want[group].items()}
    assert tuple(got["rel_bias"].shape) == want["rel_bias"].shape == (NB, NH)
