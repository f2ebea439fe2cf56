"""The per-op encoder path: the port's encode_batch vs the reference's on
every route the config and width can pick.

One seeded numpy parameter tree (non-trivial biases and LayerNorm
parameters) feeds the reference's encode_batch (its Pallas kernels in
interpret mode) and, through params_from_numpy, the port's BertModel, on
a 2-layer model, in f32 and bf16, for:

- layer_impl="ops" at H=128, nh=4: packed attention (K5) + fused FFN (K7);
- attn_impl="xla": einsum attention + K7 (the whole-layer kernel steps
  aside);
- pool_impl="fused": the pool + normalize kernel (K8) after K1;
- layer_impl="ops" with pool_impl="fused", the per-op node's setting:
  K5 + K7 in every layer, then K8;
- the envelope fallback at H=64, nh=4 under layer_impl="layer": H % 128 != 0,
  so both packages take head-major attention (K6) + K7; the same holds for
  layer_impl="layer_i8", whose K4 route is held against the reference in
  tests/test_torch_layer_i8.py.

Tolerances are the reference's: f32 atol 1e-4, bf16 per-row cosine
> 0.999. The routing itself is checked by recording which kernel wrappers
each configuration calls.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dawnsearch_tpu.models import bert as ref_bert
from dawnsearch_tpu_torch.models import bert
from dawnsearch_tpu_torch.models.weights import params_from_numpy
from dawnsearch_tpu_torch.ops import attention, ffn, layer

torch.set_num_threads(2)

VOCAB, I, L, P = 1000, 256, 2, 64
B, S = 4, 32

ROUTES = {
    "ops": (128, 4, dict(layer_impl="ops")),
    "attn_xla": (128, 4, dict(attn_impl="xla")),
    "pool_fused": (128, 4, dict(pool_impl="fused")),
    "ops_pool_fused": (128, 4, dict(layer_impl="ops", pool_impl="fused")),
    "fallback": (64, 4, dict(layer_impl="layer")),
}
# the kernel wrappers each route calls (per layer, and the pool once)
CALLS = {
    "ops": {"fused_attention_packed", "fused_ffn"},
    "attn_xla": {"fused_ffn"},
    "pool_fused": {"fused_bert_layer", "fused_mean_pool"},
    "ops_pool_fused": {"fused_attention_packed", "fused_ffn", "fused_mean_pool"},
    "fallback": {"fused_attention", "fused_ffn"},
}


def params_tree(rng: np.random.Generator, H: int) -> dict:
    def w(*shape):
        return rng.standard_normal(shape, np.float32) * 0.05

    def v(*shape, base=0.0):
        return (base + rng.standard_normal(shape, np.float32) * 0.1).astype(np.float32)

    return {
        "embeddings": {"word": w(VOCAB, H), "position": w(P, H),
                       "token_type": w(2, H), "ln_scale": v(H, base=1.0),
                       "ln_bias": v(H)},
        "layers": {"qkv_w": w(L, H, 3 * H), "qkv_b": v(L, 3 * H),
                   "attn_out_w": w(L, H, H), "attn_out_b": v(L, H),
                   "attn_ln_scale": v(L, H, base=1.0), "attn_ln_bias": v(L, H),
                   "ffn_in_w": w(L, H, I), "ffn_in_b": v(L, I),
                   "ffn_out_w": w(L, I, H), "ffn_out_b": v(L, H),
                   "ffn_ln_scale": v(L, H, base=1.0), "ffn_ln_bias": v(L, H)},
    }


def _configs(route: str, dtype: str):
    H, nh, impl = ROUTES[route]
    shape = dict(vocab_size=VOCAB, hidden_size=H, num_layers=L, num_heads=nh,
                 intermediate_size=I, max_position_embeddings=P, **impl)
    return (ref_bert.BertConfig(**shape, dtype={"f32": jnp.float32,
                                                "bf16": jnp.bfloat16}[dtype]),
            bert.BertConfig(**shape, dtype={"f32": torch.float32,
                                            "bf16": torch.bfloat16}[dtype]))


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(1)
    ids = rng.integers(5, VOCAB, (B, S)).astype(np.int32)
    mask = np.ones((B, S), np.int32)
    mask[1, 10:] = 0
    mask[3, 5:] = 0
    ids[mask == 0] = 0
    return ids, mask


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("route", list(ROUTES))
def test_encode_batch_matches_reference(batch, route, dtype):
    ref_cfg, cfg = _configs(route, dtype)
    tree = params_tree(np.random.default_rng(0), cfg.hidden_size)
    ids, mask = batch
    want = np.asarray(ref_bert.encode_batch(
        {k: {n: jnp.asarray(a) for n, a in d.items()} for k, d in tree.items()},
        jnp.asarray(ids), jnp.asarray(mask), cfg=ref_cfg))
    model = bert.BertModel(cfg, params_from_numpy(tree), device="cpu")
    got = bert.encode_batch(model, torch.from_numpy(ids).long(),
                            torch.from_numpy(mask)).numpy()
    assert got.shape == want.shape == (B, cfg.hidden_size)
    if dtype == "f32":
        np.testing.assert_allclose(got, want, atol=1e-4)
    else:
        cos = np.sum(got * want, axis=-1)
        assert np.all(cos > 0.999), cos


@pytest.mark.parametrize("route", list(ROUTES))
def test_each_route_calls_its_kernels_and_launches_none_on_cpu(
        batch, route, monkeypatch):
    """Routing condition for condition (bert.py:125-126, :139, :180-181):
    the wrappers a configuration reaches, recorded by spies; on the
    CPU every wrapper runs its plain twin, so no launch counter moves."""
    _, cfg = _configs(route, "bf16")
    called = []
    for name in ("fused_attention_packed", "fused_attention", "fused_ffn",
                 "fused_bert_layer", "fused_mean_pool"):
        real = getattr(bert, name)
        monkeypatch.setattr(bert, name, lambda *a, _n=name, _f=real, **kw:
                            called.append(_n) or _f(*a, **kw))
    counts = [dict(m.launches) for m in (attention, ffn, layer)]
    model = bert.BertModel(cfg, params_from_numpy(
        params_tree(np.random.default_rng(0), cfg.hidden_size)), device="cpu")
    ids, mask = batch
    bert.encode_batch(model, torch.from_numpy(ids).long(),
                      torch.from_numpy(mask))
    assert set(called) == CALLS[route]
    per_layer = CALLS[route] - {"fused_mean_pool"}
    assert len(called) == L * len(per_layer) + ("fused_mean_pool" in called)
    assert [dict(m.launches) for m in (attention, ffn, layer)] == counts


def test_layer_i8_refuses_in_the_envelope_and_falls_back_outside(
        batch, monkeypatch):
    """layer_impl="layer_i8" runs K4 (fused_bert_layer_i8) in every layer
    where the reference runs its W8A8 kernel, inside the packed envelope,
    and the per-op path where the reference does too, outside it
    (bert.py:180-195). The name is kept from when the port refused K4's
    route; nothing is refused now."""
    ids, mask = batch
    called = []
    for name in ("fused_attention_packed", "fused_attention", "fused_ffn",
                 "fused_bert_layer", "fused_bert_layer_i8"):
        real = getattr(bert, name)
        monkeypatch.setattr(bert, name, lambda *a, _n=name, _f=real, **kw:
                            called.append(_n) or _f(*a, **kw))
    for H, want in ((128, ["fused_bert_layer_i8"] * L),
                    (64, ["fused_attention", "fused_ffn"] * L)):
        cfg = bert.BertConfig(vocab_size=VOCAB, hidden_size=H, num_layers=L,
                              num_heads=4, intermediate_size=I,
                              max_position_embeddings=P, layer_impl="layer_i8")
        model = bert.BertModel(cfg, params_from_numpy(
            params_tree(np.random.default_rng(0), H)), device="cpu")
        called.clear()
        out = bert.encode_batch(model, torch.from_numpy(ids).long(),
                                torch.from_numpy(mask))
        assert out.shape == (B, H) and bool(torch.isfinite(out).all())
        assert called == want
        # K4's route holds the matrices only as i8 codes and scales
        assert hasattr(model.layers[0], "qkv_w") == (H == 64)
        assert hasattr(model.layers[0], "qkv_w_codes") == (H == 128)
