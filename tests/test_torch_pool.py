"""K8 (fused_mean_pool) and its route in encode_batch: the port vs the
reference on the CPU.

The reference's fused_mean_pool runs its Pallas kernel in interpret mode
(as tests/test_pallas_kernels.py runs it); the port's fused_mean_pool gets
the same seeded numpy inputs on CPU tensors, so it runs its plain twin.
Both take the hidden states in bf16 or f32 and cast them to f32 in the
pool. Tolerance: the reference's own for K8, max |d| <= 1e-5 and unit
norm within 1e-5 (test_pallas_kernels.py:61-62). encode_batch with
pool_impl="fused" hands K8 the last hidden state in the compute dtype; it
is held to the reference's encode_batch on the same route at the ops
path's bf16 bound, per-row cosine > 0.999 (tests/test_torch_ops_path.py).
plan_pool, which shapes the CUDA kernel's launch, is checked for the
properties csrc/pool.cu relies on. The kernel itself is held against the
twin on a card by tests/test_torch_kernels_gpu.py and chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dawnsearch_tpu.models import bert as ref_bert
from dawnsearch_tpu.ops import attention as ref
from dawnsearch_tpu_torch.models import bert, mpnet
from dawnsearch_tpu_torch.models.weights import params_from_numpy
from dawnsearch_tpu_torch.ops import attention

torch.set_num_threads(2)

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
POOL_ERR = 1e-5
H100_SMS = 132


def _pool_inputs(seed: int, B: int, S: int, H: int):
    rng = np.random.default_rng(seed)
    hidden = rng.standard_normal((B, S, H), np.float32)
    lengths = rng.integers(1, S + 1, B)
    lengths[0] = S
    mask = (np.arange(S)[None, :] < lengths[:, None]).astype(np.int32)
    mask[-1] = 0                       # an all-padding row: count clamps at 1
    return hidden, mask


@pytest.mark.parametrize("include_padding", [False, True])
@pytest.mark.parametrize("H", [312, 384, 1536, 2048])
@pytest.mark.parametrize("B,S", [(3, 7), (2, 16)])
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_fused_mean_pool_matches_reference(dtype, B, S, H, include_padding):
    hidden, mask = _pool_inputs(S + H, B, S, H)
    jdt, tdt = DTYPES[dtype]
    want = np.asarray(ref.fused_mean_pool(jnp.asarray(hidden, jdt),
                                          jnp.asarray(mask),
                                          include_padding=include_padding))
    got = attention.fused_mean_pool(torch.from_numpy(hidden).to(tdt),
                                    torch.from_numpy(mask), include_padding)
    assert got.dtype == torch.float32 and got.shape == (B, H)
    np.testing.assert_allclose(got.numpy(), want, atol=POOL_ERR)
    norms = np.linalg.norm(got.numpy(), axis=-1)
    np.testing.assert_allclose(norms[norms > 0], 1.0, atol=POOL_ERR)


@pytest.mark.parametrize("mask_dtype", [torch.int64, torch.bool,
                                        torch.float32])
def test_every_mask_dtype_gives_the_int32_masks_bits(mask_dtype):
    hidden, mask = _pool_inputs(5, 3, 16, 384)
    h = torch.from_numpy(hidden).bfloat16()
    m = torch.from_numpy(mask)
    assert torch.equal(attention.fused_mean_pool(h, m.to(mask_dtype)),
                       attention.fused_mean_pool(h, m))


@pytest.mark.parametrize("B", [1, 2, 8, 64, 1024])
def test_plan_pool_fits_the_kernel(B):
    """What csrc/pool.cu's entry checks: every chunk holds columns, the
    chunks cover H, the cluster is at most 16 CTAs, every row range holds
    a row, a CTA at most 512 threads; the batch is spread until one more
    doubling would put its CTAs on more than half the SMs or the cluster
    cannot grow (a sequence too short to split its rows splits its
    columns); a CTA has a row lane for each of its rows unless its
    share of an SM's 512 threads is full."""
    for S in (1, 7, 16, 128, 512):
        for H in (8, 312, 384, 1024, 2048, 4096, attention.POOL_MAX_H):
            cc, r, lanes, p = attention.plan_pool(B, S, H, H100_SMS)
            width = lanes * attention.POOL_VEC
            assert (cc - 1) * width < H <= cc * width
            assert cc * r <= attention.POOL_MAX_CLUSTER and 1 <= r <= S
            assert 1 <= lanes <= attention.POOL_MAX_LANES
            assert 1 <= lanes * p <= attention.POOL_MAX_LANES
            if B * cc * r * 2 <= H100_SMS // 2 and \
                    2 * cc * r <= attention.POOL_SPREAD:
                assert S // (2 * r) < attention.POOL_MIN_ROWS and \
                    (r > 1 or lanes < 32)
            share = attention.POOL_MAX_LANES // -(-B * cc * r // H100_SMS)
            assert p == -(-S // r) or p == 1 or lanes * (p + 1) > share
            assert p == 1 or lanes * p <= share


@pytest.mark.parametrize("B,S,plan", [(1, 128, (1, 4, 48, 10)),
                                      (8, 128, (1, 4, 48, 10)),
                                      (8, 512, (1, 8, 48, 10)),
                                      (64, 128, (1, 1, 48, 10)),
                                      (3, 16, (2, 1, 24, 16)),
                                      (256, 128, (1, 1, 48, 5))])
def test_plan_pool_spreads_a_small_batch(B, S, plan):
    """At the node's buckets (B = 1 and 8, S = 128, MiniLM's H = 384) a
    sequence's rows spread over a cluster of 4 CTAs of 32 rows, and a long
    sequence's over 8; at B = 64 one CTA a sequence; a short sequence
    splits its columns instead; a batch of 256 takes half an SM's threads
    a CTA, so that two CTAs share each SM in one wave."""
    assert attention.plan_pool(B, S, 384, H100_SMS) == plan


# encode_batch with pool_impl="fused" on each route K8 follows: K1, K4,
# the per-op route, and MPNet's K1 route (2 layers, H=128, 4 heads)
VOCAB, H, NH, I, L, P = 300, 128, 4, 256, 2, 68
ROUTES = {
    "layer": ("bert", dict(layer_impl="layer")),
    "layer_i8": ("bert", dict(layer_impl="layer_i8")),
    "ops": ("bert", dict(layer_impl="ops")),
    "mpnet layer": ("mpnet", dict(layer_impl="layer", type_vocab_size=0,
                                  layer_norm_eps=1e-5, model_type="mpnet",
                                  pad_token_id=1)),
}


def _tree(rng: np.random.Generator, family: str) -> dict:
    def w(*shape):
        return rng.standard_normal(shape, np.float32) * 0.05

    def v(*shape, base=0.0):
        return (base + rng.standard_normal(shape, np.float32) * 0.1
                ).astype(np.float32)
    emb = {"word": w(VOCAB, H), "position": w(P, H),
           "ln_scale": v(H, base=1.0), "ln_bias": v(H)}
    tree = {"embeddings": emb,
            "layers": {"qkv_w": w(L, H, 3 * H), "qkv_b": v(L, 3 * H),
                       "attn_out_w": w(L, H, H), "attn_out_b": v(L, H),
                       "attn_ln_scale": v(L, H, base=1.0),
                       "attn_ln_bias": v(L, H),
                       "ffn_in_w": w(L, H, I), "ffn_in_b": v(L, I),
                       "ffn_out_w": w(L, I, H), "ffn_out_b": v(L, H),
                       "ffn_ln_scale": v(L, H, base=1.0),
                       "ffn_ln_bias": v(L, H)}}
    if family == "mpnet":
        tree["rel_bias"] = rng.standard_normal((32, NH), np.float32) * 0.5
    else:
        emb["token_type"] = w(2, H)
    return tree


@pytest.mark.parametrize("route", list(ROUTES))
def test_encode_batch_hands_k8_the_uncast_hidden(route, monkeypatch):
    family, impl = ROUTES[route]
    shape = dict(vocab_size=VOCAB, hidden_size=H, num_layers=L, num_heads=NH,
                 intermediate_size=I, max_position_embeddings=P,
                 pool_impl="fused", **impl)
    tree = _tree(np.random.default_rng(0), family)
    rng = np.random.default_rng(1)
    ids = rng.integers(4, VOCAB, (4, 32)).astype(np.int32)
    mask = np.ones((4, 32), np.int32)
    mask[1, 10:] = 0
    mask[3, 5:] = 0
    ids[mask == 0] = 1 if family == "mpnet" else 0
    want = np.asarray(ref_bert.encode_batch(
        {k: ({n: jnp.asarray(a) for n, a in d.items()}
             if isinstance(d, dict) else jnp.asarray(d))
         for k, d in tree.items()},
        jnp.asarray(ids), jnp.asarray(mask),
        cfg=ref_bert.BertConfig(**shape, dtype=jnp.bfloat16)))
    cls = mpnet.MPNetModel if family == "mpnet" else bert.BertModel
    model = cls(bert.BertConfig(**shape, dtype=torch.bfloat16),
                params_from_numpy(tree), device="cpu")
    seen = []
    real = bert.fused_mean_pool
    monkeypatch.setattr(bert, "fused_mean_pool", lambda h, *a, **kw:
                        seen.append(h.dtype) or real(h, *a, **kw))
    t_ids, t_mask = torch.from_numpy(ids).long(), torch.from_numpy(mask)
    got = bert.encode_batch(model, t_ids, t_mask)
    assert seen == [torch.bfloat16]
    cos = np.sum(got.numpy() * want, axis=-1)
    assert np.all(cos > 0.999), cos
    with torch.inference_mode():
        hidden = model(t_ids, t_mask)
    assert hidden.dtype == torch.float32
    # on the CPU the twin casts first: the same bits as the cast route
    assert torch.equal(got, attention.mean_pool_plain(hidden, t_mask))
