"""K4: the port's W8A8 whole-layer plain twin vs the reference kernel.

The reference's fused_bert_layer_i8 runs its Pallas kernel in interpret
mode on the CPU; the port gets the same seeded numpy inputs, its weights
quantized by `quant_cols` and laid out (N, K) by `i8_weight`, as the
model builds them (the reference quantizes the same f32 matrices inside
its call). Bounds: per-token cosine on unmasked tokens >= 0.99995
in f32 and >= 0.9999 in bf16 for one layer; the whole encoder on K4's
route >= 0.9999 against the reference's encoder on the same route and
> 0.999 against the reference's f32 XLA encoder (its own bound,
tests/test_pallas_kernels.py:127). The CUDA kernel itself is compared
with bert_layer_i8_plain on a card by tests/test_torch_kernels_gpu.py and
chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dawnsearch_tpu.models import bert as ref_bert
from dawnsearch_tpu.ops.layer import _quant_cols
from dawnsearch_tpu.ops.layer import fused_bert_layer_i8 as ref_layer_i8
from dawnsearch_tpu_torch.models import bert
from dawnsearch_tpu_torch.models.weights import params_from_numpy
from dawnsearch_tpu_torch.ops import layer
from dawnsearch_tpu_torch.ops.vector import layer_norm

torch.set_num_threads(2)

COS_F32, COS_BF16 = 0.99995, 0.9999
# (B, S, H, nh, I): hd 32, hd 64, and a wider layer with 8 heads of 32
SHAPES = [(2, 16, 128, 4, 256), (2, 32, 128, 2, 512), (2, 16, 256, 8, 1024)]


def _inputs(B, S, H, I, seed):
    """x, a ragged key mask and its f32 bias, one layer's f32 weights with
    non-trivial biases and LayerNorm parameters."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H), np.float32)
    lengths = rng.integers(2, S + 1, B)
    lengths[0] = S
    mask = np.arange(S)[None, :] < lengths[:, None]
    bias = np.where(mask, 0.0, -1e30).astype(np.float32)

    def mat(*shape):
        return rng.standard_normal(shape, np.float32) * 0.05

    def vec(n, base=0.0):
        return (base + rng.standard_normal(n, np.float32) * 0.1).astype(np.float32)

    weights = [mat(H, 3 * H), vec(3 * H), mat(H, H), vec(H), vec(H, 1.0),
               vec(H), mat(H, I), vec(I), mat(I, H), vec(H), vec(H, 1.0), vec(H)]
    return x, mask, bias, weights


def _port_weights(weights):
    """The twelve f32 operands as the port's K4 takes them: the four
    matrices as (codes (N, K), scales) pairs."""
    out = [torch.from_numpy(w) for w in weights]
    for i in (0, 2, 6, 8):
        out[i] = layer.i8_weight(out[i])
    return out


def _token_cos(got, want, mask):
    g, w = got[mask], want[mask]
    return np.sum(g * w, -1) / (np.linalg.norm(g, axis=-1) *
                                np.linalg.norm(w, axis=-1))


@pytest.mark.parametrize("shape", [(128, 384), (384, 1536), (1024, 256)])
def test_quant_cols_bit_equal_to_reference(shape):
    """Codes and scales bit-equal to _quant_cols as written. Under jit XLA
    turns its `/ 127.0` into a product with f32(1/127) (ROADMAP Queue 3):
    there the codes still agree and the scales are within one ulp."""
    rng = np.random.default_rng(shape[0])
    w = rng.standard_normal(shape, np.float32) * 0.05
    w[:, 3] = 0.0                                    # the 1e-12 floor
    w[5, 7] = 2.0                                    # one large outlier
    codes, scales = layer.quant_cols(torch.from_numpy(w))
    want_q, want_s = _quant_cols(jnp.asarray(w))
    assert codes.dtype == torch.int8 and scales.shape == (shape[1],)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(scales.numpy().view(np.int32),
                                  np.asarray(want_s)[0].view(np.int32))
    jit_q, jit_s = jax.jit(_quant_cols)(jnp.asarray(w))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jit_q))
    ulps = np.abs(scales.numpy().view(np.int32).astype(np.int64)
                  - np.asarray(jit_s)[0].view(np.int32))
    assert ulps.max() <= 1


@pytest.mark.parametrize("shape", [(128, 384), (384, 1536), (1536, 384)])
def test_i8_weight_is_quant_cols_transposed(shape):
    """The (N, K) codes K4 reads are quant_cols' (K, N) codes transposed,
    bit for bit, and contiguous; the scales are quant_cols'."""
    rng = np.random.default_rng(shape[1])
    w = torch.from_numpy(rng.standard_normal(shape, np.float32) * 0.05)
    codes, scales = layer.i8_weight(w)
    want_q, want_s = layer.quant_cols(w)
    assert codes.shape == shape[::-1] and codes.is_contiguous()
    assert torch.equal(codes, want_q.t())
    assert torch.equal(scales.view(torch.int32), want_s.view(torch.int32))


def test_model_build_holds_the_transposed_codes():
    """BertModel on K4's route keeps each matrix as i8_weight's (N, K)
    codes: the transpose of quant_cols' codes of the f32 parameter."""
    H, I = 128, 256
    tree = _tree(np.random.default_rng(3), H, I)
    cfg = bert.BertConfig(vocab_size=VOCAB, hidden_size=H, num_layers=L,
                          num_heads=4, intermediate_size=I,
                          max_position_embeddings=P, layer_impl="layer_i8")
    model = bert.BertModel(cfg, params_from_numpy(tree), device="cpu")
    for i, lay in enumerate(model.layers):
        for name in bert.BertLayer.MATRICES:
            codes, scales = lay.i8(name)
            want_q, want_s = layer.quant_cols(
                torch.from_numpy(tree["layers"][name][i]))
            assert torch.equal(codes, want_q.t())
            assert torch.equal(scales, want_s)


def _old_layout_twin(monkeypatch):
    """The previous twin's arithmetic: (K, N) codes multiplied as they
    lie."""
    def mm_codes_kn(aq, rf, wq, ws):
        acc = (aq.double() @ wq.double()).float()
        return acc * rf.reshape(-1, 1) * ws.float()
    monkeypatch.setattr(layer, "_mm_codes", mm_codes_kn)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("B,S,H,nh,I", SHAPES)
def test_plain_layer_on_the_new_layout_equals_the_old(B, S, H, nh, I, dtype,
                                                      monkeypatch):
    """The twin on i8_weight's (N, K) codes gives, bit for bit, what it
    gave on quant_cols' (K, N) codes (the exact f64 product does not see
    the layout). The new layout is
    held against the reference kernel by
    test_plain_layer_matches_reference_kernel."""
    x, _, bias, weights = _inputs(B, S, H, I, seed=H + S + 1)
    tdt = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype]
    xt, bt = torch.from_numpy(x).to(tdt), torch.from_numpy(bias)
    new = layer.bert_layer_i8_plain(xt, bt, *_port_weights(weights), nh=nh)
    old_w = [torch.from_numpy(w) for w in weights]
    for i in (0, 2, 6, 8):
        old_w[i] = layer.quant_cols(old_w[i])
    _old_layout_twin(monkeypatch)
    old = layer.bert_layer_i8_plain(xt, bt, *old_w, nh=nh)
    assert torch.equal(new.float().view(torch.int32),
                       old.float().view(torch.int32))


def _fused_row_quant(a32, parts):
    """Row quantization as K4's GEMMs gather it (csrc/gemm.cuh: x1 in the
    attention-out LayerNorm epilogue over its H / 128 CTAs, h in the
    FFN-out GEMM's prologue from the GELU epilogue's I / 128 partials):
    each CTA's 128-column chunk's absmax alone, their max in rank order,
    then quant_rows_kernel's arithmetic on every element."""
    M, K = a32.shape
    amax = a32.abs().reshape(M, parts, K // parts).amax(dim=-1)
    m = amax[:, 0]
    for p in range(1, parts):
        m = torch.maximum(m, amax[:, p])
    s = m.clamp_min(1e-6).reshape(M, 1)
    aq = torch.round(a32 * torch.div(torch.full_like(s, 127.0), s))
    return aq.to(torch.int8), (s * layer.INV127).reshape(-1)


@pytest.mark.parametrize("H,parts", [(128, 1), (384, 3), (768, 6),
                                     (1024, 8), (1536, 12), (3072, 24)])
def test_fused_row_quantization_is_quant_rows(H, parts):
    """Codes as K4's GEMMs make them, from each CTA's absmax gathered in
    rank order (_fused_row_quant), are quant_rows' codes and factors, bit
    for bit, on LayerNorm output rows with an outlier, a constant row (all
    zero after the LayerNorm: the 1e-6 floor) and a row whose absmax lies
    in the last chunk: the twin quantizes x1 and h with quant_rows."""
    rng = np.random.default_rng(H)
    att = rng.standard_normal((64, H), np.float32) * 2.0
    att[3, 7] = 40.0
    att[5] = 1.5
    att[9, -1] = -30.0
    att = torch.from_numpy(att)
    ln_s = torch.from_numpy(1.0 + rng.standard_normal(H, np.float32) * 0.1)
    ln_b = torch.zeros(H)
    x1 = layer_norm(att, ln_s, ln_b, 1e-12)
    got_q, got_rf = _fused_row_quant(x1, parts)
    want_q, want_rf = layer.quant_rows(x1)
    assert got_q.dtype == torch.int8 and got_rf.shape == (64,)
    assert torch.equal(got_q, want_q)
    assert torch.equal(got_rf.view(torch.int32), want_rf.view(torch.int32))
    assert float(got_rf[5]) == pytest.approx(1e-6 / 127)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("B,S,H,nh,I", SHAPES)
def test_plain_layer_matches_reference_kernel(B, S, H, nh, I, dtype):
    x, mask, bias, weights = _inputs(B, S, H, I, seed=H + S)
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    want = np.asarray(ref_layer_i8(
        jnp.asarray(x, jdt), jnp.asarray(bias),
        *[jnp.asarray(w) for w in weights], nh=nh)).astype(np.float32)
    got = layer.bert_layer_i8_plain(
        torch.from_numpy(x).to(tdt), torch.from_numpy(bias),
        *_port_weights(weights), nh=nh)
    assert got.dtype == tdt and got.shape == (B, S, H)
    cos = _token_cos(got.float().numpy(), want, mask)
    assert cos.min() >= (COS_F32 if dtype == "f32" else COS_BF16), cos.min()


def test_wrapper_runs_plain_on_cpu_without_launching():
    x, _, bias, weights = _inputs(2, 16, 128, 256, seed=1)
    args = (torch.from_numpy(x).bfloat16(), torch.from_numpy(bias),
            *_port_weights(weights))
    before = dict(layer.launches)
    got = layer.fused_bert_layer_i8(*args, nh=4)
    assert torch.equal(got, layer.bert_layer_i8_plain(*args, nh=4))
    assert layer.launches == before


def test_no_bias_equals_zero_bias():
    x, _, _, weights = _inputs(2, 16, 128, 256, seed=2)
    w = _port_weights(weights)
    xt = torch.from_numpy(x)
    assert torch.equal(layer.bert_layer_i8_plain(xt, None, *w, nh=4),
                       layer.bert_layer_i8_plain(xt, torch.zeros(2, 16), *w,
                                                 nh=4))


VOCAB, L, P = 1000, 2, 64


def _tree(rng, H, I):
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


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("H,nh,I", [(128, 4, 256), (256, 4, 512)])
def test_encoder_on_k4_route_matches_reference(H, nh, I, dtype):
    """The whole encoder with layer_impl="layer_i8": against the
    reference's encode_batch on the same route, and against its f32
    XLA encoder (attn_impl and ffn_impl "xla": no Pallas kernel)."""
    tree = _tree(np.random.default_rng(H), H, I)
    rng = np.random.default_rng(1)
    ids = rng.integers(5, VOCAB, (4, 32)).astype(np.int32)
    mask = np.ones((4, 32), np.int32)
    mask[1, 10:] = 0
    mask[3, 5:] = 0
    ids[mask == 0] = 0
    shape = dict(vocab_size=VOCAB, hidden_size=H, num_layers=L, num_heads=nh,
                 intermediate_size=I, max_position_embeddings=P)
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jtree = {k: {n: jnp.asarray(a) for n, a in d.items()}
             for k, d in tree.items()}

    def ref(**kw):
        return np.asarray(ref_bert.encode_batch(
            jtree, jnp.asarray(ids), jnp.asarray(mask),
            cfg=ref_bert.BertConfig(**shape, **kw)))
    cfg = bert.BertConfig(**shape, dtype=tdt, layer_impl="layer_i8")
    assert bert.layer_route(cfg) == "layer_i8"
    got = bert.encode_batch(bert.BertModel(cfg, params_from_numpy(tree),
                                           device="cpu"),
                            torch.from_numpy(ids).long(),
                            torch.from_numpy(mask)).numpy()
    same_route = ref(dtype=jdt, layer_impl="layer_i8")
    xla_f32 = ref(dtype=jnp.float32, attn_impl="xla", ffn_impl="xla")
    assert got.shape == same_route.shape == (4, H)
    assert np.sum(got * same_route, -1).min() >= 0.9999
    assert np.sum(got * xla_f32, -1).min() > 0.999


@pytest.mark.parametrize("H,nh,attn_impl,route", [
    (128, 4, "fused", "layer_i8"), (384, 12, "fused", "layer_i8"),
    (768, 12, "fused", "layer_i8"), (128, 4, "xla", "ops"),
    (64, 4, "fused", "ops"), (312, 12, "fused", "ops")])
def test_layer_i8_route_is_the_references(H, nh, attn_impl, route):
    """K4 exactly where the reference's _layer_fwd takes its W8A8 kernel:
    128 % head_dim == 0, H % 128 == 0 and attn_impl != "xla"."""
    cfg = bert.BertConfig(hidden_size=H, num_heads=nh, attn_impl=attn_impl,
                          layer_impl="layer_i8")
    ref_takes_k4 = (attn_impl != "xla" and 128 % (H // nh) == 0
                    and H % 128 == 0)
    assert bert.layer_route(cfg) == route == ("layer_i8" if ref_takes_k4
                                              else "ops")
