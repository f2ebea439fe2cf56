"""The port's CUDA kernels vs their plain PyTorch twins, on a card.

Everything here needs an NVIDIA GPU (a CUDA kernel has no CPU mode) and
skips without one. The file imports neither JAX nor the reference
package, so it also runs on a machine that has only torch:

    python -m pytest --noconftest -q tests/test_torch_kernels_gpu.py

Every encoder kernel runs at bf16 and at f32 (compute_dtype = "f32": the
kernels' f32 instances, counted under `_f32` names; K1's GEMM and the K1,
K5 and K6 attention take every product 3xTF32 on the tensor cores, K4's
attention keeps its fixed order, K7 runs on K1's GEMM ring in 3xTF32
with its matrices as (W_hi, W_lo) pairs). At f32, against
the twin run at f32 with TF32 off: K1 within max |d| 1e-4 and per-token
cosine 0.99999, K4 at per-token cosine 0.99995 (its f32 CPU bound), K5,
K6 and K7 within 1e-5 of the output's scale and per-row cosine 0.99999;
an f32 input never reaches a plain twin, a dtype mix is refused, and K1
and K7 at f32 refuse a matrix that is not its (W_hi, W_lo) pair. K2 (i8
queries) and K3 (i8 queries) must be bit-equal to their
plain twin, also at B = 1 and 8 over 32 tiles with count mid-tile and
whole tiles past it; the bf16-query variants agree within two key steps (3.1e-5) on the
values and on at least 99% of the window ids; K1 agrees to the bf16 bound
of the reference's own tests (per-row cosine > 0.999) at every head dim
of the packed envelope; K4 agrees with bert_layer_i8_plain at per-token
cosine >= 0.9999 (the same rounding points and exact s32 sums; f32 sums
of LayerNorm and attention in another order), at B = 1 too, and each of
its s8 GEMMs alone with the twin's arithmetic (the codes it makes of x1
and the absmax it records of h bit-equal to the twin's). K1 and K4 with MPNet's
rel_bias agree with their plain twins given the same operand at per-token
cosine >= 0.9999, a zero rel_bias changes no bit, and a rel_bias of the
wrong shape, dtype, device or layout raises. The per-op
kernels K5 and K6 (which pass a null rel_bias through the same C entry)
and K7 agree with their plain twins at per-row cosine
> 0.9999 (the same bf16 rounding points, f32 sums in another order), K7
at ragged widths (312/1200, 128/256) and at widths whose h a shared-memory
design could not hold (1024/8192); K8
within 1e-5 in bf16 and f32 at widths 312 to 4096 and S = 7 to 512, its
bf16 result bit-equal to its f32 one on the upcast input, two calls bit-
equal, every mask dtype it reads giving the same bits. K1's GEMM (TMA + wgmma, its LayerNorm over a
thread-block cluster) is held at rows that are not a multiple of its
tiles at every cluster width up to a non-portable 10, each epilogue alone
against the f32 product rounded to bf16 (bf16) or the f64 product (f32,
at M = 128 and 8192), and in a CUDA-graph replay (f32: equal to the eager
call); the mma.sync attention at S of 16 to 512 and every head dim it
pads (16 to 128, and 26), on 16-byte aligned and misaligned inputs, in
K5, K6 and K1 with rel_bias, and at f32 with rel at hd 26, with whole
key tiles masked and with every key of a sequence masked; the GEMM's
ragged last column tile (EPI_LN at N = 312, EPI_GELU at N = 1200) against
the same products; a bf16 input
never reaches a plain twin either. K1 and K8 are also held at the bulk
ingest shapes (ingest_batch_size 512, coalesced to two caps of the top
bucket, 1024, at S = 512): K1 at B = 1024 (H = 384 and H = 1024, where
M * I = 2^31) and B = 512 (H = 768), K8 at B = 1024, with the bounds
above; the plain twin runs in batch slices there, to bound its memory.
The profiler names the kernels each
route runs: K1 f32 the TMA + wgmma GEMM and the 3xTF32 attention, K4 (at
either dtype) the fixed-order attention.
"""

import numpy as np
import pytest
import torch

from dawnsearch_tpu_torch.index.flat import FlatIndex, quantize_rows_i8
from dawnsearch_tpu_torch.models import bert, mpnet
from dawnsearch_tpu_torch.models.weights import init_params
from dawnsearch_tpu_torch.ops import attention, ffn, layer
from dawnsearch_tpu_torch.ops.layer import i8_weight
from dawnsearch_tpu_torch.ops import scan_select as ss
from dawnsearch_tpu_torch.ops.quant import quantize_i4_vals, write_rows_i4
from dawnsearch_tpu_torch.ops.vector import layer_norm

pytestmark = pytest.mark.gpu
torch.set_num_threads(2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    # the f32 twins' products must be true f32 products, not TF32
    assert torch.backends.cuda.matmul.allow_tf32 is False
    return torch.device("cuda")


DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def _layer_bound(got, want, m, dtype):
    """K1's bound at its dtype: per-token cosine > 0.999 in bf16 (the
    reference's), max |d| <= 1e-4 and cosine >= 0.99999 in f32."""
    assert torch.isfinite(got).all()
    cos = torch.nn.functional.cosine_similarity(got[m], want[m], dim=-1)
    if dtype == torch.bfloat16:
        assert float(cos.min()) > 0.999
    else:
        assert float((got - want)[m].abs().max()) <= 1e-4
        assert float(cos.min()) >= 0.99999


def _layer_inputs(rng, B, S, H=384, I=1536):
    lengths = rng.integers(2, S + 1, B)
    mask = np.arange(S)[None, :] < lengths[:, None]
    bias = np.where(mask, 0.0, -1e30).astype(np.float32)
    x = rng.standard_normal((B, S, H), np.float32)

    def mat(*shape):
        return rng.standard_normal(shape, np.float32) * 0.05

    def vec(n, base=0.0):
        return (base + rng.standard_normal(n, np.float32) * 0.1).astype(np.float32)

    weights = [mat(H, 3 * H), vec(3 * H), mat(H, H), vec(H), vec(H, 1.0),
               vec(H), mat(H, I), vec(I), mat(I, H), vec(H), vec(H, 1.0), vec(H)]
    return x, mask, bias, weights


def _k1_args(rng, B, S, cuda, dtype, H=384, I=1536):
    x, mask, bias, weights = _layer_inputs(rng, B, S, H, I)
    w = [torch.from_numpy(a).to(cuda, dtype if a.ndim == 2 else None)
         for a in weights]
    return (torch.from_numpy(x).to(cuda, dtype),
            torch.from_numpy(bias).to(cuda), w,
            torch.from_numpy(mask).to(cuda))


def _k1_form(w):
    """K1's (and K7's) weights as its kernel takes them: at f32 each (in,
    out) matrix as its (W_hi, W_lo) pair (layer.tf32_pair), as the model
    holds them on a card; the plain twin takes w as it is."""
    return [layer.tf32_pair(t) if t.ndim == 2 and t.dtype == torch.float32
            else t for t in w]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("B,S", [(3, 16), (4, 32), (2, 128), (1, 512),
                                 (3, 48)])
def test_k1_matches_plain(cuda, B, S, dtype):
    """(3, 48): M = 144 rows, not a multiple of the GEMM's tiles."""
    dt = DTYPES[dtype]
    xt, bt, w, m = _k1_args(np.random.default_rng(S), B, S, cuda, dt)
    name = "kernel_bert_layer" + ("_f32" if dtype == "f32" else "")
    before = dict(layer.launches)
    got = layer.fused_bert_layer(xt, bt, *_k1_form(w), nh=12)
    assert got.dtype == dt
    assert layer.launches == {**before, name: before[name] + 1}
    want = layer.bert_layer_plain(xt, bt, *w, nh=12)
    _layer_bound(got.float(), want.float(), m, dt)


# the ingest path's shapes: (B, S, H, nh, I); the last puts M * I at 2^31
INGEST_K1 = [(1024, 512, 384, 12, 1536), (512, 512, 768, 12, 3072),
             (1024, 512, 1024, 16, 4096)]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("B,S,H,nh,I", INGEST_K1)
def test_k1_at_the_ingest_shapes(cuda, B, S, H, nh, I, dtype):
    """K1 at the bulk ingest batches (one launch), against the plain twin
    run 32 sequences at a time on the same inputs."""
    dt = DTYPES[dtype]
    xt, bt, w, m = _k1_args(np.random.default_rng(B + H), B, S, cuda, dt,
                            H=H, I=I)
    got = layer.fused_bert_layer(xt, bt, *_k1_form(w), nh=nh)
    assert got.shape == (B, S, H) and got.dtype == dt
    for i in range(0, B, 32):
        want = layer.bert_layer_plain(xt[i:i + 32], bt[i:i + 32], *w, nh=nh)
        _layer_bound(got[i:i + 32].float(), want.float(), m[i:i + 32], dt)


def test_k1_refuses_what_it_does_not_take(cuda):
    """A dtype mix (bf16 x with f32 matrices, or the reverse) and f16 are
    refused; a head dim of 64 (nh = 6 at H = 384), once refused, now runs
    and agrees with the plain twin; a width outside the envelope is
    refused."""
    x, mask, bias, weights = _layer_inputs(np.random.default_rng(0), 2, 16)
    w = [torch.from_numpy(a).to(cuda, torch.bfloat16 if a.ndim == 2 else None)
         for a in weights]
    w32 = [t.float() for t in w]
    xt = torch.from_numpy(x).to(cuda)
    bt = torch.from_numpy(bias).to(cuda)
    before = dict(layer.launches)
    with pytest.raises(ValueError, match="K1 qkv_w"):
        layer.fused_bert_layer(xt, bt, *w, nh=12)           # f32 x, bf16 W
    with pytest.raises(ValueError, match="K1 qkv_w"):
        layer.fused_bert_layer(xt.bfloat16(), bt, *w32, nh=12)  # the reverse
    with pytest.raises(ValueError, match="bf16 or f32"):
        layer.fused_bert_layer(xt.half(), bt, *w, nh=12)
    assert layer.launches == before
    got = layer.fused_bert_layer(xt.bfloat16(), bt, *w, nh=6).float()
    want = layer.bert_layer_plain(xt.bfloat16(), bt, *w, nh=6).float()
    m = torch.from_numpy(mask).to(cuda)
    cos = torch.nn.functional.cosine_similarity(got[m], want[m], dim=-1)
    assert torch.isfinite(got).all() and float(cos.min()) > 0.999
    with pytest.raises(ValueError, match="128 % hd == 0"):
        layer.fused_bert_layer(xt.bfloat16(), bt, *w, nh=16)  # hd 24


def test_k1_f32_refuses_a_missing_or_misshaped_pair(cuda):
    """At f32 K1 takes each matrix as its (W_hi, W_lo) pair only: the
    (in, out) matrix, a lone half, halves in the (in, out) layout or in
    bf16 raise, and nothing launches (no fallback to the (in, out)
    matrix)."""
    x, _, bias, weights = _layer_inputs(np.random.default_rng(8), 2, 16)
    w = [torch.from_numpy(a).to(cuda) for a in weights]
    xt, bt = torch.from_numpy(x).to(cuda), torch.from_numpy(bias).to(cuda)
    pairs = _k1_form(w)
    before = dict(layer.launches)
    for i, bad, match in (
            (0, w[0], "K1 qkv_w: at f32"),
            (0, pairs[0][:1], "K1 qkv_w: at f32"),
            (6, tuple(t.t() for t in pairs[6]), "K1 w1 hi"),
            (8, tuple(t.bfloat16() for t in pairs[8]), "K1 w2 hi")):
        args = list(pairs)
        args[i] = bad
        with pytest.raises(ValueError, match=match):
            layer.fused_bert_layer(xt, bt, *args, nh=12)
    assert layer.launches == before


@pytest.mark.parametrize("H,nh,I", [(256, 16, 512), (768, 12, 3072),
                                    (256, 2, 1024)])
def test_k1_every_packed_head_dim(cuda, H, nh, I):
    """hd 16, 64 and 128 against bert_layer_plain."""
    B, S = 2, 64
    x, mask, bias, weights = _layer_inputs(np.random.default_rng(H + nh), B, S,
                                           H, I)
    w = [torch.from_numpy(a).to(cuda, torch.bfloat16 if a.ndim == 2 else None)
         for a in weights]
    xt = torch.from_numpy(x).to(cuda, torch.bfloat16)
    bt = torch.from_numpy(bias).to(cuda)
    before = layer.launches["kernel_bert_layer"]
    got = layer.fused_bert_layer(xt, bt, *w, nh=nh).float()
    assert layer.launches["kernel_bert_layer"] == before + 1
    want = layer.bert_layer_plain(xt, bt, *w, nh=nh).float()
    m = torch.from_numpy(mask).to(cuda)
    cos = torch.nn.functional.cosine_similarity(got[m], want[m], dim=-1)
    assert torch.isfinite(got).all() and float(cos.min()) > 0.999


def _k4_args(rng, B, S, H, I, cuda):
    x, mask, bias, weights = _layer_inputs(rng, B, S, H, I)
    w = [torch.from_numpy(a) for a in weights]
    for i in (0, 2, 6, 8):
        w[i] = tuple(t.to(cuda) for t in i8_weight(w[i]))
    w = [t if isinstance(t, tuple) else t.to(cuda) for t in w]
    return (torch.from_numpy(x).to(cuda, torch.bfloat16),
            torch.from_numpy(bias).to(cuda), w,
            torch.from_numpy(mask).to(cuda))


# K4 vs its twin, per-token cosine: bf16 (f32 sums of LayerNorm in
# another order) and f32 (its CPU bound, tests/test_torch_layer_i8.py)
K4_COS = {torch.bfloat16: 0.9999, torch.float32: 0.99995}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("B,S,H,nh,I", [(3, 128, 384, 12, 1536),
                                        (2, 64, 768, 12, 3072),
                                        (1, 512, 1024, 16, 4096),
                                        (1, 128, 384, 12, 1536),
                                        (1, 128, 768, 12, 3072)])
def test_k4_matches_plain(cuda, B, S, H, nh, I, dtype):
    """MiniLM, BERT-base and BERT-large widths, ragged masks, and one B=1
    query (M = 128) at MiniLM and BERT-base widths."""
    dt = DTYPES[dtype]
    x, bias, w, m = _k4_args(np.random.default_rng(H), B, S, H, I, cuda)
    x = x.to(dt)
    name = "kernel_bert_layer_i8" + ("_f32" if dtype == "f32" else "")
    before = dict(layer.launches)
    got = layer.fused_bert_layer_i8(x, bias, *w, nh=nh)
    assert got.dtype == dt
    assert layer.launches == {**before, name: before[name] + 1}
    want = layer.bert_layer_i8_plain(x, bias, *w, nh=nh).float()
    got = got.float()
    assert torch.isfinite(got).all()
    cos = torch.nn.functional.cosine_similarity(got[m], want[m], dim=-1)
    assert float(cos.min()) >= K4_COS[dt]


def test_k4_refuses_what_it_does_not_take(cuda):
    x, bias, w, _ = _k4_args(np.random.default_rng(1), 2, 16, 384, 1536, cuda)
    with pytest.raises(ValueError, match="bf16 or f32"):
        layer.fused_bert_layer_i8(x.half(), bias, *w, nh=12)
    with pytest.raises(ValueError, match="128 % hd == 0"):
        layer.fused_bert_layer_i8(x, bias, *w, nh=16)          # hd 24
    with pytest.raises(ValueError, match="S % 16 == 0"):
        layer.fused_bert_layer_i8(x[:, :10], bias[:, :10], *w, nh=12)
    bad = list(w)
    bad[0] = (w[0][0].float(), w[0][1])                        # not i8 codes
    with pytest.raises(ValueError, match="K4 qkv_w codes"):
        layer.fused_bert_layer_i8(x, bias, *bad, nh=12)


def test_k4_encode_batch_on_cuda_matches_cpu(cuda):
    """layer_impl="layer_i8" on the card: K4 in every layer, K1 never."""
    cfg = bert.BertConfig(vocab_size=512, hidden_size=256, num_layers=2,
                          num_heads=4, intermediate_size=512,
                          max_position_embeddings=64, dtype=torch.bfloat16,
                          layer_impl="layer_i8")
    params = init_params(torch.Generator().manual_seed(0), cfg)
    rng = np.random.default_rng(3)
    ids = torch.from_numpy(rng.integers(5, 512, (8, 32)))
    mask = torch.ones((8, 32), dtype=torch.int32)
    mask[5, 7:] = 0
    before = dict(layer.launches)
    got = bert.encode_batch(bert.BertModel(cfg, params, device=cuda),
                            ids.to(cuda), mask.to(cuda)).cpu()
    assert layer.launches["kernel_bert_layer_i8"] == \
        before["kernel_bert_layer_i8"] + 2
    assert layer.launches["kernel_bert_layer"] == before["kernel_bert_layer"]
    want = bert.encode_batch(bert.BertModel(cfg, params, device="cpu"),
                             ids, mask)
    assert float((got * want).sum(-1).min()) > 0.999


def _rel(rng, S, nh, cuda):
    """MPNet's (nh, S, S) f32 bias from a seeded (32, nh) table."""
    table = torch.from_numpy(rng.standard_normal((32, nh), np.float32) * 0.5)
    return mpnet.position_bias(table.to(cuda), S, nh, 32)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("kernel", ["k1", "k4"])
@pytest.mark.parametrize("B,S", [(3, 128), (1, 512), (2, 16), (1, 128)])
def test_rel_bias_matches_plain(cuda, kernel, B, S, dtype):
    """all-mpnet-base-v2's width (H=768, 12 heads of 64, I=3072), ragged
    masks, eps 1e-5; each call counts under the `_rel` name only (`_rel_f32`
    at f32)."""
    H, nh, I = 768, 12, 3072
    dt = DTYPES[dtype]
    rng = np.random.default_rng(S + B)
    if kernel == "k4":
        x, bias, w, m = _k4_args(rng, B, S, H, I, cuda)
        x = x.to(dt)
        fused, plain = layer.fused_bert_layer_i8, layer.bert_layer_i8_plain
    else:
        x, bias, w, m = _k1_args(rng, B, S, cuda, dt, H, I)
        fused, plain = layer.fused_bert_layer, layer.bert_layer_plain
    rel = _rel(rng, S, nh, cuda)
    kw = _k1_form(w) if kernel == "k1" else w
    name = {"k1": "kernel_bert_layer", "k4": "kernel_bert_layer_i8"}[kernel]
    name += "_rel" + ("_f32" if dtype == "f32" else "")
    before = dict(layer.launches)
    got = fused(x, bias, *kw, nh=nh, eps=1e-5, rel_bias=rel).float()
    assert layer.launches == {**before, name: before[name] + 1}
    want = plain(x, bias, *w, nh=nh, eps=1e-5, rel_bias=rel).float()
    if kernel == "k1":
        _layer_bound(got, want, m, dt)
    else:
        assert torch.isfinite(got).all()
        cos = torch.nn.functional.cosine_similarity(got[m], want[m], dim=-1)
        assert float(cos.min()) >= K4_COS[dt]
    # a zero rel_bias adds exact zeros: bit-equal to the call without one
    assert torch.equal(fused(x, bias, *kw, nh=nh, eps=1e-5),
                       fused(x, bias, *kw, nh=nh, eps=1e-5,
                             rel_bias=torch.zeros_like(rel)))


@pytest.mark.parametrize("kernel", ["k1", "k4"])
def test_rel_bias_refusals(cuda, kernel):
    """A rel_bias the kernels do not take raises; nothing falls back to
    the plain twin."""
    rng = np.random.default_rng(5)
    B, S, nh = 2, 32, 12
    x, bias, w, _ = _k4_args(rng, B, S, 384, 1536, cuda)
    if kernel == "k4":
        fused = layer.fused_bert_layer_i8
    else:
        fused = layer.fused_bert_layer
        w = [torch.from_numpy(a).to(cuda, torch.bfloat16 if a.ndim == 2
                                    else None)
             for a in _layer_inputs(rng, B, S, 384, 1536)[3]]
    rel = _rel(rng, S, nh, cuda)
    before = dict(layer.launches)
    for bad in (rel[:, :, :16], rel[:6], rel.bfloat16(), rel.cpu(),
                rel.transpose(1, 2)):
        with pytest.raises(ValueError, match="rel_bias"):
            fused(x, bias, *w, nh=nh, rel_bias=bad)
    assert layer.launches == before


@pytest.mark.parametrize("impl", [dict(layer_impl="layer"),
                                  dict(layer_impl="layer_i8"),
                                  dict(layer_impl="ops")])
def test_mpnet_encode_batch_on_cuda_matches_cpu(cuda, impl):
    """An MPNet encoder on the card on each route against the same model
    on the CPU: K1 or K4 with rel_bias in every layer, or (per-op) einsum
    attention and K7, never K5 or K6."""
    cfg = bert.BertConfig(vocab_size=512, hidden_size=256, num_layers=2,
                          num_heads=4, intermediate_size=512,
                          max_position_embeddings=66, type_vocab_size=0,
                          layer_norm_eps=1e-5, model_type="mpnet",
                          pad_token_id=1, dtype=torch.bfloat16, **impl)
    params = init_params(torch.Generator().manual_seed(0), cfg)
    params["rel_bias"] = params["rel_bias"] * 25.0       # std 0.5
    rng = np.random.default_rng(4)
    ids = torch.from_numpy(rng.integers(5, 512, (8, 32)))
    mask = torch.ones((8, 32), dtype=torch.int32)
    mask[5, 7:] = 0
    ids[mask == 0] = 1
    counters = [attention.launches, ffn.launches, layer.launches]
    before = [dict(c) for c in counters]
    got = bert.encode_batch(mpnet.MPNetModel(cfg, params, device=cuda),
                            ids.to(cuda), mask.to(cuda)).cpu()
    ran = {k: c[k] - b[k] for c, b in zip(counters, before) for k in c}
    want = {"layer": {"kernel_bert_layer_rel": 2},
            "layer_i8": {"kernel_bert_layer_i8_rel": 2},
            "ops": {"kernel_ffn": 2}}[impl["layer_impl"]]
    assert {k: n for k, n in ran.items() if n} == want
    cpu = bert.encode_batch(mpnet.MPNetModel(cfg, params, device="cpu"),
                            ids, mask)
    assert float((got * cpu).sum(-1).min()) > 0.999


def _rows_and_queries(cuda, B, seed, n=32768):
    g = torch.Generator(device=cuda).manual_seed(seed)
    rows = torch.randn((n, 384), generator=g, device=cuda)
    rows = rows / rows.norm(dim=1, keepdim=True)
    q = rows[:B] + 0.1 * torch.randn((B, 384), generator=g, device=cuda)
    return rows, q / q.norm(dim=1, keepdim=True)


def _i4_codes(rows):
    vals, scales = quantize_i4_vals(rows)
    codes = torch.zeros((rows.shape[0] // 2, rows.shape[1]),
                        dtype=torch.uint8, device=rows.device)
    write_rows_i4(codes, vals, 0)
    return codes, scales


# B = 1, 8 and 32 (the searcher's batch buckets up to 32) over 32 tiles
# (the node's capacity of 524,288 rows): count mid-tile with 15 tiles
# wholly past it, inside the first tile, and full
NODE_SHAPES = [(B, 524288, count) for B in (1, 8, 32)
               for count in (270000, 5000, 524288)]


@pytest.mark.parametrize("B,n,count", [(8, 32768, 30000), (100, 32768, 32768),
                                       (1, 32768, 17), *NODE_SHAPES])
def test_k2_bit_equal_to_plain(cuda, B, n, count):
    rows, q = _rows_and_queries(cuda, B, B, n)
    codes, scales = quantize_rows_i8(rows)
    qq, qs = ss.quantize_queries(q)
    before = ss.launches["kernel_select"]
    got_v, got_i = ss.select_candidates(qq, qs, codes, scales, count)
    assert ss.launches["kernel_select"] == before + 1
    want_v, want_i = ss.select_candidates_plain(qq, qs, codes, scales, count)
    assert torch.equal(got_v.view(torch.int32), want_v.view(torch.int32))
    assert torch.equal(got_i, want_i)


@pytest.mark.parametrize("B,n,count", [(8, 32768, 30000), (70, 32768, 17000),
                                       *NODE_SHAPES])
def test_k3_bit_equal_to_plain(cuda, B, n, count):
    rows, q = _rows_and_queries(cuda, B, 10 + B, n)
    codes, scales = _i4_codes(rows)
    qq, qs = ss.quantize_queries(q)
    before = ss.launches["kernel_select_i4"]
    got_v, got_i = ss.select_candidates(qq, qs, codes, scales, count)
    assert ss.launches["kernel_select_i4"] == before + 1
    want_v, want_i = ss.select_candidates_plain(qq, qs, codes, scales, count)
    assert torch.equal(got_v.view(torch.int32), want_v.view(torch.int32))
    assert torch.equal(got_i, want_i)


@pytest.mark.parametrize("B", [40, 1])
@pytest.mark.parametrize("fmt", ["bf16", "i8", "i4"])
def test_bf16_query_variants_within_tolerance(cuda, fmt, B):
    rows, q = _rows_and_queries(cuda, B, 20)
    if fmt == "bf16":
        codes, scales = rows.bfloat16(), None
    elif fmt == "i8":
        codes, scales = quantize_rows_i8(rows)
    else:
        codes, scales = _i4_codes(rows)
    qb = q.bfloat16()
    name = ss.VARIANTS[(codes.dtype, False)]
    before = ss.launches[name]
    got_v, got_i = ss.select_candidates(qb, None, codes, scales, 30000)
    assert ss.launches[name] == before + 1
    want_v, want_i = ss.select_candidates_plain(qb, None, codes, scales, 30000)
    fin = torch.isfinite(want_v)
    assert torch.equal(torch.isfinite(got_v), fin)
    assert float((got_v - want_v)[fin].abs().max()) <= 3.1e-5
    assert float((got_i == want_i).float().mean()) >= 0.99
    got_d, got_top = ss.fold_topk(got_v, got_i, 10)
    want_d, want_top = ss.fold_topk(want_v, want_i, 10)
    assert torch.equal(got_top[:, 0], want_top[:, 0])


@pytest.mark.parametrize("dtype,name", [("i8", "kernel_select"),
                                        ("i4", "kernel_select_i4"),
                                        ("bf16", "kernel_select_bf16")])
def test_flat_index_fused_path_matches_cpu(cuda, dtype, name):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((20000, 384), np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    q = x[:16] + 0.2 * rng.standard_normal((16, 384), np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    got, want = (FlatIndex(dtype=dtype, exact="f16", device=d)
                 for d in (cuda, "cpu"))
    for ix in (got, want):
        ix.fused_min_rows = 0
        ix.add(x)
        assert ix.fused_eligible()
    before = ss.launches[name]
    d_gpu, i_gpu = got.search(q, 10)
    assert ss.launches[name] == before + 1
    d_cpu, i_cpu = want.search(q, 10)
    np.testing.assert_array_equal(i_gpu, i_cpu)
    np.testing.assert_allclose(d_gpu, d_cpu, atol=1e-5)


def test_encode_batch_on_cuda_matches_cpu(cuda):
    cfg = bert.BertConfig(vocab_size=512, hidden_size=128, num_layers=2,
                          num_heads=4, intermediate_size=256,
                          max_position_embeddings=64, dtype=torch.bfloat16)
    params = init_params(torch.Generator().manual_seed(0), cfg)
    rng = np.random.default_rng(2)
    ids = torch.from_numpy(rng.integers(5, 512, (8, 32)))
    mask = torch.ones((8, 32), dtype=torch.int32)
    mask[3, 9:] = 0
    got = bert.encode_batch(bert.BertModel(cfg, params, device=cuda),
                            ids.to(cuda), mask.to(cuda)).cpu()
    want = bert.encode_batch(bert.BertModel(cfg, params, device="cpu"),
                             ids, mask)
    cos = (got * want).sum(-1)
    assert float(cos.min()) > 0.999


def _row_cos(got, want, width):
    g, w = got.float().reshape(-1, width), want.float().reshape(-1, width)
    return torch.nn.functional.cosine_similarity(g, w, dim=-1)


def _bias(rng, B, S, cuda):
    lengths = rng.integers(1, S + 1, B)
    lengths[0] = S
    mask = np.arange(S)[None, :] < lengths[:, None]
    return torch.from_numpy(np.where(mask, 0.0, -1e30).astype(np.float32)).to(cuda)


def _per_op_bound(got, want, width, dtype):
    """K5-K7 vs their twins: per-row cosine > 0.9999 in bf16 (the same
    rounding points, f32 sums in another order); in f32 max |d| <= 1e-5
    of the output's scale and cosine >= 0.99999."""
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    cos = float(_row_cos(got, want, width).min())
    if dtype == torch.bfloat16:
        assert cos > 0.9999
    else:
        assert float((got - want).abs().max()) <= 1e-5 * float(
            want.abs().max())
        assert cos >= 0.99999


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("B,S,H", [(3, 16, 384), (2, 128, 384), (1, 512, 384),
                                   (2, 64, 768)])
def test_k5_matches_plain(cuda, B, S, H, dtype):
    """q, k, v as column slices of one (B, S, 3H) projection output."""
    dt = DTYPES[dtype]
    rng = np.random.default_rng(S + H)
    qkv = torch.from_numpy(rng.standard_normal((B, S, 3 * H), np.float32)
                           ).to(cuda, dt)
    q, k, v = qkv.split(H, dim=-1)
    bias = _bias(rng, B, S, cuda)
    name = "kernel_attention_packed" + ("_f32" if dtype == "f32" else "")
    before = dict(attention.launches)
    got = attention.fused_attention_packed(q, k, v, bias, 12)
    assert got.dtype == dt
    assert attention.launches == {**before, name: before[name] + 1}
    want = attention.attention_packed_plain(q, k, v, bias, 12)
    _per_op_bound(got, want, H, dt)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("B,S,hd", [(2, 128, 26), (1, 512, 26), (3, 16, 26),
                                    (2, 128, 32), (2, 64, 64)])
def test_k6_matches_plain(cuda, B, S, hd, dtype):
    dt = DTYPES[dtype]
    rng = np.random.default_rng(S + hd)
    q, k, v = (torch.from_numpy(rng.standard_normal((B, 12, S, hd), np.float32)
                                ).to(cuda, dt) for _ in range(3))
    bias = _bias(rng, B, S, cuda)
    name = "kernel_attention" + ("_f32" if dtype == "f32" else "")
    before = dict(attention.launches)
    got = attention.fused_attention(q, k, v, bias, 12)
    assert got.dtype == dt
    assert attention.launches == {**before, name: before[name] + 1}
    want = attention.attention_plain(q, k, v, bias, 12)
    _per_op_bound(got, want, hd, dt)
    # no bias is a zero bias
    assert torch.equal(attention.fused_attention(q, k, v, None, 12),
                       attention.fused_attention(q, k, v, torch.zeros_like(bias),
                                                 12))


def _ffn_args(rng, M, H, I, cuda, dtype=torch.bfloat16):
    x, _, _, weights = _layer_inputs(rng, 1, M, H, I)
    w1, b1, w2, b2, g, be = weights[6:]
    return [torch.from_numpy(x[0]).to(cuda, dtype),
            *[torch.from_numpy(a).to(cuda, dtype if a.ndim == 2 else None)
              for a in (w1, b1, w2, b2, g, be)]]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("M,H,I", [(100, 384, 1536), (64, 312, 1200),
                                   (40, 768, 3072), (16, 128, 256),
                                   (128, 768, 3072), (64, 1024, 8192)])
def test_k7_matches_plain(cuda, M, H, I, dtype):
    """K7 (two launches of the GEMM ring; at f32 its matrices as
    tf32_pair pairs, as the model holds them) against ffn_plain on the
    (in, out) matrices, at ragged widths and at 1024/8192."""
    dt = DTYPES[dtype]
    args = _ffn_args(np.random.default_rng(H), M, H, I, cuda, dt)
    name = "kernel_ffn" + ("_f32" if dtype == "f32" else "")
    before = dict(ffn.launches)
    got = ffn.fused_ffn(args[0], *_k1_form(args[1:]))
    assert got.dtype == dt
    assert ffn.launches == {**before, name: before[name] + 1}
    want = ffn.ffn_plain(*args)
    _per_op_bound(got, want, H, dt)


def _pool_inputs(rng, B, S, H, cuda, dtype=torch.float32):
    hidden = torch.from_numpy(rng.standard_normal((B, S, H), np.float32))
    mask = (_bias(rng, B, S, cuda) == 0).int()
    return hidden.to(cuda, dtype), mask


@pytest.mark.parametrize("include_padding", [False, True])
@pytest.mark.parametrize("H", [312, 384, 1024, 1536, 2048, 4096])
@pytest.mark.parametrize("B,S", [(1, 128), (8, 128), (3, 16), (2, 512),
                                 (5, 7)])
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_k8_matches_plain(cuda, dtype, B, S, H, include_padding):
    """K8 in either dtype, at ragged widths (312: scalar loads), widths
    past the old 1024 cap, and S not a multiple of 16; one launch."""
    hidden, mask = _pool_inputs(np.random.default_rng(S + H), B, S, H, cuda,
                                DTYPES[dtype])
    before = attention.launches["kernel_mean_pool"]
    got = attention.fused_mean_pool(hidden, mask, include_padding)
    assert attention.launches["kernel_mean_pool"] == before + 1
    assert got.dtype == torch.float32 and got.shape == (B, H)
    want = attention.mean_pool_plain(hidden, mask, include_padding)
    assert float((got - want).abs().max()) <= 1e-5
    assert float((got.norm(dim=-1) - 1).abs().max()) <= 1e-5


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_k8_at_the_ingest_shape(cuda, dtype):
    """K8 at B = 1024, S = 512, H = 384: one launch, within 1e-5 of the
    plain twin, unit rows."""
    B, S, H = 1024, 512, 384
    hidden, mask = _pool_inputs(np.random.default_rng(B), B, S, H, cuda,
                                DTYPES[dtype])
    before = attention.launches["kernel_mean_pool"]
    got = attention.fused_mean_pool(hidden, mask)
    assert attention.launches["kernel_mean_pool"] == before + 1
    assert got.dtype == torch.float32 and got.shape == (B, H)
    want = attention.mean_pool_plain(hidden, mask)
    assert float((got - want).abs().max()) <= 1e-5
    assert float((got.norm(dim=-1) - 1).abs().max()) <= 1e-5


@pytest.mark.parametrize("include_padding", [False, True])
@pytest.mark.parametrize("B", [128, 256])
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_k8_one_cta_a_sequence_matches_plain(cuda, dtype, B,
                                             include_padding):
    """The node's ingest buckets of 128 and 256 sequences fill the card
    alone: plan_pool gives each sequence one CTA, launched with no
    cluster, which reads its own shared memory."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    cc, r = attention.plan_pool(B, 128, 384, sms)[:2]
    assert cc * r == 1
    hidden, mask = _pool_inputs(np.random.default_rng(B), B, 128, 384, cuda,
                                DTYPES[dtype])
    got = attention.fused_mean_pool(hidden, mask, include_padding)
    want = attention.mean_pool_plain(hidden, mask, include_padding)
    assert float((got - want).abs().max()) <= 1e-5
    assert float((got.norm(dim=-1) - 1).abs().max()) <= 1e-5


@pytest.mark.parametrize("B,S,H", [(1, 128, 384), (8, 512, 1024),
                                   (5, 7, 312), (2, 512, 4096)])
def test_k8_bf16_is_bit_equal_to_f32_of_the_same_values(cuda, B, S, H):
    """bf16 -> f32 is exact and the order of K8's sums depends on the
    plan alone, so the bf16 instance gives the f32 instance's bits on the
    upcast input."""
    hidden, mask = _pool_inputs(np.random.default_rng(H), B, S, H, cuda,
                                torch.bfloat16)
    for pad in (False, True):
        assert torch.equal(attention.fused_mean_pool(hidden, mask, pad),
                           attention.fused_mean_pool(hidden.float(), mask,
                                                     pad))


@pytest.mark.parametrize("B,S,H", [(1, 8, 65536), (2, 16, 12288)])
def test_k8_widest_rows(cuda, B, S, H):
    """Wide rows take several column chunks: 6 at H = 12,288, and 16 (a
    non-portable cluster) at H = 65,536, the widest K8 takes."""
    hidden, mask = _pool_inputs(np.random.default_rng(H), B, S, H, cuda,
                                torch.bfloat16)
    got = attention.fused_mean_pool(hidden, mask)
    want = attention.mean_pool_plain(hidden, mask)
    assert float((got - want).abs().max()) <= 1e-5
    with pytest.raises(ValueError, match="over 65536"):
        attention.fused_mean_pool(torch.zeros((1, 1, 65544), device=cuda),
                                  mask[:1, :1])


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_k8_is_deterministic(cuda, dtype):
    """One launch, fixed-order sums over the cluster, no atomics: two
    calls give the same bits."""
    hidden, mask = _pool_inputs(np.random.default_rng(9), 8, 512, 2048,
                                cuda, DTYPES[dtype])
    first = attention.fused_mean_pool(hidden, mask)
    assert torch.equal(first, attention.fused_mean_pool(hidden, mask))


def test_k8_reads_every_mask_dtype_and_layout(cuda):
    """bool, int32, int64 and f32 masks, and a strided view, read in place
    with no cast: the same bits."""
    hidden, mask = _pool_inputs(np.random.default_rng(4), 8, 128, 384, cuda,
                                torch.bfloat16)
    want = attention.fused_mean_pool(hidden, mask)
    wide = torch.zeros((8, 256), dtype=torch.int64, device=cuda)
    wide[:, ::2] = mask
    for m in (mask.bool(), mask.long(), mask.float(), wide[:, ::2]):
        assert torch.equal(attention.fused_mean_pool(hidden, m), want)


def test_per_op_kernels_refuse_what_they_do_not_take(cuda):
    rng = np.random.default_rng(0)
    qkv = torch.from_numpy(rng.standard_normal((2, 32, 3 * 384), np.float32)
                           ).to(cuda)
    q, k, v = qkv.bfloat16().split(384, dim=-1)
    q32, k32, v32 = qkv.split(384, dim=-1)
    with pytest.raises(ValueError, match="k must match q"):     # a dtype mix
        attention.fused_attention_packed(q32, k, v32, None, 12)
    with pytest.raises(ValueError, match="bf16 or f32"):
        attention.fused_attention_packed(*qkv.half().split(384, dim=-1),
                                         None, 12)
    with pytest.raises(ValueError, match="128 % head_dim"):
        attention.fused_attention_packed(q, k, v, None, 16)  # hd 24
    with pytest.raises(ValueError, match="S % 16"):
        attention.fused_attention_packed(q[:, :20], k[:, :20], v[:, :20],
                                         None, 12)
    with pytest.raises(ValueError, match="unit feature stride"):
        t = q.transpose(1, 2).contiguous().transpose(1, 2)
        attention.fused_attention_packed(t, t, t, None, 12)
    heads = q.reshape(2, 32, 12, 32).transpose(1, 2)          # a strided view
    with pytest.raises(ValueError, match="contiguous"):
        attention.fused_attention(heads, heads, heads, None, 12)
    h16, h32 = heads.contiguous(), heads.float().contiguous()
    with pytest.raises(ValueError, match="v must match q"):     # a dtype mix
        attention.fused_attention(h32, h32, h16, None, 12)
    with pytest.raises(ValueError, match="bf16 or f32"):
        attention.fused_attention(h16.half(), h16.half(), h16.half(), None, 12)
    big = torch.zeros((1, 2, 16, 160), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="hd <= 128"):
        attention.fused_attention(big, big, big, None, 2)
    long = torch.zeros((1, 1, 528, 32), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="S <= 512"):
        attention.fused_attention(long, long, long, None, 1)

    args = _ffn_args(rng, 32, 384, 1536, cuda)
    with pytest.raises(ValueError, match="K7 w1"):              # a dtype mix
        ffn.fused_ffn(args[0].float(), *args[1:])
    args32 = _ffn_args(rng, 32, 384, 1536, cuda, torch.float32)
    with pytest.raises(ValueError, match="K7 w1"):              # the reverse
        ffn.fused_ffn(args[0], *args32[1:])
    with pytest.raises(ValueError, match="bf16 or f32"):
        ffn.fused_ffn(args[0].half(), *args[1:])
    with pytest.raises(ValueError, match="non-contiguous"):
        xt = args[0].t().contiguous().t()
        ffn.fused_ffn(xt, *args[1:])
    odd = _ffn_args(rng, 16, 100, 256, cuda)                   # H % 8 != 0
    with pytest.raises(ValueError, match="multiples of 8"):
        ffn.fused_ffn(*odd)
    wide = _ffn_args(rng, 16, 2176, 256, cuda)                 # 17 CTAs
    with pytest.raises(ValueError, match="H <= 2048"):
        ffn.fused_ffn(*wide)
    w1 = layer.tf32_pair(args32[1])                             # plain f32 W2
    with pytest.raises(ValueError, match=r"K7 w2: at f32 .*\(W_hi, W_lo\)"):
        ffn.fused_ffn(args32[0], w1, *args32[2:])

    hidden = torch.zeros((2, 32, 384), device=cuda)
    mask = torch.ones((2, 32), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="bf16 or f32"):
        attention.fused_mean_pool(hidden.half(), mask)
    with pytest.raises(ValueError, match="int64 or f32 mask"):
        attention.fused_mean_pool(hidden, mask.half())
    with pytest.raises(ValueError, match="non-contiguous"):
        attention.fused_mean_pool(hidden.transpose(0, 1).contiguous()
                                  .transpose(0, 1), mask)
    with pytest.raises(ValueError, match="mask"):
        attention.fused_mean_pool(hidden, mask[:, :16])


@pytest.mark.parametrize("impl", [dict(layer_impl="ops", pool_impl="fused"),
                                  dict(attn_impl="xla"),
                                  dict(hidden_size=312, num_heads=12,
                                       intermediate_size=1200)])
def test_per_op_encode_batch_on_cuda_matches_cpu(cuda, impl):
    """The per-op routes on the card (K5 + K7 + K8; einsum + K7; the
    TinyBERT-width fallback to K6 + K7) against the same model on the
    CPU; K1 never runs."""
    shape = dict(vocab_size=512, hidden_size=128, num_layers=2, num_heads=4,
                 intermediate_size=256, max_position_embeddings=64,
                 dtype=torch.bfloat16)
    cfg = bert.BertConfig(**{**shape, **impl})
    params = init_params(torch.Generator().manual_seed(0), cfg)
    rng = np.random.default_rng(2)
    ids = torch.from_numpy(rng.integers(5, 512, (8, 32)))
    mask = torch.ones((8, 32), dtype=torch.int32)
    mask[3, 9:] = 0
    k1 = layer.launches["kernel_bert_layer"]
    got = bert.encode_batch(bert.BertModel(cfg, params, device=cuda),
                            ids.to(cuda), mask.to(cuda)).cpu()
    assert layer.launches["kernel_bert_layer"] == k1
    want = bert.encode_batch(bert.BertModel(cfg, params, device="cpu"),
                             ids, mask)
    cos = (got * want).sum(-1)
    assert float(cos.min()) > 0.999


F32_ROUTES = {
    "layer": (dict(layer_impl="layer"), {"kernel_bert_layer_f32": 2}),
    "layer_i8": (dict(layer_impl="layer_i8"), {"kernel_bert_layer_i8_f32": 2}),
    "ops+fused pool": (dict(layer_impl="ops", pool_impl="fused"),
                       {"kernel_attention_packed_f32": 2, "kernel_ffn_f32": 2,
                        "kernel_mean_pool": 1}),
    "tinybert width": (dict(hidden_size=312, num_heads=12,
                            intermediate_size=1200),
                       {"kernel_attention_f32": 2, "kernel_ffn_f32": 2}),
    "mpnet layer": (dict(model_type="mpnet", type_vocab_size=0,
                         pad_token_id=1, layer_norm_eps=1e-5),
                    {"kernel_bert_layer_rel_f32": 2}),
    "mpnet layer_i8": (dict(model_type="mpnet", type_vocab_size=0,
                            pad_token_id=1, layer_norm_eps=1e-5,
                            layer_impl="layer_i8"),
                       {"kernel_bert_layer_i8_rel_f32": 2}),
}


@pytest.mark.parametrize("route", sorted(F32_ROUTES))
def test_f32_encode_batch_on_cuda_matches_cpu(cuda, route):
    """compute_dtype = "f32" on the card, each route against the same model
    on the CPU: only the route's f32 kernels run (each bf16 counter stays
    0); embeddings within the reference's f32 atol 1e-4 (K4's routes:
    per-row cosine >= 0.99995)."""
    impl, want_ran = F32_ROUTES[route]
    shape = dict(vocab_size=512, hidden_size=128, num_layers=2, num_heads=4,
                 intermediate_size=256, max_position_embeddings=66,
                 dtype=torch.float32)
    cfg = bert.BertConfig(**{**shape, **impl})
    params = init_params(torch.Generator().manual_seed(0), cfg)
    family = mpnet.MPNetModel if cfg.model_type == "mpnet" else bert.BertModel
    if cfg.model_type == "mpnet":
        params["rel_bias"] = params["rel_bias"] * 25.0       # std 0.5
    rng = np.random.default_rng(7)
    ids = torch.from_numpy(rng.integers(5, 512, (8, 32)))
    mask = torch.ones((8, 32), dtype=torch.int32)
    mask[3, 9:] = 0
    ids[mask == 0] = cfg.pad_token_id
    counters = [attention.launches, ffn.launches, layer.launches]
    before = [dict(c) for c in counters]
    got = bert.encode_batch(family(cfg, params, device=cuda), ids.to(cuda),
                            mask.to(cuda)).cpu()
    ran = {k: c[k] - b[k] for c, b in zip(counters, before) for k in c}
    assert {k: n for k, n in ran.items() if n} == want_ran
    want = bert.encode_batch(family(cfg, params, device="cpu"), ids, mask)
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    if cfg.layer_impl == "layer_i8":
        assert float((got * want).sum(-1).min()) >= 0.99995
    else:
        assert float((got - want).abs().max()) <= 1e-4


def test_f32_on_cuda_never_reaches_the_plain_twin(cuda, monkeypatch):
    """Every wrapper given f32 CUDA tensors launches its f32 kernel: with
    each plain twin replaced by one that fails, all of them still run."""
    def boom(*args, **kwargs):
        raise AssertionError("a plain twin ran on CUDA tensors")
    for mod, name in ((layer, "bert_layer_plain"),
                      (layer, "bert_layer_i8_plain"),
                      (layer, "attention_f32_plain"),
                      (attention, "attention_plain"),
                      (attention, "attention_packed_plain"),
                      (attention, "mean_pool_plain"),
                      (ffn, "ffn_plain")):
        monkeypatch.setattr(mod, name, boom)
    f32 = torch.float32
    rng = np.random.default_rng(9)
    x, bias, w, _ = _k1_args(rng, 2, 32, cuda, f32)
    assert layer.fused_bert_layer(x, bias, *_k1_form(w), nh=12).dtype == f32
    _, _, w8, _ = _k4_args(rng, 2, 32, 384, 1536, cuda)
    assert layer.fused_bert_layer_i8(x, bias, *w8, nh=12).dtype == f32
    qkv = torch.from_numpy(rng.standard_normal((2, 32, 3 * 384), np.float32)
                           ).to(cuda)
    q, k, v = qkv.split(384, dim=-1)
    assert attention.fused_attention_packed(q, k, v, bias, 12).dtype == f32
    heads = q.reshape(2, 32, 12, 32).transpose(1, 2).contiguous()
    assert attention.fused_attention(heads, heads, heads, bias, 12).dtype == f32
    args = _ffn_args(rng, 64, 384, 1536, cuda, f32)
    assert ffn.fused_ffn(args[0], *_k1_form(args[1:])).dtype == f32
    assert attention.fused_mean_pool(x, (bias == 0).int()).dtype == f32


# -- K1's TMA + wgmma GEMM and the mma.sync attention -----------------------

@pytest.mark.parametrize("H,nh", [(384, 12), (768, 12), (1024, 16), (1280, 10)])
@pytest.mark.parametrize("B,S", [(3, 16), (1, 16), (1, 128)])
def test_k1_every_cluster_width_at_ragged_rows(cuda, B, S, H, nh):
    """M = B·S = 48, 16 and 128 rows (not a multiple of the GEMM's 64- or
    128-row tiles: TMA reads zeros past M, the stores mask them) at every
    LayerNorm cluster width: 3, 6, 8 and 10 CTAs (a non-portable
    cluster), I = 4H; the reference's bf16 bound (per-token cosine >
    0.999)."""
    xt, bt, w, m = _k1_args(np.random.default_rng(H + S + B), B, S, cuda,
                            torch.bfloat16, H, 4 * H)
    got = layer.fused_bert_layer(xt, bt, *w, nh=nh).float()
    want = layer.bert_layer_plain(xt, bt, *w, nh=nh).float()
    _layer_bound(got, want, m, torch.bfloat16)


@pytest.mark.parametrize("epi", ["qkv", "attn_out", "ffn_in", "ffn_out"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("M,H,I", [(128, 384, 1536), (200, 768, 3072),
                                   (4096, 1024, 4096), (48, 128, 256)])
def test_k4_gemms_match_the_plain_arithmetic(cuda, M, H, I, dtype, epi):
    """Each of K4's s8 GEMMs alone (ops/layer.py::_gemm_i8) against the
    twin's arithmetic on the same operands, at rows that are not a multiple
    of its tiles and LayerNorm clusters of 1 to 8 CTAs: the qkv and FFN-in
    products' dequantized outputs within one rounding of the twin's
    (exact s32 sums, the same f32 steps: bit-equal before the GELU and the
    cast to dt), the FFN-in GEMM's partial absmax bit-equal to that of the
    h it wrote; the LayerNorm ones at per-row cosine >= 0.9999, with the
    attention-out GEMM's x1 codes and factors bit-equal to quant_rows of
    the x1 it wrote, and the FFN-out one quantizing its f32 h itself from
    the partials."""
    dt = DTYPES[dtype]
    rng = np.random.default_rng(M + H + I)

    def t(*shape, s=1.0, base=0.0, d=torch.float32):
        return torch.from_numpy((base + s * rng.standard_normal(shape)
                                 ).astype(np.float32)).to(cuda, d)
    K, N = {"qkv": (H, 3 * H), "attn_out": (H, H), "ffn_in": (H, I),
            "ffn_out": (I, H)}[epi]
    w = tuple(u.to(cuda) for u in i8_weight(t(K, N, s=0.05).cpu()))
    b = t(N, s=0.1)
    if epi in ("qkv", "ffn_in"):
        a = t(M, K, d=dt if epi == "qkv" else torch.float32)
        aq, rf = layer.quant_rows(a.float())
        want = layer._mm_codes(aq, rf, *w) + b
        if epi == "qkv":
            got = layer._gemm_i8(aq, w, b, 0, dt=dt, rf=rf)
            assert got.dtype == dt
            assert torch.equal(got, want.to(dt))
            return
        got, part = layer._gemm_i8(aq, w, b, 1, dt=dt, rf=rf)
        assert got.dtype == torch.float32 and part.shape == (M, N // 128)
        want = 0.5 * want * (1.0 + ffn.erf_poly(want * 2.0 ** -0.5))
        assert float((got - want).abs().max()) <= 1e-6 * float(
            want.abs().max())
        assert torch.equal(part, got.abs().reshape(M, -1, 128).amax(dim=-1))
        return
    a = t(M, K)
    resid = t(M, N, d=dt if epi == "attn_out" else torch.float32)
    ln_s, ln_b = t(N, s=0.1, base=1.0), t(N, s=0.1)
    aq, rf = layer.quant_rows(a)
    want = layer_norm(layer._mm_codes(aq, rf, *w) + b + resid.float(), ln_s,
                      ln_b, 1e-12)
    if epi == "attn_out":
        got, got_q, got_rf = layer._gemm_i8(
            aq, w, b, 2, dt=dt, rf=rf, resid=resid, ln_s=ln_s, ln_b=ln_b)
        want_q, want_rf = layer.quant_rows(got)
        assert torch.equal(got_q, want_q)
        assert torch.equal(got_rf.view(torch.int32), want_rf.view(torch.int32))
        assert got.dtype == torch.float32
    else:
        part = a.abs().reshape(M, -1, 128).amax(dim=-1)
        got = layer._gemm_i8(a, w, b, 2, dt=dt, part=part, resid=resid,
                             ln_s=ln_s, ln_b=ln_b)
        assert got.dtype == dt
    assert torch.isfinite(got).all()
    assert float(_row_cos(got, want, N).min()) >= 0.9999


def _gemm_want(a, w, b, epi, resid, ln_s, ln_b):
    """The f32 product of the bf16 operands with K1's epilogue in f32."""
    y = a.float() @ w.float() + b
    if epi == 1:
        return 0.5 * y * (1.0 + ffn.erf_poly(y * 2.0 ** -0.5))
    if epi == 2:
        return layer_norm(y + resid.float(), ln_s, ln_b, 1e-12)
    return y


@pytest.mark.parametrize("epi", [0, 1, 2])
@pytest.mark.parametrize("M,K,N", [(48, 384, 1152), (128, 1536, 384),
                                   (4096, 1024, 1024), (16, 2048, 2048)])
def test_k1_gemm_epilogues_match_the_f32_product(cuda, M, K, N, epi):
    """Each epilogue of csrc/layer.cu::dawn_bert_gemm alone (bias, GELU,
    residual + LayerNorm over a cluster of N / 128 CTAs, up to 16) against
    the f32 product rounded to bf16: per-row cosine >= 0.9999 and max |d|
    within 2^-7 of the output's scale (one bf16 rounding of the same f32
    value, whose sums differ only in order)."""
    rng = np.random.default_rng(M + K + N + epi)

    def t(*shape, s=1.0, base=0.0, dt=None):
        return torch.from_numpy((base + s * rng.standard_normal(shape)
                                 ).astype(np.float32)).to(cuda, dt)
    a = t(M, K, dt=torch.bfloat16)
    w = t(K, N, s=0.05, dt=torch.bfloat16)
    b = t(N, s=0.1)
    resid, ln_s, ln_b = ((t(M, N, dt=torch.bfloat16), t(N, s=0.1, base=1.0),
                          t(N, s=0.1)) if epi == 2 else (None, None, None))
    got = layer._gemm(a, w, b, epi, resid, ln_s, ln_b)
    assert got.dtype == torch.bfloat16 and got.shape == (M, N)
    want = _gemm_want(a, w, b, epi, resid, ln_s, ln_b).to(torch.bfloat16)
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    assert float(_row_cos(got, want, N).min()) >= 0.9999
    assert float((got - want).abs().max()) <= 2 ** -7 * float(
        want.abs().max())


def _gemm_want_f64(a, w, b, epi, resid, ln_s, ln_b):
    """The f64 product of the f32 operands with K1's epilogue in f64."""
    y = a.double() @ w.double() + b.double()
    if epi == 1:
        return 0.5 * y * (1.0 + ffn.erf_poly(y * 2.0 ** -0.5))
    if epi == 2:
        return layer_norm(y + resid.double(), ln_s.double(), ln_b.double(),
                          1e-12)
    return y


@pytest.mark.parametrize("epi", [0, 1, 2])
@pytest.mark.parametrize("M,K,N", [(128, 384, 1152), (128, 1536, 384),
                                   (128, 3072, 768), (8192, 384, 1536),
                                   (8192, 3072, 768), (48, 768, 768),
                                   (16, 2048, 2048)])
def test_k1_f32_gemm_epilogues_match_the_f64_product(cuda, M, K, N, epi):
    """Each epilogue of dawn_bert_gemm at f32 alone (3xTF32 on the TF32
    wgmma, W as its (W_hi, W_lo) pair), at one query's M = 128 and a
    batch's 8192 rows, at rows past the tiles (48, 16) and at a LayerNorm
    cluster of 16: max |d| within 1e-5 of the output's scale and per-row
    cosine >= 0.99999 against the f64 product (the f32 kernels' bound)."""
    rng = np.random.default_rng(M + K + N + epi)

    def t(*shape, s=1.0, base=0.0):
        return torch.from_numpy((base + s * rng.standard_normal(shape)
                                 ).astype(np.float32)).to(cuda)
    a, w, b = t(M, K), t(K, N, s=0.05), t(N, s=0.1)
    resid, ln_s, ln_b = ((t(M, N), t(N, s=0.1, base=1.0), t(N, s=0.1))
                         if epi == 2 else (None, None, None))
    got = layer._gemm(a, layer.tf32_pair(w), b, epi, resid, ln_s, ln_b)
    assert got.dtype == torch.float32 and got.shape == (M, N)
    want = _gemm_want_f64(a, w, b, epi, resid, ln_s, ln_b)
    assert torch.isfinite(got).all()
    assert float((got.double() - want).abs().max()) <= 1e-5 * float(
        want.abs().max())
    assert float(_row_cos(got, want, N).min()) >= 0.99999


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("M,K,N,epi", [(200, 1200, 312, 2), (200, 312, 1200, 1),
                                       (16, 312, 1200, 1)])
def test_gemm_ragged_last_column_tile(cuda, M, K, N, epi, dtype):
    """ops/layer.py::_gemm at an N that is not a multiple of 128, as K7
    runs it at TinyBERT's width: the LayerNorm over a cluster of 3 CTAs
    (312 = 128 + 128 + 56) and the GELU GEMM's 10th tile of 48 columns,
    rows ragged too. Against the same products with the epilogue in f32
    (bf16: rounded once, per-row cosine >= 0.9999 and max |d| within 2^-7
    of the scale) or f64 (f32, 3xTF32: max |d| within 1e-5 of the scale,
    cosine >= 0.99999)."""
    dt = DTYPES[dtype]
    rng = np.random.default_rng(M + K + N)

    def t(*shape, s=1.0, base=0.0, dtype=None):
        return torch.from_numpy((base + s * rng.standard_normal(shape)
                                 ).astype(np.float32)).to(cuda, dtype)
    a, w, b = t(M, K, dtype=dt), t(K, N, s=0.05, dtype=dt), t(N, s=0.1)
    resid, ln_s, ln_b = ((t(M, N, dtype=dt), t(N, s=0.1, base=1.0),
                          t(N, s=0.1)) if epi == 2 else (None, None, None))
    kw = layer.tf32_pair(w) if dt == torch.float32 else w
    got = layer._gemm(a, kw, b, epi, resid, ln_s, ln_b)
    assert got.dtype == dt and got.shape == (M, N)
    assert torch.isfinite(got).all()
    if dt == torch.float32:
        want = _gemm_want_f64(a, w, b, epi, resid, ln_s, ln_b)
        assert float((got.double() - want).abs().max()) <= 1e-5 * float(
            want.abs().max())
        assert float(_row_cos(got, want, N).min()) >= 0.99999
    else:
        want = _gemm_want(a, w, b, epi, resid, ln_s, ln_b).to(dt).float()
        got = got.float()
        assert float(_row_cos(got, want, N).min()) >= 0.9999
        assert float((got - want).abs().max()) <= 2 ** -7 * float(
            want.abs().max())


def test_gemm_refuses_a_ragged_bias_gemm(cuda):
    """The ragged last column tile is built for the GELU and LayerNorm
    epilogues only (K7's two launches): a bias GEMM at N = 312 is refused
    (CUDA's invalid-value error)."""
    a = torch.zeros((16, 256), dtype=torch.bfloat16, device=cuda)
    w = torch.zeros((256, 312), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(RuntimeError, match="CUDA error"):
        layer._gemm(a, w, torch.zeros(312, device=cuda), 0)


def test_k1_f32_replays_in_a_cuda_graph(cuda):
    """K1 at f32 captured once in a CUDA graph and replayed on new inputs
    copied into the captured ones gives, bit for bit, what its eager call
    gives on the same input."""
    rng = np.random.default_rng(24)
    x, bias, w, _ = _k1_args(rng, 2, 64, cuda, torch.float32)
    kw = _k1_form(w)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            layer.fused_bert_layer(x, bias, *kw, nh=12)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y = layer.fused_bert_layer(x, bias, *kw, nh=12)
    for seed in (25, 26):
        fresh, _, _, _ = _k1_args(np.random.default_rng(seed), 2, 64, cuda,
                                  torch.float32)
        x.copy_(fresh)
        graph.replay()
        eager = layer.fused_bert_layer(x.clone(), bias, *kw, nh=12)
        torch.cuda.synchronize()
        assert torch.equal(y, eager)


def test_k1_gemm_refuses_a_cluster_past_sixteen(cuda):
    """A LayerNorm over N = 2176 would need 17 CTAs in a cluster: refused
    (CUDA's invalid-value error), never split or shrunk."""
    a = torch.zeros((16, 256), dtype=torch.bfloat16, device=cuda)
    w = torch.zeros((256, 2176), dtype=torch.bfloat16, device=cuda)
    v = torch.zeros(2176, device=cuda)
    resid = torch.zeros((16, 2176), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(RuntimeError, match="LN: CUDA error"):
        layer._gemm(a, w, v, 2, resid, v, v)


def test_k1_replays_in_a_cuda_graph(cuda):
    """fused_bert_layer captured once in a CUDA graph, then replayed on new
    inputs copied into the captured ones: the tensor maps ride in the
    kernels' parameters (__grid_constant__), so every replay reads the
    captured buffers and matches the plain twin on the current input."""
    rng = np.random.default_rng(21)
    x, bias, w, m = _k1_args(rng, 2, 64, cuda, torch.bfloat16)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            layer.fused_bert_layer(x, bias, *w, nh=12)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y = layer.fused_bert_layer(x, bias, *w, nh=12)
    for seed in (22, 23):
        fresh, _, _, _ = _k1_args(np.random.default_rng(seed), 2, 64, cuda,
                                  torch.bfloat16)
        x.copy_(fresh)
        graph.replay()
        torch.cuda.synchronize()
        want = layer.bert_layer_plain(x, bias, *w, nh=12).float()
        _layer_bound(y.float(), want, m, torch.bfloat16)


ATTN_S = [16, 48, 128, 512]


def _misaligned(shape, cuda, rng):
    """A contiguous bf16 tensor whose storage starts 2 bytes past a
    16-byte boundary."""
    flat = torch.empty(int(np.prod(shape)) + 1, dtype=torch.bfloat16,
                       device=cuda)
    t = flat[1:].view(shape)
    t.copy_(torch.from_numpy(rng.standard_normal(shape, np.float32)))
    return t


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("hd", [16, 32, 64, 128])
@pytest.mark.parametrize("S", ATTN_S)
def test_k5_every_head_dim_and_layout(cuda, S, hd, aligned):
    """K5 at H = 384 (nh = 384 / hd) on q, k, v cut from one (B, S, ld)
    buffer: ld = 3H with 16-byte rows (cp.async staging), or ld = 3H + 3
    and a 2-byte offset (element staging); KERNEL_COS_MIN."""
    H, B = 384, 2
    nh = H // hd
    rng = np.random.default_rng(S + hd + aligned)
    ld, off = (3 * H, 0) if aligned else (3 * H + 3, 1)
    buf = torch.from_numpy(rng.standard_normal((B, S, ld), np.float32)
                           ).to(cuda, torch.bfloat16)
    q, k, v = (buf[..., off + i * H: off + (i + 1) * H] for i in range(3))
    bias = _bias(rng, B, S, cuda)
    got = attention.fused_attention_packed(q, k, v, bias, nh)
    want = attention.attention_packed_plain(q, k, v, bias, nh)
    _per_op_bound(got, want, H, torch.bfloat16)


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("hd", [16, 26, 32, 64, 128])
@pytest.mark.parametrize("S", ATTN_S)
def test_k6_every_head_dim_and_layout(cuda, S, hd, aligned):
    """K6 on (B, 4, S, hd), 16-byte aligned or starting 2 bytes past a
    16-byte boundary; hd 26 stages element by element either way;
    KERNEL_COS_MIN."""
    B, nh = 2, 4
    rng = np.random.default_rng(S + hd + 2 * aligned)
    if aligned:
        q, k, v = (torch.from_numpy(rng.standard_normal((B, nh, S, hd),
                                                        np.float32)
                                    ).to(cuda, torch.bfloat16)
                   for _ in range(3))
    else:
        q, k, v = (_misaligned((B, nh, S, hd), cuda, rng) for _ in range(3))
    bias = _bias(rng, B, S, cuda)
    got = attention.fused_attention(q, k, v, bias, nh)
    want = attention.attention_plain(q, k, v, bias, nh)
    _per_op_bound(got, want, hd, torch.bfloat16)


@pytest.mark.parametrize("hd", [16, 32, 64, 128])
@pytest.mark.parametrize("S", ATTN_S)
def test_k1_rel_every_head_dim(cuda, S, hd):
    """K1 with a rel_bias at H = 384 (nh = 384 / hd), ragged masks, against
    bert_layer_plain with the same operand: per-token cosine >=
    KERNEL_COS_MIN, as the MPNet-width test holds it."""
    H = 384
    nh = H // hd
    rng = np.random.default_rng(S * hd)
    x, bias, w, m = _k1_args(rng, 2, S, cuda, torch.bfloat16, H, 4 * H)
    rel = torch.from_numpy(rng.standard_normal((nh, S, S), np.float32) * 0.5
                           ).to(cuda)
    got = layer.fused_bert_layer(x, bias, *w, nh=nh, rel_bias=rel).float()
    want = layer.bert_layer_plain(x, bias, *w, nh=nh, rel_bias=rel).float()
    assert torch.isfinite(got).all()
    cos = torch.nn.functional.cosine_similarity(got[m], want[m], dim=-1)
    assert float(cos.min()) >= 0.9999


def _lengths_bias(lengths, S, cuda):
    mask = np.arange(S)[None, :] < np.asarray(lengths)[:, None]
    return torch.from_numpy(np.where(mask, 0.0, -1e30).astype(np.float32)
                            ).to(cuda)


@pytest.mark.parametrize("kernel", ["k5", "k6"])
def test_f32_attention_with_whole_key_tiles_masked(cuda, kernel):
    """The one-pass f32 kernel at S = 512 (eight 64-key tiles) on
    sequences of 512, 10 (seven masked tiles after the first), 0 (every
    key masked: the softmax is uniform, as in the twin) and 70 keys, K5 at
    MiniLM width and K6 at hd 26, within 1e-5 of the scale."""
    B, S, nh = 4, 512, 12
    rng = np.random.default_rng(31)
    bias = _lengths_bias([512, 10, 0, 70], S, cuda)
    if kernel == "k5":
        H = 384
        qkv = torch.from_numpy(rng.standard_normal((B, S, 3 * H), np.float32)
                               ).to(cuda)
        q, k, v = qkv.split(H, dim=-1)
        got = attention.fused_attention_packed(q, k, v, bias, nh)
        want = attention.attention_packed_plain(q, k, v, bias, nh)
        _per_op_bound(got, want, H, torch.float32)
    else:
        q, k, v = (torch.from_numpy(rng.standard_normal((B, nh, S, 26),
                                                        np.float32)).to(cuda)
                   for _ in range(3))
        got = attention.fused_attention(q, k, v, bias, nh)
        want = attention.attention_plain(q, k, v, bias, nh)
        _per_op_bound(got, want, 26, torch.float32)


@pytest.mark.parametrize("hd", [16, 26, 32, 64, 128])
@pytest.mark.parametrize("S", [16, 48, 512])
def test_f32_attention_with_rel_at_every_head_dim(cuda, S, hd):
    """dawn_attention's 3xTF32 kernel with a rel operand at every padded
    head dim, hd 26 (element staging) included, on head-major f32 q, k, v
    with ragged masks, against the contract computed in f32: within 1e-5
    of the scale."""
    from dawnsearch_tpu_torch.ops import _cuda
    B, nh = 2, 4
    rng = np.random.default_rng(S * hd + 1)
    q, k, v = (torch.from_numpy(rng.standard_normal((B, nh, S, hd),
                                                    np.float32)).to(cuda)
               for _ in range(3))
    bias = _bias(rng, B, S, cuda)
    rel = torch.from_numpy(rng.standard_normal((nh, S, S), np.float32) * 0.5
                           ).to(cuda)
    out = torch.empty_like(q)
    strides = (nh * S * hd, S * hd, hd)
    _cuda.check(_cuda.lib().dawn_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
        rel.data_ptr(), out.data_ptr(), B, nh, S, hd, *strides, *strides,
        1.0 / np.sqrt(hd), 1, 1, 0, _cuda.stream_handle(q)), "attention")
    s = layer._biased(q @ k.transpose(-1, -2), hd, bias, rel)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    want = (p @ v) * (1.0 / p.sum(dim=-1, keepdim=True))
    _per_op_bound(out, want, hd, torch.float32)


def test_dawn_attention_refuses_a_flag_mix(cuda):
    """The flags pick the kernel and must match the output: an f32 input
    without an f32 output, a bf16 input with one outside the fixed order,
    and the fixed order without an f32 output are invalid values."""
    from dawnsearch_tpu_torch.ops import _cuda
    t = torch.zeros((1, 1, 16, 32), device=cuda)
    bias = torch.zeros((1, 16), device=cuda)
    st = (16 * 32, 16 * 32, 32)
    for out_f32, in_f32, fixed in ((0, 1, 0), (1, 0, 0), (0, 0, 1)):
        err = _cuda.lib().dawn_attention(
            t.data_ptr(), t.data_ptr(), t.data_ptr(), bias.data_ptr(), None,
            t.data_ptr(), 1, 1, 16, 32, *st, *st, 1.0, out_f32, in_f32, fixed,
            _cuda.stream_handle(t))
        assert err != 0


def _kernel_names(fn) -> set:
    """The names of the CUDA kernels fn() launches, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key for e in prof.key_averages()}


def test_f32_routes_run_the_kernels_they_name(cuda):
    """K1 at f32 runs the TMA + wgmma GEMM and the 3xTF32 attention (no
    CUDA-core SGEMM is left); K4 at f32 and at bf16 still runs the
    fixed-order attention, which nothing else runs."""
    rng = np.random.default_rng(27)
    x, bias, w, _ = _k1_args(rng, 2, 64, cuda, torch.float32)
    kw = _k1_form(w)
    k1 = _kernel_names(lambda: layer.fused_bert_layer(x, bias, *kw, nh=12))
    assert any("gemm_kernel" in n for n in k1)
    assert any("attention_tf32_kernel" in n for n in k1)
    assert not any("attention_seq_kernel" in n or "sgemm" in n for n in k1)
    _, _, w8, _ = _k4_args(rng, 2, 64, 384, 1536, cuda)
    for xt in (x, x.bfloat16()):
        k4 = _kernel_names(lambda: layer.fused_bert_layer_i8(xt, bias, *w8,
                                                              nh=12))
        assert any("attention_seq_kernel" in n for n in k4)
        assert not any("attention_tf32_kernel" in n for n in k4)
    qkv = torch.from_numpy(rng.standard_normal((2, 64, 3 * 384), np.float32)
                           ).to(cuda)
    q, k, v = qkv.split(384, dim=-1)
    k5 = _kernel_names(lambda: attention.fused_attention_packed(q, k, v,
                                                                bias, 12))
    assert any("attention_tf32_kernel" in n for n in k5)
    assert not any("attention_seq_kernel" in n for n in k5)


def test_bf16_on_cuda_never_reaches_the_plain_twin(cuda, monkeypatch):
    """K1 (with and without rel_bias), K5 and K6 on bf16 CUDA tensors
    launch their kernels: with K1's and the attention's plain twins
    replaced by ones that fail, every wrapper still runs."""
    def boom(*args, **kwargs):
        raise AssertionError("a plain twin ran on CUDA tensors")
    for mod, name in ((layer, "bert_layer_plain"),
                      (attention, "attention_plain"),
                      (attention, "attention_packed_plain"),
                      (attention, "mean_pool_plain")):
        monkeypatch.setattr(mod, name, boom)
    bf = torch.bfloat16
    rng = np.random.default_rng(10)
    x, bias, w, _ = _k1_args(rng, 2, 32, cuda, bf)
    assert layer.fused_bert_layer(x, bias, *w, nh=12).dtype == bf
    rel = torch.zeros((12, 32, 32), device=cuda)
    assert layer.fused_bert_layer(x, bias, *w, nh=12,
                                  rel_bias=rel).dtype == bf
    qkv = torch.from_numpy(rng.standard_normal((2, 32, 3 * 384), np.float32)
                           ).to(cuda, bf)
    q, k, v = qkv.split(384, dim=-1)
    assert attention.fused_attention_packed(q, k, v, bias, 12).dtype == bf
    heads = q.reshape(2, 32, 12, 32).transpose(1, 2).contiguous()
    assert attention.fused_attention(heads, heads, heads, bias,
                                     12).dtype == bf
    assert attention.fused_mean_pool(x, (bias == 0).int()).dtype == \
        torch.float32


# -- ModernBERT's long-context kernels (csrc/long/, ops/modernbert.py) -----
# Each against its plain twin on the same bf16 operands: the GEMM
# epilogues to the bf16 rounding of the twin's f32 result (per-row cosine
# >= 0.9999, the twin rounds at the same points, the sums run in another
# order), the attention to per-row cosine >= 0.999 (the kernel rounds p to
# bf16 against a running max, the twin keeps p in f32), windowed and
# global, at S = 16 to 8,192 (the 1.5x buckets 48, 96, 1,536 and 6,144
# among them, which a 128-row tile does not divide) with ragged lengths:
# at the edges of a 64- and a 128-key tile (1, 63-65, 127-129), S - 1 and
# 0; the global kernel bit-equal whatever the rows past each length hold
# (zeros or NaN) and from launch to launch; the GEMMs on every tile path
# of their persistent schedule (64- and 128-row tiles, ragged last tiles,
# tile counts no multiple of the grid) and bit-equal from launch to
# launch; then the windowed launch's cost against the global one's at B =
# 32, S = 8,192.

def _mb():
    from dawnsearch_tpu_torch.ops import modernbert
    return modernbert


def _rowcos(got, want):
    return torch.nn.functional.cosine_similarity(got.float(), want.float(),
                                                 dim=-1)


@pytest.mark.parametrize("B,S,nh,lens", [
    (3, 128, 12, (128, 77, 2)), (2, 1024, 4, (1024, 613)),
    (2, 8192, 2, (8192, 3001)), (3, 16, 12, (16, 1, 0)),
    (3, 48, 12, (48, 47, 17)), (4, 96, 12, (96, 65, 64, 95)),
    (9, 1536, 12, (1536, 1, 63, 64, 65, 127, 128, 129, 1535)),
    (3, 6144, 4, (6144, 0, 6143)), (2, 8192, 12, (8191, 129))])
@pytest.mark.parametrize("window", [None, 64])
def test_long_attention_matches_plain(cuda, B, S, nh, lens, window):
    mb = _mb()
    g = torch.Generator(device=cuda).manual_seed(S + (window or 0))
    qkv = (torch.randn((B * S, 3 * nh * 64), generator=g, device=cuda)
           * 1.5).to(torch.bfloat16)
    lengths = torch.tensor(lens, dtype=torch.int32, device=cuda)
    got = mb.attention(qkv, lengths, B, S, nh, window)
    want = mb.attention_plain(qkv, lengths, B, S, nh, window)
    live = (torch.arange(S, device=cuda)[None] < lengths[:, None].long()
            ).reshape(-1)
    assert torch.isfinite(got).all()
    assert float(_rowcos(got[live], want[live]).min()) >= 0.999
    assert not got[~live].any()


def test_long_global_attention_ignores_rows_past_each_length(cuda):
    """Whatever the qkv rows at or past a sequence's length hold (zeros or
    NaN, in q, k and v alike), the output is the same bits, and a second
    launch on the same input gives them again: masked keys contribute
    exactly zero, padded query rows are written as zeros, nothing is
    summed in a varying order. S 96 and 1,536 are not multiples of the
    128-row tile, so a tile also reads the next sequence's rows."""
    mb = _mb()
    for B, S, nh, lens in ((4, 96, 12, (96, 0, 1, 65)),
                           (4, 1536, 12, (1535, 129, 128, 700)),
                           (2, 8192, 12, (8191, 4000))):
        g = torch.Generator(device=cuda).manual_seed(S)
        qkv = (torch.randn((B * S, 3 * nh * 64), generator=g, device=cuda)
               * 1.5).to(torch.bfloat16)
        lengths = torch.tensor(lens, dtype=torch.int32, device=cuda)
        past = (torch.arange(S, device=cuda)[None] >= lengths[:, None].long()
                ).reshape(-1)
        for window in (None, 64):
            zero = qkv.clone()
            zero[past] = 0.0
            nan = qkv.clone()
            nan[past] = float("nan")
            want = mb.attention(zero, lengths, B, S, nh, window)
            got = mb.attention(nan, lengths, B, S, nh, window)
            again = mb.attention(nan, lengths, B, S, nh, window)
            assert torch.isfinite(want).all()
            assert torch.equal(got, want), (S, window)
            assert torch.equal(again, got), (S, window)
            assert not got[past].any()


# (M, S): 64-row tiles (3·128 and 400 rows: too few 128-row tiles to
# fill the card, 400 a ragged last tile), 128-row tiles (2,048), a ragged
# last 128-row tile (131·128 + 16), and 300 row blocks, whose tiles (2,700
# of 128 x 256, 5,400 of 128 x 128) and LayerNorm clusters are no multiple
# of the persistent grid
LONG_GEMM_SHAPES = [(3 * 128, 128), (2 * 1024 + 0, 1024), (400, 16),
                    (131 * 128 + 16, 16), (300 * 128, 128)]


def _long_gemm_operands(cuda, M):
    g = torch.Generator(device=cuda).manual_seed(M)

    def rnd(*shape, std=1.0):
        return torch.randn(shape, generator=g, device=cuda) * std
    H, I, bf = 768, 1152, torch.bfloat16
    return {"a": rnd(M, H).to(bf), "wq": rnd(H, 3 * H, std=0.05).to(bf),
            "wi": rnd(H, 2 * I, std=0.05).to(bf),
            "wo": rnd(H, H, std=0.05).to(bf),
            "wo2": rnd(I, H, std=0.05).to(bf), "ctx": rnd(M, I).to(bf),
            "resid": rnd(M, H), "s": 1.0 + rnd(H, std=0.1),
            "table": rnd(1000, H)}


@pytest.mark.parametrize("M,S", LONG_GEMM_SHAPES)
def test_long_gemm_epilogues_match_plain(cuda, M, S):
    mb = _mb()
    nh, bf = 12, torch.bfloat16
    o = _long_gemm_operands(cuda, M)
    a = o["a"]
    cos, sin = mb.rope_tables(8192, 64, 160000.0, cuda)
    got = mb.qkv_rope(a, o["wq"], cos, sin, S, nh)
    want = mb.qkv_rope_plain(a, o["wq"], cos, sin, S, nh)
    assert float(_rowcos(got, want).min()) >= 0.9999
    got = mb.geglu(a, mb.interleave_gate(o["wi"]))
    want = mb.geglu_plain(a, o["wi"])
    assert float(_rowcos(got, want).min()) >= 0.9999
    resid, s = o["resid"], o["s"]
    for x, w in ((a, o["wo"]), (o["ctx"], o["wo2"])):  # K = 768, 1,152
        for out in (bf, torch.float32):
            h, y = mb.resid_ln(x, w, resid, s, 1e-5, out)
            h2, y2 = mb.resid_ln_plain(x, w, resid, s, 1e-5, out)
            assert y.dtype == out
            assert float((h - h2).abs().max()) <= 1e-3
            assert float(_rowcos(y, y2).min()) >= 0.9999
    ids = torch.randint(0, 1000, (M,), device=cuda)
    x, a2 = mb.embed_ln(o["table"], ids, s, 1e-5, bf)
    x2, _ = mb.embed_ln_plain(o["table"], ids, s, 1e-5, bf)
    assert float((x - x2).abs().max()) <= 1e-4
    assert torch.equal(a2, x.to(bf))


@pytest.mark.parametrize("M,S", [(400, 16), (300 * 128, 128)])
def test_long_gemm_launches_give_the_same_bits(cuda, M, S):
    """Two launches of each epilogue on the same inputs give the same bits:
    every output is written once, by one CTA, from sums in a fixed order
    (the LayerNorm's partials in cluster-rank order), whichever CTA of the
    persistent grid takes the tile."""
    mb = _mb()
    o = _long_gemm_operands(cuda, M)
    cos, sin = mb.rope_tables(8192, 64, 160000.0, cuda)
    wi = mb.interleave_gate(o["wi"])
    calls = {
        "rope": lambda: (mb.qkv_rope(o["a"], o["wq"], cos, sin, S, 12),),
        "geglu": lambda: (mb.geglu(o["a"], wi),),
        "ln bf16": lambda: mb.resid_ln(o["ctx"], o["wo2"], o["resid"], o["s"],
                                       1e-5, torch.bfloat16),
        "ln f32": lambda: mb.resid_ln(o["a"], o["wo"], o["resid"], o["s"],
                                      1e-5, torch.float32)}
    for name, call in calls.items():
        first, again = call(), call()
        assert all(torch.equal(u, v) for u, v in zip(first, again)), name


def test_long_kernels_refuse_what_they_do_not_take(cuda):
    mb = _mb()
    bf = torch.bfloat16
    qkv = torch.zeros((2 * 32, 3 * 384), device=cuda, dtype=bf)
    lens = torch.full((2,), 32, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="heads of 64"):
        mb.attention(qkv, lens, 2, 32, 12, None)      # hd 32
    with pytest.raises(ValueError, match="S % 16"):
        mb.attention(torch.zeros((2 * 8200, 3 * 768), device=cuda, dtype=bf),
                     lens, 2, 8200, 12, None)
    with pytest.raises(ValueError, match="bfloat16"):
        mb.attention(qkv.float()[:, :3 * 384], lens, 2, 32, 6, None)
    with pytest.raises(ValueError, match="N % 128"):
        mb.geglu(torch.zeros((64, 768), device=cuda, dtype=bf),
                 torch.zeros((768, 200), device=cuda, dtype=bf))


def test_long_local_attention_costs_a_fraction_of_global(cuda):
    """At B = 32, S = 8,192 (nh 12) a windowed launch (window 64) takes
    under 1/8 of a global one's time: it visits 3 key tiles a query tile
    where the global one visits 128."""
    mb = _mb()
    B, S, nh = 32, 8192, 12
    qkv = torch.randn((B * S, 3 * nh * 64), device=cuda).to(torch.bfloat16)
    lens = torch.full((B,), S, dtype=torch.int32, device=cuda)
    times = {}
    for window in (64, None, 64, None):
        mb.attention(qkv, lens, B, S, nh, window)
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0.record()
        for _ in range(3):
            mb.attention(qkv, lens, B, S, nh, window)
        t1.record()
        torch.cuda.synchronize()
        times[window] = t0.elapsed_time(t1) / 3
    print(f"long attention B={B} S={S}: local {times[64]:.3f} ms, global "
          f"{times[None]:.3f} ms")
    assert times[64] < times[None] / 8


def test_modernbert_on_the_card_matches_its_cpu_route(cuda):
    """Two layers (a global and a local) at ModernBERT-base widths: the
    kernel route in bf16 against the CPU route (the plain twins) in f32 on
    the same weights, per-row cosine of the pooled embeddings >= 0.999;
    every projection and attention on the long kernels."""
    import dataclasses

    from dawnsearch_tpu_torch.models import modernbert as M
    cfg = dataclasses.replace(M.MODERNBERT_BASE, num_layers=2,
                              dtype=torch.bfloat16, pool_impl="fused")
    params = M.init_params(torch.Generator().manual_seed(3), cfg)
    params["embeddings"]["word"] *= 25.0
    B, S = 3, 512
    ids = torch.randint(0, cfg.vocab_size, (B, S))
    mask = (torch.arange(S)[None] < torch.tensor([512, 300, 9])[:, None]
            ).to(torch.int32)
    mb = _mb()
    before = dict(mb.launches)
    card = bert.encode_batch(M.ModernBertModel(cfg, params, device=cuda),
                             ids.to(cuda), mask.to(cuda)).cpu()
    assert all(mb.launches[k] > before[k] for k in mb.launches)
    cpu_cfg = dataclasses.replace(cfg, dtype=torch.float32, pool_impl="xla")
    want = bert.encode_batch(M.ModernBertModel(cpu_cfg, params,
                                               device="cpu"), ids, mask)
    assert float(_rowcos(card, want).min()) >= 0.999


# -- Qwen3's kernels (csrc/long/qwen3.cu and gemm_long.cu's EPI_QKN,
# EPI_SWIGLU, EPI_RMS; ops/qwen3.py) ---------------------------------------
# Each against its plain twin on the same bf16 operands, at the published
# widths (H 4,096, 32 q heads and 8 kv heads of 128, I 12,288) and at
# small ones whose column tiles mix a k and a v head (H 256: 2 q heads
# over 1 kv head) or pair 2 q heads a kv head (H 512): the GEMM epilogues
# at per-row cosine >= 0.9999 on every tile path of the persistent
# schedule; the causal attention at per-row cosine >= 0.999 at S 16 to
# 8,192 with ragged lengths at the edges of the 32-position query blocks
# and 128-key tiles, every group size it takes (1, 2, 4, 8), bit-equal
# whatever the rows past each length hold and from launch to launch; the
# embedding and the last-token pool within 1e-5.

def _q3():
    from dawnsearch_tpu_torch.ops import qwen3
    return qwen3


def _q3_operands(cuda, M, H, nh, nkv, I):
    g = torch.Generator(device=cuda).manual_seed(M + H)

    def rnd(*shape, std=1.0):
        return torch.randn(shape, generator=g, device=cuda) * std
    bf = torch.bfloat16
    x = rnd(M, H) * 3.0
    q3 = _q3()
    return {"x": x, "a": x.to(bf), "ssq": (x * x).view(M, q3.parts(H), -1)
            .sum(-1), "wqkv": rnd(H, (nh + 2 * nkv) * 128, std=0.02).to(bf),
            "wgu": rnd(H, 2 * I, std=0.02).to(bf),
            "wo": rnd(nh * 128, H, std=0.02).to(bf),
            "wd": rnd(I, H, std=0.02).to(bf), "ctx": rnd(M, nh * 128).to(bf),
            "g": rnd(M, I).to(bf), "qn": 1.0 + rnd(128, std=0.1),
            "kn": 1.0 + rnd(128, std=0.1), "s": 1.0 + rnd(H, std=0.1),
            "table": rnd(1000, H).to(bf)}


QWEN3_WIDTHS = [(4096, 32, 8, 12288), (256, 2, 1, 384), (512, 4, 2, 768)]


@pytest.mark.parametrize("H,nh,nkv,I", QWEN3_WIDTHS)
@pytest.mark.parametrize("M,S", [(3 * 128, 128), (400, 16),
                                 (131 * 128 + 16, 16), (64 * 128, 8192)])
def test_qwen3_gemm_epilogues_match_plain(cuda, M, S, H, nh, nkv, I):
    q3 = _q3()
    mb = _mb()
    o = _q3_operands(cuda, M, H, nh, nkv, I)
    cos, sin = mb.rope_tables(8192, 128, 1e6, cuda)
    got = q3.qkv_norm_rope(o["a"], o["ssq"], o["wqkv"], o["qn"], o["kn"],
                           cos, sin, S, nh, nkv, 1e-6)
    want = q3.qkv_norm_rope_plain(o["a"], o["ssq"], o["wqkv"], o["qn"],
                                  o["kn"], cos, sin, S, nh, nkv, 1e-6)
    assert float(_rowcos(got, want).min()) >= 0.9999
    got = q3.swiglu(o["a"], o["ssq"], mb.interleave_gate(o["wgu"]), 1e-6)
    want = q3.swiglu_plain(o["a"], o["ssq"], o["wgu"], 1e-6)
    assert float(_rowcos(got, want).min()) >= 0.9999
    for a, w in ((o["ctx"], o["wo"]), (o["g"], o["wd"])):  # K 4,096, 12,288
        h, y, sq = q3.resid_rms(a, w, o["x"], o["s"])
        h2, y2, sq2 = q3.resid_rms_plain(a, w, o["x"], o["s"])
        assert float((h - h2).abs().max()) <= 1e-3
        assert float(_rowcos(y, y2).min()) >= 0.9999
        assert torch.allclose(sq, sq2, rtol=1e-4)
    ids = torch.randint(0, 1000, (M,), device=cuda)
    x, a, sq = q3.embed(o["table"], ids, o["s"], torch.bfloat16)
    x2, a2, sq2 = q3.embed_plain(o["table"], ids, o["s"], torch.bfloat16)
    assert torch.equal(x, x2) and torch.equal(a, a2)
    assert torch.allclose(sq, sq2, rtol=1e-5)


@pytest.mark.parametrize("M,S", [(400, 16), (300 * 128, 128)])
def test_qwen3_gemm_launches_give_the_same_bits(cuda, M, S):
    q3 = _q3()
    o = _q3_operands(cuda, M, 4096, 32, 8, 12288)
    cos, sin = _mb().rope_tables(8192, 128, 1e6, cuda)
    wgu = _mb().interleave_gate(o["wgu"])
    calls = {
        "qkn": lambda: (q3.qkv_norm_rope(o["a"], o["ssq"], o["wqkv"],
                                         o["qn"], o["kn"], cos, sin, S, 32,
                                         8, 1e-6),),
        "swiglu": lambda: (q3.swiglu(o["a"], o["ssq"], wgu, 1e-6),),
        "rms": lambda: q3.resid_rms(o["g"], o["wd"], o["x"], o["s"])}
    for name, call in calls.items():
        first, again = call(), call()
        assert all(torch.equal(u, v) for u, v in zip(first, again)), name


@pytest.mark.parametrize("B,S,nh,nkv,lens", [
    (3, 128, 32, 8, (128, 77, 2)), (2, 1024, 32, 8, (1024, 613)),
    (2, 8192, 32, 8, (8192, 3001)), (3, 16, 32, 8, (16, 1, 0)),
    (3, 48, 4, 2, (48, 47, 17)), (4, 96, 2, 1, (96, 65, 64, 95)),
    (9, 1536, 8, 1, (1536, 1, 31, 32, 33, 127, 128, 129, 1535)),
    (3, 6144, 4, 4, (6144, 0, 6143)), (2, 8192, 16, 8, (8191, 129))])
def test_qwen3_attention_matches_plain(cuda, B, S, nh, nkv, lens):
    q3 = _q3()
    g = torch.Generator(device=cuda).manual_seed(S + nh)
    qkv = (torch.randn((B * S, (nh + 2 * nkv) * 128), generator=g,
                       device=cuda) * 1.5).to(torch.bfloat16)
    lengths = torch.tensor(lens, dtype=torch.int32, device=cuda)
    got = q3.attention(qkv, lengths, B, S, nh, nkv)
    live = (torch.arange(S, device=cuda)[None] < lengths[:, None].long()
            ).reshape(-1)
    assert torch.isfinite(got).all()
    assert not got[~live].any()
    # the twin a sequence at a time (its (B, nh, S, S) scores)
    for b, n in enumerate(lens):
        if n == 0:
            continue
        rows = slice(b * S, b * S + n)
        want = q3.attention_plain(qkv[rows], lengths[b:b + 1], 1, n, nh,
                                  nkv)
        assert float(_rowcos(got[rows], want).min()) >= 0.999, (b, n)


def test_qwen3_attention_ignores_rows_past_each_length(cuda):
    q3 = _q3()
    for B, S, nh, nkv, lens in ((4, 96, 32, 8, (96, 0, 1, 65)),
                                (4, 1536, 32, 8, (1535, 129, 128, 700)),
                                (2, 8192, 32, 8, (8191, 4000))):
        g = torch.Generator(device=cuda).manual_seed(S)
        qkv = (torch.randn((B * S, (nh + 2 * nkv) * 128), generator=g,
                           device=cuda) * 1.5).to(torch.bfloat16)
        lengths = torch.tensor(lens, dtype=torch.int32, device=cuda)
        past = (torch.arange(S, device=cuda)[None] >= lengths[:, None].long()
                ).reshape(-1)
        zero = qkv.clone()
        zero[past] = 0.0
        nan = qkv.clone()
        nan[past] = float("nan")
        want = q3.attention(zero, lengths, B, S, nh, nkv)
        got = q3.attention(nan, lengths, B, S, nh, nkv)
        again = q3.attention(nan, lengths, B, S, nh, nkv)
        assert torch.isfinite(want).all()
        assert torch.equal(got, want), S
        assert torch.equal(again, got), S
        assert not got[past].any()


@pytest.mark.parametrize("B,S,H", [(3, 16, 4096), (5, 8192, 4096),
                                   (2, 48, 256)])
def test_qwen3_last_pool_matches_plain(cuda, B, S, H):
    q3 = _q3()
    g = torch.Generator(device=cuda).manual_seed(S)
    x = torch.randn((B * S, H), generator=g, device=cuda) * 5.0
    w = 1.0 + 0.1 * torch.randn(H, generator=g, device=cuda)
    lens = torch.tensor([S, 1, 7, S - 1, 3][:B], dtype=torch.int32,
                        device=cuda)
    got = q3.last_pool(x, lens, S, w, 1e-6)
    want = q3.last_pool_plain(x, lens, S, w, 1e-6)
    assert float((got - want).abs().max()) <= 1e-5


def test_qwen3_kernels_refuse_what_they_do_not_take(cuda):
    q3 = _q3()
    bf = torch.bfloat16
    lens = torch.full((2,), 32, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="nh / nkv"):
        q3.attention(torch.zeros((64, 5 * 128), device=cuda, dtype=bf),
                     lens, 2, 32, 3, 1)
    with pytest.raises(ValueError, match="nh / nkv"):
        q3.attention(torch.zeros((64, 11 * 128), device=cuda, dtype=bf),
                     lens, 2, 32, 9, 1)
    with pytest.raises(ValueError, match="S % 16"):
        q3.attention(torch.zeros((2 * 40, 6 * 128), device=cuda, dtype=bf),
                     lens, 2, 40, 4, 1)
    a = torch.zeros((64, 8192), device=cuda, dtype=bf)
    with pytest.raises(ValueError, match="16"):
        q3.swiglu(a, torch.zeros((64, 32), device=cuda),
                  torch.zeros((8192, 256), device=cuda, dtype=bf), 1e-6)
    with pytest.raises(ValueError, match="H % 256"):
        q3.embed(torch.zeros((10, 384), device=cuda, dtype=bf),
                 torch.zeros((4,), device=cuda, dtype=torch.int64),
                 torch.ones(384, device=cuda), bf)


def test_qwen3_on_the_card_matches_its_cpu_route(cuda):
    """Two layers at Qwen3-Embedding-8B's widths (a vocab of 1,000): the
    kernel route in bf16 against the CPU route (the plain twins) in f32 on
    the same weights, per-row cosine of the embeddings >= 0.999; each
    forward launches 1 embed, 5 a layer and 1 pool, no other kernel of
    the encoder."""
    import dataclasses

    from dawnsearch_tpu_torch.models import qwen3 as M
    q3 = _q3()
    cfg = dataclasses.replace(M.QWEN3_EMBEDDING_8B, num_layers=2,
                              vocab_size=1000, max_position_embeddings=512,
                              dtype=torch.bfloat16)
    params = M.init_params(torch.Generator().manual_seed(3), cfg)
    B, S = 3, 256
    ids = torch.randint(0, cfg.vocab_size, (B, S))
    mask = (torch.arange(S)[None] < torch.tensor([256, 200, 9])[:, None]
            ).to(torch.int32)
    before = dict(q3.launches)
    card = M.Qwen3Model(cfg, params, device=cuda)(ids.to(cuda),
                                                  mask.to(cuda)).cpu()
    got = {k: q3.launches[k] - before[k] for k in q3.launches}
    assert got == {"kernel_qwen3_embed": 1, "kernel_qwen3_qkv_norm_rope": 2,
                   "kernel_qwen3_attention": 2, "kernel_qwen3_resid_rms": 4,
                   "kernel_qwen3_swiglu": 2, "kernel_qwen3_last_pool": 1}
    cpu_cfg = dataclasses.replace(cfg, dtype=torch.float32)
    want = M.Qwen3Model(cpu_cfg, params, device="cpu")(ids, mask)
    assert float(_rowcos(card, want).min()) >= 0.999


def test_qwen3_w8a8_route_on_the_card_stays_near_its_cpu_route(cuda):
    """layer_impl "layer_i8" (the benchmark's control) at Qwen3-Embedding-
    8B's widths, two layers: the four projections on K4's s8 pieces, the
    attention, embedding and pool on Qwen3's kernels and none of its bf16
    GEMM epilogues; the embeddings within 8-bit rounding of the CPU route
    in f32 (per-row cosine >= 0.99) and finite."""
    import dataclasses

    from dawnsearch_tpu_torch.models import qwen3 as M
    q3 = _q3()
    cfg = dataclasses.replace(M.QWEN3_EMBEDDING_8B, num_layers=2,
                              vocab_size=1000, max_position_embeddings=512,
                              dtype=torch.bfloat16, layer_impl="layer_i8")
    params = M.init_params(torch.Generator().manual_seed(5), cfg)
    B, S = 3, 256
    ids = torch.randint(0, cfg.vocab_size, (B, S))
    mask = (torch.arange(S)[None] < torch.tensor([256, 200, 9])[:, None]
            ).to(torch.int32)
    before = dict(q3.launches)
    card = M.Qwen3Model(cfg, params, device=cuda)(ids.to(cuda),
                                                  mask.to(cuda)).cpu()
    got = {k: q3.launches[k] - before[k] for k in q3.launches}
    assert got == {"kernel_qwen3_embed": 1, "kernel_qwen3_qkv_norm_rope": 0,
                   "kernel_qwen3_attention": 2, "kernel_qwen3_resid_rms": 0,
                   "kernel_qwen3_swiglu": 0, "kernel_qwen3_last_pool": 1}
    cpu_cfg = dataclasses.replace(cfg, dtype=torch.float32)
    want = M.Qwen3Model(cpu_cfg, params, device="cpu")(ids, mask)
    assert bool(torch.isfinite(card).all())
    assert float(_rowcos(card, want).min()) >= 0.99
