#!/usr/bin/env python3
"""Time K8, the fused mean-pool, of one checkout of the port, so that two
checkouts can be compared on one card.

    python3 scripts/pool_ab.py --tree PATH --label NAME [--out FILE.json]

PATH is the root of a checkout of this repository (by default the one
this script lies in). The script imports that checkout's
dawnsearch_tpu_torch, builds its kernels, checks each result against
mean_pool_plain (max |d| <= 1e-5) and times, with CUDA-graph replays
(chip_smoke.py's graph_ms, the device time of one call):

  floor   K8 at B = S = 1, H = 8 (f32 hidden, f32 mask);
  kernel  K8 at each of SHAPES, masked and with include_padding, on f32
          hidden states and an f32 mask (which every version of the
          wrapper hands to the kernel as it is), and on bf16 hidden states
          where the checkout takes them; where the checkout plans its
          launch (plan_pool), also under the other plans of PLANS;
  stage   encode_batch's pool stage on a (B, 128, 384) last hidden state
          and the encoder's int32 mask: with pool_impl="fused" on a bf16
          state, as the checkout runs it (K8 on the bf16 state where it
          takes bf16, else the cast to f32, the mask's cast and K8); the
          same on an f32 state (compute_dtype="f32": K8, after the mask's
          cast where the wrapper casts it); and with pool_impl="xla" on
          the bf16 state (the cast, mean_pool and normalize). Device time
          and host time (median of 20 calls, each synchronized).

Each line of output is one reading; the JSON file holds them all. Compare
two checkouts in one call to the card, in the order A, B, B, A.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = ((1, 128, 384), (8, 128, 384), (64, 128, 384), (128, 128, 384),
          (256, 128, 384), (8, 512, 384), (8, 512, 1024), (8, 512, 2048))
STAGE_BATCHES = (1, 8, 64, 128, 256)
ROW_SPLITS = (1, 2, 4, 8, 16)  # PLANS: one chunk a row block, r row ranges
ERR_MAX = 1e-5


def _smoke():
    """chip_smoke.py of this script's checkout, for its timers and bound."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _inputs(gen: torch.Generator, B: int, S: int, H: int, dev):
    """Seeded hidden states on the card and a ragged (B, S) int32 mask
    (row 0 full, the others of length in [S/8, S])."""
    hidden = torch.randn((B, S, H), generator=gen, device=dev)
    lengths = torch.randint(max(1, S // 8), S + 1, (B,), generator=gen,
                            device=dev)
    lengths[0] = S
    mask = (torch.arange(S, device=dev)[None, :] < lengths[:, None]).int()
    return hidden, mask


def _plans(at, B: int, S: int, H: int, sms: int) -> list[tuple]:
    """The checkout's own plan first, then one column chunk layout with r
    row ranges for each r of ROW_SPLITS that K8 takes."""
    own = at.plan_pool(B, S, H, sms)
    groups = -(-H // at.POOL_VEC)
    cc = -(-groups // at.POOL_MAX_LANES)
    lanes = -(-groups // cc)
    out = [own]
    for r in ROW_SPLITS:
        if r <= S and cc * r <= at.POOL_MAX_CLUSTER:
            plan = (cc, r, lanes,
                    max(1, min(at.POOL_MAX_LANES // lanes, -(-S // r))))
            if plan not in out:
                out.append(plan)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=HERE,
                    help="root of the checkout whose K8 is timed")
    ap.add_argument("--label", required=True, help="name of this run")
    ap.add_argument("--out", help="write every reading to this JSON file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("no GPU: torch.cuda.is_available() is False")
    smoke = _smoke()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    from dawnsearch_tpu_torch.models.bert import mean_pool
    from dawnsearch_tpu_torch.ops import attention as at
    from dawnsearch_tpu_torch.ops.vector import normalize
    if not os.path.abspath(at.__file__).startswith(tree + os.sep):
        raise SystemExit(f"imported {at.__file__}, not from {tree}")
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    planned = hasattr(at, "plan_pool")
    dtypes = (torch.float32, torch.bfloat16) if planned else (torch.float32,)
    widest = at.POOL_MAX_H if planned else 1024
    readings = []

    def say(kind: str, **row) -> None:
        row = {"label": args.label, "kind": kind, **row}
        readings.append(row)
        print(json.dumps(row), flush=True)

    def check(got, hidden, mask, pad, what: str) -> float:
        want = at.mean_pool_plain(hidden, mask, pad)
        err = float((got - want).abs().max())
        if not err <= ERR_MAX:
            raise AssertionError(f"{what}: K8 off its plain version by {err}")
        return err

    tiny, one = torch.ones((1, 1, 8), device=dev), torch.ones((1, 1),
                                                              device=dev)
    say("floor", shape="B=1 S=1 H=8 f32",
        ms=smoke.graph_ms(lambda: at.fused_mean_pool(tiny, one)))
    own_plan = getattr(at, "plan_pool", None)

    gen = torch.Generator(device=dev)
    gen.manual_seed(13)
    for B, S, H in SHAPES:
        if H > widest:
            continue
        base, mask = _inputs(gen, B, S, H, dev)
        fmask = mask.float()
        plans = _plans(at, B, S, H, sms) if planned else [None]
        for dtype in dtypes:
            hidden = base.to(dtype)
            for pad in (False, True):
                for plan in plans:
                    if plan is not None:  # the wrapper asks plan_pool
                        at.plan_pool = lambda *_, p=plan: p

                    def k8():
                        return at.fused_mean_pool(hidden, fmask, pad)
                    what = (f"B={B} S={S} H={H} {str(dtype)[6:]}"
                            f"{' include_padding' if pad else ''}")
                    err = check(k8(), hidden, mask, pad, what)
                    bd = smoke.bound(2 * B * S * H, "f32", smoke.nbytes(
                        hidden, fmask if not pad else None) + B * H * 4)
                    say("kernel", shape=what, plan=plan,
                        own_plan=plan == plans[0], max_abs_err=err,
                        ms=smoke.graph_ms(k8), bound_ms=bd["bound_ms"])
                at.plan_pool = own_plan
    for B in STAGE_BATCHES:
        base, mask = _inputs(gen, B, 128, 384, dev)
        hidden = base.bfloat16()
        state = hidden.float()
        stages = {
            "fused": (lambda: at.fused_mean_pool(hidden, mask)) if planned
            else (lambda: at.fused_mean_pool(hidden.float(), mask)),
            "fused_f32": lambda: at.fused_mean_pool(state, mask),
            "xla": lambda: normalize(mean_pool(hidden.float(), mask),
                                     eps=1e-12)}
        for name, fn in stages.items():
            err = check(fn(), hidden, mask, False, f"stage {name} B={B}")
            say("stage", shape=f"B={B} S=128 H=384", stage=name,
                max_abs_err=err, ms=smoke.graph_ms(fn),
                host_ms=smoke._host_ms(fn))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(readings, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
