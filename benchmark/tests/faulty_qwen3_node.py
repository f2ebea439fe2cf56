"""The port's node serving Qwen3 with a planted fault: BENCH_FAULT=causal
lets every token attend to the whole sequence (no causal mask), and
BENCH_FAULT=first pools each text's first token instead of its last. A
CPU test runs the Qwen3 ingest cell on it and sees `correct` come out
false."""

import os
import sys

if __name__ == "__main__":
    fault = os.environ["BENCH_FAULT"]
    import torch

    from dawnsearch_tpu_torch.ops import qwen3
    if fault == "causal":
        def attention(qkv, lengths, B, S, nh, nkv):
            hd = qwen3.HEAD_DIM
            t = qkv.float().view(B, S, nh + 2 * nkv, hd).transpose(1, 2)
            q, k, v = t[:, :nh], t[:, nh:nh + nkv], t[:, nh + nkv:]
            k = k.repeat_interleave(nh // nkv, 1)
            v = v.repeat_interleave(nh // nkv, 1)
            keep = torch.arange(S)[None, :] < lengths.long()[:, None]
            s = (q @ k.transpose(-1, -2)) / hd ** 0.5
            s = s.masked_fill(~keep[:, None, None], float("-inf"))
            ctx = (torch.softmax(s, -1) @ v).transpose(1, 2)
            return ctx.reshape(B * S, -1).to(qkv.dtype)
        qwen3.attention = attention
    else:
        assert fault == "first"
        pool = qwen3.last_pool
        qwen3.last_pool = lambda x, lengths, S, w, eps: pool(
            x, torch.ones_like(lengths), S, w, eps)
    from dawnsearch_tpu_torch.__main__ import main
    sys.exit(main(sys.argv[1:]))
