"""The port's node serving ModernBERT with its windowed attention turned
global (BENCH_FAULT=window): every local layer attends to the whole
sequence. A CPU test runs the long-ingest cell on it and sees `correct`
come out false."""

import os
import sys

if __name__ == "__main__":
    assert os.environ["BENCH_FAULT"] == "window"
    from dawnsearch_tpu_torch.ops import modernbert
    attention = modernbert.attention
    modernbert.attention = lambda qkv, lengths, B, S, nh, window: \
        attention(qkv, lengths, B, S, nh, None)
    from dawnsearch_tpu_torch.__main__ import main
    sys.exit(main(sys.argv[1:]))
