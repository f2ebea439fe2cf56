"""Model FLOP share of the bf16 peak over the pages inserted in the window (Qwen3: projections and causal attention, benchmark/qwen3_work.py)."""
from benchmark.readers import mfu as read  # noqa: F401
