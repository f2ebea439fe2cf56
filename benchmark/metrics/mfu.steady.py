"""Model FLOP share of the bf16 peak over the queries answered in the window."""
from benchmark.readers import mfu as read  # noqa: F401
