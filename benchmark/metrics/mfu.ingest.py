"""Model FLOP share of the bf16 peak over the pages inserted in the window."""
from benchmark.readers import mfu as read  # noqa: F401
