"""Model FLOP share of the bf16 peak over the pages inserted in the window (ModernBERT: projections and banded or global attention, benchmark/modernbert_work.py)."""
from benchmark.readers import mfu as read  # noqa: F401
