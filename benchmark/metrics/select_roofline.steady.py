"""K2's share of its HBM bytes bound, from the trace (ops/scan_select.py)."""
from benchmark.readers import select_roofline as read  # noqa: F401
