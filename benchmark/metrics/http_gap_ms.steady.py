"""Median of client latency from send minus the server's `seconds` (serving/http_service.py)."""
from benchmark.readers import http_gap_ms as read  # noqa: F401
