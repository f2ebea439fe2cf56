"""fused_query_dispatch p50 at the window's end: host launch work of serving/fused.py."""
from benchmark.readers import timer_p50

read = timer_p50("fused_query_dispatch")
