"""ingest_store p50 per batch at the window's end (index/provider.py, index/store.py)."""
from benchmark.readers import timer_p50

read = timer_p50("ingest_store")
