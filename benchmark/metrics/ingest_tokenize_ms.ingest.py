"""ingest_tokenize p50 per batch at the window's end (ingest/extraction_service.py)."""
from benchmark.readers import timer_p50

read = timer_p50("ingest_tokenize")
