"""Extraction workers' busy µs per WARC record read (ingest/pages.py, ingest/extraction_service.py)."""
from benchmark.program_readers import extract_us_record as read  # noqa: F401
