"""Extraction workers' busy share: their read, decode, html and filter seconds over workers × window (ingest/extraction_service.py)."""
from benchmark.program_readers import extract_busy as read  # noqa: F401
