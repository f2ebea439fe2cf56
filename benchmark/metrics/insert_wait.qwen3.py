"""Share of the window the insert thread waited for a tokenized batch (ingest/extraction_service.py)."""
from benchmark.program_readers import insert_wait as read  # noqa: F401
