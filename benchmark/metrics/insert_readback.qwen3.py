"""Share of the window the insert thread spent reading embeddings back from the device (serving/search_service.py)."""
from benchmark.program_readers import insert_readback as read  # noqa: F401
