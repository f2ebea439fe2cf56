"""Share of the window the insert thread spent storing pages (serving/search_service.py, index/store.py)."""
from benchmark.program_readers import insert_store as read  # noqa: F401
