"""Share of the window the insert thread spent screening URLs against the store (serving/search_service.py, index/provider.py)."""
from benchmark.program_readers import insert_screen as read  # noqa: F401
