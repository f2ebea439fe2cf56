"""Mean queries per text_query batch (serving/batcher.py) in the window."""
from benchmark.readers import query_batch as read  # noqa: F401
