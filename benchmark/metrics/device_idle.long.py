"""Share of the traced window with no kernel or copy on the card."""
from benchmark.readers import device_idle as read  # noqa: F401
