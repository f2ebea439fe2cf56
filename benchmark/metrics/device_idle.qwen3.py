"""Share of the traced window with no kernel or copy on the card, over busy time that the kind clips to the capture (qwen3_readers.clip_to_capture)."""
from benchmark.readers import device_idle as read  # noqa: F401
