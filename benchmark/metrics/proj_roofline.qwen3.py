"""QKV and output projection launches' share of their roofline (encoder.proj spans)."""
from benchmark.qwen3_readers import proj_roofline as read  # noqa: F401
