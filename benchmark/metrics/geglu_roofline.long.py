"""GeGLU FFN launches' share of their roofline (encoder.ffn spans)."""
from benchmark.long_readers import geglu_roofline as read  # noqa: F401
