"""SwiGLU FFN launches' share of their roofline (encoder.ffn spans)."""
from benchmark.qwen3_readers import swiglu_roofline as read  # noqa: F401
