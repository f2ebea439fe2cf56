"""Causal GQA attention launches' share of their roofline (encoder.attn spans, kind causal)."""
from benchmark.qwen3_readers import attn_roofline as read  # noqa: F401
