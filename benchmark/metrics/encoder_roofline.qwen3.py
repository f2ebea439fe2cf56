"""Qwen3's FLOP share of the bf16 peak over the kernels its whole encoder.forward spans launched (projections of every row, causal attention at the real tokens' keys)."""
from benchmark.qwen3_readers import encoder_roofline as read  # noqa: F401
