"""The encoder's FLOP share of the bf16 peak over the kernels its whole encoder.forward spans launched (the long kernels, from the trace)."""
from benchmark.long_readers import encoder_roofline as read  # noqa: F401
