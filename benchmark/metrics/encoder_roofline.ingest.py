"""The encoder's FLOP share of the bf16 peak over the kernels its whole encoder.forward spans launched (K1 rel, from the trace)."""
from benchmark.program_readers import encoder_roofline as read  # noqa: F401
