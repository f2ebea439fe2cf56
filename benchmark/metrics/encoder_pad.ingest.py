"""Share of the encoder's padded (B, S) token slots that held no real token (serving/fused.py)."""
from benchmark.program_readers import encoder_pad as read  # noqa: F401
