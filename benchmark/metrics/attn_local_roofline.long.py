"""Windowed attention launches' share of their roofline (encoder.attn spans, kind local)."""
from benchmark.long_readers import attn_roofline

read = attn_roofline("local")
