"""Global attention launches' share of their roofline (encoder.attn spans, kind global)."""
from benchmark.long_readers import attn_roofline

read = attn_roofline("global")
