"""Text helpers (reference: src/util.rs).

`slice_up_to` — UTF-8-safe truncation (util.rs:18-27). Python strings
are code points so "safe" means: never cut a grapheme-producing
surrogate pair apart; slicing by code points is already valid UTF-8,
matching the reference's intent (truncate to at most n units without
producing invalid text). Port of dawnsearch_tpu/utils/text.py.
"""

from __future__ import annotations

import time


def slice_up_to(s: str, n: int) -> str:
    """Truncate to at most n code points (util.rs:18-27)."""
    return s[:n]


def now() -> int:
    """Unix time in whole seconds (util.rs:47-52)."""
    return int(time.time())
