"""Every random stream of a run, derived from its --seed and a tag, so the
same seed gives the same inputs and the streams never overlap."""

from __future__ import annotations

import numpy as np

WEIGHTS, STORE, QUERIES, SCHEDULE, WARMUP, JUDGE, PAGES = range(1, 8)


def rng(seed: int, tag: int) -> np.random.Generator:
    return np.random.default_rng([seed, tag])


def torch_seed(seed: int, tag: int) -> int:
    """A 63-bit seed for a torch.Generator."""
    state = np.random.SeedSequence([seed, tag]).generate_state(1, np.uint64)
    return int(state[0] >> np.uint64(1))
