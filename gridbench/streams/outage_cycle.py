"""Traffic kind ``outage_cycle``: N-1 screening.

Every branch in an order permuted by the seed, batch b the next B of that
cycle (wrapping), so every batch holds B outages and every seed the same
work in another order.
"""

from __future__ import annotations

import numpy as np


class Stream:
    """Every branch once per cycle, in a seeded order."""

    item = "outage"

    def __init__(self, p: dict, arrays: dict, seed: int, batch: int,
                 order=None, device="cpu"):
        self.batch = batch
        m = len(arrays["f"])
        self.order = np.random.default_rng([seed, 2]).permutation(m)

    def items(self, b: int) -> np.ndarray:
        """The outaged branches of batch b."""
        m = len(self.order)
        return self.order[(b * self.batch + np.arange(self.batch)) % m]

    payload = items
