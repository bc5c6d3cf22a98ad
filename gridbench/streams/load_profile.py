"""Traffic kind ``load_profile``: quasi-static time-series snapshots.

A year of hourly load factors a_h (a daily and a weekly cycle plus AR(1)
noise, scaled onto [min_factor, max_factor]) is drawn from the seed;
snapshot h is the base injections x a_h x (1 + bus_noise e_hi), e_hi
standard normal per bus.  A pool of ``pool_hours`` consecutive hours from
a seeded start is made at set-up (the noise drawn on the device), and
batch b is pool rows [b K, (b + 1) K) modulo the pool: a view, so the
window times the study and not the generator.  Every seed gives the same
sizes and the same kind of work, in another order.
"""

from __future__ import annotations

import numpy as np


def load_factors(p: dict, seed: int) -> np.ndarray:
    """(hours,) hourly load factors of a year, in [min_factor,
    max_factor]."""
    rng = np.random.default_rng([seed, 0])
    hours = int(p["hours"])
    h = np.arange(hours)
    day = (h % 24) / 24.0
    # morning rise, evening peak near 18h, night trough near 4h
    daily = (0.55 * np.sin(2 * np.pi * (day - 0.42))
             + 0.25 * np.sin(4 * np.pi * (day - 0.33)))
    weekend = ((h // 24) % 7) >= 5
    weekly = -p["weekend_drop"] * weekend
    noise = np.empty(hours)
    e = rng.standard_normal(hours) * p["noise_sd"]
    acc = 0.0
    phi = p["noise_ar"]
    for i in range(hours):
        acc = phi * acc + e[i]
        noise[i] = acc
    raw = daily + weekly + noise
    lo, hi = p["min_factor"], p["max_factor"]
    return lo + (hi - lo) * (raw - raw.min()) / (raw.max() - raw.min())


def base_injections(arrays: dict) -> np.ndarray:
    """(n,) complex bus injections of the grid: generation less load."""
    return (arrays["pg"] - arrays["pd"]) - 1j * arrays["qd"]


class Stream:
    """The pool of snapshots and its batches."""

    item = "snapshot"

    def __init__(self, p: dict, arrays: dict, seed: int, batch: int,
                 order=None, device="cpu"):
        """``order``: the study's bus order (new bus k = old bus
        order[k]); the pool is held in it, so a batch needs no gather.
        The per-bus noise is drawn on ``device`` by a ``torch.Generator``
        seeded from ``seed`` (a few large calls), the pool then copied to
        the host: the same seed on the same kind of device gives the same
        pool."""
        import torch

        self.batch = batch
        P = int(p["pool_hours"])
        if P % batch:
            raise ValueError(f"pool_hours {P} is not a multiple of the "
                             f"batch {batch}")
        a = load_factors(p, seed)
        ss = np.random.SeedSequence([seed, 1])
        start, tseed = ss.generate_state(2, dtype=np.uint64)
        self.hours = (int(start % len(a)) + np.arange(P)) % len(a)
        base = base_injections(arrays)
        if order is not None:
            base = base[order]
        n = len(base)
        gen = torch.Generator(device=device).manual_seed(int(tseed))
        with torch.inference_mode():
            scale = torch.randn((P, n), generator=gen, device=device,
                                dtype=torch.float64)
            scale.mul_(p["bus_noise"]).add_(1.0).mul_(torch.as_tensor(
                a[self.hours, None], device=device))
            pool = torch.complex(
                scale * torch.as_tensor(base.real, device=device),
                scale * torch.as_tensor(base.imag, device=device))
            del scale
            self.pool = pool.cpu().numpy()
        del pool
        self.factors = a

    def items(self, b: int) -> np.ndarray:
        """Pool rows of batch b."""
        s = (b * self.batch) % len(self.pool)
        return np.arange(s, s + self.batch)

    def payload(self, b: int) -> np.ndarray:
        """(K, n) complex injections of batch b, a view of the pool."""
        s = (b * self.batch) % len(self.pool)
        return self.pool[s:s + self.batch]
