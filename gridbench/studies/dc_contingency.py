"""N-1 DC screening with ``DCContingency.run(outages, batch=B)``: each
chunk's post-outage flows and soundness flags copied to the host; judged
by the reference's outage numbers (``contingency.n1_numbers``) on a
seeded sample of ``check_count`` kept outages."""

from __future__ import annotations

import numpy as np
import torch

from gridbench.hostio import host_buffer, port_grid, to_host
from gridbench.reference import contingency


class Study:
    item = "outage"
    order = None

    def __init__(self, arrays: dict, settings: dict, device):
        from csparse3_tpu_torch.models.contingency import DCContingency

        self.device = device
        self.batch = settings["batch"]
        self.dc = DCContingency(port_grid(arrays), device=device)
        B, m = self.batch, len(arrays["f"])
        self.bufs = dict(flows=host_buffer((B, m), torch.float64),
                         ok=host_buffer((B,), torch.bool))

    def run(self, outages):
        flows, _, ok = self.dc.run(outages, batch=self.batch)
        return to_host(self.bufs, dict(flows=flows, ok=ok), self.device)

    def tally(self, out) -> dict:
        return dict(ok=out["ok"].copy(),
                    finite=np.isfinite(out["flows"]).all(axis=1))

    def keep(self, out, rows, payload) -> dict:
        return dict(flows=out["flows"][rows].copy())

    def counters(self) -> dict:
        return {}


def numbers(arrays, settings, kept, tally, seed) -> dict:
    """``kept``: item (the outaged branch), flows; ``tally``: item, ok,
    finite, one entry per outage of the window."""
    rng = np.random.default_rng([seed, 4])
    n = len(kept["item"])
    sample = np.sort(rng.choice(n, min(int(settings["check_count"]), n),
                                replace=False))
    return contingency.n1_numbers(
        arrays, dict(outage=kept["item"], flows=kept["flows"]),
        dict(outage=tally["item"], ok=tally["ok"], finite=tally["finite"]),
        sample)


def control(arrays, settings, outages, precision):
    """(kept, tally) of the reference's direct solves in ``precision`` in
    the program's place, for ``outages``; an islanding outage's flows are
    not finite, as the program's are."""
    dtype = {"float64": np.float64, "float32": np.float32}[precision]
    bridge = contingency.bridges(arrays)
    nan = np.full(len(arrays["f"]), np.nan)
    flows = np.array([nan if bridge[k] else
                      contingency.dc_flows(arrays, int(k), dtype)
                      for k in outages])
    return (dict(item=outages, flows=flows),
            dict(item=outages, ok=~bridge[outages],
                 finite=np.isfinite(flows).all(axis=1)))
