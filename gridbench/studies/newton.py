"""A batched time-series study with ``NewtonPowerFlow.solve_batch``: K
load snapshots from the flat start against one symbolic factorization,
their (vm, va, iterations, residual) copied to the host; judged by the
reference's power-flow numbers (``powerflow.ts_numbers``)."""

from __future__ import annotations

import numpy as np
import torch

from gridbench.hostio import host_buffer, port_grid, to_host
from gridbench.reference import network, powerflow


class Study:
    item = "snapshot"
    #: the bus order the traffic is given in (None: the grid's)
    order = None

    def __init__(self, arrays: dict, settings: dict, device):
        from csparse3_tpu_torch.models.powerflow import NewtonPowerFlow

        s = settings["solver"]
        self.tol, self.max_iter = s["tol"], s["max_iter"]
        self.device = device
        self.pf = NewtonPowerFlow(port_grid(arrays), tol=s["tol"],
                                  max_iter=s["max_iter"], spmv=s["spmv"],
                                  solver=s["solver"], device=device)
        K, n = settings["batch"], arrays["n_bus"]
        self.bufs = dict(vm=host_buffer((K, n), torch.float64),
                         va=host_buffer((K, n), torch.float64),
                         it=host_buffer((K,), torch.int64),
                         res=host_buffer((K,), torch.float64))

    def run(self, sb):
        vm, va, it, res = self.pf.solve_batch(sb)
        return to_host(self.bufs, dict(vm=vm, va=va, it=it, res=res),
                       self.device)

    def tally(self, out) -> dict:
        """Per snapshot: iterations, and not converged."""
        return dict(it=out["it"].copy(),
                    failed=(out["it"] >= self.max_iter)
                    | ~(out["res"] <= self.tol))

    def keep(self, out, rows, payload) -> dict:
        return dict(vm=out["vm"][rows].copy(), va=out["va"][rows].copy(),
                    sb=payload[rows].copy())

    def counters(self) -> dict:
        """Launches the program counted, by kernel name."""
        plan = self.pf._yplan
        return ({"band_points_entries_kernel": plan.scenario_launches}
                if hasattr(plan, "scenario_launches") else {})


def numbers(arrays, settings, kept, tally, seed) -> dict:
    return powerflow.ts_numbers(arrays, kept, tally, per_vm=False)


def control(arrays, settings, sb, precision):
    """(kept, tally) of the reference's Newton in ``precision`` in the
    program's place, for the snapshots ``sb`` (rows, the grid's order)."""
    s = settings["solver"]
    Y = network.ybus(arrays)
    out = [powerflow.newton(Y, row, arrays, s["tol"], s["max_iter"],
                            precision) for row in sb]
    its = np.array([o[2] for o in out])
    return (dict(vm=np.array([o[0] for o in out]),
                 va=np.array([o[1] for o in out]), sb=sb),
            dict(failed=its >= s["max_iter"]))
