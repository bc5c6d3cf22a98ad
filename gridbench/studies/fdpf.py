"""A batched time-series study with ``FastDecoupled.solve_batch`` on the
grid in the program's RCM order (``rcm_grid``, made at set-up): K load
snapshots from the flat start against the one pair of factorizations,
their (vm, va, iterations) copied to the host and mapped back to the
grid's bus order; judged by the reference's power-flow numbers with the
mismatch divided by Vm, the XB scheme's own measure."""

from __future__ import annotations

import numpy as np
import torch

from gridbench.hostio import host_buffer, port_grid, to_host
from gridbench.reference import network, powerflow


class Study:
    item = "snapshot"

    def __init__(self, arrays: dict, settings: dict, device):
        from csparse3_tpu_torch.models.grids import rcm_grid
        from csparse3_tpu_torch.models.powerflow import FastDecoupled

        s = settings["solver"]
        self.max_iter = s["max_iter"]
        self.device = device
        g, perm = rcm_grid(port_grid(arrays))
        self.order = np.asarray(perm)
        self.pf = FastDecoupled(g, tol=s["tol"], max_iter=s["max_iter"],
                                spmv=s["spmv"], solver=s["solver"],
                                device=device)
        K, n = settings["batch"], arrays["n_bus"]
        self.bufs = dict(vm=host_buffer((K, n), torch.float64),
                         va=host_buffer((K, n), torch.float64),
                         it=host_buffer((K,), torch.int64))

    def run(self, sb):
        vm, va, it = self.pf.solve_batch(sb)
        return to_host(self.bufs, dict(vm=vm, va=va, it=it), self.device)

    def tally(self, out) -> dict:
        return dict(it=out["it"].copy(), failed=out["it"] >= self.max_iter)

    def keep(self, out, rows, payload) -> dict:
        """Rows in the grid's bus order."""
        kept = {}
        for k, part in (("vm", out["vm"]), ("va", out["va"]),
                        ("sb", payload)):
            kept[k] = np.empty((len(rows), len(self.order)), part.dtype)
            kept[k][:, self.order] = part[rows]
        return kept

    def counters(self) -> dict:
        from csparse3_tpu_torch.kernels import dia

        return {"dia_entries_split_kernel":
                dia.BATCH_LAUNCHES["dia_spmv_split_batched"]}


def numbers(arrays, settings, kept, tally, seed) -> dict:
    return powerflow.ts_numbers(arrays, kept, tally, per_vm=True)


def control(arrays, settings, sb, precision):
    """(kept, tally) of the reference's XB scheme in ``precision`` in the
    program's place, for the snapshots ``sb`` (rows, the grid's order)."""
    s = settings["solver"]
    Y = network.ybus(arrays)
    out = [powerflow.fdpf(Y, row, arrays, s["tol"], s["max_iter"],
                          precision) for row in sb]
    its = np.array([o[2] for o in out])
    return (dict(vm=np.array([o[0] for o in out]),
                 va=np.array([o[1] for o in out]), sb=sb),
            dict(failed=its >= s["max_iter"]))
