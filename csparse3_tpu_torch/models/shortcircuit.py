"""Three-phase (symmetric) short-circuit analysis.

The JAX package's ``csparse3_tpu/models/shortcircuit.py``, computed on the
device.  The fault current at bus ``i`` is read off the bus impedance
matrix ``Z = Ybus^{-1}``, whose columns are multi-RHS solves against the
complex LU factorization:

* one complex ``splu`` of Ybus (native host kernel), then
* Z columns for all faulted buses as chunked complex multi-RHS solves on
  the device,
* post-fault voltages by superposition, and branch currents ``Yf @ v`` as
  one sparse product per chunk of scenarios, on the device too (the JAX
  package keeps that product on the host only because some TPU
  attachments cannot transfer complex buffers).

Classical assumptions (MATPOWER / short-circuit standard): pre-fault
voltage profile given (default flat 1.0 p.u.), loads neglected, fault
through impedance ``zf``.

Deviation from the JAX package, by design: the results are tensors on the
device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import resolve_device
from ..linalg import splu
from ..ops.matvec import SpMVPlan
from .grids import Grid, ybus

__all__ = ["SCResult", "zbus_columns", "short_circuit"]


class SCResult(NamedTuple):
    buses: np.ndarray    # faulted bus per scenario, (K,)
    ifault: torch.Tensor  # complex fault current (p.u.), (K,)
    vpost: torch.Tensor  # post-fault bus voltages, (K, n_bus)
    iflow: torch.Tensor  # post-fault from-side branch currents, (K, n_branch)
    ok: torch.Tensor     # False = no finite solution (islanded/singular)


def zbus_columns(Y, buses, ordering="auto", chunk: int = 512, device=None):
    """Columns ``Z[:, buses]`` of ``Ybus^{-1}`` via one complex LU and
    chunked multi-RHS solves on ``device`` (None:
    ``config.default_device()``).  Returns an (n, len(buses)) complex128
    tensor there.

    Never forms the dense inverse: at grid scale Z is dense even though
    Y is sparse; only the requested columns are ever materialized.
    """
    device = resolve_device(device)
    buses = np.asarray(buses, dtype=np.int64)
    n = Y.shape[0]
    if buses.size and (buses.min() < 0 or buses.max() >= n):
        raise IndexError("fault bus index out of range")
    lu = splu(Y, ordering=ordering)
    b = torch.as_tensor(buses, device=device)
    cols = torch.empty((n, len(buses)), dtype=torch.complex128,
                       device=device)
    for s in range(0, len(buses), chunk):
        e = min(s + chunk, len(buses))
        rhs = torch.zeros((n, e - s), dtype=torch.complex128, device=device)
        rhs[b[s:e], torch.arange(e - s, device=device)] = 1.0
        cols[:, s:e] = lu.solve(rhs)
    return cols


def short_circuit(grid: Grid, buses=None, zf: complex = 0.0,
                  vpre=None, ordering="auto", chunk: int = 512,
                  device=None) -> SCResult:
    """Screen three-phase bus faults on ``device`` (None:
    ``config.default_device()``).

    ``buses`` — faulted buses (default: all).  ``zf`` — fault impedance.
    ``vpre`` — pre-fault voltage phasors, (n_bus,) complex (default flat
    1.0 p.u.; pass a power-flow solution for accurate studies).
    ``chunk`` — scenarios per multi-RHS solve and per branch-current
    product.

    Returns per-scenario fault currents, post-fault voltages, and
    from-side branch currents (``Yf @ v``).
    """
    device = resolve_device(device)
    n = grid.n_bus
    buses = (np.arange(n) if buses is None
             else np.asarray(buses, dtype=np.int64))
    vpre = (np.ones(n, dtype=np.complex128) if vpre is None
            else np.asarray(vpre, dtype=np.complex128))
    if vpre.shape != (n,):
        raise ValueError("vpre must be (n_bus,)")
    Y, Yf, _ = ybus(grid)
    Z = zbus_columns(Y, buses, ordering=ordering, chunk=chunk,
                     device=device)                            # (n, K)
    K = len(buses)
    b = torch.as_tensor(buses, device=device)
    vp = torch.as_tensor(vpre, device=device)
    zii = Z[b, torch.arange(K, device=device)] + zf
    ifault = vp[b] / zii
    # v_k = vpre - Z[:, i] * If_i   (superposition)
    vpost = vp[None, :] - (Z * ifault[None, :]).T             # (K, n)
    ok = (zii.abs() > 1e-12) & torch.isfinite(vpost).all(dim=1)
    vpost[~ok] = complex("nan")
    ifault = torch.where(ok, ifault, complex("nan"))

    # branch from-side currents: the Yf product, a chunk of scenarios at a
    # time (its gathered operands are nnz(Yf) x chunk)
    yf = SpMVPlan(Yf, device=device)
    iflow = torch.empty((K, grid.n_branch), dtype=torch.complex128,
                        device=device)
    for s in range(0, K, chunk):
        iflow[s:s + chunk] = yf(vpost[s:s + chunk].T).T
    return SCResult(buses, ifault, vpost, iflow, ok)
