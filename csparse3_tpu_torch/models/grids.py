"""Power-grid test systems and admittance (Ybus) assembly.

The reference is the sparse-matrix engine under GridCal power-systems
solvers (SURVEY "What the reference is"); its canonical flow builds branch
connectivity and admittance matrices from line tables
(reference: src/test/test3_lil_matrix.py, docs/connectivity_matrix.rst).
This module provides the grid cases the benchmarks need:

* ``ieee14()``       — the standard IEEE 14-bus case (public MATPOWER
                       case14 parameters), BASELINE config 1.
* ``synthetic_grid`` — deterministic generator of Ybus-realistic grids at
                       arbitrary scale (10k / 100k / 1M nodes; BASELINE
                       configs 2-5): a 2-D lattice backbone (transmission
                       grids are near-planar) plus random chords.
* ``rcm_grid``       — the same grid with its buses renumbered in reverse
                       Cuthill-McKee order, which makes Ybus banded (the
                       form the DIA SpMV plans want).
* ``ybus``           — vectorized admittance assembly (standard pi-model
                       with off-nominal taps and shunts) via one
                       ``from_triplets`` sort-build; also returns the
                       branch connectivity matrices Cf/Ct.

Pure numpy, verbatim from the JAX package (``csparse3_tpu/models/
grids.py``), so both packages build the same grids and the same Ybus from
the same seed.  The matrices are host CSCs; plans place them on a device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops import construct
from ..utils.profiling import span

__all__ = ["Grid", "branch_admittances", "ieee14", "synthetic_grid",
           "ybus", "connectivity", "reorder_grid", "rcm_grid"]

# bus types
PQ, PV, SLACK = 0, 1, 2


class Grid(NamedTuple):
    n_bus: int
    # branch arrays
    f: np.ndarray  # from bus (0-based)
    t: np.ndarray  # to bus
    r: np.ndarray  # series resistance (p.u.)
    x: np.ndarray  # series reactance (p.u.)
    b: np.ndarray  # total line charging susceptance (p.u.)
    tap: np.ndarray  # off-nominal tap ratio (1.0 = none)
    # bus arrays
    bus_type: np.ndarray  # PQ/PV/SLACK
    pd: np.ndarray  # active load (p.u.)
    qd: np.ndarray  # reactive load (p.u.)
    pg: np.ndarray  # active generation (p.u.)
    vm0: np.ndarray  # voltage magnitude setpoints / flat start
    gs: np.ndarray  # bus shunt conductance (p.u.)
    bs: np.ndarray  # bus shunt susceptance (p.u.)

    @property
    def n_branch(self):
        return len(self.f)

    @property
    def pq(self):
        return np.flatnonzero(self.bus_type == PQ)

    @property
    def pv(self):
        return np.flatnonzero(self.bus_type == PV)

    @property
    def slack(self):
        return np.flatnonzero(self.bus_type == SLACK)


def ieee14() -> Grid:
    """IEEE 14-bus test case (MATPOWER case14 parameters, 100 MVA base)."""
    # fbus, tbus, r, x, b, tap  (1-based buses)
    br = np.array([
        [1, 2, 0.01938, 0.05917, 0.0528, 0.0],
        [1, 5, 0.05403, 0.22304, 0.0492, 0.0],
        [2, 3, 0.04699, 0.19797, 0.0438, 0.0],
        [2, 4, 0.05811, 0.17632, 0.0340, 0.0],
        [2, 5, 0.05695, 0.17388, 0.0346, 0.0],
        [3, 4, 0.06701, 0.17103, 0.0128, 0.0],
        [4, 5, 0.01335, 0.04211, 0.0, 0.0],
        [4, 7, 0.0, 0.20912, 0.0, 0.978],
        [4, 9, 0.0, 0.55618, 0.0, 0.969],
        [5, 6, 0.0, 0.25202, 0.0, 0.932],
        [6, 11, 0.09498, 0.19890, 0.0, 0.0],
        [6, 12, 0.12291, 0.25581, 0.0, 0.0],
        [6, 13, 0.06615, 0.13027, 0.0, 0.0],
        [7, 8, 0.0, 0.17615, 0.0, 0.0],
        [7, 9, 0.0, 0.11001, 0.0, 0.0],
        [9, 10, 0.03181, 0.08450, 0.0, 0.0],
        [9, 14, 0.12711, 0.27038, 0.0, 0.0],
        [10, 11, 0.08205, 0.19207, 0.0, 0.0],
        [12, 13, 0.22092, 0.19988, 0.0, 0.0],
        [13, 14, 0.17093, 0.34802, 0.0, 0.0],
    ])
    # bus: type, Pd, Qd, Pg, Vm, Bs   (MW/MVar on 100 MVA base)
    bus = np.array([
        [SLACK, 0.0, 0.0, 232.4, 1.060, 0.0],
        [PV, 21.7, 12.7, 40.0, 1.045, 0.0],
        [PV, 94.2, 19.0, 0.0, 1.010, 0.0],
        [PQ, 47.8, -3.9, 0.0, 1.0, 0.0],
        [PQ, 7.6, 1.6, 0.0, 1.0, 0.0],
        [PV, 11.2, 7.5, 0.0, 1.070, 0.0],
        [PQ, 0.0, 0.0, 0.0, 1.0, 0.0],
        [PV, 0.0, 0.0, 0.0, 1.090, 0.0],
        [PQ, 29.5, 16.6, 0.0, 1.0, 19.0],
        [PQ, 9.0, 5.8, 0.0, 1.0, 0.0],
        [PQ, 3.5, 1.8, 0.0, 1.0, 0.0],
        [PQ, 6.1, 1.6, 0.0, 1.0, 0.0],
        [PQ, 13.5, 5.8, 0.0, 1.0, 0.0],
        [PQ, 14.9, 5.0, 0.0, 1.0, 0.0],
    ])
    base = 100.0
    tap = br[:, 5].copy()
    tap[tap == 0.0] = 1.0
    return Grid(
        n_bus=14,
        f=br[:, 0].astype(np.int64) - 1,
        t=br[:, 1].astype(np.int64) - 1,
        r=br[:, 2],
        x=br[:, 3],
        b=br[:, 4],
        tap=tap,
        bus_type=bus[:, 0].astype(np.int64),
        pd=bus[:, 1] / base,
        qd=bus[:, 2] / base,
        pg=bus[:, 3] / base,
        vm0=bus[:, 4],
        gs=np.zeros(14),
        bs=bus[:, 5] / base,
    )


def synthetic_grid(n: int, seed: int = 0, chord_frac: float = 0.25) -> Grid:
    """Deterministic grid-like case with ~1.3n branches: a sqrt(n) x sqrt(n)
    lattice backbone plus ``chord_frac * n`` random chords; line parameters
    sampled from transmission-typical ranges."""
    rng = np.random.default_rng(seed)
    side = int(np.ceil(np.sqrt(n)))
    idx = np.arange(n)
    # lattice edges
    right = idx[(idx % side != side - 1) & (idx + 1 < n)]
    down = idx[idx + side < n]
    f = np.concatenate([right, down])
    t = np.concatenate([right + 1, down + side])
    # random chords — short-range (within a ~2-row lattice neighborhood),
    # matching real transmission grids' near-planar locality; long-range
    # random chords would give the admittance matrix an expander-graph
    # pattern whose LU fill no ordering can control
    nc = int(n * chord_frac)
    cf = rng.integers(0, n, nc)
    ct = cf + rng.integers(-2 * side, 2 * side + 1, nc)
    keep = (cf != ct) & (ct >= 0) & (ct < n)
    f = np.concatenate([f, cf[keep]])
    t = np.concatenate([t, ct[keep]])
    m = len(f)
    # transmission-typical: x/r between 3 and 10, light-to-moderate loading
    # so the case is AC-feasible at any n
    x = rng.uniform(0.02, 0.15, m)
    r = x / rng.uniform(3.0, 10.0, m)
    b = rng.uniform(0.0, 0.04, m)
    tap = np.ones(m)
    trafo = rng.random(m) < 0.1
    tap[trafo] = rng.uniform(0.95, 1.05, trafo.sum())

    bus_type = np.full(n, PQ, dtype=np.int64)
    npv = max(n // 10, 1)
    pv_sel = rng.choice(n, npv + 1, replace=False)
    bus_type[pv_sel[1:]] = PV
    bus_type[pv_sel[0]] = SLACK
    pd = rng.uniform(0.0, 0.08, n)
    pd[pv_sel] = 0.0
    qd = pd * rng.uniform(0.1, 0.3, n)
    pg = np.zeros(n)
    pg[pv_sel] = pd.sum() / (npv + 1)
    vm0 = np.ones(n)
    vm0[bus_type != PQ] = rng.uniform(1.0, 1.04, (bus_type != PQ).sum())
    return Grid(
        n_bus=n, f=f, t=t, r=r, x=x, b=b, tap=tap,
        bus_type=bus_type, pd=pd, qd=qd, pg=pg, vm0=vm0,
        gs=np.zeros(n), bs=np.zeros(n),
    )


def _as_common(*fields):
    """The fields as given when all are host arrays, else all as tensors
    on the first tensor's device (a grid whose fields require a gradient
    gives differentiable derived values, as ``jax.grad`` over the JAX
    package's grid)."""
    dev = next((f.device for f in fields if isinstance(f, torch.Tensor)),
               None)
    if dev is None:
        return fields
    return tuple(torch.as_tensor(f, device=dev) for f in fields)


def branch_admittances(grid: Grid):
    """Per-branch pi-model admittances (yff, yft, ytf, ytt) — the four
    Ybus stamp values of each branch (MATPOWER-standard formulas); tensors
    where a field of the grid is one."""
    r, x, b, tap = _as_common(grid.r, grid.x, grid.b, grid.tap)
    ys = 1.0 / (r + 1j * x)
    bc2 = 1j * b / 2.0
    if isinstance(tap, torch.Tensor):
        tap = tap.to(torch.complex128)
        ctap = tap.conj()
    else:
        tap = np.asarray(tap).astype(np.complex128)
        ctap = np.conj(tap)
    ytt = ys + bc2
    yff = ytt / (tap * ctap)
    yft = -ys / ctap
    ytf = -ys / tap
    return yff, yft, ytf, ytt


def ybus(grid: Grid):
    """Complex bus admittance matrix (pi model, MATPOWER-standard formulas).

    Returns (Ybus, Yf, Yt): bus admittance plus from/to branch admittance
    matrices (n_branch x n_bus), all CSC, built with one sort-based
    from_triplets each (the vectorized replacement for the reference's
    per-element LilMat insertion flow)."""
    yff, yft, ytf, ytt = branch_admittances(grid)
    f, t = grid.f, grid.t
    n, m = grid.n_bus, grid.n_branch
    ysh = grid.gs + 1j * grid.bs

    rows = np.concatenate([f, f, t, t, np.arange(n)])
    cols = np.concatenate([f, t, f, t, np.arange(n)])
    vals = np.concatenate([yff, yft, ytf, ytt, ysh])
    Y = construct.from_triplets(rows, cols, vals, (n, n))

    br = np.arange(m)
    Yf = construct.from_triplets(
        np.concatenate([br, br]), np.concatenate([f, t]),
        np.concatenate([yff, yft]), (m, n),
    )
    Yt = construct.from_triplets(
        np.concatenate([br, br]), np.concatenate([f, t]),
        np.concatenate([ytf, ytt]), (m, n),
    )
    return Y, Yf, Yt


def connectivity(grid: Grid):
    """Branch-bus incidence matrices Cf, Ct and C = Cf - Ct
    (the reference's f_mat/t_mat flow, test3_lil_matrix.py:29-40)."""
    m, n = grid.n_branch, grid.n_bus
    br = np.arange(m)
    ones = np.ones(m)
    Cf = construct.from_triplets(br, grid.f, ones, (m, n))
    Ct = construct.from_triplets(br, grid.t, ones, (m, n))
    return Cf, Ct


def reorder_grid(grid: Grid, perm) -> Grid:
    """Renumber buses by ``perm`` (new index k = old bus perm[k]), e.g. an
    RCM order, which makes Ybus banded so that the gather-free DIA plans
    apply.  Returns a new Grid; results map back via
    vm_old[perm] = vm_new."""
    perm = np.asarray(perm)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    return grid._replace(
        f=inv[grid.f], t=inv[grid.t],
        bus_type=grid.bus_type[perm], pd=grid.pd[perm], qd=grid.qd[perm],
        pg=grid.pg[perm], vm0=grid.vm0[perm], gs=grid.gs[perm],
        bs=grid.bs[perm],
    )


def rcm_grid(grid: Grid):
    """(reordered grid, perm) with buses in RCM order of the Ybus pattern."""
    from ..linalg.ordering import rcm

    with span("setup.rcm", n=grid.n_bus):
        Y, _, _ = ybus(grid)
        perm = rcm(Y)
        return reorder_grid(grid, perm), perm
