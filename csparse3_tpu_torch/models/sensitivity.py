"""Linear DC sensitivity factors: PTDF, LODF, and LODF-based N-1 screening.

The JAX package's ``csparse3_tpu/models/sensitivity.py``, computed on the
device:

* **PTDF** ``H = Bf . B_r^{-1}`` is one multi-RHS solve ``B_r X = Bf_r^T``,
  chunked over branch columns: block-Thomas sweeps over the no-pivot RCM
  factors (``SparseLU.banded_solve_plan``) where B' allows them, else the
  level-scheduled ``SolvePlan`` (warned).  The right-hand sides are built
  on the device.
* **LODF** is dense algebra on H: gathers and a rank-1 correction
  denominator.
* **Screening** post-outage flows are a broadcast axpy
  ``F_k = F0 + LODF[:, k] * F0[k]``: one (K, m) elementwise product for
  all scenarios.  Production tools screen with LODF and re-solve only the
  violations (``DCContingency`` re-solves).

Conventions: flows are in the from->to direction in p.u.; the slack bus
absorbs injection imbalance (PTDF columns at slack buses are 0).

``LinearContingency.run_sharded`` spreads the outage list over the
positions of a ``parallel.Mesh`` as the contingency studies' do
(``models/contingency.py``).

Deviation from the JAX package, by design: the results are tensors on the
device (the JAX package returns host numpy).
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from ..config import resolve_device
from ..linalg import splu
from ..ops import construct
from .grids import SLACK, Grid

__all__ = ["ptdf", "lodf", "LinearContingency"]


def _reduced_susceptance(grid: Grid):
    """B' with slack rows/cols removed, plus the keep/reduction maps.

    Same assembly as ``DCContingency`` (models/contingency.py): branch
    susceptance 1/x stamped as a graph Laplacian.
    """
    n = grid.n_bus
    f, t = grid.f, grid.t
    bsus = 1.0 / np.asarray(grid.x, dtype=np.float64)
    rows = np.concatenate([f, t, f, t])
    cols = np.concatenate([t, f, f, t])
    vals = np.concatenate([-bsus, -bsus, bsus, bsus])
    B = construct.from_triplets(rows, cols, vals, (n, n))
    keep = np.flatnonzero(np.asarray(grid.bus_type) != SLACK)
    red = np.full(n, -1, dtype=np.int64)
    red[keep] = np.arange(len(keep))
    return B[keep, keep], keep, red, bsus


def _torch_dtype(dtype):
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.empty(0, dtype=dtype)).dtype


def ptdf(grid: Grid, branches=None, ordering="auto", chunk: int = 1024,
         dtype=np.float64, device=None):
    """Power Transfer Distribution Factors, a tensor on ``device`` (None:
    ``config.default_device()``, the CUDA card).

    ``H[l, i]`` = sensitivity of the flow on branch ``l`` (from->to) to a
    1 p.u. injection at bus ``i`` (withdrawn at the slack).  Shape
    ``(len(branches), n_bus)``; columns at slack buses are exactly 0.

    ``branches`` — monitored subset (default: all).  ``chunk`` — RHS
    columns per device solve (the multi-RHS batch size).
    """
    device = resolve_device(device)
    dtype = _torch_dtype(dtype)
    m = grid.n_branch
    branches = (np.arange(m) if branches is None
                else np.asarray(branches, dtype=np.int64))
    if branches.size and (branches.min() < 0 or branches.max() >= m):
        raise IndexError("branch index out of range")
    Br, keep, red, bsus = _reduced_susceptance(grid)
    # B' is a diagonally dominant Laplacian (regularized by the slack
    # reduction): the RCM no-pivot factors solve as block-bidiagonal dense
    # sweeps, where the level-scheduled plan is one launch chain per level
    plan = None
    if ordering in ("auto", "rcm"):
        try:
            lu0 = splu(Br, ordering="rcm", tol=0.0)
            # a grid that breaks B' diagonal dominance (series
            # compensation, 1/x < 0) can hit a zero or tiny no-pivot pivot
            # that is reported (or silently infs) rather than raised: only
            # a numerically sound factorization may skip pivoting
            if lu0.is_singular or not (
                    np.isfinite(np.asarray(lu0._h.Lx)).all()
                    and np.isfinite(np.asarray(lu0._h.Ux)).all()):
                raise ValueError("no-pivot factorization unstable")
            plan = lu0.banded_solve_plan(device=device)
        except (ValueError, np.linalg.LinAlgError) as e:
            # expected fallbacks only (stability and bandwidth checks); any
            # other exception is a bug and propagates
            warnings.warn(
                f"ptdf: banded fast path unavailable ({e}); falling "
                "back to the level-scheduled solve plan", stacklevel=2)
            plan = None
    if plan is None:
        lu = splu(Br, ordering=ordering)
        plan = lu.solve_plan(device=device)
    nb = len(keep)

    # B' is symmetric, so row l of H over kept buses is
    # x_l = B_r^{-1} rhs_l with rhs_l = (e_f - e_t) b_l  (reduced).
    def dev(a, dt=torch.int64):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dt,
                               device=device)

    rf = dev(red[np.asarray(grid.f)[branches]])
    rt = dev(red[np.asarray(grid.t)[branches]])
    bl = dev(bsus[branches], dtype)
    keep_t = dev(keep)

    H = torch.zeros((len(branches), grid.n_bus), dtype=dtype, device=device)
    for s in range(0, len(branches), chunk):
        e = min(s + chunk, len(branches))
        rhs = torch.zeros((nb, e - s), dtype=dtype, device=device)
        cols = torch.arange(e - s, device=device)
        lf, lt = rf[s:e], rt[s:e]
        livef, livet = lf >= 0, lt >= 0
        # a branch's two terminals are distinct rows of its column
        rhs[lf[livef], cols[livef]] = bl[s:e][livef]
        rhs[lt[livet], cols[livet]] = -bl[s:e][livet]
        H[s:e].index_copy_(1, keep_t, plan(rhs).T.to(dtype))
    return H


def lodf(grid: Grid, H=None, ordering="auto", tol: float = 1e-8,
         device=None):
    """Line Outage Distribution Factors, on the device of ``H`` (computed
    by ``ptdf`` on ``device`` when not given).

    ``L[l, k]`` = fraction of branch ``k``'s pre-outage flow that shifts
    onto branch ``l`` when ``k`` trips.  ``L[k, k] = -1``.  Returns
    ``(L, ok)`` where ``ok[k]`` is False when tripping ``k`` islands the
    grid (the transfer denominator ``1 - PTDF_kk`` vanishes); the
    corresponding LODF column is zeroed (flows there are meaningless).

    Pass a precomputed full ``H = ptdf(grid)`` to reuse it.
    """
    if H is None:
        H = ptdf(grid, ordering=ordering, device=device)
    elif not isinstance(H, torch.Tensor):
        H = torch.as_tensor(np.asarray(H), device=resolve_device(device))
    m = grid.n_branch
    if tuple(H.shape) != (m, grid.n_bus):
        raise ValueError("H must be the full (n_branch, n_bus) PTDF")
    f = torch.as_tensor(np.asarray(grid.f), device=H.device)
    t = torch.as_tensor(np.asarray(grid.t), device=H.device)
    # Hbr[l, k] = flow change on l per unit pair-injection at k's terminals
    # (formed in place: at 10k buses each (m, m) float64 term is 4 GB)
    L = H[:, f].sub_(H[:, t])
    denom = 1.0 - torch.diagonal(L)
    ok = denom.abs() > tol
    L /= torch.where(ok, denom, torch.ones_like(denom))[None, :]
    L[:, ~ok] = 0.0
    L.fill_diagonal_(-1.0)
    bad = torch.nonzero(~ok).flatten()
    L[bad, bad] = 0.0
    return L, ok


class LinearContingency:
    """LODF-based N-1 screening: ``flows_k = F0 + LODF[:, k] * F0[k]``, on
    ``device`` (None: ``config.default_device()``).

    The linear-screening companion to ``DCContingency`` (which re-solves
    each scenario by device refactorization): exact for DC flows, O(m) per
    scenario after the one-time PTDF build, and scenario-parallel.
    ``run`` mirrors the ``DCContingency`` API and returns ``(flows, ok)``
    as tensors on the device.
    """

    def __init__(self, grid: Grid, ordering="auto", tol: float = 1e-8,
                 device=None):
        self.grid = grid
        self.device = resolve_device(device)
        self._kw = dict(ordering=ordering, tol=tol)
        H = ptdf(grid, ordering=ordering, device=self.device)
        L, ok = lodf(grid, H=H, tol=tol)
        P = torch.as_tensor(np.asarray(grid.pg) - np.asarray(grid.pd),
                            dtype=H.dtype, device=self.device)
        # base flows directly from the PTDF: F0 = H P
        self.base_flows = H @ P
        self.H = H
        self.lodf = L
        self._ok = ok

    @property
    def n_branch(self) -> int:
        return self.grid.n_branch

    @torch.inference_mode()
    def run(self, outages=None):
        """Screen ``outages`` (default: every branch).  Returns
        ``(flows (K, n_branch), ok (K,))``; ``ok`` False = islanding
        outage (its flow row is not meaningful)."""
        if outages is None:
            outages = np.arange(self.n_branch)
        outages = np.ascontiguousarray(outages, dtype=np.int64)
        if outages.size and (outages.min() < 0
                             or outages.max() >= self.n_branch):
            raise IndexError("outage branch index out of range")
        ks = torch.as_tensor(outages, device=self.device)
        F0 = self.base_flows
        # (K, m): outage k shifts F0[k] through LODF column k (in place on
        # the gathered columns: one (K, m) tensor at a time)
        fl = self.lodf[:, ks].T.mul_(F0[ks][:, None]).add_(F0[None, :])
        fl[torch.arange(len(outages), device=self.device), ks] = 0.0
        return fl, self._ok[ks]

    def run_sharded(self, mesh, outages=None, axis: str | None = None):
        """``run`` of ``outages`` spread over the positions of ``mesh``
        (``models/contingency.py``); returns ``(flows, ok)`` on the mesh's
        first device."""
        from .contingency import _sharded

        return _sharded(self, mesh, outages, axis)
