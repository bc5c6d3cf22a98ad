"""N-1 contingency screening: batched same-pattern refactorization.

The JAX package's ``csparse3_tpu/models/contingency.py``.  For every
branch outage, re-solve the network and report the post-outage state:

* A branch outage never changes the pattern of B' (DC) or Ybus (AC), only
  the four values that branch stamps.  So the base case is factored once
  on the host (pattern and pivot order frozen), and every contingency is a
  numeric refactorization on the device.  The JAX package ``vmap``s one
  scenario over the outage list; here the scenarios are the leading axis
  of one batch: (K, nnz) values through one batched refactorization and
  one batched solve per chunk of ``batch`` outages.

* Islanding: an outage that splits the grid makes the reduced B'
  singular.  With frozen pivots the zero pivot may come out as round-off
  noise, and the solution is then finite and backward-stable garbage that
  neither a finiteness nor a residual check catches.  ``ok`` therefore
  uses the KLU-style pivot ratio min|U_kk| / max|U_kk| of each scenario's
  own refactorization, thresholded at 1000 eps of the dtype.

``run_sharded(mesh, outages)`` spreads the outage list over the positions
of a ``parallel.Mesh`` (scenario data parallel, no communication): the
list is padded to a multiple of the mesh size with repeats of its first
outage, each position runs its part through ``run`` on its device (one
study object per distinct device), and the padding is dropped.

Deviation from the JAX package, by design: the results stay on the device
as tensors (the JAX package returns host numpy), ``run_sharded``'s on the
mesh's first device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import resolve_device
from ..linalg import splu
from ..linalg.multifrontal import MultifrontalRefactor
from ..ops import construct
from ..ops.slicing import sample_offsets
from ..types import _placed_on
from ..utils.profiling import span
from .grids import SLACK, Grid, branch_admittances

__all__ = ["ACContingency", "DCContingency"]


def _check_outages(outages, n_branch):
    """Validate and normalize an outage index list (a gather would wrap a
    negative id, and the JAX package's would clamp one past the end)."""
    outages = np.asarray(outages, dtype=np.int64)
    if outages.size and ((outages < 0) | (outages >= n_branch)).any():
        bad = outages[(outages < 0) | (outages >= n_branch)]
        raise IndexError(
            f"outage ids out of range [0, {n_branch}): {bad[:5]}...")
    return outages


def _replica(study, device):
    """``study`` itself when it runs on ``device``, else its copy built
    there (made at the first call and kept)."""
    if _placed_on(study.device, device):
        return study
    replicas = study.__dict__.setdefault("_replicas", {})
    key = str(torch.device(device))
    if key not in replicas:
        replicas[key] = type(study)(study.grid, device=device, **study._kw)
    return replicas[key]


def _sharded(study, mesh, outages, axis):
    """``study.run`` of ``outages`` (None: every branch) spread over the
    positions of ``mesh``: padded to a multiple of the mesh size with
    repeats of the first outage, one part a position on its device, the
    parts joined on the first position's device, the padding dropped."""
    mesh.check_axis(axis)
    if outages is None:
        outages = np.arange(study.n_branch)
    outages = _check_outages(outages, study.n_branch)
    dev0 = mesh.devices[0]
    K, S = len(outages), mesh.size
    if K == 0:
        return _replica(study, dev0).run(outages)
    ks = np.concatenate([outages, np.full((-K) % S, outages[0])])
    per = len(ks) // S
    parts = [_replica(study, dev).run(ks[p * per:(p + 1) * per])
             for p, dev in enumerate(mesh.devices)]
    return tuple(torch.cat([part[i].to(dev0) for part in parts])[:K]
                 for i in range(len(parts[0])))


def _outage_values(base, pos, delta, ks):
    """(K, nnz) values: ``base`` less the stamp (4 positions ``pos[k]``,
    values ``delta[k]``) of each outaged branch k in ``ks``."""
    out = base.expand(ks.shape[0], -1).clone()
    return out.scatter_add_(1, pos[ks], -delta[ks])


def _refactor_plan(Br, ordering, device):
    """The device refactorization plan of the reduced B' on ``device``.

    B' is a diagonally dominant reduced Laplacian: a no-pivot ND
    factorization is stable and lets the batched refactorization run as
    dense fronts (``MultifrontalRefactor``) instead of the scalar
    level-scheduled plan; ``RefactorPlan`` takes anything it refuses."""
    if ordering in ("auto", "nd", "amd", "rcm"):
        try:
            lu0 = splu(Br, ordering="nd" if ordering == "auto" else ordering,
                       tol=0.0)
            # the no-pivot factorization must be numerically sound before
            # its pivots are frozen: a grid that breaks B' diagonal
            # dominance (series compensation, 1/x < 0) can hit a zero or
            # tiny pivot that is reported (or silently infs) rather than
            # raised
            if lu0.is_singular or not (
                    np.isfinite(np.asarray(lu0._h.Lx)).all()
                    and np.isfinite(np.asarray(lu0._h.Ux)).all()):
                raise ValueError("no-pivot base factorization unstable")
            return MultifrontalRefactor(lu0._h, Br, device=device)
        except (ValueError, AssertionError):
            pass
    return splu(Br, ordering=ordering).refactor_plan(Br, device=device)


def _chunks(n, batch):
    step = batch or max(n, 1)
    return [(s, min(s + step, n)) for s in range(0, n, step)]


class ACContingency:
    """Full-AC N-1 screening: one batched device Newton over the outages.

    A branch outage changes only the four Ybus stamp values (yff, yft, ytf,
    ytt) of that branch, so one base-case symbolic factorization serves
    every scenario, and each chunk of outages runs
    ``NewtonPowerFlow.run_batch`` with per-scenario Ybus values: the
    mismatch from the raw entry streams, Jacobian assembly and
    refactorization on the device.  ``ok`` is the Newton convergence flag:
    an islanding outage leaves no solution (no slack in the island), and
    the mismatch, evaluated against the scenario's own admittances, stays
    large.  A scenario that trips the growth gate of ``solver=
    'multifrontal'`` counts as not converged.
    """

    def __init__(self, grid: Grid, tol=None, max_iter=20, device=None,
                 **pf_kwargs):
        from .powerflow import NewtonPowerFlow

        # the port's Newton state is float64 throughout: the JAX package's
        # x64 target
        tol = 1e-8 if tol is None else tol
        self.pf = NewtonPowerFlow(grid, tol=tol, max_iter=max_iter,
                                  device=device, **pf_kwargs)
        self._kw = dict(tol=tol, max_iter=max_iter, **pf_kwargs)
        self.grid = grid
        self.tol = tol
        self.device = self.pf.device
        Y = self.pf.Y
        f, t = np.asarray(grid.f), np.asarray(grid.t)
        yff, yft, ytf, ytt = branch_admittances(grid)
        pos = np.stack([
            sample_offsets(Y, f, f), sample_offsets(Y, f, t),
            sample_offsets(Y, t, f), sample_offsets(Y, t, t),
        ], axis=1)
        if (pos < 0).any():
            raise RuntimeError("branch stamp missing from assembled Ybus")
        delta = np.stack([yff, yft, ytf, ytt], axis=1)

        def dev(a, dtype=torch.float64):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                   device=self.device)

        self._pos = dev(pos, torch.int64)                       # (m, 4)
        self._dre, self._dim = dev(delta.real), dev(delta.imag)  # (m, 4)
        self._vm0 = dev(np.asarray(grid.vm0, dtype=np.float64))

    @property
    def n_branch(self) -> int:
        return self.grid.n_branch

    @torch.inference_mode()
    def run(self, outages=None, batch: int | None = None):
        """Screen ``outages`` (default: every branch) in chunks of
        ``batch`` scenarios (default: all at once).  Returns (vm (K, n), va
        (K, n), iters (K,), ok (K,)) as tensors on the device."""
        if outages is None:
            outages = np.arange(self.n_branch)
        outages = _check_outages(outages, self.n_branch)
        K, n = len(outages), self.grid.n_bus
        f64 = dict(dtype=torch.float64, device=self.device)
        vm = torch.zeros((K, n), **f64)
        va = torch.zeros((K, n), **f64)
        iters = torch.zeros(K, dtype=torch.int64, device=self.device)
        res = torch.zeros(K, **f64)
        pf = self.pf
        ks_all = torch.as_tensor(outages, device=self.device)
        for s, e in _chunks(K, batch):
            ks = ks_all[s:e]
            ygr = _outage_values(pf._ygr, self._pos, self._dre, ks)
            ygi = _outage_values(pf._ygi, self._pos, self._dim, ks)
            vm0 = self._vm0.expand(e - s, n)
            v, a, it, r, bad = pf.run_batch(
                vm0, torch.zeros_like(vm0), pf._sbr.expand(e - s, n),
                pf._sbi.expand(e - s, n), ygr, ygi)
            vm[s:e], va[s:e], iters[s:e] = v, a, it
            # a gated scenario counts as not converged
            res[s:e] = torch.where(bad, torch.inf, r)
        ok = torch.isfinite(res) & (res < 10 * self.tol)
        return vm, va, iters, ok

    def run_sharded(self, mesh, outages=None, axis: str | None = None):
        """``run`` of ``outages`` spread over the positions of ``mesh``
        (module docstring); returns what ``run`` returns, on the mesh's
        first device."""
        return _sharded(self, mesh, outages, axis)


class DCContingency:
    """DC (B' theta = P) N-1 screening for a grid, on ``device`` (None:
    ``config.default_device()``, the CUDA card).

    ``run(outages)`` returns (flows, theta, ok): per-scenario branch flows
    (K, n_branch), bus angles (K, n_bus, slack = 0), and the mask of
    outages with a sound solution (False: the outage islands the grid),
    as tensors on the device.
    """

    def __init__(self, grid: Grid, ordering="auto", device=None):
        self.device = resolve_device(device)
        self._kw = dict(ordering=ordering)
        n = grid.n_bus
        f, t = np.asarray(grid.f), np.asarray(grid.t)
        bsus = 1.0 / np.asarray(grid.x)
        rows = np.concatenate([f, t, f, t])
        cols = np.concatenate([t, f, f, t])
        vals = np.concatenate([-bsus, -bsus, bsus, bsus])
        B = construct.from_triplets(rows, cols, vals, (n, n))
        keep = np.flatnonzero(np.asarray(grid.bus_type) != SLACK)
        red = np.full(n, -1, dtype=np.int64)
        red[keep] = np.arange(len(keep))
        Br = B[keep, keep]
        with span("setup.symbolic", n=Br.n) as sp:
            self._rp = _refactor_plan(Br, ordering, self.device)
            sp.note(front_floats=getattr(self._rp, "front_floats", 0))

        # per-branch outage stamp: up to 4 (position, delta) pairs in the
        # reduced matrix; entries touching the slack simply vanish
        m = grid.n_branch
        rf, rt = red[f], red[t]
        ls = []
        for rr, cc, sgn in ((rf, rf, +1.0), (rt, rt, +1.0),
                            (rf, rt, -1.0), (rt, rf, -1.0)):
            live = (rr >= 0) & (cc >= 0)
            pos = np.zeros(m, dtype=np.int64)
            pos[live] = sample_offsets(Br, rr[live], cc[live])
            delta = np.where(live, sgn * bsus, 0.0)
            if (pos[live] < 0).any():
                # a structurally live entry must exist in the assembled B'
                raise RuntimeError(
                    "branch stamp position missing from the assembled B' "
                    "(entry eliminated during assembly?)")
            ls.append((pos, delta))
        nb = len(keep)

        def dev(a, dtype=torch.float64):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                   device=self.device)

        self.grid = grid
        self.keep = keep
        self._keep = dev(keep, torch.int64)
        self._pos = dev(np.stack([p for p, _ in ls], axis=1), torch.int64)
        self._delta = dev(np.stack([d for _, d in ls], axis=1))
        self._base = dev(Br.np_arrays()[2])
        self._P = dev((np.asarray(grid.pg) - np.asarray(grid.pd))[keep])
        self._binv_x = dev(bsus)
        # angle gathers with a guard slot nb (slack buses read 0)
        self._gf = dev(np.where(rf >= 0, rf, nb), torch.int64)
        self._gt = dev(np.where(rt >= 0, rt, nb), torch.int64)

    @property
    def n_branch(self) -> int:
        return self.grid.n_branch

    @torch.inference_mode()
    def base_theta(self):
        """Pre-contingency angles (device solve with the base values), a
        tensor on the device (slack = 0)."""
        th = torch.zeros(self.grid.n_bus, dtype=torch.float64,
                         device=self.device)
        th[self._keep] = self._rp.refactor(self._base)(self._P)
        return th

    @torch.inference_mode()
    def run(self, outages=None, batch: int | None = None):
        """Screen ``outages`` (default: every branch) in chunks of
        ``batch`` scenarios (default: all at once; a chunk holds K copies
        of the factorization's working set).  Returns (flows (K, n_branch),
        theta (K, n_bus), ok (K,)) as tensors on the device."""
        if outages is None:
            outages = np.arange(self.n_branch)
        outages = _check_outages(outages, self.n_branch)
        K, m = len(outages), self.n_branch
        f64 = dict(dtype=torch.float64, device=self.device)
        flows = torch.zeros((K, m), **f64)
        theta = torch.zeros((K, self.grid.n_bus), **f64)
        ok = torch.zeros(K, dtype=torch.bool, device=self.device)
        ks_all = torch.as_tensor(outages, device=self.device)
        # a noise pivot sits at O(eps) relative, sound grid pivots orders
        # of magnitude above
        tol = 1000.0 * torch.finfo(torch.float64).eps
        for s, e in _chunks(K, batch):
            with span("study.batch", K=e - s, item="outage"):
                ks = ks_all[s:e]
                data = _outage_values(self._base, self._pos, self._delta, ks)
                plan, u_diag = self._rp.refactor(data, with_diag=True)
                th_r = plan(self._P.expand(e - s, -1))
                au = u_diag.abs()
                rcond = au.amin(1) / au.amax(1).clamp_min(1e-30)
                th_pad = torch.cat([th_r, th_r.new_zeros(e - s, 1)], dim=1)
                fl = self._binv_x * (th_pad[:, self._gf]
                                     - th_pad[:, self._gt])
                # the outaged branch carries nothing
                fl[torch.arange(e - s, device=self.device), ks] = 0.0
                flows[s:e] = fl
                theta[s:e, self._keep] = th_r
                ok[s:e] = (torch.isfinite(fl).all(1)
                           & torch.isfinite(th_r).all(1)
                           & torch.isfinite(rcond) & (rcond > tol))
        return flows, theta, ok

    def run_sharded(self, mesh, outages=None, axis: str | None = None):
        """``run`` of ``outages`` spread over the positions of ``mesh``
        (module docstring); returns what ``run`` returns, on the mesh's
        first device."""
        return _sharded(self, mesh, outages, axis)
