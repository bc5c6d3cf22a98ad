"""Power-flow solvers: the library's main paths.

* ``dc_power_flow``  linear B theta = P, one LU factor + solve.
* ``FastDecoupled``  FDXB fast-decoupled AC power flow: two constant
                     matrices B' / B'' factored ONCE on the host; every
                     iteration is then {split-complex Ybus SpMV, two
                     triangular solves} on the device.
* ``NewtonPowerFlow`` / ``newton_raphson``  full Newton, below.

``NewtonPowerFlow`` (the JAX package's ``csparse3_tpu/models/powerflow.py``
class of the same name): the Jacobian pattern is fixed by the Ybus
pattern, so the host does the symbolic work once, and every Newton
iteration then runs on the device: split-complex Ybus SpMV for the
mismatch, Jacobian values on the frozen pattern, numeric factorization and
solve, state update.  ``solver='level'`` freezes a host LU's pivots and
refactors with ``linalg.RefactorPlan`` and level-scheduled triangular
solves; ``solver='multifrontal'`` factors from scratch every iteration in
dense fronts (``linalg.MultifrontalLU``) with partial pivoting inside each
front, gated on pivot growth; ``solver='blocklu'`` refactors the
RCM-ordered Jacobian as block-Thomas recurrences (``linalg.BandedRefactor``).
The JAX ``lax.while_loop`` is a Python loop here, with one host read per
iteration (the residual norm, and the gate).

``FastDecoupled`` solves with level-scheduled triangular solves
(``solver='level'``), block-bidiagonal sweeps over a no-row-exchange sparse
LU (``'banded'``) or the block-Thomas ``linalg.BandedLU`` (``'blocklu'``).

``newton_raphson`` is the host reference (``splu`` per iteration).

Batched studies (``NewtonPowerFlow.solve_batch`` / ``run_batch``,
``FastDecoupled.solve_batch``): K scenarios (load cases, or per-scenario
Ybus values for the AC contingencies) against ONE symbolic factorization,
as the JAX package's ``jax.vmap``.  Every device op of an iteration takes
the whole (K, n) batch: one launch of the Ybus SpMV kernel per mismatch
evaluation, batched refactorizations and solves.  The loop runs until no
scenario is active, and a scenario that converged, ran out of iterations
or tripped the growth gate keeps its state (``torch.where``), so its
iteration count is that of its own solve, as under ``vmap``.  The batched
results stay on the device as tensors.

Every entry point runs on ``device``; None is ``config.default_device()``,
the CUDA card, and a caller without one passes ``device="cpu"``.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from ..config import resolve_device
from ..linalg import BandedLU, MultifrontalLU, splu
from ..ops import construct, matvec
from ..ops.matvec import _recorded
from ..types import CSC
from ..utils.profiling import span
from .grids import SLACK, Grid, _as_common, ybus

__all__ = ["sbus", "dc_power_flow", "FastDecoupled", "newton_raphson",
           "NewtonPowerFlow"]


def sbus(grid: Grid):
    """Complex power injections (generation - load) per bus; a tensor
    (differentiable) where a field of the grid is one."""
    pg, pd, qd = _as_common(grid.pg, grid.pd, grid.qd)
    return (pg - pd) - 1j * qd


def _make_yplan(Y, spmv, device):
    """Split-complex Ybus SpMV plan on ``device``.

    'ell'        gather-based SplitSpMV;
    'dia'        gather-free banded slabs (pair with models.grids.rcm_grid),
                 the CUDA kernel of kernels.dia on a GPU;
    'symdia'     like 'dia' but stores only the upper diagonals: Ybus is
                 complex symmetric when taps are real (no phase shifters),
                 which halves the slab traffic.  Raises if Y is not
                 symmetric;
    'bandpoints' heavy-diagonal slabs + scattered points
                 (kernels.bandpoints, its CUDA kernel on a GPU), float32 by
                 design: the Newton mismatch floors near f32 precision.

    'ell', 'dia' and 'symdia' keep Ybus's dtype (float64 parts).
    """
    with span("setup.plans", spmv=spmv, n=Y.n):
        return _yplan(Y, spmv, device)


def _yplan(Y, spmv, device):
    if spmv == "ell":
        return matvec.SplitSpMV(Y, device=device)
    if spmv == "dia":
        return matvec.SplitDIA(Y, device=device)
    if spmv == "symdia":
        return matvec.SplitSymDIA(Y, tol=1e-12, device=device)
    if spmv == "bandpoints":
        from ..kernels.bandpoints import SplitBandPoints

        return SplitBandPoints(Y, device=device)
    raise ValueError(f"unknown spmv {spmv!r}; have 'ell', 'dia', 'symdia', "
                     "'bandpoints'")


# ---------------------------------------------------------------------------
# DC power flow
# ---------------------------------------------------------------------------

def _b_series(grid: Grid) -> CSC:
    """Series-susceptance matrix (r = 0, b = 0, tap = 1): DC power flow's B
    and the fast-decoupled B'."""
    n = grid.n_bus
    bsus = 1.0 / grid.x
    f, t = grid.f, grid.t
    return construct.from_triplets(
        np.concatenate([f, t, f, t]), np.concatenate([f, t, t, f]),
        np.concatenate([bsus, bsus, -bsus, -bsus]), (n, n))


def dc_power_flow(grid: Grid, ordering="auto", device=None):
    """theta = B^{-1} P with the slack row and column removed, solved on
    ``device``; returns the bus angles as host numpy (radians, slack = 0)."""
    device = resolve_device(device)
    keep = np.flatnonzero(grid.bus_type != SLACK)
    Br = _b_series(grid)[keep, keep]
    P = (grid.pg - grid.pd)[keep]
    lu = splu(Br, ordering=ordering)
    th = np.zeros(grid.n_bus)
    th[keep] = lu.solve(P, device=device).cpu().numpy()
    return th


# ---------------------------------------------------------------------------
# fast-decoupled power flow (XB scheme)
# ---------------------------------------------------------------------------

class FastDecoupled:
    """Factor-once fast-decoupled AC power flow on ``device``.

    Construction does the host work (Ybus, B' and B'' assembly, two LU
    factorizations, the solve plans); ``step`` / ``run`` are device work:
    per iteration two Ybus SpMVs and one solve against each factorization.
    """

    def __init__(self, grid: Grid, ordering="auto", tol=1e-8, max_iter=50,
                 spmv="ell", solver="level", device=None):
        """spmv: 'ell' (gathers), 'dia' (gather-free banded slabs: reorder
        the grid with models.grids.rcm_grid first so that Ybus is banded),
        'symdia' (dia with only the upper diagonals stored; valid when
        Ybus is complex symmetric, i.e. no phase shifters) or
        'bandpoints'.  solver: 'level' (``SparseLU.solve_plan``: level
        schedules with a dense tail where the factor has one), 'banded'
        (``SparseLU.banded_solve_plan``: block-bidiagonal sweeps over the
        factors of ``splu(B, ordering='rcm', tol=0)``) or 'blocklu'
        (``linalg.BandedLU``, block Thomas with its own RCM ordering: no
        sparse factorization at all).  ``ordering`` applies to 'level'."""
        if solver not in ("level", "banded", "blocklu"):
            raise ValueError(f"unknown solver {solver!r}; have 'level', "
                             "'banded', 'blocklu'")
        self.grid = grid
        self.tol = tol
        self.max_iter = max_iter
        self.device = resolve_device(device)
        n = grid.n_bus
        self.Y, _, _ = ybus(grid)
        self.pvpq = np.concatenate([grid.pv, grid.pq])
        self.pq = grid.pq
        self.slack = grid.slack

        # B': series susceptance only, slack removed
        Bp = _b_series(grid)[self.pvpq, self.pvpq]
        # B'': -imag(Ybus) on PQ buses
        ipY, ixY, dtY = self.Y.np_arrays()
        colsY = np.repeat(np.arange(n), np.diff(ipY))
        Bpp = construct.from_triplets(ixY, colsY, -dtY.imag,
                                      (n, n))[self.pq, self.pq]
        if solver == "blocklu":
            self.lu_bp = self._bp_plan = BandedLU(Bp, device=self.device)
            self.lu_bpp = self._bpp_plan = BandedLU(Bpp, device=self.device)
        elif solver == "banded":
            self.lu_bp = splu(Bp, ordering="rcm", tol=0.0)
            self.lu_bpp = splu(Bpp, ordering="rcm", tol=0.0)
            self._bp_plan = self.lu_bp.banded_solve_plan(device=self.device)
            self._bpp_plan = self.lu_bpp.banded_solve_plan(
                device=self.device)
        else:
            self.lu_bp = splu(Bp, ordering=ordering)
            self.lu_bpp = splu(Bpp, ordering=ordering)
            self._bp_plan = self.lu_bp.solve_plan(device=self.device)
            self._bpp_plan = self.lu_bpp.solve_plan(device=self.device)
        self._yplan = _make_yplan(self.Y, spmv, self.device)

        def f64(a):
            return torch.as_tensor(np.ascontiguousarray(a),
                                   dtype=torch.float64, device=self.device)

        sb = sbus(grid)
        self._sbr, self._sbi = f64(sb.real), f64(sb.imag)
        self._vm0 = f64(grid.vm0)
        self._pvpq_t = torch.as_tensor(self.pvpq, dtype=torch.int64,
                                       device=self.device)
        self._pq_t = torch.as_tensor(self.pq, dtype=torch.int64,
                                     device=self.device)

    def mismatch(self, vm, va, sbr=None, sbi=None):
        """Power mismatch dS = (S(V) - Sbus) / Vm as (real, imag) parts;
        every argument (n,) or a batch (K, n)."""
        sbr = self._sbr if sbr is None else sbr
        sbi = self._sbi if sbi is None else sbi
        with span("pf.mismatch"):
            vr = vm * torch.cos(va)
            vi = vm * torch.sin(va)
            with span("spmv", plan=type(self._yplan).__name__,
                      K=_batch(vr)):
                yr, yi = self._yplan(vr, vi)
            # s = v * conj(Y v)
            sr = vr * yr + vi * yi
            si = vi * yr - vr * yi
            return (sr - sbr) / vm, (si - sbi) / vm

    def step(self, carry):
        """One P-theta / Q-V half-iteration pair; returns the new carry
        (vm, va, sbr, sbi) and leaves the one given untouched.  A batch
        (K, n) solves its K right-hand sides against each fixed factor in
        one multi-RHS solve.  Differentiable in the carry, as the JAX
        package's step, when a part of it requires a gradient."""
        with _recorded(*carry):
            return self._step(carry)

    def _step(self, carry):
        vm, va, sbr, sbi = carry
        mr, _ = self.mismatch(vm, va, sbr, sbi)
        va = va.index_add(-1, self._pvpq_t,
                          _solve_rows(self._bp_plan, mr[..., self._pvpq_t]),
                          alpha=-1)
        _, mi = self.mismatch(vm, va, sbr, sbi)
        vm = vm.index_add(-1, self._pq_t,
                          _solve_rows(self._bpp_plan, mi[..., self._pq_t]),
                          alpha=-1)
        return (vm, va, sbr, sbi)

    def residual(self, vm, va, sbr=None, sbi=None):
        """Max-norm of the mismatch over the equations solved (P at PV and
        PQ buses, Q at PQ buses): a 0-d tensor, (K,) for a batch.
        Differentiable as ``step``."""
        with _recorded(vm, va, sbr, sbi):
            mr, mi = self.mismatch(vm, va, sbr, sbi)
            r = torch.cat([mr[..., self._pvpq_t], mi[..., self._pq_t]],
                          dim=-1)
            return r.abs().amax(-1) if r.shape[-1] else torch.zeros(
                r.shape[:-1], dtype=vm.dtype, device=vm.device)

    @torch.inference_mode()
    def run(self, vm0, va0, sbr=None, sbi=None):
        """Iterate from (vm0, va0) while the residual exceeds ``tol`` and
        fewer than ``max_iter`` iterations ran; returns (vm, va,
        iterations) with vm, va on the device.  One host read per residual
        evaluation (``run_batch`` of one scenario)."""
        vm, va, it = self.run_batch(vm0, va0,
                                    self._sbr if sbr is None else sbr,
                                    self._sbi if sbi is None else sbi)
        return vm, va, int(it)

    def solve(self, flat_start=True):
        """Solve from the grid's flat start; returns host numpy (vm, va),
        the iteration count and the final residual."""
        vm, va, it = self.run(self._vm0, torch.zeros_like(self._vm0))
        res = float(self.residual(vm, va))
        return vm.cpu().numpy(), va.cpu().numpy(), int(it), res

    @torch.inference_mode()
    def run_batch(self, vm0, va0, sbr, sbi):
        """``run`` for K scenarios at once, every argument (K, n) (or (n,)
        for one): each iteration evaluates the K residuals (one Ybus
        product of the batch) and reads whether any scenario is still
        active in one host transfer; the active ones take a step, the
        others keep their state.  Returns (vm, va, iterations (K,)) on the
        device; each scenario's count is that of its own solve."""
        vm = vm0.to(self.device, torch.float64, copy=True)
        va = va0.to(self.device, torch.float64, copy=True)
        it = torch.zeros(vm.shape[:-1], dtype=torch.int64,
                         device=self.device)
        for i in itertools.count():
            active = ((self.residual(vm, va, sbr, sbi) > self.tol)
                      & (it < self.max_iter))
            with span("host.sync"):
                done = not bool(active.any())
            if done:
                return vm, va, it
            with span("pf.iteration", i=i):
                vm2, va2, _, _ = self.step((vm, va, sbr, sbi))
                keep = active[..., None]
                vm = torch.where(keep, vm2, vm)
                va = torch.where(keep, va2, va)
                it = it + active

    def solve_batch(self, sb_batch):
        """Solve K load scenarios, ``sb_batch`` (K, n) complex bus
        injections, against the one pair of factorizations from the flat
        start.  Returns (vm, va, iterations) as tensors on the device, (K,
        n), (K, n) and (K,)."""
        sb = np.asarray(sb_batch)
        K = sb.shape[0]
        with span("study.batch", K=K, item="snapshot"):
            with span("io.upload", bytes=2 * 8 * sb.size):
                sbr, sbi = (torch.as_tensor(np.ascontiguousarray(p),
                                            dtype=torch.float64,
                                            device=self.device)
                            for p in (sb.real, sb.imag))
            vm0 = self._vm0.expand(K, -1)
            return self.run_batch(vm0, torch.zeros_like(vm0), sbr, sbi)


def _batch(v) -> int:
    """The scenarios of a vector (n,) or a batch (K, n)."""
    return v.shape[0] if v.ndim > 1 else 1


def _solve_rows(plan, r):
    """x = A^{-1} r for r (n,) or a batch of right-hand sides as rows (K,
    n): the solve plans take them as (n, K) columns."""
    return plan(r) if r.ndim == 1 else plan(r.T).T


def _jacobian(Y: CSC, v, ibus, pvpq, pq):
    """Sparse power-flow Jacobian from Ybus entry streams (host, numpy).

    dS/dVa (i,k) = j V_i (delta_ik conj(I_i) - conj(y_ik) conj(V_k))
    dS/dVm (i,k) = V_i conj(y_ik) conj(V_k)/|V_k| + delta_ik conj(I_i) V_i/|V_i|
    """
    ip, rows, y = Y.np_arrays()
    ip = np.asarray(ip)
    cols = np.repeat(np.arange(Y.n), np.diff(ip))
    v = np.asarray(v)
    ibus = np.asarray(ibus)
    vm = np.abs(v)

    dva = -1j * v[rows] * np.conj(y) * np.conj(v[cols])
    dvm = v[rows] * np.conj(y) * np.conj(v[cols]) / vm[cols]
    diag = rows == cols
    dva[diag] += 1j * v[rows[diag]] * np.conj(ibus[rows[diag]])
    dvm[diag] += np.conj(ibus[rows[diag]]) * v[rows[diag]] / vm[rows[diag]]

    n = Y.n
    # index maps: bus id -> position in pvpq / pq (or -1)
    pos_pvpq = np.full(n, -1)
    pos_pvpq[pvpq] = np.arange(len(pvpq))
    pos_pq = np.full(n, -1)
    pos_pq[pq] = np.arange(len(pq))

    npvpq, npq = len(pvpq), len(pq)
    blocks = []
    for vals, rsel, csel, roff, coff, part in [
        (dva, pos_pvpq, pos_pvpq, 0, 0, np.real),
        (dvm, pos_pvpq, pos_pq, 0, npvpq, np.real),
        (dva, pos_pq, pos_pvpq, npvpq, 0, np.imag),
        (dvm, pos_pq, pos_pq, npvpq, npvpq, np.imag),
    ]:
        keep = (rsel[rows] >= 0) & (csel[cols] >= 0)
        blocks.append((
            rsel[rows[keep]] + roff,
            csel[cols[keep]] + coff,
            part(vals[keep]),
        ))
    jr = np.concatenate([b[0] for b in blocks])
    jc = np.concatenate([b[1] for b in blocks])
    jv = np.concatenate([b[2] for b in blocks])
    dim = npvpq + npq
    return construct.from_triplets(jr, jc, jv, (dim, dim))


def _growth_gate(jd, stats, growth_limit, piv_rtol):
    """The pivot-growth gate of a front factorization (0-d bool tensor):
    within-front pivoting cannot reach rows outside the front, so a
    factorization is suspect when (a) a pivot collapses relative to the
    factor's magnitude, (b) its element growth against the input Jacobian
    exceeds ``growth_limit``, or (c) its factors are not finite.

    The zero-scale guard is the tiny of ``jd``'s own dtype.  The JAX
    package adds float64's tiny cast to ``jd``'s dtype, which is 0 in
    float32, so its guard does nothing there.  A batch, ``jd`` (K, nnz)
    and (K,) stats, gives one gate per scenario."""
    scale = jd.abs().amax(-1) + torch.finfo(jd.dtype).tiny
    return ((stats["min_pivot"] < piv_rtol * stats["max_u"])
            | (stats["max_u"] > growth_limit * scale)
            | ~torch.isfinite(stats["max_u"]))


class NewtonPowerFlow:
    """Newton power flow with device factorization, on ``device``.

    Construction is host work: Ybus, the SpMV plan, the fixed Jacobian
    structure, the symbolic factorization of the flat-start Jacobian and
    the device plan.  ``run`` / ``solve`` iterate on the device.
    """

    def __init__(self, grid: Grid, tol=1e-10, max_iter=20, ordering="auto",
                 spmv="ell", solver="level", growth_limit=1e7,
                 piv_rtol=1e-10, device=None):
        """spmv: 'ell' (float64 gathers), 'dia' / 'symdia' (float64 banded
        slabs, for a grid reordered with models.grids.rcm_grid; the DIA
        CUDA kernel on a GPU) or 'bandpoints' (float32 slabs + points, its
        CUDA kernel on a GPU).  solver: 'level' (KLU-style RefactorPlan +
        level-scheduled solves) or 'multifrontal' (``MultifrontalLU``: a
        from-scratch front factorization per iteration with partial
        pivoting inside each front, ND-ordered under ordering='auto', and
        the front-form solve) or 'blocklu' (``BandedLU(J0)
        .refactor_plan(J0)``: the RCM-ordered Jacobian refactored every
        iteration as block-Thomas recurrences on the device; ``ordering``
        does not apply, and a Jacobian whose bandwidth exceeds the block
        size raises here).  ``growth_limit`` / ``piv_rtol`` set the
        'multifrontal' pivot-growth gate (``_growth_gate``): a gated
        iteration is not applied, and ``solve`` continues on the host with
        true partial pivoting."""
        if solver not in ("level", "multifrontal", "blocklu"):
            raise ValueError(f"unknown solver {solver!r}; have 'level', "
                             "'multifrontal', 'blocklu'")
        self.grid = grid
        self.tol = tol
        self.max_iter = max_iter
        self.growth_limit = float(growth_limit)
        self.piv_rtol = float(piv_rtol)
        self.device = resolve_device(device)
        n = grid.n_bus
        self.Y, _, _ = ybus(grid)
        self._yplan = _make_yplan(self.Y, spmv, self.device)
        sb = sbus(grid)

        def f64(a):
            return torch.as_tensor(np.ascontiguousarray(a),
                                   dtype=torch.float64, device=self.device)

        def i64(a):
            return torch.as_tensor(np.asarray(a), dtype=torch.int64,
                                   device=self.device)

        self._sbr, self._sbi = f64(sb.real), f64(sb.imag)
        pvpq = np.concatenate([grid.pv, grid.pq])
        pq = grid.pq
        self._pvpq, self._pq = i64(pvpq), i64(pq)
        self._npvpq = len(pvpq)

        # ---- fixed Jacobian structure from Ybus entry streams ------------
        with span("setup.plans", part="jacobian", n=n):
            npvpq, npq = len(pvpq), len(pq)
            ipY, ixY, dtY = self.Y.np_arrays()
            rows = ixY.astype(np.int64)
            cols = np.repeat(np.arange(n, dtype=np.int64), np.diff(ipY))
            self._y_rows, self._y_cols = i64(rows), i64(cols)
            self._ygr, self._ygi = f64(dtY.real), f64(dtY.imag)
            self._diag_mask = torch.as_tensor(rows == cols,
                                              device=self.device)

            pos_pvpq = np.full(n, -1)
            pos_pvpq[pvpq] = np.arange(npvpq)
            pos_pq = np.full(n, -1)
            pos_pq[pq] = np.arange(npq)

            keeps, jr_l, jc_l = [], [], []
            for rsel, csel, roff, coff in [
                (pos_pvpq, pos_pvpq, 0, 0),       # J11 real(dS/dVa)
                (pos_pvpq, pos_pq, 0, npvpq),     # J12 real(dS/dVm)
                (pos_pq, pos_pvpq, npvpq, 0),     # J21 imag(dS/dVa)
                (pos_pq, pos_pq, npvpq, npvpq),   # J22 imag(dS/dVm)
            ]:
                keep = np.flatnonzero((rsel[rows] >= 0)
                                      & (csel[cols] >= 0))
                keeps.append(keep)
                jr_l.append(rsel[rows[keep]] + roff)
                jc_l.append(csel[cols[keep]] + coff)
            jr = np.concatenate(jr_l)
            jc = np.concatenate(jc_l)
            dim = npvpq + npq
            # canonical-order permutation: J.data[i] = stream[perm[i]]
            perm = np.argsort(jc.astype(np.int64) * dim + jr,
                              kind="stable")
            self._keep = [i64(k) for k in keeps]
            self._perm = i64(perm)
        # host: factor the pattern once (values at flat start)
        v0 = grid.vm0.astype(np.complex128)
        ibus0 = self.Y.to_scipy().tocsr() @ v0
        J0 = _jacobian(self.Y, v0, ibus0, pvpq, pq)
        if solver == "blocklu":
            self._rp = BandedLU(J0, device=self.device).refactor_plan(J0)
        elif solver == "multifrontal":
            self._rp = MultifrontalLU.from_matrix(
                J0, ordering="nd" if ordering == "auto" else ordering,
                device=self.device)
        else:
            lu = splu(J0, ordering=ordering)
            self._rp = lu.refactor_plan(J0, device=self.device)

    # -- device Jacobian values (fixed pattern, split-complex real math) ----
    def _jac_data(self, vr, vi, vm, ir, ii, ygr=None, ygi=None):
        """Real/imag parts of dS/dVa and dS/dVm per Ybus entry, in real
        arithmetic, gathered into the Jacobian's canonical entry order:

          t = conj(y) conj(v_col);  dVa = -i v_row t (+ i v conj(I) on diag)
          dVm = v_row t / |v_col|   (+ conj(I) v/|v| on diag)

        Vectors (n,) or a batch (K, n), giving (nnz,) or (K, nnz).
        ``ygr`` / ``ygi`` override Ybus's entry values (same pattern; (nnz,)
        or one row per scenario)."""
        with span("pf.jacobian"):
            rows, cols = self._y_rows, self._y_cols
            gr = self._ygr if ygr is None else ygr
            gi = self._ygi if ygi is None else ygi
            vrr, vri = vr[..., rows], vi[..., rows]
            vcr, vci = vr[..., cols], vi[..., cols]
            t_r = gr * vcr - gi * vci
            t_i = -(gr * vci + gi * vcr)
            # p + iq = v_row * t
            p = vrr * t_r - vri * t_i
            q = vrr * t_i + vri * t_r
            dva_r, dva_i = q, -p
            dvm_r, dvm_i = p / vm[..., cols], q / vm[..., cols]
            irr, iir = ir[..., rows], ii[..., rows]
            vmr = vm[..., rows]
            dm = self._diag_mask
            dva_r = torch.where(dm, dva_r + vrr * iir - vri * irr, dva_r)
            dva_i = torch.where(dm, dva_i + vrr * irr + vri * iir, dva_i)
            dvm_r = torch.where(dm, dvm_r + (vrr * irr + vri * iir) / vmr,
                                dvm_r)
            dvm_i = torch.where(dm, dvm_i + (vri * irr - vrr * iir) / vmr,
                                dvm_i)
            stream = torch.cat([
                dva_r[..., self._keep[0]],
                dvm_r[..., self._keep[1]],
                dva_i[..., self._keep[2]],
                dvm_i[..., self._keep[3]],
            ], dim=-1)
            return stream[..., self._perm]

    def _mismatch_f(self, vm, va, sbr, sbi, ygr=None, ygi=None):
        """(f, (vr, vi), (ir, ii)): the mismatch of the equations solved and
        the voltage and current parts it came from, for (n,) or (K, n).
        With ``ygr`` / ``ygi`` (per-scenario Ybus values: the AC
        contingencies) the SpMV plan, which holds the base values, cannot
        serve: I = Y v is summed from the raw entry streams by
        ``index_add_``, one per part."""
        with span("pf.mismatch"):
            vr = vm * torch.cos(va)
            vi = vm * torch.sin(va)
            if ygr is None:
                with span("spmv", plan=type(self._yplan).__name__,
                          K=_batch(vr)):
                    ir, ii = self._yplan(vr, vi)
            else:
                rows, cols = self._y_rows, self._y_cols
                vcr, vci = vr[..., cols], vi[..., cols]
                ir = torch.zeros_like(vr).index_add_(-1, rows,
                                                     ygr * vcr - ygi * vci)
                ii = torch.zeros_like(vr).index_add_(-1, rows,
                                                     ygr * vci + ygi * vcr)
            mis_r = vr * ir + vi * ii - sbr
            mis_i = vi * ir - vr * ii - sbi
            f = torch.cat([mis_r[..., self._pvpq], mis_i[..., self._pq]],
                          dim=-1)
            return f, (vr, vi), (ir, ii)

    def _iterate(self, vm, va, sbr, sbi, ygr, ygi):
        """The Newton loop over (n,) vectors or a (K, n) batch; returns
        (vm, va, iterations, residual, bad) as tensors of the batch's shape.
        A scenario is active while its mismatch max-norm exceeds ``tol``,
        it ran fewer than ``max_iter`` iterations and the growth gate did
        not engage; the loop ends when none is (one host read per
        evaluation).  An inactive scenario keeps its state by
        ``torch.where``, never by a product with a mask: the factor of a
        frozen scenario may be non-finite (an islanded outage), and 0 * nan
        is nan."""
        lead = vm.shape[:-1]
        front = isinstance(self._rp, MultifrontalLU)
        it = torch.zeros(lead, dtype=torch.int64, device=self.device)
        bad = torch.zeros(lead, dtype=torch.bool, device=self.device)
        for i in itertools.count():
            f, (vr, vi), (ir, ii) = self._mismatch_f(vm, va, sbr, sbi,
                                                     ygr, ygi)
            nrm = (f.abs().amax(-1) if f.shape[-1]
                   else f.new_zeros(lead))
            active = (nrm > self.tol) & (it < self.max_iter) & ~bad
            with span("host.sync"):
                done = not bool(active.any())
            if done:
                return vm, va, it, nrm, bad
            with span("pf.iteration", i=i):
                jd = self._jac_data(vr, vi, vm, ir, ii, ygr, ygi)
                if front:
                    fac, stats = self._rp.factor_piv(jd)
                    gate = _growth_gate(jd, stats, self.growth_limit,
                                        self.piv_rtol)
                    dx = self._rp.solve_piv(fac, -f)
                    # a gated iteration counts but must not move the state
                    move = active & ~gate
                    bad = bad | (active & gate)
                else:
                    dx = self._rp.refactor(jd)(-f)
                    move = active
                move = move[..., None]
                va = torch.where(move, va.index_add(
                    -1, self._pvpq, dx[..., : self._npvpq]), va)
                vm = torch.where(move, vm.index_add(
                    -1, self._pq, dx[..., self._npvpq:]), vm)
                it = it + active

    @torch.inference_mode()
    def run(self, vm0, va0, sbr=None, sbi=None, ygr=None, ygi=None):
        """Iterate from (vm0, va0) until the mismatch max-norm is <= tol,
        ``max_iter`` iterations ran or the pivot-growth gate engaged;
        returns (vm, va, iterations, residual, bad) with vm, va on the
        device.  ``bad`` is True iff a 'multifrontal' factorization tripped
        the gate: that iteration counts but leaves the state unchanged,
        and the caller falls back to a true-pivoting host factorization
        (``solve`` does).  One mismatch evaluation (one Ybus SpMV) per
        iteration plus the final one, and one host read per evaluation.
        ``ygr`` / ``ygi`` override the Ybus entry values (same pattern)."""
        sbr = self._sbr if sbr is None else sbr
        sbi = self._sbi if sbi is None else sbi
        vm, va, it, nrm, bad = self._iterate(
            vm0.to(self.device, torch.float64, copy=True),
            va0.to(self.device, torch.float64, copy=True), sbr, sbi,
            ygr, ygi)
        with span("host.sync"):
            it, nrm, bad = torch.stack([it.to(nrm.dtype), nrm,
                                        bad.to(nrm.dtype)]).tolist()
        return vm, va, int(it), nrm, bool(bad)

    @torch.inference_mode()
    def run_batch(self, vm0, va0, sbr, sbi, ygr=None, ygi=None):
        """``run`` for K scenarios at once: vm0, va0, sbr, sbi (K, n) and
        optional per-scenario Ybus values ``ygr`` / ``ygi`` (K, nnz).
        Returns (vm, va, iterations, residual, bad) as tensors on the
        device, (K, n), (K, n) and (K,) each; every scenario's values are
        those of its own ``run``."""
        return self._iterate(
            vm0.to(self.device, torch.float64, copy=True),
            va0.to(self.device, torch.float64, copy=True),
            sbr.to(self.device, torch.float64),
            sbi.to(self.device, torch.float64), ygr, ygi)

    def _host_newton(self, vm, va, sb=None):
        """Continue Newton on the host with TRUE partial pivoting (``splu``
        per iteration) from (vm, va) for the injections ``sb`` (None: the
        grid's): the growth-gate fallback.  Returns (vm, va, iterations,
        residual)."""
        import warnings

        warnings.warn(
            "multifrontal pivot-growth gate engaged: falling back to "
            "host factorization with true partial pivoting",
            RuntimeWarning, stacklevel=3)
        vm = np.array(vm, dtype=np.float64)
        va = np.array(va, dtype=np.float64)
        y_csr = self.Y.to_scipy().tocsr()
        sb = sbus(self.grid) if sb is None else sb
        pvpq = np.concatenate([self.grid.pv, self.grid.pq])
        pq = self.grid.pq
        it = 0
        nrm = np.inf
        for it in range(self.max_iter):
            v = vm * np.exp(1j * va)
            ibus = y_csr @ v
            mis = v * np.conj(ibus) - sb
            f = np.concatenate([mis.real[pvpq], mis.imag[pq]])
            nrm = np.max(np.abs(f)) if f.size else 0.0
            if nrm < self.tol:
                break
            J = _jacobian(self.Y, v, ibus, pvpq, pq)
            dx = np.asarray(splu(J, ordering="auto").solve_host(-f))
            va[pvpq] += dx[: self._npvpq]
            vm[pq] += dx[self._npvpq:]
        return vm, va, it, nrm

    def solve(self, flat_start=True):
        """Solve from the grid's flat start; returns host numpy (vm, va),
        the iteration count and the final mismatch max-norm.  When the
        'multifrontal' growth gate engages, the solve continues on the host
        with true partial pivoting and warns (RuntimeWarning)."""
        n = self.grid.n_bus
        vm0 = torch.as_tensor(self.grid.vm0.astype(np.float64),
                              device=self.device)
        va0 = torch.zeros(n, dtype=torch.float64, device=self.device)
        vm, va, it, res, bad = self.run(vm0, va0)
        vm, va = vm.cpu().numpy(), va.cpu().numpy()
        if bad:
            vm, va, it2, res = self._host_newton(vm, va)
            it += it2
        return vm, va, int(it), float(res)

    @torch.inference_mode()
    def solve_batch(self, sb_batch):
        """Solve K load scenarios, ``sb_batch`` (K, n) complex bus
        injections, from the flat start against the one symbolic
        factorization: every iteration refactors all K Jacobians on the
        device (``run_batch``).  A scenario whose factorization trips the
        growth gate continues on the host with true partial pivoting
        (warned), as in ``solve``.  Returns (vm, va, iterations, residual)
        as tensors on the device."""
        sb = np.asarray(sb_batch)
        K, n = sb.shape[0], self.grid.n_bus
        f64 = dict(dtype=torch.float64, device=self.device)
        with span("study.batch", K=K, item="snapshot"):
            vm0 = torch.as_tensor(self.grid.vm0.astype(np.float64),
                                  **f64).expand(K, n)
            with span("io.upload", bytes=2 * 8 * sb.size):
                sbr, sbi = (torch.as_tensor(np.ascontiguousarray(p), **f64)
                            for p in (sb.real, sb.imag))
            vm, va, it, res, bad = self.run_batch(
                vm0, torch.zeros_like(vm0), sbr, sbi)
            with span("host.sync"):
                gated = np.flatnonzero(bad.cpu().numpy())
            for k in gated:
                vk, ak, ik, rk = self._host_newton(
                    vm[k].cpu().numpy(), va[k].cpu().numpy(), sb[k])
                vm[k], va[k] = (torch.as_tensor(a, **f64) for a in (vk, ak))
                it[k] += ik
                res[k] = rk
        return vm, va, it, res


@torch.inference_mode()
def newton_raphson(grid: Grid, tol=1e-10, max_iter=20, ordering="auto",
                   device=None):
    """Full Newton power flow with a host factorization per iteration (the
    reference implementation), products and solves on ``device``; returns
    (vm, va, iterations, residual)."""
    device = resolve_device(device)
    n = grid.n_bus
    Y, _, _ = ybus(grid)
    yplan = matvec.SpMVPlan(Y, device=device)
    sb = sbus(grid)
    pvpq = np.concatenate([grid.pv, grid.pq])
    pq = grid.pq
    vm = grid.vm0.astype(np.float64).copy()
    va = np.zeros(n)

    def ybus_times(v):
        return yplan(torch.as_tensor(v, device=device)).cpu().numpy()

    for it in range(max_iter):
        v = vm * np.exp(1j * va)
        ibus = ybus_times(v)
        mis = v * np.conj(ibus) - sb
        f = np.concatenate([mis.real[pvpq], mis.imag[pq]])
        nrm = np.max(np.abs(f)) if f.size else 0.0
        if nrm < tol:
            return vm, va, it, nrm
        J = _jacobian(Y, v, ibus, pvpq, pq)
        lu = splu(J, ordering=ordering)
        dx = lu.solve(torch.as_tensor(-f, device=device)).cpu().numpy()
        va[pvpq] += dx[: len(pvpq)]
        vm[pq] += dx[len(pvpq):]
    v = vm * np.exp(1j * va)
    mis = v * np.conj(ybus_times(v)) - sb
    f = np.concatenate([mis.real[pvpq], mis.imag[pq]])
    return vm, va, max_iter, float(np.max(np.abs(f)))
