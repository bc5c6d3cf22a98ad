"""Newton power flow, the library's main path.

``NewtonPowerFlow`` (the JAX package's ``csparse3_tpu/models/powerflow.py``
class of the same name, ``solver='level'``): the Jacobian pattern is fixed
by the Ybus pattern, so the host factors it once (symbolic work and
pivoting, native C++), and every Newton iteration then runs on the device:
split-complex Ybus SpMV for the mismatch, Jacobian values on the frozen
pattern, numeric refactorization (``linalg.RefactorPlan``), level-scheduled
triangular solves, state update.  The JAX ``lax.while_loop`` is a Python
loop here, with one host read of the residual norm per iteration.

``newton_raphson`` is the host reference (``splu`` per iteration).

Not ported yet, and refused with ``NotImplementedError``: spmv 'dia' /
'symdia' and solver 'blocklu' / 'multifrontal' (see ROADMAP.md), with the
multifrontal pivot-growth gate and its host fallback.
"""

from __future__ import annotations

import numpy as np
import torch

from ..linalg import splu
from ..ops import construct, matvec
from ..types import CSC
from .grids import Grid, ybus

__all__ = ["sbus", "newton_raphson", "NewtonPowerFlow"]


def sbus(grid: Grid):
    """Complex power injections (generation - load) per bus."""
    return (grid.pg - grid.pd) - 1j * grid.qd


def _make_yplan(Y, spmv, device):
    """Split-complex Ybus SpMV plan on ``device``.

    'ell'        — gather-based SplitSpMV, float64;
    'bandpoints' — heavy-diagonal slabs + scattered points
                   (kernels.bandpoints, the CUDA kernel on a GPU), float32
                   by design: the Newton mismatch floors near f32 precision.
    """
    if spmv == "ell":
        return matvec.SplitSpMV(Y, device=device)
    if spmv == "bandpoints":
        from ..kernels.bandpoints import SplitBandPoints

        return SplitBandPoints(Y, device=device)
    if spmv in ("dia", "symdia"):
        raise NotImplementedError(
            f"spmv={spmv!r} is not ported yet (ROADMAP: the DIA family and "
            "kernel K4, 'spmv dia/symdia' in the modules still to come)")
    raise ValueError(f"unknown spmv {spmv!r}; have 'ell', 'bandpoints'")


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


class NewtonPowerFlow:
    """Newton power flow with device refactorization, on ``device``.

    Construction is host work: Ybus, the SpMV plan, the fixed Jacobian
    structure, one host LU of the flat-start Jacobian (pattern and
    pivots), and the device refactorization plan.  ``run`` / ``solve``
    iterate on the device.
    """

    def __init__(self, grid: Grid, tol=1e-10, max_iter=20, ordering="auto",
                 spmv="ell", solver="level", device="cpu"):
        """spmv: 'ell' (float64 gathers) or 'bandpoints' (float32 slabs +
        points, the CUDA kernel on a GPU).  solver: 'level' (KLU-style
        RefactorPlan + level-scheduled solves)."""
        if solver in ("blocklu", "multifrontal"):
            raise NotImplementedError(
                f"solver={solver!r} is not ported yet (ROADMAP: the banded "
                "and multifrontal solvers in the modules still to come)")
        if solver != "level":
            raise ValueError(f"unknown solver {solver!r}; have 'level'")
        self.grid = grid
        self.tol = tol
        self.max_iter = max_iter
        self.device = torch.device(device)
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
        npvpq, npq = len(pvpq), len(pq)
        self._npvpq = npvpq

        # ---- fixed Jacobian structure from Ybus entry streams ------------
        ipY, ixY, dtY = self.Y.np_arrays()
        rows = ixY.astype(np.int64)
        cols = np.repeat(np.arange(n, dtype=np.int64), np.diff(ipY))
        self._y_rows, self._y_cols = i64(rows), i64(cols)
        self._ygr, self._ygi = f64(dtY.real), f64(dtY.imag)
        self._diag_mask = torch.as_tensor(rows == cols, device=self.device)

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
            keep = np.flatnonzero((rsel[rows] >= 0) & (csel[cols] >= 0))
            keeps.append(keep)
            jr_l.append(rsel[rows[keep]] + roff)
            jc_l.append(csel[cols[keep]] + coff)
        jr = np.concatenate(jr_l)
        jc = np.concatenate(jc_l)
        dim = npvpq + npq
        # canonical-order permutation: J.data[i] = stream[perm[i]]
        perm = np.argsort(jc.astype(np.int64) * dim + jr, kind="stable")
        self._keep = [i64(k) for k in keeps]
        self._perm = i64(perm)

        # host: factor the pattern once (values at flat start)
        v0 = grid.vm0.astype(np.complex128)
        ibus0 = self.Y.to_scipy().tocsr() @ v0
        J0 = _jacobian(self.Y, v0, ibus0, pvpq, pq)
        lu = splu(J0, ordering=ordering)
        self._rp = lu.refactor_plan(J0, device=self.device)

    # -- device Jacobian values (fixed pattern, split-complex real math) ----
    def _jac_data(self, vr, vi, vm, ir, ii):
        """Real/imag parts of dS/dVa and dS/dVm per Ybus entry, in real
        arithmetic, gathered into the Jacobian's canonical entry order:

          t = conj(y) conj(v_col);  dVa = -i v_row t (+ i v conj(I) on diag)
          dVm = v_row t / |v_col|   (+ conj(I) v/|v| on diag)
        """
        rows, cols = self._y_rows, self._y_cols
        gr, gi = self._ygr, self._ygi
        vrr, vri = vr[rows], vi[rows]
        vcr, vci = vr[cols], vi[cols]
        t_r = gr * vcr - gi * vci
        t_i = -(gr * vci + gi * vcr)
        # p + iq = v_row * t
        p = vrr * t_r - vri * t_i
        q = vrr * t_i + vri * t_r
        dva_r, dva_i = q, -p
        dvm_r, dvm_i = p / vm[cols], q / vm[cols]
        irr, iir = ir[rows], ii[rows]
        dm = self._diag_mask
        dva_r = torch.where(dm, dva_r + vrr * iir - vri * irr, dva_r)
        dva_i = torch.where(dm, dva_i + vrr * irr + vri * iir, dva_i)
        dvm_r = torch.where(dm, dvm_r + (vrr * irr + vri * iir) / vm[rows],
                            dvm_r)
        dvm_i = torch.where(dm, dvm_i + (vri * irr - vrr * iir) / vm[rows],
                            dvm_i)
        stream = torch.cat([
            dva_r[self._keep[0]],
            dvm_r[self._keep[1]],
            dva_i[self._keep[2]],
            dvm_i[self._keep[3]],
        ])
        return stream[self._perm]

    def _mismatch_f(self, vm, va, sbr, sbi):
        vr = vm * torch.cos(va)
        vi = vm * torch.sin(va)
        ir, ii = self._yplan(vr, vi)
        mis_r = vr * ir + vi * ii - sbr
        mis_i = vi * ir - vr * ii - sbi
        f = torch.cat([mis_r[self._pvpq], mis_i[self._pq]])
        return f, (vr, vi), (ir, ii)

    @torch.inference_mode()
    def run(self, vm0, va0, sbr=None, sbi=None):
        """Iterate from (vm0, va0) until the mismatch max-norm is <= tol or
        ``max_iter`` iterations ran; returns (vm, va, iterations, residual)
        with vm, va on the device.  One mismatch evaluation (one Ybus
        SpMV) per iteration plus the final one."""
        sbr = self._sbr if sbr is None else sbr
        sbi = self._sbi if sbi is None else sbi
        vm = vm0.to(self.device, torch.float64, copy=True)
        va = va0.to(self.device, torch.float64, copy=True)
        it = 0
        while True:
            f, (vr, vi), (ir, ii) = self._mismatch_f(vm, va, sbr, sbi)
            nrm = float(f.abs().max()) if f.numel() else 0.0
            if not (nrm > self.tol and it < self.max_iter):
                return vm, va, it, nrm
            jd = self._jac_data(vr, vi, vm, ir, ii)
            dx = self._rp.refactor(jd)(-f)
            va.index_add_(0, self._pvpq, dx[: self._npvpq])
            vm.index_add_(0, self._pq, dx[self._npvpq:])
            it += 1

    def solve(self, flat_start=True):
        """Solve from the grid's flat start; returns host numpy (vm, va),
        the iteration count and the final mismatch max-norm."""
        n = self.grid.n_bus
        vm0 = torch.as_tensor(self.grid.vm0.astype(np.float64))
        va0 = torch.zeros(n, dtype=torch.float64)
        vm, va, it, res = self.run(vm0, va0)
        return vm.cpu().numpy(), va.cpu().numpy(), int(it), float(res)


@torch.inference_mode()
def newton_raphson(grid: Grid, tol=1e-10, max_iter=20, ordering="auto",
                   device="cpu"):
    """Full Newton power flow with a host factorization per iteration (the
    reference implementation); returns (vm, va, iterations, residual)."""
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
