"""AC power flow: the mismatch that judges a state, and Newton and
fast-decoupled (XB) solvers with ``scipy.sparse.linalg`` in a chosen
precision.

``precision``:
* ``float64``: the reference itself;
* ``float32``: every array and solve in float32 (complex64);
* ``bf16_product``: float64 but the Ybus product of the mismatch in
  bfloat16 values and vector, summed in float32;
* ``float32_solve``: float64 state and mismatch, the Jacobian (Newton) or
  B' and B'' (fast-decoupled), their factors and solves in float32.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla

from .network import b_series, index_sets, slack_bus, ybus


def mismatch(Y, vm, va, sb, pvpq, pq, per_vm=False) -> np.ndarray:
    """Max-norm of the power mismatch of each state row, (K,) for (K, n)
    rows: P at PV and PQ buses, Q at PQ buses; divided by Vm with
    ``per_vm`` (the fast-decoupled scheme's measure).  Float64."""
    vm, va, sb = (np.atleast_2d(np.asarray(z)) for z in (vm, va, sb))
    v = vm * np.exp(1j * va)
    mis = v * np.conj((Y @ v.T).T) - sb
    if per_vm:
        mis = mis / vm
    r = np.concatenate([np.abs(mis.real[:, pvpq]), np.abs(mis.imag[:, pq])],
                       axis=1)
    return r.max(axis=1) if r.shape[1] else np.zeros(len(r))


def to_bf16(x: np.ndarray) -> np.ndarray:
    """float32 ``x`` rounded to bfloat16 (nearest, ties to even), held in
    float32."""
    u = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


class _Product:
    """I = Y v in the precision asked for."""

    def __init__(self, Y, precision):
        self.precision = precision
        if precision == "float32":
            self.Y = Y.astype(np.complex64)
        elif precision == "bf16_product":
            Yc = Y.tocsr()
            self.Yr = sp.csr_matrix((to_bf16(Yc.data.real), Yc.indices,
                                     Yc.indptr), shape=Y.shape)
            self.Yi = sp.csr_matrix((to_bf16(Yc.data.imag), Yc.indices,
                                     Yc.indptr), shape=Y.shape)
        else:
            self.Y = Y

    def __call__(self, v):
        if self.precision == "bf16_product":
            vr = to_bf16(v.real.astype(np.float32))
            vi = to_bf16(v.imag.astype(np.float32))
            ir = self.Yr @ vr - self.Yi @ vi
            ii = self.Yr @ vi + self.Yi @ vr
            return (ir + 1j * ii).astype(np.complex128)
        return self.Y @ v.astype(self.Y.dtype)


def _dtypes(precision):
    """(state float, state complex, solve float) of ``precision``."""
    if precision == "float32":
        return np.float32, np.complex64, np.float32
    if precision == "float32_solve":
        return np.float64, np.complex128, np.float32
    return np.float64, np.complex128, np.float64


def newton(Y, sb, a, tol, max_iter, precision="float64"):
    """Newton-Raphson from the flat start for injections ``sb`` (n,);
    ``splu`` of the full Jacobian each iteration.  Returns (vm, va,
    iterations) as float64 host arrays; iterations = max_iter when the
    mismatch (in this precision) never fell to ``tol``."""
    fdt, cdt, sdt = _dtypes(precision)
    pvpq, pq, _ = index_sets(a)
    npvpq = len(pvpq)
    prod = _Product(Y, precision)
    Yd = Y.astype(cdt)
    vm = np.asarray(a["vm0"], dtype=fdt).copy()
    va = np.zeros(a["n_bus"], dtype=fdt)
    sb = sb.astype(cdt)
    for it in range(max_iter + 1):
        v = (vm * np.exp(1j * va)).astype(cdt)
        ibus = prod(v).astype(cdt)
        mis = v * np.conj(ibus) - sb
        f = np.concatenate([mis.real[pvpq], mis.imag[pq]])
        if np.abs(f).max() <= tol or it == max_iter:
            return vm.astype(np.float64), va.astype(np.float64), it
        dv = sp.diags(v)
        dva = 1j * dv @ np.conj(sp.diags(ibus) - Yd @ dv)
        dvm = dv @ np.conj(Yd @ sp.diags(v / np.abs(v))) + np.conj(
            sp.diags(ibus)) @ sp.diags(v / np.abs(v))
        J = sp.bmat([[dva[pvpq][:, pvpq].real, dvm[pvpq][:, pq].real],
                     [dva[pq][:, pvpq].imag, dvm[pq][:, pq].imag]],
                    format="csc").astype(sdt)
        dx = spla.splu(J).solve(-f.astype(sdt))
        va[pvpq] += dx[:npvpq]
        vm[pq] += dx[npvpq:]


def fdpf(Y, sb, a, tol, max_iter, precision="float64"):
    """Fast-decoupled (XB) power flow from the flat start for ``sb`` (n,):
    B' (series susceptances, slack removed) and B'' (-imag Ybus on PQ
    buses) factored once, the mismatch divided by Vm.  Returns (vm, va,
    iterations) as float64 host arrays; iterations = max_iter when the
    residual (in this precision) never fell to ``tol``."""
    fdt, cdt, sdt = _dtypes(precision)
    pvpq, pq, _ = index_sets(a)
    prod = _Product(Y, precision)
    Bp = b_series(a)[pvpq][:, pvpq].tocsc().astype(sdt)
    Bpp = (-Y.imag)[pq][:, pq].tocsc().astype(sdt)
    lp, lpp = spla.splu(Bp), spla.splu(Bpp)
    vm = np.asarray(a["vm0"], dtype=fdt).copy()
    va = np.zeros(a["n_bus"], dtype=fdt)
    sb = sb.astype(cdt)

    def dS(vm, va):
        v = (vm * np.exp(1j * va)).astype(cdt)
        return (v * np.conj(prod(v).astype(cdt)) - sb) / vm

    for it in range(max_iter + 1):
        m = dS(vm, va)
        r = max(np.abs(m.real[pvpq]).max(initial=0.0),
                np.abs(m.imag[pq]).max(initial=0.0))
        if r <= tol or it == max_iter:
            return vm.astype(np.float64), va.astype(np.float64), it
        va[pvpq] -= lp.solve(m.real[pvpq].astype(sdt))
        m = dS(vm, va)
        vm[pq] -= lpp.solve(m.imag[pq].astype(sdt))


def ts_numbers(a: dict, kept: dict, tally: dict, per_vm: bool) -> dict:
    """The numbers of a power-flow study.  ``kept``: sb, vm, va (rows, in
    the grid's bus order); ``tally``: failed (one flag per snapshot of the
    window).  ``mismatch``, the largest power mismatch of the kept rows,
    in float64 on the reference's own Ybus (divided by Vm with
    ``per_vm``); ``setpoints``, the largest departure of a PV or slack
    magnitude from its setpoint or of the slack angle from 0; ``failed``,
    the snapshots the program reports not converged."""
    pvpq, pq, fixed = index_sets(a)
    res = mismatch(ybus(a), kept["vm"], kept["va"], kept["sb"], pvpq, pq,
                   per_vm=per_vm)
    vm0 = np.asarray(a["vm0"])
    dev = np.maximum(np.abs(kept["vm"][:, fixed] - vm0[fixed]).max(axis=1),
                     np.abs(kept["va"][:, slack_bus(a)]))
    return dict(mismatch=float(res.max()), setpoints=float(dev.max()),
                failed=int(np.count_nonzero(tally["failed"])))
