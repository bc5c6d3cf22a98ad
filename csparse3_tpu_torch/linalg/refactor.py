"""Device numeric LU refactorization (KLU-style).

After one host factorization (pattern and pivot order fixed), repeated
factorizations of matrices with the SAME sparsity pattern but new values
(the Newton power-flow inner loop) run on the device.

Formulation (the JAX package's, ``csparse3_tpu/linalg/refactor.py``): the
left-looking factorization is a level-scheduled wavefront over columns.
Column k depends on column j when U(j,k) != 0 or L(k,j) != 0; the native
symbolic build (``native/host_ext.cpp`` ``refactor_build``) groups columns
into levels of that DAG and lists, per level,

  divisions:  L-cells of the level's columns  /=  their pivot cell
  updates:    X[dst] -= X[L-cell] * X[U-cell]  for every elementary update
              whose source column sits in the level

over one value array X = [L values | U values] in CSC entry order.

The JAX plan pads the levels into slab groups for ``lax.scan``, with dummy
cells absorbing the padding.  PyTorch runs the level loop eagerly, so the
lists stay flat and level-sorted and each level is a slice: no padding, no
dummy cells.  Several updates of one level may hit one cell, so updates
are summed with ``index_add_`` (indexed ``+=`` would keep only one).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..native import host_ext
from .lu import SolvePlan
from .lu_host import HostLU
from .trisolve import TriSolvePlan

__all__ = ["RefactorPlan", "retarget_solve_plan"]


def _level_ptr(lev, nlev):
    return np.concatenate(
        [[0], np.cumsum(np.bincount(lev, minlength=nlev))]).tolist()


class RefactorPlan(nn.Module):
    """Built from a host factorization and the matrix it factored, placed
    on ``device``.

    ``refactor(new_data)`` -> SolvePlan with fresh numeric factors, where
    ``new_data`` is the data array of a CSC with the SAME canonical
    pattern as the original matrix.
    """

    def __init__(self, host: HostLU, a_csc, device=None):
        super().__init__()
        n = host.n
        Lp, Li = host.Lp.astype(np.int64), host.Li.astype(np.int64)
        Up, Ui = host.Up.astype(np.int64), host.Ui.astype(np.int64)
        lnz, unz = len(Li), len(Ui)

        # global sorted keys for position lookup (cols ascend, rows ascend
        # within a column -> key stream is globally sorted)
        key = n + 1
        colsL = np.repeat(np.arange(n), np.diff(Lp))
        colsU = np.repeat(np.arange(n), np.diff(Up))
        keysL = colsL * key + Li
        keysU = colsU * key + Ui
        diag = np.arange(n)
        l_unit = np.searchsorted(keysL, diag * key + diag)
        u_diagpos = lnz + np.searchsorted(keysU, diag * key + diag)
        l_off_pos = np.flatnonzero(Li != colsL)
        u_off_pos = np.flatnonzero(Ui != colsU) + lnz

        ip, rows, _ = a_csc.np_arrays()
        built = host_ext.refactor_build(
            n, Lp, Li, Up, Ui, ip, rows, host.perm_r, host.perm_c)
        nlev = built["nlev"]
        self.div_ptr = _level_ptr(built["div_lev"], nlev)
        self.upd_ptr = _level_ptr(built["upd_lev"], nlev)

        self.n = n
        self.lnz, self.unz = lnz, unz
        self.dtype = torch.as_tensor(host.Lx[:0]).dtype

        # solve-plan templates: their index layout is fixed by the pattern;
        # refactor() hands them values gathered from X
        self._ltpl = TriSolvePlan(n, host.Lp, host.Li, host.Lx, lower=True,
                                  device=device)
        self._utpl = TriSolvePlan(n, host.Up, host.Ui, host.Ux, lower=False,
                                  device=device)

        # X positions fit int32 (as in the JAX plan's slabs), which halves
        # the index bytes of the level loop, the bulk of its traffic (the
        # update lists hold one triple per multiply-add of the LU).  The
        # loop reads them only through index_select / index_add_ /
        # index_put_, which take int32 indices on the CPU and on CUDA.
        idx = np.int32 if lnz + unz < 2**31 else np.int64

        def buf(name, a, dtype=np.int64):
            self.register_buffer(name, torch.as_tensor(
                np.asarray(a, dtype=dtype), device=device))

        buf("a_dst", built["a_dst"])
        buf("l_unit", l_unit)
        for name in ("div_dst", "div_piv", "upd_dst", "upd_L", "upd_U"):
            buf(name, built[name], idx)
        buf("perm_r", host.perm_r)
        buf("perm_c", host.perm_c)
        # X positions of the templates' level-ordered off-diagonal entries
        buf("_l_epos", l_off_pos[self._ltpl.e_order])
        buf("_u_epos", u_off_pos[self._utpl.e_order])
        buf("_u_diagpos", u_diagpos)

    @property
    def nlevels(self):
        return len(self.div_ptr) - 1

    @torch.inference_mode()
    def factor_values(self, new_data):
        """(Lx, Ux) for a matrix with the original pattern and ``new_data``
        values (canonical CSC entry order)."""
        new_data = torch.as_tensor(new_data, device=self.a_dst.device)
        dtype = torch.promote_types(new_data.dtype, self.dtype)
        X = torch.zeros(self.lnz + self.unz, dtype=dtype,
                        device=new_data.device)
        X[self.l_unit] = 1
        X.index_add_(0, self.a_dst, new_data.to(dtype))
        dp, up = self.div_ptr, self.upd_ptr
        for lv in range(len(dp) - 1):
            a, c = dp[lv], dp[lv + 1]
            if c > a:
                dd = self.div_dst[a:c]
                X.index_put_((dd,), X.index_select(0, dd)
                             / X.index_select(0, self.div_piv[a:c]))
            a, c = up[lv], up[lv + 1]
            if c > a:
                X.index_add_(0, self.upd_dst[a:c],
                             X.index_select(0, self.upd_L[a:c])
                             * X.index_select(0, self.upd_U[a:c]),
                             alpha=-1)
        return X[: self.lnz], X[self.lnz:]

    @torch.inference_mode()
    def refactor(self, new_data, with_diag: bool = False):
        """SolvePlan with fresh numeric factors.

        with_diag=True also returns the U diagonal — min|u|/max|u| is the
        KLU-style cheap rcond estimate callers use to flag (near-)singular
        refactorizations (frozen pivots turn structural singularity into a
        zero-or-noise pivot, NOT necessarily inf/nan output)."""
        Lx, Ux = self.factor_values(new_data)
        return retarget_solve_plan(self, Lx, Ux, with_diag)


def retarget_solve_plan(obj, Lx, Ux, with_diag: bool = False):
    """Shared refactor() plumbing for device refactorization classes that
    keep the RefactorPlan template layout (``_ltpl`` / ``_utpl`` solve
    plans and the ``_l_epos`` / ``_u_epos`` / ``_u_diagpos`` positions in
    X = [Lx | Ux]): gather the fresh values into the stored solve plans and
    return a SolvePlan (plus the U diagonal when ``with_diag``).  The JAX
    package gathers through its one-hot ``rowgather`` workaround here;
    these are plain indexing."""
    X = torch.cat([Lx, Ux])
    u_diag = X[obj._u_diagpos]
    lplan = obj._ltpl.with_values(X[obj._l_epos])
    uplan = obj._utpl.with_values(X[obj._u_epos], 1.0 / u_diag)
    plan = SolvePlan(lplan, uplan, obj.perm_r, obj.perm_c)
    return (plan, u_diag) if with_diag else plan
