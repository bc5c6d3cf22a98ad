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

from ..config import resolve_device
from ..native import host_ext
from ..ops.matvec import _cast_grad, _wants_grad
from ..utils.profiling import span
from .lu import SolvePlan
from .lu_host import HostLU
from .trisolve import TriSolvePlan

__all__ = ["RefactorPlan", "attach_solve_templates", "retarget_solve_plan"]


def _level_ptr(lev, nlev):
    return np.concatenate(
        [[0], np.cumsum(np.bincount(lev, minlength=nlev))]).tolist()


class _LevelFactor(torch.autograd.Function):
    """X = [Lx | Ux] of ``plan``'s level loop, differentiable in the values.

    The forward is the loop itself; it keeps the final X.  That is all the
    backward needs: every multiplicand of a level's updates is final when
    the level reads it (L(i, j) is divided in the level of column j, and
    U(j, k) is updated only from columns of earlier levels).  With G =
    dL/dX, the backward walks the levels in reverse:

      updates    X[dst] -= X[L] X[U]:  G[L] -= G[dst] conj(X[U]),
                                       G[U] -= G[dst] conj(X[L])
      divisions  X[dd] /= X[piv]:      G[piv] -= G[dd] conj(X[dd] / X[piv]),
                                       G[dd] /= conj(X[piv])

    (``index_add_``, as cells repeat), then dL/dvalues = G[a_dst].  The
    unit cells are constants.  No tape: one buffer of X's size, G."""

    @staticmethod
    def forward(ctx, plan, new_data):
        X = plan._factor_(plan._assembled(new_data))
        ctx.plan, ctx.d_dtype = plan, new_data.dtype
        ctx.save_for_backward(X)
        return X

    @staticmethod
    def backward(ctx, gX):
        plan = ctx.plan
        X, = ctx.saved_tensors
        Xc = X.conj()
        G = gX.clone(memory_format=torch.contiguous_format)
        dp, up = plan.div_ptr, plan.upd_ptr
        for lv in range(len(dp) - 2, -1, -1):
            a, c = up[lv], up[lv + 1]
            if c > a:
                ul, uu = plan.upd_L[a:c], plan.upd_U[a:c]
                gd = G.index_select(-1, plan.upd_dst[a:c])
                G.index_add_(-1, ul, gd * Xc.index_select(-1, uu), alpha=-1)
                G.index_add_(-1, uu, gd * Xc.index_select(-1, ul), alpha=-1)
            a, c = dp[lv], dp[lv + 1]
            if c > a:
                dd, piv = plan.div_dst[a:c], plan.div_piv[a:c]
                gd = G.index_select(-1, dd) / Xc.index_select(-1, piv)
                G.index_add_(-1, piv, gd * Xc.index_select(-1, dd), alpha=-1)
                G[..., dd] = gd
        return None, _cast_grad(G.index_select(-1, plan.a_dst), ctx.d_dtype)


class RefactorPlan(nn.Module):
    """Built from a host factorization and the matrix it factored, placed
    on ``device`` (None: ``config.default_device()``, the CUDA card).

    ``refactor(new_data)`` -> SolvePlan with fresh numeric factors, where
    ``new_data`` is the data array of a CSC with the SAME canonical
    pattern as the original matrix.
    """

    def __init__(self, host: HostLU, a_csc, device=None):
        super().__init__()
        device = resolve_device(device)
        n = host.n
        Lp, Li = host.Lp.astype(np.int64), host.Li.astype(np.int64)
        Up, Ui = host.Up.astype(np.int64), host.Ui.astype(np.int64)
        lnz, unz = len(Li), len(Ui)

        # global sorted keys for position lookup (cols ascend, rows ascend
        # within a column -> key stream is globally sorted)
        key = n + 1
        colsL = np.repeat(np.arange(n), np.diff(Lp))
        keysL = colsL * key + Li
        diag = np.arange(n)
        l_unit = np.searchsorted(keysL, diag * key + diag)

        ip, rows, _ = a_csc.np_arrays()
        built = host_ext.refactor_build(
            n, Lp, Li, Up, Ui, ip, rows, host.perm_r, host.perm_c)
        nlev = built["nlev"]
        self.div_ptr = _level_ptr(built["div_lev"], nlev)
        self.upd_ptr = _level_ptr(built["upd_lev"], nlev)

        self.n = n
        self.lnz, self.unz = lnz, unz
        self.dtype = torch.as_tensor(host.Lx[:0]).dtype

        attach_solve_templates(self, host, device, a_csc)

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

    @property
    def nlevels(self):
        return len(self.div_ptr) - 1

    def _assembled(self, new_data):
        """X = [Lx | Ux] before the level loop: A's values at their cells,
        L's unit diagonal, zeros elsewhere; (K, lnz + unz) for values
        (K, nnz)."""
        dtype = torch.promote_types(new_data.dtype, self.dtype)
        X = torch.zeros(new_data.shape[:-1] + (self.lnz + self.unz,),
                        dtype=dtype, device=new_data.device)
        X[..., self.l_unit] = 1
        X.index_add_(-1, self.a_dst, new_data.to(dtype))
        return X

    def _factor_(self, X):
        """The level loop, in place on X; every level op runs along the
        last axis."""
        dp, up = self.div_ptr, self.upd_ptr
        for lv in range(len(dp) - 1):
            a, c = dp[lv], dp[lv + 1]
            if c > a:
                dd = self.div_dst[a:c]
                X[..., dd] = (X.index_select(-1, dd)
                              / X.index_select(-1, self.div_piv[a:c]))
            a, c = up[lv], up[lv + 1]
            if c > a:
                X.index_add_(-1, self.upd_dst[a:c],
                             X.index_select(-1, self.upd_L[a:c])
                             * X.index_select(-1, self.upd_U[a:c]),
                             alpha=-1)
        return X

    def factor_values(self, new_data):
        """(Lx, Ux) for a matrix with the original pattern and ``new_data``
        values (canonical CSC entry order).  ``new_data`` (K, nnz), one
        matrix per scenario, gives (K, lnz) and (K, unz).

        Differentiable (``_LevelFactor``) in ``new_data`` when it requires
        a gradient; every other call runs under inference mode."""
        new_data = torch.as_tensor(new_data, device=self.a_dst.device)
        if _wants_grad(new_data):
            X = _LevelFactor.apply(self, new_data)
            return X[..., : self.lnz], X[..., self.lnz:]
        with torch.inference_mode():
            X = self._factor_(self._assembled(new_data))
            return X[..., : self.lnz], X[..., self.lnz:]

    def refactor(self, new_data, with_diag: bool = False):
        """SolvePlan with fresh numeric factors.

        with_diag=True also returns the U diagonal — min|u|/max|u| is the
        KLU-style cheap rcond estimate callers use to flag (near-)singular
        refactorizations (frozen pivots turn structural singularity into a
        zero-or-noise pivot, NOT necessarily inf/nan output).

        ``new_data`` (K, nnz) gives a ``batched`` SolvePlan over K factors
        (and the diagonal as (K, n)).  A ``new_data`` tensor that requires
        a gradient makes the plan's solves differentiable in it."""
        Lx, Ux = self.factor_values(new_data)
        return retarget_solve_plan(self, Lx, Ux, with_diag, values=new_data)


def attach_solve_templates(obj: nn.Module, host: HostLU, device, a_csc):
    """Give ``obj`` what ``retarget_solve_plan`` reads: level solve-plan
    templates of the host factors (their index layout is fixed by the
    pattern; a refactorization hands them values gathered from X =
    [Lx | Ux]) and the X positions of the templates' level-ordered
    off-diagonal entries and of U's diagonal.  The host factors and
    ``a_csc`` are kept for a backward pass: the transposed templates
    (``transposed_templates``) and A's entry streams are made from them at
    its first call."""
    obj._host_factors = host
    obj._a_csc = a_csc
    n = host.n
    colsL = np.repeat(np.arange(n), np.diff(host.Lp))
    colsU = np.repeat(np.arange(n), np.diff(host.Up))
    Li, Ui = host.Li.astype(np.int64), host.Ui.astype(np.int64)
    lnz, key, diag = len(Li), n + 1, np.arange(n)
    obj._ltpl = TriSolvePlan(n, host.Lp, host.Li, host.Lx, lower=True,
                             device=device)
    obj._utpl = TriSolvePlan(n, host.Up, host.Ui, host.Ux, lower=False,
                             device=device)
    for name, pos in (
            ("_l_epos", np.flatnonzero(Li != colsL)[obj._ltpl.e_order]),
            ("_u_epos", (np.flatnonzero(Ui != colsU) + lnz)[
                obj._utpl.e_order]),
            ("_u_diagpos", lnz + np.searchsorted(colsU * key + Ui,
                                                 diag * key + diag))):
        obj.register_buffer(name, torch.as_tensor(pos, device=device))


def _positions_transposed(n, Fp, Fi):
    """CSC arrays of F^T whose values are the positions (0-based, float64:
    exact below 2**53) of the entries of F, in F^T's canonical order."""
    import scipy.sparse as sp

    pos = np.arange(1, len(Fi) + 1, dtype=np.float64)
    t = sp.csc_matrix((pos, Fi, Fp), shape=(n, n)).T.tocsc()
    return t.indptr, t.indices, t.data - 1


def transposed_templates(obj):
    """Level solve-plan templates of U^T (lower) and L^T (upper) over the
    pattern ``attach_solve_templates`` kept, and the X = [Lx | Ux]
    positions of their level-ordered off-diagonal entries: made at the
    first call (a backward pass) and kept, so that every later
    refactorization's adjoint is a gather, as its forward plan is."""
    if "_tr_templates" not in obj.__dict__:
        h = obj._host_factors
        n, lnz = h.n, len(h.Li)
        device = obj.perm_r.device
        out = []
        for Fp, Fi, shift, lower in ((h.Up, h.Ui, lnz, True),
                                     (h.Lp, h.Li, 0, False)):
            Tp, Ti, pos = _positions_transposed(n, Fp, Fi)
            tpl = TriSolvePlan(n, Tp, Ti, pos, lower=lower, device=device)
            cols = np.repeat(np.arange(n), np.diff(Tp))
            epos = (pos[Ti != cols].astype(np.int64) + shift)[tpl.e_order]
            out += [tpl, torch.as_tensor(epos, device=device)]
        obj._tr_templates = tuple(out)
    return obj._tr_templates


def _adjoint_from(obj, X, u_diag):
    """The SolvePlan of A^T for the factors X = [Lx | Ux] (a leading
    scenario axis gives a batched plan)."""
    ut, ut_pos, lt, lt_pos = transposed_templates(obj)
    return SolvePlan(ut.with_values(X[..., ut_pos], 1.0 / u_diag),
                     lt.with_values(X[..., lt_pos]), obj.perm_c, obj.perm_r)


def retarget_solve_plan(obj, Lx, Ux, with_diag: bool = False, values=None):
    """Shared refactor() plumbing for device refactorization classes that
    keep the RefactorPlan template layout (``_ltpl`` / ``_utpl`` solve
    plans and the ``_l_epos`` / ``_u_epos`` / ``_u_diagpos`` positions in
    X = [Lx | Ux]): gather the fresh values into the stored solve plans and
    return a SolvePlan (plus the U diagonal when ``with_diag``); factors
    with a leading scenario axis give a batched SolvePlan.  The
    templates are level plans whatever ``SparseLU.solve_plan`` would pick:
    a dense tail's block inverses cannot be refreshed by a gather (the JAX
    package retargets the level layout only, too).  The JAX
    package gathers through its one-hot ``rowgather`` workaround here;
    these are plain indexing.

    With grad mode on at the call, the plan can be differentiated: it keeps
    X for its adjoint (``SolvePlan.adjoint``, built from
    ``transposed_templates`` at the first backward), and then

    * ``values``, when it is a tensor that requires a gradient, is the
      input its solves are differentiable in (``_Solve``: refactor's
      route, no sweep through the factorization);
    * else ``Lx`` / ``Ux``, when either requires a gradient, are
      (``_FactorSolve``), and the U diagonal is a recorded gather.

    Under inference mode (the solvers' loops) it keeps none of these."""
    with span("front.retarget"):
        return _retarget(obj, Lx, Ux, with_diag, values)


def _retarget(obj, Lx, Ux, with_diag, values):
    grad = torch.is_grad_enabled()
    with torch.inference_mode():
        X = torch.cat([Lx, Ux], dim=-1)
        u_diag = X[..., obj._u_diagpos]
        lplan = obj._ltpl.with_values(X[..., obj._l_epos])
        uplan = obj._utpl.with_values(X[..., obj._u_epos], 1.0 / u_diag)
    plan = SolvePlan(lplan, uplan, obj.perm_r, obj.perm_c, adjoint=(
        (lambda: _adjoint_from(obj, X, u_diag)) if grad else None))
    if grad and isinstance(values, torch.Tensor) and values.requires_grad:
        plan.values = values
        plan._pattern_fn = lambda: obj._a_csc.to(
            obj.perm_r.device).entry_streams()
    elif _wants_grad(Lx, Ux):
        plan.factors, plan._templates = (Lx, Ux), obj
    if with_diag and _wants_grad(Lx, Ux):
        u_diag = Ux[..., obj._u_diagpos - obj.lnz]
    return (plan, u_diag) if with_diag else plan
