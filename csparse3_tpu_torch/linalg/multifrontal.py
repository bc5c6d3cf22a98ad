"""Multifrontal device LU: dense fronts, extend-add by index.

The JAX package's ``csparse3_tpu/linalg/multifrontal.py``.  Every value of
the factorization lives in dense per-front buffers, batched in groups of
fronts of one level and one size class:

  per level (top-down, so every child sits one level below its parent):
    extend-add   each child's update block W into its parent's front
    factor       the (w, w) pivot block
    solve        L21 = B U11^{-1},  U12 = L11^{-1} C
    update       W = F22 - L21 @ U12

Fronts within a level are split into SIZE BUCKETS (``_BUCKETS``): one wide
separator would otherwise pad a thousand narrow fronts to its width.

On the card the fronts of all groups are slices of ONE flat buffer, so
the arbitrary-index traffic is one ``index_add_`` of the nnz(A) input
values per factorization, one ``index_select`` + ``index_add_`` pair of
extend-add per level (every child's W, read in place from the child's
front, into its parent's), and one gather per factor at the end to emit
(Lx, Ux) in CSC order.  The Schur update runs in place on the front's
(off, off) block, which then IS the W its parent reads.  The JAX
package's one-hot extend-add einsums and ``rowgather`` (TPU workarounds
for slow arbitrary gathers) have no counterpart here.

``MultifrontalRefactor`` freezes the host pivot order (KLU-style, the
contract of ``RefactorPlan``): it needs a no-row-exchange host factor of
a structurally symmetric pattern.  ``MultifrontalLU`` factors from
scratch with partial pivoting inside each front's fully-summed block.

The host build is the JAX package's numpy, copied; ``nlevels``,
``ngroups``, ``group_static`` and ``groups_at`` equal the JAX plan's.
Plans factor in the floating dtype of the values given (see
``linalg/supernodal.py``), without TF32.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..config import resolve_device
from ..ops.matvec import _cast_grad, _wants_grad
from ..utils.profiling import span
from .lu_host import HostLU
from .refactor import attach_solve_templates, retarget_solve_plan
from .supernodal import (_front_adjoint, _fundamental_partition, _graded_ok,
                         _lu_nopiv_, _pattern_symmetric, _sub_product_,
                         _unpermute_rows, _values_dtype)

__all__ = ["MultifrontalRefactor", "MultifrontalLU"]

_BUCKETS = (16, 32, 64, 128, 256)     # rmax bucket boundaries


def _groupby(keys, nkeys):
    """order, bounds such that order[bounds[k]:bounds[k+1]] are the
    positions with key k (replaces per-key flatnonzero scans)."""
    order = np.argsort(keys, kind="stable")
    bounds = np.searchsorted(keys[order], np.arange(nkeys + 1))
    return order, bounds


def _ptr(parts):
    return np.concatenate([[0], np.cumsum([len(p) for p in parts])]).tolist()


def _cat(parts, dtype):
    return (np.concatenate(parts).astype(dtype, copy=False) if parts
            else np.zeros(0, dtype=dtype))


class MultifrontalRefactor(nn.Module):
    """values -> (Lx, Ux) (and a SolvePlan) on ``device`` (None:
    ``config.default_device()``, the CUDA card) via batched dense fronts.

    Built once from a no-row-exchange host factorization and the matrix it
    factored.  ``relax`` caps the amalgamated supernode width (1 keeps
    fundamental supernodes only).  ``solve_plumbing=False`` skips the
    level solve templates that only ``refactor`` needs.
    """

    def __init__(self, host: HostLU, a_csc, relax: int = 16,
                 solve_plumbing: bool = True, device=None):
        super().__init__()
        device = resolve_device(device)
        n = host.n
        Lp = np.asarray(host.Lp, dtype=np.int64)
        Li = np.asarray(host.Li, dtype=np.int64)
        Up = np.asarray(host.Up, dtype=np.int64)
        Ui = np.asarray(host.Ui, dtype=np.int64)
        if not _pattern_symmetric(n, Lp, Li, Up, Ui):
            raise ValueError(
                "multifrontal refactorization needs a structurally "
                "symmetric factor pattern (no-row-exchange factorization "
                "of a structurally symmetric matrix); use RefactorPlan")
        lnz, unz = len(Li), len(Ui)
        colsL = np.repeat(np.arange(n, dtype=np.int64), np.diff(Lp))
        colsU = np.repeat(np.arange(n, dtype=np.int64), np.diff(Up))

        # ---- fundamental supernode partition ---------------------------
        fstarts, parent, cnt = _fundamental_partition(n, Lp, Li)

        # ---- amalgamation restricted to etree parent-child chains ------
        # merge group [a, b) with the next fundamental snode ONLY when
        # parent(last col) is exactly the next column, so the merged front
        # keeps the multifrontal containment theorem (its off rows land
        # inside its parent's front)
        starts = [0]
        srows = []
        if relax and relax > 1 and len(fstarts) > 2:
            cur_a, cur_b = fstarts[0], fstarts[1]
            cur_R = Li[Lp[cur_a]:Lp[cur_a + 1]]
            cur_ent = int(Lp[cur_b] - Lp[cur_a])
            for k in range(1, len(fstarts) - 1):
                a2, b2 = fstarts[k], fstarts[k + 1]
                R2 = Li[Lp[a2]:Lp[a2 + 1]]
                w_new = int(b2 - cur_a)
                chain = parent[cur_b - 1] == a2
                if chain and w_new <= relax:
                    R_new = np.union1d(cur_R, R2)
                    ent_new = cur_ent + int(Lp[b2] - Lp[a2])
                    z = 1.0 - ent_new / max(len(R_new) * w_new, 1)
                    if _graded_ok(w_new, z):
                        cur_b, cur_R, cur_ent = b2, R_new, ent_new
                        continue
                starts.append(int(a2))
                srows.append(cur_R)
                cur_a, cur_b, cur_R = a2, b2, R2
                cur_ent = int(Lp[b2] - Lp[a2])
            srows.append(cur_R)

            # keep the merged partition only when it actually cuts the
            # sequential level depth (chain-heavy patterns); on
            # dissection-style orderings merging buys nothing and the
            # wider padded fronts just cost flops
            def _depth(st, sr):
                m_ = len(st)
                sn = np.empty(n, dtype=np.int64)
                for i in range(m_):
                    sn[st[i]:(st[i + 1] if i + 1 < m_ else n)] = i
                h = np.ones(m_, dtype=np.int64)
                for i in range(m_):
                    w_ = (st[i + 1] if i + 1 < m_ else n) - st[i]
                    if len(sr[i]) > w_:
                        p_ = sn[sr[i][w_]]
                        h[p_] = max(h[p_], h[i] + 1)
                return int(h.max()) if m_ else 0

            f_srows = [Li[Lp[s]:Lp[s + 1]] for s in fstarts[:-1]]
            if _depth(starts, srows) > 0.6 * _depth(fstarts[:-1],
                                                    f_srows):
                starts, srows = list(fstarts[:-1]), f_srows
        else:
            starts = fstarts[:-1]
            srows = [Li[Lp[s]:Lp[s + 1]] for s in starts]
        if starts[-1] != n:
            starts.append(n)
        ns = len(starts) - 1
        starts_np = np.asarray(starts, dtype=np.int64)
        widths = np.diff(starts_np)
        snode_of = np.repeat(np.arange(ns, dtype=np.int64), widths)

        # snode etree: parent = snode of the first off-block row
        parent_s = np.full(ns, ns, dtype=np.int64)   # ns = "no parent"
        for s in range(ns):
            if len(srows[s]) > widths[s]:
                parent_s[s] = snode_of[srows[s][widths[s]]]

        # ---- top-down leveling: child level == parent level - 1 --------
        height = np.ones(ns, dtype=np.int64)
        for s in range(ns):                       # children first (s < p)
            p = parent_s[s]
            if p < ns:
                height[p] = max(height[p], height[s] + 1)
        nlev = int(height.max()) if ns else 0
        lev = np.empty(ns, dtype=np.int64)
        for s in range(ns - 1, -1, -1):           # parents first
            p = parent_s[s]
            lev[s] = (height[s] - 1) if p >= ns else lev[p] - 1

        # ---- bucketed groups: (level, size class) -----------------------
        rsz = np.asarray([len(R) for R in srows], dtype=np.int64)
        u_sz = rsz - widths
        kind = np.zeros(ns, dtype=np.int64)
        for t in _BUCKETS:
            kind += rsz > t
        gkey = lev * (len(_BUCKETS) + 1) + kind
        order_g, gb = _groupby(gkey, nlev * (len(_BUCKETS) + 1))
        group_sids = []
        group_of = np.empty(ns, dtype=np.int64)
        slot_of = np.empty(ns, dtype=np.int64)
        group_level = []
        for gk in range(nlev * (len(_BUCKETS) + 1)):
            sids = order_g[gb[gk]:gb[gk + 1]]
            if not len(sids):
                continue
            gid = len(group_sids)
            group_sids.append(sids)
            group_of[sids] = gid
            slot_of[sids] = np.arange(len(sids))
            group_level.append(gk // (len(_BUCKETS) + 1))
        ngroups = len(group_sids)
        groups_at = [[] for _ in range(nlev)]
        for gid, L in enumerate(group_level):
            groups_at[L].append(gid)

        # ---- A-value assembly: the owner front of each entry -----------
        pinv = np.empty(n, dtype=np.int64)
        pinv[np.asarray(host.perm_r)] = np.arange(n)
        qinv = np.empty(n, dtype=np.int64)
        qinv[np.asarray(host.perm_c)] = np.arange(n)
        ip, rows_a, _ = a_csc.np_arrays()
        acols = np.repeat(np.arange(n), np.diff(np.asarray(ip)))
        pr = pinv[np.asarray(rows_a, dtype=np.int64)]
        pc = qinv[acols]
        owner = snode_of[np.minimum(pr, pc)]
        a_order, a_bounds = _groupby(owner, ns)
        u_owner = snode_of[Ui]                     # U(r, c): row's snode
        u_order, u_bounds = _groupby(u_owner, ns)
        c_order, c_bounds = _groupby(parent_s, ns + 1)  # children lists

        # ---- per-group structures, as positions in ONE flat buffer of all
        # fronts: group gid holds (nb, rmax, rmax) from fbase[gid]; front
        # axes 0..w-1 are the snode's columns, slots w_max..w_max+u-1 its
        # off-block rows (both axes).  One slot past the fronts holds 1:
        # L's stored unit diagonal is emitted from it.
        a_pos = np.empty(len(pr), dtype=np.int64)
        exL = np.empty(lnz, dtype=np.int64)
        exU = np.empty(unz, dtype=np.int64)
        group_static = []      # (nb, w_max, u_max, rmax)
        fbase = [0]
        colmasks, rows_p_parts, rows_o_parts, pad_diag = [], [], [], []
        ext_src = [[] for _ in range(nlev)]
        ext_dst = [[] for _ in range(nlev)]
        for gid, sids in enumerate(group_sids):
            L = group_level[gid]
            nb = len(sids)
            w_max = int(widths[sids].max())
            u_max = int(max(u_sz[sids].max(), 1))
            rmax = w_max + u_max
            fb = fbase[gid]
            colmask = np.zeros((nb, w_max), dtype=bool)
            # global row ids per front slot (elimination space; pad -> n):
            # the front-form solve of MultifrontalLU gathers/scatters the
            # right-hand side by these
            rows_piv = np.full((nb, w_max), n, dtype=np.int64)
            rows_off = np.full((nb, u_max), n, dtype=np.int64)
            for b, s in enumerate(sids):
                w = int(widths[s])
                R = srows[s]
                colmask[b, :w] = True
                rows_piv[b, :w] = starts_np[s] + np.arange(w)
                rows_off[b, : len(R) - w] = R[w:]
                front = fb + b * rmax * rmax
                # padded pivot columns get a unit diagonal
                pad = np.arange(w, w_max)
                pad_diag.append(front + pad * (rmax + 1))

                def _slot(i):
                    return np.where(i < w, i, w_max + (i - w))

                # A assembly destinations owned by this front
                sel = a_order[a_bounds[s]:a_bounds[s + 1]]
                if len(sel):
                    ri = _slot(np.searchsorted(R, pr[sel]))
                    ci = _slot(np.searchsorted(R, pc[sel]))
                    a_pos[sel] = front + ri * rmax + ci
                # L emission, whole snode at once: L(r, c) at (slot r, c)
                j1 = int(starts_np[s])
                posl = np.arange(Lp[j1], Lp[j1 + w])
                rs = _slot(np.searchsorted(R, Li[posl]))
                exL[posl] = front + rs * rmax + (colsL[posl] - j1)
                # U emission: U(r, c) at (r - j1, slot of c)
                selu = u_order[u_bounds[s]:u_bounds[s + 1]]
                if len(selu):
                    cs = _slot(np.searchsorted(R, colsU[selu]))
                    exU[selu] = front + (Ui[selu] - j1) * rmax + cs
                # extend-add: each child's (u_c, u_c) update block, read in
                # place from its own front, onto this front's slots of the
                # child's off-block rows
                for c in c_order[c_bounds[s]:c_bounds[s + 1]]:
                    offc = srows[c][int(widths[c]):]
                    loc = np.searchsorted(R, offc)
                    if not np.array_equal(
                            R[np.minimum(loc, len(R) - 1)], offc):
                        raise AssertionError(
                            "multifrontal containment violated: "
                            "child off row missing from parent")
                    dsl = _slot(loc)
                    cnb, cw, _, crm = group_static[group_of[c]]
                    csl = cw + np.arange(len(offc))
                    cfront = fbase[group_of[c]] + slot_of[c] * crm * crm
                    ext_src[L].append(
                        (cfront + csl[:, None] * crm + csl[None, :]).ravel())
                    ext_dst[L].append(
                        (front + dsl[:, None] * rmax + dsl[None, :]).ravel())
            group_static.append((nb, w_max, u_max, rmax))
            fbase.append(fb + nb * rmax * rmax)
            colmasks.append(colmask.ravel())
            rows_p_parts.append(rows_piv.ravel())
            rows_o_parts.append(rows_off.ravel())
        one = fbase[-1]
        exL[Li == colsL] = one

        self.n = n
        self.lnz, self.unz = lnz, unz
        self.dtype = torch.as_tensor(host.Lx[:0]).dtype
        self.nsnodes = ns
        self.nlevels = nlev
        self.ngroups = ngroups
        self.group_static = tuple(group_static)
        self.groups_at = tuple(tuple(g) for g in groups_at)
        #: floats of the padded fronts (the flat buffer, less its 1 slot)
        self.front_floats = int(one)
        self._fbase = tuple(fbase)
        self._mask_off = tuple(_ptr(colmasks))   # == rows_p offsets
        self._rows_o_off = tuple(_ptr(rows_o_parts))
        ext_lists = [np.concatenate(e) if e else np.zeros(0, np.int64)
                     for e in ext_src]
        self._ext_ptr = tuple(_ptr(ext_lists))
        # positions in the flat buffer fit int32 below 2^31 floats; the
        # index ops take int32 on the CPU and on CUDA
        idx = np.int32 if one < 2**31 else np.int64

        def buf(name, a, dtype=torch.int64):
            self.register_buffer(name, torch.as_tensor(
                a, dtype=dtype, device=device))

        buf("_a_pos", a_pos.astype(idx))
        buf("_pad_diag", _cat(pad_diag + [np.asarray([one])], idx))
        buf("_ext_src", _cat(ext_lists, idx))
        buf("_ext_dst", _cat([np.concatenate(e) if e
                              else np.zeros(0, np.int64)
                              for e in ext_dst], idx))
        buf("_exL", exL.astype(idx))
        buf("_exU", exU.astype(idx))
        buf("_masks", _cat(colmasks, np.bool_), torch.bool)
        buf("_rows_p", _cat(rows_p_parts, np.int64))
        buf("_rows_o", _cat(rows_o_parts, np.int64))
        buf("perm_r", np.asarray(host.perm_r, dtype=np.int64))
        buf("perm_c", np.asarray(host.perm_c, dtype=np.int64))
        # the level solve templates serve refactor() only; MultifrontalLU's
        # front-form solve_piv never touches them
        self._solve_plumbing = bool(solve_plumbing)
        if solve_plumbing:
            attach_solve_templates(self, host, device, a_csc)

    # ---- views of the flat buffers ---------------------------------------
    def _group_mask(self, gid):
        """colmask bool (nb, w_max): the front's genuine pivot columns."""
        nb, w_max, _, _ = self.group_static[gid]
        mo = self._mask_off[gid]
        return self._masks[mo:mo + nb * w_max].view(nb, w_max)

    def _rows_parts(self, gid):
        """(rows_piv (nb, w), rows_off (nb, u)) global row ids."""
        nb, w_max, u_max, _ = self.group_static[gid]
        po, oo = self._mask_off[gid], self._rows_o_off[gid]
        return (self._rows_p[po:po + nb * w_max].view(nb, w_max),
                self._rows_o[oo:oo + nb * u_max].view(nb, u_max))

    def _front(self, flat, gid):
        """Group ``gid``'s (nb, rmax, rmax) fronts, a view of ``flat``;
        (K, nb, rmax, rmax) for a (K, floats) buffer of K scenarios, a
        view strided over K (ops on it keep the leading axis apart)."""
        nb, _, _, rmax = self.group_static[gid]
        return flat[..., self._fbase[gid]:self._fbase[gid + 1]].view(
            flat.shape[:-1] + (nb, rmax, rmax))

    def _assembled(self, new_data):
        """The flat front buffer holding A's values, the padded pivot
        columns' unit diagonal and the 1 slot: (floats,), or (K, floats)
        for ``new_data`` (K, nnz), one row per scenario."""
        dtype = _values_dtype(new_data, self.dtype)
        flat = torch.zeros(new_data.shape[:-1] + (self.front_floats + 1,),
                           dtype=dtype, device=new_data.device)
        flat.index_fill_(-1, self._pad_diag, 1)
        flat.index_add_(-1, self._a_pos, new_data.to(dtype))
        return flat

    def _fronts(self, flat):
        """Yield (gid, fronts) level by level, after the extend-add of the
        level's children into the level's fronts."""
        for L in range(self.nlevels):
            a, c = self._ext_ptr[L], self._ext_ptr[L + 1]
            if c > a:
                flat.index_add_(-1, self._ext_dst[a:c],
                                flat.index_select(-1, self._ext_src[a:c]))
            for gid in self.groups_at[L]:
                yield gid, self._front(flat, gid)

    # ---- numeric factorization ---------------------------------------------
    def _factor_(self, flat, pivot: bool = False):
        """The front loop, in place on the flat buffer: per group (M, U12,
        L21, perm).  Without ``pivot`` the factors are views of ``flat``
        (M, L21 and U12 written over D, B and C; perm None); with it,
        partial pivoting inside each front's fully-summed block, D[perm] =
        L11 U11, and the factors are tensors of their own.  Either way the
        Schur update runs in place on the front's (off, off) block."""
        factors = [None] * self.ngroups
        for gid, F in self._fronts(flat):
            w = self.group_static[gid][1]
            D, B, C = F[..., :w, :w], F[..., w:, :w], F[..., :w, w:]
            if pivot:
                M, piv, _ = torch.linalg.lu_factor_ex(D, check_errors=False)
                perm = _pivot_perm(M, piv)
                Cp = C.gather(-2, perm[..., None].expand(
                    perm.shape + (C.shape[-1],)))
            else:
                M, perm, Cp = _lu_nopiv_(D), None, C
            L21 = torch.linalg.solve_triangular(M, B, upper=True, left=False)
            U12 = torch.linalg.solve_triangular(M, Cp, upper=False,
                                                unitriangular=True)
            if pivot:
                factors[gid] = (M, U12, L21, perm)
            else:
                B.copy_(L21)
                C.copy_(U12)
                factors[gid] = (M, C, B, None)
            _sub_product_(F[..., w:, w:], L21, U12)
        return factors

    def _factor_adjoint(self, G, factors):
        """dL/dvalues from G, the gradient of the flat buffer's final
        state (M, L21 and U12 in each front's D, B and C regions, S in its
        (off, off) block): the levels in reverse, each group's fronts by
        ``_front_adjoint``, then the extend-add's adjoint G[ext_src] +=
        G[ext_dst].  In place on G."""
        for L in range(self.nlevels - 1, -1, -1):
            for gid in self.groups_at[L]:
                w = self.group_static[gid][1]
                F = self._front(G, gid)
                M, U12, L21, perm = factors[gid]
                gD, gB, gC = _front_adjoint(
                    M, L21, U12, F[..., :w, :w], F[..., w:, :w],
                    F[..., :w, w:], F[..., w:, w:], perm)
                F[..., :w, :w] = gD
                F[..., w:, :w] = gB
                F[..., :w, w:] = gC
            a, c = self._ext_ptr[L], self._ext_ptr[L + 1]
            if c > a:
                G.index_add_(-1, self._ext_src[a:c],
                             G.index_select(-1, self._ext_dst[a:c]))
        return G.index_select(-1, self._a_pos)

    def factor_values(self, new_data):
        """(Lx, Ux) for the original pattern with ``new_data`` values;
        (K, lnz) and (K, unz) for ``new_data`` (K, nnz), the fronts of all
        K scenarios factored together, in place in one (K, floats)
        buffer.  Differentiable (``_FrontFactor``) in ``new_data`` when it
        requires a gradient; every other call runs under inference
        mode."""
        new_data = torch.as_tensor(new_data, device=self._a_pos.device)
        with self._factor_span(new_data):
            if _wants_grad(new_data):
                return _FrontFactor.apply(self, False, new_data)
            with torch.inference_mode():
                flat = self._assembled(new_data)
                self._factor_(flat)
                return flat[..., self._exL], flat[..., self._exU]

    def _factor_span(self, new_data):
        """The ``front.factor`` span of a factorization of ``new_data``."""
        return span("front.factor", groups=self.ngroups,
                    levels=self.nlevels, front_floats=self.front_floats,
                    K=new_data.shape[0] if new_data.ndim > 1 else 1)

    def refactor(self, new_data, with_diag: bool = False):
        """SolvePlan with fresh numeric factors (same contract as
        RefactorPlan.refactor, gradients included; the slab retargeting is
        shared)."""
        if not self._solve_plumbing:
            raise ValueError(
                "this plan was built with solve_plumbing=False (the "
                "MultifrontalLU front-form path); rebuild with "
                "solve_plumbing=True to use refactor()")
        Lx, Ux = self.factor_values(new_data)
        return retarget_solve_plan(self, Lx, Ux, with_diag, values=new_data)


def _pivot_perm(LU, pivots):
    """The row permutation ``perm`` with D[perm] = L U from LAPACK's
    1-based sequential swaps, in a fixed number of ops: ``lu_unpack``
    gives P with D = P L U, so perm[i] is the row of P's 1 in column i."""
    P, _, _ = torch.lu_unpack(LU, pivots, unpack_data=False)
    return P.argmax(dim=-2)


class MultifrontalLU(MultifrontalRefactor):
    """FROM-SCRATCH device LU with restricted partial pivoting.

    The host contributes only SYMBOLIC structure (fill pattern and front
    partition from a generic-valued factorization of the pattern), and
    ``factor_piv(new_data)`` runs the whole numeric factorization on the
    device with PARTIAL PIVOTING inside each front's fully-summed block
    (``torch.linalg.lu_factor_ex`` per group).  Row exchanges restricted
    to fully-summed variables keep the fill inside the (dense) front, so
    the symbolic structure stays valid.

    Factors stay in FRONT form, (M = L11\\U11 packed, U12, L21, perm) per
    group, and ``solve_piv`` runs the level schedule forward and backward
    on them.  ``stats`` reports min |U11 pivot| and max |U| for the
    growth-based fallback to a host pivoted factorization.
    """

    @classmethod
    def from_matrix(cls, a, ordering="nd", relax=16, seed=0, device=None):
        """Symbolic-only host work: factor the PATTERN with generic
        diagonally-dominant values (exact cancellation has probability
        zero, so the generic factor's pattern IS the symbolic fill), then
        build the front schedule against the real matrix."""
        from ..types import CSC
        from .lu import splu

        ip, ix, _ = a.np_arrays()
        ip = np.asarray(ip)
        ix = np.asarray(ix)
        n = a.n
        cols = np.repeat(np.arange(n, dtype=np.int64), np.diff(ip))
        diag_pos = ix == cols
        if int(diag_pos.sum()) < n:
            raise ValueError(
                "from_matrix needs a full structural diagonal (the "
                "no-pivot symbolic pattern is ill-defined without it)")
        rng = np.random.RandomState(seed)
        gen = 0.01 + 0.1 * rng.rand(len(ix))
        deg = np.diff(ip)
        gen[diag_pos] = deg[cols[diag_pos]] + 1.0   # dominant diagonal
        Ag = CSC(a.m, a.n, ip, ix, gen, canonical=a.canonical)
        with span("setup.symbolic", n=n) as sp:
            lu = splu(Ag, ordering=ordering, tol=0.0)
            if lu.is_singular or not (
                    np.isfinite(np.asarray(lu._h.Lx)).all()
                    and np.isfinite(np.asarray(lu._h.Ux)).all()):
                raise ValueError("generic-value symbolic factorization "
                                 "failed (pattern problem)")
            plan = cls(lu._h, a, relax=relax, solve_plumbing=False,
                       device=device)
            sp.note(front_floats=plan.front_floats)
        return plan

    def factor_piv(self, new_data):
        """new_data -> (factors, stats).

        factors: per-group (M, U12, L21, perm) (front form).
        stats: {"min_pivot", "max_u"} (0-d tensors), the growth gate's.
        ``new_data`` (K, nnz) factors K scenarios together: every factor
        gains a leading K axis and the stats are (K,), one gate per
        scenario.  Differentiable (``_FrontFactor``) in ``new_data`` when
        it requires a gradient: the factors carry it, and the stats are
        taken from the differentiable M (min / max spread their gradient
        evenly over ties).  Every other call runs under inference mode."""
        new_data = torch.as_tensor(new_data, device=self._a_pos.device)
        with self._factor_span(new_data):
            if _wants_grad(new_data):
                out = _FrontFactor.apply(self, True, new_data)
                factors = tuple(tuple(out[4 * g:4 * g + 4])
                                for g in range(self.ngroups))
                return factors, self._piv_stats(factors, new_data.ndim - 1)
            with torch.inference_mode():
                factors = self._factor_(self._assembled(new_data),
                                        pivot=True)
                return tuple(factors), self._piv_stats(factors,
                                                       new_data.ndim - 1)

    def _piv_stats(self, factors, lead):
        """min |U11 pivot| over genuine columns and max |U11|, per
        scenario."""
        mins, maxs = [], []
        for gid, (M, _, _, _) in enumerate(factors):
            du = M.diagonal(dim1=-2, dim2=-1).abs()
            mins.append(du.masked_fill(~self._group_mask(gid), float("inf"))
                        .amin(dim=tuple(range(lead, du.ndim))))
            maxs.append(M.triu().abs().amax(dim=tuple(range(lead, M.ndim))))
        return {"min_pivot": torch.stack(mins).amin(0),
                "max_u": torch.stack(maxs).amax(0)}

    def solve_piv(self, factors, b):
        """x = A^{-1} b from ``factor_piv`` factors; b (n,) or (n, B), and
        (K, n) for factors of K scenarios, row k against scenario k.
        The result is in ORIGINAL row/column space (the symbolic fill-
        reducing perms are applied here; the per-front pivoting perms
        live in the factors).  Differentiable (``_FrontSolve``) in b and in
        the factors (M, U12, L21) when any of them requires a gradient;
        every other call runs under inference mode."""
        b = torch.as_tensor(b, device=self.perm_r.device)
        tensors = [t for f in factors for t in f[:3]]
        with span("front.solve", groups=self.ngroups, levels=self.nlevels):
            if _wants_grad(b, *tensors):
                return _FrontSolve.apply(
                    self, tuple(f[3] for f in factors), b, *tensors)
            with torch.inference_mode():
                return self._solve_piv(factors, b)[0]

    def _rows_of(self, y, r):
        """Rows of y (..., n + 1, nB) by a group's (nb, k) row ids, as
        (..., nb, k, nB)."""
        return y.index_select(-2, r.view(-1)).view(
            y.shape[:-2] + r.shape + y.shape[-1:])

    def _solve_piv(self, factors, b, keep: bool = False):
        """(x, z, y): x = A^{-1} b, and with ``keep`` the (..., n + 1, nB)
        permuted-space vectors after the forward sweep (z) and after the
        backward one (y)."""
        batched = any(f[0].ndim == 4 for f in factors)
        squeeze = b.ndim == 1 or batched
        if squeeze:
            b = b[..., None]
        lead = b.shape[:-2]           # (K,) for a batch, else ()
        fdt = next((f[0].dtype for f in factors), self.dtype)
        dtype = torch.promote_types(b.dtype, fdt)
        nB = b.shape[-1]
        # permuted right-hand side + one pad slot (row n)
        y = torch.zeros(lead + (self.n + 1, nB), dtype=dtype,
                        device=b.device)
        y[..., :-1, :] = b[..., self.perm_r, :]
        # rows of y by a group's (nb, k) row ids; writes to the pad row
        # collide and are never read back
        def rows(r):
            return self._rows_of(y, r)

        def put(r, v):
            return v.reshape(lead + (r.numel(), nB))

        for L in range(self.nlevels):
            for gid in self.groups_at[L]:
                rows_p, rows_o = self._rows_parts(gid)
                M, U12, L21, perm = factors[gid]
                b1 = rows(rows_p).gather(-2, perm[..., None].expand(
                    perm.shape + (nB,)))
                z1 = torch.linalg.solve_triangular(M, b1, upper=False,
                                                   unitriangular=True)
                y.index_copy_(-2, rows_p.view(-1), put(rows_p, z1))
                y.index_add_(-2, rows_o.view(-1), put(rows_o, L21 @ z1),
                             alpha=-1)
        z = y.clone() if keep else None
        for L in range(self.nlevels - 1, -1, -1):
            for gid in self.groups_at[L]:
                rows_p, rows_o = self._rows_parts(gid)
                M, U12, L21, perm = factors[gid]
                rhs = _sub_product_(rows(rows_p), U12, rows(rows_o))
                x1 = torch.linalg.solve_triangular(M, rhs, upper=True)
                y.index_copy_(-2, rows_p.view(-1), put(rows_p, x1))
        x = torch.empty(lead + (self.n, nB), dtype=dtype, device=b.device)
        x[..., self.perm_c, :] = y[..., :-1, :]
        return (x[..., 0] if squeeze else x), z, y


class _FrontFactor(torch.autograd.Function):
    """The front loop of ``plan`` (``MultifrontalRefactor._factor_``),
    differentiable in the values.  Without ``pivot`` its outputs are (Lx,
    Ux), gathered from the flat buffer, and it keeps the factors, views of
    that buffer; with ``pivot`` they are every group's (M, U12, L21, perm),
    which it keeps.  The backward places the outputs' gradients in a flat
    buffer G (at ``_exL`` / ``_exU``, or in each front's regions) and
    walks the levels in reverse (``_factor_adjoint``)."""

    @staticmethod
    def forward(ctx, plan, pivot, new_data):
        ctx.set_materialize_grads(False)
        ctx.plan, ctx.pivot, ctx.d_dtype = plan, pivot, new_data.dtype
        flat = plan._assembled(new_data)
        factors = plan._factor_(flat, pivot)
        ctx.flat = (flat.shape, flat.dtype)
        if not pivot:
            ctx.factors = factors  # views of an intermediate: held as such
            return flat[..., plan._exL], flat[..., plan._exU]
        out = tuple(t for f in factors for t in f)
        ctx.mark_non_differentiable(*out[3::4])
        ctx.save_for_backward(*out)
        return out

    @staticmethod
    def backward(ctx, *grads):
        plan = ctx.plan
        shape, dtype = ctx.flat
        G = torch.zeros(shape, dtype=dtype, device=plan._a_pos.device)
        if not ctx.pivot:
            factors = ctx.factors
            for ex, g in zip((plan._exL, plan._exU), grads):
                if g is not None:
                    G.index_add_(-1, ex, g)
        else:
            saved = ctx.saved_tensors
            factors = [saved[4 * g:4 * g + 4] for g in range(plan.ngroups)]
            for gid in range(plan.ngroups):
                w = plan.group_static[gid][1]
                F = plan._front(G, gid)
                for region, g in zip((F[..., :w, :w], F[..., :w, w:],
                                      F[..., w:, :w]),
                                     grads[4 * gid:4 * gid + 3]):
                    if g is not None:
                        region.copy_(g)
        return None, None, _cast_grad(plan._factor_adjoint(G, factors),
                                      ctx.d_dtype)


class _FrontSolve(torch.autograd.Function):
    """x = A^{-1} b through ``factor_piv`` factors (``_solve_piv``),
    differentiable in b and in every group's (M, U12, L21).  The forward
    keeps z (y after the forward sweep) and y (after the backward sweep).
    The backward is the transposed solve, in the permuted space: one
    ascending level pass (the backward sweep's adjoint) with t1 = U11^{-H}
    y_p, y_o -= U12^H t1, y_p = t1, then one descending pass (the forward
    sweep's) with s1 = L11^{-H} (y_p - L21^H y_o), y_p = s1 scattered back
    by perm.  The factors' gradients are outer products with the saved
    vectors, summed over b's columns: gU11 = -triu(t1 x1^H), gU12 = -t1
    x_off^H, gL11 = -tril_{-1}(s1 z1^H), gL21 = -y_o z1^H."""

    @staticmethod
    def forward(ctx, plan, perms, b, *tensors):
        factors = [tensors[3 * g:3 * g + 3] + (perms[g],)
                   for g in range(len(perms))]
        x, z, y = plan._solve_piv(factors, b, keep=True)
        ctx.plan, ctx.perms, ctx.b_dtype = plan, perms, b.dtype
        # factors made under inference mode (a solve differentiable in b
        # alone) cannot be saved: they are held by reference
        ctx.held = [t if t.is_inference() else None for t in tensors]
        ctx.save_for_backward(z, y, *(None if t.is_inference() else t
                                      for t in tensors))
        return x

    @staticmethod
    def backward(ctx, g):
        plan, perms = ctx.plan, ctx.perms
        z, y, *saved = ctx.saved_tensors
        tensors = [s if h is None else h for s, h in zip(saved, ctx.held)]
        factors = [tuple(tensors[3 * k:3 * k + 3]) + (perms[k],)
                   for k in range(len(perms))]
        squeeze = g.ndim == y.ndim - 1
        if squeeze:
            g = g[..., None]
        lead, nB = y.shape[:-2], y.shape[-1]
        gy = torch.zeros_like(y, dtype=torch.promote_types(g.dtype, y.dtype))
        gy[..., :-1, :] = g[..., plan.perm_c, :]
        grads = [[None, None, None] for _ in perms]
        fac = any(ctx.needs_input_grad[3:])

        def put(r, v):
            return v.reshape(lead + (r.numel(), nB))

        for L in range(plan.nlevels):
            for gid in plan.groups_at[L]:
                rows_p, rows_o = plan._rows_parts(gid)
                M, U12, L21, perm = factors[gid]
                t1 = torch.linalg.solve_triangular(
                    M.mH, plan._rows_of(gy, rows_p), upper=False)
                gy.index_add_(-2, rows_o.view(-1),
                              put(rows_o, U12.mH @ t1), alpha=-1)
                gy.index_copy_(-2, rows_p.view(-1), put(rows_p, t1))
                if fac:
                    grads[gid][0] = -(t1 @ plan._rows_of(y, rows_p).mH
                                      ).triu()
                    grads[gid][1] = -(t1 @ plan._rows_of(y, rows_o).mH)
        for L in range(plan.nlevels - 1, -1, -1):
            for gid in plan.groups_at[L]:
                rows_p, rows_o = plan._rows_parts(gid)
                M, U12, L21, perm = factors[gid]
                yo = plan._rows_of(gy, rows_o)
                s1 = torch.linalg.solve_triangular(
                    M.mH, plan._rows_of(gy, rows_p) - L21.mH @ yo,
                    upper=True, unitriangular=True)
                if fac:
                    z1 = plan._rows_of(z, rows_p)
                    grads[gid][0] -= (s1 @ z1.mH).tril(-1)
                    grads[gid][2] = -(yo @ z1.mH)
                gy.index_copy_(-2, rows_p.view(-1),
                               put(rows_p, _unpermute_rows(s1, perm)))
        gb = None
        if ctx.needs_input_grad[2]:
            gb = torch.empty(lead + (plan.n, nB), dtype=gy.dtype,
                             device=gy.device)
            gb[..., plan.perm_r, :] = gy[..., :-1, :]
            gb = _cast_grad(gb[..., 0] if squeeze else gb, ctx.b_dtype)
        return (None, None, gb) + tuple(
            None if gr is None else _cast_grad(gr, t.dtype)
            for gr, t in zip((gr for f in grads for gr in f), tensors))
