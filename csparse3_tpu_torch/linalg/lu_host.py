"""Host sparse LU factorization: left-looking with partial pivoting.

This is the capability CSparse3 intends but never implemented — its only
trace is the SuperLU breadcrumb in the research dir
(reference: src/research/scipy_wrappers.py:1-11, SURVEY scope note).  The
algorithm is the classic left-looking ("GP") sparse LU from the CSparse
lineage (cs_lu / cs_spsolve / cs_reach semantics), written fresh:

  for each column k of A·Q:
    1. reach: DFS from the column's row pattern through the graph of the
       already-computed L columns -> topological order of dependencies
    2. numeric sparse triangular solve x = L^{-1} A[:, q[k]]
    3. partial pivoting: pick the largest |x_r| among not-yet-pivoted rows
       (with a diagonal-preference threshold ``tol``, KLU-style)
    4. split x into U[:, k] (pivoted rows) and L[:, k] (unpivoted, scaled)

Factorization is inherently sequential in k and lives on the host; the
result feeds the *device* solve path (level-scheduled, linalg/trisolve.py)
and the device refactorization path.  ``splu`` always runs the C++ twin of
this routine (``native/host_ext.cpp``, bound by ``native/host_ext.py``);
this numpy version, verbatim from the JAX package, is the reference the
tests hold it to.

Singular pivots are reported rather than raised, mirroring SuperLU's
``info != 0 -> fill NaN`` pattern that GridCal relies on
(reference: scipy_wrappers.py:7-10).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

__all__ = ["HostLU", "lu_factor_host"]


class HostLU(NamedTuple):
    n: int
    # L: unit lower triangular (unit diagonal stored), pivot-space rows
    Lp: np.ndarray
    Li: np.ndarray
    Lx: np.ndarray
    # U: upper triangular, pivot-space rows
    Up: np.ndarray
    Ui: np.ndarray
    Ux: np.ndarray
    perm_r: np.ndarray  # perm_r[k] = original row chosen as k-th pivot
    perm_c: np.ndarray  # perm_c[k] = original column eliminated k-th
    singular_cols: np.ndarray  # columns with zero pivot (empty if nonsingular)


def lu_factor_host(n, Ap, Ai, Ax, q=None, tol: float = 1.0) -> HostLU:
    """Factor P A Q = L U.

    Parameters: CSC arrays of a square A; ``q`` a column ordering
    (fill-reducing, from linalg.ordering); ``tol`` the diagonal-preference
    threshold: the diagonal entry is accepted as pivot when
    |x_diag| >= tol * max|x| (tol=1.0 -> strict partial pivoting).
    """
    Ap = np.asarray(Ap)
    Ai = np.asarray(Ai)
    Ax = np.asarray(Ax)
    if q is None:
        q = np.arange(n, dtype=np.int64)
    q = np.asarray(q, dtype=np.int64)

    dtype = Ax.dtype
    # L columns under construction: original-row ids + values (diag excluded)
    Lrows = [None] * n
    Lvals = [None] * n
    Urows_piv = []  # per column: pivot-space row ids
    Uvals = []
    pinv = np.full(n, -1, dtype=np.int64)  # original row -> pivot index
    perm_r = np.full(n, -1, dtype=np.int64)
    singular = []

    x = np.zeros(n, dtype=dtype)  # dense workspace by original row id
    flag = np.full(n, -1, dtype=np.int64)  # DFS visit marker (= current k)
    in_pattern = np.full(n, -1, dtype=np.int64)  # row-in-pattern marker
    stack = np.empty(n, dtype=np.int64)  # DFS node stack
    estack = np.empty(n, dtype=np.int64)  # DFS edge-position stack
    topo = np.empty(n, dtype=np.int64)  # reverse finish order buffer

    out_L = ([], [], [])  # col, orig row, val
    out_U = ([], [], [])  # col, pivot row, val

    for k in range(n):
        col = q[k]
        a_lo, a_hi = Ap[col], Ap[col + 1]
        arows = Ai[a_lo:a_hi]
        avals = Ax[a_lo:a_hi]

        # ---- symbolic: reach via DFS over pivot-node graph ---------------
        top = n  # topo fills from the right (reverse finish order)
        pat_rows = []  # all rows appearing in x's pattern
        for r in arows:
            r = int(r)
            if in_pattern[r] != k:
                in_pattern[r] = k
                pat_rows.append(r)
            j = pinv[r]
            if j >= 0 and flag[j] != k:
                # iterative DFS from node j
                sp = 0
                stack[0] = j
                estack[0] = 0
                flag[j] = k
                while sp >= 0:
                    node = stack[sp]
                    rows_n = Lrows[node]
                    e = estack[sp]
                    advanced = False
                    while e < len(rows_n):
                        rr = int(rows_n[e])
                        e += 1
                        if in_pattern[rr] != k:
                            in_pattern[rr] = k
                            pat_rows.append(rr)
                        jj = pinv[rr]
                        if jj >= 0 and flag[jj] != k:
                            flag[jj] = k
                            estack[sp] = e
                            sp += 1
                            stack[sp] = jj
                            estack[sp] = 0
                            advanced = True
                            break
                    if not advanced:
                        # node finished
                        top -= 1
                        topo[top] = node
                        sp -= 1

        # ---- numeric: x = L^{-1} a ---------------------------------------
        x[arows] = 0  # (pattern rows are zeroed at end of iteration; avals scatter below)
        np.add.at(x, arows, avals)
        for t in range(top, n):
            j = topo[t]
            pr = perm_r[j]
            xj = x[pr]
            if xj != 0:
                rows_j = Lrows[j]
                x[rows_j] -= Lvals[j] * xj

        # ---- pivot -------------------------------------------------------
        best_r, best_a = -1, 0.0
        diag_r = int(col)
        for r in pat_rows:
            if pinv[r] < 0:
                a_ = abs(x[r])
                if a_ > best_a:
                    best_a, best_r = a_, r
        if best_r < 0 or best_a == 0.0:
            # structurally or numerically singular column
            singular.append(k)
            # choose any unpivoted row for structural progress
            if best_r < 0:
                free = np.flatnonzero(pinv < 0)
                best_r = int(free[0])
            pivot_val = dtype.type(0)
        else:
            if (
                pinv[diag_r] < 0
                and in_pattern[diag_r] == k
                and abs(x[diag_r]) >= tol * best_a
            ):
                best_r = diag_r  # threshold diagonal preference
            pivot_val = x[best_r]

        pinv[best_r] = k
        perm_r[k] = best_r

        # ---- split x into U column and L column --------------------------
        u_r, u_v = [], []
        l_r, l_v = [], []
        for r in pat_rows:
            pr = pinv[r]
            if r == best_r:
                continue
            if pr >= 0 and pr < k:
                u_r.append(pr)
                u_v.append(x[r])
            elif pr < 0:
                xv = x[r]
                if xv != 0:
                    l_v.append(xv / pivot_val if pivot_val != 0 else xv * np.inf)
                    l_r.append(r)
            x[r] = 0
        x[best_r] = 0
        u_r.append(k)
        u_v.append(pivot_val)

        Lrows[k] = np.asarray(l_r, dtype=np.int64)
        Lvals[k] = np.asarray(l_v, dtype=dtype)
        out_U[0].append(np.full(len(u_r), k, dtype=np.int64))
        out_U[1].append(np.asarray(u_r, dtype=np.int64))
        out_U[2].append(np.asarray(u_v, dtype=dtype))

    # ---- export to canonical CSC arrays ----------------------------------
    # L: rows mapped to pivot space, explicit unit diagonal
    l_cols, l_rows, l_vals = [], [], []
    for k in range(n):
        rows_k = pinv[Lrows[k]]
        l_cols.append(np.full(len(rows_k) + 1, k, dtype=np.int64))
        l_rows.append(np.concatenate([[k], rows_k]))
        l_vals.append(np.concatenate([[dtype.type(1)], Lvals[k]]))
    Lc = np.concatenate(l_cols)
    Lr = np.concatenate(l_rows)
    Lv = np.concatenate(l_vals)
    Uc = np.concatenate(out_U[0])
    Ur = np.concatenate(out_U[1])
    Uv = np.concatenate(out_U[2])

    def to_csc(c, r, v):
        order = np.argsort(c.astype(np.int64) * n + r, kind="stable")
        c, r, v = c[order], r[order], v[order]
        indptr = np.zeros(n + 1, dtype=np.int64)
        np.add.at(indptr, c + 1, 1)
        return np.cumsum(indptr), r, v

    Lp, Li, Lx = to_csc(Lc, Lr, Lv)
    Up, Ui, Ux = to_csc(Uc, Ur, Uv)
    return HostLU(
        n, Lp, Li, Lx, Up, Ui, Ux, perm_r, q,
        np.asarray(singular, dtype=np.int64),
    )
