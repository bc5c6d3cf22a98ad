"""DC N-1 outages: a direct solve of each post-outage network, islands by
``scipy.sparse.csgraph``, and the grid's bridges (the branches whose
outage islands it) by a plain depth-first search."""

from __future__ import annotations

import warnings

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla
from scipy.sparse.csgraph import connected_components

from .network import SLACK, b_series


def islands(a: dict, k: int) -> bool:
    """True when the outage of branch ``k`` cuts a bus off the slack."""
    n = a["n_bus"]
    live = np.ones(len(a["f"]), dtype=bool)
    live[k] = False
    adj = sp.coo_matrix((np.ones(live.sum()),
                         (np.asarray(a["f"])[live],
                          np.asarray(a["t"])[live])), shape=(n, n))
    _, lab = connected_components(adj, directed=False)
    slack = np.flatnonzero(np.asarray(a["bus_type"]) == SLACK)[0]
    return bool((lab != lab[slack]).any())


def dc_flows(a: dict, k: int, dtype=np.float64) -> np.ndarray:
    """Branch flows (m,) after the outage of branch ``k`` (0 on it):
    theta = B_k^{-1} P with the slack removed, solved by SuperLU
    (``splu``, minimum degree on B + B^T, diagonal pivots preferred) in
    ``dtype``, flows (theta_f - theta_t) / x."""
    n = a["n_bus"]
    keep = np.flatnonzero(np.asarray(a["bus_type"]) != SLACK)
    B = b_series(a, drop=k)[keep][:, keep].tocsc().astype(dtype)
    P = (np.asarray(a["pg"]) - np.asarray(a["pd"]))[keep].astype(dtype)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        th_r = spla.splu(B, permc_spec="MMD_AT_PLUS_A",
                         options=dict(SymmetricMode=True)).solve(P)
    th = np.zeros(n)
    th[keep] = th_r
    x = np.asarray(a["x"]).astype(dtype)
    fl = ((th[a["f"]] - th[a["t"]]).astype(dtype) / x).astype(np.float64)
    fl[k] = 0.0
    return fl


def bridges(a: dict) -> np.ndarray:
    """(m,) bool: the branches that are bridges of the grid's multigraph
    (parallel branches are not), found by an iterative depth-first
    search with low-links."""
    n = a["n_bus"]
    f, t = np.asarray(a["f"]), np.asarray(a["t"])
    m = len(f)
    adj = [[] for _ in range(n)]
    for e in range(m):
        adj[f[e]].append((t[e], e))
        adj[t[e]].append((f[e], e))
    disc = [-1] * n
    low = [0] * n
    out = np.zeros(m, dtype=bool)
    timer = 0
    for root in range(n):
        if disc[root] >= 0:
            continue
        disc[root] = low[root] = timer
        timer += 1
        stack = [(root, -1, iter(adj[root]))]
        while stack:
            u, via, it = stack[-1]
            for w, e in it:
                if e == via:
                    continue
                if disc[w] < 0:
                    disc[w] = low[w] = timer
                    timer += 1
                    stack.append((w, e, iter(adj[w])))
                    break
                low[u] = min(low[u], disc[w])
            else:
                stack.pop()
                if stack:
                    p = stack[-1][0]
                    low[p] = min(low[p], low[u])
                    if low[u] > disc[p]:
                        out[via] = True
    return out


def n1_numbers(a: dict, kept: dict, tally: dict, sample: np.ndarray) -> dict:
    """The numbers of an N-1 DC screening.  ``kept``: outage, flows (rows);
    ``tally``: outage, ok, finite (one entry per outage of the window);
    ``sample``: the rows of ``kept`` to solve again.  ``flow_rel_err``,
    over the sample's outages that do not island the grid, the largest
    flow error against ``dc_flows`` over the largest reference flow;
    ``island_flags``, the outages of the window whose soundness flag
    disagrees with the bridges; ``failed``, the outages of the window that
    do not island the grid and whose flows are not finite."""
    bridge = bridges(a)
    isl = bridge[tally["outage"]]
    worst = 0.0
    for i in sample:
        k = int(kept["outage"][i])
        if islands(a, k) != bridge[k]:
            raise RuntimeError(f"reference: islands and bridges disagree "
                               f"on branch {k}")
        if bridge[k]:
            continue
        ref = dc_flows(a, k)
        err = np.abs(kept["flows"][i] - ref).max() / np.abs(ref).max()
        worst = max(worst, float(err) if np.isfinite(err) else np.inf)
    return dict(flow_rel_err=worst,
                island_flags=int(np.count_nonzero(tally["ok"] == isl)),
                failed=int(np.count_nonzero(~isl & ~tally["finite"])))
