"""The deployments' grids, made from their configuration files.

A configuration fixes its grid the way a case file does: the topology, line
parameters and operating point do not vary with ``--seed`` (which makes the
traffic).  The arrays are handed to the port as its ``Grid`` and to the
reference as they are.

The generator, ``geo_tree_chords``, follows the structure that Birchfield
et al. (IEEE Trans. Power Systems 32(4), 2017) publish for synthetic
transmission grids: buses placed in a plane; each voltage level a
spanning tree of its shortest lines (the Euclidean minimum spanning tree
of the Delaunay triangulation of its buses) plus its shortest remaining
Delaunay lines, the lowest level taking as many as make the case's own
branch count, which leaves degree-1 (radial) buses and bridges as real
grids have; the higher levels, over fewer buses with lower per-unit
reactance, carry power across the plane.  Generator buses number the
case's generators; each generator covers the load of the buses nearest it
along the lowest level's lines and the DC estimate of the losses of the
branches leaving them, so power flows locally and the slack bus carries
only the estimate's error.
"""

from __future__ import annotations

import zlib

import numpy as np
import scipy.sparse as sp
from scipy.sparse.csgraph import dijkstra, minimum_spanning_tree
from scipy.sparse.linalg import spsolve
from scipy.spatial import Delaunay

# bus types
PQ, PV, SLACK = 0, 1, 2

#: the arrays of a grid, in the order of the port's ``Grid`` after n_bus
FIELDS = ("f", "t", "r", "x", "b", "tap", "bus_type", "pd", "qd", "pg",
          "vm0", "gs", "bs")


def _tree_chords(rng, pts, n_chords: int):
    """(k, 2) lines over the points ``pts``: the Euclidean minimum spanning
    tree of their Delaunay triangulation plus the ``n_chords`` shortest of
    the remaining Delaunay edges (each length times a lognormal draw)."""
    n = len(pts)
    simp = Delaunay(pts).simplices
    e = np.concatenate([simp[:, [0, 1]], simp[:, [1, 2]], simp[:, [0, 2]]])
    e = np.unique(np.sort(e, axis=1), axis=0)
    length = np.linalg.norm(pts[e[:, 0]] - pts[e[:, 1]], axis=1)
    tree = minimum_spanning_tree(sp.csr_matrix(
        (length, (e[:, 0], e[:, 1])), shape=(n, n))).tocoo()
    in_tree = np.isin(e[:, 0] * n + e[:, 1],
                      np.minimum(tree.row, tree.col) * n
                      + np.maximum(tree.row, tree.col))
    rest = np.flatnonzero(~in_tree)
    score = length[rest] * rng.lognormal(0.0, 0.5, len(rest))
    chords = rest[np.argsort(score, kind="stable")[:n_chords]]
    return e[np.concatenate([np.flatnonzero(in_tree), chords])]


def _topology(rng, n: int, n_branch: int, strips: int, levels: list):
    """(points, f, t, level): buses numbered strip by strip across the plane, as a
    case numbers by area.  Level 0, the network over all buses; each
    further level, a higher voltage, over ``buses`` of the level below it
    drawn from the seed, a tree plus ``chords`` of its size in chords.
    Level 0 takes tree and chords enough to make ``n_branch`` in all."""
    pts = rng.random((n, 2))
    band = np.minimum((pts[:, 1] * strips).astype(np.int64), strips - 1)
    along = np.where(band % 2 == 0, pts[:, 0], -pts[:, 0])
    pts = pts[np.lexsort((along, band))]
    br, lev = [], []
    at = np.arange(n)
    for k, spec in enumerate(levels, start=1):
        at = np.sort(rng.choice(at, spec["buses"], replace=False))
        top = at[_tree_chords(rng, pts[at], int(spec["chords"] * len(at)))]
        br.append(top)
        lev.append(np.full(len(top), k))
    low = _tree_chords(rng, pts, n_branch - sum(map(len, br)) - (n - 1))
    br = np.concatenate([low] + br)
    lev = np.concatenate([np.zeros(len(low), np.int64)] + lev)
    p = rng.permutation(len(br))
    return pts, br[p, 0], br[p, 1], lev[p]


def _dc_losses(n, f, t, r, x, p, slack) -> np.ndarray:
    """(m,) r f^2 of each branch, f the DC flows of injections p."""
    keep = np.flatnonzero(np.arange(n) != slack)
    bs = 1.0 / x
    B = sp.csc_matrix((np.concatenate([bs, bs, -bs, -bs]),
                       (np.concatenate([f, t, f, t]),
                        np.concatenate([f, t, t, f]))), shape=(n, n))
    th = np.zeros(n)
    th[keep] = spsolve(B[keep][:, keep].tocsc(), p[keep])
    return r * ((th[f] - th[t]) / x) ** 2


def geo_tree_chords(n: int, seed: int, n_branch: int, n_gen: int,
                    strips: int, x: list, b: list, levels: list) -> dict:
    """The grid of ``n`` buses and ``n_branch`` branches.  Reactance
    uniform in ``x`` (p.u.) on the lowest level and in each level's own
    ``x`` above it, x/r 3-10, charging uniform in ``b``; off-nominal taps
    0.95-1.05 on 10% of the lowest level's branches.  Loads at every bus
    without generation, 0-0.08 p.u. active at a reactive ratio 0.1-0.3.
    ``n_gen`` generator buses drawn from the seed, setpoints 1.00-1.04, the
    slack the one with most top-level lines."""
    rng = np.random.default_rng(seed)
    pts, f, t, level = _topology(rng, n, n_branch, strips, levels)
    m = len(f)
    lo, hi = np.array([x] + [spec["x"] for spec in levels]).T
    x = rng.uniform(lo[level], hi[level])
    r = x / rng.uniform(3.0, 10.0, m)
    b = rng.uniform(*b, m)
    tap = np.ones(m)
    trafo = (rng.random(m) < 0.1) & (level == 0)
    tap[trafo] = rng.uniform(0.95, 1.05, trafo.sum())

    bus_type = np.full(n, PQ, dtype=np.int64)
    gen = np.sort(rng.choice(n, n_gen, replace=False))
    deg = np.bincount(np.concatenate([f, t])[np.concatenate(
        [level, level]) == level.max()], minlength=n)
    slack = gen[np.argmax(deg[gen])]
    bus_type[gen] = PV
    bus_type[slack] = SLACK
    pd = rng.uniform(0.0, 0.08, n)
    pd[gen] = 0.0
    qd = pd * rng.uniform(0.1, 0.3, n)
    # each load, and each branch's DC loss estimate, served by the
    # generator nearest it along the lowest level's lines (in reactance)
    low = level == 0
    X = sp.csr_matrix((x[low], (f[low], t[low])), shape=(n, n))
    nearest = dijkstra(X, directed=False, indices=gen, min_only=True,
                       return_predecessors=True)[2]
    pg = np.zeros(n)
    np.add.at(pg, nearest, pd)
    np.add.at(pg, nearest[f], _dc_losses(n, f, t, r, x, pg - pd, slack))
    vm0 = np.ones(n)
    vm0[gen] = rng.uniform(1.0, 1.04, n_gen)
    return dict(n_bus=n, f=f, t=t, r=r, x=x, b=b, tap=tap,
                bus_type=bus_type, pd=pd, qd=qd, pg=pg, vm0=vm0,
                gs=np.zeros(n), bs=np.zeros(n))


GENERATORS = {"geo_tree_chords": geo_tree_chords}


def topology_crc32(f, t) -> int:
    """CRC-32 of the grid's branch list, each branch (low bus, high bus),
    sorted: it catches a library that triangulates the plane otherwise."""
    e = np.sort(np.stack([f, t], axis=1), axis=1).astype(np.int64)
    return zlib.crc32(e[np.lexsort(e.T[::-1])].tobytes())


def make_grid(config: dict) -> dict:
    """The grid arrays of a configuration (``n_bus`` and ``FIELDS``),
    checked against the counts and the topology's CRC-32 the file
    expects."""
    gen = dict(config["generator"])
    kind = gen.pop("kind")
    if kind not in GENERATORS:
        raise ValueError(f"unknown grid generator {kind!r}")
    arrays = GENERATORS[kind](config["n_bus"], **gen)
    have = dict(n_branch=len(arrays["f"]),
                n_pv=int((arrays["bus_type"] == PV).sum()),
                n_pq=int((arrays["bus_type"] == PQ).sum()),
                topology_crc32=topology_crc32(arrays["f"], arrays["t"]))
    for key, want in config.get("expect", {}).items():
        if have[key] != want:
            raise ValueError(f"{config['name']}: {key} is {have[key]}, "
                             f"the configuration expects {want}")
    return arrays
