"""Persistence of sparse matrices and factorizations, as the JAX package's
``csparse3_tpu/utils/io.py``; the files are the interchange format, so the
two packages and scipy read each other's:

* ``save_npz`` / ``load_npz``: scipy's .npz layout for CSC / CSR / COO
  (``scipy.sparse.load_npz`` reads these files, and ``load_npz`` reads
  scipy's);
* ``save_lu`` / ``load_lu``: a ``SparseLU``'s host factors and
  permutations; loading rebuilds the solver without refactoring;
* ``save_banded`` / ``load_banded``: a ``BandedLU``'s block-Thomas stacks
  and layout.

Host numpy throughout: a loaded container or plan is placed on
``device`` (None: ``config.default_device()``, resolved at its first
device use).
"""

from __future__ import annotations

import numpy as np

from ..types import COO, CSC, CSR

__all__ = ["save_npz", "load_npz", "save_lu", "load_lu",
           "save_banded", "load_banded"]


def _save(path, compressed, payload):
    (np.savez_compressed if compressed else np.savez)(path, **payload)


def save_npz(path, a, compressed: bool = True):
    """Write a CSC / CSR / COO matrix in scipy's .npz layout."""
    if isinstance(a, (CSC, CSR)):
        fmt = "csc" if isinstance(a, CSC) else "csr"
        ip, ix, dt = a.np_arrays()
        arrays = {"indptr": ip, "indices": ix, "data": dt}
    elif isinstance(a, COO):
        fmt = "coo"
        r, c, d = a.np_arrays()
        arrays = {"row": r, "col": c, "data": d}
    else:
        raise TypeError(f"cannot save {type(a).__name__}")
    _save(path, compressed, dict(format=np.array(fmt.encode("ascii")),
                                 shape=np.array(a.shape, dtype=np.int64),
                                 **arrays))


def load_npz(path, device=None):
    """Read a CSC / CSR / COO .npz written by scipy or either package."""
    with np.load(path, allow_pickle=False) as f:
        fmt = f["format"].item()
        if isinstance(fmt, bytes):
            fmt = fmt.decode("ascii")
        m, n = (int(s) for s in f["shape"])
        if fmt == "csc":
            return CSC(m, n, f["indptr"], f["indices"], f["data"],
                       device=device)
        if fmt == "csr":
            return CSR(m, n, f["indptr"], f["indices"], f["data"],
                       device=device)
        if fmt == "coo":
            return COO(m, n, f["row"], f["col"], f["data"], device=device)
    raise ValueError(f"unsupported sparse format {fmt!r} in {path}")


def save_lu(path, lu, compressed: bool = True):
    """Persist a ``linalg.SparseLU`` (its host factors)."""
    h = lu._h
    _save(path, compressed, dict(
        n=np.int64(h.n), Lp=h.Lp, Li=h.Li, Lx=h.Lx, Up=h.Up, Ui=h.Ui,
        Ux=h.Ux, perm_r=h.perm_r, perm_c=h.perm_c,
        singular_cols=h.singular_cols))


def load_lu(path):
    """Rebuild a ``linalg.SparseLU`` from disk; its solve plans are made at
    the first solve, on the device that solve names."""
    from ..linalg.lu import SparseLU
    from ..linalg.lu_host import HostLU

    with np.load(path, allow_pickle=False) as f:
        h = HostLU(n=int(f["n"]), Lp=f["Lp"], Li=f["Li"], Lx=f["Lx"],
                   Up=f["Up"], Ui=f["Ui"], Ux=f["Ux"], perm_r=f["perm_r"],
                   perm_c=f["perm_c"], singular_cols=f["singular_cols"])
    return SparseLU(h)


def save_banded(path, plan, compressed: bool = True):
    """Persist a ``linalg.BandedLU`` factored on the host: its (ehat, sinv,
    uhat) stacks, the permutation and (n, s, bw)."""
    if plan._h is None:
        raise ValueError("no host stacks: this plan was factored on the "
                         "device")
    ehat, sinv, uhat, perm = plan._h
    _save(path, compressed, dict(
        n=np.int64(plan.n), s=np.int64(plan.s), bw=np.int64(plan.bw),
        ehat=ehat, sinv=sinv, uhat=uhat, perm=np.asarray(perm)))


def load_banded(path, device=None):
    """Rebuild a ``linalg.BandedLU`` from disk: host stacks, uploaded to
    ``device`` at the first device solve."""
    from ..linalg.banded import BandedLU

    with np.load(path, allow_pickle=False) as f:
        return BandedLU._from_stacks(
            f["ehat"], f["sinv"], f["uhat"], f["perm"], int(f["n"]),
            int(f["s"]), int(f["bw"]), device=device)
