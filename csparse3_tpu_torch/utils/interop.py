"""Carrying state between the JAX package and the port.

This library has no weights: its state is the matrices and the grids.
The helpers take plain numpy arrays (what the JAX package's
``CSC.np_arrays()``, the fields of its ``BSR``, ``Grid._asdict()`` and
the host stacks of its ``BandedLU`` give), so a caller can hand the
same state to both packages without either importing the other.
"""

from __future__ import annotations

import numpy as np

from ..models.grids import Grid
from ..types import BSR, CSC, DIA

__all__ = ["csc_from_arrays", "bsr_from_arrays", "dia_from_arrays",
           "grid_from_arrays", "banded_from_stacks",
           "row_partition_from_arrays", "dist_banded_from_host"]


def csc_from_arrays(m, n, indptr, indices, data, device=None) -> CSC:
    """CSC from host (indptr, indices, data) arrays, placed on ``device``
    (None: ``config.default_device()``, resolved when a tensor of it is
    first read); the arrays stay as its host cache."""
    return CSC(m, n, np.asarray(indptr), np.asarray(indices),
               np.asarray(data), device=device)


def bsr_from_arrays(m, n, indptr, indices, data, nnz_blocks=None,
                    device=None) -> BSR:
    """BSR from host (indptr, indices, data (nblocks, R, C)) arrays, placed
    like ``csc_from_arrays``; the block shape is read off ``data``."""
    data = np.asarray(data)
    return BSR(m, n, data.shape[1], data.shape[2], np.asarray(indptr),
               np.asarray(indices), data, nnz_blocks=nnz_blocks,
               device=device)


def dia_from_arrays(m, n, offsets, data, device=None) -> DIA:
    """DIA from host (offsets, data) arrays, placed like
    ``csc_from_arrays``."""
    return DIA(m, n, np.asarray(offsets), np.asarray(data), device=device)


def grid_from_arrays(**fields) -> Grid:
    """Grid from its fields (``Grid._asdict()`` of either package)."""
    return Grid(**{k: int(v) if k == "n_bus" else np.asarray(v)
                   for k, v in fields.items()})


def banded_from_stacks(ehat, sinv, uhat, perm, n, s, bw, device=None):
    """``linalg.BandedLU`` from host block-Thomas stacks (ehat, sinv, uhat
    of shape (nb, s, s), the ordering ``perm``; the JAX package's
    ``BandedLU._h``), uploaded at its first device solve to ``device``
    (None: ``config.default_device()``); ``solve_host`` works at once."""
    from ..linalg.banded import BandedLU

    return BandedLU._from_stacks(
        np.asarray(ehat), np.asarray(sinv), np.asarray(uhat),
        np.asarray(perm, dtype=np.int64), int(n), int(s), int(bw),
        device=device)


def row_partition_from_arrays(m, n, S, mloc, k, strategy, e_rows, e_cols,
                              e_vals):
    """``parallel.RowPartition`` from the fields of a JAX package
    ``RowPartition`` (its static fields and its three leaves as host
    arrays); placed on a mesh at its first distributed call."""
    from ..parallel import RowPartition

    return RowPartition(int(m), int(n), int(S), int(mloc), int(k),
                        str(strategy), np.array(e_rows),
                        np.array(e_cols), np.array(e_vals))


def dist_banded_from_host(ehat, sinv, uhat, Wsp, Vsp, r_eh, r_si, r_uh,
                          perm, n, s, bw, m, P, mesh):
    """``parallel.DistBandedLU`` from the host factor state of a JAX package
    ``DistBandedLU`` built by its host constructor (its ``_h`` stacks, in
    that order, and ``perm``, ``n``, ``s``, ``bw``, ``m``, ``P``), on a port
    ``Mesh`` of P positions; the stacks upload at the first device solve,
    ``solve_host`` works at once."""
    from ..parallel import DistBandedLU

    if mesh.size != int(P):
        raise ValueError(f"mesh has {mesh.size} positions, the factor "
                         f"{int(P)} chunks")
    return DistBandedLU._from_host(
        (ehat, sinv, uhat, Wsp, Vsp, r_eh, r_si, r_uh), perm, int(n),
        int(s), int(bw), int(m), mesh)
