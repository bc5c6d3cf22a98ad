"""Carrying state between the JAX package and the port.

This library has no weights: its state is the matrices and the grids.
Both helpers take plain numpy arrays (what the JAX package's
``CSC.np_arrays()`` and ``Grid._asdict()`` give), so a caller can hand the
same state to both packages without either importing the other.
"""

from __future__ import annotations

import numpy as np

from ..models.grids import Grid
from ..types import CSC

__all__ = ["csc_from_arrays", "grid_from_arrays"]


def csc_from_arrays(m, n, indptr, indices, data, device=None) -> CSC:
    """CSC from host (indptr, indices, data) arrays, placed on ``device``
    (CPU when None); the arrays stay as its host cache."""
    return CSC(m, n, np.asarray(indptr), np.asarray(indices),
               np.asarray(data), device=device)


def grid_from_arrays(**fields) -> Grid:
    """Grid from its fields (``Grid._asdict()`` of either package)."""
    return Grid(**{k: int(v) if k == "n_bus" else np.asarray(v)
                   for k, v in fields.items()})
