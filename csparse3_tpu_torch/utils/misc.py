"""Small host utilities, as the JAX package's ``csparse3_tpu/utils/
misc.py``: a slice resolved against an axis length, and a dense matrix
printed with exact zeros as '_'."""

from __future__ import annotations

import numpy as np

__all__ = ["slice_to_range", "dense_to_str"]


def slice_to_range(sl: slice, dim: int) -> np.ndarray:
    """The indices a slice selects on an axis of length ``dim``."""
    start, stop, step = sl.indices(dim)
    return np.arange(start, stop, step, dtype=np.int64)


def dense_to_str(mat) -> str:
    """A dense matrix (numpy or a tensor) as tab-separated rows, exact
    zeros as '_'."""
    if hasattr(mat, "detach"):
        mat = mat.detach().cpu().numpy()
    mat = np.asarray(mat)
    rows = []
    for r in mat:
        cells = ["_" if v == 0 else f"{v:g}" for v in r]
        rows.append("\t".join(cells))
    return "\n".join(rows) + "\n"
