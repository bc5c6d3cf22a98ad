"""The yardstick's peaks and byte counts.

``PEAKS`` holds the published rates of the cards the benchmark knows, by
the name ``torch.cuda.get_device_name()`` gives (NVIDIA's data sheet, SXM
part).  ``spmv_least_bytes`` counts what a sparse product of the problem
must move at the least, from the problem's sizes alone, whatever layout a
plan holds: so an edit of a plan cannot move the yardstick.
"""

from __future__ import annotations

import scipy.sparse as sp

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12},
}


def unique_nonzeros(Y, symmetric: bool) -> int:
    """Stored entries of ``Y``: all, or the upper triangle with the
    diagonal for the symmetric form."""
    Y = sp.csr_matrix(Y)
    return int(sp.triu(Y).nnz) if symmetric else int(Y.nnz)


def spmv_least_bytes(Y, K: int, value_bytes: int, symmetric: bool) -> int:
    """Bytes a complex product Y X of K vectors must move: each unique
    nonzero read once as a complex value (2 x ``value_bytes``) and a 4-byte
    column index, X (K, n) read once and Y X written once, complex in
    ``value_bytes`` parts."""
    n = Y.shape[0]
    return (unique_nonzeros(Y, symmetric) * (2 * value_bytes + 4)
            + 2 * K * n * 2 * value_bytes)


def roofline_pct(nbytes: int, seconds: float, kind: str):
    """Share of the card's memory roofline, in %: the least time (bytes
    over the published bandwidth) over the measured time; None for a card
    not in ``PEAKS`` or no time."""
    peak = PEAKS.get(kind)
    if peak is None or not seconds > 0:
        return None
    return 100.0 * nbytes / peak["hbm_bytes_per_s"] / seconds
