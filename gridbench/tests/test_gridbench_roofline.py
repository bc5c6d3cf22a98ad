"""The least-bytes count of a product and the roofline share."""

import numpy as np
import pytest
import scipy.sparse as sp

from _tiny import ROOT  # noqa: F401
from gridbench.roofline import (roofline_pct, spmv_least_bytes,
                                unique_nonzeros)


def _sym():
    # 3 x 3 complex symmetric: 7 nonzeros, 5 in the upper triangle
    return sp.csr_matrix(np.array([[4, 1j, 0], [1j, 5, 2], [0, 2, 6]],
                                  dtype=complex))


def test_unique_nonzeros():
    assert unique_nonzeros(_sym(), False) == 7
    assert unique_nonzeros(_sym(), True) == 5


def test_least_bytes_by_hand():
    # float32: 7 x (8 + 4) + x and y, 2 x K x n x 8 with K = 2, n = 3
    assert spmv_least_bytes(_sym(), 2, 4, False) == 7 * 12 + 2 * 2 * 3 * 8
    # float64, stored triangle: 5 x (16 + 4) + 2 x 2 x 3 x 16
    assert spmv_least_bytes(_sym(), 2, 8, True) == 5 * 20 + 2 * 2 * 3 * 16


def test_roofline_pct():
    kind = "NVIDIA H100 80GB HBM3"
    # 3.35 GB in 2 ms is half of 3.35 TB/s
    assert roofline_pct(3.35e9, 2e-3, kind) == pytest.approx(50.0)
    assert roofline_pct(3.35e9, 2e-3, "cpu") is None
    assert roofline_pct(3.35e9, 0.0, kind) is None
