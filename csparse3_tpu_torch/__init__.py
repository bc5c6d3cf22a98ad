"""csparse3_tpu_torch: the PyTorch and CUDA port of csparse3-tpu.

A second package beside the JAX one (``csparse3_tpu``), which stays the
reference the port's tests hold it to.  This package imports torch, numpy
and scipy, never jax.  Host-symbolic work (construction, orderings, LU
factorization) is numpy and the repository's native C++; device work is
torch, plus hand-written CUDA kernels (``csrc/``) where the JAX package had
a Pallas kernel on the path.

This is the first slice: what ``NewtonPowerFlow(spmv='ell' |
'bandpoints', solver='level')`` needs.
"""

__version__ = "0.1.0"

from . import config  # noqa: F401
from .types import COO, CSC, CSR  # noqa: F401
from .ops.construct import (  # noqa: F401
    canonicalize,
    csc_to_coo,
    csc_to_csr,
    csc_to_dense,
    csr_to_csc,
    from_triplets,
    to_scipy,
    transpose,
)
from .ops.matvec import SplitSpMV, SpMVPlan, spmv  # noqa: F401
from .kernels.bandpoints import (  # noqa: F401
    OffsetsPlan,
    SplitBandPoints,
    split_offsets,
)
from .linalg import (  # noqa: F401
    RefactorPlan,
    SolvePlan,
    SparseLU,
    TriSolvePlan,
    splu,
    spsolve,
)
from . import linalg, models  # noqa: F401
from .models import NewtonPowerFlow, newton_raphson  # noqa: F401
from .utils.interop import csc_from_arrays, grid_from_arrays  # noqa: F401
