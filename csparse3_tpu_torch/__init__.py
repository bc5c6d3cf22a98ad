"""csparse3_tpu_torch: the PyTorch and CUDA port of csparse3-tpu.

A second package beside the JAX one (``csparse3_tpu``), which stays the
reference the port's tests hold it to.  This package imports torch, numpy
and scipy, never jax.  Host-symbolic work (construction, orderings, LU
factorization) is numpy and the repository's native C++; device work is
torch, plus hand-written CUDA kernels (``csrc/``) where the JAX package had
a Pallas kernel on the path.

Ported so far: the Newton power flow (``NewtonPowerFlow(spmv='ell' |
'bandpoints' | 'dia' | 'symdia', solver='level' | 'multifrontal' |
'blocklu')``, 'multifrontal' on ``linalg.MultifrontalLU`` with its
pivot-growth gate; the supernodal and multifrontal refactorizations), and
the banded path: ``rcm_grid``, the DIA SpMV family with its CUDA kernel,
``FastDecoupled(solver='level' | 'banded' | 'blocklu')``, the block-Thomas
solvers (``BandedLU``, ``BandedRefactor``, ``BandedSolvePlan``),
``dc_power_flow`` and the dense-tail triangular solves; and the sparse-
product path: CSC ``+ - *`` and ``@``, ``spgemm`` / ``gram`` with their
symbolic plans and the CUDA numeric kernel, the device ESC product, the
``BSR`` container with its block operations, and ``spmm`` / ``bsr_spmm``
with the CUDA block kernel; and the batched study path:
``NewtonPowerFlow.solve_batch`` / ``FastDecoupled.solve_batch`` on a
scenario axis (the Ybus SpMV kernels take a (K, n) batch in one launch;
the level, multifrontal and banded refactorizations and solves take
(K, nnz) values), ``DCContingency`` / ``ACContingency``, ``ptdf`` /
``lodf`` / ``LinearContingency``, ``short_circuit`` / ``zbus_columns`` and
the MATPOWER reader (``parse_case``, ``load_case``); and the symmetric
and iterative solvers with DC state estimation: ``ldlt`` /
``SparseLDLT`` / ``LDLTSolvePlan``, ``btf`` / ``btf_splu``, ``cg`` /
``bicgstab`` / ``gmres`` / ``refine`` with ``jacobi_prec`` /
``ilu0_prec``, ``dc_state_estimation`` and
``largest_normalized_residual``.  Products and solves are differentiable
(``torch.autograd``) in x / b and in the matrix values: ``spmv``,
``spmm``, ``SpMVPlan``, ``SolvePlan`` and the refactorizations' solves.
And the rest of the public surface: the builders (``TripletBuilder`` /
``LilMat`` / ``CooMat``), connected components on the device
(``islands``, ``component_labels``), stacking, ``norm``, ``validate``, the
constructors (``eye``, ``diag``, ``diags``, ``random_csc``, ...),
``utils.io`` and ``utils.profiling``; and the single-card streamed SPIKE
solver (``linalg.StreamedSPIKE``); and the distributed layer
(``parallel``: ``Mesh``, ``RowPartition`` / ``partition_rows``, the ring
and all-gather ``dist_spmv``, ``dist_cg`` / ``dist_bicgstab`` with
``BlockJacobi`` / ``DiagJacobi``, ``SchurLU``, ``DistBandedLU``) with the
studies' ``run_sharded``.

Every entry point runs on the CUDA card unless the caller passes
``device="cpu"`` (``config.default_device``).
"""

from .__version__ import __version__  # noqa: F401

from . import config  # noqa: F401
from .config import default_device  # noqa: F401
from .types import BSR, COO, CSC, CSR, DIA  # noqa: F401
from .ops.construct import (  # noqa: F401
    bsr_to_dense,
    canonicalize,
    compress_indptr,
    coo_to_csc,
    csc_to_bsr,
    csc_to_coo,
    csc_to_csr,
    csc_to_dense,
    csc_to_dia,
    dense_to_csc,
    dia_to_csc,
    csr_to_csc,
    diag,
    diags,
    expand_indptr,
    eye,
    from_triplets,
    random_csc,
    to_scipy,
    transpose,
)
from .builder import CooMat, LilMat, TripletBuilder  # noqa: F401
from .ops.graph import component_labels, islands  # noqa: F401
from .ops.norms import norm  # noqa: F401
from .ops.stacking import block, hstack, pack_4_by_4, vstack  # noqa: F401
from .ops.validate import (  # noqa: F401
    has_canonical_format,
    has_sorted_indices,
    validate,
)
from .utils.misc import dense_to_str, slice_to_range  # noqa: F401
from .ops.matvec import (  # noqa: F401
    DIAPlan,
    SplitDIA,
    SplitSpMV,
    SplitSymDIA,
    SpMVPlan,
    SymDIAPlan,
    bsr_spmm,
    dia_spmv,
    spmm,
    spmv,
)
from .ops.arithmetic import (  # noqa: F401
    add,
    axpby,
    compare,
    eldiv,
    eliminate_zeros,
    elmul,
    equal,
    maximum,
    minimum,
    scale,
    scale_columns,
    scale_rows,
    sub,
)
from .ops.spgemm import (  # noqa: F401
    GramPlan,
    SpGEMMPlan,
    gram,
    gram_symbolic,
    spgemm,
    spgemm_symbolic,
)
from .ops.spgemm_device import ESCSpGEMM, gram_device, spgemm_device  # noqa: F401
from .ops.bsr_ops import (  # noqa: F401
    BSRMatMatPlan,
    bsr_add,
    bsr_binop,
    bsr_matmat,
    bsr_transpose,
)
from .ops.slicing import sample_offsets, sample_values, submatrix  # noqa: F401
from .ops.reductions import diagonal, sum_duplicates  # noqa: F401
from .kernels.bandpoints import (  # noqa: F401
    OffsetsPlan,
    SplitBandPoints,
    split_offsets,
)
from .kernels.dia import (  # noqa: F401
    CudaDIA,
    PallasDIA,
    SplitCudaDIA,
    SplitPallasDIA,
)
from .linalg import (  # noqa: F401
    BandedLU,
    BandedRefactor,
    BandedSolvePlan,
    ComplexBandedSolve,
    BTFLU,
    DenseTailTriSolvePlan,
    LDLTSolvePlan,
    RefactorPlan,
    SolvePlan,
    SparseLDLT,
    SparseLU,
    StreamedSPIKE,
    TriSolvePlan,
    bicgstab,
    btf,
    btf_splu,
    cg,
    gmres,
    ilu0_prec,
    jacobi_prec,
    ldlt,
    max_transversal,
    refine,
    splu,
    spsolve,
)
from . import linalg, models, parallel, utils  # noqa: F401
from .utils import io, profiling  # noqa: F401
from .models import (  # noqa: F401
    ACContingency,
    DCContingency,
    DCMeasurements,
    FastDecoupled,
    LinearContingency,
    NewtonPowerFlow,
    SCResult,
    SEResult,
    dc_power_flow,
    dc_state_estimation,
    largest_normalized_residual,
    load_case,
    lodf,
    newton_raphson,
    parse_case,
    ptdf,
    rcm_grid,
    reorder_grid,
    short_circuit,
    zbus_columns,
)
from .utils.interop import (  # noqa: F401
    banded_from_stacks,
    bsr_from_arrays,
    csc_from_arrays,
    dia_from_arrays,
    dist_banded_from_host,
    grid_from_arrays,
    row_partition_from_arrays,
)

# the reference library's names
CscMat = CSC
Diag = diag
Diags = diags


def scipy_to_mat(a, device=None) -> CSC:
    """Adopt a scipy sparse matrix as a CSC."""
    return CSC.from_scipy(a, device=device)
