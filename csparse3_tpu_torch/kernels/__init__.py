"""Hand-written CUDA kernels (``csrc/``) with their plain PyTorch twins."""

from .bandpoints import OffsetsPlan, SplitBandPoints, split_offsets  # noqa: F401
from .dia import (  # noqa: F401
    CudaDIA,
    PallasDIA,
    SplitCudaDIA,
    SplitPallasDIA,
    dia_spmv_cuda,
    dia_spmv_plain,
)
from .bsr_spmm import bsr_spmm_cuda, bsr_spmm_plain  # noqa: F401
from .spgemm import spgemm_numeric_cuda, spgemm_numeric_plain  # noqa: F401
