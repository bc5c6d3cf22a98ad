"""Hand-written CUDA kernels (``csrc/``) with their plain PyTorch twins."""

from .bandpoints import OffsetsPlan, SplitBandPoints, split_offsets  # noqa: F401
