"""Construction, conversion, slicing, arithmetic, reductions, SpMV / SpMM,
SpGEMM and the BSR block operations."""

from . import (  # noqa: F401
    arithmetic,
    bsr_ops,
    construct,
    matvec,
    reductions,
    slicing,
    spgemm,
    spgemm_device,
)
