"""Construction, conversion, slicing, arithmetic, SpMV / SpMM, SpGEMM and
the BSR block operations."""

from . import (  # noqa: F401
    arithmetic,
    bsr_ops,
    construct,
    matvec,
    slicing,
    spgemm,
    spgemm_device,
)
