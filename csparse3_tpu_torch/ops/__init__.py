"""Construction, conversion, validation, slicing, stacking, arithmetic,
reductions, norms, connected components, SpMV / SpMM, SpGEMM and the BSR
block operations."""

from . import (  # noqa: F401
    arithmetic,
    bsr_ops,
    construct,
    graph,
    matvec,
    norms,
    reductions,
    slicing,
    spgemm,
    spgemm_device,
    stacking,
    validate,
)
