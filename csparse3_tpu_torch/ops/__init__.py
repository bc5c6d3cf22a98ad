"""Construction, conversion, slicing and SpMV."""

from . import construct, matvec, slicing  # noqa: F401
