"""Construction, conversion and SpMV."""

from . import construct, matvec  # noqa: F401
