"""The distributed layer over a single-process device mesh: row
partitions, the ring / all-gather SpMV, distributed Krylov solvers, the
Schur-complement and SPIKE direct solvers (the JAX package's
``csparse3_tpu/parallel``)."""

from .mesh import Mesh  # noqa: F401
from .partition import RowPartition, partition_rows  # noqa: F401
from .spmv import dist_spmm, dist_spmv, spmv_local  # noqa: F401
from .solve import (BlockJacobi, DiagJacobi, dist_bicgstab,  # noqa: F401
                    dist_cg)
from .schur import SchurLU, SchurSolvePlan  # noqa: F401
from .banded import DistBandedLU  # noqa: F401
