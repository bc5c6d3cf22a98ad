"""Sparse LU and LDL^T (host factorizations), level-scheduled and
dense-tail triangular solves, device refactorization (level-scheduled,
supernodal and multifrontal), the from-scratch multifrontal device LU, the
banded block-Thomas solvers and the single-card streamed SPIKE solver, the
block triangular form with its block-wise LU, and the Krylov solvers."""

from .lu_host import HostLU, lu_factor_host  # noqa: F401
from .trisolve import (  # noqa: F401
    DenseTailTriSolvePlan,
    TriSolvePlan,
    choose_dense_tail,
    level_schedule,
    lsolve,
    ltsolve,
    usolve,
    utsolve,
)
from .lu import SolvePlan, SparseLU, splu, spsolve  # noqa: F401
from .cholesky import LDLTSolvePlan, SparseLDLT, ldlt  # noqa: F401
from .refactor import RefactorPlan, retarget_solve_plan  # noqa: F401
from .ordering import (  # noqa: F401
    amd,
    get_ordering,
    mindeg,
    natural,
    nd,
    rcm,
    symmetrize_pattern,
)
from .supernodal import SupernodalRefactor  # noqa: F401
from .multifrontal import MultifrontalLU, MultifrontalRefactor  # noqa: F401
from .banded import (  # noqa: F401
    BandedLU,
    BandedRefactor,
    BandedSolvePlan,
    ComplexBandedSolve,
    bandwidth,
    spike_tips_device,
    thomas_factor_device,
    thomas_sweeps,
)
from .spike_stream import StreamedSPIKE, spike_reduced_factor  # noqa: F401
from .btf import BTFLU, btf, btf_splu, max_transversal  # noqa: F401
from .iterative import (  # noqa: F401
    bicgstab,
    cg,
    gmres,
    ilu0_prec,
    jacobi_prec,
    refine,
)
