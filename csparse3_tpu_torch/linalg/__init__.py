"""Sparse LU (host factorization), level-scheduled and dense-tail
triangular solves, device refactorization (level-scheduled, supernodal and
multifrontal), the from-scratch multifrontal device LU and the banded
block-Thomas solvers."""

from .lu_host import HostLU, lu_factor_host  # noqa: F401
from .trisolve import (  # noqa: F401
    DenseTailTriSolvePlan,
    TriSolvePlan,
    choose_dense_tail,
    level_schedule,
    lsolve,
    usolve,
)
from .lu import SolvePlan, SparseLU, splu, spsolve  # noqa: F401
from .refactor import RefactorPlan, retarget_solve_plan  # noqa: F401
from .ordering import amd, get_ordering, natural, nd, rcm  # noqa: F401
from .supernodal import SupernodalRefactor  # noqa: F401
from .multifrontal import MultifrontalLU, MultifrontalRefactor  # noqa: F401
from .banded import (  # noqa: F401
    BandedLU,
    BandedRefactor,
    BandedSolvePlan,
    ComplexBandedSolve,
    bandwidth,
    thomas_factor_device,
    thomas_sweeps,
)
