"""Sparse LU (host factorization), level-scheduled triangular solves and
device refactorization."""

from .lu_host import HostLU, lu_factor_host  # noqa: F401
from .trisolve import TriSolvePlan, level_schedule, lsolve, usolve  # noqa: F401
from .lu import SolvePlan, SparseLU, splu, spsolve  # noqa: F401
from .refactor import RefactorPlan, retarget_solve_plan  # noqa: F401
from .ordering import amd, get_ordering, natural, nd, rcm  # noqa: F401
