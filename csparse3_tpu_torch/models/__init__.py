"""Power-grid cases, the power-flow solvers and the studies built on them
(contingency screening, sensitivity factors, short circuit, DC state
estimation)."""

from . import grids, powerflow  # noqa: F401
from .contingency import ACContingency, DCContingency  # noqa: F401
from .estimation import (  # noqa: F401
    DCMeasurements,
    SEResult,
    dc_state_estimation,
    largest_normalized_residual,
)
from .grids import (  # noqa: F401
    Grid,
    branch_admittances,
    connectivity,
    ieee14,
    rcm_grid,
    reorder_grid,
    synthetic_grid,
    ybus,
)
from .matpower import load_case, parse_case  # noqa: F401
from .sensitivity import LinearContingency, lodf, ptdf  # noqa: F401
from .shortcircuit import SCResult, short_circuit, zbus_columns  # noqa: F401
from .powerflow import (  # noqa: F401
    FastDecoupled,
    NewtonPowerFlow,
    dc_power_flow,
    newton_raphson,
    sbus,
)
