"""Power-grid cases and the power-flow solvers."""

from . import grids, powerflow  # noqa: F401
from .grids import (  # noqa: F401
    Grid,
    ieee14,
    rcm_grid,
    reorder_grid,
    synthetic_grid,
    ybus,
)
from .powerflow import (  # noqa: F401
    FastDecoupled,
    NewtonPowerFlow,
    dc_power_flow,
    newton_raphson,
    sbus,
)
