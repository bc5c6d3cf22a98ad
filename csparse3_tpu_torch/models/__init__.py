"""Power-grid cases and the Newton power flow."""

from . import grids, powerflow  # noqa: F401
from .grids import Grid, ieee14, synthetic_grid, ybus  # noqa: F401
from .powerflow import NewtonPowerFlow, newton_raphson, sbus  # noqa: F401
