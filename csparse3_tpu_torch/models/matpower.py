"""MATPOWER case-file reader.

The JAX package's ``csparse3_tpu/models/matpower.py``, copied: it is
numpy only, and the port keeps its own copy rather than import the JAX
package.  The de-facto interchange format for the grids power-flow
solvers consume is the MATPOWER case file (``case14.m``,
``case2869pegase.m``).  This module parses the MATLAB struct syntax those
files use into a ``models.grids.Grid``, so any public MATPOWER/pglib-opf
case drops straight into ``grids.ybus`` / ``models.powerflow``.

Only the matrices the power-flow chain needs are read (``bus``, ``gen``,
``branch``, ``baseMVA``); everything else (gencost, dcline, ...) is
ignored.  Supported syntax: ``mpc.<name> = [ ... ];`` blocks with
newline- or semicolon-separated rows, ``%`` comments, scientific notation,
and arbitrary (non-consecutive) bus numbering.
"""

from __future__ import annotations

import re

import numpy as np

from .grids import PQ, PV, SLACK, Grid

__all__ = ["parse_case", "load_case"]

# MATPOWER column indices (matpower manual, caseformat)
_BUS_I, _BUS_TYPE, _PD, _QD, _GS, _BS, _VM = 0, 1, 2, 3, 4, 5, 7
_GEN_BUS, _PG, _VG, _GEN_STATUS = 0, 1, 5, 7
_F_BUS, _T_BUS, _BR_R, _BR_X, _BR_B, _TAP, _SHIFT, _BR_STATUS = (
    0, 1, 2, 3, 4, 8, 9, 10)


def _matrix_blocks(text: str) -> dict:
    """All ``mpc.<name> = [ ... ];`` numeric blocks plus scalar fields."""
    # strip % comments (MATPOWER files comment column headers this way)
    text = re.sub(r"%[^\n]*", "", text)
    out = {}
    for m in re.finditer(
            r"mpc\.(\w+)\s*=\s*\[(.*?)\]\s*;", text, re.DOTALL):
        name, body = m.group(1), m.group(2)
        rows = []
        for raw in re.split(r"[;\n]", body):
            vals = raw.replace(",", " ").split()
            if vals:
                rows.append([float(v) for v in vals])
        if rows:
            width = max(len(r) for r in rows)
            if any(len(r) != width for r in rows):
                raise ValueError(
                    f"mpc.{name}: ragged rows (found lengths "
                    f"{sorted({len(r) for r in rows})}) — zero-padding "
                    "would silently flip status columns")
            out[name] = np.array(rows)
    for m in re.finditer(r"mpc\.(\w+)\s*=\s*([\d.eE+-]+)\s*;", text):
        out.setdefault(m.group(1), float(m.group(2)))
    return out


def parse_case(text: str) -> Grid:
    """Parse MATPOWER case text into a Grid (per-unit on baseMVA,
    0-based consecutive bus ids, out-of-service branches/gens dropped,
    phase shifters folded into a complex tap)."""
    blocks = _matrix_blocks(text)
    for req in ("bus", "branch"):
        if req not in blocks:
            raise ValueError(f"case text has no mpc.{req} matrix")
    base = float(blocks.get("baseMVA", 100.0))
    bus = np.atleast_2d(blocks["bus"])
    branch = np.atleast_2d(blocks["branch"])
    gen = np.atleast_2d(blocks["gen"]) if "gen" in blocks else np.zeros((0, 8))

    n = bus.shape[0]
    bus_ids = bus[:, _BUS_I].astype(np.int64)
    lut = {b: i for i, b in enumerate(bus_ids)}

    # MATPOWER type codes: 1=PQ, 2=PV, 3=ref, 4=isolated (treated as PQ)
    mp_type = bus[:, _BUS_TYPE].astype(np.int64)
    bus_type = np.full(n, PQ, dtype=np.int64)
    bus_type[mp_type == 2] = PV
    bus_type[mp_type == 3] = SLACK

    pd = bus[:, _PD] / base
    qd = bus[:, _QD] / base
    gs = bus[:, _GS] / base
    bs = bus[:, _BS] / base
    vm0 = bus[:, _VM].copy()
    vm0[vm0 <= 0] = 1.0

    pg = np.zeros(n)
    if gen.size:
        on = gen[:, _GEN_STATUS] > 0 if gen.shape[1] > _GEN_STATUS else \
            np.ones(len(gen), dtype=bool)
        for row in gen[on]:
            i = lut[int(row[_GEN_BUS])]
            pg[i] += row[_PG] / base
            if row[_VG] > 0:
                vm0[i] = row[_VG]

    status = branch[:, _BR_STATUS] > 0 if branch.shape[1] > _BR_STATUS \
        else np.ones(len(branch), dtype=bool)
    br = branch[status]
    f = np.array([lut[int(v)] for v in br[:, _F_BUS]], dtype=np.int64)
    t = np.array([lut[int(v)] for v in br[:, _T_BUS]], dtype=np.int64)
    ratio = br[:, _TAP].copy() if br.shape[1] > _TAP else np.ones(len(br))
    ratio[ratio == 0] = 1.0  # MATPOWER convention: 0 means nominal
    shift = np.deg2rad(br[:, _SHIFT]) if br.shape[1] > _SHIFT else \
        np.zeros(len(br))
    tap = ratio * np.exp(1j * shift) if np.any(shift) else ratio

    return Grid(
        n_bus=n, f=f, t=t,
        r=br[:, _BR_R].copy(), x=br[:, _BR_X].copy(), b=br[:, _BR_B].copy(),
        tap=tap, bus_type=bus_type, pd=pd, qd=qd, pg=pg, vm0=vm0,
        gs=gs, bs=bs,
    )


def load_case(path) -> Grid:
    """Read a MATPOWER .m case file into a Grid."""
    with open(path) as fh:
        return parse_case(fh.read())
