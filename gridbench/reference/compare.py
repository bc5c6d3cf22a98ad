"""The judgement that decides ``correct``.

Each number compared has a limit of its own in the cell's file
(``cells/<workload>.json``, key ``limits``); a run is correct when every
number is at or below its limit.  The numbers come from the study's own
``numbers`` (``studies/<study>.py``), which reads the program's answers
only to judge them with the reference's functions
(``powerflow.ts_numbers``, ``contingency.n1_numbers``).
"""

from __future__ import annotations

import numpy as np


def judge(numbers: dict, limits: dict):
    """(correct, [(name, value, limit)]) in the order of ``limits``; a
    number missing or not finite is not correct."""
    rows = [(k, float(numbers.get(k, float("nan"))), float(limits[k]))
            for k in limits]
    ok = all(np.isfinite(v) and v <= lim for _, v, lim in rows)
    return ok, rows
