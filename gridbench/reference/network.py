"""Network matrices from a grid's arrays (pi model, MATPOWER formulas)."""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

PQ, PV, SLACK = 0, 1, 2


def index_sets(a: dict):
    """(pvpq, pq, fixed): the buses whose angle is solved, those whose
    magnitude is solved, and those whose magnitude is a setpoint (PV and
    slack)."""
    bt = np.asarray(a["bus_type"])
    pv, pq = np.flatnonzero(bt == PV), np.flatnonzero(bt == PQ)
    return np.concatenate([pv, pq]), pq, np.flatnonzero(bt != PQ)


def slack_bus(a: dict) -> int:
    return int(np.flatnonzero(np.asarray(a["bus_type"]) == SLACK)[0])


def ybus(a: dict) -> sp.csr_matrix:
    """Complex bus admittance matrix, CSR."""
    n = a["n_bus"]
    f, t = np.asarray(a["f"]), np.asarray(a["t"])
    ys = 1.0 / (np.asarray(a["r"]) + 1j * np.asarray(a["x"]))
    bc = 0.5j * np.asarray(a["b"])
    tap = np.asarray(a["tap"], dtype=np.complex128)
    ytt = ys + bc
    yff = ytt / (tap * np.conj(tap))
    yft = -ys / np.conj(tap)
    ytf = -ys / tap
    diag = np.arange(n)
    rows = np.concatenate([f, f, t, t, diag])
    cols = np.concatenate([f, t, f, t, diag])
    vals = np.concatenate([yff, yft, ytf, ytt,
                           np.asarray(a["gs"]) + 1j * np.asarray(a["bs"])])
    return sp.csr_matrix((vals, (rows, cols)), shape=(n, n))


def sbus(a: dict) -> np.ndarray:
    """Base complex injections: generation less load."""
    return (np.asarray(a["pg"]) - np.asarray(a["pd"])) - 1j * np.asarray(
        a["qd"])


def b_series(a: dict, drop=None) -> sp.csc_matrix:
    """The series-susceptance Laplacian (r = 0, b = 0, tap = 1): DC power
    flow's B and the XB scheme's B', without branch ``drop`` if given."""
    n = a["n_bus"]
    f, t = np.asarray(a["f"]), np.asarray(a["t"])
    bs = 1.0 / np.asarray(a["x"])
    if drop is not None:
        live = np.ones(len(f), dtype=bool)
        live[drop] = False
        f, t, bs = f[live], t[live], bs[live]
    return sp.csc_matrix(
        (np.concatenate([bs, bs, -bs, -bs]),
         (np.concatenate([f, t, f, t]), np.concatenate([f, t, t, f]))),
        shape=(n, n))
