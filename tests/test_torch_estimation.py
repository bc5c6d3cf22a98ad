"""The port's DC state estimation (``models/estimation.py``) against the
JAX package's on the same measurements (made with numpy from a seed):
theta, residuals and chi2 within 1e-9 (both estimate on the host in
float64 through the same native gram and LDL^T kernels), the same
``j_max`` and the normalized residuals within 1e-8 (the port's chunked
solves run on the CPU here, the card by default), the same errors, and a
dense normal-equations oracle from first principles.
"""

import jax  # noqa: F401  (JAX on the CPU with x64, set up by conftest)
import numpy as np
import pytest
import torch

from csparse3_tpu.models import estimation as je
from csparse3_tpu.models import grids as jgrids
from csparse3_tpu_torch import config
from csparse3_tpu_torch.models import estimation as pe
from csparse3_tpu_torch.models import grids as pgrids

# one intra-op thread: the suite runs several test processes at once
torch.set_num_threads(1)


def _true_state(g):
    """Bus angles from a seed (slack at 0) and the branch flows and bus
    injections they give: exact measurements of a DC state."""
    th = 0.1 * np.random.RandomState(g.n_bus).randn(g.n_bus)
    th[np.asarray(g.bus_type) == pgrids.SLACK] = 0.0
    flows = (th[g.f] - th[g.t]) / g.x
    inj = np.zeros(g.n_bus)
    np.add.at(inj, g.f, flows)
    np.add.at(inj, g.t, -flows)
    return th, flows, inj


def _measurements(g, noise=1.0, seed=1, bad=None, angles=False):
    """(flows, injections, angles) tuples for ``DCMeasurements.build``:
    every branch flow and bus injection with seeded noise, one flow
    corrupted by 20 sigma when ``bad`` names it."""
    th, flows, inj = _true_state(g)
    rng = np.random.RandomState(seed)
    zf = flows + noise * 0.01 * rng.randn(len(flows))
    if bad is not None:
        zf[bad] += 20 * 0.01
    zi = inj + noise * 0.02 * rng.randn(g.n_bus)
    buses = np.arange(g.n_bus)
    return dict(flows=(np.arange(g.n_branch), zf, 0.01),
                injections=(buses, zi, 0.02),
                angles=(buses, th, 0.001) if angles else None)


CASES = {
    "ieee14_exact": (lambda: jgrids.ieee14(), lambda: pgrids.ieee14(),
                     dict(noise=0.0)),
    "synthetic120_bad": (lambda: jgrids.synthetic_grid(120, seed=9),
                         lambda: pgrids.synthetic_grid(120, seed=9),
                         dict(bad=11)),
    "synthetic60_angles": (lambda: jgrids.synthetic_grid(60, seed=2),
                           lambda: pgrids.synthetic_grid(60, seed=2),
                           dict(angles=True)),
}


@pytest.fixture(scope="module")
def reference():
    out = {}
    for name, (jg, _, kw) in CASES.items():
        g = jg()
        meas = _measurements(g, **kw)
        res = je.dc_state_estimation(g, je.DCMeasurements.build(**meas))
        # one chunk on the JAX side (one compile); the port takes 16
        out[name] = (meas, res,
                     je.largest_normalized_residual(res, chunk=1024))
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_estimate_matches_reference(reference, name):
    meas, rj, (jj, rNj) = reference[name]
    g = CASES[name][1]()
    res = pe.dc_state_estimation(g, pe.DCMeasurements.build(**meas))
    np.testing.assert_allclose(res.theta, rj.theta, rtol=0, atol=1e-9)
    np.testing.assert_allclose(res.residuals, rj.residuals, rtol=0,
                               atol=1e-9)
    assert abs(res.chi2 - rj.chi2) <= 1e-9 * max(1.0, rj.chi2)
    assert (res.dof, res.H.shape) == (rj.dof, rj.H.shape)
    np.testing.assert_array_equal(res.keep, rj.keep)
    j, rN = pe.largest_normalized_residual(res, chunk=16, device="cpu")
    assert j == jj
    np.testing.assert_allclose(rN, rNj, rtol=0, atol=1e-8)
    if name == "synthetic120_bad":
        assert j == 11 and rN[11] > 10.0
    if name == "ieee14_exact":
        assert res.chi2 < 1e-12
        np.testing.assert_allclose(res.theta, _true_state(g)[0], atol=1e-10)


def test_chunking_does_not_change_the_result(reference):
    meas, _, (_, rNj) = reference["synthetic60_angles"]
    res = pe.dc_state_estimation(pgrids.synthetic_grid(60, seed=2),
                                 pe.DCMeasurements.build(**meas))
    for chunk in (7, 1024):
        _, rN = pe.largest_normalized_residual(res, chunk=chunk,
                                               device="cpu")
        np.testing.assert_allclose(rN, rNj, rtol=0, atol=1e-8)


def test_dense_normal_equations_oracle():
    g = pgrids.synthetic_grid(80, seed=9)
    meas = pe.DCMeasurements.build(**_measurements(g, seed=1))
    res = pe.dc_state_estimation(g, meas)
    keep = np.flatnonzero(np.asarray(g.bus_type) != pgrids.SLACK)
    nb = len(keep)
    red = np.full(g.n_bus, -1, np.int64)
    red[keep] = np.arange(nb)
    b = 1.0 / g.x
    Hf = np.zeros((g.n_branch, nb))
    r = np.arange(g.n_branch)
    for end, sgn in ((g.f, 1.0), (g.t, -1.0)):
        live = red[end] >= 0
        Hf[r[live], red[end[live]]] += sgn * b[live]
    B = np.zeros((g.n_bus, g.n_bus))
    np.add.at(B, (g.f, g.f), b)
    np.add.at(B, (g.t, g.t), b)
    np.add.at(B, (g.f, g.t), -b)
    np.add.at(B, (g.t, g.f), -b)
    H = np.vstack([Hf, B[:, keep]])
    z = np.concatenate([meas.flow_val, meas.inj_val])
    w = 1.0 / np.concatenate([meas.flow_sigma, meas.inj_sigma]) ** 2
    th_r = np.linalg.solve(H.T @ (w[:, None] * H), H.T @ (w * z))
    np.testing.assert_allclose(res.theta[keep], th_r, atol=1e-9)
    np.testing.assert_allclose(res.residuals, z - H @ th_r, atol=1e-9)


def _errors(grids):
    g = grids.ieee14()
    _, flows, _ = _true_state(g)
    k = np.zeros(20, dtype=np.int64)
    return {
        "unobservable": (g, dict(flows=(k, flows[k], 0.01))),
        "underdetermined": (g, dict(flows=(np.array([0, 1]), np.zeros(2),
                                           0.01))),
        "duplicate": (g, dict(injections=(np.array([3, 3] + list(range(14))),
                                          np.zeros(16), 0.1))),
        "sigmas must be positive": (g, dict(flows=(np.array([0]),
                                                   np.zeros(1), 0.0))),
        "out of range": (g, dict(flows=(np.arange(g.n_branch + 1),
                                        np.zeros(g.n_branch + 1), 0.01))),
    }


@pytest.mark.parametrize("match", ["unobservable", "underdetermined",
                                   "duplicate", "sigmas must be positive",
                                   "out of range"])
def test_errors_raise_as_reference(match):
    outcomes = []
    for mod, grids in ((je, jgrids), (pe, pgrids)):
        g, kw = _errors(grids)[match]
        with pytest.raises((ValueError, IndexError), match=match) as info:
            mod.dc_state_estimation(g, mod.DCMeasurements.build(**kw))
        outcomes.append(info.type)
    assert outcomes[0] is outcomes[1]


def test_device_none_is_the_default_device(monkeypatch):
    g = pgrids.ieee14()
    res = pe.dc_state_estimation(
        g, pe.DCMeasurements.build(**_measurements(g, noise=0.0)))

    def card():
        raise RuntimeError("default device asked for")

    monkeypatch.setattr(config, "default_device", card)
    with pytest.raises(RuntimeError, match="default device"):
        pe.largest_normalized_residual(res)
