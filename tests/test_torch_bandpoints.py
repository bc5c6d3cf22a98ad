"""The band + points SpMV: the port's plain version against the JAX
package's plan (Pallas in interpret mode on the CPU).  The CUDA kernel is
held to the plain version on a card in tests/test_torch_gpu.py.

Both sides compute in float32 with different summation orders, so they are
held to 5e-6 of max|y| (about 40 float32 ulps of the largest output).
"""

import jax  # noqa: F401  (JAX on the CPU with x64, set up by conftest)
import numpy as np
import pytest
import torch

import csparse3_tpu as jt
import csparse3_tpu_torch as pt
from csparse3_tpu.kernels import bandpoints as jbp
from csparse3_tpu.models import grids as jgrids
from csparse3_tpu_torch.kernels import bandpoints as pbp
from csparse3_tpu_torch.utils.interop import csc_from_arrays

# one intra-op thread: the suite runs several test processes at once
torch.set_num_threads(1)

REL = 5e-6


def _ybus(n, seed):
    Y, _, _ = jgrids.ybus(jgrids.synthetic_grid(n, seed=seed))
    return Y


def _band(n):
    rows = np.concatenate([np.arange(n), np.arange(1, n), np.arange(n - 1)])
    cols = np.concatenate([np.arange(n), np.arange(n - 1), np.arange(1, n)])
    vals = np.random.RandomState(6).rand(len(rows))
    return jt.from_triplets(rows, cols, vals, (n, n))


CASES = {
    # not a tile multiple
    "ybus1037": (lambda: _ybus(1037, 3), dict(tile=128)),
    # offset groups: group 0 fused with the slabs, later groups points-only
    "groups900": (lambda: _ybus(900, 9), dict(tile=128, group_span=40)),
    # heavy diagonals only, empty point table
    "band500": (lambda: _band(500), dict(tile=128)),
}


def _x(n, seed):
    rng = np.random.RandomState(seed)
    return rng.rand(n).astype(np.float32), rng.rand(n).astype(np.float32)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_jax(case):
    make, kw = CASES[case]
    Yj = make()
    jplan = jbp.SplitBandPoints(Yj, **kw)
    pplan = pbp.SplitBandPoints(csc_from_arrays(Yj.m, Yj.n, *Yj.np_arrays()),
                                device="cpu", **kw)
    assert pplan.offs == jplan.offs and pplan.n_groups == jplan.n_groups
    if "group_span" in kw:
        assert pplan.n_groups >= 2
    xr, xi = _x(Yj.n, 4)
    yj = np.stack([np.asarray(y) for y in jplan(xr, xi)])
    yp = torch.stack(pplan(torch.as_tensor(xr), torch.as_tensor(xi)))
    assert yp.dtype == torch.float32
    scale = np.abs(yj).max()
    assert np.abs(yp.numpy() - yj).max() <= REL * scale
    # and both agree with scipy in complex128
    z = Yj.to_scipy() @ (xr.astype(np.float64) + 1j * xi)
    assert np.abs(yp.numpy() - np.stack([z.real, z.imag])).max() \
        <= REL * scale


@pytest.mark.parametrize("span", [40, 100])
def test_grouped_kernel_lists_equal_ungrouped(span):
    """The kernel walks the offset groups' lists joined in group order:
    exactly the lists of the ungrouped plan, so one launch serves both.
    The grouped plain version still walks group by group, as the JAX plan
    does, and matches it."""
    Yj = _ybus(900, 9)
    Yp = csc_from_arrays(Yj.m, Yj.n, *Yj.np_arrays())
    grouped = pbp.SplitBandPoints(Yp, tile=128, group_span=span,
                                  device="cpu")
    whole = pbp.SplitBandPoints(Yp, tile=128, device="cpu")
    assert grouped.n_groups >= 2 and whole.n_groups == 1
    for a, b in zip(grouped._kernel_lists(), whole._kernel_lists()):
        assert a.dtype == b.dtype and torch.equal(a, b)
    jplan = jbp.SplitBandPoints(Yj, tile=128, group_span=span)
    assert jplan.n_groups == grouped.n_groups
    xr, xi = _x(Yj.n, 5)
    yj = np.stack([np.asarray(y) for y in jplan(xr, xi)])
    yp = torch.stack(grouped(torch.as_tensor(xr), torch.as_tensor(xi)))
    assert np.abs(yp.numpy() - yj).max() <= REL * np.abs(yj).max()


def test_cpu_input_runs_plain_version_without_launching():
    Yj = _ybus(300, 1)
    plan = pt.SplitBandPoints(csc_from_arrays(Yj.m, Yj.n, *Yj.np_arrays()),
                              device="cpu")
    xr, xi = _x(300, 2)
    y = plan(torch.as_tensor(xr), torch.as_tensor(xi))
    p = plan.plain(torch.as_tensor(xr), torch.as_tensor(xi))
    assert plan.kernel_launches == 0
    for a, b in zip(y, p):
        assert torch.equal(a, b)
    # any other device goes to the kernel path, which refuses it
    with pytest.raises(ValueError, match="CUDA device"):
        plan(torch.empty(300, device="meta"), torch.empty(300, device="meta"))


def test_offsets_plan_matches_jax():
    Yj = _ybus(500, 2)
    ip, ix, dt = Yj.np_arrays()
    cols = np.repeat(np.arange(Yj.n), np.diff(ip))
    offs = jbp.split_offsets(ix, cols, Yj.n)
    assert offs == pbp.split_offsets(ix, cols, Yj.n)
    vals = dt.real
    jp = jbp.OffsetsPlan.from_entries(Yj.m, Yj.n, ix, cols, vals, offs)
    pp = pbp.OffsetsPlan.from_entries(Yj.m, Yj.n, ix, cols, vals, offs,
                                      device="cpu")
    x = np.random.RandomState(3).rand(Yj.n, 2).astype(np.float32)
    np.testing.assert_allclose(pp(torch.as_tensor(x)).numpy(),
                               np.asarray(jp(x)), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(pp(torch.as_tensor(x[:, 0])).numpy(),
                               np.asarray(jp(x[:, 0])), rtol=1e-6, atol=1e-6)


def test_bad_arguments_raise():
    Y = csc_from_arrays(2, 3, np.array([0, 1, 1, 1]), np.array([0]),
                        np.array([1.0]))
    with pytest.raises(ValueError, match="square"):
        pt.SplitBandPoints(Y, device="cpu")
    Yj = _ybus(100, 1)
    Yp = csc_from_arrays(Yj.m, Yj.n, *Yj.np_arrays())
    with pytest.raises(ValueError, match="tile"):
        pt.SplitBandPoints(Yp, tile=100, device="cpu")
    with pytest.raises(ValueError, match="precision"):
        pt.SplitBandPoints(Yp, precision="bf16", device="cpu")
