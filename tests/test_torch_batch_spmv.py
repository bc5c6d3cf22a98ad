"""The port's batched Ybus products against the JAX package's ``jax.vmap``
of the same one-vector product, and the host helpers of the batched CUDA
kernels' dispatch.

A study (``solve_batch``, the contingencies) multiplies Ybus with a (K, n)
batch of vectors.  The JAX package maps its one-vector plan over the
scenarios with ``jax.vmap``; the port takes the batch as one product (on a
card one launch of the batched kernel, here on the CPU its plain version).
Both get the same numpy inputs from a seed, on the 300-bus synthetic grid
('dia' / 'symdia' in RCM order, as the banded solvers use them).  The JAX
band+points plan runs its Pallas kernels in interpret mode on the CPU.

Tolerances: float64 plans ('dia', 'symdia') within 1e-12 of max|y| (the
two sum each row's terms in other orders); the float32 'bandpoints' plan
within 5e-6 of max|y|, the bound its one-vector tests hold (about 40
float32 ulps of the largest output).  The JAX references are computed once
per module, for the largest K; a smaller batch compares against its first
rows.
"""

import copy

import jax
import numpy as np
import pytest
import torch

from csparse3_tpu.models import grids as jgrids
from csparse3_tpu.models import powerflow as jpf
from csparse3_tpu_torch.kernels import bandpoints as pbp
from csparse3_tpu_torch.kernels import dia as pdia
from csparse3_tpu_torch.models import grids as pgrids
from csparse3_tpu_torch.models import powerflow as ppf
from csparse3_tpu_torch.utils.interop import grid_from_arrays

# one intra-op thread: the suite runs several test processes at once
torch.set_num_threads(1)

KS = (1, 3, 33)
F64_REL = 1e-12
F32_REL = 5e-6
PLANS = ("bandpoints", "dia", "symdia")


@pytest.fixture(scope="module")
def batches():
    """{plan: (port plan, xr, xi, JAX yr, JAX yi)} for K = max(KS)."""
    jg = jgrids.synthetic_grid(300, seed=4)
    out = {}
    for plan in PLANS:
        g = jgrids.rcm_grid(jg)[0] if plan != "bandpoints" else jg
        Yj = jgrids.ybus(g)[0]
        pg = grid_from_arrays(**g._asdict())
        Yp = pgrids.ybus(pg)[0]
        jplan = jpf._make_yplan(Yj, plan)
        real = np.float32 if plan == "bandpoints" else np.float64
        rng = np.random.RandomState(31)
        xr, xi = (rng.randn(max(KS), g.n_bus).astype(real) for _ in range(2))
        yr, yi = jax.vmap(jplan)(xr, xi)
        out[plan] = (ppf._make_yplan(Yp, plan, "cpu"), xr, xi,
                     np.asarray(yr), np.asarray(yi))
    return out


@pytest.mark.parametrize("K", KS)
@pytest.mark.parametrize("plan", PLANS)
def test_batched_product_matches_jax_vmap(batches, plan, K):
    p, xr, xi, jr, ji = batches[plan]
    yr, yi = p(torch.as_tensor(xr[:K]), torch.as_tensor(xi[:K]))
    assert yr.shape == yi.shape == (K, xr.shape[1])
    want = np.stack([jr[:K], ji[:K]])
    got = torch.stack([yr, yi]).numpy()
    assert got.dtype == want.dtype
    rel = F32_REL if plan == "bandpoints" else F64_REL
    assert np.abs(got - want).max() <= rel * np.abs(want).max()


@pytest.mark.parametrize("K,lanes", [(1, 1), (2, 2), (3, 4), (4, 4), (5, 8),
                                     (16, 16), (17, 32), (32, 32), (33, 32),
                                     (256, 32), (65535, 32)])
def test_scenario_lanes_is_the_least_power_of_two_up_to_a_warp(K, lanes):
    assert pbp.scenario_lanes(K) == lanes


def test_scenario_lanes_refuses_an_empty_batch():
    with pytest.raises(ValueError, match="at least one vector"):
        pbp.scenario_lanes(0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_scenario_minor_pairs_puts_a_columns_scenarios_side_by_side(dtype):
    rng = np.random.RandomState(5)
    xr, xi = (torch.as_tensor(rng.randn(3, 7)) for _ in range(2))
    xs = pbp.scenario_minor_pairs(xr, xi, dtype)
    assert xs.shape == (7, 3, 2) and xs.dtype == dtype
    assert xs.is_contiguous()
    for k in range(3):
        assert torch.equal(xs[:, k, 0], xr[k].to(dtype))
        assert torch.equal(xs[:, k, 1], xi[k].to(dtype))


def test_scenario_minor_pairs_refuses_parts_that_are_not_alike():
    with pytest.raises(ValueError, match=r"\(K, n\) alike"):
        pbp.scenario_minor_pairs(torch.zeros(3, 7), torch.zeros(3, 6),
                                 torch.float32)
    with pytest.raises(ValueError, match=r"\(K, n\) alike"):
        pbp.scenario_minor_pairs(torch.zeros(7), torch.zeros(7),
                                 torch.float32)


def test_split_wrapper_refuses_a_scenario_minor_vector(batches):
    p = batches["symdia"][0]
    assert p.shared_runs
    vals = (p.re.run_values, p.im.run_values)
    x = torch.zeros((p.re.n, 2), dtype=torch.float64)
    with pytest.raises(ValueError, match="scenario-minor"):
        pdia.dia_split_cuda(p.re.slabs, p.im.slabs, x, 0, True, p.re.runs,
                            vals, scenario_minor=True)
    # the right shapes on the CPU: the kernel needs the card
    with pytest.raises(ValueError, match="CUDA device"):
        pdia.dia_split_cuda(p.re.slabs, p.im.slabs, x[:, None], 0, True,
                            p.re.runs, vals, scenario_minor=True)


def test_split_wrapper_refuses_a_batch_without_its_entries(batches):
    p = batches["symdia"][0]
    vals = (p.re.run_values, p.im.run_values)
    x = torch.zeros((3, p.re.n, 2), dtype=torch.float64)
    for xn2, minor in ((x, False), (x.transpose(0, 1), True)):
        with pytest.raises(ValueError, match="batch entries"):
            pdia.dia_split_cuda(p.re.slabs, p.im.slabs, xn2, 0, True,
                                p.re.runs, vals, scenario_minor=minor)


# -- the batch entries the batched kernels walk -------------------------------

def _slow_dia_entries(p):
    """The batch entries of a split DIA plan, walked the way the one-vector
    run kernel adds its slots: for each row and lane-set j, the runs j, j +
    P, ... of the group's forward list, then of its mirror list."""
    re, im = p.re, p.im
    m, n, omin, sym = re.m, re.n, re.omin, re.symmetric
    P = pdia.run_parts(m)
    lists = [(re.runs[0], re.runs[1], re.run_values[0], im.run_values[0],
              False)]
    if sym:
        lists.append((re.runs[2], re.runs[3], re.run_values[1],
                      im.run_values[1], True))
    out = {}
    for i in range(m):
        g, lane = divmod(i, pdia.RUN_ROWS)
        for j in range(P):
            ent = []
            for ptr, diag, rv, iv, mirror in lists:
                for r in range(int(ptr[g]) + j, int(ptr[g + 1]), P):
                    d = int(diag[r])
                    col = i - d if mirror else i + omin + d
                    ok = (d > 0 and col >= 0) if mirror else 0 <= col < n
                    a, b = float(rv[r, lane]), float(iv[r, lane])
                    if ok and (a != 0 or b != 0):
                        ent.append((col, a, b))
            out[i, j] = ent
    return out


@pytest.mark.parametrize("plan", ["dia", "symdia"])
def test_dia_batch_entries_are_the_one_vector_lane_sets_nonzero_slots(
        batches, plan):
    p = batches[plan][0]
    eptr, ecol, ere, eim = p.batch_entries()
    assert p.batch_entries()[0] is eptr  # built with the plan, then kept
    assert dict(p.named_buffers())["re.batch_eptr"] is eptr
    m, P = p.re.m, pdia.run_parts(p.re.m)
    assert eptr.shape == (m * P + 1,)
    slow = _slow_dia_entries(p)
    for (i, j), ent in slow.items():
        a, b = int(eptr[i * P + j]), int(eptr[i * P + j + 1])
        got = list(zip(ecol[a:b].tolist(), ere[a:b].tolist(),
                       eim[a:b].tolist()))
        assert got == ent, (i, j)


@pytest.mark.parametrize("plan", ["dia", "symdia"])
def test_dia_batch_entries_are_cast_with_the_plan(batches, plan):
    p = copy.deepcopy(batches[plan][0])
    eptr, ecol, ere, eim = p.batch_entries()
    q = p.float()
    e32 = q.batch_entries()
    assert e32[2].dtype == e32[3].dtype == torch.float32
    assert torch.equal(e32[0], eptr) and torch.equal(e32[1], ecol)
    assert torch.equal(e32[2], ere.float()) and torch.equal(e32[3],
                                                           eim.float())


def test_bandpoints_batch_entries_are_each_rows_terms_in_kernel_order(
        batches):
    p = batches["bandpoints"][0]
    eptr, ecol, ere, eim = p.batch_entries()
    assert dict(p.named_buffers())["b_eptr"] is eptr  # built with the plan
    ptr, col, val = (t.numpy() for t in p._kernel_lists())
    slabs = p.slabs.numpy()
    for i in range(p.m):
        want = [(int(col[e]), float(val[0, e]), float(val[1, e]))
                for e in range(ptr[i], ptr[i + 1])]
        want += [(i + o, float(slabs[0, d, i]), float(slabs[1, d, i]))
                 for d, o in enumerate(p.offs) if 0 <= i + o < p.n]
        a, b = int(eptr[i]), int(eptr[i + 1])
        assert list(zip(ecol[a:b].tolist(), ere[a:b].tolist(),
                        eim[a:b].tolist())) == want, i


@pytest.mark.parametrize("m", [1, 100, 10_000, 16_896, 16_897, 33_792,
                               200_000])
def test_run_parts_splits_lists_while_the_launch_is_short_of_threads(m):
    # the rule of csrc/dia_spmv.cu: double while 8 lane-sets of 4 rows fit a
    # warp and m * parts * 2 stays within 132 * 1024 threads
    parts = pdia.run_parts(m)
    assert parts in (1, 2, 4, 8)
    assert parts == 8 or m * parts * 2 > 132 * 1024
    assert parts == 1 or m * parts <= 132 * 1024
