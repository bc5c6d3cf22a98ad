"""The port on a CUDA card: the band+points kernel against its plain
PyTorch version, and the device Newton against the same solve on the CPU.

Every test here needs a card and skips without one.  The file imports
neither jax nor the JAX package, so it runs where only torch is installed:

    python -m pytest -q --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

The kernel and the plain version both sum in float32, in different orders
(and the kernel contracts to FMA), so they are held to 5e-6 of max|y|.
"""

import numpy as np
import pytest
import torch

import csparse3_tpu_torch as pt
from csparse3_tpu_torch.models.grids import ieee14, synthetic_grid, ybus
from csparse3_tpu_torch.models.powerflow import NewtonPowerFlow

REL = 5e-6


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _band(n):
    rows = np.concatenate([np.arange(n), np.arange(1, n), np.arange(n - 1)])
    cols = np.concatenate([np.arange(n), np.arange(n - 1), np.arange(1, n)])
    vals = np.random.RandomState(6).rand(len(rows))
    return pt.from_triplets(rows, cols, vals, (n, n))


CASES = {
    "ybus1037": (lambda: ybus(synthetic_grid(1037, seed=3))[0],
                 dict(tile=128)),
    "groups900": (lambda: ybus(synthetic_grid(900, seed=9))[0],
                  dict(tile=128, group_span=40)),
    "band500": (lambda: _band(500), dict(tile=128)),
    "ybus20000": (lambda: ybus(synthetic_grid(20_000, seed=1))[0], {}),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(CASES))
def test_cuda_kernel_matches_plain(cuda, case):
    make, kw = CASES[case]
    Y = make()
    plan = pt.SplitBandPoints(Y, device=cuda, **kw)
    rng = np.random.RandomState(4)
    xr, xi = (torch.as_tensor(rng.rand(Y.n).astype(np.float32), device=cuda)
              for _ in range(2))
    yk = torch.stack(plan(xr, xi))
    torch.cuda.synchronize()
    assert plan.kernel_launches == plan.n_groups
    yp = torch.stack(plan.plain(xr, xi))
    assert plan.kernel_launches == plan.n_groups
    scale = yp.abs().max().item()
    assert (yk - yp).abs().max().item() <= REL * scale


@pytest.mark.gpu
def test_cuda_input_never_reaches_plain_version(cuda, monkeypatch):
    plan = pt.SplitBandPoints(ybus(synthetic_grid(1037, seed=3))[0],
                              device=cuda)

    def refuse(*a):
        raise AssertionError("plain version ran on a CUDA input")

    monkeypatch.setattr(plan, "plain", refuse)
    x = torch.rand(1037, device=cuda)
    for k in range(1, 4):
        plan(x, x)
        assert plan.kernel_launches == k
    with pytest.raises(ValueError, match="CUDA device"):
        plan(x.cpu(), x)


@pytest.mark.gpu
@pytest.mark.parametrize("spmv", ["ell", "bandpoints"])
def test_newton_on_cuda_matches_cpu(cuda, spmv):
    for g in (ieee14(), synthetic_grid(2000, seed=3)):
        tol = 5e-5 if spmv == "bandpoints" else 1e-10
        pf = NewtonPowerFlow(g, spmv=spmv, tol=tol, device=cuda)
        vm, va, it, res = pf.solve()
        vm_c, va_c, it_c, res_c = NewtonPowerFlow(g, spmv=spmv,
                                                  tol=tol).solve()
        assert res <= tol and res_c <= tol
        atol = 1e-5 if spmv == "bandpoints" else 1e-10
        np.testing.assert_allclose(vm, vm_c, rtol=0, atol=atol)
        np.testing.assert_allclose(va, va_c, rtol=0, atol=atol)
        if spmv == "bandpoints":
            assert pf._yplan.kernel_launches == it + 1
