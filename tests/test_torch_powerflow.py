"""The slice as a whole: the port's Newton power flow against the JAX
package's on the same grids.

'ell' runs in float64 on both sides and agrees to 1e-10.  'bandpoints'
computes the Ybus SpMV in float32 by design on both sides, so the Newton
mismatch floors near float32 precision (~2e-5 here) and both runs stop at
``max_iter`` jittering at that floor; the states agree to 1e-5.
"""

import jax  # noqa: F401  (JAX on the CPU with x64, set up by conftest)
import numpy as np
import pytest
import torch

from csparse3_tpu.models import grids as jgrids
from csparse3_tpu.models import powerflow as jpf
from csparse3_tpu_torch.models import grids as pgrids
from csparse3_tpu_torch.models import powerflow as ppf


def test_newton_ell_matches_jax_ieee14():
    vm_p, va_p, it_p, res_p = ppf.NewtonPowerFlow(pgrids.ieee14()).solve()
    vm_j, va_j, it_j, res_j = jpf.NewtonPowerFlow(jgrids.ieee14()).solve()
    assert it_p == it_j and res_p < 1e-10
    np.testing.assert_allclose(vm_p, vm_j, rtol=0, atol=1e-10)
    np.testing.assert_allclose(va_p, va_j, rtol=0, atol=1e-10)


def test_newton_bandpoints_matches_jax_synthetic200():
    gp, gj = pgrids.synthetic_grid(200, seed=7), jgrids.synthetic_grid(
        200, seed=7)
    pf = ppf.NewtonPowerFlow(gp, spmv="bandpoints")
    vm_p, va_p, it_p, res_p = pf.solve()
    vm_j, va_j, it_j, res_j = jpf.NewtonPowerFlow(gj, spmv="bandpoints").solve()
    assert res_p < 1e-4 and res_j < 1e-4
    np.testing.assert_allclose(vm_p, vm_j, rtol=0, atol=1e-5)
    np.testing.assert_allclose(va_p, va_j, rtol=0, atol=1e-5)
    # on the CPU the plan ran its plain version: nothing was launched
    assert pf._yplan.kernel_launches == 0


def test_newton_raphson_matches_jax():
    vm_p, va_p, it_p, res_p = ppf.newton_raphson(pgrids.ieee14())
    vm_j, va_j, it_j, res_j = jpf.newton_raphson(jgrids.ieee14())
    assert it_p == it_j and res_p < 1e-10
    np.testing.assert_allclose(vm_p, vm_j, rtol=0, atol=1e-10)
    np.testing.assert_allclose(va_p, va_j, rtol=0, atol=1e-10)


def test_device_jacobian_values_match_host_jacobian():
    g = pgrids.synthetic_grid(300, seed=4)
    pf = ppf.NewtonPowerFlow(g)
    rng = np.random.default_rng(1)
    vm = g.vm0 * (1 + 0.01 * rng.standard_normal(g.n_bus))
    va = 0.05 * rng.standard_normal(g.n_bus)
    v = vm * np.exp(1j * va)
    ibus = pf.Y.to_scipy() @ v
    J = ppf._jacobian(pf.Y, v, ibus, np.concatenate([g.pv, g.pq]), g.pq)
    vr, vi, ir, ii = (torch.as_tensor(np.ascontiguousarray(a))
                      for a in (v.real, v.imag, ibus.real, ibus.imag))
    jd = pf._jac_data(vr, vi, torch.as_tensor(vm), ir, ii)
    np.testing.assert_allclose(jd.numpy(), J.np_arrays()[2], rtol=1e-12,
                               atol=1e-12)


@pytest.mark.parametrize("kw", [dict(spmv="dia"), dict(spmv="symdia"),
                                dict(solver="blocklu"),
                                dict(solver="multifrontal")])
def test_options_of_later_slices_are_refused(kw):
    with pytest.raises(NotImplementedError, match="not ported yet"):
        ppf.NewtonPowerFlow(pgrids.ieee14(), **kw)
