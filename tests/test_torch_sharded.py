"""The sharded studies of the port (``run_sharded`` of ``DCContingency``,
``LinearContingency`` and ``ACContingency``) against the port's own
``run`` on the same outages (exact: each position runs its part through
``run``) and against the JAX package's ``run_sharded`` on its 8 virtual
CPU devices (within 1e-10 of the largest value, ``RTOL``; the masks
exact).  The outage counts are not multiples of the mesh size, so the
padding with repeats of the first outage is dropped on return.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from csparse3_tpu.models import contingency as jc
from csparse3_tpu.models import grids as jg
from csparse3_tpu.models import sensitivity as jsn
from csparse3_tpu_torch.models import contingency as pc
from csparse3_tpu_torch.models import grids as pg
from csparse3_tpu_torch.models import sensitivity as psn
from csparse3_tpu_torch.parallel import Mesh

# one intra-op thread: the suite runs several test processes at once
torch.set_num_threads(1)

S = 8
RTOL = 1e-10

GRIDS = {"ieee14": (jg.ieee14, pg.ieee14),
         "synthetic200": (lambda: jg.synthetic_grid(200, seed=1),
                          lambda: pg.synthetic_grid(200, seed=1))}

# study -> (JAX class, port class, outages of a grid with m branches)
STUDIES = {
    "dc": (jc.DCContingency, pc.DCContingency, lambda m: np.arange(13)),
    "linear": (jsn.LinearContingency, psn.LinearContingency,
               lambda m: np.arange(m)[::-1]),
    "ac": (jc.ACContingency, pc.ACContingency, lambda m: np.arange(5)),
}


def _same(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.shape == r.shape and g.dtype == r.dtype
        # an islanding outage's rows may hold NaN, in both
        torch.testing.assert_close(g, r, rtol=0, atol=0, equal_nan=True)


def _close(got, ref):
    for g, r in zip(got, ref):
        g = g.numpy()
        r = np.asarray(r)
        assert g.shape == r.shape
        if r.dtype == bool:
            assert np.array_equal(g, r)
        else:
            np.testing.assert_allclose(
                g.astype(np.float64), r.astype(np.float64), rtol=0,
                atol=RTOL * max(np.nanmax(np.abs(r)), 1e-300))


# the AC sweep on ieee14 only (test time)
@pytest.mark.parametrize("grid, study", [
    (g, s) for g in GRIDS for s in STUDIES if s != "ac" or g == "ieee14"])
def test_run_sharded(grid, study):
    jcls, pcls, outages = STUDIES[study]
    jgrid, pgrid = (f() for f in GRIDS[grid])
    ks = outages(jgrid.n_branch)
    assert len(ks) % S
    ref = jcls(jgrid).run_sharded(JMesh(np.array(jax.devices()[:S]),
                                        ("rows",)), ks)
    port = pcls(pgrid, device="cpu")
    mesh = Mesh.virtual(S, "cpu")
    got = port.run_sharded(mesh, ks)
    _same(got, port.run(ks))
    _close(got, ref)
    assert all(g.device == torch.device("cpu") for g in got)


def test_run_sharded_empty_and_checks():
    port = pc.DCContingency(pg.ieee14(), device="cpu")
    mesh = Mesh.virtual(4, "cpu")
    _same(port.run_sharded(mesh, []), port.run([]))
    _same(port.run_sharded(mesh), port.run())
    with pytest.raises(IndexError):
        port.run_sharded(mesh, [port.n_branch])
    with pytest.raises(ValueError, match="axis"):
        port.run_sharded(mesh, [0], axis="batch")
    # positions on the study's own device use the study itself
    assert pc._replica(port, "cpu") is port
