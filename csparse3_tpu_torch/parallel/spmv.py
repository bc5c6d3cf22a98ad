"""Distributed SpMV / SpMM over a mesh.

The JAX package's ``csparse3_tpu/parallel/spmv.py``, ported.  y = A x with
A row-partitioned (``parallel/partition.py``) and x, y split by row
blocks over the mesh positions.  Two strategies:

* **ring**: the d = 0 (local) group is contracted first, then k steps of
  a forward and a backward ring shift (``mesh.ppermute``) bring the x
  slices of the neighbours at distance 1..k, each contracted as it
  arrives;
* **allgather**: one ``all_gather`` of x, then one contraction with
  global column ids.

A contraction is ``index_select`` of x at the group's columns, times the
values, ``index_add_`` into ``mloc + 1`` rows (padding lands in the dummy
slot, dropped).  Real or complex values, one or B right-hand sides.

``spmv_local(part, xs, mesh)`` takes and returns the per-position list:
the piece the distributed solvers compose.  ``dist_spmv`` splits a padded
vector over the mesh and returns the padded product on the mesh's first
device.

The products are differentiable, as ``jax.grad`` differentiates the JAX
package's: in x, and in the partition's values when they are a tensor
that requires a gradient (``RowPartition.with_values``).  Autograd
follows the gathers, the scatter-adds and the copies between positions,
so the backward is the transposed scatter with each ring shift run the
other way.  A call with no input that requires a gradient runs under
inference mode.
"""

from __future__ import annotations

import torch

from ..ops.matvec import _recorded
from .mesh import all_gather, ppermute
from .partition import RowPartition

__all__ = ["spmv_local", "dist_spmv", "dist_spmm"]


def _contract(er, ec, ev, xs, mloc):
    """Scatter-add of one entry group: er / ec / ev (E,), xs (mloc,) or
    (mloc, B).  Padding rows carry er == mloc and land in the dummy slot."""
    vals = ev if xs.ndim == 1 else ev[:, None]
    contrib = vals * xs.index_select(0, ec)
    y = contrib.new_zeros((mloc + 1,) + tuple(xs.shape[1:]))
    return y.index_add_(0, er, contrib)[:mloc]


def spmv_local(part: RowPartition, xs, mesh):
    """Per-position SpMV: ``xs`` one (mloc,) or (mloc, B) tensor per mesh
    position, on its device; returns the list of y slices."""
    with _recorded(part.e_vals, *xs):
        return _spmv_local(part, xs, mesh)


def _spmv_local(part, xs, mesh):
    leaves = part.local(mesh)
    mloc, k = part.mloc, part.k
    if part.strategy == "allgather":
        x_full = all_gather(xs, tiled=True)
        return [_contract(er, ec, ev, xf, mloc)
                for (er, ec, ev), xf in zip(leaves, x_full)]

    # ring: group g holds offset d = g - k
    ys = [_contract(er[k], ec[k], ev[k], x, mloc)
          for (er, ec, ev), x in zip(leaves, xs)]
    x_fwd = x_bwd = xs
    for step in range(1, k + 1):
        x_fwd = ppermute(x_fwd, +1)   # x of position (me - step)
        x_bwd = ppermute(x_bwd, -1)   # x of position (me + step)
        ys = [y + _contract(er[k - step], ec[k - step], ev[k - step], xf,
                            mloc)
              for y, (er, ec, ev), xf in zip(ys, leaves, x_fwd)]
        ys = [y + _contract(er[k + step], ec[k + step], ev[k + step], xb,
                            mloc)
              for y, (er, ec, ev), xb in zip(ys, leaves, x_bwd)]
    return ys


def dist_spmv(part: RowPartition, x, mesh, axis: str = "rows"):
    """y = A x with A row-partitioned over ``mesh`` (axis name ``axis``).

    x: (m,) or padded (m_pad,), numpy or a tensor; also multi-RHS (m, B).
    Returns the padded (m_pad[, B]) product on the mesh's first device."""
    mesh.check_axis(axis)
    dev0 = mesh.devices[0]
    with _recorded(part.e_vals, x):
        x = torch.as_tensor(part.pad_vector(x), device=dev0)
        ys = spmv_local(part, mesh.scatter(x, part.mloc), mesh)
        return torch.cat([y.to(dev0) for y in ys])


def dist_spmm(part: RowPartition, X, mesh, axis: str = "rows"):
    """Multi-RHS distributed SpMM: X (m, B) -> (m_pad, B)."""
    return dist_spmv(part, X, mesh, axis)
