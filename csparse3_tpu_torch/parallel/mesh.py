"""A one-axis device mesh driven by one process, and its collectives.

The JAX package's distributed layer runs one Python process over a
``jax.sharding.Mesh`` of devices and writes each shard's program once,
under ``shard_map``, with ``lax.ppermute`` / ``all_gather`` / ``psum`` /
``axis_index`` between the shards.  The port keeps the single controller
and makes the shards explicit:

* ``Mesh(devices=None, axis="rows")`` is a tuple of torch devices, one per
  mesh position; None means every visible CUDA device (raising where there
  is none, as ``config.default_device``).  ``Mesh.virtual(S, device)``
  repeats one device S times, the counterpart of the JAX tests'
  ``--xla_force_host_platform_device_count=8``: the same code then runs on
  one card or on several.
* A sharded value is a list with one tensor per position, on that
  position's device; the position's index in the list is its
  ``axis_index``.
* A replicated value is held once per distinct device: positions that
  share a device share one tensor (``replicate`` gives a dict keyed by
  device).
* The collectives below copy between positions: a peer copy where the
  devices differ, the tensor itself where they are the same.  They run
  outside any kernel.

Only one-axis meshes exist: every distributed path of the JAX package
takes a one-axis mesh.
"""

from __future__ import annotations

import torch

from ..config import default_device, resolve_device

__all__ = ["Mesh", "ppermute", "all_gather", "psum", "replicate"]


def _norm(device) -> torch.device:
    """A torch.device with the index of a bare 'cuda' filled in."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


class Mesh:
    """One-axis mesh of torch devices (see the module docstring).

    ``devices``: the position devices (None: every visible CUDA device);
    ``axis``: the axis name, checked by the distributed entry points that
    take one.  ``.shape`` is ``{axis: S}`` and ``.size`` is S."""

    def __init__(self, devices=None, axis: str = "rows"):
        if devices is None:
            default_device()   # raises without a card
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
        self.devices = tuple(_norm(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.axis_names = (str(axis),)
        self.shape = {self.axis_names[0]: len(self.devices)}

    @classmethod
    def virtual(cls, S: int, device=None, axis: str = "rows") -> "Mesh":
        """S positions on one device (None: ``config.default_device()``)."""
        if int(S) < 1:
            raise ValueError(f"a mesh needs at least one position, got {S}")
        return cls([resolve_device(device)] * int(S), axis=axis)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def distinct(self):
        """The distinct devices, in the order of their first position."""
        return tuple(dict.fromkeys(self.devices))

    def check_axis(self, axis):
        """The mesh's axis name; ``axis`` (None: the mesh's own) must be
        it."""
        if axis is not None and axis not in self.axis_names:
            raise ValueError(f"mesh has axis {self.axis_names[0]!r}, not "
                             f"{axis!r}")
        return self.axis_names[0]

    def scatter(self, x, rows: int):
        """Split the leading axis of ``x`` into S consecutive pieces of
        ``rows`` rows, piece s on position s's device."""
        return [x[s * rows:(s + 1) * rows].to(d)
                for s, d in enumerate(self.devices)]

    def __repr__(self):
        return (f"Mesh(S={self.size}, axis={self.axis_names[0]!r}, "
                f"devices={[str(d) for d in self.distinct]})")


def replicate(x, devices):
    """``x`` once on each distinct device of ``devices``: a dict keyed by
    device (the tensor itself on its own device)."""
    return {d: x.to(d) for d in dict.fromkeys(devices)}


def ppermute(xs, shift: int):
    """Ring shift of a sharded value: position s receives the tensor of
    position s - shift (mod S), as ``lax.ppermute`` with the pairs
    ``[(i, (i + shift) % S)]``."""
    S = len(xs)
    return [xs[(s - shift) % S].to(xs[s].device) for s in range(S)]


def all_gather(xs, tiled: bool = False):
    """Every position's tensor on every position, as ``lax.all_gather``:
    stacked on a new leading axis, or joined along the leading axis when
    ``tiled``.  Positions on one device share the result."""
    join = torch.cat if tiled else torch.stack
    per = {d: join([x.to(d) for x in xs]) for d in dict.fromkeys(
        x.device for x in xs)}
    return [per[x.device] for x in xs]


def psum(xs):
    """The sum of the S parts, added in position order, on every position
    (``lax.psum``).  Positions on one device share the result."""
    per = {}
    for d in dict.fromkeys(x.device for x in xs):
        total = xs[0].to(d)
        for x in xs[1:]:
            total = total + x.to(d)
        per[d] = total
    return [per[x.device] for x in xs]
