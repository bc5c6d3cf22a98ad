"""What the studies share: the port's ``Grid`` from the arrays, and pinned
host buffers for the results copied from the card."""

from __future__ import annotations

import torch


def port_grid(arrays: dict):
    """The grid arrays as the program's ``Grid``."""
    from csparse3_tpu_torch.models.grids import Grid

    return Grid(n_bus=arrays["n_bus"],
                **{k: arrays[k] for k in Grid._fields if k != "n_bus"})


def host_buffer(shape, dtype):
    """A pinned host tensor for results copied from the card: one DMA."""
    return torch.empty(shape, dtype=dtype, pin_memory=True)


def to_host(bufs: dict, tensors: dict, device) -> dict:
    """Copy each tensor into its buffer, wait, and return numpy views."""
    for k, t in tensors.items():
        bufs[k].copy_(t, non_blocking=True)
    torch.cuda.synchronize(device)
    return {k: b.numpy() for k, b in bufs.items()}
