"""Global configuration for the PyTorch port.

The JAX package's ``Config`` also selects a compute backend ('xla',
'pallas' or 'numpy'); the port has none to select: host work is numpy,
device work is torch, and a CUDA kernel runs exactly when its input lies
on a CUDA device.  What stays is the index dtype of host construction
(``ops.construct``), the value dtype of the constructors that take
none, and the default BSR block shape, with the JAX package's
defaults.  Its ``growth`` and ``deterministic`` fields are read by no
module of the JAX package and are not kept.  ``update`` and ``config_ctx``
set fields as the JAX package's do.

``default_device`` is where every entry point of the port runs when the
caller names no device: the CUDA card.  There is no quiet CPU default: a
caller without a card (the tests, a host-only user) passes
``device="cpu"``.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

__all__ = ["Config", "get_config", "update", "config_ctx", "default_device",
           "resolve_device"]


@dataclasses.dataclass
class Config:
    # numpy dtype of CSC/CSR index arrays built on the host
    index_dtype: np.dtype = np.int32
    # numpy dtype of the values ``eye``, ``diag`` and ``random_csc`` make
    # when the caller names none
    value_dtype: np.dtype = np.float64
    # (R, C) of ``csc_to_bsr`` when the caller names no block
    bsr_block: tuple = (8, 128)


_config = Config()


def get_config() -> Config:
    return _config


def update(**kw) -> Config:
    """Set fields of the global config; an unknown field raises
    ValueError."""
    for k, v in kw.items():
        if not hasattr(_config, k):
            raise ValueError(f"unknown config field: {k}")
        setattr(_config, k, v)
    return _config


@contextlib.contextmanager
def config_ctx(**kw):
    """``update(**kw)`` for the body of a ``with``, the old values restored
    on exit."""
    old = {k: getattr(_config, k) for k in kw}
    try:
        update(**kw)
        yield _config
    finally:
        update(**old)


def default_device() -> torch.device:
    """The device of every ``device=None``: the CUDA card.  Raises where
    there is none, naming the way to ask for the CPU."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "csparse3_tpu_torch runs on the CUDA card by default and "
            "torch.cuda.is_available() is False; pass device=\"cpu\" to "
            "run on the CPU")
    return torch.device("cuda")


def resolve_device(device=None, like=None) -> torch.device:
    """``device`` as a torch.device.  None is the device of ``like`` (a
    container that was placed explicitly or built from tensors), else
    ``default_device()``."""
    if device is not None:
        return torch.device(device)
    placed = getattr(like, "_device", None)
    return default_device() if placed is None else placed
