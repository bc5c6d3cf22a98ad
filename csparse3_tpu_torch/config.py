"""Global configuration for the PyTorch port.

The JAX package's ``Config`` also selects a compute backend ('xla',
'pallas' or 'numpy'); the port has none to select: host work is numpy,
device work is torch, and a CUDA kernel runs exactly when its input lies
on a CUDA device.  What stays is the index dtype of host construction
(``ops.construct``), with the JAX package's default; the other fields
come back with the modules that read them.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["Config", "get_config"]


@dataclasses.dataclass
class Config:
    # numpy dtype of CSC/CSR index arrays built on the host
    index_dtype: np.dtype = np.int32


_config = Config()


def get_config() -> Config:
    return _config
