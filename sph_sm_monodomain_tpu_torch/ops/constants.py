"""Small constant tensors cached per device.

Building a tensor from Python values on a CUDA device copies it from
pageable host memory, and that copy waits for the stream: on the step path
it would make the host wait for the card every step. The step therefore
takes its few constant vectors from this cache. The cache never evicts: a
captured CUDA graph (models/scan.py) reads these tensors at the addresses
it was captured with, so they must live as long as the process.
"""

from __future__ import annotations

import functools

import torch


@functools.cache
def const_tensor(values: tuple, device: torch.device,
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Read-only tensor of `values` (nested tuples allowed) on `device`.
    Callers must not write into it."""
    return torch.tensor(values, dtype=dtype, device=device)

