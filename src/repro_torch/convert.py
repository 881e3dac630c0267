"""Carry the reference's arrays across into the port's tensors.

The parity tests build inputs once, through the reference's
``make_inputs`` (or a numpy generator), and hand the same values to both
packages. The reference's arrays arrive here as numpy arrays (callers pass
``np.asarray(x)``); this module imports no JAX.

bfloat16 needs a detour: ``np.asarray`` of a JAX bfloat16 array has the
``ml_dtypes`` bfloat16 dtype, which ``torch.from_numpy`` refuses. Such
arrays go through float32 (exact) and then ``.to(torch.bfloat16)`` (exact
again, since every value came from bfloat16).
"""

from __future__ import annotations

from typing import Iterable

import numpy as np
import torch

__all__ = ["from_reference"]


def _tensor(a) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    # A copy: arrays that come from JAX are read-only, and torch tensors
    # over read-only memory are not safe to write.
    return torch.from_numpy(np.array(arr))


def from_reference(
    arrays: Iterable, device: str | torch.device = "cuda"
) -> tuple[torch.Tensor, ...]:
    """The port's tensors on ``device`` for the reference's arrays."""
    return tuple(_tensor(a).to(device) for a in arrays)
