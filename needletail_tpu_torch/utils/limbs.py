"""Counting state across the two packages.

The JAX package keeps 64-bit tables and tallies as ``(lo, hi)`` uint32 limb
pairs, because its device runs 32-bit lanes.  The port keeps plain int64
tensors.  These functions carry a JAX state into the port's form and back.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

__all__ = ["limbs_to_int64_array", "int64_array_to_limbs"]


def limbs_to_int64_array(
    lo, hi, device: Optional[Union[str, torch.device]] = None
) -> torch.Tensor:
    """int64 tensor from uint32 limb arrays (numpy, or anything
    ``np.asarray`` takes, such as JAX arrays)."""
    t = np.asarray(lo).astype(np.int64) + (np.asarray(hi).astype(np.int64) << 32)
    return torch.from_numpy(t).to(device or "cpu")


def int64_array_to_limbs(table) -> Tuple[np.ndarray, np.ndarray]:
    """Split a non-negative int64 table (tensor or array) into ``(lo, hi)``
    uint32 numpy arrays, the JAX drivers' state."""
    if isinstance(table, torch.Tensor):
        table = table.detach().cpu().numpy()
    t = np.asarray(table).astype(np.int64, copy=False)
    return (t & 0xFFFFFFFF).astype(np.uint32), (t >> 32).astype(np.uint32)
