"""Published peaks of one NVIDIA H100 SXM and the least time a piece of
work can take on it.

The same figures as the port's chip smoke script: HBM at 3.35 TB/s and
67 T operations/s outside the tensor cores (every kernel measured here is
integer work on the CUDA cores).  They assume the card's full power limit
of 700 W; :func:`power_limit_w` reads the limit the card is set to, which
is printed beside every share of a peak.
"""

from __future__ import annotations

import subprocess
from typing import Optional, Tuple

__all__ = ["HBM_BYTES_PER_S", "CORE_OPS_PER_S", "bound_s", "power_limit_w"]

HBM_BYTES_PER_S = 3.35e12
CORE_OPS_PER_S = 67e12


def bound_s(nbytes: float, ops: float = 0.0) -> Tuple[float, str]:
    """``(seconds, "bytes" | "operations")``: the least time the card could
    take to move ``nbytes`` through device memory and do ``ops``
    operations, and which of the two bounds it."""
    by_bytes = nbytes / HBM_BYTES_PER_S
    by_ops = ops / CORE_OPS_PER_S
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def power_limit_w() -> Optional[float]:
    """The first card's power limit in watts, by ``nvidia-smi``; None where
    it cannot be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout
        return float(out.splitlines()[0].strip())
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None
