"""Experiments of the port that run only on the card, and the timing
helpers they share with ``chip_smoke.py``."""

from __future__ import annotations

import subprocess
from typing import Callable

__all__ = ["card_line", "cuda_ms"]


def card_line() -> str:
    """``name, power limit`` of the first card, as ``nvidia-smi`` gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


# a spin of about 50 ms at the H100's 1.98 GHz: longer than the host
# takes to queue the timed calls
BACKLOG_CYCLES = 100_000_000


def cuda_ms(fn: Callable[[], object], reps: int, warmup: int = 2) -> float:
    """Mean milliseconds of ``fn()`` on the card, by CUDA events.

    The timed calls are queued behind a spin kernel, so the card runs them
    back to back and the events time its work, not the host's launch rate:
    a call that takes the card less time than its Python wrapper takes the
    host would otherwise read as the wrapper's time.  A call that waits on
    the card itself still counts the gaps it makes."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(BACKLOG_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps
