"""Arithmetic of the end-to-end metrics and of the device timeline:
window, rate, percentile and the union of intervals."""

from __future__ import annotations

from typing import Iterable, List, Sequence, Tuple

__all__ = ["window_s", "rate", "percentile", "union_length", "gaps"]


def window_s(jobs: Sequence[Tuple[float, float]]) -> float:
    """Seconds from the first job's start to the last job's end, of
    ``(start, end)`` pairs."""
    if not jobs:
        return 0.0
    return max(e for _, e in jobs) - min(s for s, _ in jobs)


def rate(amount: float, seconds: float) -> float:
    """``amount`` per second; 0 for an empty window."""
    return amount / seconds if seconds > 0 else 0.0


def percentile(values: Sequence[float], q: float) -> float:
    """The ``q``-th percentile (0-100), interpolated linearly between the
    two nearest ranks as NumPy's default does."""
    if not values:
        raise ValueError("percentile of no values")
    xs = sorted(values)
    pos = (len(xs) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def _merged(intervals: Iterable[Tuple[float, float]], lo: float, hi: float
            ) -> List[Tuple[float, float]]:
    """The union of ``intervals`` clipped to ``[lo, hi]``, as sorted
    disjoint intervals."""
    out: List[Tuple[float, float]] = []
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def union_length(intervals: Iterable[Tuple[float, float]], lo: float,
                 hi: float) -> float:
    """Length of the union of ``intervals`` inside ``[lo, hi]``: time in
    which at least one of them was running, overlaps counted once."""
    return sum(e - s for s, e in _merged(intervals, lo, hi))


def gaps(intervals: Iterable[Tuple[float, float]], lo: float, hi: float
         ) -> List[Tuple[float, float]]:
    """The stretches of ``[lo, hi]`` that no interval covers."""
    out = []
    at = lo
    for s, e in _merged(intervals, lo, hi):
        if s > at:
            out.append((at, s))
        at = max(at, e)
    if hi > at:
        out.append((at, hi))
    return out
