"""The device's timeline over a measured window, from ``torch.profiler``.

The profile opens with a warm-up step of spin kernels whose records it
discards, as the port's chip smoke script does: a profiling session that
records from its start, late in a process, has been seen to lose the
device records of its first kernels.  Busy time is the union of the
intervals in which a kernel, a copy or a memset ran, so that work on two
streams at once counts once; the window is the benchmark's own
``portbench.window`` span on the same clock.
"""

from __future__ import annotations

import contextlib
import re
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

from . import stats

__all__ = ["DeviceTrace", "record", "span", "WINDOW", "SPIN_KERNELS"]

# the discarded warm-up step's spin kernels
SPIN_KERNELS = 256
WINDOW = "portbench.window"


@dataclass
class DeviceTrace:
    """Device operations ``(name, start_s, end_s)`` and the benchmark's
    host spans ``(name, start_s, end_s)``, on the profiler's clock, and
    the window's bounds on it."""

    ops: List[Tuple[str, float, float]] = field(default_factory=list)
    spans: List[Tuple[str, float, float]] = field(default_factory=list)
    window: Tuple[float, float] = (0.0, 0.0)

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def busy_s(self) -> float:
        """Seconds of the window in which some device operation ran."""
        return stats.union_length(
            ((s, e) for _, s, e in self.ops), *self.window
        )

    def seconds_matching(self, patterns: Sequence[str]) -> Tuple[float, int]:
        """Summed device seconds and count of the operations inside the
        window whose name matches one of the regular expressions."""
        regs = [re.compile(p) for p in patterns]
        lo, hi = self.window
        total, n = 0.0, 0
        for name, s, e in self.ops:
            if s >= lo and e <= hi and any(r.search(name) for r in regs):
                total += e - s
                n += 1
        return total, n

    def top_ops(self, n: int = 10, width: int = 160) -> List[list]:
        """The ``n`` device operations that took most time in the window,
        summed by name: ``[[name, seconds], ...]``."""
        lo, hi = self.window
        by_name: Dict[str, float] = {}
        for name, s, e in self.ops:
            if s >= lo and e <= hi:
                by_name[name] = by_name.get(name, 0.0) + (e - s)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:width], sec] for name, sec in top]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """The ``n`` longest stretches of the window with no device
        operation, each named by the innermost host span around its
        middle: ``[[name, seconds], ...]``."""
        found = stats.gaps(((s, e) for _, s, e in self.ops), *self.window)
        found.sort(key=lambda g: g[0] - g[1])
        out = []
        for s, e in found[:n]:
            mid = (s + e) / 2
            inner = [sp for sp in self.spans
                     if sp[1] <= mid <= sp[2] and sp[0] != WINDOW]
            name = min(inner, key=lambda sp: sp[2] - sp[1])[0] if inner else "between jobs"
            out.append([name, e - s])
        return out


def _bounds(evt) -> Tuple[float, float]:
    """An event's start and end in seconds on the profiler's clock."""
    if hasattr(evt, "start_ns"):
        start = evt.start_ns() / 1e9
        return start, start + evt.duration_ns() / 1e9
    start = evt.start_us() / 1e6
    return start, start + evt.duration_us() / 1e6


def _collect(prof) -> DeviceTrace:
    """Sort the profile's events into device operations and the
    benchmark's host spans.  An annotation is never an operation: the
    profiler mirrors each host span (``portbench.*``, ``ProfilerStep*``)
    onto the device's timeline, where it would cover the work inside it."""
    trace = DeviceTrace()
    for evt in prof.profiler.kineto_results.events():
        name = evt.name()
        if "CUDA" in str(evt.device_type()):
            kind = str(evt.activity_type()) if hasattr(evt, "activity_type") else ""
            if (
                "annotation" in kind
                or name.startswith(("portbench.", "ProfilerStep"))
                or (hasattr(evt, "is_user_annotation") and evt.is_user_annotation())
            ):
                continue
            trace.ops.append((name, *_bounds(evt)))
        elif name.startswith("portbench."):
            trace.spans.append((name, *_bounds(evt)))
            if name == WINDOW:
                trace.window = trace.spans[-1][1:]
    return trace


@contextlib.contextmanager
def span(name: str) -> Iterator[None]:
    """A host span on the profiler's timeline (a no-op when no profile
    is recording)."""
    import torch

    with torch.profiler.record_function(name):
        yield


@contextlib.contextmanager
def record(on_cuda: bool) -> Iterator[List[Optional[DeviceTrace]]]:
    """Profile the body; the yielded list holds the :class:`DeviceTrace`
    once the body has ended.  The body wraps its window in
    ``span(WINDOW)``."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    activities = [ProfilerActivity.CPU]
    if on_cuda:
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    out: List[Optional[DeviceTrace]] = [None]
    with profile(
        activities=activities,
        schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
    ) as prof:
        if on_cuda:
            for _ in range(SPIN_KERNELS):
                torch.cuda._sleep(100)
            torch.cuda.synchronize()
        prof.step()
        yield out
        if on_cuda:
            torch.cuda.synchronize()
        prof.step()
    out[0] = _collect(prof)
