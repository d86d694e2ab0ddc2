"""Throughput metering and the ``torch.profiler`` trace hook of the port.

The port's copy of the JAX package's ``utils/profiling.py``: per-stage
seconds, bytes and items behind the drivers' ``meter=`` argument, and
``trace(log_dir)``, whose device trace comes from ``torch.profiler`` where
the JAX package's comes from ``jax.profiler``.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Dict, Iterator, Optional

__all__ = ["ThroughputMeter", "trace", "metered_iter"]


@dataclass
class _Stage:
    seconds: float = 0.0
    bytes: int = 0
    items: int = 0


@dataclass
class ThroughputMeter:
    """Accumulate per-stage wall time + byte/item counts.

    >>> meter = ThroughputMeter()
    >>> with meter.stage("frame", nbytes=len(chunk)):
    ...     frame(chunk)                                   # doctest: +SKIP
    >>> meter.report()                                     # doctest: +SKIP
    """

    stages: Dict[str, _Stage] = field(default_factory=dict)

    @contextlib.contextmanager
    def stage(self, name: str, nbytes: int = 0, items: int = 0) -> Iterator[None]:
        st = self.stages.setdefault(name, _Stage())
        t0 = time.perf_counter()
        try:
            yield
        finally:
            st.seconds += time.perf_counter() - t0
            st.bytes += nbytes
            st.items += items

    def add(self, name: str, seconds: float, nbytes: int = 0, items: int = 0) -> None:
        st = self.stages.setdefault(name, _Stage())
        st.seconds += seconds
        st.bytes += nbytes
        st.items += items

    def report(self) -> str:
        lines = []
        for name, st in self.stages.items():
            rate = st.bytes / st.seconds / 1e6 if st.seconds and st.bytes else 0.0
            items = f" {st.items/st.seconds:,.0f} items/s" if st.items and st.seconds else ""
            lines.append(f"{name:>16}: {st.seconds:8.3f}s {rate:10.1f} MB/s{items}")
        return "\n".join(lines)

    def as_dict(self) -> Dict[str, Dict[str, float]]:
        """JSON-ready per-stage breakdown: seconds, bytes, MB/s, items/s."""
        out: Dict[str, Dict[str, float]] = {}
        for name, st in self.stages.items():
            d: Dict[str, float] = {"s": round(st.seconds, 4)}
            if st.bytes:
                d["bytes"] = st.bytes
                if st.seconds:
                    d["mb_per_s"] = round(st.bytes / st.seconds / 1e6, 1)
            if st.items:
                d["items"] = st.items
                if st.seconds:
                    d["items_per_s"] = round(st.items / st.seconds, 1)
            out[name] = d
        return out


def metered_iter(meter, name, source, nbytes_of=None, items_of=None):
    """Wrap an iterable so the time spent producing each element (the
    ``next()`` call — e.g. host framing, or waiting on a feeder queue) is
    charged to ``meter`` stage ``name``.  ``meter=None`` passes ``source``
    through untouched."""
    if meter is None:
        return source

    def gen():
        it = iter(source)
        while True:
            t0 = time.perf_counter()
            try:
                item = next(it)
            except StopIteration:
                return
            dt = time.perf_counter() - t0
            meter.add(
                name,
                dt,
                nbytes=nbytes_of(item) if nbytes_of else 0,
                items=items_of(item) if items_of else 0,
            )
            yield item

    return gen()


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None) -> Iterator[None]:
    """``torch.profiler`` trace context writing a TensorBoard trace into
    ``log_dir`` (the card's kernels too where CUDA is available); no-op
    when ``log_dir`` is None."""
    if log_dir is None:
        yield
        return
    import torch
    from torch.profiler import (
        ProfilerActivity, profile, tensorboard_trace_handler,
    )

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield
