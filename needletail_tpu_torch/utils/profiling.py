"""Throughput metering, spans and the ``torch.profiler`` trace hook of the
port.

The port's copy of the JAX package's ``utils/profiling.py``: per-stage
seconds, bytes and items behind the drivers' ``meter=`` argument, and
``trace(log_dir)``, whose device trace comes from ``torch.profiler`` where
the JAX package's comes from ``jax.profiler``.  :func:`span` marks one
layer's work at once on the profiler's timeline (``needletail.<name>``,
beside the card's kernels and copies) and in a meter's stage ``<name>``.
"""

from __future__ import annotations

import contextlib
import functools
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, Iterator, Optional

__all__ = ["ThroughputMeter", "trace", "metered_iter", "span", "spanned"]


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


class _Span:
    """One open span: a ``record_function`` on the timeline while a profile
    records this thread, and the seconds, bytes and items added to
    ``meter``'s stage on exit.  ``nbytes`` and ``items`` may be set inside
    the body, where they are known only once the work is done; a body that
    sets ``meter`` to None records nothing into it."""

    __slots__ = ("name", "meter", "nbytes", "items", "_t0", "_rf")

    def __init__(self, name, meter, nbytes, items, recording) -> None:
        self.name = name
        self.meter = meter
        self.nbytes = nbytes
        self.items = items
        self._rf = None
        if recording:
            from torch.autograd.profiler import record_function

            self._rf = record_function("needletail." + name)

    def __enter__(self) -> "_Span":
        if self._rf is not None:
            self._rf.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        seconds = time.perf_counter() - self._t0
        if self._rf is not None:
            self._rf.__exit__(*exc)
        if self.meter is not None:
            self.meter.add(self.name, seconds, nbytes=self.nbytes,
                           items=self.items)


class _NoSpan:
    """What :func:`span` returns where nothing would read it: a context
    that does nothing, whose counters take writes and drop them."""

    __slots__ = ("meter", "nbytes", "items")

    def __enter__(self) -> "_NoSpan":
        return self

    def __exit__(self, *exc) -> None:
        pass


_NO_SPAN = _NoSpan()

# torch's test of whether a profile records the calling thread, bound at
# the first span after torch has been loaded: this module never loads it
_recording = None


def span(name: str, meter=None, nbytes: int = 0, items: int = 0):
    """Context manager around one layer's work.

    While a ``torch.profiler`` session records the calling thread it opens
    ``record_function("needletail." + name)``, on the clock of the device
    trace's kernels and copies (a thread the profile did not start, such
    as a feeder, is not recorded).  With a ``meter`` it adds the body's
    ``time.perf_counter`` seconds, ``nbytes`` and ``items`` to the meter's
    stage ``name``, from any thread.  With neither it costs one test.
    """
    global _recording
    if _recording is None and "torch" in sys.modules:
        _recording = sys.modules["torch"]._C._autograd._profiler_enabled
    recording = _recording is not None and _recording()
    if meter is None and not recording:
        return _NO_SPAN
    return _Span(name, meter, nbytes, items, recording)


def spanned(name: str):
    """Decorator: each call of the function runs inside ``span(name)``."""

    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return call

    return wrap


def metered_iter(meter, name, source, nbytes_of=None, items_of=None):
    """Wrap an iterable so the time spent producing each element (the
    ``next()`` call — e.g. host framing, or waiting on a feeder queue) is
    charged to ``meter`` stage ``name`` and spans ``name`` on the profiler's
    timeline (the timeline alone with ``meter=None``); the call that finds
    the source exhausted is not charged to the meter."""

    def gen():
        it = iter(source)
        while True:
            with span(name, meter) as sp:
                try:
                    item = next(it)
                except StopIteration:
                    sp.meter = None
                    return
                if nbytes_of:
                    sp.nbytes = nbytes_of(item)
                if items_of:
                    sp.items = items_of(item)
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
