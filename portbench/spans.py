"""Spans and counters around the calls into the port's flush layer,
recorded from the benchmark's side in a traced run.

``FlushSpans`` wraps ``device/count.py``'s ``SparseSpectrumAccumulator._flush``
(sort, run count, compaction or host filter, host merge) and, inside it,
``finalize_sparse`` (the flush on the device and its pull),
``compact_spectrum`` (the host filter) and ``merge_sorted_spectra`` (the
host merge).  The outer span synchronises the card at its entry and exit,
so its seconds hold the flush's device work and none of the work queued
before it; that changes the run, which is why only the traced run takes
it.  It also reads the program's own counter of flush routes,
``count.FLUSH_ROUTES``.
"""

from __future__ import annotations

import functools
import time
from typing import Dict

from .devtrace import span

__all__ = ["FlushSpans", "flush_share"]


class FlushSpans:
    """Context manager: while open, the flush layer's calls are timed and
    named on the profiler's timeline."""

    def __init__(self, on_cuda: bool) -> None:
        self.on_cuda = on_cuda
        self.seconds = 0.0
        self.calls = 0
        self.routes: Dict[str, int] = {}
        self._saved = []
        self._routes0: Dict[str, int] = {}

    def _sync(self) -> None:
        if self.on_cuda:
            import torch

            torch.cuda.synchronize()

    def _wrap(self, owner, attr: str, name: str, timed: bool = False) -> None:
        inner = getattr(owner, attr)
        outer = self

        @functools.wraps(inner)
        def wrapped(*args, **kwargs):
            if not timed:
                with span(name):
                    return inner(*args, **kwargs)
            outer._sync()
            t0 = time.perf_counter()
            try:
                with span(name):
                    return inner(*args, **kwargs)
            finally:
                outer._sync()
                outer.seconds += time.perf_counter() - t0
                outer.calls += 1

        self._saved.append((owner, attr, inner))
        setattr(owner, attr, wrapped)

    def __enter__(self) -> "FlushSpans":
        from needletail_tpu_torch.device import count

        self._routes0 = dict(count.FLUSH_ROUTES)
        self._wrap(count.SparseSpectrumAccumulator, "_flush",
                   "portbench.flush", timed=True)
        self._wrap(count, "finalize_sparse", "portbench.flush.device")
        self._wrap(count, "compact_spectrum", "portbench.flush.host_filter")
        self._wrap(count, "merge_sorted_spectra", "portbench.flush.merge")
        return self

    def __exit__(self, *exc) -> None:
        from needletail_tpu_torch.device import count

        for owner, attr, inner in reversed(self._saved):
            setattr(owner, attr, inner)
        self._saved.clear()
        self.routes = {
            r: n - self._routes0.get(r, 0) for r, n in count.FLUSH_ROUTES.items()
        }


def flush_share(run):
    """Share of the window spent in the flush, by the span's seconds summed
    over the window; nothing where no flush was timed."""
    if not run.flush_s or run.window_s <= 0:
        return None
    return run.flush_s / run.window_s
