"""The per-rank spectrum resolver of the sharded exact paths.

Counterpart of ``needletail_tpu/parallel/_resolve.py``.  ``exact.py`` and
``multik.py`` end a flush the same way: this rank's lexicographic sort and
run-length count (``count.unique_counts``), then, on the card, the run
heads moved to a front prefix so only distinct entries cross to the host:
two passes of the slot-compaction kernel (``csrc/compact_slots.cu``, 8x
each) before a stable partition of what is left, or the stable partition
of the whole sorted stream when a 1024-lane chunk holds more run heads
than its slots.

Every rank takes the same route: the two passes' overflow flags are
all-reduced over ``data`` before any rank chooses, as JAX ``psum``s them.

``narrow=True`` (keys that fit one uint32, k <= 15) drops the hi plane
end to end.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.distributed as dist

from ..device import count as _count
from .mesh import mesh_device

__all__ = ["make_sharded_resolver"]

ResolveFn = Callable[..., Optional[Tuple]]


def make_sharded_resolver(
    mesh, device_compact: bool, cascade: bool, narrow: bool = False
) -> ResolveFn:
    """Build ``resolve(buf_hi, buf_lo) -> (hi_c, lo_c, counts_c, n)`` (or,
    with ``narrow``, ``resolve(buf_lo) -> (lo_c, counts_c, n)``) over this
    rank's flat key buffers.

    Sort the buffered key lanes, run-length count, and with
    ``device_compact`` move the distinct entries to a front prefix of
    length ``n`` (a 0-d tensor); without it ``n`` counts them and the
    host compacts.  With ``cascade`` the compaction runs the two kernel
    passes and falls back, on every rank at once, where any rank's
    chunks overflow.  A rank with nothing buffered calls
    ``resolve(None)`` (``resolve(None, None)`` wide), which joins that
    vote and returns None.
    """
    group = mesh.get_group("data")
    dev = mesh_device(mesh)

    def split(bufs):
        return (None, bufs[0]) if narrow else (bufs[0], bufs[1])

    def outs(hi, *rest):
        return rest if narrow else (hi, *rest)

    def overflows(ok1, ok2) -> Tuple[int, int]:
        """How many ranks of the data dim overflowed each pass."""
        bads = torch.stack([~ok1, ~ok2]).to(dev, torch.int32)
        dist.all_reduce(bads, group=group)
        bad1, bad2 = bads.tolist()
        return bad1, bad2

    def resolve(*bufs):
        hi, lo = split(bufs)
        if lo is None:
            if device_compact and cascade:
                ok = torch.ones((), dtype=torch.bool, device=dev)
                overflows(ok, ok)
            return None
        hi_s, lo_s, counts = _count.unique_counts(hi, lo)
        if not device_compact:
            return outs(hi_s, lo_s, counts, (counts > 0).sum())
        chosen = (hi_s, lo_s, counts)
        if cascade:
            from ..device.kernels import mxu_compact_slots

            h1, l1, c1, ok1 = mxu_compact_slots(hi_s, lo_s, counts)
            h2, l2, c2, ok2 = mxu_compact_slots(h1, l1, c1)
            bad1, bad2 = overflows(ok1, ok2)
            # where some rank's chunk held more runs than slots, its
            # reduced planes dropped entries: every rank then compacts its
            # full stream, else the deeper pass that held everywhere
            if not bad1:
                chosen = (h1, l1, c1) if bad2 else (h2, l2, c2)
        h_c, l_c, c_c, n = _count.compact_runs_device(*chosen)
        return outs(h_c, l_c, c_c, n)

    return resolve
