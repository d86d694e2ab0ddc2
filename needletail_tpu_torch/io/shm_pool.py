"""Shared-memory batch transport for the multi-worker framing pool.

The port's copy of ``needletail_tpu/io/shm_pool.py``.

The mp.Queue path pickles every batch plane (two copies + pipe
syscalls per ~1 MiB batch) — fine for a couple of workers, a real
bottleneck when 8-16 framing processes feed ~GB/s aggregate.  This pool
pre-allocates ``segments`` shared-memory slots sized
``rows x max_len`` (+ optional quality plane + lengths); workers write
planes in place and ship only ``(segment_id, n_reads, num_bases)``
descriptors through the queue.

Lifetime contract: a yielded batch's arrays VIEW the segment; the
segment is recycled when the consumer asks for the NEXT batch, so
consumers must finish with (or copy to the device) a batch
before advancing — exactly how every counting pipeline here behaves.

No reference equivalent (the reference is single-threaded); this is
plumbing for the BASELINE aggregate-ingest target.
"""

from __future__ import annotations

from multiprocessing import shared_memory
from typing import List, Optional, Tuple

import numpy as np

__all__ = ["SharedBatchPool", "SharedBatchWriter"]


def _plane_widths(max_len: int, with_quals: bool, packed: bool):
    """(primary, secondary) plane widths per row: ASCII seqs+quals, or
    packed 2-bit codes + validity bitplane (see needletail_tpu_torch.encoding)."""
    if packed:
        return max_len // 4, max_len // 8
    return max_len, max_len if with_quals else 0


def _segment_layout(rows: int, max_len: int, with_quals: bool, packed: bool) -> int:
    a_w, b_w = _plane_widths(max_len, with_quals, packed)
    return rows * (a_w + b_w) + 4 * rows  # planes + int32 lengths


class SharedBatchPool:
    """Consumer-side owner of the shared segments."""

    def __init__(
        self, rows: int, max_len: int, with_quals: bool, segments: int,
        packed: bool = False,
    ) -> None:
        self.rows = rows
        self.max_len = max_len
        self.with_quals = with_quals
        self.packed = packed
        size = _segment_layout(rows, max_len, with_quals, packed)
        self._shms: List[shared_memory.SharedMemory] = []
        try:
            for _ in range(segments):
                self._shms.append(
                    shared_memory.SharedMemory(create=True, size=size)
                )
        except BaseException:
            # mid-creation failure (e.g. /dev/shm ENOSPC): release what
            # was already created instead of leaking it until process exit
            self.close()
            raise
        self.names = [s.name for s in self._shms]

    def views(
        self, seg: int, n_reads: int
    ) -> Tuple[np.ndarray, Optional[np.ndarray], np.ndarray]:
        """(primary, secondary, lengths) views of the first ``n_reads``
        rows — (seqs, quals, lengths) for ASCII pools, (codes, vbits,
        lengths) for packed pools."""
        buf = self._shms[seg].buf
        a_w, b_w = _plane_widths(self.max_len, self.with_quals, self.packed)
        a_plane = self.rows * a_w
        seqs = np.frombuffer(buf, np.uint8, a_plane).reshape(
            self.rows, a_w
        )[:n_reads]
        off = a_plane
        quals = None
        if b_w:
            quals = np.frombuffer(buf, np.uint8, self.rows * b_w, offset=off
                                  ).reshape(self.rows, b_w)[:n_reads]
            off += self.rows * b_w
        lengths = np.frombuffer(buf, np.int32, self.rows, offset=off)[:n_reads]
        return seqs, quals, lengths

    def close(self) -> None:
        for s in self._shms:
            # close() raises BufferError while consumer-held views still
            # export the buffer — unlink regardless so the name is freed
            # (the mapping lives until the views are garbage-collected)
            try:
                s.close()
            except BufferError:
                pass
            try:
                s.unlink()
            except FileNotFoundError:  # pragma: no cover
                pass


class SharedBatchWriter:
    """Worker-side view over the pool's segments (attached by name)."""

    def __init__(
        self, names: List[str], rows: int, max_len: int, with_quals: bool,
        packed: bool = False,
    ) -> None:
        self.rows = rows
        self.max_len = max_len
        self.with_quals = with_quals
        self.packed = packed
        self._shms = [shared_memory.SharedMemory(name=n) for n in names]

    def write(self, seg: int, batch) -> int:
        """Copy a (Packed)ReadBatch's planes into segment ``seg``; returns
        n_reads.  Packed pools write codes + vbits (zeros when the batch is
        clean — the descriptor's ``has_vbits`` distinguishes)."""
        n = batch.num_reads
        buf = self._shms[seg].buf
        a_w, b_w = _plane_widths(self.max_len, self.with_quals, self.packed)
        a_plane = self.rows * a_w
        a_src = batch.codes if self.packed else batch.seqs
        seqs = np.frombuffer(buf, np.uint8, a_plane).reshape(self.rows, a_w)
        src_w = a_src.shape[1]
        seqs[:n, :src_w] = a_src
        if src_w < a_w:
            seqs[:n, src_w:] = 0
        off = a_plane
        if b_w:
            b_src = batch.dense_vbits() if self.packed else batch.quals
            quals = np.frombuffer(buf, np.uint8, self.rows * b_w, offset=off
                                  ).reshape(self.rows, b_w)
            if b_src is not None:
                sw = b_src.shape[1]
                quals[:n, :sw] = b_src
                if sw < b_w:
                    quals[:n, sw:] = 0
            off += self.rows * b_w
        lengths = np.frombuffer(buf, np.int32, self.rows, offset=off)
        lengths[:n] = batch.lengths
        return n

    def close(self) -> None:
        for s in self._shms:
            try:
                s.close()
            except BufferError:  # pragma: no cover
                pass
