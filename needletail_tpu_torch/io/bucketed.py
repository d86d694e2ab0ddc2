"""Length-bucketed batching: avoid padding waste on mixed-length inputs.

The port's copy of ``needletail_tpu/io/bucketed.py``.

Fixed-shape device batches pad every read to the batch width, so a corpus
mixing (say) 36 bp and 150 bp reads wastes most of its lanes if batched
together.  This layer re-buckets the fast framer's output by read length:
each yielded batch is padded only to its bucket's width (SURVEY.md §7 hard
part 4 — bucketed padding; the k-mer kernels' validity masks already play
the role of segment IDs on pad lanes).

Reads longer than the largest configured bucket get dynamic buckets
rounded up to a multiple of 128 (or use ``device.tiling`` for multi-Mbp
records).
"""

from __future__ import annotations

from typing import Iterator, Optional, Sequence, Tuple

import numpy as np

from ..batch import ReadBatch
from .fast_batch import fast_read_batches, fast_read_batches_range

__all__ = ["bucketed_read_batches", "DEFAULT_BUCKETS"]

DEFAULT_BUCKETS = (128, 256, 512, 1024, 2048, 4096)


class _BucketAcc:
    def __init__(self, width: int, batch_size: int, with_quals: bool) -> None:
        self.width = width
        self.bs = batch_size
        self.seqs = np.zeros((batch_size, width), np.uint8)
        self.quals = np.zeros((batch_size, width), np.uint8) if with_quals else None
        self.lengths = np.zeros(batch_size, np.int32)
        self.fill = 0

    def take(self) -> ReadBatch:
        out = ReadBatch(
            seqs=self.seqs[: self.fill],
            lengths=self.lengths[: self.fill],
            quals=self.quals[: self.fill] if self.quals is not None else None,
            ids=[],
        )
        self.seqs = np.zeros((self.bs, self.width), np.uint8)
        if self.quals is not None:
            self.quals = np.zeros((self.bs, self.width), np.uint8)
        self.lengths = np.zeros(self.bs, np.int32)
        self.fill = 0
        return out


def bucketed_read_batches(
    path,
    batch_size: int = 4096,
    buckets: Sequence[int] = DEFAULT_BUCKETS,
    with_quals: bool = True,
    max_len: Optional[int] = None,
    byte_range: Optional[Tuple[int, int]] = None,
) -> Iterator[ReadBatch]:
    """Stream ``ReadBatch``es grouped by length bucket.

    Single-file: a list of paths raises ``ValueError``.  ``byte_range``
    ``(start, end)`` buckets only that record-aligned range of an
    uncompressed file.

    Every yielded batch's width is the smallest bucket holding all its
    reads, so device FLOPs scale with real bases instead of the corpus's
    longest read.  Record order is preserved within a bucket; buckets
    interleave as they fill.  An explicit ``max_len`` keeps the flat
    paths' contract: reads longer than it raise — after the same
    round-up-to-8 quantum the flat transports apply, so toggling
    ``bucketed`` never flips a read between accepted and rejected.
    """
    from .fast_batch import _effective_packed_max_len

    if isinstance(path, (list, tuple)):
        raise ValueError("bucketed framing is single-file; pass one path")
    max_len = _effective_packed_max_len(True, max_len)
    buckets = tuple(sorted(buckets))
    barr = np.asarray(buckets, np.int64)
    accs = {}
    emit_quals = with_quals  # resolved from the first batch (FASTA has none)

    def acc_for(width: int) -> _BucketAcc:
        acc = accs.get(width)
        if acc is None:
            acc = accs[width] = _BucketAcc(width, batch_size, emit_quals)
        return acc

    if byte_range is None:
        source = fast_read_batches(
            path, batch_size=batch_size, max_len=None, with_quals=with_quals
        )
    else:
        source = fast_read_batches_range(
            path, *byte_range, batch_size=batch_size, max_len=None,
            with_quals=with_quals,
        )
    for batch in source:
        if batch.quals is None:
            # FASTA source: never fabricate a zero quality plane
            emit_quals = False
        n = batch.num_reads
        lens = np.asarray(batch.lengths[:n])
        if max_len is not None and n and int(lens.max()) > max_len:
            over = int((lens > max_len).sum())
            raise ValueError(
                f"{over} read(s) exceed max_len={max_len}; pass a larger max_len"
            )
        b_idx = np.searchsorted(barr, lens)
        for bi in np.unique(b_idx):
            rows = np.flatnonzero(b_idx == bi)
            if bi < len(buckets):
                width = buckets[bi]
            else:
                # dynamic bucket for reads beyond the largest configured one
                width = int(-(-int(lens[rows].max()) // 128) * 128)
            acc = acc_for(width)
            # the source batch may be narrower than the bucket (widths round
            # to 128, buckets are powers of two); the remainder stays zero
            w = min(width, batch.seqs.shape[1])
            pos = 0
            while pos < len(rows):
                take = min(len(rows) - pos, acc.bs - acc.fill)
                sel = rows[pos : pos + take]
                acc.seqs[acc.fill : acc.fill + take, :w] = batch.seqs[sel, :w]
                if acc.quals is not None and batch.quals is not None:
                    acc.quals[acc.fill : acc.fill + take, :w] = batch.quals[sel, :w]
                acc.lengths[acc.fill : acc.fill + take] = lens[sel]
                acc.fill += take
                pos += take
                if acc.fill == acc.bs:
                    yield acc.take()
    for width in sorted(accs):
        if accs[width].fill:
            yield accs[width].take()
