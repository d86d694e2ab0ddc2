"""High-throughput batched FASTQ/FASTA ingestion via the native framer.

The port's copy of ``needletail_tpu/io/fast_batch.py``, the host engine
that keeps the device fed: bytes stream through the decompressor into a
reusable buffer, the C scanner
frames records at memchr speed, and sequences/qualities are memcpy'd straight
into padded ``[batch, max_len]`` numpy arrays — no per-record Python objects.

Error taxonomy and line accounting match the streaming readers exactly
(validated against them in tests): FASTQ errors carry the record id and the
reference's line offsets; truncated tails raise UnexpectedEnd; trailing blank
lines are accepted.

Falls back to the pure-Python ``BatchReader`` when the native library is not
available or the input is FASTA (the batched FASTA path uses the native
scanner for framing but Python for newline-stripping of wrapped sequences).
"""

from __future__ import annotations

import io
from pathlib import Path
from typing import Iterator, Optional, Union

import numpy as np

from ..batch import BatchReader, ReadBatch
from ..errors import ErrorPosition, Format, ParseError
from ..parser import FastaReader, FastqReader
from ..parser.utils import trim_cr
from .compression import (
    DECOMPRESSION_ERRORS,
    open_uncompressed,
    sniff_compression,
)
from .prefetch import PrefetchReader
from . import native

__all__ = ["fast_read_batches"]

_CHUNK = 4 << 20


class _StreamWindow:
    """Growable readinto window over a stream (compressed/pipe input).

    ``fill(need)`` returns a view holding at least ``need`` valid bytes
    (less only at EOF); ``consume(n)`` memmoves the unscanned remainder to
    the front.  ``eof`` is True once the stream is exhausted (the returned
    view then holds every remaining byte)."""

    def __init__(self, stream, base_offset: int = 0) -> None:
        self._stream = stream
        self._buf = np.empty(2 * _CHUNK, dtype=np.uint8)
        self._len = 0
        self.eof = False
        # absolute stream offset of the window's first byte (for
        # record-aligned checkpoint offsets; decompressed-space for
        # compressed streams)
        self.abs_offset = base_offset

    def fill(self, need: int) -> np.ndarray:
        while not self.eof and self._len < need:
            if self._buf.size - self._len < _CHUNK:
                grown = np.empty(self._buf.size * 2, dtype=np.uint8)
                grown[: self._len] = self._buf[: self._len]
                self._buf = grown
            try:
                got = self._stream.readinto(
                    memoryview(self._buf)[self._len : self._len + _CHUNK]
                )
            except DECOMPRESSION_ERRORS as exc:
                raise ParseError.from_io(
                    exc if isinstance(exc, OSError) else OSError(str(exc))
                ) from exc
            if not got:
                self.eof = True
                break
            self._len += got
        return self._buf[: self._len]

    def consume(self, n: int) -> None:
        if n:
            remaining = self._len - n
            self._buf[:remaining] = self._buf[n : self._len]
            self._len = remaining
            self.abs_offset += n

    def remaining(self) -> np.ndarray:
        return self._buf[: self._len]

    def close(self) -> None:
        close = getattr(self._stream, "close", None)
        if close is not None:
            close()


class _MmapWindow:
    """Zero-copy window over an uncompressed file (the mmap path):
    the scanner and batch fillers read straight from the page cache —
    no readinto copy, no memmove.  ``[start, end)`` bounds support the
    byte-range workers."""

    def __init__(self, path, start: int = 0, end: Optional[int] = None) -> None:
        import mmap as _mmap

        self._f = open(path, "rb")
        self._mm = _mmap.mmap(self._f.fileno(), 0, access=_mmap.ACCESS_READ)
        # sequential scan pattern: aggressive readahead roughly halves the
        # minor-fault cost of first-touch (the scanner is fault-bound on
        # cold windows, ~2 GB/s vs ~10 GB/s warm)
        for advice in ("MADV_SEQUENTIAL", "MADV_WILLNEED"):
            try:
                self._mm.madvise(getattr(_mmap, advice))
            except (AttributeError, OSError):  # pragma: no cover
                break
        self._arr = np.frombuffer(self._mm, dtype=np.uint8)
        self._pos = start
        self._end = self._arr.size if end is None else min(end, self._arr.size)
        self.eof = self._pos >= self._end

    @property
    def abs_offset(self) -> int:
        """Absolute file offset of the window's first byte."""
        return self._pos

    def fill(self, need: int) -> np.ndarray:
        stop = min(self._pos + max(need, 2 * _CHUNK), self._end)
        self.eof = stop >= self._end
        return self._arr[self._pos : stop]

    def consume(self, n: int) -> None:
        # eof stays as the last fill() set it: it means "that window
        # reached the end of input", which consuming a prefix cannot undo
        self._pos += n

    def remaining(self) -> np.ndarray:
        return self._arr[self._pos : self._end]

    def close(self) -> None:
        # views into the map keep it alive via refcounts; numpy arrays from
        # np.frombuffer hold the mmap object, so an explicit close is only
        # safe once iteration is done — the driving generators close in a
        # finally after the batcher finishes (or is abandoned)
        try:
            self._arr = None
            try:
                self._mm.close()
            except BufferError:
                # a live view still exports the buffer (e.g. generator
                # abandoned mid-chunk): the map frees when views collect,
                # but the fd below closes now
                pass
        finally:
            self._f.close()


def _as_window(source):
    """Accept either a window provider or a plain readable stream."""
    return source if hasattr(source, "fill") else _StreamWindow(source)


def _round128(n: int) -> int:
    return ((max(n, 1) + 127) // 128) * 128


class _IdAccum:
    """Accumulates packed '\n'-separated id blobs for one output batch;
    ``take()`` seals them into a LazyIds without per-record objects."""

    __slots__ = ("_parts", "_n")

    def __init__(self) -> None:
        self._parts: list = []
        self._n = 0

    def add_packed(self, blob: bytes, n: int) -> None:
        if n:
            self._parts.append(blob)
            self._n += n

    def add_one(self, id_bytes: bytes) -> None:
        self._parts.append(id_bytes + b"\n")
        self._n += 1

    def take(self):
        from ..batch import LazyIds

        return LazyIds(b"".join(self._parts), self._n)


def _new_ids(with_ids: bool):
    return _IdAccum() if with_ids else []


def _take_ids(ids):
    return ids.take() if isinstance(ids, _IdAccum) else ids


def _widen(arr: np.ndarray, new_ml: int) -> np.ndarray:
    """Re-pad a partially-filled [rows, old_ml] batch plane to new_ml."""
    out = np.zeros((arr.shape[0], new_ml), dtype=arr.dtype)
    out[:, : arr.shape[1]] = arr
    return out


def _tail_error_pos(
    tail: bytes, base_line: int, line_offset: int, parse_id: bool
) -> ErrorPosition:
    """get_error_pos semantics for a truncated tail (ref fastq.rs:287-303)."""
    rec_id = None
    if parse_id:
        nl = tail.find(b"\n")
        if nl >= 1:  # '@\n' yields an empty id, matching the streaming reader
            raw = trim_cr(tail[1:nl])
            rec_id = raw.split(b" ")[0].decode("utf-8", errors="replace")
    return ErrorPosition(line=base_line + line_offset, id=rec_id)


def _record_error(buf: np.ndarray, start: int, err: int, base_line: int) -> ParseError:
    """Reconstruct the exact ParseError for a record failing C-side validation."""
    data = buf[start:].tobytes()
    nl1 = data.find(b"\n")
    rec_id = None
    if nl1 >= 1:  # empty headers still carry an (empty) id, like the reader
        rec_id = (
            trim_cr(data[1:nl1]).split(b" ")[0].decode("utf-8", errors="replace")
        )
    if err == native.ERR_INVALID_START:
        return ParseError.new_invalid_start(
            data[0], ErrorPosition(line=base_line, id=None), Format.FASTQ
        )
    if err == native.ERR_INVALID_SEPARATOR:
        sep_byte = data[data.find(b"\n", nl1 + 1) + 1]
        return ParseError.new_invalid_separator(
            sep_byte, ErrorPosition(line=base_line + 2, id=rec_id)
        )
    # unequal lengths: recompute the two lengths for the message
    nl2 = data.find(b"\n", nl1 + 1)
    nl3 = data.find(b"\n", nl2 + 1)
    nl4 = data.find(b"\n", nl3 + 1)
    seq_len = len(trim_cr(data[nl1 + 1 : nl2]))
    qual_len = len(trim_cr(data[nl3 + 1 : nl4 if nl4 >= 0 else len(data)]))
    return ParseError.new_unequal_length(
        seq_len, qual_len, ErrorPosition(line=base_line, id=rec_id)
    )


class _FastqBatcher:
    """Stream -> padded batches using the native scanner.

    ``packed=True`` switches the fill stage to the C packed fills: the
    primary plane holds 2-bit codes [bs, max_len/4], the secondary plane
    the validity bitplane [bs, max_len/8] (dropped at yield when the batch
    had no ambiguous base), and batches come out as ``PackedReadBatch``
    (quality planes are not carried — packed transport is for the counting
    paths).  See ``needletail_tpu_torch.encoding`` for the layout contract.
    """

    def __init__(
        self, source, batch_size: int, max_len: Optional[int], with_quals: bool,
        with_ids: bool = False, packed: bool = False, normalized: bool = True,
    ):
        if packed and with_quals:
            raise ValueError("packed transport does not carry quality planes")
        self._win = _as_window(source)
        self._bs = batch_size
        self._max_len = max_len
        self._auto = max_len is None  # widen instead of erroring on overflow
        self._with_quals = with_quals
        self._with_ids = with_ids
        self._packed = packed
        self._normalized = normalized
        if packed:
            from ..encoding import encode_lut

            self._lut = np.ascontiguousarray(encode_lut(normalized))
        self._dirty = 0  # invalid bases packed into the current batch
        self._row_invalid = np.zeros(0, dtype=np.int32)  # per-row, packed mode
        self._count_base = 0  # records scanned in prior chunks (line accounting)
        # absolute offset one past the last record filled into the current
        # batch (record-aligned resume point); None until known
        self._emit_offset = None

    def _alloc(self):
        ml = self._max_len
        if self._packed:
            seqs = np.zeros((self._bs, ml // 4), dtype=np.uint8)
            quals = np.zeros((self._bs, ml // 8), dtype=np.uint8)  # vbits
            self._dirty = 0
            self._row_invalid = np.zeros(self._bs, dtype=np.int32)
        else:
            seqs = np.zeros((self._bs, ml), dtype=np.uint8)
            quals = (
                np.zeros((self._bs, ml), dtype=np.uint8)
                if self._with_quals
                else None
            )
        lengths = np.zeros(self._bs, dtype=np.int32)
        return seqs, quals, lengths

    def _emit(self, seqs, quals, lengths, ids, n: Optional[int] = None):
        """Seal the current planes into the right batch type."""
        if n is not None:
            seqs = seqs[:n]
            lengths = lengths[:n]
            if quals is not None:
                quals = quals[:n]
        if self._packed:
            from ..batch import PackedReadBatch

            batch = PackedReadBatch(
                codes=seqs,
                lengths=lengths,
                vbits=quals if self._dirty else None,
                ids=_take_ids(ids),
                normalized=self._normalized,
                file_offset=self._emit_offset,
            )
            # lean transport: ship validity only for the rows that need it
            return batch.to_lean(self._row_invalid) if self._dirty else batch
        return ReadBatch(
            seqs=seqs, lengths=lengths, quals=quals, ids=_take_ids(ids),
            file_offset=self._emit_offset,
        )

    def _fill(
        self, pending, chunk_recs, seqs_rows, quals_rows, len_rows,
        rowinv_rows=None,
    ):
        """Dispatch to the ASCII memcpy fill or the packed 2-bit fill."""
        if self._packed:
            overflow, n_invalid = native.fill_fastq_batch_packed_rows(
                pending, chunk_recs, self._lut, seqs_rows, quals_rows,
                len_rows, self._max_len, rowinv_rows,
            )
            self._dirty += n_invalid
            return overflow
        return native.fill_fastq_batch(
            pending, chunk_recs, seqs_rows, quals_rows, len_rows
        )

    def _widen_planes(self, seqs, quals):
        if self._packed:
            seqs = _widen(seqs, self._max_len // 4)
            quals = _widen(quals, self._max_len // 8)
        else:
            seqs = _widen(seqs, self._max_len)
            if quals is not None:
                quals = _widen(quals, self._max_len)
        return seqs, quals

    def __iter__(self) -> Iterator[ReadBatch]:
        # window provider: stream windows memmove leftovers to the front;
        # mmap windows are zero-copy views over the page cache
        win = self._win
        seqs = quals = lengths = None
        ids = _new_ids(self._with_ids)
        fill = 0
        need = _CHUNK  # grows when a single record exceeds the window
        recs_buf = np.empty(((2 * _CHUNK) // 6 + 16, 5), dtype=np.int64)

        while True:
            pending = win.fill(need)
            pending_abs = win.abs_offset
            if pending.size == 0 and win.eof:
                break

            cap = pending.size // 6 + 16  # min record is 6 bytes
            if recs_buf.shape[0] < cap:
                recs_buf = np.empty((cap, 5), dtype=np.int64)
            recs, n, consumed, err, err_rec = native.scan_fastq(pending, cap, out=recs_buf)

            longest = int((recs[:, 2] - 1 - recs[:, 1]).max()) if n else 0
            if self._max_len is None:
                # infer from the first scan: longest seq line, rounded to 128
                self._max_len = _round128(longest)
            elif self._auto and longest > self._max_len:
                # auto mode: a later chunk holds a longer read — widen the
                # batch width (and any partially-filled arrays) instead of
                # erroring like the explicit-max_len contract does
                self._max_len = _round128(longest)
                if seqs is not None:
                    seqs, quals = self._widen_planes(seqs, quals)

            # fill rows, possibly spanning multiple output batches
            idx = 0
            while idx < n:
                if seqs is None:
                    seqs, quals, lengths = self._alloc()
                    fill = 0
                take = min(n - idx, self._bs - fill)
                chunk_recs = np.ascontiguousarray(recs[idx : idx + take])
                overflow = self._fill(
                    pending,
                    chunk_recs,
                    seqs[fill : fill + take],
                    quals[fill : fill + take] if quals is not None else None,
                    lengths[fill : fill + take],
                    self._row_invalid[fill : fill + take]
                    if self._packed
                    else None,
                )
                if overflow:
                    raise ValueError(
                        f"{overflow} read(s) exceed max_len={self._max_len}; "
                        "pass a larger max_len"
                    )
                if self._with_ids:
                    ids.add_packed(*native.extract_ids_packed(pending, chunk_recs, fastq=True))
                self._emit_offset = pending_abs + int(chunk_recs[-1, 4]) + 1
                fill += take
                idx += take
                if fill == self._bs:
                    yield self._emit(seqs, quals, lengths, ids)
                    seqs = quals = lengths = None
                    ids = _new_ids(self._with_ids)
                    fill = 0

            if err != native.ERR_OK:
                # flush records framed before the error (the streaming reader
                # delivers them one-by-one before raising), then raise with
                # the reference line accounting: 4 lines per prior record
                if seqs is not None and fill > 0:
                    yield self._emit(seqs, quals, lengths, ids, n=fill)
                    seqs = quals = lengths = None
                    ids = _new_ids(self._with_ids)
                base_line = 1 + 4 * (self._count_base + n)
                raise _record_error(pending, err_rec, err, base_line)

            self._count_base += n
            win.consume(consumed)

            if not win.eof:
                # ensure forward progress even when one record > window
                need = _CHUNK if n > 0 else pending.size + _CHUNK
                continue

            tail_arr = win.remaining()
            if tail_arr.size > 0:
                try:
                    row = self._handle_tail(tail_arr)
                except ParseError:
                    if seqs is not None and fill > 0:
                        yield self._emit(seqs, quals, lengths, ids, n=fill)
                        seqs = quals = lengths = None
                        ids = _new_ids(self._with_ids)
                    raise
                self._emit_offset = win.abs_offset + tail_arr.size
                if row is not None:
                    if seqs is None:
                        seqs, quals, lengths = self._alloc()
                        fill = 0
                    sb, qb = row
                    if self._with_ids:
                        tb = tail_arr.tobytes()
                        nl = tb.find(b"\n")
                        ids.add_one(trim_cr(tb[1:nl]) if nl > 0 else b"")
                    if len(sb) > self._max_len:
                        if not self._auto:
                            raise ValueError(
                                f"final read exceeds max_len={self._max_len}"
                            )
                        self._max_len = _round128(len(sb))
                        seqs, quals = self._widen_planes(seqs, quals)
                    if self._packed:
                        rowinv = native.pack_row(
                            np.frombuffer(sb, dtype=np.uint8),
                            self._lut,
                            seqs[fill],
                            quals[fill],
                        )
                        self._dirty += rowinv
                        self._row_invalid[fill] = rowinv
                    else:
                        seqs[fill, : len(sb)] = np.frombuffer(sb, dtype=np.uint8)
                        if quals is not None:
                            quals[fill, : len(qb)] = np.frombuffer(qb, dtype=np.uint8)
                    lengths[fill] = len(sb)
                    fill += 1
            break

        if seqs is not None and fill > 0:
            yield self._emit(seqs, quals, lengths, ids, n=fill)

    def _handle_tail(self, tail_arr: np.ndarray):
        """check_end semantics (ref fastq.rs:337-356) for the final bytes."""
        tail = tail_arr.tobytes()
        nls = []
        i = tail.find(b"\n")
        while i >= 0 and len(nls) < 4:
            nls.append(i)
            i = tail.find(b"\n", i + 1)
        stage = min(len(nls), 3)
        base_line = 1 + 4 * (self._count_base)
        if len(nls) >= 3:
            # only the quality newline is missing: validate + emit
            if tail[0:1] != b"@":
                raise ParseError.new_invalid_start(
                    tail[0], ErrorPosition(line=base_line, id=None), Format.FASTQ
                )
            if tail[nls[1] + 1 : nls[1] + 2] != b"+":  # separator line start
                raise ParseError.new_invalid_separator(
                    tail[nls[1] + 1],
                    _tail_error_pos(tail, base_line, 2, True),
                )
            seq = trim_cr(tail[nls[0] + 1 : nls[1]])
            qual = trim_cr(tail[nls[2] + 1 :])
            if len(seq) != len(qual):
                raise ParseError.new_unequal_length(
                    len(seq), len(qual), _tail_error_pos(tail, base_line, 0, True)
                )
            return seq, qual
        if all(len(trim_cr(line)) == 0 for line in tail.split(b"\n")):
            return None
        raise ParseError.new_unexpected_end(
            _tail_error_pos(tail, base_line, stage, stage > 0), Format.FASTQ
        )


class _FastaBatcher:
    """Stream -> padded batches for FASTA using the native scanner + the
    newline-stripping batch filler.  Mid-file FASTA framing has no
    validation errors; the truncated-EOF cases are delegated to the
    streaming FastaReader on the tail bytes (with line-number adjustment)."""

    def __init__(
        self, source, batch_size: int, max_len: Optional[int],
        with_ids: bool = False, packed: bool = False, normalized: bool = True,
    ):
        self._win = _as_window(source)
        self._bs = batch_size
        self._max_len = max_len
        self._auto = max_len is None  # widen instead of erroring on overflow
        self._with_ids = with_ids
        self._packed = packed
        self._normalized = normalized
        if packed:
            from ..encoding import encode_lut

            self._lut = np.ascontiguousarray(encode_lut(normalized))
        self._dirty = 0
        self._vbits = None  # packed mode's validity plane
        self._row_invalid = np.zeros(0, dtype=np.int32)  # per-row, packed mode
        self._lines_done = 0
        self._emit_offset = None  # see _FastqBatcher

    def _alloc(self):
        if self._packed:
            seqs = np.zeros((self._bs, self._max_len // 4), dtype=np.uint8)
            self._vbits = np.zeros((self._bs, self._max_len // 8), dtype=np.uint8)
            self._dirty = 0
            self._row_invalid = np.zeros(self._bs, dtype=np.int32)
        else:
            seqs = np.zeros((self._bs, self._max_len), dtype=np.uint8)
        lengths = np.zeros(self._bs, dtype=np.int32)
        return seqs, lengths

    def _emit(self, seqs, lengths, ids, n: Optional[int] = None):
        if n is not None:
            seqs = seqs[:n]
            lengths = lengths[:n]
        if self._packed:
            from ..batch import PackedReadBatch

            vbits = self._vbits if self._dirty else None
            if vbits is not None and n is not None:
                vbits = vbits[:n]
            self._vbits = None
            batch = PackedReadBatch(
                codes=seqs, lengths=lengths, vbits=vbits,
                ids=_take_ids(ids), normalized=self._normalized,
                file_offset=self._emit_offset,
            )
            return batch.to_lean(self._row_invalid) if self._dirty else batch
        return ReadBatch(
            seqs=seqs, lengths=lengths, quals=None, ids=_take_ids(ids),
            file_offset=self._emit_offset,
        )

    def _fill(
        self, pending, chunk_recs, seqs_rows, vbits_rows, len_rows,
        rowinv_rows=None,
    ):
        if self._packed:
            overflow, n_invalid = native.fill_fasta_batch_packed_rows(
                pending, chunk_recs, self._lut, seqs_rows, vbits_rows,
                len_rows, self._max_len, rowinv_rows,
            )
            self._dirty += n_invalid
            return overflow
        return native.fill_fasta_batch(pending, chunk_recs, seqs_rows, len_rows)

    def _widen_planes(self, seqs):
        if self._packed:
            if self._vbits is not None:
                self._vbits = _widen(self._vbits, self._max_len // 8)
            return _widen(seqs, self._max_len // 4)
        return _widen(seqs, self._max_len)

    def __iter__(self) -> Iterator[ReadBatch]:
        win = self._win
        seqs = lengths = None
        ids = _new_ids(self._with_ids)
        fill = 0
        need = _CHUNK
        recs_buf = np.empty(((2 * _CHUNK) // 4 + 16, 3), dtype=np.int64)
        started = False

        while True:
            pending = win.fill(need)
            pending_abs = win.abs_offset
            if pending.size == 0 and win.eof:
                break
            if not started:
                if pending[0] != 0x3E:  # '>' (dispatch normally catches this)
                    raise ParseError.new_invalid_start(
                        int(pending[0]), ErrorPosition(line=0, id=None), Format.FASTA
                    )
                started = True

            cap = pending.size // 4 + 16  # min record is ">\n\n" = 4ish bytes
            if recs_buf.shape[0] < cap:
                recs_buf = np.empty((cap, 3), dtype=np.int64)
            recs, n, consumed = native.scan_fasta(pending, cap, out=recs_buf)

            # exact longest stripped length (raw spans over-pad wrapped
            # FASTA by the newline fraction), rounded to 128
            longest = native.fasta_max_len(pending, recs) if n else 0
            if self._max_len is None:
                self._max_len = _round128(longest)
            elif self._auto and longest > self._max_len:
                # auto mode: widen for longer records in later chunks
                self._max_len = _round128(longest)
                if seqs is not None:
                    seqs = self._widen_planes(seqs)

            idx = 0
            while idx < n:
                if seqs is None:
                    seqs, lengths = self._alloc()
                    fill = 0
                take = min(n - idx, self._bs - fill)
                chunk_recs = np.ascontiguousarray(recs[idx : idx + take])
                overflow = self._fill(
                    pending, chunk_recs, seqs[fill : fill + take],
                    self._vbits[fill : fill + take] if self._packed else None,
                    lengths[fill : fill + take],
                    self._row_invalid[fill : fill + take]
                    if self._packed
                    else None,
                )
                if overflow:
                    raise ValueError(
                        f"{overflow} record(s) exceed max_len={self._max_len}; "
                        "pass a larger max_len or use device.tiling for "
                        "whole-genome records"
                    )
                if self._with_ids:
                    ids.add_packed(*native.extract_ids_packed(pending, chunk_recs, fastq=False))
                self._emit_offset = pending_abs + int(chunk_recs[-1, 2]) + 1
                fill += take
                idx += take
                if fill == self._bs:
                    yield self._emit(seqs, lengths, ids)
                    seqs = lengths = None
                    ids = _new_ids(self._with_ids)
                    fill = 0

            if consumed:
                self._lines_done += native.count_newlines(pending[:consumed])
                win.consume(consumed)

            if not win.eof:
                need = _CHUNK if n > 0 else pending.size + _CHUNK
                continue

            tail_arr = win.remaining()
            if tail_arr.size > 0:
                # The final record has no following '>' so the C scanner
                # never frames it — but for a WELL-FORMED tail (a body
                # line exists: >=2 newlines, or 1 non-terminal newline)
                # the EOF-handler's only job is "seq = everything past the
                # header line".  Appending a '\n>' sentinel lets the same
                # C scan+fill path frame it at native speed — the whole
                # input front of a single-record genome FASTA is this tail
                # (the Python reader walks 5 Mbp in ~30 ms; the C fill in
                # ~2).  Malformed tails (header-only / no newline) keep
                # the reference-exact Python path and its error taxonomy
                # (ref fasta.rs:206-213: UnexpectedEnd).
                n_nl = native.count_newlines(tail_arr)
                ends_nl = bool(tail_arr[-1] == 0x0A)
                if n_nl >= 2 or (n_nl == 1 and not ends_nl):
                    sent = np.empty(tail_arr.size + 2, dtype=np.uint8)
                    sent[:-2] = tail_arr
                    sent[-2] = 0x0A
                    sent[-1] = 0x3E
                    recs_t, n_t, consumed_t = native.scan_fasta(sent, 4)
                    if n_t == 1 and consumed_t == sent.size - 1:
                        chunk_recs = np.ascontiguousarray(recs_t[:1])
                        longest = native.fasta_max_len(sent, chunk_recs)
                        if self._max_len is None:
                            self._max_len = _round128(longest)
                        elif longest > self._max_len:
                            if not self._auto:
                                raise ValueError(
                                    f"final record exceeds max_len="
                                    f"{self._max_len}"
                                )
                            self._max_len = _round128(longest)
                            if seqs is not None:
                                seqs = self._widen_planes(seqs)
                        if seqs is None:
                            seqs, lengths = self._alloc()
                            fill = 0
                        self._fill(
                            sent, chunk_recs, seqs[fill : fill + 1],
                            self._vbits[fill : fill + 1]
                            if self._packed
                            else None,
                            lengths[fill : fill + 1],
                            self._row_invalid[fill : fill + 1]
                            if self._packed
                            else None,
                        )
                        if self._with_ids:
                            ids.add_packed(
                                *native.extract_ids_packed(
                                    sent, chunk_recs, fastq=False
                                )
                            )
                        fill += 1
                        self._emit_offset = win.abs_offset + tail_arr.size
                        if fill == self._bs:
                            yield self._emit(seqs, lengths, ids)
                            seqs = lengths = None
                            ids = _new_ids(self._with_ids)
                            fill = 0
                        break
                # delegate the final (possibly truncated) record to the
                # reference-exact streaming reader, offsetting line numbers
                reader = FastaReader(bytes(tail_arr))
                tail_end = win.abs_offset + tail_arr.size
                self._emit_offset = None
                try:
                    while (rec := reader.next()) is not None:
                        s = rec.seq()
                        if seqs is None:
                            seqs, lengths = self._alloc()
                            fill = 0
                        if self._with_ids:
                            ids.add_one(bytes(rec.id()))
                        if len(s) > self._max_len:
                            if not self._auto:
                                raise ValueError(
                                    f"final record exceeds max_len={self._max_len}"
                                )
                            self._max_len = _round128(len(s))
                            seqs = self._widen_planes(seqs)
                        if self._packed:
                            rowinv = native.pack_row(
                                np.frombuffer(s, dtype=np.uint8),
                                self._lut,
                                seqs[fill],
                                self._vbits[fill],
                            )
                            self._dirty += rowinv
                            self._row_invalid[fill] = rowinv
                        else:
                            seqs[fill, : len(s)] = np.frombuffer(s, dtype=np.uint8)
                        lengths[fill] = len(s)
                        fill += 1
                        if fill == self._bs:
                            yield self._emit(seqs, lengths, ids)
                            seqs = lengths = None
                            ids = _new_ids(self._with_ids)
                            fill = 0
                    self._emit_offset = tail_end
                except ParseError as exc:
                    if seqs is not None and fill > 0:
                        yield self._emit(seqs, lengths, ids, n=fill)
                        seqs = lengths = None
                        ids = _new_ids(self._with_ids)
                    raise ParseError(
                        exc.msg,
                        exc.kind,
                        ErrorPosition(
                            line=exc.position.line + self._lines_done,
                            id=exc.position.id,
                        ),
                        exc.format,
                    ) from None
            break

        if seqs is not None and fill > 0:
            yield self._emit(seqs, lengths, ids, n=fill)


def _strip_quals_unless(batches, with_quals: bool):
    """The pure-Python BatchReader always materializes qualities; drop them
    when the caller asked for none so both paths yield identical batches."""
    for b in batches:
        if not with_quals:
            b.quals = None
        yield b


def _pack_fallback(batches, normalized: bool):
    """Numpy-pack ASCII batches (the no-native-framer packed path)."""
    from ..batch import PackedReadBatch

    for b in batches:
        yield PackedReadBatch.from_read_batch(b, normalized=normalized)


def _effective_packed_max_len(
    packed: bool, max_len: Optional[int]
) -> Optional[int]:
    """Packed planes are byte-quantized (4 codes / 8 validity bits per
    byte), so an explicit ``max_len`` rounds UP to the next multiple of 8
    — never an error, because the counting drivers auto-select packed
    transport and must accept every ``max_len`` the ASCII path accepts.
    The widened columns stay masked by per-read lengths."""
    if packed and max_len is not None and max_len % 8:
        return max_len + (8 - max_len % 8)
    return max_len


class RangeStream(io.RawIOBase):
    """Reads exactly ``[start, end)`` of a file (record-aligned ranges come
    from ``parallel.distributed.split_fastx_ranges``)."""

    def __init__(self, path, start: int, end: int) -> None:
        self._f = open(path, "rb")
        self._f.seek(start)
        self._remaining = end - start

    def readable(self) -> bool:  # pragma: no cover
        return True

    def read(self, size: int = -1) -> bytes:
        if self._remaining <= 0:
            return b""
        if size is None or size < 0 or size > self._remaining:
            size = self._remaining
        data = self._f.read(size)
        self._remaining -= len(data)
        return data

    def readinto(self, b) -> int:
        data = self.read(len(b))
        b[: len(data)] = data
        return len(data)

    def close(self) -> None:
        try:
            self._f.close()
        finally:
            super().close()


def fast_read_batches_range(
    path: Union[str, Path],
    start: int,
    end: int,
    batch_size: int = 8192,
    max_len: Optional[int] = None,
    with_quals: bool = True,
    with_ids: bool = False,
    packed: bool = False,
    normalized: bool = True,
) -> Iterator[ReadBatch]:
    """Native-framer batches over one record-aligned byte range of an
    UNCOMPRESSED file (compressed streams cannot be range-split).

    ``packed=True`` yields ``PackedReadBatch``es (2-bit codes + validity
    bitplane, no quality plane) packed by the C framer — the transport
    format of the counting pipelines."""
    max_len = _effective_packed_max_len(packed, max_len)
    if packed:
        with_quals = False
    try:
        with open(path, "rb") as f:
            magic = f.read(2)
    except OSError as exc:
        raise ParseError.from_io(exc) from exc
    if len(magic) == 2 and sniff_compression(magic):
        raise ValueError("byte-range framing needs an uncompressed file")
    if start >= end:
        return
    first = magic[:1]
    stream = None
    if first in (b"@", b">") and native.available():
        try:
            stream = _MmapWindow(path, start, end)  # zero-copy framing
        except (OSError, ValueError):
            # base_offset keeps batch.file_offset ABSOLUTE (checkpoints
            # written mid-resume must not record range-relative offsets)
            stream = _StreamWindow(
                RangeStream(path, start, end), base_offset=start
            )
    if stream is None:
        # non-native fallback: the streaming readers take a raw stream
        stream = RangeStream(path, start, end)
    try:
        if first == b"@" and native.available():
            yield from _FastqBatcher(
                stream, batch_size, max_len, with_quals, with_ids,
                packed=packed, normalized=normalized,
            )
        elif first == b">" and native.available():
            yield from _FastaBatcher(
                stream, batch_size, max_len, with_ids,
                packed=packed, normalized=normalized,
            )
        elif first == b">":
            batches = BatchReader(
                FastaReader(stream), batch_size=batch_size, max_len=max_len,
                keep_ids=with_ids,
            )
            yield from _pack_fallback(batches, normalized) if packed else batches
        elif first == b"@":
            batches = _strip_quals_unless(
                BatchReader(
                    FastqReader(stream), batch_size=batch_size, max_len=max_len,
                    keep_ids=with_ids,
                ),
                with_quals,
            )
            yield from _pack_fallback(batches, normalized) if packed else batches
        else:
            raise ParseError.new_unknown_format(first[0] if first else 0)
    finally:
        # release the fd + mapping deterministically (safe: every yielded
        # plane is a copy into batch arrays, never a view of the map)
        stream.close()


def fast_read_batches_bgzf(
    path: Union[str, Path],
    start: int = 0,
    batch_size: int = 8192,
    max_len: Optional[int] = None,
    with_quals: bool = True,
    packed: bool = False,
    normalized: bool = True,
) -> Iterator[ReadBatch]:
    """Native-framer batches over a BGZF file, starting at a record-aligned
    DECOMPRESSED offset ``start`` — the compressed twin of
    :func:`fast_read_batches_range` for checkpoint/resume.

    BGZF members are independently decodable and carry their decoded size
    (ISIZE), so ``start`` maps to (block, skip) without decompressing the
    prefix; ``batch.file_offset`` values are decompressed-space offsets
    (``_StreamWindow.abs_offset`` seeded with ``base_offset=start``), so a
    checkpoint written mid-stream records exactly the coordinate this
    function resumes from."""
    from .bgzf import BGZFReader

    max_len = _effective_packed_max_len(packed, max_len)
    if packed:
        with_quals = False
    # format sniff: the first decompressed byte (block 0, independent of
    # where `start` lands)
    probe = BGZFReader(path, threads=1, lookahead=2)
    try:
        first = probe.read(1)
    finally:
        probe.close()
    if not first:
        raise ParseError.new_empty_file()
    stream = _StreamWindow(BGZFReader(path, start_offset=start), base_offset=start)
    try:
        if first == b"@" and native.available():
            yield from _FastqBatcher(
                stream, batch_size, max_len, with_quals, False,
                packed=packed, normalized=normalized,
            )
        elif first == b">" and native.available():
            yield from _FastaBatcher(
                stream, batch_size, max_len, False,
                packed=packed, normalized=normalized,
            )
        elif first in (b">", b"@"):
            # pure-Python fallback: frames correctly from `start` but
            # reports no record-aligned offsets (resume-only; checkpoint
            # WRITING is refused up front by checkpoint_source)
            stream.close()
            raw = BGZFReader(path, start_offset=start)
            reader = FastaReader(raw) if first == b">" else FastqReader(raw)
            batches = _strip_quals_unless(
                BatchReader(reader, batch_size=batch_size, max_len=max_len),
                with_quals,
            )
            yield from _pack_fallback(batches, normalized) if packed else batches
        else:
            raise ParseError.new_unknown_format(first[0])
    finally:
        stream.close()


def fast_read_batches(
    path: Union[str, Path],
    batch_size: int = 8192,
    max_len: Optional[int] = None,
    with_quals: bool = True,
    prefetch: bool = False,
    with_ids: bool = False,
    packed: bool = False,
    normalized: bool = True,
) -> Iterator[ReadBatch]:
    """Stream a FASTX file as padded batches at native-framer speed.

    ``prefetch=True`` decodes compressed input in a background thread —
    use when the consumer overlaps device compute.

    FASTQ and FASTA both use the native fast path when the C framer is
    available; otherwise the pure-Python ``BatchReader`` produces the same
    output.  ``with_ids=True`` carries raw header bytes per read (opt-in:
    id extraction costs per-record Python work).

    ``packed=True`` yields ``PackedReadBatch``es — 2-bit codes + validity
    bitplane packed by the C framer under the ``normalized`` encode LUT,
    0.25-0.375 B/base on the host->device wire instead of 1 (quality
    planes are never carried; see ``needletail_tpu_torch.encoding``).
    """
    max_len = _effective_packed_max_len(packed, max_len)
    if packed:
        with_quals = False

    def _native_fastq(src):
        return _FastqBatcher(
            src, batch_size, max_len, with_quals, with_ids,
            packed=packed, normalized=normalized,
        )

    def _native_fasta(src):
        return _FastaBatcher(
            src, batch_size, max_len, with_ids,
            packed=packed, normalized=normalized,
        )

    def _python(reader):
        batches = _strip_quals_unless(
            BatchReader(reader, batch_size=batch_size, max_len=max_len,
                        keep_ids=with_ids),
            with_quals,
        )
        return _pack_fallback(batches, normalized) if packed else batches

    if str(path) == "-":
        # batched stdin: stream windows, no mmap/range-split (the record
        # API twin is parse_fastx_stdin; same codec sniffing applies)
        import sys as _sys

        stream, first_byte = open_uncompressed(_sys.stdin.buffer)
        if first_byte == 0x40 and native.available():
            yield from _native_fastq(stream)
            return
        if first_byte == 0x3E and native.available():
            yield from _native_fasta(stream)
            return
        if first_byte == 0x3E:
            reader = FastaReader(stream)
        elif first_byte == 0x40:
            reader = FastqReader(stream)
        else:
            raise ParseError.new_unknown_format(first_byte)
        yield from _python(reader)
        return
    try:
        handle = open(path, "rb")
        magic = handle.read(2)
        handle.seek(0)
    except OSError as exc:
        raise ParseError.from_io(exc) from exc
    if (
        len(magic) == 2
        and not sniff_compression(magic)
        and magic[:1] in (b"@", b">")
        and native.available()
    ):
        # uncompressed regular file on the native path: mmap zero-copy
        # framing (falls back to the stream window for pipes/specials)
        win = None
        try:
            win = _MmapWindow(path)
        except (OSError, ValueError):
            win = None
        if win is not None:
            handle.close()
            try:
                if magic[:1] == b"@":
                    yield from _native_fastq(win)
                else:
                    yield from _native_fasta(win)
            finally:
                win.close()  # ADVICE r2: don't leave fd+map to the GC
            return
    stream, first_byte = open_uncompressed(handle)
    if prefetch and len(magic) == 2 and sniff_compression(magic):
        # overlap decompression with downstream (device) work; measured
        # slightly negative for framing alone, positive when the consumer
        # computes concurrently
        stream = PrefetchReader(stream)
    if first_byte == 0x40 and native.available():  # '@' FASTQ
        yield from _native_fastq(stream)
        return
    if first_byte == 0x3E and native.available():  # '>' FASTA
        yield from _native_fasta(stream)
        return
    if first_byte == 0x3E:
        reader = FastaReader(stream)
    elif first_byte == 0x40:
        reader = FastqReader(stream)
    else:
        raise ParseError.new_unknown_format(first_byte)
    yield from _python(reader)
