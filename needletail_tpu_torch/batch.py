"""Batched ingestion: records -> fixed-shape padded planes for the device.

The port's copy of ``needletail_tpu/batch.py``.  The unit of work is a
padded ``[reads, max_len] uint8`` plane plus a length vector (or its 2-bit
packed form), so k-mer extraction runs as vectorized kernels over the lane
dimension.

``ReadBatch`` carries sequence bytes (and qualities for FASTQ) in numpy; ids
and per-record positions stay host-side.  ``BatchReader`` adapts any
``FastxReader`` into an iterator of fixed-shape batches (the fallback of
the native framer).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterator, List, NamedTuple, Optional, Sequence, Union

import numpy as np

from .parser import FastxReader, SequenceRecord, parse_fastx_file

__all__ = [
    "ReadBatch",
    "PackedReadBatch",
    "BatchReader",
    "read_batches",
    "LazyIds",
    "length_wire_dtype",
    "WireLayout",
]


def length_wire_dtype(max_len: int) -> type:
    """Narrowest numpy dtype that holds every per-read length for a batch
    width (int32 lengths would be ~7.5% of the packed wire at 128-base
    reads; uint8 is ~0.9%).  Device steps widen back to int32."""
    if max_len <= 0xFF:
        return np.uint8
    if max_len <= 0xFFFF:
        return np.uint16
    return np.int32


# scatter index used to pad lean vrow planes up to a compile-stable bucket
# size: out of range for any real batch, dropped by the device scatter
VROW_PAD_INDEX = np.int32(1 << 30)


class WireLayout(NamedTuple):
    """Static section map of a coalesced one-buffer batch transport.

    The packed counting drivers ship each batch as ONE contiguous uint8
    buffer (one host->device copy instead of 4-5).  Sections, in order:

      codes [B*l4] | validity | lengths [B*len_size] | vrow_idx [vcap*4]

    where validity is dense ``[B*l8]`` (vmode=1), lean rows ``[vcap*l8]``
    (vmode=2) or empty (vmode=0 — clean batch), lengths ride the narrowest
    dtype little-endian, and lean row indices ride int32 little-endian.
    The device side slices the sections as views of the one buffer.
    """

    num_reads: int
    l4: int  # codes columns (max_len / 4)
    l8: int  # validity columns (0 when vmode == 0)
    len_size: int  # bytes per length entry (1 / 2 / 4)
    vcap: int  # padded lean row count (vmode == 2), else 0
    vmode: int  # 0 = clean, 1 = dense vbits, 2 = lean rows

    @property
    def codes_end(self) -> int:
        return self.num_reads * self.l4

    @property
    def val_end(self) -> int:
        rows = self.num_reads if self.vmode == 1 else self.vcap
        return self.codes_end + (rows * self.l8 if self.vmode else 0)

    @property
    def len_end(self) -> int:
        return self.val_end + self.num_reads * self.len_size

    @property
    def nbytes(self) -> int:
        return self.len_end + (self.vcap * 4 if self.vmode == 2 else 0)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


class LazyIds:
    """Sequence of record ids backed by one '\n'-separated packed blob.

    Building a Python ``bytes`` object per record costs more than framing
    the record; this wraps the C framer's packed id buffer and only
    materializes the ids a consumer actually touches (``ids[i]`` slices
    the blob; full iteration does a single C-level ``split``).  Compares
    equal to the equivalent ``list[bytes]``.
    """

    __slots__ = ("_blob", "_bounds", "_list")

    def __init__(self, blob: bytes, n: Optional[int] = None) -> None:
        self._blob = blob
        self._list: Optional[List[bytes]] = None
        if blob:
            nl = np.flatnonzero(
                np.frombuffer(blob, dtype=np.uint8) == 0x0A
            ).astype(np.int64)
            self._bounds = np.concatenate([np.zeros(1, np.int64), nl + 1])
        else:
            self._bounds = np.zeros(1, np.int64)
        if n is not None and len(self) != n:
            raise ValueError(f"blob holds {len(self)} ids, expected {n}")

    def _as_list(self) -> List[bytes]:
        if self._list is None:
            self._list = self._blob.split(b"\n")[:-1] if self._blob else []
        return self._list

    def __len__(self) -> int:
        return self._bounds.shape[0] - 1

    def __getitem__(self, i):
        if isinstance(i, slice):
            return self._as_list()[i]
        n = len(self)
        if i < 0:
            i += n
        if not 0 <= i < n:
            raise IndexError(i)
        return self._blob[int(self._bounds[i]) : int(self._bounds[i + 1]) - 1]

    def __iter__(self):
        return iter(self._as_list())

    def __eq__(self, other):
        if isinstance(other, LazyIds):
            return self._as_list() == other._as_list()
        if isinstance(other, (list, tuple)):
            return self._as_list() == list(other)
        return NotImplemented

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"LazyIds(n={len(self)})"

    def __reduce__(self):
        # pickles as the compact blob (worker -> consumer IPC)
        return (LazyIds, (self._blob,))


@dataclass
class ReadBatch:
    """A fixed-shape batch of reads.

    ``seqs``: uint8 [B, L], zero-padded (0 is never a valid base so padding is
    inert in every kernel). ``lengths``: int32 [B]. ``quals``: uint8 [B, L]
    or None (FASTA). ``ids``: raw header bytes, host-side only.
    """

    seqs: np.ndarray
    lengths: np.ndarray
    quals: Optional[np.ndarray] = None
    ids: List[bytes] = field(default_factory=list)
    # byte offset one past the last record of this batch in the source
    # stream (record-aligned resume point for checkpointing); None when
    # unknown (pure-Python framing, mid-tail flushes, interleaved workers)
    file_offset: Optional[int] = None

    @property
    def num_reads(self) -> int:
        return int(self.seqs.shape[0])

    @property
    def max_len(self) -> int:
        return int(self.seqs.shape[1])

    @property
    def num_bases(self) -> int:
        return int(self.lengths.sum())

    @classmethod
    def from_records(
        cls,
        records: Sequence[SequenceRecord],
        max_len: Optional[int] = None,
        pad_reads_to: int = 1,
        pad_len_to: int = 128,
        keep_ids: bool = True,
    ) -> "ReadBatch":
        """Build a batch from framed records (uses the newline-stripped
        ``seq()``; quality lines are carried when every record has one).
        Zero records yield a genuinely empty batch (num_reads == 0)."""
        seq_bytes = [r.seq() for r in records]
        quals = [r.qual() for r in records]
        has_qual = all(q is not None for q in quals) and len(records) > 0
        lengths = np.array([len(s) for s in seq_bytes], dtype=np.int32)
        longest = int(lengths.max()) if len(seq_bytes) else 0
        if max_len is None:
            max_len = _round_up(max(longest, 1), pad_len_to)
        n = _round_up(len(seq_bytes), pad_reads_to) if seq_bytes else 0

        seqs = np.zeros((n, max_len), dtype=np.uint8)
        for i, s in enumerate(seq_bytes):
            if len(s) > max_len:
                raise ValueError(
                    f"record {i} length {len(s)} exceeds batch max_len {max_len}"
                )
            seqs[i, : len(s)] = np.frombuffer(s, dtype=np.uint8)

        qarr = None
        if has_qual:
            qarr = np.zeros((n, max_len), dtype=np.uint8)
            for i, q in enumerate(quals):
                qarr[i, : len(q)] = np.frombuffer(q, dtype=np.uint8)

        full_lengths = np.zeros(n, dtype=np.int32)
        full_lengths[: len(lengths)] = lengths
        return cls(
            seqs=seqs,
            lengths=full_lengths,
            quals=qarr,
            ids=[r.id() for r in records] if keep_ids else [],
        )

    def pad_reads_to(self, n: int) -> "ReadBatch":
        """Zero-pad the read dimension up to ``n`` (e.g. for even sharding)."""
        if n < self.num_reads:
            raise ValueError(f"cannot shrink batch {self.num_reads} -> {n}")
        if n == self.num_reads:
            return self
        seqs = np.zeros((n, self.max_len), dtype=np.uint8)
        seqs[: self.num_reads] = self.seqs
        lengths = np.zeros(n, dtype=np.int32)
        lengths[: self.num_reads] = self.lengths
        quals = None
        if self.quals is not None:
            quals = np.zeros((n, self.max_len), dtype=np.uint8)
            quals[: self.num_reads] = self.quals
        return ReadBatch(seqs=seqs, lengths=lengths, quals=quals,
                         ids=list(self.ids), file_offset=self.file_offset)


@dataclass
class PackedReadBatch:
    """A fixed-shape batch in the 2-bit packed transport format.

    ``codes``: uint8 [B, L/4] — 4 bases/byte, base j at bits ``2*(j&3)`` of
    byte ``j>>2`` (see ``needletail_tpu_torch.encoding`` for the full layout and
    LUT contract).  Validity rides one of THREE shapes (at most one set):

      * both None — every in-length base is a real base (clean fast path);
      * ``vbits`` uint8 [B, L/8] — the dense validity bitplane;
      * ``vrows`` uint8 [D, L/8] + ``vrow_idx`` int32 [D] — the LEAN
        transport: validity rows only for the D reads that
        actually contain an ambiguous base.  Rows not listed are fully
        valid in-length.  The framers pick lean vs dense by wire bytes
        (``D * (L/8 + 4) < B * L/8``), so real-world corpora (N rate well
        under 1 read in 2) ship ~0 validity bytes instead of 0.125 B/base.

    ``normalized`` records which encode LUT packed the batch.

    This is what ships host->device on the packed counting paths: ~0.25
    bytes/base instead of 1 (+1 for quals).  Quality planes are never
    packed (the counting pipelines do not read them).
    """

    codes: np.ndarray
    lengths: np.ndarray
    vbits: Optional[np.ndarray] = None
    ids: List[bytes] = field(default_factory=list)
    normalized: bool = True
    # record-aligned resume offset; see ReadBatch.file_offset
    file_offset: Optional[int] = None
    # lean validity (mutually exclusive with vbits; see class docstring)
    vrows: Optional[np.ndarray] = None
    vrow_idx: Optional[np.ndarray] = None

    @property
    def num_reads(self) -> int:
        return int(self.codes.shape[0])

    @property
    def max_len(self) -> int:
        return int(self.codes.shape[1]) * 4

    @property
    def num_bases(self) -> int:
        return int(self.lengths.sum())

    @property
    def quals(self):  # counting-path duck-typing with ReadBatch
        return None

    @classmethod
    def from_read_batch(
        cls, batch: ReadBatch, normalized: bool = True
    ) -> "PackedReadBatch":
        """Pack an ASCII batch (numpy fallback / test oracle path).
        Emits the same lean/dense validity shape as the native framers."""
        from .encoding import pack_codes_host_rows

        codes, vbits, row_invalid = pack_codes_host_rows(
            batch.seqs, batch.lengths, normalized=normalized
        )
        out = cls(
            codes=codes,
            lengths=batch.lengths,
            vbits=vbits,
            ids=batch.ids,
            normalized=normalized,
            file_offset=batch.file_offset,
        )
        return out.to_lean(row_invalid)

    @staticmethod
    def pick_lean(n_dirty: int, num_reads: int, vplane_cols: int) -> bool:
        """The one lean-vs-dense wire rule: ragged dirty rows win iff they
        ship fewer bytes than the dense bitplane (row bytes + int32 index
        per dirty row vs one bitplane row per read)."""
        return n_dirty * (vplane_cols + 4) < num_reads * vplane_cols

    def to_lean(self, row_invalid: np.ndarray) -> "PackedReadBatch":
        """Convert a dense-vbits batch to the lean shape when it wins by
        wire bytes; ``row_invalid`` is the per-row invalid-base count."""
        if self.vbits is None:
            return self
        rows = np.flatnonzero(row_invalid[: self.num_reads]).astype(np.int32)
        if not self.pick_lean(rows.size, self.num_reads, self.vbits.shape[1]):
            return self
        self.vrows = np.ascontiguousarray(self.vbits[rows])
        self.vrow_idx = rows
        self.vbits = None
        return self

    def wire_nbytes(self) -> int:
        """Bytes this batch ships host->device under the lean-transport
        placement conventions (narrow lengths, power-of-two-padded vrow
        planes) — the h2d meter's payload accounting."""
        n = self.codes.nbytes + self.num_reads * np.dtype(
            length_wire_dtype(self.max_len)
        ).itemsize
        if self.vbits is not None:
            n += self.vbits.nbytes
        elif self.vrows is not None:
            d = int(self.vrow_idx.shape[0])
            cap = 8 if d <= 8 else 1 << (d - 1).bit_length()
            n += cap * (self.vrows.shape[1] + 4)
        return n

    def dense_vbits(self) -> Optional[np.ndarray]:
        """The dense [B, L/8] validity bitplane, materialized host-side
        from the lean shape if needed; None for clean batches.  Consumers
        that haven't adopted the lean transport call this instead of
        reading ``.vbits`` directly (reading ``.vbits`` on a lean batch
        would silently treat dirty reads as clean)."""
        if self.vbits is not None:
            return self.vbits
        if self.vrows is None:
            return None
        l8 = self.vrows.shape[1]
        plane = np.empty((self.num_reads, l8), dtype=np.uint8)
        plane[:] = 0xFF
        # out-of-length bits don't matter (every kernel masks windows by
        # per-read length), so clean rows are all-ones
        plane[self.vrow_idx] = self.vrows
        return plane

    def unpack_host(self) -> np.ndarray:
        """Per-base codes [B, L] uint8 (255 invalid) on host — for tests.
        Out-of-length lanes are masked invalid (lean rows carry no pad
        validity, so the dense twin's pad-invalid convention is restored
        from ``lengths``)."""
        from .encoding import unpack_codes_host

        out = unpack_codes_host(self.codes, self.dense_vbits())
        if self.vrows is not None:
            pad = (
                np.arange(out.shape[1], dtype=np.int32)[None, :]
                >= self.lengths[:, None]
            )
            out[pad] = 255
        return out

    def wire_frame(self, batch_size: int) -> "tuple[np.ndarray, WireLayout]":
        """Coalesce this batch into ONE contiguous uint8 wire buffer plus
        its static :class:`WireLayout` (see that class for the section
        map).  Read-dimension padding up to ``batch_size`` is folded into
        the buffer fill (padded rows are all-zero codes with length 0), so
        the short final batch costs no extra plane copies."""
        n = self.num_reads
        if n > batch_size:
            raise ValueError(f"batch {n} > wire batch_size {batch_size}")
        l4 = int(self.codes.shape[1])
        if self.vbits is not None:
            vmode, l8, vcap = 1, int(self.vbits.shape[1]), 0
        elif self.vrows is not None:
            d = int(self.vrow_idx.shape[0])
            vmode, l8 = 2, int(self.vrows.shape[1])
            vcap = 8 if d <= 8 else 1 << (d - 1).bit_length()
        else:
            vmode, l8, vcap = 0, 0, 0
        ldt = length_wire_dtype(self.max_len)
        layout = WireLayout(
            batch_size, l4, l8, np.dtype(ldt).itemsize, vcap, vmode
        )
        buf = np.zeros(layout.nbytes, dtype=np.uint8)
        buf[: n * l4] = self.codes.reshape(-1)
        o = layout.codes_end
        if vmode == 1:
            buf[o : o + n * l8] = self.vbits.reshape(-1)
        elif vmode == 2:
            d = int(self.vrow_idx.shape[0])
            buf[o : o + d * l8] = self.vrows.reshape(-1)
        o = layout.val_end
        # explicit little-endian: the device side recomposes from byte
        # planes, so the wire bytes must not depend on host endianness
        lens = np.ascontiguousarray(
            self.lengths[:n].astype(np.dtype(ldt).newbyteorder("<"), copy=False)
        )
        buf[o : o + lens.nbytes] = lens.view(np.uint8)
        if vmode == 2:
            idx = np.full(vcap, VROW_PAD_INDEX, dtype="<i4")
            idx[:d] = self.vrow_idx
            buf[layout.len_end :] = idx.view(np.uint8)
        return buf, layout

    def pad_reads_to(self, n: int) -> "PackedReadBatch":
        """Zero-pad the read dimension up to ``n`` (for even sharding)."""
        if n < self.num_reads:
            raise ValueError(f"cannot shrink batch {self.num_reads} -> {n}")
        if n == self.num_reads:
            return self
        codes = np.zeros((n, self.codes.shape[1]), dtype=np.uint8)
        codes[: self.num_reads] = self.codes
        lengths = np.zeros(n, dtype=np.int32)
        lengths[: self.num_reads] = self.lengths
        vbits = None
        if self.vbits is not None:
            vbits = np.zeros((n, self.vbits.shape[1]), dtype=np.uint8)
            vbits[: self.num_reads] = self.vbits
        # lean rows index original reads; padding rows are length-0 and
        # need no validity, so vrows/vrow_idx pass through unchanged
        return PackedReadBatch(
            codes=codes, lengths=lengths, vbits=vbits, ids=list(self.ids),
            normalized=self.normalized, file_offset=self.file_offset,
            vrows=self.vrows, vrow_idx=self.vrow_idx,
        )


class BatchReader:
    """Adapt a ``FastxReader`` into an iterator of ``ReadBatch``es.

    Reads are grouped ``batch_size`` at a time; sequence length is padded to
    the next multiple of ``pad_len_to`` within each batch (bucketed shapes),
    or to a fixed ``max_len`` when given (single compiled shape).
    """

    def __init__(
        self,
        reader: FastxReader,
        batch_size: int = 1024,
        max_len: Optional[int] = None,
        pad_len_to: int = 128,
        keep_ids: bool = True,
    ) -> None:
        self._reader = reader
        self._batch_size = batch_size
        self._max_len = max_len
        self._pad_len_to = pad_len_to
        self._keep_ids = keep_ids

    def __iter__(self) -> Iterator[ReadBatch]:
        while True:
            records = []
            while len(records) < self._batch_size:
                rec = self._reader.next()
                if rec is None:
                    break
                records.append(rec)
            if not records:
                return
            yield ReadBatch.from_records(
                records,
                max_len=self._max_len,
                pad_reads_to=self._batch_size if len(records) == self._batch_size else 1,
                pad_len_to=self._pad_len_to,
                keep_ids=self._keep_ids,
            )


def read_batches(
    path: Union[str, "Path"],  # noqa: F821 - Path only for typing
    batch_size: int = 1024,
    max_len: Optional[int] = None,
    pad_len_to: int = 128,
) -> Iterator[ReadBatch]:
    """Stream a FASTA/FASTQ file (any supported compression) as batches."""
    return iter(
        BatchReader(
            parse_fastx_file(path),
            batch_size=batch_size,
            max_len=max_len,
            pad_len_to=pad_len_to,
        )
    )
