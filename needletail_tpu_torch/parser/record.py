"""SequenceRecord and round-trip writers (ref needletail src/parser/record.rs).

The port's copy of the JAX package's ``parser/record.py``.  A
``SequenceRecord`` is a view over one framed FASTA/FASTQ record.  Unlike the
reference (which borrows from the parser's buffer), records here own their
byte span — Python slicing copies anyway, and the batch path avoids
per-record objects entirely.
"""

from __future__ import annotations

from typing import IO, Optional

from .. import bitkmer as _bitkmer
from .. import kmer as _kmer
from .. import sequence as _sequence
from ..errors import Format
from ..quality import PhredEncoding, decode_phred
from .utils import LineEnding, Position, trim_cr

__all__ = [
    "SequenceRecord",
    "write_fasta",
    "write_fastq",
    "mask_header_tabs",
    "mask_header_utf8",
]


class SequenceRecord:
    """One FASTA or FASTQ record (ref record.rs:21-178).

    Accessors match the reference: ``id``/``raw_seq``/``seq``/``qual``/``all``/
    ``num_bases``/``start_line_number``/``position``/``line_ending``/``write``/
    ``decode_phred``.
    """

    __slots__ = (
        "_format",
        "_all",
        "_first_nl",
        "_seq_off",
        "_sep_off",
        "_qual_off",
        "_position",
        "_line_ending",
    )

    def __init__(
        self,
        format: Format,
        all_bytes: bytes,
        position: Position,
        line_ending: Optional[LineEnding],
        *,
        first_nl: Optional[int] = None,
        seq_off: int = 0,
        sep_off: int = 0,
        qual_off: int = 0,
    ) -> None:
        self._format = format
        self._all = all_bytes
        self._first_nl = first_nl
        self._seq_off = seq_off
        self._sep_off = sep_off
        self._qual_off = qual_off
        self._position = position
        # Records always report a line ending (default Unix, ref record.rs:39)
        self._line_ending = line_ending if line_ending is not None else LineEnding.UNIX

    # -- constructors ------------------------------------------------------
    @classmethod
    def new_fasta(
        cls,
        all_bytes: bytes,
        first_nl: Optional[int],
        position: Position,
        line_ending: Optional[LineEnding],
    ) -> "SequenceRecord":
        """``all_bytes`` is the record span without the trailing newline;
        ``first_nl`` is the offset of the header-terminating newline within
        it (None when the record is a bare header)."""
        return cls(
            Format.FASTA, all_bytes, position, line_ending, first_nl=first_nl
        )

    @classmethod
    def new_fastq(
        cls,
        all_bytes: bytes,
        seq_off: int,
        sep_off: int,
        qual_off: int,
        position: Position,
        line_ending: Optional[LineEnding],
    ) -> "SequenceRecord":
        """Offsets are within ``all_bytes``: start of the sequence line, of the
        separator line, and of the quality line (one past each newline)."""
        return cls(
            Format.FASTQ,
            all_bytes,
            position,
            line_ending,
            seq_off=seq_off,
            sep_off=sep_off,
            qual_off=qual_off,
        )

    # -- accessors ----------------------------------------------------------
    def format(self) -> Format:
        return self._format

    def id(self) -> bytes:
        """Record id: everything after '>'/'@' on the header line
        (ref fasta.rs:50, fastq.rs:37)."""
        if self._format is Format.FASTA:
            end = self._first_nl if self._first_nl is not None else len(self._all)
            return trim_cr(self._all[1:end])
        return trim_cr(self._all[1 : self._seq_off - 1])

    def raw_seq(self) -> bytes:
        """Sequence bytes as present in the file — FASTA keeps internal
        newlines (ref fasta.rs:55-63, fastq.rs:42-44)."""
        if self._format is Format.FASTA:
            if self._first_nl is None:
                return b""
            return trim_cr(self._all[self._first_nl + 1 :])
        return trim_cr(self._all[self._seq_off : self._sep_off - 1])

    def seq(self) -> bytes:
        """Cleaned-up sequence: FASTA minus all ``\\r\\n`` (ref record.rs:87-92)."""
        if self._format is Format.FASTA:
            return _sequence.strip_returns(self.raw_seq())
        return self.raw_seq()

    def qual(self) -> Optional[bytes]:
        """Quality line; always None for FASTA, Some (possibly empty) for
        FASTQ (ref record.rs:94-102)."""
        if self._format is Format.FASTA:
            return None
        return trim_cr(self._all[self._qual_off :])

    def decode_phred(
        self, encoding: PhredEncoding = PhredEncoding.PHRED33
    ) -> Optional[bytes]:
        """Decode the quality line to scores (ref record.rs:109-121); None for
        FASTA; raises PhredOffsetError on out-of-range chars."""
        q = self.qual()
        if q is None:
            return None
        return decode_phred(q, encoding)

    def all(self) -> bytes:
        """Full record span including internal line endings, without a
        trailing newline (ref record.rs:123-130)."""
        return self._all

    def num_bases(self) -> int:
        """Number of bases, computed without materializing ``seq()``
        (ref fasta.rs:102-107, fastq.rs:52-54)."""
        raw = self.raw_seq()
        if self._format is Format.FASTA:
            return len(raw) - raw.count(b"\n") - raw.count(b"\r")
        return len(raw)

    def start_line_number(self) -> int:
        """Line number in the file where this record starts (ref record.rs:142)."""
        return self._position.line()

    def position(self) -> Position:
        return self._position

    def line_ending(self) -> LineEnding:
        return self._line_ending

    def write(
        self, writer: IO[bytes], forced_line_ending: Optional[LineEnding] = None
    ) -> None:
        """Round-trip the record, preserving the original line ending unless
        forced (ref record.rs:158-178)."""
        ending = forced_line_ending or self._line_ending
        if self._format is Format.FASTA:
            write_fasta(self.id(), self.raw_seq(), writer, ending)
        else:
            write_fastq(self.id(), self.raw_seq(), self.qual(), writer, ending)

    # -- Sequence-trait conveniences (ref record.rs:181-185 + sequence.rs) ---
    def sequence(self) -> bytes:
        return self.raw_seq()

    def normalize(self, iupac: bool = False) -> bytes:
        out = _sequence.normalize(self.raw_seq(), iupac)
        return out if out is not None else self.raw_seq()

    def strip_returns(self) -> bytes:
        return _sequence.strip_returns(self.raw_seq())

    def reverse_complement(self) -> bytes:
        return _sequence.reverse_complement(self.raw_seq())

    def kmers(self, k: int):
        return _kmer.kmers(self.raw_seq(), k)

    def canonical_kmers(self, k: int, reverse_complement: bytes):
        return _kmer.canonical_kmers(self.raw_seq(), reverse_complement, k)

    def bit_kmers(self, k: int, canonical: bool = False):
        return _bitkmer.bit_kmers(self.raw_seq(), k, canonical)

    def __repr__(self) -> str:
        return (
            f"SequenceRecord(format={self._format.value}, id={self.id()!r}, "
            f"len={self.num_bases()})"
        )


def mask_header_tabs(id: bytes) -> Optional[bytes]:
    """Mask tabs in header lines to ``|`` (ref record.rs:188-194); None when
    there were none."""
    if b"\t" not in id:
        return None
    return id.replace(b"\t", b"|")


def mask_header_utf8(id: bytes) -> Optional[bytes]:
    """Convert invalid UTF-8 to replacement chars (ref record.rs:197-204);
    None when already valid."""
    decoded = id.decode("utf-8", errors="replace")
    out = decoded.encode("utf-8")
    return None if out == id else out


def write_fasta(
    id: bytes, seq: bytes, writer: IO[bytes], line_ending: LineEnding = LineEnding.UNIX
) -> None:
    """Write a FASTA record (ref record.rs:207-220)."""
    ending = line_ending.to_bytes()
    writer.write(b">" + id + ending + seq + ending)


def write_fastq(
    id: bytes,
    seq: bytes,
    qual: Optional[bytes],
    writer: IO[bytes],
    line_ending: LineEnding = LineEnding.UNIX,
) -> None:
    """Write a FASTQ record; a missing quality line is filled with ``I``
    (ref record.rs:222-247)."""
    ending = line_ending.to_bytes()
    if qual is None:
        qual = b"I" * len(seq)
    writer.write(b"@" + id + ending + seq + ending + b"+" + ending + qual + ending)
