"""High-level, needletail-compatible Python API (ref needletail src/python.rs).

Drop-in surface for users of the reference's PyO3 bindings:
``parse_fastx_file``, ``parse_fastx_string``, ``normalize_seq``,
``reverse_complement``, ``decode_phred``, classes ``FastxReader`` and
``Record``, and the single ``NeedletailError`` exception.  Strings in,
strings out (the reference decodes record fields with lossy UTF-8,
ref python.rs:136-143).

The port's copy of the JAX package's ``api.py``.
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterator, Optional, Tuple, Union

from . import parser as _parser
from . import quality as _quality
from . import sequence as _sequence
from .errors import NeedletailError, ParseError, PhredOffsetError

__all__ = [
    "FastxReader",
    "Record",
    "NeedletailError",
    "parse_fastx_file",
    "parse_fastx_string",
    "normalize_seq",
    "reverse_complement",
    "decode_phred",
]

_LOSSY = dict(errors="replace")


def _get_seq_snippet(seq: str, max_len: int = 20) -> str:
    """Ref python.rs:37-45."""
    if len(seq) > max_len:
        return f"{seq[: max_len - 4]}…{seq[-3:]}"
    return seq


class Record:
    """A record representing a biological sequence (ref python.rs:126-264).

    Attributes ``id``/``seq``/``qual`` are owned strings; ``name`` is the id
    up to the first whitespace, ``description`` the remainder (or None).
    """

    __slots__ = ("id", "seq", "qual")

    def __init__(self, id: str, seq: str, qual: Optional[str] = None) -> None:
        if qual is not None and len(qual) != len(seq):
            raise ValueError(
                "Sequence and quality strings must have the same length"
            )
        self.id = id
        self.seq = seq
        self.qual = qual

    @classmethod
    def _from_sequence_record(cls, rec: "_parser.SequenceRecord") -> "Record":
        obj = cls.__new__(cls)
        obj.id = rec.id().decode("utf-8", **_LOSSY)
        obj.seq = rec.seq().decode("utf-8", **_LOSSY)
        q = rec.qual()
        obj.qual = None if q is None else q.decode("utf-8", **_LOSSY)
        return obj

    # -- properties ---------------------------------------------------------
    @property
    def name(self) -> str:
        """Id up to the first whitespace character (ref python.rs:147-154)."""
        for i, ch in enumerate(self.id):
            if ch.isspace():
                return self.id[:i]
        return self.id

    @property
    def description(self) -> Optional[str]:
        """Id after the first whitespace, lstripped (ref python.rs:156-163)."""
        for i, ch in enumerate(self.id):
            if ch.isspace():
                return self.id[i:].lstrip()
        return None

    # -- methods -------------------------------------------------------------
    def is_fasta(self) -> bool:
        return self.qual is None

    def is_fastq(self) -> bool:
        return self.qual is not None

    def normalize(self, iupac: bool = False) -> None:
        """Normalize ``seq`` in place (ref python.rs:196-202)."""
        out = _sequence.normalize(self.seq.encode("utf-8"), iupac)
        if out is not None:
            self.seq = out.decode("utf-8", **_LOSSY)

    # -- dunder --------------------------------------------------------------
    def __hash__(self) -> int:
        return hash((self.id, self.seq, self.qual))

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, Record):
            return NotImplemented
        return (
            self.id == other.id and self.seq == other.seq and self.qual == other.qual
        )

    def __len__(self) -> int:
        return len(self.seq)

    def __str__(self) -> str:
        if self.qual is None:
            return f">{self.id}\n{self.seq}\n"
        return f"@{self.id}\n{self.seq}\n+\n{self.qual}\n"

    def __repr__(self) -> str:
        name = self.name
        id_snippet = f"{name}…" if name != self.id else name
        seq_snippet = _get_seq_snippet(self.seq)
        qual_snippet = _get_seq_snippet(self.qual) if self.qual is not None else "None"
        return f"Record(id={id_snippet}, seq={seq_snippet}, qual={qual_snippet})"


class FastxReader:
    """An iterator that yields ``Record`` objects (ref python.rs:62-86)."""

    def __init__(self, reader: "_parser.FastxReader") -> None:
        self._reader = reader

    def __repr__(self) -> str:
        return "<FastxReader>"

    def __iter__(self) -> Iterator[Record]:
        return self

    def __next__(self) -> Record:
        try:
            rec = self._reader.next()
        except ParseError as exc:
            raise NeedletailError(str(exc)) from exc
        if rec is None:
            raise StopIteration
        return Record._from_sequence_record(rec)


def parse_fastx_file(path: Union[str, Path]) -> FastxReader:
    """Parse a FASTA/FASTQ file into an iterator of ``Record`` objects
    (ref python.rs:291-298). Raises ``NeedletailError`` on any parse/IO error.
    """
    try:
        return FastxReader(_parser.parse_fastx_file(path))
    except ParseError as exc:
        raise NeedletailError(str(exc)) from exc


def parse_fastx_string(content: str) -> FastxReader:
    """Parse FASTA/FASTQ records out of a string (ref python.rs:325-331)."""
    try:
        return FastxReader(_parser.parse_fastx_reader(content.encode("utf-8")))
    except ParseError as exc:
        raise NeedletailError(str(exc)) from exc


def normalize_seq(seq: str, iupac: bool = False) -> str:
    """Normalize a nucleotide string (ref python.rs:363-371)."""
    out = _sequence.normalize(seq.encode("utf-8"), iupac)
    if out is None:
        return seq
    return out.decode("utf-8", **_LOSSY)


def reverse_complement(seq: str) -> str:
    """Reverse complement of a nucleotide string (ref python.rs:390-399)."""
    return _sequence.reverse_complement(seq.encode("utf-8")).decode("utf-8", **_LOSSY)


def decode_phred(qual: str, base_64: bool = False) -> Tuple[int, ...]:
    """Decode a Phred quality string to a tuple of scores
    (ref python.rs:416-427). Raises ``ValueError`` on invalid characters."""
    encoding = (
        _quality.PhredEncoding.PHRED64 if base_64 else _quality.PhredEncoding.PHRED33
    )
    try:
        scores = _quality.decode_phred(qual.encode("utf-8"), encoding)
    except PhredOffsetError as exc:
        raise ValueError(f"Invalid Phred quality: {exc}") from exc
    return tuple(scores)
