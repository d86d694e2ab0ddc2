"""SequenceRecord (ref needletail src/parser/record.rs).

The port's copy of ``needletail_tpu/parser/record.py``, cut to what the
framers and batches need: the record accessors.  A ``SequenceRecord`` is a
view over one framed FASTA/FASTQ record that owns its byte span.
"""

from __future__ import annotations

from typing import Optional

from ..errors import Format
from .utils import LineEnding, Position, trim_cr

__all__ = ["SequenceRecord"]


class SequenceRecord:
    """One FASTA or FASTQ record (ref record.rs:21-178).

    Accessors match the reference: ``id``/``raw_seq``/``seq``/``qual``/``all``/
    ``num_bases``/``start_line_number``/``position``/``line_ending``.
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
            return self.raw_seq().replace(b"\r", b"").replace(b"\n", b"")
        return self.raw_seq()

    def qual(self) -> Optional[bytes]:
        """Quality line; always None for FASTA, Some (possibly empty) for
        FASTQ (ref record.rs:94-102)."""
        if self._format is Format.FASTA:
            return None
        return trim_cr(self._all[self._qual_off :])

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

    def __repr__(self) -> str:
        return (
            f"SequenceRecord(format={self._format.value}, id={self.id()!r}, "
            f"len={self.num_bases()})"
        )

