"""Error taxonomy of the port.

The port's copy of the JAX package's ``errors.py``, which mirrors the
reference error model (needletail ``src/errors.rs``): a single
``ParseError`` carrying a kind, a human message, an ``ErrorPosition``
(line number + record id when known) and the format being parsed, plus
``PhredOffsetError`` for quality decoding.  The Python-facing exception
type (``NeedletailError``, ref ``src/python.rs:28``) wraps everything for
the high-level API.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Optional


class Format(enum.Enum):
    """FASTA or FASTQ? (ref src/parser/utils.rs:76-88)"""

    FASTA = "fasta"
    FASTQ = "fastq"

    @property
    def start_char(self) -> str:
        return ">" if self is Format.FASTA else "@"


class ParseErrorKind(enum.Enum):
    """The type of error that occurred during parsing (ref src/errors.rs:28-43)."""

    IO = "io"
    UNKNOWN_FORMAT = "unknown_format"
    INVALID_START = "invalid_start"
    INVALID_SEPARATOR = "invalid_separator"
    UNEQUAL_LENGTHS = "unequal_lengths"
    UNEXPECTED_END = "unexpected_end"
    EMPTY_FILE = "empty_file"


@dataclass(frozen=True)
class ErrorPosition:
    """Where we were in a file when an error occurred (ref src/errors.rs:10-24).

    ``line`` starts at 1; ``id`` is the record name up to the first space when
    available.
    """

    line: int = 0
    id: Optional[str] = None

    def __str__(self) -> str:
        if self.id is not None:
            return f"record '{self.id}' at line {self.line}"
        return f"line {self.line}"


def _escape_byte(byte: int) -> str:
    """Mimic Rust's ``char::escape_default`` for a single byte."""
    ch = chr(byte)
    if ch == "\t":
        return "\\t"
    if ch == "\r":
        return "\\r"
    if ch == "\n":
        return "\\n"
    if ch == "\\":
        return "\\\\"
    if ch == "'":
        return "\\'"
    if ch == '"':
        return '\\"'
    if 0x20 <= byte <= 0x7E:
        return ch
    return "\\u{" + format(byte, "x") + "}"


class ParseError(Exception):
    """The only error type the parsers raise (ref src/errors.rs:47-126)."""

    def __init__(
        self,
        msg: str,
        kind: ParseErrorKind,
        position: Optional[ErrorPosition] = None,
        format: Optional[Format] = None,
    ) -> None:
        super().__init__(msg)
        self.msg = msg
        self.kind = kind
        self.position = position if position is not None else ErrorPosition()
        self.format = format

    def __reduce__(self):
        # picklable across process boundaries (multiprocess framing workers)
        return (ParseError, (self.msg, self.kind, self.position, self.format))

    # ---- constructors matching the reference (src/errors.rs:59-126) ----
    @classmethod
    def new_invalid_start(
        cls, byte_found: int, position: ErrorPosition, format: Format
    ) -> "ParseError":
        msg = (
            f"Expected '{format.start_char}' but found "
            f"'{_escape_byte(byte_found)}"
        )
        return cls(msg, ParseErrorKind.INVALID_START, position, format)

    @classmethod
    def new_invalid_separator(
        cls, byte_found: int, position: ErrorPosition
    ) -> "ParseError":
        msg = f"Expected '+' separator but found '{_escape_byte(byte_found)}"
        return cls(msg, ParseErrorKind.INVALID_SEPARATOR, position, Format.FASTQ)

    @classmethod
    def new_unknown_format(cls, byte_found: int) -> "ParseError":
        msg = (
            "Expected '@' or '>' at the start of the file but found "
            f"'{_escape_byte(byte_found)}'."
        )
        return cls(msg, ParseErrorKind.UNKNOWN_FORMAT, ErrorPosition(), Format.FASTQ)

    @classmethod
    def new_unequal_length(
        cls, seq_len: int, qual_len: int, position: ErrorPosition
    ) -> "ParseError":
        msg = f"Sequence length is {seq_len} but quality length is {qual_len}"
        return cls(msg, ParseErrorKind.UNEQUAL_LENGTHS, position, Format.FASTQ)

    @classmethod
    def new_unexpected_end(
        cls, position: ErrorPosition, format: Format
    ) -> "ParseError":
        return cls("", ParseErrorKind.UNEXPECTED_END, position, format)

    @classmethod
    def new_empty_file(cls) -> "ParseError":
        return cls(
            "Failed to read the first two bytes. Is the file empty?",
            ParseErrorKind.EMPTY_FILE,
            ErrorPosition(),
            None,
        )

    @classmethod
    def from_io(cls, err: OSError) -> "ParseError":
        return cls(str(err), ParseErrorKind.IO, ErrorPosition(), None)

    def __str__(self) -> str:  # Display (ref src/errors.rs:128-142)
        if self.kind is ParseErrorKind.IO:
            return f"I/O error: {self.msg}"
        if self.kind is ParseErrorKind.UNEXPECTED_END:
            return f"Unexpected end of input ({self.position})."
        return f"{self.msg} ({self.position})"

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, ParseError):
            return NotImplemented
        return (
            self.msg == other.msg
            and self.kind == other.kind
            and self.position == other.position
            and self.format == other.format
        )

    def __hash__(self) -> int:
        return hash((self.msg, self.kind, self.position, self.format))


@dataclass(frozen=True)
class PhredOffsetError(Exception):
    """Error during decoding of FASTQ quality data (ref src/errors.rs:166-181)."""

    q: int = 0
    offset: int = 0

    def __str__(self) -> str:
        return (
            f"character '{chr(self.q)}' cannot be decoded with offset "
            f"'{self.offset}'"
        )


class NeedletailError(Exception):
    """Single exception type for the high-level Python API (ref src/python.rs:28)."""
