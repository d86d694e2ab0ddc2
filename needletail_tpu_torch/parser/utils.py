"""Shared parser types: Position, LineEnding, Format, FastxReader protocol.

Mirrors needletail ``src/parser/utils.rs``.
"""

from __future__ import annotations

import enum
from abc import ABC, abstractmethod
from typing import Iterator, Optional

from ..errors import Format, ParseError

__all__ = [
    "BUFSIZE",
    "Position",
    "Format",
    "LineEnding",
    "find_line_ending",
    "trim_cr",
    "FastxReader",
]

# Default read-chunk size (ref utils.rs:8 uses 64 KiB; we read bigger host
# chunks since Python call overhead dominates, semantics are unaffected).
BUFSIZE = 64 * 1024
CHUNK = 1 << 20


def trim_cr(line: bytes) -> bytes:
    """Remove a final ``\\r`` from a byte slice (ref utils.rs:12-18)."""
    if line.endswith(b"\r"):
        return line[:-1]
    return line


class Position:
    """Line number and byte offset of a parser state (ref utils.rs:53-72)."""

    __slots__ = ("_line", "_byte")

    def __init__(self, line: int, byte: int) -> None:
        self._line = line
        self._byte = byte

    def line(self) -> int:
        """Line number (starting with 1)."""
        return self._line

    def byte(self) -> int:
        """Byte offset within the file."""
        return self._byte

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, Position):
            return NotImplemented
        return self._line == other._line and self._byte == other._byte

    def __repr__(self) -> str:
        return f"Position(line={self._line}, byte={self._byte})"


class LineEnding(enum.Enum):
    """Whether the file uses \\r\\n or only \\n (ref utils.rs:92-104)."""

    WINDOWS = "windows"
    UNIX = "unix"

    def to_bytes(self) -> bytes:
        return b"\r\n" if self is LineEnding.WINDOWS else b"\n"


def find_line_ending(data: bytes) -> Optional[LineEnding]:
    """Detect the line ending used by ``data`` (ref utils.rs:106-117)."""
    if data:
        idx = data.find(b"\n")
        if idx >= 0:
            if idx > 0 and data[idx - 1 : idx] == b"\r":
                return LineEnding.WINDOWS
            return LineEnding.UNIX
    return None


class FastxReader(ABC):
    """Iterator-like trait the FASTA/FASTQ readers implement (ref utils.rs:119-130).

    ``next()`` raises ``ParseError`` on malformed input and returns ``None`` at
    EOF (the reference returns ``Option<Result<...>>``; in Python the error
    arm is an exception).  The readers are also plain Python iterators.
    """

    @abstractmethod
    def next(self):  # -> Optional[SequenceRecord]
        ...

    @abstractmethod
    def position(self) -> Position:
        """Current line/byte position in the stream."""

    @abstractmethod
    def line_ending(self) -> Optional[LineEnding]:
        """Line ending style; None until the first record has been read."""

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        rec = self.next()
        if rec is None:
            raise StopIteration
        return rec
