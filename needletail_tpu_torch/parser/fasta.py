"""Streaming FASTA framer (semantics of needletail src/parser/fasta.rs).

Frames records out of a growable host buffer: a record ends where the next
line starts with ``>``.  Multi-line sequences, ``\\r\\n`` endings, empty
records, and the reference's exact EOF/error behavior are preserved:

  * file not starting with ``>`` -> InvalidStart at line 0 (ref fasta.rs:316)
  * a record whose header newline is the last byte of input (e.g. ``>x\\n``)
    -> UnexpectedEnd (ref fasta.rs:206-213 push rules + fasta.rs:348-356)
  * position().line advances by the record's line count, .byte by its full
    span including the trailing newline (ref fasta.rs:191-195)

The buffer is anchored at the current record start with an offset pointer and
compacted periodically (the moral equivalent of the reference's
``make_room``/``grow``, ref fasta.rs:270-287, without the fixed-capacity
bookkeeping).
"""

from __future__ import annotations

import io
from pathlib import Path
from typing import IO, Optional, Union

from ..io.compression import DECOMPRESSION_ERRORS
from ..errors import ErrorPosition, Format, ParseError
from .record import SequenceRecord
from .utils import CHUNK, FastxReader, LineEnding, Position, find_line_ending

__all__ = ["FastaReader"]

_COMPACT_THRESHOLD = 8 << 20


class FastaReader(FastxReader):
    """Parser for FASTA streams.

    Only use directly when the input is known to be uncompressed FASTA;
    otherwise use ``parse_fastx_file``/``parse_fastx_reader``.
    """

    def __init__(self, reader: Union[IO[bytes], bytes, bytearray], capacity: int = CHUNK) -> None:
        if isinstance(reader, (bytes, bytearray, memoryview)):
            reader = io.BytesIO(bytes(reader))
        self._stream = reader
        self._chunk = max(int(capacity), 3)
        self._buf = bytearray()
        self._off = 0  # start of the current record within _buf
        self._scan = 0  # absolute offset up to which we've searched for "\n>"
        self._eof = False
        self._started = False
        self._finished = False
        self._line = 0
        self._byte = 0
        self._pending_lines = 0
        self._pending_bytes = 0
        self._line_ending: Optional[LineEnding] = None

    @classmethod
    def from_path(cls, path: Union[str, Path]) -> "FastaReader":
        return cls(open(path, "rb"))

    @classmethod
    def with_capacity(
        cls, reader: Union[IO[bytes], bytes, bytearray], capacity: int
    ) -> "FastaReader":
        return cls(reader, capacity=capacity)

    # ------------------------------------------------------------------
    def _fill(self) -> int:
        """Read one chunk; returns number of bytes read (0 at EOF).

        Stream errors (including mid-stream decompression failures) surface
        as ParseError with kind Io, like the reference's ``From<io::Error>``
        conversion (ref errors.rs:144-153)."""
        if self._eof:
            return 0
        try:
            data = self._stream.read(self._chunk)
        except DECOMPRESSION_ERRORS as exc:
            self._finished = True
            raise ParseError.from_io(
                exc if isinstance(exc, OSError) else OSError(str(exc))
            ) from exc
        if not data:
            self._eof = True
            return 0
        self._buf += data
        return len(data)

    def _compact(self) -> None:
        if self._off > _COMPACT_THRESHOLD:
            del self._buf[: self._off]
            self._scan -= self._off
            self._off = 0

    # ------------------------------------------------------------------
    def next(self) -> Optional[SequenceRecord]:
        if self._finished:
            return None

        buf = self._buf
        if not self._started:
            while not self._eof and len(buf) == 0:
                self._fill()
            if len(buf) == 0:
                self._finished = True
                return None
            if buf[0] != 0x3E:  # b'>'
                raise ParseError.new_invalid_start(
                    buf[0], ErrorPosition(line=self._line, id=None), Format.FASTA
                )
            self._started = True
            self._line = 1
            self._byte = 0
            self._scan = 1  # skip the leading '>' like the reference search_pos

        # apply the advance deferred from the previously emitted record
        if self._pending_bytes or self._pending_lines:
            self._line += self._pending_lines
            self._byte += self._pending_bytes
            self._off += self._pending_bytes
            self._pending_lines = 0
            self._pending_bytes = 0
            self._scan = max(self._scan, self._off)
            self._compact()
            buf = self._buf

        # find the start of the next record: a '\n' followed by '>'
        while True:
            idx = buf.find(b"\n>", self._scan)
            if idx >= 0:
                next_start = idx + 1
                break
            # not found: re-search the last byte once more data arrives
            self._scan = max(len(buf) - 1, self._off)
            if self._eof:
                return self._emit_final()
            self._fill()
            buf = self._buf

        span = bytes(buf[self._off : next_start])
        self._scan = next_start + 1  # resume after the '>' of the next record
        return self._emit(span, consumed=len(span))

    # ------------------------------------------------------------------
    def _emit(self, span: bytes, consumed: int) -> SequenceRecord:
        """Emit a complete mid-file record. ``span`` includes its trailing
        newline; ``consumed`` is the byte advance for the next record."""
        nl_count = span.count(b"\n")
        all_bytes = span[:-1]  # drop the boundary newline
        first_nl = span.find(b"\n")
        # seq_pos parity: a single newline means header-only (ref fasta.rs:55-63)
        first = first_nl if nl_count > 1 else None
        pos = Position(self._line, self._byte)
        if self._line_ending is None:
            self._line_ending = find_line_ending(all_bytes)
        self._pending_lines = nl_count
        self._pending_bytes = consumed
        return SequenceRecord.new_fasta(all_bytes, first, pos, self._line_ending)

    def _emit_final(self) -> Optional[SequenceRecord]:
        """EOF reached with no further record boundary (ref fasta.rs:206-213)."""
        self._finished = True
        remaining = bytes(self._buf[self._off :])
        if not remaining:
            return None
        nls = []
        i = remaining.find(b"\n")
        while i >= 0:
            nls.append(i)
            i = remaining.find(b"\n", i + 1)
        # Reconstruct the reference's seq_pos push rules: newlines that are the
        # final buffer byte were never pushed during scanning; the EOF handler
        # then pushes the current search position iff seq_pos is non-empty.
        if remaining[-1] == 0x0A:  # ends with '\n'
            seq_pos = nls  # last entry doubles as the EOF push
            if len(nls) <= 1:
                raise ParseError.new_unexpected_end(
                    ErrorPosition(line=self._line, id=None), Format.FASTA
                )
        else:
            if not nls:
                raise ParseError.new_unexpected_end(
                    ErrorPosition(line=self._line, id=None), Format.FASTA
                )
            seq_pos = nls + [len(remaining)]

        all_bytes = remaining[: seq_pos[-1]]
        first = seq_pos[0] if len(seq_pos) > 1 else None
        pos = Position(self._line, self._byte)
        if self._line_ending is None:
            self._line_ending = find_line_ending(all_bytes)
        return SequenceRecord.new_fasta(all_bytes, first, pos, self._line_ending)

    # ------------------------------------------------------------------
    def position(self) -> Position:
        return Position(self._line, self._byte)

    def line_ending(self) -> Optional[LineEnding]:
        return self._line_ending
