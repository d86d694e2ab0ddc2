"""Streaming FASTQ framer (semantics of needletail src/parser/fastq.rs).

Strict 4-line records (no line wrapping).  Preserves the reference's exact
validation and error taxonomy:

  * record must start with ``@`` -> InvalidStart (ref fastq.rs:241-249)
  * separator line must start with ``+`` -> InvalidSeparator, reported two
    lines down with the record id (ref fastq.rs:251-258)
  * sequence and quality lengths must match -> UnequalLengths
    (ref fastq.rs:276-283); quality *characters* are deliberately not
    validated (~90% perf cost, ref fastq.rs:265-275)
  * EOF inside the quality line still emits the final record
    (ref fastq.rs:337-343); trailing blank lines are fine
    (ref fastq.rs:346-350); any other truncation -> UnexpectedEnd with the
    line offset of the stage reached (ref fastq.rs:352-355)
  * position().line += 4 and .byte += full record span per record
    (ref fastq.rs:411-414)
"""

from __future__ import annotations

import io
from pathlib import Path
from typing import IO, Optional, Union

from ..io.compression import DECOMPRESSION_ERRORS
from ..errors import ErrorPosition, Format, ParseError
from .record import SequenceRecord
from .utils import CHUNK, FastxReader, LineEnding, Position, find_line_ending, trim_cr

__all__ = ["FastqReader"]

_COMPACT_THRESHOLD = 8 << 20


class FastqReader(FastxReader):
    """Parser for FASTQ streams.

    Only use directly when the input is known to be uncompressed FASTQ;
    otherwise use ``parse_fastx_file``/``parse_fastx_reader``.
    """

    def __init__(self, reader: Union[IO[bytes], bytes, bytearray], capacity: int = CHUNK) -> None:
        if isinstance(reader, (bytes, bytearray, memoryview)):
            reader = io.BytesIO(bytes(reader))
        self._stream = reader
        self._chunk = max(int(capacity), 3)
        self._buf = bytearray()
        self._off = 0
        self._eof = False
        self._finished = False
        self._line = 1
        self._byte = 0
        self._pending = 0  # bytes to consume before framing the next record
        self._line_ending: Optional[LineEnding] = None

    @classmethod
    def from_path(cls, path: Union[str, Path]) -> "FastqReader":
        return cls(open(path, "rb"))

    @classmethod
    def with_capacity(
        cls, reader: Union[IO[bytes], bytes, bytearray], capacity: int
    ) -> "FastqReader":
        return cls(reader, capacity=capacity)

    # ------------------------------------------------------------------
    def _fill(self) -> int:
        """Read one chunk; stream/decompression errors become ParseError(Io)
        (ref errors.rs:144-153)."""
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

    # ------------------------------------------------------------------
    def next(self) -> Optional[SequenceRecord]:
        if self._finished:
            return None

        # advance past the previously emitted record (deferred like the
        # reference's next() preamble, ref fastq.rs:411-415)
        if self._pending:
            self._byte += self._pending
            self._line += 4
            self._off += self._pending
            self._pending = 0
            if self._off > _COMPACT_THRESHOLD:
                del self._buf[: self._off]
                self._off = 0

        buf = self._buf
        if len(buf) - self._off == 0:
            while not self._eof and len(buf) - self._off == 0:
                self._fill()
            if len(buf) - self._off == 0:
                self._finished = True
                return None

        # frame 4 lines; nl[i] is the absolute index of the i-th newline
        nl = []
        search = self._off
        while True:
            while len(nl) < 4:
                p = buf.find(b"\n", search)
                if p < 0:
                    break
                nl.append(p)
                search = p + 1
            if len(nl) == 4:
                end = nl[3]
                return self._validate_and_emit(nl, end, at_eof=False)
            if self._eof:
                return self._check_end(nl)
            search = len(buf)
            self._fill()
            buf = self._buf

    # ------------------------------------------------------------------
    def _check_end(self, nl) -> Optional[SequenceRecord]:
        """EOF with an incomplete record (ref fastq.rs:337-356)."""
        self._finished = True
        buf = self._buf
        stage = len(nl)  # 0=Id, 1=Sequence, 2=Separator, 3=Quality
        if stage == 3:
            # only the quality line's newline is missing: emit the record
            return self._validate_and_emit(nl, len(buf), at_eof=True)

        rest = bytes(buf[self._off :])
        if all(len(trim_cr(line)) == 0 for line in rest.split(b"\n")):
            return None

        raise ParseError.new_unexpected_end(
            self._error_pos(nl, line_offset=stage, parse_id=stage > 0),
            Format.FASTQ,
        )

    def _error_pos(self, nl, line_offset: int, parse_id: bool) -> ErrorPosition:
        """Reproduce get_error_pos (ref fastq.rs:287-303): id is the header up
        to the first space, only when the header line is non-empty."""
        rec_id = None
        if parse_id and nl and (nl[0] + 1) - self._off > 1:
            raw = trim_cr(bytes(self._buf[self._off + 1 : nl[0]]))
            rec_id = raw.split(b" ")[0].decode("utf-8", errors="replace")
        return ErrorPosition(line=self._line + line_offset, id=rec_id)

    # ------------------------------------------------------------------
    def _validate_and_emit(self, nl, end: int, at_eof: bool) -> SequenceRecord:
        buf = self._buf
        off = self._off
        start_byte = buf[off]
        if start_byte != 0x40:  # b'@'
            self._finished = True
            raise ParseError.new_invalid_start(
                start_byte, self._error_pos(nl, 0, False), Format.FASTQ
            )
        sep_byte = buf[nl[1] + 1]
        if sep_byte != 0x2B:  # b'+'
            self._finished = True
            raise ParseError.new_invalid_separator(
                sep_byte, self._error_pos(nl, 2, True)
            )

        all_bytes = bytes(buf[off:end])
        seq_off = nl[0] + 1 - off
        sep_off = nl[1] + 1 - off
        qual_off = nl[2] + 1 - off
        seq_len = len(trim_cr(all_bytes[seq_off : sep_off - 1]))
        qual_len = len(trim_cr(all_bytes[qual_off:]))
        if seq_len != qual_len:
            self._finished = True
            raise ParseError.new_unequal_length(
                seq_len, qual_len, self._error_pos(nl, 0, True)
            )

        pos = Position(self._line, self._byte)
        if self._line_ending is None:
            self._line_ending = find_line_ending(all_bytes)
        if at_eof:
            self._finished = True
        else:
            self._pending = end + 1 - off
        return SequenceRecord.new_fastq(
            all_bytes, seq_off, sep_off, qual_off, pos, self._line_ending
        )

    # ------------------------------------------------------------------
    def position(self) -> Position:
        return Position(self._line, self._byte)

    def line_ending(self) -> Optional[LineEnding]:
        return self._line_ending
