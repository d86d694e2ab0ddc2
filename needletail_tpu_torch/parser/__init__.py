"""FASTA/FASTQ parsing: dispatch, format parsers, records, writers.

The port's copy of the JAX package's ``parser/__init__.py``.
``parse_fastx_reader``/``parse_fastx_file``/``parse_fastx_stdin`` mirror the
reference entry points (needletail src/parser/mod.rs:85-163): sniff
compression by magic bytes, sniff format by the first decompressed byte
(``>`` FASTA / ``@`` FASTQ), and hand the stream to the right framer.
"""

from __future__ import annotations

import io
import sys
from pathlib import Path
from typing import IO, Union

from ..errors import ParseError
from ..io.compression import open_uncompressed
from .fasta import FastaReader
from .fastq import FastqReader
from .record import (
    SequenceRecord,
    mask_header_tabs,
    mask_header_utf8,
    write_fasta,
    write_fastq,
)
from .utils import FastxReader, Format, LineEnding, Position

__all__ = [
    "parse_fastx_reader",
    "parse_fastx_file",
    "parse_fastx_stdin",
    "FastaReader",
    "FastqReader",
    "FastxReader",
    "SequenceRecord",
    "write_fasta",
    "write_fastq",
    "mask_header_tabs",
    "mask_header_utf8",
    "Format",
    "LineEnding",
    "Position",
]


def _get_fastx_reader(stream: IO[bytes], first_byte: int) -> FastxReader:
    """Dispatch on the first byte (ref mod.rs:37-46)."""
    if first_byte == 0x3E:  # b'>'
        return FastaReader(stream)
    if first_byte == 0x40:  # b'@'
        return FastqReader(stream)
    raise ParseError.new_unknown_format(first_byte)


def parse_fastx_reader(reader: Union[IO[bytes], bytes, bytearray, str]) -> FastxReader:
    """Main entry point for any readable byte stream (ref mod.rs:85-150).

    Detects compression (gzip/bzip2/xz/zstd) and format (FASTA/FASTQ)
    automatically.  Raises ``ParseError`` with kind EmptyFile for inputs
    shorter than two bytes and UnknownFormat for unrecognized leading bytes.
    """
    if isinstance(reader, str):
        reader = reader.encode("utf-8")
    if isinstance(reader, (bytes, bytearray, memoryview)):
        reader = io.BytesIO(bytes(reader))
    stream, first_byte = open_uncompressed(reader)
    return _get_fastx_reader(stream, first_byte)


def parse_fastx_stdin() -> FastxReader:
    """Parse a FASTA/FASTQ stream from stdin (ref mod.rs:154)."""
    return parse_fastx_reader(sys.stdin.buffer)


def parse_fastx_file(path: Union[str, Path]) -> FastxReader:
    """Parse a FASTA/FASTQ file, transparently decompressed (ref mod.rs:161)."""
    try:
        handle = open(path, "rb")
    except OSError as exc:
        raise ParseError.from_io(exc) from exc
    return parse_fastx_reader(handle)
