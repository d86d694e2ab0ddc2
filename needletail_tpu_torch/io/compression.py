"""Magic-byte compression sniffing and transparent decompression.

The port's copy of ``needletail_tpu/io/compression.py``.

Mirrors needletail ``src/parser/mod.rs:28-150``: the first two bytes select a
decoder (gzip ``1F 8B``, bzip2 ``42 5A``, xz ``FD 37``, zstd ``28 B5``), the
first *decompressed* byte selects the format parser, and both sniffed bytes
are chained back in front of the stream.  Less than two bytes -> EmptyFile;
an empty compressed payload -> EmptyFile.
"""

from __future__ import annotations

import bz2
import gzip
import io
import lzma
from typing import IO, Optional, Tuple

from ..errors import ParseError

__all__ = [
    "GZ_MAGIC",
    "BZ_MAGIC",
    "XZ_MAGIC",
    "ZST_MAGIC",
    "sniff_compression",
    "wrap_decompressor",
    "ChainedReader",
    "open_uncompressed",
]

GZ_MAGIC = b"\x1f\x8b"
BZ_MAGIC = b"BZ"
XZ_MAGIC = b"\xfd7"
ZST_MAGIC = b"(\xb5"

_MAGICS = {GZ_MAGIC: "gzip", BZ_MAGIC: "bzip2", XZ_MAGIC: "xz", ZST_MAGIC: "zstd"}


def _decompression_errors() -> tuple:
    """Every exception a mid-stream decode failure can raise.

    gzip/bz2 raise OSError subclasses, but lzma raises LZMAError, zlib
    raises zlib.error, and zstandard raises ZstdError — all plain
    Exceptions.  Readers catch this tuple so corrupt streams surface as
    ParseError(Io) per the documented taxonomy.
    """
    import zlib

    errs = [OSError, EOFError, lzma.LZMAError, zlib.error]
    try:
        import zstandard

        errs.append(zstandard.ZstdError)
    except ImportError:  # pragma: no cover
        pass
    return tuple(errs)


DECOMPRESSION_ERRORS = _decompression_errors()


class ChainedReader(io.RawIOBase):
    """A readable stream that yields ``prefix`` then the underlying stream —
    the equivalent of the reference's ``Cursor::chain`` un-consume trick
    (ref mod.rs:92-93)."""

    def __init__(self, prefix: bytes, stream: IO[bytes]) -> None:
        self._prefix = prefix
        self._pos = 0
        self._stream = stream

    def readable(self) -> bool:  # pragma: no cover - io protocol
        return True

    def read(self, size: int = -1) -> bytes:
        if self._pos < len(self._prefix):
            if size is None or size < 0:
                out = self._prefix[self._pos :] + (self._stream.read() or b"")
                self._pos = len(self._prefix)
                return out
            out = self._prefix[self._pos : self._pos + size]
            self._pos += len(out)
            return out
        return self._stream.read(size)

    def readinto(self, b) -> int:  # pragma: no cover - io protocol
        data = self.read(len(b))
        b[: len(data)] = data
        return len(data)

    def close(self) -> None:
        try:
            self._stream.close()
        finally:
            super().close()


def sniff_compression(first_two: bytes) -> Optional[str]:
    """Return the codec name for the given 2-byte magic, or None."""
    return _MAGICS.get(first_two)


def _zstd_reader(stream: IO[bytes]) -> IO[bytes]:
    try:
        import zstandard  # type: ignore
    except ImportError as exc:  # pragma: no cover - env always has it
        raise ParseError.from_io(
            OSError("zstd-compressed input but the 'zstandard' module is unavailable")
        ) from exc
    dctx = zstandard.ZstdDecompressor()
    return dctx.stream_reader(stream, read_across_frames=True)


def wrap_decompressor(codec: str, stream: IO[bytes]) -> IO[bytes]:
    """Wrap ``stream`` in a streaming decoder for ``codec``.

    gzip uses the multi-member decoder semantics (``MultiGzDecoder`` in the
    reference, ref mod.rs:98) — Python's GzipFile already concatenates
    members.
    """
    if codec == "gzip":
        return gzip.GzipFile(fileobj=stream, mode="rb")
    if codec == "bzip2":
        return bz2.BZ2File(stream, mode="rb")
    if codec == "xz":
        return lzma.LZMAFile(stream, mode="rb")
    if codec == "zstd":
        return _zstd_reader(stream)
    raise ValueError(f"unknown codec {codec!r}")


def open_uncompressed(stream: IO[bytes]) -> Tuple[IO[bytes], int]:
    """Sniff ``stream`` and return ``(decompressed_stream, first_byte)``.

    The returned stream includes the sniffed first byte at its head.  Raises
    ``ParseError`` (EmptyFile) when fewer than two raw bytes or zero
    decompressed bytes are available (ref mod.rs:85-150).
    """
    first_two = stream.read(2) or b""
    while 0 < len(first_two) < 2:
        more = stream.read(2 - len(first_two))
        if not more:
            break
        first_two += more
    if len(first_two) < 2:
        raise ParseError.new_empty_file()

    chained = ChainedReader(first_two, stream)
    codec = sniff_compression(first_two)
    if codec is None:
        return chained, first_two[0]

    try:
        decoded = wrap_decompressor(codec, chained)
        first = decoded.read(1)
    except ParseError:
        raise
    except EOFError as exc:
        # stream ended before one decompressed byte: EmptyFile, like the
        # reference's first-byte read hitting EOF (ref mod.rs:98-146)
        raise ParseError.new_empty_file() from exc
    except DECOMPRESSION_ERRORS as exc:
        # corrupt data is an Io error, not an empty file
        raise ParseError.from_io(
            exc if isinstance(exc, OSError) else OSError(str(exc))
        ) from exc
    if not first:
        raise ParseError.new_empty_file()
    return ChainedReader(first, decoded), first[0]
