"""BGZF (blocked gzip) support: block index scan + parallel decompression.

The port's copy of ``needletail_tpu/io/bgzf.py``.

BGZF is the htslib/bgzip framing used across genomics: a gzip-compatible
stream made of independent <=64 KiB members, each carrying its compressed
size in a 'BC' extra subfield.  Ordinary gzip tools read it transparently
(it IS multi-member gzip, ref mod.rs:98 MultiGzDecoder semantics), but the
per-block size field lets us (a) index every block with header-hop seeks
and (b) decompress blocks on a thread pool — zlib releases the GIL, so a
many-core host decodes an entire file in parallel.  This is the compressed
half of the >=10 GB/s aggregate ingest target (BASELINE.json north star);
the reference has no parallel decode path (single-stream, mod.rs:95-147).
"""

from __future__ import annotations

import gzip
import io
import mmap
import os
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Tuple

__all__ = [
    "is_bgzf",
    "scan_bgzf_blocks",
    "bgzf_decompressed_starts",
    "BGZFReader",
    "write_bgzf",
    "write_bgzf_stream",
    "MAX_BLOCK_SIZE",
    "BGZF_EOF",
]

# the fixed 28-byte empty terminator block bgzip appends
BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000"
)


def _parse_block_size(data: bytes, off: int) -> Optional[int]:
    """Total compressed size of the BGZF block at ``off``, or None if the
    bytes there are not a BGZF member header."""
    if len(data) - off < 18:
        return None
    if data[off : off + 4] != b"\x1f\x8b\x08\x04":
        return None  # gzip magic + deflate + FEXTRA flag required
    (xlen,) = struct.unpack_from("<H", data, off + 10)
    extra_end = off + 12 + xlen
    if extra_end > len(data):
        return None
    p = off + 12
    while p + 4 <= extra_end:
        si1, si2, slen = data[p], data[p + 1], struct.unpack_from("<H", data, p + 2)[0]
        if si1 == 0x42 and si2 == 0x43 and slen == 2:  # 'B' 'C'
            (bsize_minus1,) = struct.unpack_from("<H", data, p + 4)
            return bsize_minus1 + 1
        p += 4 + slen
    return None


def is_bgzf(path) -> bool:
    """True when the file starts with a BGZF member (gzip + BC subfield)."""
    try:
        with open(path, "rb") as f:
            head = f.read(18 + 256)
    except OSError:
        return False
    return _parse_block_size(head, 0) is not None


def scan_bgzf_blocks(mm) -> List[Tuple[int, int]]:
    """(offset, size) of every BGZF block in a buffer, by header hops.

    Raises ValueError on a malformed block chain (callers fall back to the
    streaming single-thread decoder).
    """
    blocks: List[Tuple[int, int]] = []
    off = 0
    n = len(mm)
    while off < n:
        size = _parse_block_size(mm, off)
        if size is None:
            raise ValueError(f"not a BGZF block at offset {off}")
        blocks.append((off, size))
        off += size
    return blocks


def bgzf_decompressed_starts(mm, blocks) -> Tuple[List[int], int]:
    """Decompressed start offset of every block, plus the total
    decompressed size — from the gzip ISIZE trailer of each member, no
    decompression needed (BGZF members are <= 64 KiB decoded, so the
    mod-2^32 ISIZE is exact).  This is what makes BGZF checkpoint/resume
    work: a record-aligned *decompressed* offset maps to (block, skip)
    with a binary search, and re-decoding starts at that block."""
    starts: List[int] = []
    total = 0
    for off, size in blocks:
        starts.append(total)
        (isize,) = struct.unpack_from("<I", mm, off + size - 4)
        total += isize
    return starts, total


class BGZFReader(io.RawIOBase):
    """Parallel BGZF decompressor presenting a plain readable stream.

    Blocks decode on a thread pool with a bounded lookahead; delivery is
    in order, so downstream framing sees exactly the bytes a serial
    decoder would produce.

    ``start_offset`` (a DECOMPRESSED-space position) begins delivery
    there: the reader hops straight to the containing block via the
    ISIZE index and skips into it — the resume half of BGZF
    checkpointing (block-aligned seekability is the whole point of the
    format; ordinary gzip cannot do this).
    """

    def __init__(
        self,
        path,
        threads: Optional[int] = None,
        lookahead: int = 64,
        start_offset: int = 0,
    ) -> None:
        self._f = open(path, "rb")
        try:
            self._mm = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
        except (ValueError, OSError):
            # zero-length files cannot be mapped
            self._f.close()
            raise
        try:
            # raises ValueError on hybrid files (BGZF blocks followed by
            # ordinary gzip members — legal multi-member gzip); callers
            # fall back to the streaming decoder
            self._blocks = scan_bgzf_blocks(self._mm)
        except ValueError:
            self._mm.close()
            self._f.close()
            raise
        workers = threads or min(os.cpu_count() or 1, 16)
        self._pool = ThreadPoolExecutor(max_workers=workers)
        self._lookahead = max(lookahead, 2 * workers)
        self._futs: dict = {}
        self._next_submit = 0
        self._next_deliver = 0
        self._buf = b""
        self._off = 0
        self._skip = 0
        self._closed = False
        if start_offset:
            import bisect

            starts, total = bgzf_decompressed_starts(self._mm, self._blocks)
            if start_offset > total:
                self._mm.close()
                self._f.close()
                raise ValueError(
                    f"start_offset {start_offset} is beyond the decompressed "
                    f"size {total}"
                )
            i = bisect.bisect_right(starts, start_offset) - 1
            self._next_submit = self._next_deliver = i
            self._skip = start_offset - starts[i]
        self._top_up()

    def _decode(self, i: int) -> bytes:
        off, size = self._blocks[i]
        # gzip.decompress validates the CRC and ISIZE of the member
        return gzip.decompress(self._mm[off : off + size])

    def _top_up(self) -> None:
        while (
            self._next_submit < len(self._blocks)
            and self._next_submit - self._next_deliver < self._lookahead
        ):
            self._futs[self._next_submit] = self._pool.submit(
                self._decode, self._next_submit
            )
            self._next_submit += 1

    def _pull(self) -> bool:
        while self._next_deliver < len(self._blocks):
            fut = self._futs.pop(self._next_deliver)
            self._next_deliver += 1
            self._top_up()
            data = fut.result()  # propagates zlib errors to the consumer
            if self._skip:  # start_offset landed inside this block
                take = min(self._skip, len(data))
                data = data[take:]
                self._skip -= take
            if data:  # EOF marker blocks decode to b""
                self._buf = data
                self._off = 0
                return True
        return False

    def readable(self) -> bool:  # pragma: no cover - io protocol
        return True

    def read(self, size: int = -1) -> bytes:
        if size is None or size < 0:
            parts = [self._buf[self._off :]]
            self._buf = b""
            self._off = 0
            while self._pull():
                parts.append(self._buf)
                self._buf = b""
            return b"".join(parts)
        out = bytearray()
        while len(out) < size:
            if self._off >= len(self._buf):
                if not self._pull():
                    break
            take = min(size - len(out), len(self._buf) - self._off)
            out += self._buf[self._off : self._off + take]
            self._off += take
        return bytes(out)

    def readinto(self, b) -> int:
        want = len(b)
        got = 0
        while got < want:
            if self._off >= len(self._buf):
                if not self._pull():
                    break
            take = min(want - got, len(self._buf) - self._off)
            b[got : got + take] = self._buf[self._off : self._off + take]
            self._off += take
            got += take
        return got

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._pool.shutdown(wait=False, cancel_futures=True)
        try:
            self._mm.close()
        finally:
            self._f.close()
            super().close()


# largest chunk whose level-0 stored encoding (+26 B of framing and
# 5 B/16 KiB deflate stored-block headers) still fits the uint16 BSIZE
MAX_BLOCK_SIZE = 65280


def _check_block_size(block_size: int) -> None:
    if not 1 <= block_size <= MAX_BLOCK_SIZE:
        raise ValueError(
            f"block_size must be in [1, {MAX_BLOCK_SIZE}] (BGZF blocks carry "
            f"their size in a uint16), got {block_size}"
        )


def _write_member(out, chunk: bytes) -> None:
    comp = zlib.compressobj(6, zlib.DEFLATED, -15)
    payload = comp.compress(chunk) + comp.flush()
    bsize = 12 + 6 + len(payload) + 8  # header+extra+deflate+crc/isize
    if bsize > 65536:  # incompressible chunk: store at level 0
        comp = zlib.compressobj(0, zlib.DEFLATED, -15)
        payload = comp.compress(chunk) + comp.flush()
        bsize = 12 + 6 + len(payload) + 8
    header = (
        b"\x1f\x8b\x08\x04"  # magic, deflate, FEXTRA
        + b"\x00\x00\x00\x00"  # mtime
        + b"\x00\xff"  # XFL, OS=unknown
        + struct.pack("<H", 6)  # XLEN
        + b"BC"
        + struct.pack("<H", 2)
        + struct.pack("<H", bsize - 1)
    )
    out.write(header)
    out.write(payload)
    out.write(struct.pack("<II", zlib.crc32(chunk), len(chunk) & 0xFFFFFFFF))


def write_bgzf(data: bytes, path, block_size: int = MAX_BLOCK_SIZE) -> None:
    """Compress ``data`` to ``path`` as BGZF (independent <=64 KiB members
    with BC size subfields + the EOF marker).  bgzip/htslib compatible."""
    _check_block_size(block_size)
    with open(path, "wb") as out:
        for i in range(0, len(data), block_size):
            _write_member(out, data[i : i + block_size])
        out.write(BGZF_EOF)


def write_bgzf_stream(src, path, block_size: int = MAX_BLOCK_SIZE) -> int:
    """Recompress a readable stream to BGZF with O(block_size) memory;
    returns the number of uncompressed bytes consumed."""
    _check_block_size(block_size)
    total = 0
    with open(path, "wb") as out:
        while chunk := src.read(block_size):
            _write_member(out, chunk)
            total += len(chunk)
        out.write(BGZF_EOF)
    return total
