"""Decompress-to-spill: turn compressed input into range-splittable files.

The port's copy of ``needletail_tpu/io/spill.py``.

Monolithic gzip/bzip2/xz/zstd streams cannot be byte-range split (each
byte depends on the whole prefix), so multi-worker framing can't consume
them directly.  The spill path decodes ONCE to an uncompressed temp file
— in parallel when the input is BGZF, serially otherwise — after which
``split_fastx_ranges`` + per-worker native framing proceed exactly as for
plain files.  The serial decode is the codec's own speed limit; everything
downstream of the spill parallelizes.

The reference's decoders are likewise single-stream (ref mod.rs:95-147);
this module exists for the BASELINE aggregate-ingest target, not parity.
"""

from __future__ import annotations

import errno
import os
import shutil
import tempfile
from pathlib import Path
from typing import Optional, Union

from ..errors import ParseError
from .bgzf import BGZFReader, is_bgzf
from .compression import (
    DECOMPRESSION_ERRORS,
    sniff_compression,
    wrap_decompressor,
)

__all__ = [
    "decompress_to_spill",
    "spilled_input",
    "estimate_decompressed_size",
    "SpillSpaceError",
]

_COPY_CHUNK = 8 << 20

# conservative decompressed-size multiple when the codec gives no hint
# (FASTQ gzips around 3-4x; xz/zstd can do better, so 6x is a safe ceiling)
_FALLBACK_RATIO = 6


class SpillSpaceError(OSError):
    """Spill target lacks the free space for the decompressed input.

    Drivers catch this and degrade to single-stream framing instead of
    dying mid-decode with a half-written temp file."""


def estimate_decompressed_size(path: Union[str, Path]) -> int:
    """Best-effort decompressed byte estimate for a compressed file.

    gzip (incl. BGZF) carries ISIZE mod 2^32 in the final member's last 4
    bytes; that is exact below 4 GiB and a lower bound above, so the
    returned value is ``max(isize, comp_size * ratio)``.  Other codecs use
    the ratio alone.  Never raises — callers treat this as advisory.
    """
    size = os.path.getsize(path)
    guess = size * _FALLBACK_RATIO
    try:
        with open(path, "rb") as f:
            magic = f.read(2)
            if sniff_compression(magic) == "gzip" and size >= 8:
                f.seek(-4, os.SEEK_END)
                isize = int.from_bytes(f.read(4), "little")
                # multi-member gzip (incl. BGZF) only reports the LAST
                # member here; keep the ratio bound as the floor
                return max(isize, guess)
    except OSError:
        pass
    return guess


def _check_spill_space(path: Union[str, Path], dir: Optional[str]) -> None:
    target = dir or tempfile.gettempdir()
    try:
        free = shutil.disk_usage(target).free
    except OSError:
        return  # exotic fs: let the write itself surface errors
    need = estimate_decompressed_size(path)
    if free < need:
        raise SpillSpaceError(
            f"spill dir {target!r} has {free >> 20} MiB free but decoding "
            f"{path!r} needs an estimated {need >> 20} MiB; pass a roomier "
            "spill_dir or use single-stream framing (host_workers=1)"
        )


def decompress_to_spill(
    path: Union[str, Path],
    dir: Optional[str] = None,
    threads: Optional[int] = None,
) -> str:
    """Decode ``path`` into an uncompressed temp file; returns its path.

    BGZF inputs decode block-parallel on ``threads`` workers; other codecs
    stream through their single-threaded decoder.  The caller owns (and
    should unlink) the returned file.  Raises ParseError(Io) on corrupt
    streams, ValueError if the input is not compressed, SpillSpaceError
    when the spill target's free space is below the estimated decompressed
    size (checked up front so no half-written temp file is left behind).
    """
    with open(path, "rb") as f:
        magic = f.read(2)
    codec = sniff_compression(magic) if len(magic) == 2 else None
    if codec is None:
        raise ValueError(f"{path} is not compressed; no spill needed")
    _check_spill_space(path, dir)

    reader = None
    if codec == "gzip" and is_bgzf(path):
        try:
            reader = BGZFReader(path, threads=threads)
        except ValueError:
            # hybrid file: BGZF blocks followed by ordinary gzip members
            # (legal multi-member gzip) — fall back to streaming decode
            reader = None
    if reader is None:
        reader = wrap_decompressor(codec, open(path, "rb"))

    fd, spill_path = tempfile.mkstemp(
        suffix=".fastx", prefix="ntspill-", dir=dir
    )
    try:
        with os.fdopen(fd, "wb") as out:
            shutil.copyfileobj(reader, out, _COPY_CHUNK)
    except OSError as exc:
        os.unlink(spill_path)
        if exc.errno in (errno.ENOSPC, errno.EDQUOT):
            # ran out mid-decode despite the estimate: degrade like the
            # up-front check so drivers fall back to streaming
            raise SpillSpaceError(str(exc)) from exc
        raise ParseError.from_io(exc) from exc
    except DECOMPRESSION_ERRORS as exc:
        os.unlink(spill_path)
        raise ParseError.from_io(
            exc if isinstance(exc, OSError) else OSError(str(exc))
        ) from exc
    except BaseException:
        os.unlink(spill_path)
        raise
    finally:
        reader.close()
    return spill_path


class spilled_input:
    """Context manager: yields a range-splittable path for any input.

    Uncompressed files pass through untouched; compressed files spill to a
    temp file that is removed on exit.

        with spilled_input(path, threads=8) as plain_path:
            parallel_read_batches(plain_path, workers=8, ...)
    """

    def __init__(
        self,
        path: Union[str, Path],
        dir: Optional[str] = None,
        threads: Optional[int] = None,
    ) -> None:
        self._path = str(path)
        self._dir = dir
        self._threads = threads
        self._spill: Optional[str] = None

    def __enter__(self) -> str:
        with open(self._path, "rb") as f:
            magic = f.read(2)
        if len(magic) == 2 and sniff_compression(magic):
            self._spill = decompress_to_spill(
                self._path, dir=self._dir, threads=self._threads
            )
            return self._spill
        return self._path

    def __exit__(self, *exc) -> None:
        if self._spill is not None:
            try:
                os.unlink(self._spill)
            except OSError:
                pass
            self._spill = None
