"""The framing front of the port's file drivers.

Ports ``_make_batch_source`` (``device/pipeline.py``), ``split_fastx_ranges``
with its record-start sync (``parallel/distributed.py``) and
``parallel_read_batches`` with its spawn worker, error rebasing and pool
size (``io/parallel_host.py``) from the JAX package.  The workers frame
through the port's own ``io.fast_batch`` and native framer, so a spawned
child imports nothing but this package.

Batches from several workers interleave; every record is framed by exactly
one worker, so the counting drivers (integer adds) get identical results.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue as _queue
from pathlib import Path
from typing import Iterator, List, Optional, Tuple, Union

from ..batch import PackedReadBatch, ReadBatch
from ..errors import ErrorPosition, ParseError
from ..parser.utils import trim_cr
from .compression import sniff_compression
from .fast_batch import (
    _effective_packed_max_len,
    fast_read_batches,
    fast_read_batches_range,
)

__all__ = [
    "split_fastx_ranges",
    "parallel_read_batches",
    "auto_host_workers",
]

_DONE = "done"
_ERR = "err"
_BATCH = "batch"


def auto_host_workers() -> int:
    """Default framing parallelism: all cores but one (the consumer thread
    drives the device), capped at 16.  Always >= 1."""
    return max(1, min((os.cpu_count() or 1) - 1, 16))


def _worker(
    path, start, end, batch_size, max_len, with_quals, with_ids, q,
    shm_names=None, free_q=None, packed=False, normalized=True,
) -> None:
    """Spawn-pool body: frame ``[start, end)`` of ``path`` and ship each
    batch (through a shared-memory segment when ``shm_names`` is given),
    then a done sentinel, or the error with the range start."""
    import pickle

    writer = None
    try:
        if shm_names is not None:
            from .shm_pool import SharedBatchWriter

            writer = SharedBatchWriter(
                shm_names, batch_size, max_len, with_quals, packed=packed
            )
        for b in fast_read_batches_range(
            path, start, end, batch_size=batch_size, max_len=max_len,
            with_quals=with_quals, with_ids=with_ids,
            packed=packed, normalized=normalized,
        ):
            # the descriptor's bool marks quals (ASCII) / vbits (packed)
            second = b.dense_vbits() if packed else b.quals
            if writer is not None:
                seg = free_q.get()
                n = writer.write(seg, b)
                q.put((_BATCH, (seg, n, b.ids if with_ids else [],
                                second is not None)))
            elif packed:
                q.put((_BATCH, (b.codes, b.lengths, second, b.ids)))
            else:
                q.put((_BATCH, (b.seqs, b.lengths, second, b.ids)))
        q.put((_DONE, None))
    except BaseException as exc:  # propagate to the consumer
        # mp.Queue pickles in a feeder thread, where an unpicklable
        # exception would vanish: check here and degrade
        try:
            pickle.dumps(exc)
        except Exception:
            exc = ParseError.from_io(OSError(repr(exc)))
        q.put((_ERR, (exc, start)))
    finally:
        if writer is not None:
            writer.close()


def _count_newlines_before(path, stop: int) -> int:
    """Newlines in ``file[0:stop]`` (error path only)."""
    remaining = stop
    count = 0
    with open(path, "rb") as f:
        while remaining > 0:
            chunk = f.read(min(remaining, 8 << 20))
            if not chunk:
                break
            count += chunk.count(b"\n")
            remaining -= len(chunk)
    return count


def _rebase_error(path, exc, range_start: int):
    """Rewrite a worker ParseError's line number to be file-global."""
    if (
        not isinstance(exc, ParseError)
        or range_start <= 0
        or exc.position is None
        or exc.position.line is None
    ):
        return exc
    try:
        lines_before = _count_newlines_before(path, range_start)
    except OSError:
        # the input vanished mid-error: keep the worker's own error
        return exc
    return ParseError(
        exc.msg,
        exc.kind,
        ErrorPosition(
            line=exc.position.line + lines_before, id=exc.position.id
        ),
        exc.format,
    )


_SYNC_WINDOW = 1 << 20
_SYNC_DEPTH = 2


def _quantize_max_len(max_len: Optional[int]) -> Optional[int]:
    """Round an explicit max_len up to a multiple of 8 in both transports,
    so packed and ASCII runs accept exactly the same reads."""
    return _effective_packed_max_len(True, max_len)


def _is_fastq_record_start(
    buf: bytes, pos: int, depth: int = _SYNC_DEPTH
) -> Optional[bool]:
    """True/False when ``pos`` does/doesn't start a FASTQ record; None when
    the window is too short to decide (the caller extends it).

    Checks ``depth`` consecutive records: ``@`` start, ``+`` separator and
    equal sequence and quality lengths, since a quality line starting with
    ``@`` can mimic a record start.
    """
    if buf[pos : pos + 1] != b"@":
        return False
    if pos > 0 and buf[pos - 1 : pos] != b"\n":
        return False
    p = pos
    for d in range(depth):
        nls = []
        q = p
        for _ in range(4):
            i = buf.find(b"\n", q)
            if i < 0:
                return None
            nls.append(i)
            q = i + 1
        if buf[p : p + 1] != b"@":
            return False
        if buf[nls[1] + 1 : nls[1] + 2] != b"+":
            return False
        seq = trim_cr(buf[nls[0] + 1 : nls[1]])
        qual = trim_cr(buf[nls[2] + 1 : nls[3]])
        if len(seq) != len(qual):
            return False
        p = nls[3] + 1
        if p >= len(buf) and d + 1 < depth:
            return None
    return True


def _sync_forward(path: Union[str, Path], offset: int, fasta: bool) -> int:
    """Smallest record-start position >= offset (or the file size)."""
    size = os.path.getsize(path)
    if offset == 0:
        return 0
    with open(path, "rb") as f:
        # one byte of left context, so a boundary AT offset is found
        f.seek(offset - 1)
        window = f.read(_SYNC_WINDOW + 1)
        base = offset - 1
        search = 0
        at_eof = False
        while True:
            idx = window.find(b"\n>" if fasta else b"\n@", search)
            if idx < 0:
                if at_eof:
                    return size
                nxt = f.read(_SYNC_WINDOW)
                if not nxt:
                    at_eof = True
                window += nxt
                search = max(len(window) - len(nxt) - 1, 0)
                if at_eof:
                    search = len(window)
                continue
            pos = idx + 1
            if fasta:
                return base + pos
            verdict = _is_fastq_record_start(window, pos)
            if verdict is None and not at_eof:
                nxt = f.read(_SYNC_WINDOW)
                if not nxt:
                    at_eof = True
                window += nxt
                search = pos - 1  # re-check the same candidate
                continue
            if verdict:
                return base + pos
            search = pos + 1


def split_fastx_ranges(
    path: Union[str, Path],
    n: int,
    byte_range: Optional[Tuple[int, int]] = None,
) -> List[Tuple[int, int]]:
    """Split an uncompressed FASTX file, or its record-aligned
    ``byte_range`` ``(start, end)``, into ``n`` disjoint byte ranges
    aligned to record starts, covering it."""
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        first = f.read(1)
    if not first:
        return [(0, 0)] * n
    fasta = first == b">"
    if first not in (b">", b"@"):
        raise ParseError.new_unknown_format(first[0])
    start, end = (0, size) if byte_range is None else byte_range
    cuts = [start]
    for i in range(1, n):
        cut = _sync_forward(path, start + (end - start) * i // n, fasta)
        cuts.append(min(max(cut, cuts[-1]), end))
    cuts.append(end)
    return [(cuts[i], cuts[i + 1]) for i in range(n)]


def parallel_read_batches(
    path: Union[str, Path],
    workers: int = 2,
    batch_size: int = 8192,
    max_len: Optional[int] = None,
    with_quals: bool = True,
    packed: bool = False,
    normalized: bool = True,
    byte_range: Optional[Tuple[int, int]] = None,
) -> Iterator[ReadBatch]:
    """Frame an uncompressed FASTX file, or its record-aligned
    ``byte_range`` ``(start, end)``, with ``workers`` processes.

    ``workers <= 1`` (or stdin) frames in this process.  With an explicit
    ``max_len`` the planes travel through a shared-memory segment pool
    instead of the pickle queue.  Record ids are not carried.  Errors
    surface with file-global line numbers, as from the single-stream
    reader.
    """
    if packed:
        with_quals = False
    # quantize before sizing the pool: workers apply the same rule
    max_len = _effective_packed_max_len(packed, max_len)
    if byte_range is not None and workers <= 1:
        yield from fast_read_batches_range(
            str(path), *byte_range, batch_size=batch_size, max_len=max_len,
            with_quals=with_quals, packed=packed, normalized=normalized,
        )
        return
    if workers <= 1 or str(path) == "-":
        yield from fast_read_batches(
            str(path), batch_size=batch_size, max_len=max_len,
            with_quals=with_quals, packed=packed, normalized=normalized,
        )
        return

    try:
        with open(path, "rb") as f:
            magic = f.read(2)
    except OSError as exc:
        raise ParseError.from_io(exc) from exc
    if len(magic) == 2 and sniff_compression(magic):
        raise ValueError(
            "byte-range framing needs an uncompressed file; use "
            "fast_read_batches(prefetch=True) for compressed input"
        )
    ranges = split_fastx_ranges(path, workers, byte_range)
    # spawn, never fork: the consumer runs threads (feeders, CUDA)
    ctx = mp.get_context("spawn")
    q = ctx.Queue(maxsize=4 * workers)
    pool = free_q = shm_names = None
    if max_len is not None:
        from .shm_pool import SharedBatchPool

        pool = SharedBatchPool(
            batch_size, max_len, with_quals, segments=2 * workers + 2,
            packed=packed,
        )
        shm_names = pool.names
        free_q = ctx.Queue()
        for i in range(len(shm_names)):
            free_q.put(i)
    procs = [
        ctx.Process(
            target=_worker,
            args=(str(path), start, end, batch_size, max_len, with_quals,
                  False, q, shm_names, free_q, packed, normalized),
            daemon=True,
        )
        for start, end in ranges
    ]
    for p in procs:
        p.start()
    live = len(procs)
    error = None
    try:
        while live:
            try:
                kind, payload = q.get(timeout=1.0)
            except _queue.Empty:
                # a worker killed without its sentinel must not wedge us
                dead = [p for p in procs if p.exitcode not in (None, 0)]
                if dead:
                    hint = ""
                    if dead[0].exitcode == 1:
                        # the classic spawn failure: an unguarded script
                        # re-executes itself in the child
                        hint = (
                            " (the framing pool uses the 'spawn' start "
                            "method, which re-imports the calling script — "
                            "if this happened at startup, guard your entry "
                            "point with `if __name__ == \"__main__\":` or "
                            "pass host_workers=1)"
                        )
                    error = RuntimeError(
                        "framing worker died with exit code "
                        f"{dead[0].exitcode}{hint}"
                    )
                    break
                if all(p.exitcode is not None for p in procs) and q.empty():
                    break
                continue
            if kind == _DONE:
                live -= 1
            elif kind == _ERR:
                exc, range_start = payload
                error = _rebase_error(str(path), exc, range_start)
                break
            elif pool is not None:
                seg, n, ids, has_second = payload
                seqs, quals, lengths = pool.views(seg, n)
                second = (
                    quals.copy() if (has_second and quals is not None) else None
                )
                if packed:
                    batch = PackedReadBatch(
                        codes=seqs.copy(), lengths=lengths.copy(),
                        vbits=second, ids=ids, normalized=normalized,
                    )
                else:
                    batch = ReadBatch(
                        seqs=seqs.copy(), lengths=lengths.copy(),
                        quals=second, ids=ids,
                    )
                # drop the views before recycling the segment
                del seqs, quals, lengths, second
                free_q.put(seg)
                yield batch
            elif packed:
                codes, lengths, vbits, ids = payload
                yield PackedReadBatch(
                    codes=codes, lengths=lengths, vbits=vbits, ids=ids,
                    normalized=normalized,
                )
            else:
                seqs, lengths, quals, ids = payload
                yield ReadBatch(seqs=seqs, lengths=lengths, quals=quals, ids=ids)
    finally:
        for p in procs:
            p.terminate()
        for p in procs:
            p.join()
        if pool is not None:
            pool.close()
    if error is not None:
        raise error


def _make_batch_source(
    path,
    batch_size: int,
    max_len: Optional[int],
    host_workers: Optional[int],
    with_quals: bool,
    spill_dir: Optional[str] = None,
    packed: bool = False,
    normalized: bool = True,
    byte_range: Optional[Tuple[int, int]] = None,
):
    """The drivers' input front: ``(batches, host_workers)``.

    ``host_workers=None`` sizes the framing pool from the CPU count for a
    plain file.  Compressed input streams in one process unless the caller
    opts into decode-to-spill with an explicit ``host_workers > 1`` or a
    ``spill_dir``.  A list of paths chains every file through one source.
    An explicit ``max_len`` rounds up to a multiple of 8.  ``byte_range``
    ``(start, end)`` frames only that record-aligned range of one
    uncompressed file (a compressed one raises ``ValueError``), through
    the same pool.
    """
    if isinstance(path, (list, tuple)):
        if len(path) == 1:
            path = path[0]
        else:
            paths = list(path)

            def chained():
                for p in paths:
                    src, _w = _make_batch_source(
                        p, batch_size, max_len, host_workers,
                        with_quals=with_quals, spill_dir=spill_dir,
                        packed=packed, normalized=normalized,
                    )
                    yield from src

            return chained(), (host_workers or 0)

    max_len = _quantize_max_len(max_len)
    if byte_range is not None:
        if host_workers is None:
            host_workers = auto_host_workers()
        return parallel_read_batches(
            path, workers=host_workers, batch_size=batch_size,
            max_len=max_len, with_quals=with_quals, packed=packed,
            normalized=normalized, byte_range=byte_range,
        ), host_workers
    compressed = False
    if str(path) != "-":
        try:
            with open(path, "rb") as f:
                magic = f.read(2)
            compressed = len(magic) == 2 and sniff_compression(magic) is not None
        except OSError:
            pass  # the framer raises it with its own error kinds
    spill_opt_in = spill_dir is not None or (
        host_workers is not None and host_workers > 1
    )
    if host_workers is None:
        host_workers = auto_host_workers()
    if str(path) == "-":
        host_workers = 1
    if compressed and not spill_opt_in:
        host_workers = 1
    if host_workers <= 1:
        return fast_read_batches(
            path, batch_size=batch_size, max_len=max_len,
            with_quals=with_quals, prefetch=True,
            packed=packed, normalized=normalized,
        ), host_workers

    def gen():
        from .spill import SpillSpaceError, spilled_input

        spill = spilled_input(path, dir=spill_dir, threads=host_workers)
        try:
            plain = spill.__enter__()
        except SpillSpaceError as exc:
            import warnings

            warnings.warn(
                f"falling back to single-stream framing: {exc}",
                RuntimeWarning,
                stacklevel=2,
            )
            yield from fast_read_batches(
                path, batch_size=batch_size, max_len=max_len,
                with_quals=with_quals, prefetch=True,
                packed=packed, normalized=normalized,
            )
            return
        try:
            yield from parallel_read_batches(
                plain, workers=host_workers, batch_size=batch_size,
                max_len=max_len, with_quals=with_quals,
                packed=packed, normalized=normalized,
            )
        finally:
            spill.__exit__(None, None, None)

    return gen(), host_workers
