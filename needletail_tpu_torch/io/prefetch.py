"""Background prefetch for decompression streams.

The port's copy of ``needletail_tpu/io/prefetch.py``.

Single-stream gzip/bzip2/xz decode is CPU-serial; running it in a worker
thread overlaps decode with framing and device compute (the GIL is released
inside zlib/bz2/lzma).  A bounded queue caps memory.
"""

from __future__ import annotations

import io
import queue
import threading
from typing import IO, Optional

__all__ = ["PrefetchReader"]

_CHUNK = 4 << 20
_DEPTH = 4


class PrefetchReader(io.RawIOBase):
    """Wrap a readable stream; a worker thread pulls chunks ahead."""

    def __init__(self, stream: IO[bytes], chunk: int = _CHUNK, depth: int = _DEPTH):
        self._stream = stream
        self._queue: "queue.Queue" = queue.Queue(maxsize=depth)
        self._buf = b""
        self._off = 0
        self._eof = False
        self._chunk = chunk
        self._stopped = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self) -> None:
        try:
            while not self._stopped.is_set():
                data = self._stream.read(self._chunk)
                # bounded put with a timeout so close() can unblock us even
                # if the consumer abandoned the stream with a full queue
                while not self._stopped.is_set():
                    try:
                        self._queue.put(data, timeout=0.2)
                        break
                    except queue.Full:
                        continue
                if not data:
                    return
        except Exception as exc:  # delivered to the consumer
            if not self._stopped.is_set():
                try:
                    self._queue.put(exc, timeout=0.2)
                except queue.Full:
                    pass

    def readable(self) -> bool:  # pragma: no cover
        return True

    def _pull(self) -> bool:
        """Load the next chunk into the buffer; False at EOF."""
        if self._eof:
            return False
        # Poll with a timeout so a read() racing (or issued after) close()
        # wakes up and errors instead of blocking forever on a queue the
        # stopped worker will never feed again.
        while True:
            if self._stopped.is_set():
                raise ValueError("read of closed PrefetchReader")
            try:
                item = self._queue.get(timeout=0.2)
                break
            except queue.Empty:
                continue
        if isinstance(item, Exception):
            self._eof = True
            raise item
        if not item:
            self._eof = True
            return False
        self._buf = item
        self._off = 0
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
        # stop the worker (it may be blocked on a full queue), drain, join —
        # otherwise an abandoned stream leaks the thread and ~chunk*depth
        # bytes of buffered data for the life of the process
        self._stopped.set()
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)
        try:
            self._stream.close()
        finally:
            super().close()
