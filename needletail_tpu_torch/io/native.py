"""ctypes binding to the port's native framer (``csrc/framer.cpp``).

The port's copy of ``needletail_tpu/io/native.py``.  The library builds
from the port's own copy of the framer source with the host C++ compiler
(``device._build.build_framer``) into ``build/needletail_tpu_torch/`` at
first use.  When the compiler or library is unavailable, callers fall back
to the pure-Python framers; ``NEEDLETAIL_TPU_NO_NATIVE`` forces that.
"""

from __future__ import annotations

import ctypes
import os
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

__all__ = ["get_lib", "scan_fastq", "scan_fasta", "fill_fastq_batch", "available"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False

# NtError codes (must match csrc/framer.cpp)
ERR_OK = 0
ERR_INVALID_START = 1
ERR_INVALID_SEPARATOR = 2
ERR_UNEQUAL_LENGTHS = 3


def get_lib() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native framer; None when unavailable."""
    global _lib, _tried
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("NEEDLETAIL_TPU_NO_NATIVE"):
            return None
        from ..device._build import build_framer

        so = build_framer()
        if so is not None:
            _lib = _bind(so)
        return _lib


def _bind(so: Path) -> Optional[ctypes.CDLL]:
    """Load + bind the C ABI; None if the library is stale (e.g. an
    editable-install .so compiled before new symbols were added — callers
    then try the freshly-built csrc library or degrade to pure Python)."""
    try:
        lib = ctypes.CDLL(str(so))
        i64 = ctypes.c_int64
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i64p = ctypes.POINTER(ctypes.c_int64)
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.nt_scan_fastq.restype = i64
        lib.nt_scan_fastq.argtypes = [u8p, i64, i64p, i64, i64p, i32p, i64p]
        lib.nt_scan_fasta.restype = i64
        lib.nt_scan_fasta.argtypes = [u8p, i64, i64p, i64, i64p]
        lib.nt_fill_fastq_batch.restype = i64
        lib.nt_fill_fastq_batch.argtypes = [u8p, i64p, i64, u8p, u8p, i32p, i64]
        lib.nt_fill_fasta_batch.restype = i64
        lib.nt_fill_fasta_batch.argtypes = [u8p, i64p, i64, u8p, i32p, i64]
        lib.nt_count_newlines.restype = i64
        lib.nt_count_newlines.argtypes = [u8p, i64]
        lib.nt_fill_ids.restype = i64
        lib.nt_fill_ids.argtypes = [u8p, i64p, i64, i64, i64, u8p, i32p, i64]
        lib.nt_pack_ids.restype = i64
        lib.nt_pack_ids.argtypes = [u8p, i64p, i64, i64, i64, u8p]
        lib.nt_fasta_max_len.restype = i64
        lib.nt_fasta_max_len.argtypes = [u8p, i64p, i64]
        lib.nt_fill_fastq_batch_packed.restype = i64
        lib.nt_fill_fastq_batch_packed.argtypes = [
            u8p, i64p, i64, u8p, u8p, u8p, i32p, i64, i64p,
        ]
        lib.nt_fill_fasta_batch_packed.restype = i64
        lib.nt_fill_fasta_batch_packed.argtypes = [
            u8p, i64p, i64, u8p, u8p, u8p, i32p, i64, i64p,
        ]
        lib.nt_pack_row.restype = i64
        lib.nt_pack_row.argtypes = [u8p, i64, u8p, u8p, u8p]
        lib.nt_fill_fastq_batch_packed_rows.restype = i64
        lib.nt_fill_fastq_batch_packed_rows.argtypes = [
            u8p, i64p, i64, u8p, u8p, u8p, i32p, i64, i64p, i32p,
        ]
        lib.nt_fill_fasta_batch_packed_rows.restype = i64
        lib.nt_fill_fasta_batch_packed_rows.argtypes = [
            u8p, i64p, i64, u8p, u8p, u8p, i32p, i64, i64p, i32p,
        ]
        return lib
    except (OSError, AttributeError):
        return None


def available() -> bool:
    return get_lib() is not None


def _u8ptr(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def scan_fastq(
    buf: np.ndarray, cap: int, out: Optional[np.ndarray] = None
) -> Tuple[np.ndarray, int, int, int, int]:
    """Scan complete FASTQ records from a uint8 buffer.

    Returns (recs[n,5], n, consumed, err, err_rec_start).  Pass ``out``
    (int64 [>=cap, 5]) to reuse an allocation across calls.
    """
    lib = get_lib()
    recs = out if out is not None and out.shape[0] >= cap else np.empty((cap, 5), dtype=np.int64)
    consumed = ctypes.c_int64(0)
    err = ctypes.c_int32(0)
    err_rec = ctypes.c_int64(-1)
    n = lib.nt_scan_fastq(
        _u8ptr(buf),
        buf.size,
        recs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        cap,
        ctypes.byref(consumed),
        ctypes.byref(err),
        ctypes.byref(err_rec),
    )
    return recs[:n], int(n), int(consumed.value), int(err.value), int(err_rec.value)


def scan_fasta(
    buf: np.ndarray, cap: int, out: Optional[np.ndarray] = None
) -> Tuple[np.ndarray, int, int]:
    """Scan complete FASTA records. Returns (recs[n,3], n, consumed).
    Pass ``out`` (int64 [>=cap, 3]) to reuse an allocation across calls."""
    lib = get_lib()
    recs = (
        out
        if out is not None and out.shape[0] >= cap
        else np.empty((cap, 3), dtype=np.int64)
    )
    consumed = ctypes.c_int64(0)
    n = lib.nt_scan_fasta(
        _u8ptr(buf),
        buf.size,
        recs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        cap,
        ctypes.byref(consumed),
    )
    return recs[:n], int(n), int(consumed.value)


def fill_fastq_batch(
    buf: np.ndarray,
    recs: np.ndarray,
    seq_out: np.ndarray,
    qual_out: Optional[np.ndarray],
    lengths: np.ndarray,
) -> int:
    """memcpy scanned records into padded [rows, max_len] arrays; returns the
    number of rows skipped because they exceeded max_len."""
    lib = get_lib()
    n = recs.shape[0]
    max_len = seq_out.shape[1]
    qual_ptr = (
        _u8ptr(qual_out)
        if qual_out is not None
        else ctypes.cast(None, ctypes.POINTER(ctypes.c_uint8))
    )
    return int(
        lib.nt_fill_fastq_batch(
            _u8ptr(buf),
            recs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            n,
            _u8ptr(seq_out),
            qual_ptr,
            lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            max_len,
        )
    )


def fill_fasta_batch(
    buf: np.ndarray,
    recs: np.ndarray,
    seq_out: np.ndarray,
    lengths: np.ndarray,
) -> int:
    """Copy scanned FASTA records' newline-stripped sequences into padded
    rows; returns the number of rows that exceeded max_len."""
    lib = get_lib()
    n = recs.shape[0]
    max_len = seq_out.shape[1]
    return int(
        lib.nt_fill_fasta_batch(
            _u8ptr(buf),
            recs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            n,
            _u8ptr(seq_out),
            lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            max_len,
        )
    )


def fill_fastq_batch_packed(
    buf: np.ndarray,
    recs: np.ndarray,
    lut: np.ndarray,
    code_out: np.ndarray,
    valid_out: np.ndarray,
    lengths: np.ndarray,
    max_len: int,
) -> Tuple[int, int]:
    """Pack scanned FASTQ records' sequences into 2-bit code + validity
    bitplanes (``lut``: 256-entry byte->code, 0xFF invalid).  Returns
    ``(overflow_rows, n_invalid_bases)``."""
    lib = get_lib()
    n_invalid = ctypes.c_int64(0)
    overflow = lib.nt_fill_fastq_batch_packed(
        _u8ptr(buf),
        recs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        recs.shape[0],
        _u8ptr(lut),
        _u8ptr(code_out),
        _u8ptr(valid_out),
        lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        max_len,
        ctypes.byref(n_invalid),
    )
    return int(overflow), int(n_invalid.value)


def fill_fasta_batch_packed(
    buf: np.ndarray,
    recs: np.ndarray,
    lut: np.ndarray,
    code_out: np.ndarray,
    valid_out: np.ndarray,
    lengths: np.ndarray,
    max_len: int,
) -> Tuple[int, int]:
    """Packed twin of ``fill_fasta_batch`` (newline/CR-stripping).  Returns
    ``(overflow_rows, n_invalid_bases)``."""
    lib = get_lib()
    n_invalid = ctypes.c_int64(0)
    overflow = lib.nt_fill_fasta_batch_packed(
        _u8ptr(buf),
        recs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        recs.shape[0],
        _u8ptr(lut),
        _u8ptr(code_out),
        _u8ptr(valid_out),
        lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        max_len,
        ctypes.byref(n_invalid),
    )
    return int(overflow), int(n_invalid.value)


def fill_fastq_batch_packed_rows(
    buf: np.ndarray,
    recs: np.ndarray,
    lut: np.ndarray,
    code_out: np.ndarray,
    valid_out: np.ndarray,
    lengths: np.ndarray,
    max_len: int,
    row_invalid: np.ndarray,
) -> Tuple[int, int]:
    """Row-resolved twin of :func:`fill_fastq_batch_packed`: additionally
    writes each row's invalid-base count into ``row_invalid`` (int32,
    caller-zeroed) so the batcher can ship validity as ragged dirty rows
    (the lean transport).  Returns ``(overflow_rows, n_invalid_bases)``."""
    lib = get_lib()
    n_invalid = ctypes.c_int64(0)
    overflow = lib.nt_fill_fastq_batch_packed_rows(
        _u8ptr(buf),
        recs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        recs.shape[0],
        _u8ptr(lut),
        _u8ptr(code_out),
        _u8ptr(valid_out),
        lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        max_len,
        ctypes.byref(n_invalid),
        row_invalid.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return int(overflow), int(n_invalid.value)


def fill_fasta_batch_packed_rows(
    buf: np.ndarray,
    recs: np.ndarray,
    lut: np.ndarray,
    code_out: np.ndarray,
    valid_out: np.ndarray,
    lengths: np.ndarray,
    max_len: int,
    row_invalid: np.ndarray,
) -> Tuple[int, int]:
    """Row-resolved twin of :func:`fill_fasta_batch_packed` (see
    :func:`fill_fastq_batch_packed_rows`)."""
    lib = get_lib()
    n_invalid = ctypes.c_int64(0)
    overflow = lib.nt_fill_fasta_batch_packed_rows(
        _u8ptr(buf),
        recs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        recs.shape[0],
        _u8ptr(lut),
        _u8ptr(code_out),
        _u8ptr(valid_out),
        lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        max_len,
        ctypes.byref(n_invalid),
        row_invalid.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return int(overflow), int(n_invalid.value)


def pack_row(
    seq: np.ndarray, lut: np.ndarray, code_row: np.ndarray, valid_row: np.ndarray
) -> int:
    """Pack one contiguous ASCII sequence row; returns n_invalid_bases."""
    lib = get_lib()
    return int(
        lib.nt_pack_row(
            _u8ptr(seq), seq.size, _u8ptr(lut), _u8ptr(code_row), _u8ptr(valid_row)
        )
    )


def count_newlines(buf: np.ndarray) -> int:
    lib = get_lib()
    return int(lib.nt_count_newlines(_u8ptr(buf), buf.size))


def fasta_max_len(buf: np.ndarray, recs: np.ndarray) -> int:
    """Longest stripped sequence length among scanned FASTA records."""
    lib = get_lib()
    return int(
        lib.nt_fasta_max_len(
            _u8ptr(buf),
            recs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            recs.shape[0],
        )
    )


def extract_ids_packed(
    buf: np.ndarray, recs: np.ndarray, fastq: bool
) -> Tuple[bytes, int]:
    """Record ids for scanned records as one '\n'-separated packed blob
    (header line minus its marker byte, '\r'-trimmed; ids cannot contain
    '\n').  Returns ``(blob, n)`` — no per-record Python objects; see
    ``needletail_tpu_torch.batch.LazyIds`` for on-demand materialization."""
    lib = get_lib()
    n = recs.shape[0]
    if n == 0:
        return b"", 0
    stride = recs.shape[1]
    end_adjust = 1 if fastq else 0
    cap = int((recs[:, 1] - recs[:, 0]).sum()) + n
    out = np.empty(cap, dtype=np.uint8)
    written = lib.nt_pack_ids(
        _u8ptr(buf),
        recs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        n,
        stride,
        end_adjust,
        _u8ptr(out),
    )
    return out[:written].tobytes(), n


def extract_ids(buf: np.ndarray, recs: np.ndarray, fastq: bool) -> list:
    """Record ids as a materialized list of bytes (one C pack + one
    ``bytes.split``); prefer ``extract_ids_packed`` on hot paths."""
    blob, n = extract_ids_packed(buf, recs, fastq)
    return blob.split(b"\n")[:-1] if n else []
