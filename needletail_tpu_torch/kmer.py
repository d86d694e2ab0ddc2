"""Byte-slice k-mer iterators (ref needletail src/kmer.rs).

``kmers`` is a plain sliding window (no N handling, ref kmer.rs:13-41);
``canonical_kmers`` yields ``(pos, kmer_bytes, was_rc)`` for every window whose
bases are all unambiguous ACGT (case-insensitive), choosing the
lexicographically smaller of the forward window and the matching slice of the
caller-provided reverse complement.  Tie-break: equal compares return the
reverse-complement slice with ``was_rc=True`` (ref kmer.rs:124-128 —
``result < rc_result`` picks forward strictly).

Implementation note: instead of translating the reference's stateful
``update_position`` machine, valid window positions are computed in one
vectorized pass (a window is valid iff all of its k bases are ACGT/acgt,
which is exactly what the reference's N-skip state machine admits).

The port's copy of the JAX package's ``kmer.py``.
"""

from __future__ import annotations

from typing import Iterator, Tuple, Union

import numpy as np

__all__ = ["kmers", "canonical_kmers", "Kmers", "CanonicalKmers", "valid_kmer_positions"]

BytesLike = Union[bytes, bytearray, memoryview, np.ndarray]

_GOOD_BASE = np.zeros(256, dtype=bool)
for _ch in b"acgtACGT":
    _GOOD_BASE[_ch] = True


def _as_np(seq: BytesLike) -> np.ndarray:
    if isinstance(seq, np.ndarray):
        return seq.astype(np.uint8, copy=False)
    return np.frombuffer(bytes(seq) if isinstance(seq, memoryview) else seq, dtype=np.uint8)


def valid_kmer_positions(seq: BytesLike, k: int) -> np.ndarray:
    """Positions of all windows of length ``k`` whose bases are all ACGT/acgt.

    Matches the emission order/positions of the reference N-skip machine
    (ref kmer.rs:84-108).
    """
    arr = _as_np(seq)
    n = arr.size
    if k <= 0 or n < k:
        return np.empty(0, dtype=np.int64)
    good = _GOOD_BASE[arr].astype(np.int32)
    # count of good bases in each window via prefix sum
    csum = np.concatenate(([0], np.cumsum(good)))
    window_good = csum[k:] - csum[:-k]
    return np.nonzero(window_good == k)[0].astype(np.int64)


def kmers(seq: BytesLike, k: int) -> Iterator[bytes]:
    """Plain sliding-window k-mers; does not skip Ns (ref kmer.rs:13-41)."""
    raw = bytes(_as_np(seq).tobytes())
    for i in range(len(raw) - k + 1):
        yield raw[i : i + k]


def canonical_kmers(
    seq: BytesLike, reverse_complement: BytesLike, k: int
) -> Iterator[Tuple[int, bytes, bool]]:
    """Yield ``(pos, canonical_kmer, was_rc)`` over valid windows.

    ``reverse_complement`` must be the reverse complement of ``seq`` (same
    length), as in the reference API (ref kmer.rs:48-129).
    """
    raw = bytes(_as_np(seq).tobytes())
    rc = bytes(_as_np(reverse_complement).tobytes())
    n = len(rc)  # the reference indexes the rc slice by rc_buffer.len()
    for pos in valid_kmer_positions(raw, k):
        p = int(pos)
        fwd = raw[p : p + k]
        rev = rc[n - p - k : n - p]
        if fwd < rev:
            yield (p, fwd, False)
        else:
            yield (p, rev, True)


# Class-style aliases mirroring the reference type names.
Kmers = kmers
CanonicalKmers = canonical_kmers
