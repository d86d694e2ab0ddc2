"""The plain k-mer spectrum that decides ``correct``.

NumPy only, written from the definition and from nothing of the program:
a base is A, C, G or T in either case (codes 0-3), every other byte breaks
the windows that hold it; a window of k bases packs into one integer, the
first base most significant; its reverse complement packs the complements
of the bases in reverse order; the canonical key is the smaller of the
two (a tie keeps either, since they are equal).  The spectrum is every
distinct key of every valid window with the number of windows that hold
it, keys ascending.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Tuple

import numpy as np

__all__ = [
    "ascii_codes", "window_keys", "valid_windows", "spectrum", "diff_count",
    "answer", "compare",
]

_BAD = 4

_LUT = np.full(256, _BAD, dtype=np.uint8)
for _i, _ch in enumerate(b"ACGT"):
    _LUT[_ch] = _i
    _LUT[_ch + 32] = _i

# windows are built over blocks of this many bases of one flat stream:
# the uint64 temporaries stay a few MB, near the host's caches
_BLOCK = 1 << 18


def ascii_codes(seq: np.ndarray) -> np.ndarray:
    """uint8 codes of ASCII bases: A0 C1 G2 T3, 4 for any other byte."""
    return _LUT[np.asarray(seq, dtype=np.uint8)]


def _stream(rows: np.ndarray) -> np.ndarray:
    """Codes of ASCII ``rows`` (``[n, L]``, or one ``[L]`` sequence) as one
    flat stream, an invalid code after each row so that no window spans
    two rows."""
    rows = np.asarray(rows, dtype=np.uint8)
    if rows.ndim == 1:
        return ascii_codes(rows)
    flat = np.empty((rows.shape[0], rows.shape[1] + 1), dtype=np.uint8)
    flat[:, :-1] = ascii_codes(rows)
    flat[:, -1] = _BAD
    return flat.reshape(-1)


def _ladder(codes: np.ndarray, k: int, reverse: bool) -> np.ndarray:
    """Packed windows of k bases at every start of ``codes`` (values 0-3):
    ``[len - k + 1]`` uint64, built by doubling.  ``reverse`` packs each
    window's bases last-first, which with the codes complemented is the
    reverse complement."""
    width = codes.size - k + 1
    rungs = {1: codes.astype(np.uint64)}
    m = 1
    while 2 * m <= k:
        a = rungs[m]
        hi, lo = (a[m:], a[:-m]) if reverse else (a[:-m], a[m:])
        rungs[2 * m] = (hi << np.uint64(2 * m)) | lo
        m *= 2
    out = None
    off = 0
    for m in sorted((m for m in rungs if k & m), reverse=True):
        part = rungs[m][off:off + width]
        if out is None:
            out = part.copy()
        elif reverse:
            out |= part << np.uint64(2 * off)
        else:
            out <<= np.uint64(2 * m)
            out |= part
        off += m
    return out


def _valid(codes: np.ndarray, k: int) -> np.ndarray:
    """bool ``[len - k + 1]``: the window holds no invalid base."""
    bad = np.zeros(codes.size + 1, dtype=np.int32)
    np.cumsum(codes >= _BAD, out=bad[1:])
    return (bad[k:] - bad[:-k]) == 0


def _blocks(codes: np.ndarray, k: int):
    """Overlapping slices of a code stream whose windows are each window
    of the stream once."""
    for start in range(0, max(codes.size - k + 1, 0), _BLOCK):
        yield codes[start:start + _BLOCK + k - 1]


def window_keys(rows: np.ndarray, k: int, canonical: bool = True) -> np.ndarray:
    """Keys of the valid windows of ASCII ``rows`` (``[n, L]`` uint8, or one
    sequence as ``[L]``), as uint64, in row-major window order."""
    if not 1 <= k <= 31:
        raise ValueError(f"k must be in [1, 31], got {k}")
    out = [np.zeros(0, np.uint64)]
    for codes in _blocks(_stream(rows), k):
        clean = codes & 3
        keys = _ladder(clean, k, reverse=False)
        if canonical:
            np.minimum(keys, _ladder(3 - clean, k, reverse=True), out=keys)
        out.append(keys[_valid(codes, k)])
    return np.concatenate(out)


def valid_windows(rows: np.ndarray, k: int) -> int:
    """Number of valid windows of ASCII ``rows`` (``[n, L]`` or ``[L]``)."""
    return sum(int(_valid(c, k).sum()) for c in _blocks(_stream(rows), k))


def spectrum(
    seqs: Iterable[np.ndarray], k: int, canonical: bool = True
) -> Tuple[np.ndarray, np.ndarray]:
    """``(keys uint64 ascending, counts int64)`` over every valid window of
    every sequence; each item of ``seqs`` is a ``[n, L]`` block of reads of
    one length or a single ``[L]`` sequence."""
    parts: List[np.ndarray] = [window_keys(s, k, canonical) for s in seqs]
    keys = np.concatenate(parts) if parts else np.zeros(0, np.uint64)
    del parts
    if not keys.size:
        return keys, np.zeros(0, np.int64)
    keys.sort()
    head = np.empty(keys.size, dtype=bool)
    head[0] = True
    np.not_equal(keys[1:], keys[:-1], out=head[1:])
    starts = np.flatnonzero(head)
    counts = np.diff(np.append(starts, keys.size)).astype(np.int64)
    return keys[starts], counts


def diff_count(
    got_keys: np.ndarray, got_counts: np.ndarray,
    ref_keys: np.ndarray, ref_counts: np.ndarray,
) -> int:
    """Entries on which two spectra disagree: keys on one side only, and
    shared keys whose counts differ.  0 means equal."""
    got_keys = np.asarray(got_keys, dtype=np.uint64)
    got_counts = np.asarray(got_counts, dtype=np.int64)
    if (
        got_keys.shape == ref_keys.shape
        and np.array_equal(got_keys, ref_keys)
        and np.array_equal(got_counts, ref_counts)
    ):
        return 0
    if got_keys.size != got_counts.size:
        return max(got_keys.size, got_counts.size) + ref_keys.size
    order = np.argsort(got_keys, kind="stable")
    got_keys, got_counts = got_keys[order], got_counts[order]
    # a key twice on the program's side is an error of its own
    dup = int(np.count_nonzero(got_keys[1:] == got_keys[:-1]))
    shared, gi, ri = np.intersect1d(
        got_keys, ref_keys, assume_unique=False, return_indices=True
    )
    only = (got_keys.size - dup - shared.size) + (ref_keys.size - shared.size)
    return int(only + dup + np.count_nonzero(got_counts[gi] != ref_counts[ri]))


def answer(inp, options: dict) -> Tuple[int, Tuple[np.ndarray, np.ndarray]]:
    """The answer a spectrum entry owes for one generated input under the
    configuration's ``options`` (``k``, ``canonical``): ``(bases, (keys,
    counts))``, as ``count_file`` and ``genome_spectrum`` return it with
    ``sparse_format="arrays"``."""
    k = int(options["k"])
    return inp.bases, spectrum(inp.seqs, k, bool(options.get("canonical", True)))


def compare(got, want) -> Dict[str, int]:
    """The numbers compared between a returned spectrum and the
    reference's: ``bases_off``, the gap in bases counted, and ``keys_off``,
    the entries on which the two spectra disagree."""
    n_bases, (keys, counts) = got
    want_bases, (want_keys, want_counts) = want
    return {
        "bases_off": abs(int(n_bases) - int(want_bases)),
        "keys_off": diff_count(keys, counts, want_keys, want_counts),
    }
