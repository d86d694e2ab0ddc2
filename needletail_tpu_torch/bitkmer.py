"""2-bit packed k-mers (ref needletail src/bitkmer.rs).

A ``BitKmer`` is a ``(value, k)`` pair with A=0, C=1, G=2, T=3 (upper + lower
case accepted), value held in the low ``2k`` bits of an integer.  Supports
k <= 31 exactly like the reference (the bit-twiddled reverse complement's
``>> 2*(32-k)`` shift caps practical k at 31; ref bitkmer.rs:112-132).

The iterator (``bit_kmers``) is vectorized with numpy uint64 arithmetic: all
window values for a sequence are computed with k shift-accumulate passes and
invalid (non-ACGT-containing) windows are masked out — byte-identical output
to the reference's rolling state machine (ref bitkmer.rs:39-109).

The port's copy of the JAX package's ``bitkmer.py``.
"""

from __future__ import annotations

from typing import Iterator, Tuple, Union

import numpy as np

__all__ = [
    "BitKmer",
    "bit_kmers",
    "BitNuclKmer",
    "reverse_complement",
    "canonical",
    "minimizer",
    "bitmer_to_bytes",
    "bytes_to_bitmer",
    "pack_kmers",
    "NUC2BIT_LUT",
]

BytesLike = Union[bytes, bytearray, memoryview, np.ndarray]
BitKmer = Tuple[int, int]  # (value, k)

# 256-entry lookup: 0..3 for ACGT/acgt, 255 = invalid (ref bitkmer.rs:5-18)
NUC2BIT_LUT = np.full(256, 255, dtype=np.uint8)
for _i, _ch in enumerate(b"ACGT"):
    NUC2BIT_LUT[_ch] = _i
    NUC2BIT_LUT[_ch + 32] = _i  # lowercase


def _as_np(seq: BytesLike) -> np.ndarray:
    if isinstance(seq, np.ndarray):
        return seq.astype(np.uint8, copy=False)
    return np.frombuffer(bytes(seq) if isinstance(seq, memoryview) else seq, dtype=np.uint8)


def pack_kmers(seq: BytesLike, k: int) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorized 2-bit packing of every window of length ``k``.

    Returns ``(values, valid)`` where ``values[i]`` (uint64) is the packed
    window starting at position ``i`` and ``valid[i]`` is True iff all k bases
    were unambiguous ACGT.  Invalid windows hold unspecified values.
    """
    if not 1 <= k <= 31:
        # the reference's rc mask math practically caps k at 31
        # (SURVEY §2 C8b); beyond 32 the uint64 shift-accumulate would
        # silently truncate, so fail loudly like the device path
        raise ValueError(f"k must be in [1, 31], got {k}")
    arr = _as_np(seq)
    n = arr.size
    if k <= 0 or n < k:
        return np.empty(0, dtype=np.uint64), np.empty(0, dtype=bool)
    codes = NUC2BIT_LUT[arr]
    bad = codes == 255
    codes64 = codes.astype(np.uint64)
    num = n - k + 1
    values = np.zeros(num, dtype=np.uint64)
    for j in range(k):
        values = (values << np.uint64(2)) | codes64[j : j + num]
    csum = np.concatenate(([0], np.cumsum(bad.astype(np.int32))))
    valid = (csum[k:] - csum[:-k]) == 0
    return values, valid


def bit_kmers(
    seq: BytesLike, k: int, canonical_form: bool = False
) -> Iterator[Tuple[int, BitKmer, bool]]:
    """Yield ``(pos, (value, k), was_rc)`` for every all-ACGT window.

    When ``canonical_form`` is True yields the integer-min of the forward and
    reverse-complement values; ties keep the forward value with
    ``was_rc=False`` (ref bitkmer.rs:136-143 — strictly-greater picks rc).
    """
    values, valid = pack_kmers(seq, k)
    if canonical_form:
        rc_vals = _rc_values(values, k)
        use_rc = values > rc_vals
        out_vals = np.where(use_rc, rc_vals, values)
        for pos in np.nonzero(valid)[0]:
            yield (int(pos), (int(out_vals[pos]), k), bool(use_rc[pos]))
    else:
        for pos in np.nonzero(valid)[0]:
            yield (int(pos), (int(values[pos]), k), False)


# Class-style alias mirroring the reference type name.
BitNuclKmer = bit_kmers


_M2 = np.uint64(0x3333_3333_3333_3333)
_M4 = np.uint64(0x0F0F_0F0F_0F0F_0F0F)
_M8 = np.uint64(0x00FF_00FF_00FF_00FF)
_M16 = np.uint64(0x0000_FFFF_0000_FFFF)
_M32 = np.uint64(0x0000_0000_FFFF_FFFF)
_ALL1 = np.uint64(0xFFFF_FFFF_FFFF_FFFF)


def _rc_values(values: np.ndarray, k: int) -> np.ndarray:
    """Vectorized bit-twiddling reverse complement (ref bitkmer.rs:112-132)."""
    v = values.astype(np.uint64, copy=True)
    v = ((v >> np.uint64(2)) & _M2) | ((v & _M2) << np.uint64(2))
    v = ((v >> np.uint64(4)) & _M4) | ((v & _M4) << np.uint64(4))
    v = ((v >> np.uint64(8)) & _M8) | ((v & _M8) << np.uint64(8))
    v = ((v >> np.uint64(16)) & _M16) | ((v & _M16) << np.uint64(16))
    v = ((v >> np.uint64(32)) & _M32) | ((v & _M32) << np.uint64(32))
    v ^= _ALL1
    v >>= np.uint64(2 * (32 - k))
    return v


def reverse_complement(kmer: BitKmer) -> BitKmer:
    """Reverse complement of a single ``BitKmer`` (ref bitkmer.rs:112-132)."""
    value, k = kmer
    arr = np.array([value], dtype=np.uint64)
    return (int(_rc_values(arr, k)[0]), k)


def canonical(kmer: BitKmer) -> Tuple[BitKmer, bool]:
    """Lexicographically-lowest of kmer/rc and whether rc was chosen
    (ref bitkmer.rs:136-143; tie keeps forward)."""
    rc = reverse_complement(kmer)
    if kmer[0] > rc[0]:
        return rc, True
    return kmer, False


def minimizer(kmer: BitKmer, minmer_size: int) -> BitKmer:
    """Lexicographically lowest substring of the kmer (ref bitkmer.rs:146-162).

    Quirk preserved from the reference: the reverse complement of each
    candidate window is computed *as a k-length kmer* (``kmer.1``), not an
    m-length one, so rc candidates carry implied leading 'A's.
    """
    value, k = kmer
    new_kmer = value
    lowest = (1 << 64) - 1
    bitmask = (1 << (2 * minmer_size)) - 1
    for _ in range(k - minmer_size + 1):
        cur = bitmask & new_kmer
        if cur < lowest:
            lowest = cur
        cur_rev = reverse_complement((cur, k))[0]
        if cur_rev < lowest:
            lowest = cur_rev
        new_kmer >>= 2
    return (lowest, k)


_BIT2NUC = b"ACGT"


def bitmer_to_bytes(kmer: BitKmer) -> bytes:
    """Decode a ``BitKmer`` back to ASCII bases (ref bitkmer.rs:164-186)."""
    value, k = kmer
    out = bytearray(k)
    for i in range(k):
        out[k - 1 - i] = _BIT2NUC[(value >> (2 * i)) & 3]
    return bytes(out)


def bytes_to_bitmer(kmer: BytesLike) -> BitKmer:
    """Pack ASCII bases into a ``BitKmer`` (invalid bases behave like the
    reference's ``extend_kmer`` returning False -> they simply don't extend,
    but this helper assumes valid input as the reference test helper does)."""
    raw = _as_np(kmer)
    k = raw.size
    value = 0
    for b in raw:
        code = int(NUC2BIT_LUT[b])
        if code != 255:
            value = ((value << 2) | code) & ((1 << (2 * k)) - 1)
    return (value, k)
