"""Host-side nucleic-acid sequence operations.

Byte-exact re-implementations of the reference semantics
(needletail ``src/sequence.rs``), vectorized with numpy lookup tables instead
of per-byte match statements.  These same 256-entry tables are reused by the
port's device ops (``needletail_tpu_torch.device.ops``) as tensor gathers, so
host and device results agree bit-for-bit.  The port's own copy of the JAX
package's ``sequence.py``, unchanged but for this paragraph.

Key semantics preserved:
  * ``normalize`` (ref sequence.rs:19-62): case-fold, U->T, ``.``/``~`` -> ``-``,
    whitespace dropped, IUPAC codes kept (upper-cased) iff ``iupac=True`` else
    mapped to ``N``; everything else -> ``N``.  Returns ``None`` when nothing
    changed (copy-on-write contract).
  * ``complement`` (ref sequence.rs:68-105): ACGT + IUPAC complement table,
    everything else passes through (including ``U``!).
  * ``canonical`` (ref sequence.rs:110-134): lexicographic min of the sequence
    and its reverse complement; ties return the original.
  * ``minimizer`` (ref sequence.rs:139-152): lexicographically smallest
    length-``l`` substring over the sequence *and* its reverse complement.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np

__all__ = [
    "normalize",
    "complement",
    "reverse_complement",
    "canonical",
    "minimizer",
    "strip_returns",
    "quality_mask",
    "COMPLEMENT_LUT",
    "normalize_luts",
]

BytesLike = Union[bytes, bytearray, memoryview, np.ndarray]

# Sentinel output value marking "drop this byte" in the normalize tables.
# Input byte 0 never maps to 0 (it normalizes to 'N'), so 0 is free.
_DROP = 0


def _build_normalize_luts() -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Build (map_iupac, map_strict, changed_iupac, changed_strict) tables.

    ``map_*[b]`` is the output byte for input ``b`` (``_DROP`` = emit nothing);
    ``changed_*[b]`` is True when emitting input ``b`` counts as "changed" for
    the copy-on-write check (ref sequence.rs:24-52).
    """
    map_iupac = np.full(256, ord("N"), dtype=np.uint8)
    map_strict = np.full(256, ord("N"), dtype=np.uint8)
    changed_iupac = np.ones(256, dtype=bool)
    changed_strict = np.ones(256, dtype=bool)

    def set_both(b: int, out: int, changed: bool) -> None:
        map_iupac[b] = out
        map_strict[b] = out
        changed_iupac[b] = changed
        changed_strict[b] = changed

    for ch in b"ACGTN-":
        set_both(ch, ch, False)
    for lo, up in zip(b"acg", b"ACG"):
        set_both(lo, up, True)
    # normalize uridine to thymine; lowercase t also maps up
    for ch in b"tuU":
        set_both(ch, ord("T"), True)
    # 'T' itself is unchanged (handled by ACGTN- above)
    # normalize gaps
    for ch in b".~":
        set_both(ch, ord("-"), True)
    # IUPAC ambiguity codes
    for ch in b"BDHVRYSWKM":
        map_iupac[ch] = ch
        changed_iupac[ch] = False
        # strict mode: -> N, changed (defaults already do this)
    for ch in b"bdhvryswkm":
        map_iupac[ch] = ch - 32  # uppercase
        changed_iupac[ch] = True
    # whitespace and line endings are dropped (and count as a change)
    for ch in b" \t\r\n":
        set_both(ch, _DROP, True)
    return map_iupac, map_strict, changed_iupac, changed_strict


_MAP_IUPAC, _MAP_STRICT, _CHANGED_IUPAC, _CHANGED_STRICT = _build_normalize_luts()


def normalize_luts(iupac: bool) -> Tuple[np.ndarray, np.ndarray]:
    """Return the (byte-map, changed-map) 256-entry tables for ``iupac``."""
    if iupac:
        return _MAP_IUPAC, _CHANGED_IUPAC
    return _MAP_STRICT, _CHANGED_STRICT


def _build_complement_lut() -> np.ndarray:
    lut = np.arange(256, dtype=np.uint8)  # default: pass through
    pairs = (
        b"at" b"cg" b"gc" b"ta"
        b"ry" b"yr" b"km" b"mk" b"bv" b"vb" b"dh" b"hd" b"ss" b"ww"
    )
    for i in range(0, len(pairs), 2):
        a, b = pairs[i], pairs[i + 1]
        lut[a] = b
        lut[a - 32] = b - 32  # uppercase pair
    return lut


COMPLEMENT_LUT = _build_complement_lut()


def _as_np(seq: BytesLike) -> np.ndarray:
    if isinstance(seq, np.ndarray):
        return seq.astype(np.uint8, copy=False)
    return np.frombuffer(bytes(seq) if isinstance(seq, memoryview) else seq, dtype=np.uint8)


def normalize(seq: BytesLike, iupac: bool = False) -> Optional[bytes]:
    """Normalized form of ``seq``; ``None`` when the input was already normal.

    Ref sequence.rs:19-62 (same copy-on-write contract).
    """
    arr = _as_np(seq)
    if arr.size == 0:
        return None
    byte_map, changed_map = normalize_luts(iupac)
    mapped = byte_map[arr]
    if not changed_map[arr].any():
        return None
    kept = mapped[mapped != _DROP]
    return kept.tobytes()


def complement(n: int) -> int:
    """Complementary base for a single IUPAC base code (ref sequence.rs:68-105)."""
    return int(COMPLEMENT_LUT[n])


def reverse_complement(seq: BytesLike) -> bytes:
    """Reverse complement of ``seq`` (ref sequence.rs:202-208)."""
    arr = _as_np(seq)
    return COMPLEMENT_LUT[arr[::-1]].tobytes()


def canonical(seq: BytesLike) -> bytes:
    """Lexicographically smaller of ``seq`` and its reverse complement.

    Ties return the original sequence (ref sequence.rs:110-134).
    """
    raw = bytes(_as_np(seq).tobytes())
    rc = reverse_complement(raw)
    return raw if raw <= rc else rc


def _lex_min_window(arr: np.ndarray, length: int) -> bytes:
    """Lexicographic minimum length-``length`` window of ``arr``,
    vectorized by candidate refinement: keep the windows whose j-th byte
    is minimal, column by column — typical cost O(n + length·survivors)
    instead of O(n·length) Python slicing."""
    n = arr.size - length + 1
    cand = np.arange(n)
    for j in range(length):
        col = arr[cand + j]
        m = col.min()
        keep = col == m
        if not keep.all():
            cand = cand[keep]
        if cand.size == 1:
            break
    i = int(cand[0])
    return arr[i : i + length].tobytes()


def minimizer(seq: BytesLike, length: int) -> bytes:
    """Lexicographically smallest length-``length`` substring of ``seq`` or its
    reverse complement (ref sequence.rs:139-152)."""
    arr = _as_np(seq)
    if not 1 <= length <= arr.size:
        # the reference panics on the out-of-bounds slice &seq[..length]
        raise ValueError(
            f"minimizer length {length} out of range for a {arr.size}-byte sequence"
        )
    rc = np.frombuffer(reverse_complement(arr.tobytes()), dtype=np.uint8)
    fwd = _lex_min_window(arr, length)
    rev = _lex_min_window(rc, length)
    return fwd if fwd <= rev else rev


def strip_returns(seq: BytesLike) -> bytes:
    """Remove all ``\\r`` and ``\\n`` bytes (ref sequence.rs:165-191)."""
    arr = _as_np(seq)
    mask = (arr != 0x0A) & (arr != 0x0D)
    if mask.all():
        return arr.tobytes()
    return arr[mask].tobytes()


def quality_mask(seq: BytesLike, qual: BytesLike, score: int) -> bytes:
    """Mask bases whose quality byte is below ``score`` with ``N``
    (ref sequence.rs:280-296)."""
    s = _as_np(seq)
    q = _as_np(qual)
    return np.where(q < np.uint8(score), np.uint8(ord("N")), s).tobytes()
