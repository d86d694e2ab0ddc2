"""Host-side 2-bit encoding tables and packed-plane helpers.

The port's copy of the JAX package's ``encoding.py``: the same tables
(built here directly, without the host sequence and bit-k-mer modules),
the row packer the batches use, and the host packer and unpacker.

One source of truth for the byte -> 2-bit code mapping shared by the C
framer's packed fills (``csrc/framer.cpp::nt_fill_*_batch_packed``), the
numpy fallback packer, and the device kernels (``device.ops.encode_2bit``
reproduces the same mapping as a branchless select chain) — so packed
transport is bit-identical to on-device encoding of raw ASCII.

Two modes, matching the reference's two compositions:

  * ``normalized=True``  — strict normalization then encode (U/u count as
    T, IUPAC/other invalid; ref sequence.rs:19-62 + bitkmer.rs:5-18).
  * ``normalized=False`` — the raw ``bit_kmers`` LUT: only ACGT/acgt valid
    (ref bitkmer.rs:5-18).

Packed plane layout (the transport format):

  * codes: uint8 [rows, max_len/4] — base j in byte ``j>>2`` at bits
    ``2*(j&3)`` (LSB-first within the byte); invalid/padding bases are 0.
  * vbits: uint8 [rows, max_len/8] — bit ``j&7`` of byte ``j>>3`` set iff
    base j mapped to a real code.  ``None`` means "every in-length base
    valid" (the clean-read fast path: 0.25 B/base on the wire).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

__all__ = [
    "ENCODE_RAW_LUT",
    "ENCODE_NORMALIZED_LUT",
    "encode_lut",
    "pack_codes_host",
    "pack_codes_host_rows",
    "unpack_codes_host",
]

_INVALID = 255


def _build_lut(bases: bytes) -> np.ndarray:
    """byte -> 2-bit code (A0 C1 G2 T3, U as T) for the upper-case
    ``bases`` and their lower-case forms; every other byte is invalid."""
    out = np.full(256, _INVALID, dtype=np.uint8)
    for ch in bases:
        code = min(b"ACGTU".index(ch), 3)
        out[ch] = code
        out[ch + 32] = code  # lowercase
    return out


# only ACGT/acgt encode
ENCODE_RAW_LUT = _build_lut(b"ACGT")
# strict normalization first: U/u count as T, IUPAC codes and the rest are
# invalid (the reference's normalize(false) + bit_kmers composition)
ENCODE_NORMALIZED_LUT = _build_lut(b"ACGTU")


def encode_lut(normalized: bool) -> np.ndarray:
    """The 256-entry byte -> 2-bit-code table (0xFF invalid) for a mode."""
    return ENCODE_NORMALIZED_LUT if normalized else ENCODE_RAW_LUT


def pack_codes_host(
    seqs: np.ndarray, lengths: np.ndarray, normalized: bool = True
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Vectorized numpy packer: ASCII [B, L] -> (codes [B, L/4], vbits).

    The pure-host twin of the C framer's packed fills.  L must be a
    multiple of 8.  ``vbits`` is None iff every IN-LENGTH byte encoded
    cleanly (padding beyond ``lengths`` never forces a validity plane;
    consumers mask windows by length anyway).
    """
    codes, vbits, _ = pack_codes_host_rows(seqs, lengths, normalized)
    return codes, vbits


def pack_codes_host_rows(
    seqs: np.ndarray, lengths: np.ndarray, normalized: bool = True
) -> Tuple[np.ndarray, Optional[np.ndarray], np.ndarray]:
    """Vectorized numpy packer, ASCII [B, L] -> packed planes, plus the
    per-row invalid-base counts the lean transport needs: the host twin of
    the C framer's ``*_packed_rows`` fills (its fallback and test oracle).
    L must be a multiple of 8.  Returns ``(codes [B, L/4], vbits [B, L/8]
    or None, row_invalid int32 [B])``; ``vbits`` is None iff every
    in-length byte encoded cleanly."""
    b, l = seqs.shape
    if l % 8:
        raise ValueError(f"max_len {l} must be a multiple of 8 to pack")
    lut = encode_lut(normalized)
    codes8 = lut[seqs]
    in_len = np.arange(l, dtype=np.int32)[None, :] < np.asarray(lengths)[:, None]
    valid = (codes8 != _INVALID) & in_len
    c = np.where(valid, codes8, 0).astype(np.uint8)
    c = c.reshape(b, l // 4, 4)
    packed = (
        c[:, :, 0]
        | (c[:, :, 1] << 1 * 2)
        | (c[:, :, 2] << 2 * 2)
        | (c[:, :, 3] << 3 * 2)
    ).astype(np.uint8)
    row_invalid = (~valid & in_len).sum(axis=1, dtype=np.int32)
    if bool(row_invalid.any()):
        vbits = np.packbits(valid, axis=1, bitorder="little")
        return packed, vbits, row_invalid
    return packed, None, row_invalid


def unpack_codes_host(
    codes: np.ndarray, vbits: Optional[np.ndarray]
) -> np.ndarray:
    """Packed planes -> per-base codes [B, L] uint8 (255 invalid); host
    twin of ``device.ops.unpack_codes`` for tests."""
    b, lq = codes.shape
    l = lq * 4
    out = np.empty((b, l), dtype=np.uint8)
    for j in range(4):
        out[:, j::4] = (codes >> (2 * j)) & 3
    if vbits is not None:
        valid = np.unpackbits(vbits, axis=1, bitorder="little")[:, :l]
        out = np.where(valid.astype(bool), out, np.uint8(_INVALID))
    return out
