"""Elementwise device ops over padded ``[B, L]`` uint8 batches, the
one-buffer wire back into its planes, validity planes, and the 2-bit
encode.

Counterpart of ``needletail_tpu/device/ops.py``; every function returns
what its JAX twin returns on the same input.  The byte ops gather from the
host's 256-entry tables (:mod:`needletail_tpu_torch.sequence`), so device
and host agree byte for byte.  Lengths and row indices are composed from
bytes in int32, never through ``uint16``/``uint32`` tensors, whose shifts
PyTorch does not implement on the CPU.  Results stay on the device of the
input.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from .. import sequence as _hostseq

__all__ = [
    "normalize",
    "complement",
    "reverse_complement",
    "quality_mask",
    "decode_phred",
    "unwire",
    "unpack_codes",
    "expand_vrows",
    "resolve_vbits",
    "encode_2bit",
]

_INVALID = 255


def _lut(table, like: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(table).to(like.device)


def normalize(
    seqs: torch.Tensor, iupac: bool = False
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Normalized bytes (ref sequence.rs:19-62) and a keep mask.

    Whitespace maps to 0 with ``keep`` False (the host normalize drops
    it); padding (byte 0) maps to 'N' with ``keep`` True, so mask by the
    lengths separately.
    """
    byte_map, _ = _hostseq.normalize_luts(iupac)
    out = _lut(byte_map, seqs)[seqs.to(torch.int64)]
    return out, out != 0


def complement(seqs: torch.Tensor) -> torch.Tensor:
    """Per-base IUPAC complement (ref sequence.rs:68-105)."""
    return _lut(_hostseq.COMPLEMENT_LUT, seqs)[seqs.to(torch.int64)]


def reverse_complement(seqs: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Length-aware reverse complement of each row (ref
    sequence.rs:202-208): row i's first ``lengths[i]`` lanes hold it and
    the rest is zero."""
    l = seqs.shape[1]
    comp = complement(seqs)
    pos = torch.arange(l, dtype=torch.int64, device=seqs.device)[None, :]
    src = lengths.to(torch.int64)[:, None] - 1 - pos
    flipped = torch.gather(comp, 1, src.clamp(0, l - 1))
    return torch.where(src >= 0, flipped, 0).to(torch.uint8)


def quality_mask(
    seqs: torch.Tensor, quals: torch.Tensor, score: Union[int, torch.Tensor]
) -> torch.Tensor:
    """Bases whose quality byte is below ``score`` become 'N' (ref
    sequence.rs:280-296).

    The compare is in int32, as JAX promotes ``uint8 < int32``: PyTorch
    would wrap a Python int into uint8 (``q < 300`` as ``q < 44``), so a
    threshold past 255 or below 0 keeps its meaning here.
    """
    return torch.where(quals.to(torch.int32) < score, ord("N"), seqs).to(
        torch.uint8
    )


def decode_phred(
    quals: torch.Tensor, offset: int = 33
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Phred scores and an ok mask: bytes below ``offset`` are flagged
    (score 0) instead of raising (ref quality.rs:15-28)."""
    ok = quals >= offset
    return (quals - offset) * ok.to(torch.uint8), ok


def unpack_codes(
    codes: torch.Tensor, vbits: Optional[torch.Tensor]
) -> torch.Tensor:
    """Packed planes -> per-base 2-bit codes ``[B, L]`` uint8 (255 invalid).

    ``codes``: uint8 ``[B, L/4]``, base j at bits ``2*(j&3)`` of byte
    ``j>>2``; ``vbits``: uint8 ``[B, L/8]`` validity bits (bit ``j&7`` of
    byte ``j>>3``) or None, meaning every base is valid.
    """
    b, lq = codes.shape
    out = torch.stack(
        [(codes >> (2 * j)) & 3 for j in range(4)], dim=-1
    ).reshape(b, lq * 4)
    if vbits is not None:
        valid = torch.stack(
            [(vbits >> j) & 1 for j in range(8)], dim=-1
        ).reshape(b, lq * 4)
        out = torch.where(valid != 0, out, _INVALID)
    return out


def expand_vrows(
    vrow_idx: torch.Tensor, vrows: torch.Tensor, num_reads: int
) -> torch.Tensor:
    """Lean validity rows -> dense ``[num_reads, L/8]`` uint8 bitplane.

    Rows not listed in ``vrow_idx`` are all ones.  An index at or beyond
    ``num_reads`` (the wire's pad index) is dropped, as JAX's
    ``.at[].set(mode="drop")`` drops it; a negative index counts from the
    end, as it does there.  Dropped rows land in a spare last row, so no
    host sync decides which rows to keep.
    """
    idx = vrow_idx.to(torch.int64)
    idx = torch.where(idx < 0, idx + num_reads, idx)
    keep = (idx >= 0) & (idx < num_reads)
    idx = torch.where(keep, idx, num_reads)
    plane = torch.full(
        (num_reads + 1, vrows.shape[1]), 0xFF,
        dtype=torch.uint8, device=vrows.device,
    )
    plane.index_copy_(0, idx, vrows)
    return plane[:num_reads]


def resolve_vbits(
    vbits: Optional[torch.Tensor],
    vrow_idx: Optional[torch.Tensor],
    vrows: Optional[torch.Tensor],
    num_reads: int,
) -> Optional[torch.Tensor]:
    """Dense plane, lean rows expanded to a dense plane, or None (clean)."""
    if vrows is not None:
        return expand_vrows(vrow_idx, vrows, num_reads)
    return vbits


def _compose_le(bytes2d: torch.Tensor) -> torch.Tensor:
    """Little-endian int32 from a ``[N, size]`` uint8 byte-plane slice."""
    w = bytes2d.to(torch.int32)
    out = w[:, 0]
    for i in range(1, bytes2d.shape[1]):
        out = out | (w[:, i] << (8 * i))
    return out


def unwire(wire: torch.Tensor, layout) -> tuple:
    """Split a one-buffer batch transport (``PackedReadBatch.wire_frame``)
    into ``(codes, lengths_i32, vbits, vrow_idx, vrows)``; see
    :class:`needletail_tpu_torch.batch.WireLayout` for the sections.  Codes and
    validity planes are views of ``wire``."""
    b, l4, l8, len_size, vcap, vmode = (
        layout.num_reads, layout.l4, layout.l8,
        layout.len_size, layout.vcap, layout.vmode,
    )
    codes = wire[: b * l4].view(b, l4)
    o = layout.codes_end
    vbits = vrow_idx = vrows = None
    if vmode == 1:
        vbits = wire[o : o + b * l8].view(b, l8)
    elif vmode == 2:
        vrows = wire[o : o + vcap * l8].view(vcap, l8)
    o = layout.val_end
    if len_size == 1:
        lengths = wire[o : o + b].to(torch.int32)
    else:
        lengths = _compose_le(wire[o : o + b * len_size].view(b, len_size))
    if vmode == 2:
        o = layout.len_end
        vrow_idx = _compose_le(wire[o : o + vcap * 4].view(vcap, 4))
    return codes, lengths, vbits, vrow_idx, vrows


def encode_2bit(seqs: torch.Tensor, normalized: bool = True) -> torch.Tensor:
    """Bytes -> 2-bit codes (A=0 C=1 G=2 T=3; 255 invalid), uint8.

    Case-folds with ``& 0xDF``; ``normalized=True`` also maps U/u to T.
    """
    up = seqs & 0xDF
    code = torch.full_like(seqs, _INVALID)
    code = torch.where(up == ord("A"), 0, code)
    code = torch.where(up == ord("C"), 1, code)
    code = torch.where(up == ord("G"), 2, code)
    is_t = up == ord("T")
    if normalized:
        is_t = is_t | (up == ord("U"))
    return torch.where(is_t, 3, code).to(torch.uint8)
