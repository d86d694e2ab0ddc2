"""Packed k-mer windows and their canonical form, in plain PyTorch.

Counterpart of ``needletail_tpu/device/kmers.py`` (XLA code there, not a
Pallas kernel, so plain tensor ops are its port).  A window is the 2-bit
packing of k bases, first base most significant (A0 C1 G2 T3).  Each one
is built directly in one int64 per lane, as the plain hash-key version
does; the JAX package builds them with doubling ladders of uint32 planes
because a TPU lane has no 64-bit integers.

Windows leave as the JAX package's ``(hi, lo)`` split of the packed value:
for k <= 16 ``hi`` is 0 and ``lo`` holds all 2k bits; for k > 16 ``hi`` is
the first k-16 bases (``value >> 32``) and ``lo`` the last 16.  Both are
int32 tensors holding the uint32 bit patterns (PyTorch has no uint32
arithmetic on the CPU).  Their values where ``valid`` is False are
unspecified (the JAX package leaves ladder residue there).

The canonical window is the integer min of the forward window and its
reverse complement; a tie keeps forward (ref bitkmer.rs:136-143).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from .ops import encode_2bit

__all__ = [
    "KmerWindows",
    "pack_kmers",
    "canonical_kmers",
    "window_validity",
    "u32_bits",
]


class KmerWindows(NamedTuple):
    """Packed k-mer windows of a batch.

    ``hi``/``lo``: int32 ``[B, W]`` uint32 bit patterns (W = L - k + 1
    window positions per read); ``valid``: bool ``[B, W]``, all k bases
    unambiguous and inside the read; ``was_rc``: bool ``[B, W]``, set only
    by :func:`canonical_kmers`.
    """

    hi: torch.Tensor
    lo: torch.Tensor
    valid: torch.Tensor
    was_rc: torch.Tensor


def u32_bits(x: torch.Tensor) -> torch.Tensor:
    """int32 tensor with the low 32 bits of the int64 ``x``."""
    x = x & 0xFFFFFFFF
    return ((x ^ 0x80000000) - 0x80000000).to(torch.int32)


def _check(codes: torch.Tensor, k: int) -> int:
    if not 1 <= k <= 31:
        raise ValueError(f"k must be in [1, 31], got {k}")
    l = codes.shape[1]
    if l < k:
        raise ValueError(f"batch max_len {l} shorter than k={k}")
    return l - k + 1


def _codes(seqs: torch.Tensor, normalized: bool, precoded: bool) -> torch.Tensor:
    return (seqs if precoded else encode_2bit(seqs, normalized)).to(torch.int64)


def _windows(
    codes: torch.Tensor, lengths: torch.Tensor, k: int, need_rc: bool
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(fwd, rc, valid)`` over ``[B, W]``: the int64 forward window, its
    reverse complement (None unless ``need_rc``) and the validity."""
    num = _check(codes, k)
    b = codes.shape[0]
    fwd = torch.zeros((b, num), dtype=torch.int64, device=codes.device)
    rc = torch.zeros_like(fwd) if need_rc else None
    valid = torch.ones((b, num), dtype=torch.bool, device=codes.device)
    for j in range(k):
        cj = codes[:, j : j + num]
        valid &= cj < 4
        base = cj & 3
        fwd = (fwd << 2) | base
        if need_rc:
            rc |= (3 - base) << (2 * j)
    pos = torch.arange(num, device=codes.device)[None, :]
    valid &= pos + k <= lengths.to(torch.int64)[:, None]
    return fwd, rc, valid


def _split(value: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    return u32_bits(value >> 32), u32_bits(value)


def window_validity(
    codes: torch.Tensor, lengths: torch.Tensor, k: int
) -> torch.Tensor:
    """bool ``[B, W]``: the window has k in-bounds, unambiguous bases
    (``codes``: per-base 2-bit codes, 255 invalid)."""
    num = _check(codes, k)
    bad = codes.to(torch.int64) >= 4
    # windows holding no invalid code: a sliding sum over k lanes
    csum = torch.nn.functional.pad(bad.to(torch.int64).cumsum(1), (1, 0))
    valid = (csum[:, k : k + num] - csum[:, :num]) == 0
    pos = torch.arange(num, device=codes.device)[None, :]
    return valid & (pos + k <= lengths.to(torch.int64)[:, None])


def pack_kmers(
    seqs: torch.Tensor,
    lengths: torch.Tensor,
    k: int,
    normalized: bool = True,
    precoded: bool = False,
) -> KmerWindows:
    """Forward-strand packed windows at every position.

    ``seqs``: uint8 ``[B, L]`` ASCII, or with ``precoded=True`` per-base
    2-bit codes (255 invalid, e.g. ``ops.unpack_codes`` of the packed
    transport), whose encode step is then skipped.
    """
    fwd, _, valid = _windows(_codes(seqs, normalized, precoded), lengths, k, False)
    hi, lo = _split(fwd)
    return KmerWindows(hi=hi, lo=lo, valid=valid, was_rc=torch.zeros_like(valid))


def canonical_kmers(
    seqs: torch.Tensor,
    lengths: torch.Tensor,
    k: int,
    normalized: bool = True,
    precoded: bool = False,
) -> KmerWindows:
    """Canonical packed windows: the integer min of forward and reverse
    complement, a tie keeping forward; ``was_rc`` marks valid windows
    taken from the reverse complement.  ``precoded`` as in
    :func:`pack_kmers`."""
    fwd, rc, valid = _windows(_codes(seqs, normalized, precoded), lengths, k, True)
    use_rc = fwd > rc
    hi, lo = _split(torch.where(use_rc, rc, fwd))
    return KmerWindows(hi=hi, lo=lo, valid=valid, was_rc=use_rc & valid)
