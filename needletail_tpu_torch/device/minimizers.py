"""Minimizers on the device.

Counterpart of ``needletail_tpu/device/minimizers.py`` (XLA code there, no
Pallas kernel).  Two granularities:

  * :func:`global_minimizer`: per read, the smallest canonical k-mer value
    (for pure-ACGT reads the reference's byte-level ``minimizer``, ref
    sequence.rs:139-152);
  * :func:`window_minimizers`: the (w, k) minimizer sketch, for every run
    of ``w`` consecutive k-mer windows the smallest canonical value; a
    sketch window is valid iff all ``w`` k-mer windows in it are.

JAX orders (hi, lo) uint32 pairs with a two-word compare.  Here a pair is
one int64, ``hi << 32 | lo`` with ``lo`` taken as unsigned (the planes
hold uint32 bit patterns in int32, so a ``lo`` with bit 31 set reads as
negative and must never be compared raw); an invalid window is
``INT64_MAX``, above every key (< 2^62), and leaves as JAX's
``(0xFFFFFFFF, 0xFFFFFFFF)``, -1 in both planes.

:func:`window_minimizers_from_planes` takes the key-plane kernel's planes
(``kernels.canonical_key_planes(_packed)``) in place of :mod:`kmers`
windows: the route of ``minimizer_spectrum_file`` on the card.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .kmers import KmerWindows, canonical_kmers, u32_bits

__all__ = [
    "global_minimizer",
    "window_minimizers",
    "window_minimizers_from_planes",
]

_NONE = torch.iinfo(torch.int64).max  # an invalid window: above every key


def _pair_values(
    hi: torch.Tensor, lo: torch.Tensor, valid: torch.Tensor
) -> torch.Tensor:
    """int64 ``hi << 32 | unsigned lo`` where valid, else ``_NONE``."""
    value = (hi.to(torch.int64) << 32) | (lo.to(torch.int64) & 0xFFFFFFFF)
    return torch.where(valid, value, _NONE)


def _pair_planes(value: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``value`` back to int32 (hi, lo) bit patterns; ``_NONE`` -> -1, -1."""
    none = value == _NONE
    return (
        torch.where(none, -1, u32_bits(value >> 32)).to(torch.int32),
        torch.where(none, -1, u32_bits(value)).to(torch.int32),
    )


def global_minimizer(
    seqs: torch.Tensor,
    lengths: torch.Tensor,
    k: int,
    normalized: bool = True,
    precoded: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-read minimum canonical k-mer value: ``(hi, lo, any_valid)``,
    each ``[B]``; a read with no valid window gives ``(-1, -1, False)``
    (JAX's ``0xFFFFFFFF`` pair).  ``precoded`` as in ``kmers.pack_kmers``."""
    win = canonical_kmers(
        seqs, lengths, k, normalized=normalized, precoded=precoded
    )
    m_hi, m_lo = _pair_planes(
        _pair_values(win.hi, win.lo, win.valid).amin(dim=1)
    )
    return m_hi, m_lo, win.valid.any(dim=1)


def _sketch(
    value: torch.Tensor, valid: torch.Tensor, w: int
) -> KmerWindows:
    """The (w, k) sketch of ``[B, W]`` window values: ``W - w + 1``
    positions, position p covering windows p..p+w-1.

    JAX's doubling ladder (O(log w) steps) with its rolled wrap-around
    lanes, which reach only sketch positions it slices off, never formed:
    each step pairs a lane with the lane ``m`` ahead and drops the last
    ``m``.
    """
    if w < 1:
        raise ValueError("w must be >= 1")
    num = value.shape[1] - w + 1
    if num < 1:
        raise ValueError(
            f"sequence windows {value.shape[1]} shorter than w={w}"
        )

    def step(x, v, m):
        return (
            torch.minimum(x[:, :-m], x[:, m:]),
            v[:, :-m] & v[:, m:],
        )

    m = 1
    while 2 * m <= w:
        value, valid = step(value, valid, m)
        m *= 2
    # min and AND are idempotent: two overlapping m-spans cover w
    if m < w:
        value, valid = step(value, valid, w - m)
    hi, lo = _pair_planes(value)
    return KmerWindows(hi=hi, lo=lo, valid=valid, was_rc=torch.zeros_like(valid))


def window_minimizers(
    seqs: torch.Tensor,
    lengths: torch.Tensor,
    k: int,
    w: int,
    normalized: bool = True,
    precoded: bool = False,
) -> KmerWindows:
    """(w, k) minimizer sketch: the minimum canonical k-mer of each run of
    ``w`` windows.

    Returns ``KmerWindows`` over ``L - k - w + 2`` sketch positions
    (position p covers k-mer windows p..p+w-1), ``was_rc`` all False.
    The (hi, lo) of an invalid position are the minimum over its valid
    windows, (-1, -1) if it has none, as in JAX.  ``precoded`` as in
    ``kmers.pack_kmers``.
    """
    win = canonical_kmers(
        seqs, lengths, k, normalized=normalized, precoded=precoded
    )
    return _sketch(_pair_values(win.hi, win.lo, win.valid), win.valid, w)


def window_minimizers_from_planes(
    hi: torch.Tensor, lo: torch.Tensor, k: int, w: int
) -> KmerWindows:
    """:func:`window_minimizers` over canonical key planes.

    ``hi``/``lo``: int32 ``[B, L]`` planes of ``kernels.canonical_key_planes``
    or ``canonical_key_planes_packed`` (uint32 bit patterns, -1 in both
    where the window is invalid; a valid ``hi`` is below 2^30, so ``hi !=
    -1`` is the validity).  Only the ``L - k + 1`` lanes where a window
    can start enter the sketch, so it is as wide as JAX's.
    """
    width = hi.shape[1] - k + 1
    if width < 1:
        raise ValueError(f"batch max_len {hi.shape[1]} shorter than k={k}")
    hi, lo = hi[:, :width], lo[:, :width]
    valid = hi != -1
    return _sketch(_pair_values(hi, lo, valid), valid, w)
