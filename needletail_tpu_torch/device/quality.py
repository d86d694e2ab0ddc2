"""Quality-aware device ops: masking low-quality bases before k-mer work,
and per-read mean Phred scores.

Counterpart of ``needletail_tpu/device/quality.py`` (XLA code there, no
Pallas kernel, so plain tensor ops are its port).  A masked base becomes
'N', an invalid code, so every window over it vanishes exactly as it would
after host-side masking (ref sequence.rs:280-308).  On the card the
counting drivers feed the masked bytes to the key-plane kernel
(``kernels.canonical_key_planes``) instead of :func:`masked_canonical_kmers`,
which is that route's plain version.
"""

from __future__ import annotations

from typing import Union

import torch

from .kmers import KmerWindows, canonical_kmers, pack_kmers
from .ops import quality_mask

__all__ = ["quality_mask_batch", "masked_canonical_kmers", "mean_quality"]


def _in_read(like: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    pos = torch.arange(like.shape[1], dtype=torch.int64, device=like.device)
    return pos[None, :] < lengths.to(torch.int64)[:, None]


def quality_mask_batch(
    seqs: torch.Tensor,
    quals: torch.Tensor,
    lengths: torch.Tensor,
    score: Union[int, torch.Tensor],
) -> torch.Tensor:
    """Bases with quality below ``score`` become 'N'; padding stays 0."""
    masked = quality_mask(seqs, quals, score)
    return torch.where(_in_read(seqs, lengths), masked, 0).to(torch.uint8)


def masked_canonical_kmers(
    seqs: torch.Tensor,
    quals: torch.Tensor,
    lengths: torch.Tensor,
    score: Union[int, torch.Tensor],
    k: int,
    canonical: bool = True,
    normalized: bool = True,
) -> KmerWindows:
    """(Canonical) k-mer windows of the quality-masked batch: a masked base
    invalidates every window over it."""
    masked = quality_mask(seqs, quals, score)
    fn = canonical_kmers if canonical else pack_kmers
    return fn(masked, lengths, k, normalized=normalized)


def mean_quality(
    quals: torch.Tensor, lengths: torch.Tensor, offset: int
) -> torch.Tensor:
    """float32 ``[B]`` mean Phred score of each read; an empty read gives 0.

    JAX's arithmetic step for step: the int32 scores inside the read are
    summed exactly, the sum cast to float32 and divided by
    ``float32(max(length, 1))``.  ``quality_filter_file`` keeps a read by
    ``mean >= cutoff``, so an ulp of difference would change its output.
    """
    scores = torch.where(
        _in_read(quals, lengths), quals.to(torch.int32) - offset, 0
    )
    denom = lengths.to(torch.int32).clamp(min=1).to(torch.float32)
    return scores.sum(dim=1).to(torch.float32) / denom
