"""Seeded synthetic inputs: read planes for holding kernels against their
plain versions (the tests and ``chip_smoke.py`` use them), and the
whole-genome FASTA of the genome-spectrum path.

Every input comes from a numpy ``Generator``, so the JAX package, the
port's plain versions and its CUDA kernels all see the same bytes.
"""

from __future__ import annotations

import numpy as np

from ..batch import PackedReadBatch
from ..encoding import pack_codes_host_rows

__all__ = [
    "CLEAN", "DIRTY", "random_reads", "packed_batch", "packed_rows",
    "odd_offset_view", "synthetic_genome",
]

# case-folded bases only: every in-length byte encodes
CLEAN = b"ACGTacgt"
# plus N, U/u (a base only under normalization), IUPAC codes and a NUL
DIRTY = b"ACGTacgtACGTNnUuRYKMSWB\x00"


def random_reads(
    rng: np.random.Generator,
    rows: int,
    width: int,
    dirty_frac: float = 0.0,
    full_frac: float = 0.25,
):
    """``(seqs uint8 [rows, width], lengths int32 [rows])``.

    A row draws from :data:`DIRTY` with probability ``dirty_frac``, else
    from :data:`CLEAN`.  Lengths are uniform in ``[0, width]``, with about
    ``full_frac`` of the rows at the full width; bytes past a row's length
    are 0, as the framers pad them.  With ``dirty_frac > 0``, row 0 is
    full width and holds an N, so some row is always dirty.
    """
    lengths = rng.integers(0, width + 1, rows).astype(np.int32)
    lengths[rng.random(rows) < full_frac] = width
    clean = np.frombuffer(CLEAN, np.uint8)
    dirty = np.frombuffer(DIRTY, np.uint8)
    seqs = clean[rng.integers(0, clean.size, (rows, width))]
    is_dirty = rng.random(rows) < dirty_frac
    n_dirty = int(is_dirty.sum())
    if n_dirty:
        seqs[is_dirty] = dirty[rng.integers(0, dirty.size, (n_dirty, width))]
    seqs[np.arange(width)[None, :] >= lengths[:, None]] = 0
    if dirty_frac > 0 and rows and width:
        # at least one row holds an ambiguous base within its length
        lengths[0] = width
        seqs[0, width // 2] = ord("N")
    return seqs, lengths


def packed_batch(
    seqs: np.ndarray, lengths: np.ndarray, vmode: int, normalized: bool = True
) -> PackedReadBatch:
    """Pack an ASCII plane in one validity shape of the wire: 0 clean (no
    validity plane), 1 dense bitplane, 2 lean rows.  Raises when the reads
    do not allow that shape (vmode 0 needs clean reads, 1 and 2 dirty)."""
    codes, vbits, row_invalid = pack_codes_host_rows(
        seqs, lengths, normalized=normalized
    )
    if (vmode == 0) != (vbits is None):
        raise ValueError(f"vmode {vmode} does not fit these reads")
    if vmode == 2:
        rows = np.flatnonzero(row_invalid).astype(np.int32)
        return PackedReadBatch(
            codes=codes, lengths=lengths, normalized=normalized,
            vrows=np.ascontiguousarray(vbits[rows]), vrow_idx=rows,
        )
    return PackedReadBatch(
        codes=codes, lengths=lengths, vbits=vbits, normalized=normalized
    )


def packed_rows(
    rng: np.random.Generator, rows: int, width: int, dirty_frac: float = 0.0
):
    """``(codes uint8 [rows, width/4], vbits uint8 [rows, width/8] or None,
    lengths int32 [rows])``: :func:`random_reads` packed at ``width``
    bases, a multiple of 4.  A validity plane needs a multiple of 8, so
    reads of any other width are clean, packed at the next multiple of 8
    and cut back: a row pitch of ``width / 4`` bytes, whatever it is."""
    if width % 4 or (width % 8 and dirty_frac):
        raise ValueError(f"no packed rows of {width} bases at dirty_frac {dirty_frac}")
    wide = -(-width // 8) * 8
    seqs, lengths = random_reads(rng, rows, wide, dirty_frac)
    lengths = np.minimum(lengths, width).astype(np.int32)
    seqs[:, width:] = 0
    codes, vbits, _ = pack_codes_host_rows(seqs, lengths)
    return np.ascontiguousarray(codes[:, : width // 4]), vbits, lengths


def odd_offset_view(plane):
    """``plane`` (a uint8 tensor) copied to byte offset 1 of a new buffer
    on its device: a validity plane as unaligned as a view of the wire can
    be."""
    import torch

    buf = torch.empty(plane.numel() + 1, dtype=torch.uint8, device=plane.device)
    view = buf[1:].view(plane.shape)
    view.copy_(plane)
    return view


def synthetic_genome(
    n_bases: int, seed: int = 31, line_width: int = 80, name: str = "synth"
) -> bytes:
    """A uniform-ACGT FASTA genome as one record wrapped at ``line_width``:
    the same bytes as the JAX package's ``synthetic_genome`` for the same
    arguments (``default_rng(seed)`` fixes the stream)."""
    rng = np.random.default_rng(seed)
    bases = rng.integers(0, 4, n_bases, dtype=np.uint8)
    seq = np.frombuffer(b"ACGT", dtype=np.uint8)[bases]
    full, rem = divmod(n_bases, line_width)
    body = np.full(
        (full + (1 if rem else 0), line_width + 1), ord("\n"), np.uint8
    )
    body[:full, :line_width] = seq[: full * line_width].reshape(full, line_width)
    if rem:
        body[full, :rem] = seq[full * line_width :]
        body = body[:full].tobytes() + body[full, : rem + 1].tobytes()
    else:
        body = body.tobytes()
    return b">" + name.encode() + b" synthetic uniform genome\n" + body
