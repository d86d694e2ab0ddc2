"""Seeded synthetic inputs: read planes for holding kernels against their
plain versions (the tests and ``chip_smoke.py`` use them), the
whole-genome FASTA of the genome-spectrum path, a FASTQ of mixed read
lengths for the bucketed path, pairs of sorted spectra for the spectrum
merge, and sorted key streams for the run count.

Every input comes from a numpy ``Generator``, so the JAX package, the
port's plain versions and its CUDA kernels all see the same bytes.
"""

from __future__ import annotations

import numpy as np

from ..batch import PackedReadBatch
from ..encoding import pack_codes_host_rows

__all__ = [
    "CLEAN", "DIRTY", "random_reads", "packed_batch", "packed_rows",
    "odd_offset_view", "synthetic_genome", "mixed_length_fastq",
    "spectra_pair", "merge_edge_cases", "run_count_streams",
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


def mixed_length_fastq(
    seed: int,
    short_reads: int = 1600,
    long_reads: int = 20,
    short_len=(36, 150),
    long_len=(2000, 8000),
    n_frac: float = 0.002,
) -> bytes:
    """A FASTQ of short reads (lengths uniform in ``short_len``) and long
    ones (``long_len``) in random order, so a length-bucketed stream meets
    several widths.  Bases are uniform ACGT with an N at ``n_frac`` of
    them.  Qualities (offset 33) are Phred 20-41, but for a low tail of
    each read (0-12% of its length, as sequencers' quality falls along a
    read) and 1% of the other bases, at Phred 2-19: about 7% of the
    bases in all."""
    rng = np.random.default_rng(seed)
    lengths = np.concatenate([
        rng.integers(short_len[0], short_len[1] + 1, short_reads),
        rng.integers(long_len[0], long_len[1] + 1, long_reads),
    ])
    rng.shuffle(lengths)
    total = int(lengths.sum())
    seq = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, total)]
    seq[rng.random(total) < n_frac] = ord("N")
    low = rng.random(total) < 0.01
    tails = (lengths * rng.random(lengths.size) * 0.12).astype(np.int64)
    ends = np.cumsum(lengths)
    for end, tail in zip(ends.tolist(), tails.tolist()):
        low[end - tail:end] = True
    qual = (33 + rng.integers(20, 42, total)).astype(np.uint8)
    qual[low] = 33 + rng.integers(2, 20, int(low.sum()))
    out = []
    start = 0
    for i, end in enumerate(ends.tolist()):
        out.append(b"@m%d\n%s\n+\n%s\n" % (
            i, seq[start:end].tobytes(), qual[start:end].tobytes()
        ))
        start = end
    return b"".join(out)


_I64_MIN, _I64_MAX = -(1 << 63), (1 << 63) - 1


def spectra_pair(rng: np.random.Generator, n_a: int, n_b: int, overlap: float):
    """Two sorted spectra of distinct int64 keys, ``overlap`` of B's keys
    also in A: numpy ``(ak, ac, bk, bc)``, counts in [1, 2^40)."""
    both = int(n_b * overlap)
    keys = np.unique(rng.integers(_I64_MIN, _I64_MAX,
                                  int((n_a + n_b - both) * 1.01), dtype=np.int64))
    keys = rng.permutation(keys)[: n_a + n_b - both]
    a = np.sort(keys[:n_a])
    b = np.sort(np.concatenate([a[rng.permutation(n_a)[:both]], keys[n_a:]]))
    return (a, rng.integers(1, 1 << 40, a.size), b,
            rng.integers(1, 1 << 40, b.size))


def merge_edge_cases(rng: np.random.Generator, tile: int = 2048):
    """``{name: (ak, ac, bk, bc)}``: empty, disjoint, identical,
    overlapping and single-key sides, the ends of the int64 range and of
    k=31's packed keys (``count._pack`` flips the sign bit), keys of a
    narrow (k <= 15) stream, and equal keys astride every edge of a merge
    that cuts its output into ``tile``-key tiles."""
    k31_top = ((1 << 62) - 1) - (1 << 63)  # 2^62 - 1, the sign bit flipped
    r = np.unique(rng.integers(_I64_MIN, _I64_MAX, 50_000, dtype=np.int64))
    even = np.arange(0, 20 * tile, 2, dtype=np.int64)
    sides = {
        "a empty": ([], r), "b empty": (r, []), "disjoint": (even, even + 1),
        "identical": (r, r), "overlapping": (r[:30_000], r[20_000:]),
        "single key": ([k31_top], [k31_top]),
        "k31 ends": ([_I64_MIN, k31_top], [_I64_MIN, k31_top - 1, k31_top]),
        "int64 ends": ([_I64_MIN, -1, 0, _I64_MAX],
                       [_I64_MIN, -2, 0, 1, _I64_MAX]),
        "narrow": (np.unique(rng.integers(0, 1 << 32, 30_000)),
                   np.unique(rng.integers(0, 1 << 32, 30_000))),
        "tile edges": (np.arange(0, 6 * tile, 2),
                       np.arange(tile // 2 - 1, 6 * tile)),
    }
    cases = {}
    for name, (a, b) in sides.items():
        a, b = np.asarray(a, np.int64), np.asarray(b, np.int64)
        cases[name] = (a, rng.integers(1, 1000, a.size), b,
                       rng.integers(1, 1000, b.size))
    return cases


def _runs_of(rng: np.random.Generator, lengths, wide: bool) -> np.ndarray:
    """Runs of the given lengths of distinct ascending packed keys, all
    below the sentinel."""
    lengths = np.asarray(lengths, np.int64)
    top = _I64_MAX - 1 if wide else 0xFFFFFFFE
    low = _I64_MIN if wide else 0
    pool = np.unique(rng.integers(low, top, 2 * lengths.size + 16,
                                  dtype=np.int64))
    keys = np.sort(rng.choice(pool, lengths.size, replace=False))
    return np.repeat(keys, lengths)


def run_count_streams(rng: np.random.Generator, wide: bool, tile: int = 1024):
    """``{name: keys}``: sorted int64 key streams as ``count._pack`` packs
    them (``wide``: the sentinel INT64_MAX, else 0xFFFFFFFF), for holding
    the run count against its plain version: empty, one lane, all
    sentinel, no sentinel, all keys distinct, one key over more than 2^20
    lanes, runs that end exactly on a ``tile``-lane edge and one lane past
    it, a sentinel run that starts mid-tile, and runs of 100-500 equal keys
    (a minimizer flush's) with half the lanes sentinel padding."""
    sentinel = _I64_MAX if wide else 0xFFFFFFFF

    def pad(keys, lanes):
        return np.concatenate([keys, np.full(lanes - keys.size, sentinel,
                                             np.int64)])

    # run ends on each tile edge, one lane past one, one lane before one
    cuts = [tile, 2 * tile + 1, 3 * tile, 3 * tile + 1, 4 * tile - 1,
            4 * tile, 5 * tile + 1, 6 * tile]
    edges = np.diff([0, *cuts])
    long_runs = rng.integers(100, 501, 20 * tile // 300)
    streams = {
        "empty": np.zeros(0, np.int64),
        "one lane": _runs_of(rng, [1], wide),
        "all sentinel": pad(np.zeros(0, np.int64), 3 * tile + 5),
        "no sentinel": _runs_of(rng, rng.integers(1, 40, 5 * tile // 20), wide),
        "all distinct": _runs_of(rng, np.ones(4 * tile + 7, np.int64), wide),
        "one key over 2^20 lanes": _runs_of(
            rng, [3, 1, (1 << 20) + 3, 2, 7], wide),
        "tile edges": pad(_runs_of(rng, edges, wide), 7 * tile),
        "tile edges, no padding": _runs_of(rng, edges, wide),
        "sentinel mid-tile": pad(
            _runs_of(rng, rng.integers(1, 9, 2 * tile // 5), wide),
            4 * tile + 3),
        "runs of 100-500, half padding": pad(
            _runs_of(rng, long_runs, wide), 2 * int(long_runs.sum())),
    }
    return streams
