#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``needletail_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. print the card (``nvidia-smi`` name and power limit), the torch and CUDA
   versions; fail unless the port's native framer builds and loads; build
   the CUDA kernels from ``needletail_tpu_torch/csrc`` and print the build
   time;
2. hold each kernel against its plain PyTorch version on the card, bit for
   bit (tolerance 0: the path is all integer): hash keys, key planes and
   hash-tally planes over k, ASCII (and for the first two packed) input,
   the three wire validity shapes (a validity plane at an odd byte
   offset) and read widths whose pitch is no multiple of 8 bytes; the
   histogram on uniform, skewed and mostly-invalid keys, on views that
   start off a 16-byte boundary and lengths that are no multiple of 4 or
   shorter than one step; slot compaction over wide and
   narrow sorted runs, random flags, an overflowing chunk and ragged
   lengths, at chunks of 32, 96, 128, 1024 and 2048 lanes, slots up to
   past the chunk, a stream shorter than a chunk and counts off a 16-byte
   boundary; the block sort at spans from 128 to 2^20 lanes on
   random, top-bit, all-equal, few-distinct, sorted and reversed keys,
   its input unchanged; the ASCII key planes also at every width a
   length-bucketed stream gives them (128 to 4096 and a dynamic 8064),
   over quality-masked reads, at k=21 and 31;
3. the hash path at full size: ``hash_count_file`` over the golden FASTQ
   written 256 times (64M bases) at batch 131072 x 128, through both of
   its kernels (launch counts read around this run), to the x256 goldens
   and 256 x the one-copy table of the plain path; then its bases/s (best
   of 2 after a warm-up), the metered stage table and a
   ``torch.profiler`` view of the device's time by kernel;
4. ``packed=False`` and an interrupted checkpoint/resume of the hash path
   at a smaller depth, equal to the per-copy results;
5. the exact path at full size: ``count_file`` over the same 64M bases at
   k=21 and k=31 (sparse arrays), through the key-plane and slot-compaction
   kernels with the cascade's first pass holding (launch counts and flush
   routes counted around each run), to 256 x the plain path's one-copy
   spectrum; then its bases/s (best of 2 after a warm-up), and at k=21
   the metered stage table and a ``torch.profiler`` view of the device's
   time by kernel and its busy share;
6. the exact path at a smaller depth: k=9 dense (the histogram kernel),
   k=11 densified, ``canonical=False``, ``packed=False``, ``28S.fasta`` at
   k=31 to its goldens, an interrupted ``count_sparse`` checkpoint/resume,
   and a mostly-distinct random stream that overflows the cascade;
7. the tally path: every ASCII batch of the 16-copy file through the
   hash-tally kernel and ``mxu_histogram16(idx, weight)`` to 16 x the
   one-copy table and goldens;
8. the genome path at full size: ``genome_spectrum`` over the 5 Mbp
   synthetic genome at k=31 (611 tiles of 8,192 bases, one block) to the
   JAX bench's goldens and checksums, its bases/s (best of 2 after a
   warm-up) and device profile; its arrays equal to the plain path's
   through the host-filter flush, that flush timed alone; k=7 dense and
   ``packed=False`` at a smaller depth;
9. multi-k at full width: ``multi_k_count_file`` over the 64M bases at
   k = 4, 21, 31 to 256 x the plain one-copy spectra, its bases/s, and an
   interrupted ``multik`` checkpoint and its resume at the 16-copy depth;
10. the quality path: ``count_file(k=21, quality_cutoff=20)`` and
   ``multi_k_count_file((4, 21, 31), quality_cutoff=20)`` over the 64M
   bases (ASCII with the quality plane; the key-plane kernel over the
   masked bytes, k=4 through the histogram) to 256 x the plain one-copy
   results, their bases/s and one metered run's stages; k=9 dense under
   quality (the histogram kernel) at the 16-copy depth;
11. the filter: ``quality_filter_file(min_mean_quality=30)`` over the 64M
   bases, 512,000 reads in, 256 x the one-copy kept count, the output's
   sha256 equal to that of 256 one-copy outputs, and its bases/s;
12. minimizers: ``minimizer_spectrum_file(k=21, w=11)`` over the 64M
   bases, packed and ASCII, through the key-plane kernel to 256 x the
   plain one-copy sketch, and the bases/s of each;
13. bucketed: ``count_file(k=31, bucketed=True, quality_cutoff=20)`` over
   a seeded mixed-length FASTQ (reads of 36-150 bp and 2-8 kbp) written
   256 times, equal to the flat run on the card and to 256 x the plain
   one-copy result, the widths it met and the bases/s of both;
14. the sharded paths (``needletail_tpu_torch.parallel``) on a NCCL world
   of one: ``sharded_hash_count_file``, ``sharded_count_file`` (k=21),
   ``sharded_multi_k_count_file`` (4, 21, 31) and the (11, 21) sketch
   over the 64M bases, ``genome_spectrum(mesh=)`` over the 5 Mbp genome
   (to its goldens and checksums), each equal to the flat driver's
   result on the card in this run and through its kernels (launch counts
   read around each run, and every kernel of the lane named in a
   ``torch.profiler`` view of one more run behind a warm-up step, with
   the NCCL collectives' device time; beside it a view without the
   warm-up step, which loses the first records); the hash and exact walls
   beside the flat ones (best of 2, alternating); the dryrun
   (``needletail_tpu_torch.dryrun``); ``hash-count --sharded`` and
   ``count --sharded`` through the command line, printing what the flat
   commands print;
15. compressed input: ``bgzip`` of the 64M-base file and ``stats`` over
   it through the command line (512,000 reads, 64M bases, 256 x the
   one-copy composition); ``hash_count_file`` over the BGZF file with
   default options (single-stream decode) and ``count_file(k=21,
   host_workers=4)`` (decode-to-spill, whose fallback to single-stream
   framing is an error here), each equal to the uncompressed run and
   through its kernels (launch counts and a ``torch.profiler`` view), with
   both walls (best of 2, alternating) and metered ``frame`` and ``wall``
   beside the uncompressed runs'; then the host surface's canonical
   ``bit_kmers`` spectrum of ``28S.fasta`` at k=31 equal to ``count_file``
   on the card;
16. the block-sort experiment (``needletail_tpu_torch.bench.exp_block_sort``):
   checked against the plain sort, then timed beside its plain version and
   ``torch.sort``; these are the block sort's times in the kernels line;
17. each other kernel's time beside its plain version's, its bound and,
   where one PyTorch call computes the same function, that call's, at the
   main paths' shapes (CUDA events around calls queued behind a spin, so
   the card's time and not the host's), the histogram also on one hot key
   and on 90% invalid keys, the compaction also on its second cascade
   pass, and the times of the flush's sort and of its whole run count
   (``unique_counts``: the sort, run heads and lengths);
18. stop every process the run started (the framing pool's resource
   tracker) and fail if a child is still alive; then a
   ``{"kernels": [...]}`` line (``launches_by_path`` counts each kernel's
   launches on every path above that runs it) and the last line
   ``{"ok": true, "device": {...}}``.

Exits non-zero without a result when CUDA is unavailable or the script
stands outside a checkout of the repository.
"""

from __future__ import annotations

import json
import math
import os
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
FQ = ROOT / "tests" / "data" / "PRJNA271013_head.fq"
FA_28S = ROOT / "tests" / "data" / "28S.fasta"

# per-copy goldens of PRJNA271013_head.fq at k=21
GOLD_BASES = 250_000
GOLD_TOTAL_K21 = 209_965
GOLD_FWD_K21 = 106_181
# 28S.fasta: bases, and canonical 31-mers in all and kept forward
GOLD_28S = (738_580, 718_007, 350_983)
GOLD_28S_DISTINCT = 283_237

K = 21
COUNT_KS = (21, 31)
COPIES = 256  # 64M bases, as the JAX package's e2e bench writes it
SMALL_COPIES = 16
BATCH = 131072
MAX_LEN = 128
SEED = 20261016
DISTINCT_READS = 16_384  # random 128-base reads: ~1.6M distinct 31-mers

HASH_KS = (1, 16, 17, 21, 31)
# width -> rows; ASCII pitches that are no multiple of 4 (150, 156) or of
# 16 (152), and rows wider than one 128-lane segment of the window kernel
ASCII_WIDTHS = {128: 512, 150: 512, 152: 512, 156: 512, 40_000: 16}
PACKED_WIDTHS = {128: 512, 152: 512, 40_000: 16}  # packed widths are x8
HIST_KEYS = BATCH * MAX_LEN  # 16.7M keys, one main-path batch
# compaction cases: (lanes, share of flagged lanes); 8192 lanes is the
# kernel's padding unit, and none of these is a multiple of it
COMPACT_CASES = ((100, 0.5), (1_000_003, 0.1), (3_000_001, 0.02))
# block sort checks: every power-of-two span from 128 to 2^20 lanes, so
# every span of the experiment, the tile edge (8,192 lanes fill one CTA;
# every larger span adds a merge pass over device memory) and spans of up
# to 7 merge passes
SORT_CHECK_BLOCKS = tuple(1 << b for b in range(7, 21))
SORT_CHECK_LANES = 1 << 21

# the genome path: bench.py's whole-bacterium k=31 spectrum and goldens
GENOME_BASES = 5_000_000
GENOME_K = 31
GENOME_TILE = 8192
GENOME_BATCH_TILES = 640  # 611 tiles: one block, 5,242,880 key lanes
GOLD_GENOME = (4_999_970, 4_999_970, 1_373_307_442, 100_106_330)
SMALL_GENOME_BASES = 400_000
MULTI_KS = (4, 21, 31)

# the quality, filter, minimizer and bucketed paths; per-copy goldens of
# PRJNA271013_head.fq from the JAX package's CLI on the CPU: Q20 masks
# 7.2% of its bases
QUALITY_CUTOFF = 20
GOLD_Q20_K21 = (146_651, 116_744)  # canonical 21-mers, distinct
FILTER_MIN_QUALITY = 30
GOLD_FILTER = (2_000, 1_732)  # reads in, reads kept
MINIMIZER_K, MINIMIZER_W = 21, 11  # minimap2's short-read preset (-x sr)
GOLD_MINIMIZERS = (28_606, 189_960)  # distinct minimizers, winning windows
BUCKET_K = 31
BUCKET_BATCH = 8192
MIXED_SEED = 7  # ~1,600 reads of 36-150 bp and ~20 of 2-8 kbp a copy
# the ASCII key-plane kernel at every width a bucketed stream gives it:
# the default buckets and a dynamic width (a multiple of 128, no power of 2)
BUCKET_WIDTHS = {128: 8192, 256: 4096, 512: 2048, 1024: 1024, 2048: 512,
                 4096: 256, 8064: 128}

# published H100 SXM peaks: HBM bytes/s, and
# operations/s outside the tensor cores (the float32 rate; every kernel
# here is integer work on the CUDA cores)
HBM_BYTES_PER_S = 3.35e12
CORE_OPS_PER_S = 67e12


def log(msg: str) -> None:
    print(msg, flush=True)


def bound_ms(nbytes: int, ops: int) -> tuple:
    """``(ms, "bytes" | "operations")``: the least time the card could take
    to move ``nbytes`` through device memory and do ``ops`` operations."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / CORE_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


class Errors:
    """Largest absolute difference seen per kernel (0 when bit-equal)."""

    def __init__(self) -> None:
        self.worst = {
            "hash_keys": 0, "histogram16": 0, "key_planes": 0,
            "compact_slots": 0, "hash_tally": 0, "block_sort": 0,
        }

    def hold(self, name: str, what: str, got, want) -> None:
        import torch

        got = torch.as_tensor(got).to(torch.int64)
        want = torch.as_tensor(want).to(got.device, torch.int64)
        if got.shape != want.shape:
            raise AssertionError(
                f"{name} {what}: shape {tuple(got.shape)} != "
                f"{tuple(want.shape)}"
            )
        err = int((got - want).abs().max()) if got.numel() else 0
        self.worst[name] = max(self.worst[name], err)
        if err != 0:
            raise AssertionError(f"{name} {what}: max abs error {err}")

    def hold_all(self, name: str, what: str, got, want, parts) -> None:
        for g, w, part in zip(got, want, parts):
            if g is None and w is None:
                continue
            self.hold(name, f"{what} {part}", g, w)


def check_window_kernels(errors: Errors, rng) -> int:
    """Hash keys, key planes and, over the ASCII cases, hash-tally planes
    (one CUDA source, three modes) over the same cases."""
    import torch

    from needletail_tpu_torch.device import kernels as K_
    from needletail_tpu_torch.device.ops import resolve_vbits, unwire
    from needletail_tpu_torch.utils.synth import (
        odd_offset_view, packed_batch, packed_rows, random_reads,
    )

    dev = torch.device("cuda")
    hash_parts = ("keys", "total", "fwd")
    plane_parts = ("hi", "lo", "total", "fwd")
    tally_parts = ("idx", "weight", "total", "fwd")
    cases = 0
    for width, rows in ASCII_WIDTHS.items():
        seqs, lengths = random_reads(rng, rows, width, dirty_frac=0.5)
        s = torch.from_numpy(seqs).to(dev)
        ln = torch.from_numpy(lengths).to(dev)
        for k in HASH_KS:
            for normalized in (True, False):
                what = f"ascii L={width} k={k} normalized={normalized}"
                errors.hold_all(
                    "hash_keys", what,
                    K_.canonical_hash_keys(s, ln, k, 16, normalized),
                    K_.canonical_hash_keys_plain(s, ln, k, 16, normalized),
                    hash_parts,
                )
                errors.hold_all(
                    "key_planes", what,
                    K_.canonical_key_planes(s, ln, k, normalized),
                    K_.canonical_key_planes_plain(s, ln, k, normalized),
                    plane_parts,
                )
                errors.hold_all(
                    "hash_tally", what,
                    K_.canonical_hash_tally(s, ln, k, 16, normalized),
                    K_.canonical_hash_tally_plain(s, ln, k, 16, normalized),
                    tally_parts,
                )
                cases += 1
    for width, rows in PACKED_WIDTHS.items():
        for vmode, dirty in ((0, 0.0), (1, 1.0), (2, 0.05)):
            seqs, lengths = random_reads(rng, rows, width, dirty_frac=dirty)
            batch = packed_batch(seqs, lengths, vmode)
            buf, layout = batch.wire_frame(rows)
            assert layout.vmode == vmode, (layout.vmode, vmode)
            wire = torch.from_numpy(buf).to(dev)
            codes, ln, vbits, vrow_idx, vrows = unwire(wire, layout)
            vb = resolve_vbits(vbits, vrow_idx, vrows, rows)
            if vb is not None:
                vb = odd_offset_view(vb)
            for k in HASH_KS:
                what = f"packed vmode={vmode} L={width} k={k}"
                errors.hold_all(
                    "hash_keys", what,
                    K_.canonical_hash_keys_packed(codes, vb, ln, k, 16),
                    K_.canonical_hash_keys_packed_plain(codes, vb, ln, k, 16),
                    hash_parts,
                )
                errors.hold_all(
                    "key_planes", what,
                    K_.canonical_key_planes_packed(codes, vb, ln, k),
                    K_.canonical_key_planes_packed_plain(codes, vb, ln, k),
                    plane_parts,
                )
                cases += 1
    # clean packed rows of 156 bases: a 39-byte pitch
    codes, _, lengths = packed_rows(rng, 512, 156)
    codes = torch.from_numpy(codes).to(dev)
    ln = torch.from_numpy(lengths).to(dev)
    for k in HASH_KS:
        what = f"packed clean L=156 k={k}"
        errors.hold_all(
            "hash_keys", what,
            K_.canonical_hash_keys_packed(codes, None, ln, k, 16),
            K_.canonical_hash_keys_packed_plain(codes, None, ln, k, 16),
            hash_parts,
        )
        errors.hold_all(
            "key_planes", what,
            K_.canonical_key_planes_packed(codes, None, ln, k),
            K_.canonical_key_planes_packed_plain(codes, None, ln, k),
            plane_parts,
        )
        cases += 1
    torch.cuda.synchronize()
    return cases


def check_bucket_widths(errors: Errors, rng) -> int:
    """The ASCII planes mode at every bucket width, k=21 and 31, over
    quality-masked reads: the input of the quality and bucketed paths."""
    import numpy as np
    import torch

    from needletail_tpu_torch.device import kernels as K_
    from needletail_tpu_torch.device.ops import quality_mask
    from needletail_tpu_torch.utils.synth import random_reads

    dev = torch.device("cuda")
    cases = 0
    for width, rows in BUCKET_WIDTHS.items():
        seqs, lengths = random_reads(rng, rows, width, dirty_frac=0.3)
        quals = rng.integers(33, 75, seqs.shape).astype(np.uint8)
        s = quality_mask(torch.from_numpy(seqs).to(dev),
                         torch.from_numpy(quals).to(dev),
                         33 + QUALITY_CUTOFF)
        ln = torch.from_numpy(lengths).to(dev)
        for k in (21, BUCKET_K):
            for normalized in (True, False):
                errors.hold_all(
                    "key_planes",
                    f"masked ascii L={width} k={k} normalized={normalized}",
                    K_.canonical_key_planes(s, ln, k, normalized),
                    K_.canonical_key_planes_plain(s, ln, k, normalized),
                    ("hi", "lo", "total", "fwd"),
                )
                cases += 1
    torch.cuda.synchronize()
    return cases


def hold_histogram(errors: Errors, what: str, keys, weight=None) -> None:
    from needletail_tpu_torch.device import kernels as K_

    errors.hold("histogram16", what, K_.mxu_histogram16(keys, weight),
                K_.histogram16_plain(keys, weight))


def check_histogram(errors: Errors, rng) -> int:
    import numpy as np
    import torch

    n = HIST_KEYS
    uniform = rng.integers(0, 1 << 16, n, dtype=np.int32)
    inputs = {
        "uniform": uniform,
        "skewed": np.full(n, 12345, np.int32),
        "mostly_invalid": np.where(rng.random(n) < 0.9, -1, uniform).astype(
            np.int32
        ),
        "wide": rng.integers(0, 1 << 31, n, dtype=np.int64).astype(np.int32),
    }
    for what, keys in inputs.items():
        t = torch.from_numpy(keys).to("cuda").view(BATCH, MAX_LEN)
        hold_histogram(errors, what, t)
    t = torch.from_numpy(uniform).to("cuda").view(BATCH, MAX_LEN)
    w = torch.from_numpy(rng.integers(-1, 2, n, dtype=np.int32)).to("cuda")
    hold_histogram(errors, "weighted", t, w.view(BATCH, MAX_LEN))
    # a head that is not 16-byte aligned, a tail short of four keys, and
    # inputs shorter than one cluster's first step (2 x 1024 x 16 keys)
    flat = torch.from_numpy(inputs["wide"]).to("cuda")
    cases = len(inputs) + 1
    for what, view in (
        ("offset 1", flat[1:]),
        ("offset 2, n % 4 == 1", flat[2:2 + 4 * 100_001 + 1]),
        ("offset 3, n % 4 == 3", flat[3:3 + 4 * 999 + 3]),
        ("n % 4 == 2", flat[:4 * 7777 + 2]),
        ("n = 3 at offset 1", flat[1:4]),
        ("n = 1", flat[5:6]),
        ("n = 33, 4 x 32 + 1", flat[:129]),
        ("one step less one key", flat[1:2 * 1024 * 16]),
    ):
        hold_histogram(errors, what, view)
        cases += 1
    torch.cuda.synchronize()
    return cases


def hold_compact(errors: Errors, what: str, hi, lo, counts, **shape) -> bool:
    """Slot compaction of one stream against its plain version (``shape``:
    ``chunk`` and ``slots``); returns the kernel's ``ok``."""
    from needletail_tpu_torch.device import kernels as K_

    got = K_.mxu_compact_slots(hi, lo, counts, **shape)
    errors.hold_all(
        "compact_slots", what, got,
        K_.compact_slots_plain(hi, lo, counts, **shape),
        ("hi", "lo", "counts", "ok"),
    )
    return bool(got[3])


def check_compact_slots(errors: Errors, rng) -> int:
    import numpy as np
    import torch

    from needletail_tpu_torch.device import count as C_

    dev = torch.device("cuda")
    cases = 0
    for n, share in COMPACT_CASES:
        hi = torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, n, dtype=np.int64)
                              .astype(np.int32)).to(dev)
        lo = torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, n, dtype=np.int64)
                              .astype(np.int32)).to(dev)
        flags = rng.random(n) < share
        counts = torch.from_numpy(
            np.where(flags, rng.integers(1, 1000, n), 0).astype(np.int32)
        ).to(dev)
        # sorted runs: unique_counts of a stream with repeats and sentinels
        keys = rng.integers(0, max(2, int(n * share)), n)
        s_hi = torch.from_numpy((keys >> 20).astype(np.int32)).to(dev)
        s_lo = torch.from_numpy((keys & 0xFFFFF).astype(np.int32)).to(dev)
        s_lo[torch.from_numpy(rng.random(n) < 0.1).to(dev)] = -1
        s_hi[s_lo == -1] = -1
        wide_runs = C_.unique_counts(s_hi, s_lo)
        narrow_runs = C_.unique_counts(None, s_lo)
        for what, args in (
            ("random flags wide", (hi, lo, counts)),
            ("random flags narrow", (None, lo, counts)),
            ("sorted runs wide", wide_runs),
            ("sorted runs narrow", narrow_runs),
        ):
            hold_compact(errors, f"{what} n={n}", *args)
            cases += 1
    # one chunk with more flags than slots: ok is False, and each slot
    # still holds the chunk's j-th flagged entry
    n = 20_000
    counts = np.where(rng.random(n) < 0.05, 1, 0).astype(np.int32)
    counts[3000:3300] = 7
    lo = torch.from_numpy(np.arange(n, dtype=np.int32)).to(dev)
    c = torch.from_numpy(counts).to(dev)
    for hi in (lo.flip(0).contiguous(), None):
        if hold_compact(errors, "overflowing chunk", hi, lo, c):
            raise AssertionError("compact_slots: overflow not reported")
        cases += 1
    # chunks off the 128-lane segments (32, 96) and of several 512-lane
    # tiles (2048), slots >= chunk, a stream shorter than one chunk, and
    # counts not 16-byte aligned: the scalar path and the carry
    n = 300_007
    base = rng.integers(-(1 << 31), 1 << 31, (3, n + 3), dtype=np.int64)
    base[2] = np.where(rng.random(n + 3) < 0.12, rng.integers(1, 50, n + 3), 0)
    hi, lo, counts = torch.from_numpy(base.astype(np.int32)).to(dev)
    for what, shape, m, off in (
        ("chunk 32 slots 8", dict(chunk=32, slots=8), n, 0),
        ("chunk 96 slots 16", dict(chunk=96, slots=16), n, 0),
        ("chunk 2048 slots 256", dict(chunk=2048, slots=256), n, 0),
        ("chunk 128 slots 128", dict(chunk=128, slots=128), n, 0),
        ("chunk 32 slots 40", dict(chunk=32, slots=40), n, 0),
        ("short stream", {}, 700, 0),
        ("short stream chunk 2048", dict(chunk=2048, slots=128), 1500, 0),
        ("counts at offset 1", {}, n, 1),
        ("counts at offset 3, chunk 2048", dict(chunk=2048, slots=256), n, 3),
    ):
        for h in (hi[off:off + m], None):
            ok = hold_compact(errors, what, h, lo[off:off + m],
                              counts[off:off + m], **shape)
            if what == "chunk 32 slots 8" and ok:
                raise AssertionError("compact_slots: overflow not reported")
            cases += 1
    torch.cuda.synchronize()
    return cases


def check_block_sort(errors: Errors, rng) -> int:
    """The block sort over every block size of ``SORT_CHECK_BLOCKS`` on
    random keys, keys with the top bit set, all-equal, sorted and reversed
    keys (the last two in unsigned order)."""
    import numpy as np
    import torch

    from needletail_tpu_torch.device import kernels as K_

    n = SORT_CHECK_LANES
    rand = rng.integers(0, 1 << 32, n, dtype=np.uint32)
    inputs = {
        "random": rand,
        "top bit set": rand | np.uint32(0x80000000),
        "all equal": np.full(n, 0x9E3779B1, np.uint32),
        "few distinct": rand % np.uint32(61) * np.uint32(0x04000001),
        "sorted": np.sort(rand),
        "reversed": np.sort(rand)[::-1].copy(),
    }
    cases = 0
    for what, keys in inputs.items():
        x = torch.from_numpy(keys.view(np.int32)).to("cuda")
        before = x.clone()
        for bl in SORT_CHECK_BLOCKS:
            errors.hold(
                "block_sort", f"{what} blocks={bl}",
                K_.bitonic_block_sort(x, bl), K_.block_sort_plain(x, bl),
            )
            cases += 1
        if not torch.equal(x, before):
            raise AssertionError(f"block_sort wrote its input ({what})")
    torch.cuda.synchronize()
    return cases


def main_path_batch(path: str):
    """The first batch the main paths frame, as device tensors: the packed
    planes and the ASCII planes at batch 131072 x 128."""
    import numpy as np
    import torch

    from needletail_tpu_torch.io.fast_batch import fast_read_batches
    from needletail_tpu_torch.device.ops import resolve_vbits, unwire

    packed = next(iter(fast_read_batches(
        path, batch_size=BATCH, max_len=MAX_LEN, packed=True,
    )))
    buf, layout = packed.wire_frame(BATCH)
    wire = torch.from_numpy(buf).to("cuda")
    codes, lengths, vbits, vrow_idx, vrows = unwire(wire, layout)
    vb = resolve_vbits(vbits, vrow_idx, vrows, BATCH)
    ascii_b = next(iter(fast_read_batches(
        path, batch_size=BATCH, max_len=MAX_LEN, with_quals=False,
    )))
    seqs = torch.from_numpy(np.ascontiguousarray(ascii_b.seqs)).to("cuda")
    ln = torch.from_numpy(ascii_b.lengths.astype(np.int32)).to("cuda")
    return (codes, vb, lengths), (seqs, ln)


def main_path_flush(path: str, k: int):
    """The exact path's flush over the whole file, as ``count_file`` builds
    it from the key-plane kernel: the sentinel-padded (hi, lo) planes."""
    import torch

    from needletail_tpu_torch.device import count as C_
    from needletail_tpu_torch.device import kernels as K_
    from needletail_tpu_torch.device.ops import resolve_vbits, unwire
    from needletail_tpu_torch.io.fast_batch import fast_read_batches

    parts = []
    for b in fast_read_batches(path, batch_size=BATCH, max_len=MAX_LEN,
                               packed=True):
        buf, layout = b.wire_frame(b.num_reads)
        codes, ln, vbits, vrow_idx, vrows = unwire(
            torch.from_numpy(buf).to("cuda"), layout
        )
        vb = resolve_vbits(vbits, vrow_idx, vrows, codes.shape[0])
        hi, lo, _, _ = K_.canonical_key_planes_packed(codes, vb, ln, k)
        w = hi.shape[1] - k + 1
        parts.append((hi[:, :w].reshape(-1), lo[:, :w].reshape(-1)))
    return C_._concat_pad_parts(parts, 1 << 20)


# per-lane operations of the functions, counted as the least work that
# computes them (a rolling window: two shift-ors, a compare and a select
# per strand update, a validity test, a store), not as the kernel's loop
WINDOW_OPS_PER_LANE = 8
HASH_OPS_PER_LANE = WINDOW_OPS_PER_LANE + 3  # two products and a xor
HIST_OPS_PER_KEY = 2  # a range test and an add
COMPACT_OPS_PER_LANE = 3  # a flag, a prefix step and a select


def time_kernels(errors: Errors, path: str) -> dict:
    """Kernel, plain and library times (ms) and bounds at the main paths'
    shapes."""
    import torch

    from needletail_tpu_torch.bench import cuda_ms
    from needletail_tpu_torch.device import count as C_
    from needletail_tpu_torch.device import kernels as K_

    out = {}
    (codes, vb, lengths), (seqs, ln) = main_path_batch(path)
    lanes = codes.shape[0] * codes.shape[1] * 4
    in_packed = nbytes(codes, vb, lengths)
    got = K_.canonical_hash_keys_packed(codes, vb, lengths, K, 16)
    want = K_.canonical_hash_keys_packed_plain(codes, vb, lengths, K, 16)
    errors.hold_all("hash_keys", "main-path batch", got, want,
                    ("keys", "total", "fwd"))
    keys = got[0]
    errors.hold(
        "histogram16", "main-path keys",
        K_.mxu_histogram16(keys), K_.histogram16_plain(keys),
    )
    out["hash_keys"] = {
        "ms": cuda_ms(
            lambda: K_.canonical_hash_keys_packed(codes, vb, lengths, K, 16), 20
        ),
        "plain_ms": cuda_ms(
            lambda: K_.canonical_hash_keys_packed_plain(
                codes, vb, lengths, K, 16
            ), 5, warmup=1,
        ),
        "ascii_ms": cuda_ms(
            lambda: K_.canonical_hash_keys(seqs, ln, K, 16), 20
        ),
        "ascii_plain_ms": cuda_ms(
            lambda: K_.canonical_hash_keys_plain(seqs, ln, K, 16), 5, warmup=1
        ),
        "library_ms": None,
        "bound": bound_ms(in_packed + nbytes(keys) + 16,
                          lanes * HASH_OPS_PER_LANE),
        "ascii_bound": bound_ms(nbytes(seqs, ln, keys) + 16,
                                lanes * HASH_OPS_PER_LANE),
        "shape": f"[{BATCH}, {MAX_LEN}] k={K} packed",
    }
    # bincount takes no negative keys: the yardstick counts key + 1 into
    # 65,537 bins, bin 0 collecting the invalid lanes
    shifted = (keys + 1).reshape(-1).to(torch.int64)
    # one hot key (every add to one bin), and 90% invalid keys
    skewed = torch.full_like(keys, 12345)
    invalid = torch.where(torch.rand(keys.shape, device=keys.device) < 0.9,
                          -1, keys)
    for what, t in (("skewed", skewed), ("invalid", invalid)):
        errors.hold("histogram16", f"timed {what} keys",
                    K_.mxu_histogram16(t), K_.histogram16_plain(t))
    out["histogram16"] = {
        "ms": cuda_ms(lambda: K_.mxu_histogram16(keys), 20),
        "skewed_ms": cuda_ms(lambda: K_.mxu_histogram16(skewed), 20),
        "invalid_ms": cuda_ms(lambda: K_.mxu_histogram16(invalid), 20),
        "plain_ms": cuda_ms(lambda: K_.histogram16_plain(keys), 5, warmup=1),
        "library_ms": cuda_ms(
            lambda: torch.bincount(shifted, minlength=(1 << 16) + 1), 20
        ),
        "library": "torch.bincount",
        "bound": bound_ms(nbytes(keys) + 4 * (1 << 16),
                          keys.numel() * HIST_OPS_PER_KEY),
        "shape": f"[{BATCH * MAX_LEN}] keys",
    }
    del keys, shifted, got, want, skewed, invalid

    got = K_.canonical_hash_tally(seqs, ln, K, 16)
    errors.hold_all(
        "hash_tally", "main-path batch", got,
        K_.canonical_hash_tally_plain(seqs, ln, K, 16),
        ("idx", "weight", "total", "fwd"),
    )
    out["hash_tally"] = {
        "ms": cuda_ms(lambda: K_.canonical_hash_tally(seqs, ln, K, 16), 20),
        "plain_ms": cuda_ms(
            lambda: K_.canonical_hash_tally_plain(seqs, ln, K, 16), 5,
            warmup=1,
        ),
        "library_ms": None,
        "bound": bound_ms(nbytes(seqs, ln, got[0], got[1]) + 16,
                          lanes * HASH_OPS_PER_LANE),
        "shape": f"[{BATCH}, {MAX_LEN}] k={K} ascii",
    }
    del got

    planes = {}
    for k in COUNT_KS:
        got = K_.canonical_key_planes_packed(codes, vb, lengths, k)
        errors.hold_all(
            "key_planes", f"main-path batch k={k}", got,
            K_.canonical_key_planes_packed_plain(codes, vb, lengths, k),
            ("hi", "lo", "total", "fwd"),
        )
        out_bytes = nbytes(got[0], got[1]) + 16
        planes[k] = {
            "ms": cuda_ms(
                lambda: K_.canonical_key_planes_packed(codes, vb, lengths, k),
                20,
            ),
            "plain_ms": cuda_ms(
                lambda: K_.canonical_key_planes_packed_plain(
                    codes, vb, lengths, k
                ), 5, warmup=1,
            ),
            "ascii_ms": cuda_ms(
                lambda: K_.canonical_key_planes(seqs, ln, k), 20
            ),
            "ascii_plain_ms": cuda_ms(
                lambda: K_.canonical_key_planes_plain(seqs, ln, k), 5,
                warmup=1,
            ),
            "bound": bound_ms(in_packed + out_bytes,
                              lanes * WINDOW_OPS_PER_LANE),
            "ascii_bound": bound_ms(nbytes(seqs, ln) + out_bytes,
                                    lanes * WINDOW_OPS_PER_LANE),
        }
        del got
    out["key_planes"] = dict(
        planes[K], library_ms=None, shape=f"[{BATCH}, {MAX_LEN}] k={K} packed",
        k31=planes[31],
    )
    del codes, vb, lengths, seqs, ln

    hi, lo = main_path_flush(path, K)
    flush_lanes = lo.numel()
    packed_keys = C_._pack(hi, lo)
    sort_ms = cuda_ms(lambda: torch.sort(packed_keys), 5, warmup=1)
    del packed_keys
    runs_ms = cuda_ms(lambda: C_.unique_counts(hi, lo), 5, warmup=1)
    runs = C_.unique_counts(hi, lo)
    del hi, lo
    if not hold_compact(errors, "main-path flush", *runs):
        raise AssertionError("compact_slots overflowed on the main-path flush")
    first = K_.mxu_compact_slots(*runs)
    # the cascade keeps the first pass's output where the second overflows
    second_ok = hold_compact(errors, "main-path second pass", *first[:3])
    second = K_.mxu_compact_slots(*first[:3])

    def compact_bound(hi, lo, counts, out):
        """The pass's bound: counts at every lane, hi/lo only at the
        flagged run heads (one 32-byte sector of each plane per 8 lanes
        that hold a head), the slots written once."""
        heads = (counts > 0).nonzero().reshape(-1)
        sectors = int(torch.unique(heads // 8).numel())
        head_bytes = sectors * 32 * (2 if hi is not None else 1)
        return bound_ms(nbytes(counts) + head_bytes + nbytes(*out[:3]) + 1,
                        lo.numel() * COMPACT_OPS_PER_LANE), heads, sectors

    bound, heads, sectors = compact_bound(*runs, first)
    second_bound = compact_bound(*first[:3], second)[0]
    out["compact_slots"] = {
        "ms": cuda_ms(lambda: K_.mxu_compact_slots(*runs), 20),
        "second_pass_ms": cuda_ms(
            lambda: K_.mxu_compact_slots(*first[:3]), 20
        ),
        "second_pass_lanes": first[1].numel(),
        "second_pass_ok": second_ok,
        "plain_ms": cuda_ms(
            lambda: K_.compact_slots_plain(*runs), 3, warmup=1
        ),
        "library_ms": None,
        "bound": bound,
        "second_pass_bound_ms": second_bound[0],
        "shape": f"[{flush_lanes}] lanes k={K}",
        "flush_sort_ms": sort_ms,
        "flush_runs_ms": runs_ms,
        "distinct": int(heads.numel()),
        "head_sectors": sectors,
    }
    return out


def sort_comparisons(lanes: int, block: int) -> int:
    """The least comparisons any comparison sort needs to order each
    ``block``-lane span of ``lanes`` keys: log2(block!) per span."""
    per_span = math.lgamma(block + 1) / math.log(2)
    return math.ceil(lanes // block * per_span)


def block_sort_times(errors: Errors, exp: dict) -> dict:
    """The block sort's entry from the experiment's own times: the kernel,
    ``block_sort_plain`` and ``torch.sort`` over rows of ``block_lanes`` at
    each block size, the first leading and every one under ``by_block``.
    The kernel is held against its plain version on the timed keys."""
    from needletail_tpu_torch.bench import exp_block_sort as E_
    from needletail_tpu_torch.device import kernels as K_

    x = E_.keys(exp["lanes"], exp["seed"])
    ms = exp["ms"]
    by_block = {}
    for bl in E_.BLOCKS:
        errors.hold("block_sort", f"timed keys blocks={bl}",
                    K_.bitonic_block_sort(x, bl), K_.block_sort_plain(x, bl))
        # each key read once and written once; the operations are the
        # fewest comparisons that sort the spans, not the network's own
        by_block[bl] = {
            "ms": ms[f"block_{bl}"],
            "plain_ms": ms[f"plain_{bl}"],
            "library_ms": ms[f"rows_{bl}"],
            "bound": bound_ms(2 * nbytes(x), sort_comparisons(x.numel(), bl)),
        }
    lead = by_block[E_.BLOCKS[0]]
    return dict(
        lead,
        library="torch.sort over rows of block_lanes",
        shape=f"[{x.numel()}] blocks={E_.BLOCKS[0]}",
        by_block={
            str(bl): {
                "ms": t["ms"], "plain_ms": t["plain_ms"],
                "library_ms": t["library_ms"], "bound_ms": t["bound"][0],
                "bound_by": t["bound"][1],
            }
            for bl, t in by_block.items()
        },
    )


class _Interrupt(Exception):
    pass


class _StopAfter:
    """A meter that stops the driver at its ``n``-th step, as a kill
    would; the checkpoint on disk then holds the batches before it."""

    def __init__(self, n: int) -> None:
        self.n = n
        self.steps = 0

    def add(self, name, seconds, nbytes=0, items=0) -> None:
        if name == "dispatch":
            self.steps += 1
            if self.steps == self.n:
                raise _Interrupt


def write_copies(path: Path, copies: int, src: Path = FQ) -> None:
    data = src.read_bytes()
    with open(path, "wb") as f:
        for _ in range(copies):
            f.write(data)


def write_distinct_reads(path: Path, rng) -> None:
    """Clean random 128-base reads as FASTA: nearly every 31-mer in them
    occurs once."""
    import numpy as np

    bases = np.frombuffer(b"ACGT", np.uint8)
    seqs = bases[rng.integers(0, 4, (DISTINCT_READS, MAX_LEN))]
    with open(path, "wb") as f:
        for i, row in enumerate(seqs):
            f.write(b">r%d\n" % i + row.tobytes() + b"\n")


def canonical_spectrum(seqs, k: int) -> tuple:
    """Sorted ``(keys uint64, counts int64)`` of the canonical 2-bit
    k-mers of byte strings, through the host surface: ``bitkmer.pack_kmers``
    and its reverse complement, the integer minimum of the two as
    ``bit_kmers(canonical_form=True)`` yields it, without a tuple a window."""
    import numpy as np

    from needletail_tpu_torch.bitkmer import _rc_values, pack_kmers

    parts = [np.empty(0, np.uint64)]
    for seq in seqs:
        values, valid = pack_kmers(seq, k)
        values = values[valid]
        parts.append(np.minimum(values, _rc_values(values, k)))
    keys, counts = np.unique(np.concatenate(parts), return_counts=True)
    return keys, counts.astype(np.int64)


def host_spectrum(path: Path, k: int) -> tuple:
    """:func:`canonical_spectrum` of every record of a FASTA/FASTQ file,
    parsed by the host surface (``parser.parse_fastx_file``)."""
    from needletail_tpu_torch.parser import parse_fastx_file

    reader = parse_fastx_file(path)
    seqs = []
    while (rec := reader.next()) is not None:
        seqs.append(rec.seq())
    return canonical_spectrum(seqs, k)


def expect(result, copies: int, table1, what: str) -> None:
    import numpy as np

    n_bases, total, fwd, table = result
    want = (GOLD_BASES * copies, GOLD_TOTAL_K21 * copies, GOLD_FWD_K21 * copies)
    if (n_bases, total, fwd) != want:
        raise AssertionError(f"{what}: {(n_bases, total, fwd)} != {want}")
    if table.dtype != np.int64 or not np.array_equal(table, table1 * copies):
        raise AssertionError(f"{what}: table != {copies} x the one-copy table")


def expect_spectrum(result, copies: int, ref, what: str) -> None:
    """``count_file`` output equal to ``copies`` x the one-copy ``ref``:
    the same keys, counts and bases scaled."""
    import numpy as np

    (n_bases, spec), (n1, spec1) = result, ref
    if n_bases != n1 * copies:
        raise AssertionError(f"{what}: {n_bases} bases != {copies} x {n1}")
    if isinstance(spec1, tuple):
        (keys, counts), (keys1, counts1) = spec, spec1
        if keys.dtype != np.uint64 or counts.dtype != np.int64:
            raise AssertionError(f"{what}: dtypes {keys.dtype}, {counts.dtype}")
        if not np.array_equal(keys, keys1):
            raise AssertionError(f"{what}: keys differ from the one-copy keys")
        if not np.array_equal(counts, counts1 * copies):
            raise AssertionError(f"{what}: counts != {copies} x one copy")
    elif spec.dtype != np.int64 or not np.array_equal(spec, spec1 * copies):
        raise AssertionError(f"{what}: table != {copies} x the one-copy table")


def child_processes() -> dict:
    """``{pid: command line}`` of this process's live children."""
    me = str(os.getpid())
    found = {}
    for entry in Path("/proc").iterdir():
        if not entry.name.isdigit():
            continue
        try:
            stat = (entry / "stat").read_text()
            cmd = (entry / "cmdline").read_bytes()
        except OSError:
            continue  # exited while we looked
        # the command name in parentheses may hold spaces: split after it
        fields = stat[stat.rindex(")") + 2:].split()
        if fields[1] == me and fields[0] != "Z":
            found[int(entry.name)] = cmd.replace(b"\0", b" ").decode().strip()
    return found


def stop_children() -> dict:
    """Stop what the run started: the framing workers (joined already on
    every normal path) and the ``multiprocessing`` resource tracker that
    the spawn context starts and would otherwise outlive this process by
    a moment.  Returns the children still alive afterwards."""
    import multiprocessing as mp
    from multiprocessing import resource_tracker

    for p in mp.active_children():
        p.terminate()
        p.join(10)
    stop = getattr(resource_tracker._resource_tracker, "_stop", None)
    if stop is not None:
        stop()
    return child_processes()


def run_exact_main_path(big: Path, card: str) -> dict:
    """Phase 5: ``count_file`` over 64M bases at each of ``COUNT_KS``;
    returns the launch counts, flushes and timings of each k, and at k=21
    the metered stages and the device profile of one more run."""
    from needletail_tpu_torch.utils.profiling import ThroughputMeter
    from needletail_tpu_torch.device import count as C_
    from needletail_tpu_torch.device import kernels as K_
    from needletail_tpu_torch.device.pipeline import count_file

    kw = dict(batch_size=BATCH, max_len=MAX_LEN, sparse_format="arrays")
    out = {}
    for k in COUNT_KS:
        ref = count_file(str(FQ), k, device="cpu", host_workers=1, **kw)
        if k == K and int(ref[1][1].sum()) != GOLD_TOTAL_K21:
            raise AssertionError(f"plain one-copy k={k}: {ref[1][1].sum()}")
        K_.reset_launches()
        C_.reset_flush_routes()
        t0 = time.perf_counter()
        result = count_file(str(big), k, device="cuda", **kw)
        first_s = time.perf_counter() - t0
        launches = dict(K_.LAUNCHES)
        flushes = {r: n for r, n in C_.FLUSH_ROUTES.items() if n}
        expect_spectrum(result, COPIES, ref, f"exact main path k={k}")
        total = int(result[1][1].sum())
        if k == K and total != GOLD_TOTAL_K21 * COPIES:
            raise AssertionError(f"exact main path k={k}: {total} k-mers")
        for name in ("key_planes", "compact_slots"):
            if launches[name] <= 0:
                raise AssertionError(f"exact main path k={k} launched no {name}")
        # one flush, its runs compacted by the cascade
        if flushes != {"cascade": 1}:
            raise AssertionError(f"exact main path k={k}: flushes {flushes}")
        log(f"exact main path k={k}: {result[0]} bases, {total} k-mers, "
            f"{len(result[1][0])} distinct; launches {launches}; flushes "
            f"{flushes}; first run {first_s:.3f} s")
        best = float("inf")
        for _ in range(2):
            t0 = time.perf_counter()
            again = count_file(str(big), k, device="cuda", **kw)
            best = min(best, time.perf_counter() - t0)
            expect_spectrum(again, COPIES, ref, f"timed exact path k={k}")
        log(f"exact e2e k={k}: best of 2 {best:.4f} s = "
            f"{result[0] / best:.6e} bases/s ({card})")
        out[k] = {
            "launches": launches, "flushes": flushes, "best_s": best,
            "bases_per_s": result[0] / best, "distinct": len(result[1][0]),
        }
        if k == K:
            meter = ThroughputMeter()
            expect_spectrum(count_file(str(big), k, device="cuda", meter=meter,
                                       **kw), COPIES, ref, "metered exact path")
            log(f"exact metered stages k={k}:\n" + meter.report())
            log("exact metered stages json: " + json.dumps(meter.as_dict()))
            prof = device_profile(
                lambda: count_file(str(big), k, device="cuda", **kw)
            )
            log(f"exact device profile k={k}: " + json.dumps(prof))
        del result, again, ref
    return out


# the port's own kernels (csrc/*.cu), by function name
PORT_KERNELS = (
    "window_kernel", "histogram16_kernel", "sum_partials_kernel",
    "compact_slots_kernel", "tile_kernel", "split_kernel", "merge_kernel",
)


# the function each wrapper's launch counter stands for
KERNEL_SYMBOL = {
    "hash_keys": "window_kernel", "key_planes": "window_kernel",
    "histogram16": "histogram16_kernel", "compact_slots": "compact_slots_kernel",
}


def device_time_by_name(events) -> dict:
    """``{name: [ms, calls]}`` from ``(name, device_us, calls)`` triples,
    summed over every triple of one full name, largest first."""
    by_name = {}
    for name, us, calls in events:
        if us > 0:
            ms_calls = by_name.setdefault(name, [0.0, 0])
            ms_calls[0] += us / 1e3
            ms_calls[1] += calls
    return dict(sorted(by_name.items(), key=lambda kv: -kv[1][0]))


# spin kernels the profile's warm-up step launches before recording
WARMUP_KERNELS = 256


def device_profile(fn, warmup: bool = True) -> dict:
    """Wall seconds of ``fn()`` under ``torch.profiler``, and the device
    time (ms) of its kernels and copies, in all and by name (largest
    first; names cut to 80 characters only in ``top_ms_calls``), with the
    port's own kernels listed apart (``port_ms_calls``) whatever their
    rank.  Streams that overlap count twice, so the busy share is an upper
    bound.

    The profile first takes a warm-up step of ``WARMUP_KERNELS`` spin
    kernels, whose records the profiler discards: late in a long process,
    a session that records from its start loses the device records of its
    first kernels (a sharded lane's first batches; ``warmup=False`` shows
    it)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    torch.cuda.synchronize()
    with profile(
        activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
        schedule=schedule(wait=0, warmup=int(warmup), active=1, repeat=1),
    ) as prof:
        if warmup:
            for _ in range(WARMUP_KERNELS):
                torch.cuda._sleep(100)
            torch.cuda.synchronize()
            prof.step()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        prof.step()
    events = []
    for evt in prof.key_averages():
        if "CUDA" not in str(evt.device_type):
            continue  # host events; their kernels are listed on their own
        if evt.key.startswith("ProfilerStep"):
            continue  # the step's span on the device's timeline, not work
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        events.append((evt.key, us, evt.count))
    by_name = device_time_by_name(events)
    busy_ms = sum(ms for ms, _ in by_name.values())
    return {
        "wall_s": wall,
        "device_ms": busy_ms,
        "busy_share": busy_ms / 1e3 / wall,
        "kernels": len(by_name),
        "top_ms_calls": [[name[:80], ms, n]
                         for name, (ms, n) in list(by_name.items())[:16]],
        "port_ms_calls": [
            [name[:80], ms, n] for name, (ms, n) in by_name.items()
            if any(f"::{k}" in name for k in PORT_KERNELS)
        ],
        # NCCL's collective kernels, on the sharded paths
        "nccl_ms": sum(ms for name, (ms, _) in by_name.items()
                       if "nccl" in name.lower()),
        "nccl_ms_calls": [[name[:80], ms, n] for name, (ms, n) in by_name.items()
                          if "nccl" in name.lower()],
    }


def run_exact_small(tmp: Path, small: Path, rng) -> None:
    """Phase 6: the exact path's other routes at a smaller depth."""
    import numpy as np
    import torch

    from needletail_tpu_torch.checkpoint import load_stream_checkpoint
    from needletail_tpu_torch.device import count as C_
    from needletail_tpu_torch.device import kernels as K_
    from needletail_tpu_torch.device.pipeline import count_file
    from needletail_tpu_torch.io.fast_batch import fast_read_batches

    kw = dict(batch_size=BATCH, max_len=MAX_LEN, sparse_format="arrays")
    one = lambda k, **o: count_file(  # noqa: E731
        str(FQ), k, device="cpu", host_workers=1, **{**kw, **o}
    )
    cases = (
        (9, {}, "k=9 dense"),
        (11, {}, "k=11 densified"),
        (21, {"canonical": False}, "canonical=False"),
        (21, {"packed": False}, "packed=False"),
    )
    for k, opts, what in cases:
        K_.reset_launches()
        C_.reset_flush_routes()
        got = count_file(str(small), k, device="cuda", **kw, **opts)
        launches = dict(K_.LAUNCHES)
        flushes = {r: n for r, n in C_.FLUSH_ROUTES.items() if n}
        expect_spectrum(got, SMALL_COPIES, one(k, **opts), what)
        if k == 9 and launches["histogram16"] <= 0:
            raise AssertionError("k=9 dense launched no histogram16")
        if opts.get("canonical", True) and k > 9 and launches["key_planes"] <= 0:
            raise AssertionError(f"{what} launched no key_planes")
        log(f"{what}: equal to {SMALL_COPIES} x the plain one-copy result; "
            f"launches {launches}; flushes {flushes}")

    # 28S at k=31, to the README goldens; the kernel's own tallies give
    # the forward count
    got = count_file(str(FA_28S), 31, device="cuda", host_workers=1,
                     sparse_format="arrays")
    want = count_file(str(FA_28S), 31, device="cpu", host_workers=1,
                      sparse_format="arrays")
    expect_spectrum(got, 1, want, "28S k=31")
    total = fwd = 0
    for b in fast_read_batches(str(FA_28S), batch_size=512):
        _, _, t, f = K_.canonical_key_planes(
            torch.from_numpy(np.ascontiguousarray(b.seqs)).to("cuda"),
            torch.from_numpy(b.lengths.astype(np.int32)).to("cuda"), 31,
        )
        total += int(t)
        fwd += int(f)
    if (got[0], int(got[1][1].sum()), total, fwd) != (
        GOLD_28S[0], GOLD_28S[1], GOLD_28S[1], GOLD_28S[2]
    ):
        raise AssertionError(f"28S k=31: {got[0]}, {got[1][1].sum()}, "
                             f"{total}, {fwd} != {GOLD_28S}")
    log(f"28S k=31: {got[0]} bases, {total} k-mers, {fwd} forward")

    # an interrupted count_sparse run and its resume
    ck = tmp / "count.npz"
    ckw = dict(batch_size=8192, max_len=MAX_LEN, sparse_format="arrays",
               device="cuda", host_workers=1)
    try:
        count_file(str(small), K, checkpoint_every=1, checkpoint_path=str(ck),
                   meter=_StopAfter(3), **ckw)
    except _Interrupt:
        pass
    else:
        raise AssertionError("the interrupted exact run ran to its end")
    saved = load_stream_checkpoint(ck)
    if saved["kind"] != "count_sparse" or not (
        0 < saved["file_offset"] < small.stat().st_size
    ):
        raise AssertionError(f"checkpoint {saved['kind']} at "
                             f"{saved['file_offset']}")
    expect_spectrum(
        count_file(str(small), K, resume_from=str(ck), **ckw),
        SMALL_COPIES, one(K), "resumed exact run",
    )
    log(f"count_sparse resume from byte {saved['file_offset']}: equal to "
        f"{SMALL_COPIES} x the one-copy spectrum")

    # a mostly-distinct stream overflows the cascade, and its sorted runs
    # are pulled whole and filtered on the host
    distinct = tmp / "distinct.fa"
    write_distinct_reads(distinct, rng)
    C_.reset_flush_routes()
    got = count_file(str(distinct), 31, device="cuda", host_workers=1,
                     sparse_format="arrays", max_len=MAX_LEN)
    flushes = {r: n for r, n in C_.FLUSH_ROUTES.items() if n}
    want = count_file(str(distinct), 31, device="cpu", host_workers=1,
                      sparse_format="arrays", max_len=MAX_LEN)
    expect_spectrum(got, 1, want, "mostly-distinct stream")
    if flushes != {"host_filter": 1}:
        raise AssertionError(f"mostly-distinct stream: flushes {flushes}")
    log(f"mostly-distinct stream: {len(got[1][0])} distinct of "
        f"{int(got[1][1].sum())} 31-mers; flushes {flushes}")


def run_tally_path(small: Path, table1) -> dict:
    """Phase 7: every ASCII batch of the 16-copy file through the
    hash-tally kernel, its ``(idx, weight)`` planes counted by
    ``mxu_histogram16(idx, weight)`` into an int64 table; returns the
    launch counts of the run."""
    import numpy as np
    import torch

    from needletail_tpu_torch.device import kernels as K_
    from needletail_tpu_torch.io.fast_batch import fast_read_batches

    K_.reset_launches()
    table = torch.zeros(1 << 16, dtype=torch.int64, device="cuda")
    tallies = torch.zeros(2, dtype=torch.int64, device="cuda")
    n_bases = 0
    for b in fast_read_batches(str(small), batch_size=BATCH, max_len=MAX_LEN,
                               with_quals=False):
        n_bases += b.num_bases
        seqs = torch.from_numpy(np.ascontiguousarray(b.seqs)).to("cuda")
        ln = torch.from_numpy(b.lengths.astype(np.int32)).to("cuda")
        idx, weight, total, fwd = K_.canonical_hash_tally(seqs, ln, K, 16)
        table += K_.mxu_histogram16(idx, weight)
        tallies += torch.stack([total, fwd])
    launches = dict(K_.LAUNCHES)
    total, fwd = tallies.tolist()
    expect((n_bases, total, fwd, table.cpu().numpy()), SMALL_COPIES, table1,
           "tally path")
    for name in ("hash_tally", "histogram16"):
        if launches[name] <= 0:
            raise AssertionError(f"tally path launched no {name}")
    log(f"tally path: {n_bases} bases, {total} windows, {fwd} forward, "
        f"table equal to {SMALL_COPIES} x the one-copy table; launches "
        f"{launches}")
    return launches


def genome_checksums(hi_s, lo_s, counts) -> tuple:
    """``bench.py``'s checksums of a device flush: distinct k-mers, their
    total, and the sums of ``lo * count`` and ``hi * count`` mod 2^32."""
    import torch

    c = counts.to(torch.int64)
    m = 0xFFFFFFFF
    out = torch.stack([
        (c > 0).sum(), c.sum(),
        ((lo_s.to(torch.int64) & m) * c).sum() & m,
        ((hi_s.to(torch.int64) & m) * c).sum() & m,
    ])
    return tuple(out.tolist())


def array_checksums(keys, counts) -> tuple:
    """:func:`genome_checksums` of ``(keys uint64, counts)`` arrays."""
    import numpy as np

    m = np.uint64(0xFFFFFFFF)
    c = counts.astype(np.uint64)  # the sums wrap mod 2^64, so mod 2^32 holds
    return (int((counts > 0).sum()), int(counts.sum()),
            int(((keys & m) * c).sum() & m),
            int(((keys >> np.uint64(32)) * c).sum() & m))


def equal_arrays(got, want, what: str) -> None:
    import numpy as np

    for g, w, part in zip(got, want, ("keys", "counts")):
        if g.dtype != w.dtype or not np.array_equal(g, w):
            raise AssertionError(f"{what}: {part} differ")


def run_genome_path(tmp: Path, card: str) -> dict:
    """Phase 8: ``genome_spectrum`` over the 5 Mbp synthetic genome at
    k=31 to ``bench.py``'s goldens; its arrays against the plain path's;
    the host-filter flush timed alone; k=7 dense and ``packed=False`` at a
    smaller depth."""
    import torch

    from needletail_tpu_torch.device import count as C_
    from needletail_tpu_torch.bench import cuda_ms
    from needletail_tpu_torch.device import kernels as K_
    from needletail_tpu_torch.device.tiling import (
        _TileStream,
        genome_spectrum,
        make_tile_key_fn,
    )
    from needletail_tpu_torch.utils.synth import synthetic_genome

    fa = tmp / "genome.fa"
    fa.write_bytes(synthetic_genome(GENOME_BASES, seed=31))
    kw = dict(tile_len=GENOME_TILE, batch_tiles=GENOME_BATCH_TILES)

    def device_run():
        n, flush = genome_spectrum(str(fa), GENOME_K, sparse_format="device",
                                   device="cuda", **kw)
        return n, flush[1].numel(), genome_checksums(*flush)

    K_.reset_launches()
    C_.reset_flush_routes()
    t0 = time.perf_counter()
    n, lanes, cks = device_run()
    first_s = time.perf_counter() - t0
    launches = dict(K_.LAUNCHES)
    if (n, cks) != (GENOME_BASES, GOLD_GENOME):
        raise AssertionError(f"genome path: {n} bases, checksums {cks} != "
                             f"{GOLD_GENOME}")
    if launches["key_planes"] <= 0:
        raise AssertionError("genome path launched no key_planes")
    log(f"genome path k={GENOME_K}: {n} bases, {lanes} key lanes, distinct "
        f"{cks[0]}, windows {cks[1]}, checksums {cks[2]} / {cks[3]}; "
        f"launches {launches}; first run {first_s:.3f} s")
    best = float("inf")
    for _ in range(2):
        t0 = time.perf_counter()
        again = device_run()
        best = min(best, time.perf_counter() - t0)
        if again[2] != GOLD_GENOME:
            raise AssertionError(f"timed genome path: checksums {again[2]}")
    log(f"genome e2e (device flush and checksums): best of 2 {best:.4f} s = "
        f"{GENOME_BASES / best:.6e} bases/s ({card})")
    prof = device_profile(device_run)
    log("genome device profile: " + json.dumps(prof))

    C_.reset_flush_routes()
    t0 = time.perf_counter()
    got = genome_spectrum(str(fa), GENOME_K, sparse_format="arrays",
                          device="cuda", **kw)
    arrays_s = time.perf_counter() - t0
    flushes = {r: c for r, c in C_.FLUSH_ROUTES.items() if c}
    want = genome_spectrum(str(fa), GENOME_K, sparse_format="arrays",
                           device="cpu", **kw)
    if got[0] != want[0]:
        raise AssertionError(f"genome arrays: {got[0]} != {want[0]} bases")
    equal_arrays(got[1], want[1], "genome arrays")
    if flushes != {"host_filter": 1}:
        raise AssertionError(f"genome arrays: flushes {flushes}")
    log(f"genome arrays: equal to the plain path's ({len(got[1][0])} "
        f"distinct); flushes {flushes}; {arrays_s:.4f} s ({card})")

    # the host-filter flush alone, on the key planes genome_spectrum holds
    keys_fn = make_tile_key_fn(GENOME_K, GENOME_TILE, packed=True,
                               device="cuda")
    parts = []
    for codes, vbits, lengths in _TileStream(
        str(fa), GENOME_K, GENOME_TILE, GENOME_BATCH_TILES, packed=True
    ):
        parts.append(keys_fn(
            torch.from_numpy(codes).to("cuda"),
            torch.from_numpy(lengths).to("cuda"),
            None if vbits is None else torch.from_numpy(vbits).to("cuda"),
        ))
    torch.cuda.synchronize()
    C_.reset_flush_routes()
    flush_s = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        C_.finalize_sparse(parts)  # ends in host arrays: synchronized
        flush_s = min(flush_s, time.perf_counter() - t0)
    if C_.FLUSH_ROUTES["host_filter"] != 3:
        raise AssertionError(f"flush routes {C_.FLUSH_ROUTES}")
    runs_ms = cuda_ms(
        lambda: C_.unique_counts(*C_._concat_pad_parts(parts, 1 << 20)), 3,
        warmup=1,
    )
    log(f"host_filter flush at {lanes} lanes: best of 3 {flush_s * 1e3:.4f} "
        f"ms, of which the device run count (concatenate, pad, sort, run "
        f"lengths) {runs_ms:.4f} ms ({card})")
    del parts

    small_fa = tmp / "genome_small.fa"
    small_fa.write_bytes(synthetic_genome(SMALL_GENOME_BASES, seed=7))
    small_kw = dict(tile_len=GENOME_TILE, batch_tiles=16)
    for k, opts, what, kernel in (
        (7, {}, "k=7 dense", "histogram16"),
        (GENOME_K, {"packed": False, "sparse_format": "arrays"},
         "packed=False", "key_planes"),
    ):
        K_.reset_launches()
        got = genome_spectrum(str(small_fa), k, device="cuda", **small_kw,
                              **opts)
        n_launch = K_.LAUNCHES[kernel]
        want = genome_spectrum(str(small_fa), k, device="cpu", **small_kw,
                               **opts)
        if got[0] != want[0] or got[0] != SMALL_GENOME_BASES:
            raise AssertionError(f"genome {what}: {got[0]} bases")
        if isinstance(want[1], tuple):
            equal_arrays(got[1], want[1], f"genome {what}")
        elif got[1].dtype != want[1].dtype or not (got[1] == want[1]).all():
            raise AssertionError(f"genome {what}: table differs")
        if n_launch <= 0:
            raise AssertionError(f"genome {what} launched no {kernel}")
        log(f"genome {what} ({SMALL_GENOME_BASES} bases): equal to the plain "
            f"path's; {kernel} launches {n_launch}")
    return {
        "launches": launches, "flushes": flushes, "lanes": lanes,
        "best_s": best, "bases_per_s": GENOME_BASES / best,
        "arrays_s": arrays_s, "host_filter_ms": flush_s * 1e3,
        "flush_runs_ms": runs_ms,
    }


def expect_multi(result, copies: int, ref, what: str) -> None:
    """``multi_k_count_file`` output equal to ``copies`` x the one-copy
    ``ref`` for every k."""
    (n_bases, spec), (n1, spec1) = result, ref
    if list(spec) != list(spec1):
        raise AssertionError(f"{what}: ks {list(spec)} != {list(spec1)}")
    for k in spec1:
        expect_spectrum((n_bases, spec[k]), copies, (n1, spec1[k]),
                        f"{what} k={k}")


def run_multi_k(big: Path, small: Path, tmp: Path, card: str) -> dict:
    """Phase 9: ``multi_k_count_file`` over 64M bases at k = 4, 21, 31 to
    256 x the plain path's one-copy spectra, its bases/s, and an
    interrupted ``multik`` checkpoint and its resume at the 16-copy
    depth."""
    from needletail_tpu_torch.checkpoint import load_stream_checkpoint
    from needletail_tpu_torch.device import count as C_
    from needletail_tpu_torch.device import kernels as K_
    from needletail_tpu_torch.device.pipeline import multi_k_count_file

    kw = dict(batch_size=BATCH, max_len=MAX_LEN, sparse_format="arrays")
    ref = multi_k_count_file(str(FQ), MULTI_KS, device="cpu", host_workers=1,
                             **kw)
    K_.reset_launches()
    C_.reset_flush_routes()
    t0 = time.perf_counter()
    got = multi_k_count_file(str(big), MULTI_KS, device="cuda", **kw)
    first_s = time.perf_counter() - t0
    launches = dict(K_.LAUNCHES)
    flushes = {r: c for r, c in C_.FLUSH_ROUTES.items() if c}
    expect_multi(got, COPIES, ref, "multi-k main path")
    for name in ("histogram16", "key_planes"):
        if launches[name] <= 0:
            raise AssertionError(f"multi-k main path launched no {name}")
    totals = {
        k: int((spec[1] if isinstance(spec, tuple) else spec).sum())
        for k, spec in got[1].items()
    }
    log(f"multi-k main path ks={MULTI_KS}: {got[0]} bases, k-mers by k "
        f"{totals}; launches {launches}; flushes {flushes}; first run "
        f"{first_s:.3f} s")
    best = float("inf")
    for _ in range(2):
        t0 = time.perf_counter()
        again = multi_k_count_file(str(big), MULTI_KS, device="cuda", **kw)
        best = min(best, time.perf_counter() - t0)
        expect_multi(again, COPIES, ref, "timed multi-k path")
    log(f"multi-k e2e: best of 2 {best:.4f} s = {got[0] / best:.6e} "
        f"bases/s ({card})")
    del got, again

    ck = tmp / "multik.npz"
    ckw = dict(batch_size=8192, max_len=MAX_LEN, sparse_format="arrays",
               device="cuda", host_workers=1)
    try:
        multi_k_count_file(str(small), MULTI_KS, checkpoint_every=1,
                           checkpoint_path=str(ck), meter=_StopAfter(3), **ckw)
    except _Interrupt:
        pass
    else:
        raise AssertionError("the interrupted multi-k run ran to its end")
    saved = load_stream_checkpoint(ck)
    ks = tuple(int(x) for x in saved["meta"]["ks"])
    if saved["kind"] != "multik" or ks != MULTI_KS or not (
        0 < saved["file_offset"] < small.stat().st_size
    ):
        raise AssertionError(f"multik checkpoint {saved['kind']} ks={ks} at "
                             f"{saved['file_offset']}")
    expect_multi(
        multi_k_count_file(str(small), MULTI_KS, resume_from=str(ck), **ckw),
        SMALL_COPIES, ref, "resumed multi-k run",
    )
    log(f"multik resume from byte {saved['file_offset']}: equal to "
        f"{SMALL_COPIES} x the one-copy spectra")
    return {"launches": launches, "flushes": flushes, "best_s": best,
            "bases_per_s": COPIES * GOLD_BASES / best}


def named_in(prof: dict, kernels) -> dict:
    """``{kernel: launches}`` that a :func:`device_profile` names of each
    wrapper's kernel."""
    return {
        kernel: sum(n for call, _, n in prof["port_ms_calls"]
                    if f"::{KERNEL_SYMBOL[kernel]}" in call)
        for kernel in kernels
    }


def run_cli(*argv) -> tuple:
    """``(stdout, '#' lines of stderr)`` of one port command, in process;
    fails unless it returns 0."""
    import contextlib
    import io

    from needletail_tpu_torch import cli

    stdout, stderr = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(stdout), contextlib.redirect_stderr(stderr):
        if cli.main(list(argv)) != 0:
            raise AssertionError(f"cli {argv} failed")
    return stdout.getvalue(), [
        line for line in stderr.getvalue().splitlines() if line.startswith("#")
    ]


def launched(what: str, launches: dict, *names) -> None:
    for name in names:
        if launches[name] <= 0:
            raise AssertionError(f"{what} launched no {name}")


def best_of_2(run, check) -> float:
    """Seconds of the faster of two more runs of ``run()``, each result
    held by ``check``."""
    best = float("inf")
    for _ in range(2):
        t0 = time.perf_counter()
        result = run()
        best = min(best, time.perf_counter() - t0)
        check(result)
    return best


def run_quality_path(big: Path, small: Path, card: str) -> dict:
    """Phase 10: ``count_file(k=21, quality_cutoff=20)`` and
    ``multi_k_count_file((4, 21, 31), quality_cutoff=20)`` over the 64M
    bases to 256 x the plain one-copy results (ASCII with the quality
    plane: the key-plane kernel over the masked bytes), their bases/s and
    the metered stages of one run; k=9 dense (the histogram kernel) at
    the 16-copy depth."""
    from needletail_tpu_torch.device import count as C_
    from needletail_tpu_torch.device import kernels as K_
    from needletail_tpu_torch.device.pipeline import (
        count_file, multi_k_count_file,
    )
    from needletail_tpu_torch.utils.profiling import ThroughputMeter

    kw = dict(batch_size=BATCH, max_len=MAX_LEN, sparse_format="arrays",
              quality_cutoff=QUALITY_CUTOFF)
    out = {"launches": {}}
    ref = count_file(str(FQ), K, device="cpu", host_workers=1, **kw)
    if (int(ref[1][1].sum()), len(ref[1][0])) != GOLD_Q20_K21:
        raise AssertionError(f"plain one-copy Q20 k={K}: "
                             f"{int(ref[1][1].sum())}, {len(ref[1][0])}")
    K_.reset_launches()
    C_.reset_flush_routes()
    got = count_file(str(big), K, device="cuda", **kw)
    launches = dict(K_.LAUNCHES)
    flushes = {r: n for r, n in C_.FLUSH_ROUTES.items() if n}
    expect_spectrum(got, COPIES, ref, "quality path k=21")
    launched("quality path k=21", launches, "key_planes", "compact_slots")
    out["launches"]["k21"] = launches
    log(f"quality path k={K} Q{QUALITY_CUTOFF}: {got[0]} bases, "
        f"{int(got[1][1].sum())} k-mers, {len(got[1][0])} distinct; "
        f"launches {launches}; flushes {flushes}")
    run = lambda: count_file(str(big), K, device="cuda", **kw)  # noqa: E731
    out["best_s"] = best_of_2(
        run, lambda r: expect_spectrum(r, COPIES, ref, "timed quality path"))
    out["bases_per_s"] = got[0] / out["best_s"]
    log(f"quality e2e k={K}: best of 2 {out['best_s']:.4f} s = "
        f"{out['bases_per_s']:.6e} bases/s ({card})")
    meter = ThroughputMeter()
    expect_spectrum(count_file(str(big), K, device="cuda", meter=meter, **kw),
                    COPIES, ref, "metered quality path")
    log("quality metered stages:\n" + meter.report())
    log("quality metered stages json: " + json.dumps(meter.as_dict()))
    del got

    one9 = count_file(str(FQ), 9, device="cpu", host_workers=1, **kw)
    K_.reset_launches()
    got = count_file(str(small), 9, device="cuda", **kw)
    launches = dict(K_.LAUNCHES)
    expect_spectrum(got, SMALL_COPIES, one9, "quality k=9 dense")
    launched("quality k=9 dense", launches, "histogram16")
    out["launches"]["k9"] = launches
    log(f"quality k=9 dense: equal to {SMALL_COPIES} x the plain one-copy "
        f"table; launches {launches}")

    ref = multi_k_count_file(str(FQ), MULTI_KS, device="cpu", host_workers=1,
                             **kw)
    K_.reset_launches()
    got = multi_k_count_file(str(big), MULTI_KS, device="cuda", **kw)
    launches = dict(K_.LAUNCHES)
    expect_multi(got, COPIES, ref, "multi-k quality path")
    launched("multi-k quality path", launches, "histogram16", "key_planes")
    out["launches"]["multi-k"] = launches
    run = lambda: multi_k_count_file(  # noqa: E731
        str(big), MULTI_KS, device="cuda", **kw)
    out["multi_k_best_s"] = best_of_2(
        run, lambda r: expect_multi(r, COPIES, ref, "timed multi-k quality"))
    out["multi_k_bases_per_s"] = got[0] / out["multi_k_best_s"]
    log(f"multi-k quality path ks={MULTI_KS}: equal to {COPIES} x the plain "
        f"one-copy spectra; launches {launches}; best of 2 "
        f"{out['multi_k_best_s']:.4f} s = {out['multi_k_bases_per_s']:.6e} "
        f"bases/s ({card})")
    return out


def run_filter_path(big: Path, tmp: Path, card: str) -> dict:
    """Phase 11: ``quality_filter_file(min_mean_quality=30)`` over the
    64M bases: 512,000 reads in, 256 x the one-copy kept count, and the
    output's sha256 that of 256 one-copy outputs end to end."""
    import hashlib

    from needletail_tpu_torch.device.pipeline import quality_filter_file

    one = tmp / "kept_x1.fq"
    if quality_filter_file(str(FQ), str(one), FILTER_MIN_QUALITY,
                           device="cpu") != GOLD_FILTER:
        raise AssertionError("plain one-copy filter missed its golden")
    want_sha = hashlib.sha256(one.read_bytes() * COPIES).hexdigest()
    want = (GOLD_FILTER[0] * COPIES, GOLD_FILTER[1] * COPIES)
    kept = tmp / "kept_x256.fq"

    def run():
        return quality_filter_file(str(big), str(kept), FILTER_MIN_QUALITY,
                                   device="cuda")

    def check(result):
        if result != want:
            raise AssertionError(f"filter: {result} != {want}")
        sha = hashlib.sha256(kept.read_bytes()).hexdigest()
        if sha != want_sha:
            raise AssertionError(f"filter output sha256 {sha} != {want_sha}")

    check(run())
    best = best_of_2(run, check)
    log(f"filter Q{FILTER_MIN_QUALITY}: {want[1]} of {want[0]} reads kept, "
        f"sha256 {want_sha} ({COPIES} one-copy outputs); best of 2 {best:.4f} s "
        f"= {COPIES * GOLD_BASES / best:.6e} bases/s ({card})")
    kept.unlink()
    return {"best_s": best, "bases_per_s": COPIES * GOLD_BASES / best}


def run_minimizer_path(big: Path, card: str) -> dict:
    """Phase 12: ``minimizer_spectrum_file(k=21, w=11)`` over the 64M
    bases, packed and ASCII, to 256 x the plain one-copy sketch, through
    the key-plane kernel; bases/s of each."""
    from needletail_tpu_torch.device import kernels as K_
    from needletail_tpu_torch.device.pipeline import minimizer_spectrum_file

    kw = dict(batch_size=BATCH, max_len=MAX_LEN)
    ref = minimizer_spectrum_file(str(FQ), MINIMIZER_K, MINIMIZER_W,
                                  device="cpu", host_workers=1, **kw)
    if (len(ref[1][0]), int(ref[1][1].sum())) != GOLD_MINIMIZERS:
        raise AssertionError(f"plain one-copy sketch: {len(ref[1][0])}, "
                             f"{int(ref[1][1].sum())}")
    out = {}
    for packed in (True, False):
        name = "packed" if packed else "ascii"

        def run():
            return minimizer_spectrum_file(str(big), MINIMIZER_K, MINIMIZER_W,
                                           packed=packed, device="cuda", **kw)

        def check(result):
            expect_spectrum(result, COPIES, ref, f"minimizers {name}")

        K_.reset_launches()
        check(run())
        launches = dict(K_.LAUNCHES)
        launched(f"minimizers {name}", launches, "key_planes")
        best = best_of_2(run, check)
        out[name] = {"launches": launches, "best_s": best,
                     "bases_per_s": COPIES * GOLD_BASES / best}
        log(f"minimizers ({MINIMIZER_W},{MINIMIZER_K}) {name}: equal to "
            f"{COPIES} x the one-copy sketch ({GOLD_MINIMIZERS[0]} distinct, "
            f"{GOLD_MINIMIZERS[1]} windows a copy); launches {launches}; best "
            f"of 2 {best:.4f} s = {COPIES * GOLD_BASES / best:.6e} bases/s "
            f"({card})")
    return out


def run_bucketed_path(tmp: Path, card: str) -> dict:
    """Phase 13: ``count_file(k=31, bucketed=True, quality_cutoff=20)``
    over a seeded mixed-length FASTQ written 256 times (~64M bases) equal
    to the flat run on the card and to 256 x the plain one-copy result;
    the widths it met, bases/s of both, and the metered stages of the
    first bucketed run and of the flat run."""
    from needletail_tpu_torch.device import count as C_
    from needletail_tpu_torch.device import kernels as K_
    from needletail_tpu_torch.device.pipeline import count_file
    from needletail_tpu_torch.io.bucketed import bucketed_read_batches
    from needletail_tpu_torch.utils.profiling import ThroughputMeter
    from needletail_tpu_torch.utils.synth import mixed_length_fastq

    one = tmp / "mixed_x1.fq"
    one.write_bytes(mixed_length_fastq(MIXED_SEED))
    big = tmp / "mixed_x256.fq"
    write_copies(big, COPIES, one)
    widths = sorted({b.max_len for b in bucketed_read_batches(
        str(big), batch_size=BUCKET_BATCH)})
    if not ({128, 256, 4096} <= set(widths) and widths[-1] > 4096):
        raise AssertionError(f"bucketed widths {widths}: 128, 256, 4096 and "
                             "a dynamic one expected")
    kw = dict(batch_size=BUCKET_BATCH, sparse_format="arrays",
              quality_cutoff=QUALITY_CUTOFF)
    ref = count_file(str(one), BUCKET_K, device="cpu", bucketed=True, **kw)
    flat_ref = count_file(str(one), BUCKET_K, device="cpu", host_workers=1,
                          **kw)
    expect_spectrum(flat_ref, 1, ref, "plain one-copy flat vs bucketed")

    def run(meter=None):
        return count_file(str(big), BUCKET_K, device="cuda", bucketed=True,
                          meter=meter, **kw)

    def check(result):
        expect_spectrum(result, COPIES, ref, "bucketed path")

    K_.reset_launches()
    C_.reset_flush_routes()
    meter = ThroughputMeter()
    got = run(meter)
    launches = dict(K_.LAUNCHES)
    check(got)
    launched("bucketed path", launches, "key_planes", "compact_slots")
    log(f"bucketed flushes {dict(C_.FLUSH_ROUTES)}; metered stages json: "
        + json.dumps(meter.as_dict()))
    best = best_of_2(run, check)
    K_.reset_launches()
    C_.reset_flush_routes()
    meter = ThroughputMeter()
    t0 = time.perf_counter()
    flat = count_file(str(big), BUCKET_K, device="cuda", meter=meter, **kw)
    flat_s = time.perf_counter() - t0
    expect_spectrum(flat, 1, got, "flat run on the card")
    log(f"flat run: launches {dict(K_.LAUNCHES)}; flushes "
        f"{dict(C_.FLUSH_ROUTES)}; metered stages json: "
        + json.dumps(meter.as_dict()))
    log(f"bucketed k={BUCKET_K} Q{QUALITY_CUTOFF}: {got[0]} bases, "
        f"{int(got[1][1].sum())} k-mers, {len(got[1][0])} distinct; widths "
        f"{widths}; launches {launches}; best of 2 {best:.4f} s = "
        f"{got[0] / best:.6e} bases/s; the flat run equal, {flat_s:.4f} s = "
        f"{got[0] / flat_s:.6e} bases/s ({card})")
    return {"launches": launches, "best_s": best,
            "bases_per_s": got[0] / best, "flat_s": flat_s, "widths": widths,
            "bases": got[0]}


def run_sharded_path(big: Path, small: Path, tmp: Path, card: str) -> dict:
    """Phase 16: the ``parallel`` drivers on a NCCL world of one, each
    held at tolerance 0 against the flat driver's result on the card in
    this run, with the launches of each path: the hash and exact (k=21)
    paths over the 64M bases (best of 2 each, alternating with the flat
    driver, and one profiled run each for the collectives' device time),
    multi-k (4, 21, 31), the (11, 21) sketch (ASCII, as the mesh path
    rides), the 5 Mbp genome at k=31 to its goldens, the dryrun, and
    ``hash-count --sharded`` and ``count --sharded`` through the command
    line, whose output equals the flat commands'."""
    import torch.distributed as dist

    from needletail_tpu_torch.device import kernels as K_
    from needletail_tpu_torch.device.pipeline import (
        count_file, hash_count_file, minimizer_spectrum_file,
        multi_k_count_file,
    )
    from needletail_tpu_torch.device.tiling import genome_spectrum
    from needletail_tpu_torch.dryrun import dryrun
    from needletail_tpu_torch.parallel import (
        make_mesh, sharded_count_file, sharded_hash_count_file,
        sharded_multi_k_count_file,
    )
    from needletail_tpu_torch.parallel.distributed import initialize, shutdown

    initialize(device="cuda")
    out = {"launches": {}, "walls": {}, "nccl": {}, "profiled": {}}
    try:
        mesh = make_mesh(data=1, table=1)
        log(f"sharded: backend {dist.get_backend()}, world "
            f"{dist.get_world_size()}, mesh {mesh}")
        lanes = dict(shard_lanes=1 << 26)
        exact_kw = dict(batch_size=BATCH, max_len=MAX_LEN)
        paths = {
            "hash": (
                lambda: hash_count_file(str(big), K, device="cuda",
                                        **exact_kw),
                lambda: sharded_hash_count_file(str(big), K, mesh,
                                                **exact_kw),
                ("hash_keys", "histogram16"),
            ),
            "exact k=21": (
                lambda: count_file(str(big), K, device="cuda",
                                   sparse_format="arrays", **exact_kw),
                lambda: sharded_count_file(str(big), K, mesh, **lanes,
                                           **exact_kw),
                ("key_planes", "compact_slots"),
            ),
            "multi-k": (
                lambda: multi_k_count_file(str(big), MULTI_KS, device="cuda",
                                           **exact_kw),
                lambda: sharded_multi_k_count_file(str(big), MULTI_KS, mesh,
                                                   **lanes, **exact_kw),
                ("histogram16", "key_planes", "compact_slots"),
            ),
            "minimizers": (
                lambda: minimizer_spectrum_file(
                    str(big), MINIMIZER_K, MINIMIZER_W, packed=False,
                    device="cuda", **exact_kw),
                lambda: minimizer_spectrum_file(
                    str(big), MINIMIZER_K, MINIMIZER_W, mesh=mesh,
                    **exact_kw),
                ("key_planes", "compact_slots"),
            ),
            "genome": (
                lambda: genome_spectrum(
                    str(tmp / "genome.fa"), GENOME_K, tile_len=GENOME_TILE,
                    batch_tiles=GENOME_BATCH_TILES, sparse_format="arrays",
                    device="cuda"),
                lambda: genome_spectrum(
                    str(tmp / "genome.fa"), GENOME_K, tile_len=GENOME_TILE,
                    batch_tiles=GENOME_BATCH_TILES, sparse_format="arrays",
                    mesh=mesh),
                ("key_planes", "compact_slots"),
            ),
        }
        for name, (flat, sharded, kernels) in paths.items():
            want = flat()
            K_.reset_launches()
            t0 = time.perf_counter()
            got = sharded()
            first_s = time.perf_counter() - t0
            launches = dict(K_.LAUNCHES)
            expect_same(got, want, f"sharded {name}")
            launched(f"sharded {name}", launches, *kernels)
            out["launches"][name] = launches
            del got, want
            # the profiler's view of one more run: the hand kernels it
            # names (beside the wrappers' counts of that run) and the
            # collectives' device time; and of a run profiled without the
            # warm-up step, which loses the first records
            named_cold = named_in(device_profile(sharded, warmup=False),
                                  kernels)
            K_.reset_launches()
            prof = device_profile(sharded)
            named = named_in(prof, kernels)
            counted = {kernel: K_.LAUNCHES[kernel] for kernel in kernels}
            out["nccl"][name] = {key: prof[key] for key in (
                "nccl_ms", "nccl_ms_calls", "device_ms", "wall_s")}
            out["profiled"][name] = {"named": named, "counted": counted,
                                     "named_without_warmup": named_cold}
            log(f"sharded {name}: equal to the flat driver's result; "
                f"launches {launches}; first run {first_s:.3f} s; the "
                f"profiled run's kernels: named {named}, counted {counted} "
                f"(without the warm-up step: named {named_cold}); device "
                f"profile {json.dumps(prof)}")
            missing = [kernel for kernel in kernels if not named[kernel]]
            if missing:
                raise AssertionError(f"sharded {name}: the profile names "
                                     f"no launch of {missing}")
        n, (keys, counts) = paths["genome"][1]()  # to the genome's goldens
        got = array_checksums(keys, counts)
        if (n, got) != (GENOME_BASES, GOLD_GENOME):
            raise AssertionError(f"sharded genome: {n} bases, checksums "
                                 f"{got} != {GOLD_GENOME}")
        log(f"sharded genome: {n} bases, distinct {got[0]}, windows "
            f"{got[1]}, checksums {got[2]} / {got[3]}")
        del keys, counts
        for name in ("hash", "exact k=21"):
            flat, sharded, _ = paths[name]
            walls = {"flat": float("inf"), "sharded": float("inf")}
            for side in ("flat", "sharded", "sharded", "flat"):
                fn = flat if side == "flat" else sharded
                t0 = time.perf_counter()
                fn()
                walls[side] = min(walls[side], time.perf_counter() - t0)
            out["walls"][name] = walls
            log(f"sharded {name} e2e: world of one best of 2 "
                f"{walls['sharded']:.4f} s, flat {walls['flat']:.4f} s "
                f"({card})")
        K_.reset_launches()
        log(dryrun())
        out["launches"]["dryrun"] = dict(K_.LAUNCHES)
    finally:
        shutdown()

    # the command line starts and ends its own world of one
    for argv in (("hash-count", str(small), "-k", str(K)),
                 ("count", str(FA_28S), "-k", "31", "--top", "3")):
        flat = run_cli(*argv, "--device", "cuda")
        K_.reset_launches()
        got = run_cli(*argv, "--device", "cuda", "--sharded")
        out["launches"][f"cli {argv[0]} --sharded"] = dict(K_.LAUNCHES)
        if got != flat:
            raise AssertionError(f"cli {argv[0]} --sharded: {got} != {flat}")
        log(f"cli {' '.join(argv[:1])} --sharded: the flat command's output "
            f"{got[0].strip()!r} {got[1]}; launches {dict(K_.LAUNCHES)}")
    return out


class _CountedSpill:
    """A ``spilled_input`` context that records the size of each file it
    decoded (an uncompressed input passes through, unrecorded)."""

    def __init__(self, inner, path, entered: list) -> None:
        self.inner, self.path, self.entered = inner, str(path), entered

    def __enter__(self):
        plain = self.inner.__enter__()
        if plain != self.path:
            self.entered.append(Path(plain).stat().st_size)
        return plain

    def __exit__(self, *exc):
        return self.inner.__exit__(*exc)


def run_compressed_path(big: Path, tmp: Path, table1, card: str) -> dict:
    """Phase 15: compressed input through the hand kernels.  ``bgzip`` the
    64M-base file and ``stats`` it through the command line; then
    ``hash_count_file`` over the BGZF file with default options (the
    single-stream route) and ``count_file(k=21, host_workers=4)`` (the
    decode-to-spill route), each equal to the uncompressed run, bin for
    bin and key for key, with the route that ran recorded and the spill's
    fallback to single-stream framing an error; their walls and metered
    ``frame`` beside the uncompressed runs' (best of 2, alternating), each
    kernel named in a device profile; and the host surface's canonical
    ``bit_kmers`` spectrum of ``28S.fasta`` at k=31 equal to
    ``count_file`` on the card."""
    import warnings

    import numpy as np

    from needletail_tpu_torch.device import kernels as K_
    from needletail_tpu_torch.device.pipeline import count_file, hash_count_file
    from needletail_tpu_torch.io import spill as spill_mod
    from needletail_tpu_torch.utils.profiling import ThroughputMeter

    out = {"launches": {}, "walls": {}, "metered_s": {}, "profiled": {}}
    bgz = tmp / "reads_x256.fq.bgz"
    t0 = time.perf_counter()
    _, said = run_cli("bgzip", str(big), "-o", str(bgz))
    out["bgzip_s"] = time.perf_counter() - t0
    if said != [f"# {big.stat().st_size} bytes -> {bgz}"]:
        raise AssertionError(f"bgzip said {said}")
    out["bytes"] = {"plain": big.stat().st_size, "bgzf": bgz.stat().st_size}
    log(f"bgzip: {out['bytes']['plain']} bytes -> {out['bytes']['bgzf']} "
        f"bytes of BGZF in {out['bgzip_s']:.4f} s ({card})")

    one = json.loads(run_cli("stats", str(FQ), "--composition")[0])
    t0 = time.perf_counter()
    stats = json.loads(run_cli("stats", str(bgz), "--composition")[0])
    out["stats_s"] = time.perf_counter() - t0
    want = {"reads": 2000 * COPIES, "bases": GOLD_BASES * COPIES,
            "composition": {b: n * COPIES
                            for b, n in one["composition"].items()}}
    got = {key: stats[key] for key in want}
    if got != want:
        raise AssertionError(f"stats over BGZF: {got} != {want}")
    log(f"stats over BGZF: {stats['reads']} reads, {stats['bases']} bases, "
        f"composition {stats['composition']} = {COPIES} x one copy; "
        f"{out['stats_s']:.4f} s ({card})")

    entered = []
    real_spill = spill_mod.spilled_input
    spill_mod.spilled_input = lambda path, *a, **kw: _CountedSpill(
        real_spill(path, *a, **kw), path, entered)
    kw = dict(sparse_format="arrays")
    lanes = {
        "hash": (lambda src, meter=None: hash_count_file(
            str(src), K, meter=meter), ("hash_keys", "histogram16"), 0),
        "exact k=21": (lambda src, meter=None: count_file(
            str(src), K, host_workers=4, spill_dir=str(tmp), meter=meter,
            **kw), ("key_planes", "compact_slots"), 1),
    }
    try:
        with warnings.catch_warnings():
            # the spill's fallback would run another route than named
            warnings.filterwarnings(
                "error", message="falling back to single-stream framing")
            for name, (lane, kernels, spills) in lanes.items():
                want = lane(big)
                del entered[:]
                K_.reset_launches()
                got = lane(bgz)
                launches = dict(K_.LAUNCHES)
                if len(entered) != spills:
                    raise AssertionError(f"bgzf {name}: {len(entered)} "
                                         f"spills, the route needs {spills}")
                expect_same(got, want, f"bgzf {name}")
                if name == "hash":
                    expect(got, COPIES, table1, "bgzf hash")
                launched(f"bgzf {name}", launches, *kernels)
                out["launches"][name] = launches
                walls = {"plain": float("inf"), "bgzf": float("inf")}
                for side in ("plain", "bgzf", "bgzf", "plain"):
                    t0 = time.perf_counter()
                    expect_same(lane(bgz if side == "bgzf" else big), want,
                                f"timed bgzf {name}")
                    walls[side] = min(walls[side], time.perf_counter() - t0)
                frame = {}
                for side, src in (("plain", big), ("bgzf", bgz)):
                    meter = ThroughputMeter()
                    expect_same(lane(src, meter), want, f"metered {name}")
                    frame[side] = meter.as_dict()
                K_.reset_launches()
                prof = device_profile(lambda: lane(bgz))
                named = named_in(prof, kernels)
                counted = {k: K_.LAUNCHES[k] for k in kernels}
                missing = [k for k in kernels if not named[k]]
                if missing:
                    raise AssertionError(f"bgzf {name}: the profile names "
                                         f"no launch of {missing}")
                out["walls"][name] = walls
                out["metered_s"][name] = {
                    side: {stage: stages.get(stage, {}).get("s")
                           for stage in ("frame", "wall")}
                    for side, stages in frame.items()}
                out["profiled"][name] = {"named": named, "counted": counted}
                log(f"bgzf {name}: equal to the uncompressed run; spilled "
                    f"{entered[:1]} bytes; launches {launches}; best of 2 "
                    f"{walls['bgzf']:.4f} s against {walls['plain']:.4f} s "
                    f"uncompressed ({card}); metered stages {json.dumps(frame)}; "
                    f"profile names {named}, counted {counted}; device "
                    f"profile {json.dumps(prof)}")
                del want, got
    finally:
        spill_mod.spilled_input = real_spill

    t0 = time.perf_counter()
    keys, counts = host_spectrum(FA_28S, 31)
    host_s = time.perf_counter() - t0
    K_.reset_launches()
    n, spec = count_file(str(FA_28S), 31, device="cuda", **kw)
    launched("28S on the card", dict(K_.LAUNCHES), "key_planes")
    expect_same(spec, (keys, counts), "host bit_kmers spectrum of 28S")
    if (n, int(counts.sum()), len(keys)) != (GOLD_28S[0], GOLD_28S[1],
                                             GOLD_28S_DISTINCT):
        raise AssertionError(f"28S k=31: {n}, {counts.sum()}, {len(keys)}")
    out["host_spectrum_s"] = host_s
    log(f"host surface: the canonical bit_kmers spectrum of 28S.fasta at "
        f"k=31 ({int(counts.sum())} windows, {len(keys)} distinct, "
        f"{host_s:.4f} s on the host) equals count_file on the card, key "
        f"for key ({card})")
    return out


def expect_same(got, want, what: str) -> None:
    """Equal driver results: ints, numpy arrays, (keys, counts) pairs and
    dicts of them, dtypes included."""
    import numpy as np

    if isinstance(want, dict):
        if list(got) != list(want):
            raise AssertionError(f"{what}: keys {list(got)} != {list(want)}")
        for key in want:
            expect_same(got[key], want[key], f"{what} [{key}]")
    elif isinstance(want, (tuple, list)):
        if len(got) != len(want):
            raise AssertionError(f"{what}: {len(got)} parts != {len(want)}")
        for i, (g, w) in enumerate(zip(got, want)):
            expect_same(g, w, f"{what} [{i}]")
    elif isinstance(want, np.ndarray):
        if got.dtype != want.dtype or not np.array_equal(got, want):
            raise AssertionError(f"{what}: arrays differ")
    elif got != want:
        raise AssertionError(f"{what}: {got} != {want}")


def kernel_entry(name, source, replaces, launches, worst, t) -> dict:
    ms, by = t["bound"]
    entry = {
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": launches,
        "max_abs_err": worst,
        "ms": t["ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": ms,
        "bound_by": by,
        "library_ms": t["library_ms"],
        "tolerance": 0,
        "shape": t["shape"],
    }
    for key in ("ascii_ms", "ascii_plain_ms", "library", "skewed_ms",
                "invalid_ms", "second_pass_ms", "second_pass_lanes",
                "second_pass_ok", "second_pass_bound_ms", "flush_sort_ms", "flush_runs_ms",
                "distinct", "head_sectors", "by_block"):
        if key in t:
            entry[key] = t[key]
    if "ascii_bound" in t:
        entry["ascii_bound_ms"] = t["ascii_bound"][0]
    if "k31" in t:
        k31 = t["k31"]
        entry["k31"] = {
            "ms": k31["ms"], "plain_ms": k31["plain_ms"],
            "ascii_ms": k31["ascii_ms"],
            "ascii_plain_ms": k31["ascii_plain_ms"],
            "bound_ms": k31["bound"][0],
        }
    return entry


def run() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this needs one GPU",
              file=sys.stderr)
        return 2
    if not (ROOT / "needletail_tpu_torch").is_dir() or not FQ.exists():
        print("chip_smoke: run it from a checkout of the repository",
              file=sys.stderr)
        return 2

    import numpy as np

    from needletail_tpu_torch.bench import card_line, exp_block_sort
    from needletail_tpu_torch.io import native
    from needletail_tpu_torch.utils.profiling import ThroughputMeter
    from needletail_tpu_torch.checkpoint import load_stream_checkpoint
    from needletail_tpu_torch.device import _build
    from needletail_tpu_torch.device import kernels as K_
    from needletail_tpu_torch.device.pipeline import hash_count_file

    # ---- 1. card, versions, build ------------------------------------
    card = card_line()
    log(card)
    log(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"cuda {torch.version.cuda}  device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    if not native.available():
        raise AssertionError(
            "the port's native framer did not build or load: framing would "
            "run in pure Python"
        )
    log(f"native framer: {native.get_lib()._name} "
        f"({time.perf_counter() - t0:.2f} s)")
    t0 = time.perf_counter()
    logs = _build.build_all()
    build_s = time.perf_counter() - t0
    log(f"build: {len(logs)} kernel source(s) compiled in {build_s:.2f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if any(w in line for w in ("registers", "Compiling entry",
                                       "stack frame")):
                log(f"  {name}: {line.strip()}")

    # ---- 2. each kernel against its plain version ---------------------
    rng = np.random.default_rng(SEED)
    errors = Errors()
    t0 = time.perf_counter()
    n_window = check_window_kernels(errors, rng)
    n_hist = check_histogram(errors, rng)
    n_compact = check_compact_slots(errors, rng)
    n_sort = check_block_sort(errors, rng)
    n_buckets = check_bucket_widths(errors, rng)
    log(f"kernel checks: hash_keys and key_planes {n_window} cases each "
        f"(hash_tally the ASCII ones), key_planes {n_buckets} more at the "
        f"bucket widths {list(BUCKET_WIDTHS)}, histogram16 {n_hist} cases, "
        f"compact_slots {n_compact} cases, block_sort {n_sort} cases equal "
        f"to the plain versions at tolerance 0 in "
        f"{time.perf_counter() - t0:.1f} s")

    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        tmp = Path(tmp)
        big = tmp / "reads_x256.fq"
        write_copies(big, COPIES)
        small = tmp / "reads_x16.fq"
        write_copies(small, SMALL_COPIES)
        n_bytes = big.stat().st_size

        # ---- 3. hash path at full size --------------------------------
        ref = hash_count_file(
            str(FQ), K, batch_size=BATCH, max_len=MAX_LEN, device="cpu",
            host_workers=1,
        )
        table1 = ref[3]
        expect(ref, 1, table1, "plain one-copy run")
        K_.reset_launches()
        t0 = time.perf_counter()
        result = hash_count_file(
            str(big), K, batch_size=BATCH, max_len=MAX_LEN, device="cuda"
        )
        first_s = time.perf_counter() - t0
        launches = dict(K_.LAUNCHES)
        expect(result, COPIES, table1, "main path")
        for name in ("hash_keys", "histogram16"):
            if launches[name] <= 0:
                raise AssertionError(f"main path launched no {name} kernel")
        log(f"main path: {result[0]} bases, {result[1]} windows, {result[2]} "
            f"forward; launches {launches}; first run {first_s:.3f} s")
        best = float("inf")
        for _ in range(2):
            t0 = time.perf_counter()
            again = hash_count_file(
                str(big), K, batch_size=BATCH, max_len=MAX_LEN, device="cuda"
            )
            best = min(best, time.perf_counter() - t0)
            expect(again, COPIES, table1, "timed main path")
        log(f"e2e: best of 2 {best:.3f} s = {result[0] / best:.6e} bases/s, "
            f"{n_bytes / best / 1e6:.1f} MB/s of file ({card})")
        meter = ThroughputMeter()
        expect(
            hash_count_file(
                str(big), K, batch_size=BATCH, max_len=MAX_LEN,
                device="cuda", meter=meter,
            ),
            COPIES, table1, "metered main path",
        )
        log("metered stages:\n" + meter.report())
        log("metered stages json: " + json.dumps(meter.as_dict()))
        prof = device_profile(lambda: expect(
            hash_count_file(str(big), K, batch_size=BATCH, max_len=MAX_LEN,
                            device="cuda"),
            COPIES, table1, "profiled main path",
        ))
        log("hash device profile: " + json.dumps(prof))

        # ---- 4. ASCII transport, checkpoint and resume ----------------
        expect(
            hash_count_file(
                str(small), K, batch_size=BATCH, max_len=MAX_LEN,
                device="cuda", packed=False,
            ),
            SMALL_COPIES, table1, "packed=False",
        )
        ck = tmp / "hash.npz"
        try:
            hash_count_file(
                str(small), K, batch_size=8192, max_len=MAX_LEN,
                device="cuda", host_workers=1, checkpoint_every=1,
                checkpoint_path=str(ck), meter=_StopAfter(3),
            )
        except _Interrupt:
            pass
        else:
            raise AssertionError("the interrupted run ran to its end")
        saved = load_stream_checkpoint(ck)
        if not 0 < saved["file_offset"] < small.stat().st_size:
            raise AssertionError(f"checkpoint offset {saved['file_offset']}")
        expect(
            hash_count_file(
                str(small), K, batch_size=8192, max_len=MAX_LEN,
                device="cuda", host_workers=1, resume_from=str(ck),
            ),
            SMALL_COPIES, table1, "resumed run",
        )
        log(f"packed=False and resume from byte {saved['file_offset']}: "
            "equal to the per-copy results")

        # ---- 5. the exact path at full size ----------------------------
        exact = run_exact_main_path(big, card)

        # ---- 6. the exact path's other routes --------------------------
        run_exact_small(tmp, small, rng)

        # ---- 7. the tally path -------------------------------------------
        tally_launches = run_tally_path(small, table1)

        # ---- 8. the genome path at full size ----------------------------
        genome = run_genome_path(tmp, card)

        # ---- 9. multi-k at full width -----------------------------------
        multi = run_multi_k(big, small, tmp, card)

        # ---- 10-13. quality, filter, minimizers, bucketed ---------------
        quality = run_quality_path(big, small, card)
        filtered = run_filter_path(big, tmp, card)
        minimizers = run_minimizer_path(big, card)
        bucketed = run_bucketed_path(tmp, card)

        # ---- 14. the sharded paths on a NCCL world of one ---------------
        sharded = run_sharded_path(big, small, tmp, card)

        # ---- 15. compressed input and the host surface ------------------
        compressed = run_compressed_path(big, tmp, table1, card)

        # ---- 16. the block-sort experiment ------------------------------
        K_.reset_launches()
        sort_exp = exp_block_sort.run(log=log)
        sort_launches = K_.LAUNCHES["block_sort"]
        if sort_launches <= 0:
            raise AssertionError("the block-sort experiment launched no sort")

        # ---- 17. kernel times at the main paths' shapes ----------------
        times = time_kernels(errors, str(big))
        times["block_sort"] = block_sort_times(errors, sort_exp)
        log("kernel times: " + json.dumps(times))

    # ---- 18. nothing this run started outlives it ---------------------
    running = child_processes()
    log(f"children before the stop: {running or 'none'}")
    left = stop_children()
    if left:
        raise AssertionError(f"processes still running after the stop: {left}")
    log("children after the stop: none")

    name, power = [s.strip() for s in card.split(",", 1)]
    pk = "needletail_tpu/device/pallas_kernels.py"
    kernels = [
        kernel_entry(
            "hash_keys", "needletail_tpu_torch/csrc/hash_keys.cu", f"{pk}:368",
            launches["hash_keys"], errors.worst["hash_keys"],
            times["hash_keys"],
        ),
        kernel_entry(
            "histogram16", "needletail_tpu_torch/csrc/histogram16.cu",
            f"{pk}:503", launches["histogram16"], errors.worst["histogram16"],
            times["histogram16"],
        ),
        kernel_entry(
            "key_planes", "needletail_tpu_torch/csrc/hash_keys.cu", f"{pk}:348",
            exact[K]["launches"]["key_planes"], errors.worst["key_planes"],
            times["key_planes"],
        ),
        kernel_entry(
            "compact_slots", "needletail_tpu_torch/csrc/compact_slots.cu",
            f"{pk}:672", exact[K]["launches"]["compact_slots"],
            errors.worst["compact_slots"], times["compact_slots"],
        ),
    ]
    kernels += [
        kernel_entry(
            "hash_tally", "needletail_tpu_torch/csrc/hash_keys.cu",
            f"{pk}:275", tally_launches["hash_tally"],
            errors.worst["hash_tally"], times["hash_tally"],
        ),
        kernel_entry(
            "block_sort", "needletail_tpu_torch/csrc/block_sort.cu",
            "benchmarks/exp_mosaic_sort.py:84", sort_launches,
            errors.worst["block_sort"], times["block_sort"],
        ),
    ]
    kernels[0]["also_replaces"] = f"{pk}:301"
    kernels[2]["also_replaces"] = f"{pk}:324"
    # launches on the other paths that run a kernel
    new_paths = {
        "quality k=21": quality["launches"]["k21"],
        "quality k=9 dense": quality["launches"]["k9"],
        "multi-k quality": quality["launches"]["multi-k"],
        "minimizers packed": minimizers["packed"]["launches"],
        "minimizers ascii": minimizers["ascii"]["launches"],
        "bucketed": bucketed["launches"],
    }
    kernels[1]["launches_by_path"] = {
        "hash": launches["histogram16"],
        "tally": tally_launches["histogram16"],
        "multi-k": multi["launches"]["histogram16"],
        **{p: n["histogram16"] for p, n in new_paths.items()
           if n["histogram16"]},
    }
    kernels[2]["launches_by_path"] = {
        "exact k=21": exact[K]["launches"]["key_planes"],
        "genome": genome["launches"]["key_planes"],
        "multi-k": multi["launches"]["key_planes"],
        **{p: n["key_planes"] for p, n in new_paths.items()
           if n["key_planes"]},
    }
    kernels[3]["launches_by_path"] = {
        "exact k=21": exact[K]["launches"]["compact_slots"],
        "genome": genome["launches"]["compact_slots"],
        "multi-k": multi["launches"]["compact_slots"],
        **{p: n["compact_slots"] for p, n in new_paths.items()
           if n["compact_slots"]},
    }
    kernels[0]["launches_by_path"] = {"hash": launches["hash_keys"]}
    for path, counts in [*sharded["launches"].items(), *(
            (f"bgzf {lane}", n) for lane, n in compressed["launches"].items())]:
        for entry in kernels:
            if counts.get(entry["name"], 0) > 0:
                entry.setdefault("launches_by_path", {})[
                    path if path.startswith(("cli", "dryrun", "bgzf"))
                    else f"sharded {path}"
                ] = counts[entry["name"]]
    for entry in kernels:
        entry["card"] = name
        entry["power_limit"] = power
    log("exact e2e: " + json.dumps({
        f"k{k}": {"bases_per_s": v["bases_per_s"], "best_s": v["best_s"],
                  "distinct": v["distinct"], "card": name,
                  "power_limit": power}
        for k, v in exact.items()
    }))
    log("genome and multi-k e2e: " + json.dumps({
        "genome": {key: genome[key] for key in (
            "bases_per_s", "best_s", "arrays_s", "host_filter_ms",
            "flush_runs_ms", "lanes", "flushes")},
        "multi_k": {key: multi[key] for key in ("bases_per_s", "best_s",
                                                "flushes")},
        "card": name, "power_limit": power,
    }))
    log("quality, filter, minimizer and bucketed e2e: " + json.dumps({
        "quality_k21": {"bases_per_s": quality["bases_per_s"],
                        "best_s": quality["best_s"]},
        "multi_k_quality": {"bases_per_s": quality["multi_k_bases_per_s"],
                            "best_s": quality["multi_k_best_s"]},
        "filter": filtered,
        "minimizers": {p: {key: v[key] for key in ("bases_per_s", "best_s")}
                       for p, v in minimizers.items()},
        "bucketed": {key: bucketed[key] for key in (
            "bases_per_s", "best_s", "flat_s", "widths", "bases")},
        "card": name, "power_limit": power,
    }))
    log("sharded e2e (NCCL world of one): " + json.dumps({
        "walls_s": sharded["walls"], "collectives": sharded["nccl"],
        "profiled_kernels": sharded["profiled"],
        "card": name, "power_limit": power,
    }))
    log("compressed e2e: " + json.dumps({
        key: compressed[key] for key in (
            "bytes", "bgzip_s", "stats_s", "walls", "metered_s",
            "host_spectrum_s")
    } | {"card": name, "power_limit": power}))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    try:
        rc = run()
    finally:
        # on a failed phase too: leave no process behind
        stop_children()
    sys.exit(rc)
