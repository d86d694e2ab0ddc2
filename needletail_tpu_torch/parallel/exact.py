"""Distributed EXACT k-mer spectra for any k <= 31 over a ``data`` mesh.

Counterpart of ``needletail_tpu/parallel/exact.py`` on
``torch.distributed``.  Every rank owns a disjoint read shard and buffers
its masked (hi, lo) key planes on its device (from the key-plane kernel,
``csrc/hash_keys.cu``, on the card, as the flat ``count_file`` takes
them); each buffer-full resolves on every rank at once with one sort and
run-length count (``_resolve``, with the slot-compaction cascade on the
card), each rank merges its sorted runs on the host, and ``finish``
gathers the ranks' spectra (lengths first, then the runs padded to the
longest) and merges them, so every rank returns the whole spectrum.

The ranks agree on when to flush: each ``add`` votes "my buffer would
overflow on this batch" (MAX) over a host group, so every rank flushes
on the same step.

Exactness: each window's key lives in exactly one rank's buffer, local
run counts are exact, and the merges sum duplicates, so the final (keys,
counts) equals the single-device spectrum bit for bit.
"""

from __future__ import annotations

import time as _time
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..device import count as _count
from .distributed import control_group, data_rank, to_device, vote
from .mesh import mesh_device, mesh_shape

__all__ = ["ShardedSpectrumAccumulator", "sharded_count_file"]

# default per-rank key-plane budget: 2^23 lanes * 8 B = 64 MiB a rank
DEFAULT_SHARD_LANES = 1 << 23

# a flush's planes pad to a multiple of this many lanes, as the flat
# accumulator's (``count.finalize_sparse``) do
_PAD_LANES = 1 << 20


def merge_resolved_shards(
    out,
    narrow: bool,
    device_compact: bool,
    keys0: np.ndarray,
    counts0: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray]:
    """Merge this rank's resolver output (``_resolve``: ``(lo, counts,
    n)`` narrow or ``(hi, lo, counts, n)``) into its running host
    spectrum.  With ``device_compact`` the distinct entries sit in a
    prefix of length ``n``, so only they cross to the host; otherwise the
    host compacts the whole sorted stream.  Shared by the per-k
    accumulator and the multi-k one."""
    if out is None:
        return keys0, counts0
    if narrow:
        hi = None
        lo, counts, n = out
    else:
        hi, lo, counts, n = out
    if device_compact:
        n = int(n)
        if n == 0:
            return keys0, counts0
        keys = _count._keys_u64(None if hi is None else hi[:n], lo[:n])
        cnts = counts[:n].cpu().numpy().astype(np.int64)
    else:
        keys, cnts = _count.compact_spectrum(hi, lo, counts)
    return _count.merge_sorted_spectra(keys0, counts0, keys, cnts)


def gather_spectra(
    keys: np.ndarray, counts: np.ndarray, group
) -> Tuple[np.ndarray, np.ndarray]:
    """Every rank's sorted ``(keys, counts)`` merged, on every rank of
    the host ``group``: the lengths are gathered first, then the runs
    padded to the longest."""
    n = dist.get_world_size(group)
    if n == 1:
        return keys, counts
    lens = [torch.zeros(1, dtype=torch.int64) for _ in range(n)]
    dist.all_gather(lens, torch.tensor([len(keys)], dtype=torch.int64), group=group)
    lens = [int(x) for x in lens]
    width = max(lens)
    mine = torch.zeros((2, width), dtype=torch.int64)
    mine[0, : len(keys)] = torch.from_numpy(keys.view(np.int64))
    mine[1, : len(keys)] = torch.from_numpy(counts)
    runs = [torch.empty_like(mine) for _ in range(n)]
    dist.all_gather(runs, mine, group=group)
    out_k, out_c = np.zeros(0, np.uint64), np.zeros(0, np.int64)
    for run, m in zip(runs, lens):
        run = run[:, :m].numpy()
        out_k, out_c = _count.merge_sorted_spectra(
            out_k, out_c, run[0].view(np.uint64), run[1]
        )
    return out_k, out_c


def _require_data_mesh(mesh) -> int:
    shape = mesh_shape(mesh)
    if "data" not in shape:
        raise ValueError("exact spectrum needs a mesh with a 'data' dim")
    if shape.get("table", 1) != 1:
        # a table dim would replicate the read shard across its columns
        # and double-count every key plane
        raise ValueError(
            "exact spectrum shards keys over 'data' only; use table=1 "
            f"(got table={shape['table']})"
        )
    return shape["data"]


class ShardedSpectrumAccumulator:
    """Streaming exact spectrum over a ``data`` mesh, one rank a shard.

    ``add(seqs, lengths)`` ingests this rank's rows of one step (every
    rank calls it once a step; ``add(None, None)`` where this rank has
    none); ``place`` cuts this rank's rows out of a global host batch.
    ``finish()`` returns ``(keys uint64, counts int64)`` of every rank,
    sorted by key, exact for any 1 <= k <= 31.
    """

    def __init__(
        self,
        mesh,
        k: int,
        canonical: bool = True,
        normalized: bool = True,
        shard_lanes: int = DEFAULT_SHARD_LANES,
        quality_cutoff: Optional[int] = None,
        phred_offset: int = 33,
        packed: bool = False,
        window_fn=None,
        window_lanes=None,
    ) -> None:
        """``window_fn(seqs, lengths) -> KmerWindows`` overrides the
        canonical k-mer extraction (e.g. (w, k) minimizer sketches) over
        ASCII rows; ``window_lanes(max_len) -> int`` must then give the
        lanes a read of that width yields."""
        if not 1 <= k <= 31:
            raise ValueError(f"k must be in [1, 31], got {k}")
        if packed and quality_cutoff is not None:
            raise ValueError("packed transport carries no quality planes")
        if window_fn is not None and packed:
            raise ValueError("window_fn extraction consumes ASCII planes")
        if (window_fn is None) != (window_lanes is None):
            raise ValueError("window_fn and window_lanes come together")
        from ..device.pipeline import _count_step_fns, _window_keys
        from ._resolve import make_sharded_resolver

        _require_data_mesh(mesh)
        self._mesh = mesh
        self._dev = mesh_device(mesh)
        self._control = control_group(mesh)
        self._cap = int(shard_lanes)
        self._packed = packed
        self._quality_cutoff = quality_cutoff
        self._qthresh = (
            None if quality_cutoff is None else phred_offset + quality_cutoff
        )
        self._lanes_per_read = window_lanes or (
            lambda max_len: max(max_len - k + 1, 0)
        )
        # k <= 15 keys fit one uint32 (2k <= 30 bits, below the sentinel):
        # buffer only the lo plane, and sort one key
        self._narrow = k <= 15
        on_cuda = self._dev.type == "cuda"
        if window_fn is None:
            self._keys_fn = _count_step_fns(
                k, packed, canonical, normalized, on_cuda
            )[1]
        else:
            self._keys_fn = lambda s, l, _vb: _window_keys(window_fn(s, l), k)
        self._parts = []
        self._lanes = 0
        self._keys = np.zeros(0, np.uint64)
        self._counts = np.zeros(0, np.int64)
        # compact on the card (bounds each flush's pull to its distinct
        # entries); on the CPU the pull is a local copy
        self._device_compact = on_cuda
        self._resolve = make_sharded_resolver(
            mesh, on_cuda, cascade=on_cuda, narrow=self._narrow
        )

    def place(self, seqs, lengths, quals=None):
        """This rank's rows of a global host batch, on its device."""
        from .sharded import _place_rows

        return _place_rows(self._mesh, ("data",), seqs, lengths, quals)

    def lanes_for(self, batch_rows: int, max_len: int) -> int:
        """Key lanes one (batch_rows, max_len) batch of this rank
        produces."""
        return batch_rows * self._lanes_per_read(max_len)

    def add(self, seqs, lengths, quals=None, vbits=None) -> None:
        """Ingest this rank's rows of one step.  In packed mode ``seqs``
        is the ``[B, L/4]`` code plane and ``vbits`` the optional validity
        plane (None = clean).  ``seqs=None`` adds nothing and still joins
        the step's flush vote."""
        lanes = 0
        if seqs is not None:
            b, l = seqs.shape
            lanes = self.lanes_for(b, l * 4 if self._packed else l)
            if self._quality_cutoff is not None and quals is None:
                raise ValueError("quality_cutoff needs FASTQ qualities")
        flush, too_big = vote(
            [self._lanes + lanes > self._cap, lanes > self._cap], self._control
        )
        if too_big:
            raise ValueError(
                f"one batch produces more lanes than the buffer "
                f"({self._cap}) on some rank; raise shard_lanes or shrink "
                "the batch"
            )
        if flush:
            self._flush()
        if lanes == 0:
            return
        dev = self._dev
        seqs, lengths = to_device(seqs, dev), to_device(lengths, dev)
        if self._qthresh is not None:
            from ..device.ops import quality_mask

            seqs = quality_mask(seqs, to_device(quals, dev), self._qthresh)
        if vbits is not None:
            vbits = to_device(vbits, dev)
        hi, lo = self._keys_fn(seqs, lengths, vbits)
        self._parts.append((None if self._narrow else hi, lo))
        self._lanes += lo.numel()

    def _flush(self) -> None:
        """Resolve every rank's buffer (a collective on the card)."""
        if self._parts:
            hi, lo = _count._concat_pad_parts(self._parts, _PAD_LANES)
            bufs = (lo,) if self._narrow else (hi, lo)
        else:
            bufs = (None,) if self._narrow else (None, None)
        out = self._resolve(*bufs)
        self._keys, self._counts = merge_resolved_shards(
            out, self._narrow, self._device_compact, self._keys, self._counts
        )
        self._parts = []
        self._lanes = 0

    def finish(self) -> Tuple[np.ndarray, np.ndarray]:
        """``(keys uint64, counts int64)`` of every rank, keys ascending,
        on every rank.  The accumulator stays live (checkpoint
        snapshots)."""
        self._flush()
        return gather_spectra(self._keys, self._counts, self._control)

    def restore(self, keys: np.ndarray, counts: np.ndarray) -> None:
        """Re-seed the merged spectrum (checkpoint resume; fresh only).
        Rank 0 of the data dim holds it, so ``finish`` counts it once."""
        if self._parts or self._keys.size:
            raise ValueError("restore() only applies to a fresh accumulator")
        if data_rank(self._mesh)[1] == 0:
            self._keys = np.asarray(keys, dtype=np.uint64)
            self._counts = np.asarray(counts, dtype=np.int64)


def sharded_count_file(
    path,
    k: int,
    mesh,
    batch_size: int = 4096,
    max_len: Optional[int] = None,
    canonical: bool = True,
    normalized: bool = True,
    shard_lanes: int = DEFAULT_SHARD_LANES,
    host_workers: Optional[int] = None,
    spill_dir: Optional[str] = None,
    quality_cutoff: Optional[int] = None,
    phred_offset: int = 33,
    packed: Optional[bool] = None,
    checkpoint_every: Optional[int] = None,
    checkpoint_path: Optional[str] = None,
    resume_from: Optional[str] = None,
    bucketed: bool = False,
    meter=None,
    double_buffer: bool = True,
) -> Tuple[int, Tuple[np.ndarray, np.ndarray]]:
    """Exact ``(keys uint64, counts int64)`` spectrum of a FASTX file over
    a data mesh: ``(n_bases, (keys, counts))`` on every rank, keys
    ascending, equal to ``pipeline.count_file``'s sparse arrays.

    Each rank frames its own input as ``sharded_hash_count_file`` says,
    in batches of ``batch_size / data`` rows.  ``packed=None`` ships the
    2-bit wire unless ``quality_cutoff`` (bases below it masked on the
    device) or ``bucketed`` (reads grouped by length) need ASCII, and
    either with ``packed=True`` raises ``ValueError``.  Checkpoints (a
    world of one) are the flat ``count_file``'s ``count_sparse`` files,
    which either driver resumes.  ``meter=`` records the stages of
    ``sharded_hash_count_file``; ``drain`` is the last flush and the
    gather.
    """
    from ..checkpoint import (
        counting_meta, prepare_checkpoint_stream, save_stream_checkpoint,
    )
    from .distributed import refuse_world_above_one

    quality = quality_cutoff is not None
    if packed is None:
        packed = not (quality or bucketed)
    elif packed and quality:
        raise ValueError("packed transport carries no quality planes")
    elif packed and bucketed:
        raise ValueError(
            "bucketed framing is ASCII-shaped; drop packed=True or bucketed"
        )
    n_data = _require_data_mesh(mesh)
    refuse_world_above_one(
        "sharded_count_file", mesh, path, checkpoint_every, checkpoint_path,
        resume_from,
    )
    acc = ShardedSpectrumAccumulator(
        mesh, k, canonical=canonical, normalized=normalized,
        shard_lanes=shard_lanes, quality_cutoff=quality_cutoff,
        phred_offset=phred_offset, packed=packed,
    )
    sem = counting_meta(
        canonical=canonical, normalized=normalized,
        quality_cutoff=quality_cutoff, phred_offset=phred_offset,
    )
    ckpt_mode, ck = prepare_checkpoint_stream(
        "count_sparse", k,
        checkpoint_every=checkpoint_every, checkpoint_path=checkpoint_path,
        resume_from=resume_from, host_workers=host_workers, bucketed=bucketed,
        canonical=canonical, normalized=normalized,
        quality_cutoff=quality_cutoff, phred_offset=phred_offset,
    )
    n_bases = start_offset = 0
    if ck is not None:
        start_offset, n_bases = ck["file_offset"], ck["n_bases"]
        acc.restore(ck["arrays"]["keys"], ck["arrays"]["counts"])

    def _save_ckpt(offset, n_bases_now):
        # a snapshot is a flush (one sort a rank) plus the merged spectrum
        keys, counts = acc.finish()
        save_stream_checkpoint(
            checkpoint_path, "count_sparse", k, offset, n_bases_now,
            {"keys": keys, "counts": counts}, input_path=str(path), meta=sem,
        )

    t_wall0 = _time.perf_counter()
    n_bases = _stream_into(
        acc, mesh, path, k, -(-batch_size // n_data), max_len, host_workers,
        spill_dir, packed, normalized, quality, bucketed, ckpt_mode,
        start_offset, checkpoint_every, _save_ckpt, meter, double_buffer,
        n_bases,
    )
    t_drain = _time.perf_counter()
    out = acc.finish()
    if meter is not None:
        now = _time.perf_counter()
        meter.add("drain", now - t_drain, items=len(out[0]))
        meter.add("wall", now - t_wall0, items=n_bases)
    return n_bases, out


def _stream_into(
    acc, mesh, path, min_len, rank_rows, max_len, host_workers, spill_dir,
    packed, normalized, quality, bucketed, ckpt_mode, start_offset,
    checkpoint_every, save_checkpoint, meter, double_buffer, n_bases,
) -> int:
    """Frame this rank's input and ``acc.add`` each batch in lockstep
    (the packed wire unwired; ASCII with its quality plane where
    ``quality``); returns the bases of every rank."""
    from ..device.pipeline import _device_args, _place_fn, _uploader
    from .distributed import rank_batch_source, run_rank_stream

    def fold(payload, layout):
        if payload is None:
            acc.add(None, None)
        elif layout is None:
            acc.add(*payload)  # seqs, lengths, quals | None
        else:
            codes, lengths, vbits = _device_args(payload, layout)
            acc.add(codes, lengths, vbits=vbits)

    batches = rank_batch_source(
        path, mesh, rank_rows, max_len, host_workers, spill_dir, packed,
        normalized, ckpt_mode, start_offset, checkpoint_every,
        with_quals=quality, bucketed=bucketed,
    )
    return run_rank_stream(
        mesh, batches,
        _place_fn(_uploader(mesh_device(mesh)), min_len, packed, quality),
        fold, packed=packed, meter=meter, double_buffer=double_buffer,
        checkpoint_every=checkpoint_every, save_checkpoint=save_checkpoint,
        ship_quals=quality, n_bases=n_bases,
    )
