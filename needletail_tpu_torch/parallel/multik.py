"""Multi-k canonical counting over a data mesh in one step a batch.

Counterpart of ``needletail_tpu/parallel/multik.py`` on
``torch.distributed``.  Each rank, for each batch of its own:

  * unpacks (or quality-masks) its rows once, shared by every k;
  * for each dense k <= 9 histograms its windows into a local ``[4^k]``
    table (``count.dense_spectrum``: the histogram kernel on the card) and
    reduce-scatters it over ``data`` (rank d owns the bins ``[d*4^k/N,
    (d+1)*4^k/N)``), accumulated in int64: the hash pipeline's topology
    with exact bins;
  * for every k > 9 feeds its masked keys (one plane for k <= 15, (hi,
    lo) above; from the key-plane kernel on the card) into that k's
    ``count.SparseSpectrumAccumulator``, as the flat
    ``multi_k_count_file`` does; ``finish`` gathers and merges the ranks'
    spectra, and k = 10..12 densify there so the dense ``[4^k]`` output
    of MAX_DENSE_K holds.

Every rank runs every dense k's reduce-scatter every step, in the same
order, whatever its batch's width (zeros where no window fits): ranks
frame different reads, and a k one rank skipped would hang the others.

Exactness: integer adds commute and each window's key lives on exactly one
rank, so every per-k result is bit-identical to the single-device one.
"""

from __future__ import annotations

import time as _time
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from ..device import count as _count
from ..device import kmers as _kmers
from .distributed import (
    control_group, data_rank, gather_table, to_device, vote,
)
from .exact import (
    DEFAULT_SHARD_LANES, _require_data_mesh, _stream_into, gather_spectra,
)
from .mesh import mesh_device

__all__ = ["ShardedMultiKAccumulator", "sharded_multi_k_count_file"]


class ShardedMultiKAccumulator:
    """Streaming multi-k spectra over a ``data`` mesh (one step a batch).

    ``add(seqs, lengths)`` (or codes + vbits in packed mode) ingests this
    rank's rows of one step (every rank calls it once a step;
    ``add(None, None)`` where this rank has none); ``finish()`` returns
    ``{k: spectrum}`` on every rank, dense int64 ``[4^k]`` arrays for k
    <= 12 and sorted ``(keys uint64, counts int64)`` pairs above.
    """

    def __init__(
        self,
        mesh,
        ks: Sequence[int],
        canonical: bool = True,
        normalized: bool = True,
        shard_lanes: int = DEFAULT_SHARD_LANES,
        packed: bool = False,
        quality_cutoff: Optional[int] = None,
        phred_offset: int = 33,
    ) -> None:
        ks = tuple(sorted({int(k) for k in ks}))
        if not ks:
            raise ValueError("ks must be non-empty")
        for k in ks:
            if not 1 <= k <= 31:
                raise ValueError(f"every k must be in [1, 31], got {k}")
        if packed and quality_cutoff is not None:
            raise ValueError("packed transport carries no quality planes")
        self._mesh = mesh
        self._n_data = _require_data_mesh(mesh)
        self._dev = mesh_device(mesh)
        self._control = control_group(mesh)
        self._group = mesh.get_group("data")
        # k <= 9 rides the histogram kernel a batch; 10..12 keep the dense
        # output but accumulate sparse and densify at finish (count_file's
        # routing)
        self._dense_ks = tuple(k for k in ks if k <= _count.MXU_DENSE_K)
        self._densify_ks = frozenset(
            k for k in ks if _count.MXU_DENSE_K < k <= _count.MAX_DENSE_K
        )
        self._sparse_ks = tuple(k for k in ks if k > _count.MXU_DENSE_K)
        for k in self._dense_ks:
            if (4**k) % self._n_data:
                raise ValueError(
                    f"4^{k} bins don't divide over data={self._n_data}; "
                    f"use a power-of-4-compatible mesh or drop k={k} to "
                    "the sparse path with dense output downstream"
                )
        self._cap = int(shard_lanes)
        self._packed = packed
        self._canonical = canonical
        self._normalized = normalized
        self._quality_cutoff = quality_cutoff
        self._qthresh = (
            None if quality_cutoff is None else phred_offset + quality_cutoff
        )
        self._dense = {
            k: torch.zeros(4**k // self._n_data, dtype=torch.int64, device=self._dev)
            for k in self._dense_ks
        }
        self._sparse = {
            k: _count.SparseSpectrumAccumulator(flush_lanes=self._cap)
            for k in self._sparse_ks
        }
        self._ingested = False
        self._on_cuda = self._dev.type == "cuda"

    def lanes_for(self, batch_rows: int, max_len: int, k: int) -> int:
        return batch_rows * max(max_len - k + 1, 0)

    def add(self, seqs, lengths, quals=None, vbits=None) -> None:
        """Ingest this rank's rows of one step; ``seqs=None`` adds nothing
        and joins the step's collectives."""
        lanes = {k: 0 for k in self._sparse_ks}
        if seqs is not None:
            b, l = seqs.shape
            if self._packed:
                l = l * 4
            lanes = {k: self.lanes_for(b, l, k) for k in self._sparse_ks}
            if self._quality_cutoff is not None and quals is None:
                raise ValueError("quality_cutoff needs FASTQ qualities")
        (too_big,) = vote(
            [any(n > self._cap for n in lanes.values())], self._control
        )
        if too_big:
            raise ValueError(
                "one batch overflows the per-rank key buffer on some rank; "
                "raise shard_lanes or shrink the batch"
            )
        windows = self._windows_fn(seqs, lengths, quals, vbits)
        for k in self._dense_ks:
            win = windows(k)
            local = (
                torch.zeros(4**k, dtype=torch.int32, device=self._dev)
                if win is None else _count.dense_spectrum(win, k)
            )
            part = local.new_empty(4**k // self._n_data)
            dist.reduce_scatter_tensor(part, local, group=self._group)
            self._dense[k] += part
        for k in self._sparse_ks:
            if lanes[k]:
                self._sparse[k].add(*windows(k, keys=True))
        self._ingested = True

    def _windows_fn(self, seqs, lengths, quals, vbits):
        """``windows(k, keys=False)`` of this rank's rows: the k-mer
        windows (None where none fits), or with ``keys`` the masked key
        planes; the rows are encoded at most once for every k."""
        from ..device.pipeline import _planes_keys, _window_keys
        from ..device.ops import quality_mask, unpack_codes

        if seqs is None:
            return lambda k, keys=False: None
        dev = self._dev
        data, lengths = to_device(seqs, dev), to_device(lengths, dev)
        if vbits is not None:
            vbits = to_device(vbits, dev)
        if self._qthresh is not None:
            data = quality_mask(data, to_device(quals, dev), self._qthresh)
        width = data.shape[1] * (4 if self._packed else 1)
        make = _kmers.canonical_kmers if self._canonical else _kmers.pack_kmers
        decoded = []

        def windows(k, keys=False):
            if k > width:
                return None
            if keys and self._canonical and self._on_cuda:
                return _planes_keys(
                    k, data, lengths, vbits, self._packed, self._normalized
                )
            if not decoded:
                decoded.append(
                    unpack_codes(data, vbits) if self._packed else data
                )
            win = make(
                decoded[0], lengths, k, normalized=self._normalized,
                precoded=self._packed,
            )
            return _window_keys(win, k) if keys else win

        return windows

    def snapshot(self) -> Dict[str, np.ndarray]:
        """Host snapshot for checkpointing: flushes the sparse buffers and
        gathers every table (collectives); the accumulator stays live.
        Keys: ``dense_{k}`` int64 arrays, ``keys_{k}``/``counts_{k}``
        sorted sparse pairs."""
        arrays: Dict[str, np.ndarray] = {}
        for k in self._dense_ks:
            arrays[f"dense_{k}"] = gather_table(self._dense[k], self._group)
        for k in self._sparse_ks:
            keys, counts = gather_spectra(
                *self._sparse[k].finish(), self._control
            )
            arrays[f"keys_{k}"] = keys
            arrays[f"counts_{k}"] = counts
        return arrays

    def restore(self, arrays: Dict[str, np.ndarray]) -> None:
        """Re-seed from a :meth:`snapshot` (checkpoint resume; fresh only).
        Each rank takes its dense bins; rank 0 of the data dim holds the
        sparse spectra, so ``finish`` counts them once."""
        if self._ingested:
            raise ValueError("restore() only applies to a fresh accumulator")
        rank = data_rank(self._mesh)[1]
        for k in self._dense_ks:
            table = np.asarray(arrays[f"dense_{k}"], dtype=np.int64)
            size = table.size // self._n_data
            self._dense[k].copy_(
                torch.from_numpy(table[rank * size : (rank + 1) * size])
            )
        if rank:
            return
        for k in self._sparse_ks:
            if f"keys_{k}" not in arrays and f"dense_{k}" in arrays:
                # written while this k rode a dense table: back to sorted
                # sparse pairs
                t = np.asarray(arrays[f"dense_{k}"]).astype(np.int64)
                nz = np.flatnonzero(t)
                self._sparse[k].restore(nz.astype(np.uint64), t[nz])
            else:
                self._sparse[k].restore(arrays[f"keys_{k}"],
                                        arrays[f"counts_{k}"])

    def finish(
        self,
    ) -> Dict[int, Union[np.ndarray, Tuple[np.ndarray, np.ndarray]]]:
        """``{k: spectrum}`` of every rank, on every rank: dense int64
        ``[4^k]`` arrays / sparse sorted (keys, counts) pairs, each
        bit-identical to a per-k run."""
        arrays = self.snapshot()
        out: Dict[int, object] = {}
        for k in self._dense_ks:
            out[k] = arrays[f"dense_{k}"]
        for k in self._sparse_ks:
            keys, counts = arrays[f"keys_{k}"], arrays[f"counts_{k}"]
            if k in self._densify_ks:
                table = np.zeros(4**k, np.int64)
                table[keys.astype(np.int64)] = counts
                out[k] = table
            else:
                out[k] = (keys, counts)
        return out


def sharded_multi_k_count_file(
    path,
    ks: Sequence[int],
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
) -> Tuple[int, Dict[int, Union[np.ndarray, Tuple[np.ndarray, np.ndarray]]]]:
    """Count several k values over the mesh in ONE pass over the file:
    ``(n_bases, {k: spectrum})`` on every rank, equal to
    ``pipeline.multi_k_count_file``'s arrays bit for bit.

    Each rank frames its own input as ``sharded_hash_count_file`` says.
    ``quality_cutoff``, ``bucketed``, ``packed``, ``meter`` and the
    checkpoint flags act as in ``sharded_count_file``; checkpoints are of
    kind ``sharded_multik`` (a flat ``multik`` file resumes too, and the
    flat driver resumes these).
    """
    from ..checkpoint import (
        counting_meta, prepare_checkpoint_stream, save_stream_checkpoint,
    )
    from .distributed import refuse_world_above_one

    ks = tuple(sorted({int(k) for k in ks}))
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
        "sharded_multi_k_count_file", mesh, path, checkpoint_every,
        checkpoint_path, resume_from,
    )
    acc = ShardedMultiKAccumulator(
        mesh, ks, canonical=canonical, normalized=normalized,
        shard_lanes=shard_lanes, packed=packed,
        quality_cutoff=quality_cutoff, phred_offset=phred_offset,
    )

    def _check_ks(ck):
        ck_ks = tuple(int(x) for x in ck["meta"].get("ks", ()))
        if ck_ks != ks:
            raise ValueError(
                f"checkpoint {resume_from!r} is a multi-k run with "
                f"ks={ck_ks}, expected ks={ks}"
            )

    sem = dict(
        canonical=canonical, normalized=normalized,
        quality_cutoff=quality_cutoff, phred_offset=phred_offset,
    )
    ckpt_mode, ck = prepare_checkpoint_stream(
        ("sharded_multik", "multik"),
        checkpoint_every=checkpoint_every, checkpoint_path=checkpoint_path,
        resume_from=resume_from, host_workers=host_workers, bucketed=bucketed,
        validate=_check_ks, **sem,
    )
    n_bases = start_offset = 0
    if ck is not None:
        start_offset, n_bases = ck["file_offset"], ck["n_bases"]
        acc.restore(ck["arrays"])

    def _save_ckpt(offset, n_bases_now):
        save_stream_checkpoint(
            checkpoint_path, "sharded_multik", 0, offset, n_bases_now,
            acc.snapshot(), input_path=str(path),
            meta={"ks": np.asarray(ks, np.int32), **counting_meta(**sem)},
        )

    t_wall0 = _time.perf_counter()
    n_bases = _stream_into(
        acc, mesh, path, min(ks), -(-batch_size // n_data), max_len,
        host_workers, spill_dir, packed, normalized, quality, bucketed,
        ckpt_mode, start_offset, checkpoint_every, _save_ckpt, meter,
        double_buffer, n_bases,
    )
    t_drain = _time.perf_counter()
    out = acc.finish()
    if meter is not None:
        now = _time.perf_counter()
        meter.add("drain", now - t_drain)
        meter.add("wall", now - t_wall0, items=n_bases)
    return n_bases, out
