"""File-level drivers of the port.

Counterpart of ``needletail_tpu/device/pipeline.py``.  The paths:

  * the hash count, :func:`hash_count_file`: FASTX file -> host framer ->
    one-buffer wire -> device ``unwire`` -> canonical k-mer hash keys ->
    2^16-bin histogram -> int64 table;
  * the exact spectrum, :func:`count_file`: the same front, then either a
    dense ``4^k`` table (k <= 9, histogram kernel) or canonical key planes
    buffered on the device, sorted and run-length counted per flush and
    compacted by the slot-compaction cascade (k >= 10; densified at the
    end for k <= 12);
  * several k values in one pass, :func:`multi_k_count_file`: each k
    routed as :func:`count_file` routes it, one unpack per batch shared
    by every k that builds windows;
  * the (w, k) minimizer sketch, :func:`minimizer_spectrum_file`: key
    planes, then the minimum of each run of w windows, counted as the
    exact spectrum counts its keys;
  * the mean-quality read filter, :func:`quality_filter_file`.

Both counting drivers take ``quality_cutoff`` (bases below it masked to
'N' on the device before any window is built; ASCII transport with the
quality plane beside it) and :func:`count_file` takes ``bucketed`` (reads
grouped by length, each batch as wide as its bucket).

The device steps are plain functions on tensors; PyTorch runs them
eagerly, so there is no per-configuration compile to cache.
"""

from __future__ import annotations

import time as _time
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from ..batch import length_wire_dtype
from ..utils.profiling import metered_iter

from ..encoding import ENCODE_RAW_LUT
from . import count as _count
from . import kernels as _kernels
from . import kmers as _kmers
from .ops import (
    _compose_le, encode_2bit, quality_mask, resolve_vbits, unpack_codes, unwire,
)

__all__ = [
    "hash_count_file",
    "count_file",
    "multi_k_count_file",
    "multi_k_tally",
    "canonical_dense_count",
    "canonical_match_count",
    "base_count",
    "pack_target",
    "readme_pipeline",
    "minimizer_spectrum_file",
    "quality_filter_file",
]


def _resolve_device(device: Union[str, torch.device]) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} but CUDA is not available; pass "
            "device='cpu' to run the plain PyTorch versions"
        )
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _uploader(dev: torch.device):
    """numpy array -> tensor on ``dev``; CUDA copies go through pinned
    staging, so each is an async DMA on the current stream."""

    def to_device(arr: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if dev.type == "cuda":
            t = t.pin_memory().to(dev, non_blocking=True)
        return t

    return to_device


def _batch_source(
    path, batch_size, max_len, host_workers, spill_dir, packed, normalized,
    ckpt_mode, start_offset, checkpoint_every, with_quals=False,
    bucketed=False,
):
    """A driver's framed batches: length-bucketed ones (single process,
    never in checkpoint mode), one offset-reporting stream from
    ``start_offset`` in checkpoint mode, else the multi-worker front.
    ``with_quals`` frames the quality plane too (FASTQ)."""
    if bucketed:
        from ..io.bucketed import bucketed_read_batches

        return bucketed_read_batches(path, batch_size=batch_size, max_len=max_len)
    if ckpt_mode:
        from ..checkpoint import checkpoint_source

        return checkpoint_source(
            path, batch_size, max_len, with_quals, packed, normalized,
            start_offset, require_offsets=checkpoint_every is not None,
        )
    from ..io.framing import _make_batch_source

    batches, _ = _make_batch_source(
        path, batch_size, max_len, host_workers, with_quals=with_quals,
        spill_dir=spill_dir, packed=packed, normalized=normalized,
    )
    return batches


def _placed_stream(
    batches, place, dev, packed, meter, double_buffer, checkpoint_every,
    save_checkpoint, ship_quals=False,
):
    """A driver's stream of ``place(batch)`` results, ``(num_bases,
    payload, aux, file_offset)`` with payload None where no window fits.

    ``double_buffer`` frames and places in feeder threads of their own;
    ``save_checkpoint(offset)`` fires after the driver folded every
    ``checkpoint_every``-th item (the feeders prefetch ahead of it);
    ``meter`` records ``frame``, ``h2d`` (synchronized, so its bytes/s is
    the transfer's own) and ``wait``, counting the quality plane's bytes
    where ``ship_quals`` (``place`` then uploads it beside the bases).
    """
    from ..checkpoint import checkpointed_batches

    def transport_nbytes(batch) -> int:
        if packed:
            return batch.wire_nbytes()
        n = batch.seqs.nbytes + batch.lengths.nbytes
        if ship_quals and batch.quals is not None:
            n += batch.quals.nbytes
        return n

    if meter is not None:
        batches = metered_iter(
            meter, "frame", batches,
            nbytes_of=transport_nbytes, items_of=lambda b: b.num_bases,
        )
        on_cuda = dev.type == "cuda"
        unmetered = place

        def place(batch):
            if on_cuda:
                # start the clock on an idle stream: the transfer queues
                # behind the steps already enqueued
                torch.cuda.current_stream(dev).synchronize()
            t0 = _time.perf_counter()
            out = unmetered(batch)
            if on_cuda and out[1] is not None:
                torch.cuda.current_stream(dev).synchronize()
            meter.add(
                "h2d", _time.perf_counter() - t0,
                nbytes=transport_nbytes(batch), items=out[0],
            )
            return out

    if double_buffer:
        from ..io.feed import device_feed

        placed = device_feed(device_feed(batches, lambda b: b), place)
    else:
        placed = (place(b) for b in batches)
    placed = checkpointed_batches(
        placed, checkpoint_every, save_checkpoint, offset_of=lambda t: t[3]
    )
    if meter is not None:
        placed = metered_iter(meter, "wait", placed)
    return placed


def _hash_step_fn(k: int, table_bits: int, packed: bool, normalized: bool):
    """One hash-count step, updating ``table`` and ``tallies`` (int64
    tensors: ``[2^table_bits]`` and ``(total, fwd)``) in place.

    Packed steps take the one-buffer wire plus its ``WireLayout``; ASCII
    steps take ``seqs`` and the lengths' little-endian bytes (composed
    back to int32 on the device, so no ``uint16`` tensor is needed).
    """

    def _fold(table, tallies, keys, total, fwd):
        table += _kernels.mxu_histogram16(keys)[: 1 << table_bits]
        tallies += torch.stack([total, fwd])

    if packed:

        def step(table, tallies, wire, layout):
            codes, lengths, vbits, vrow_idx, vrows = unwire(wire, layout)
            vb = resolve_vbits(vbits, vrow_idx, vrows, codes.shape[0])
            keys, total, fwd = _kernels.canonical_hash_keys_packed(
                codes, vb, lengths, k, table_bits=table_bits
            )
            _fold(table, tallies, keys, total, fwd)

    else:

        def step(table, tallies, seqs, length_bytes):
            size = length_bytes.numel() // seqs.shape[0]
            if size == 1:
                lengths = length_bytes.to(torch.int32)
            else:
                lengths = _compose_le(length_bytes.view(-1, size))
            keys, total, fwd = _kernels.canonical_hash_keys(
                seqs, lengths, k, table_bits=table_bits, normalized=normalized
            )
            _fold(table, tallies, keys, total, fwd)

    return step


def _hash_finalize(
    table: torch.Tensor, tallies: torch.Tensor
) -> Tuple[int, int, np.ndarray]:
    """One device->host pull of tallies and table: ``(total, fwd, table)``."""
    out = torch.cat([tallies, table]).cpu().numpy()
    return int(out[0]), int(out[1]), out[2:]


def hash_count_file(
    path,
    k: int,
    table_bits: int = 16,
    batch_size: int = 65536,
    max_len: Optional[int] = None,
    normalized: bool = True,
    host_workers: Optional[int] = None,
    spill_dir: Optional[str] = None,
    double_buffer: bool = True,
    packed: bool = True,
    checkpoint_every: Optional[int] = None,
    checkpoint_path: Optional[str] = None,
    resume_from: Optional[str] = None,
    meter=None,
    device: Union[str, torch.device] = "cuda",
) -> Tuple[int, int, int, np.ndarray]:
    """Count the canonical k-mer hashes of a FASTX file (or a list of
    files) into a ``2^table_bits``-bin table.

    Returns ``(n_bases, total_windows, forward_windows, table)``, ``table``
    an int64 numpy array; the same values JAX's ``hash_count_file``
    returns.  ``device="cuda"`` runs the hand-written kernels and raises
    when CUDA is absent; ``device="cpu"`` runs their plain versions.

    ``packed=True`` ships each batch as the 2-bit one-buffer wire;
    ``packed=False`` ships ASCII.  Results are identical.
    ``host_workers=None`` frames plain files with one process per spare
    core; ``double_buffer`` frames and uploads the next batch in feeder
    threads while the current one counts.  ``checkpoint_every=N`` writes
    the state to ``checkpoint_path`` every N batches; ``resume_from``
    continues from such a file (single-stream, uncompressed or BGZF).

    ``meter=`` (a ``ThroughputMeter``) records the stages ``frame`` (host
    framing, feeder thread), ``h2d`` (placement on the device, synchronized
    so its bytes/s is the transfer's own), ``wait`` (consumer blocked on
    the feed), ``dispatch`` (enqueueing a step), ``drain`` (final sync and
    pull) and ``wall`` (end to end; the feeder stages overlap the rest).
    """
    if table_bits > 16:
        raise ValueError("the histogram shard is 2^16 bins; table_bits <= 16")
    dev = _resolve_device(device)

    from ..checkpoint import (
        counting_meta,
        prepare_checkpoint_stream,
        save_stream_checkpoint,
    )

    def _check_table_bits(ck):
        if int(ck["meta"]["table_bits"]) != table_bits:
            raise ValueError("checkpoint table_bits mismatch")

    ckpt_mode, resume_state = prepare_checkpoint_stream(
        "hash", k,
        checkpoint_every=checkpoint_every, checkpoint_path=checkpoint_path,
        resume_from=resume_from, host_workers=host_workers,
        validate=_check_table_bits, normalized=normalized,
    )
    step = _hash_step_fn(k, table_bits, packed, normalized)

    table = torch.zeros(1 << table_bits, dtype=torch.int64, device=dev)
    tallies = torch.zeros(2, dtype=torch.int64, device=dev)  # (total, fwd)
    n_bases = 0
    start_offset = 0
    if resume_state is not None:
        start_offset = resume_state["file_offset"]
        n_bases = resume_state["n_bases"]
        table.copy_(
            torch.from_numpy(
                np.asarray(resume_state["arrays"]["table"], dtype=np.int64)
            )
        )
        tallies.copy_(
            torch.tensor(
                [
                    int(resume_state["meta"]["total"]),
                    int(resume_state["meta"]["fwd"]),
                ],
                dtype=torch.int64,
            )
        )
    t_wall0 = _time.perf_counter()
    batches = _batch_source(
        path, batch_size, max_len, host_workers, spill_dir, packed,
        normalized, ckpt_mode, start_offset, checkpoint_every,
    )
    _to_device = _uploader(dev)

    def _place(batch):
        """``(num_bases, payload, aux, file_offset)``: the wire and its
        layout, or ASCII ``seqs`` and the lengths' bytes."""
        if batch.max_len < k:
            return batch.num_bases, None, None, batch.file_offset
        if packed:
            buf, layout = batch.wire_frame(batch_size)
            return batch.num_bases, _to_device(buf), layout, batch.file_offset
        b = (
            batch
            if batch.num_reads == batch_size
            else batch.pad_reads_to(batch_size)
        )
        ldt = np.dtype(length_wire_dtype(b.max_len)).newbyteorder("<")
        length_bytes = b.lengths.astype(ldt).view(np.uint8)
        return (
            batch.num_bases,
            _to_device(b.seqs),
            _to_device(length_bytes),
            batch.file_offset,
        )

    def _save_checkpoint(offset):
        total, fwd, t = _hash_finalize(table, tallies)
        save_stream_checkpoint(
            checkpoint_path,
            "hash",
            k,
            offset,
            n_bases,
            {"table": t},
            input_path=str(path),
            meta={
                "table_bits": np.int32(table_bits),
                "total": np.int64(total),
                "fwd": np.int64(fwd),
                **counting_meta(normalized=normalized),
            },
        )

    placed = _placed_stream(
        batches, _place, dev, packed, meter, double_buffer, checkpoint_every,
        _save_checkpoint,
    )
    for nb, payload, aux, _offset in placed:
        n_bases += nb
        if payload is not None:
            t0 = _time.perf_counter() if meter is not None else 0.0
            step(table, tallies, payload, aux)
            if meter is not None:
                meter.add("dispatch", _time.perf_counter() - t0, items=nb)
    t_drain = _time.perf_counter()
    total, fwd, out = _hash_finalize(table, tallies)
    if meter is not None:
        now = _time.perf_counter()
        meter.add("drain", now - t_drain, nbytes=out.nbytes)
        meter.add("wall", now - t_wall0, items=n_bases)
    return n_bases, total, fwd, out


# ---------------------------------------------------------------------------
# the exact spectrum
# ---------------------------------------------------------------------------


def pack_target(kmer_bytes: bytes) -> Tuple[np.uint32, np.uint32]:
    """Pack an ASCII k-mer into the (hi, lo) uint32 pair of the device
    windows (bytes outside ACGT/acgt are skipped, as JAX skips them)."""
    k = len(kmer_bytes)
    value = 0
    for b in bytes(kmer_bytes):
        code = int(ENCODE_RAW_LUT[b])
        if code != 255:
            value = ((value << 2) | code) & ((1 << (2 * k)) - 1)
    return np.uint32(value >> 32), np.uint32(value & 0xFFFFFFFF)


def _windows_fn(canonical: bool):
    return _kmers.canonical_kmers if canonical else _kmers.pack_kmers


def canonical_dense_count(
    seqs: torch.Tensor,
    lengths: torch.Tensor,
    k: int,
    canonical: bool = True,
    normalized: bool = True,
) -> torch.Tensor:
    """int32 ``[4^k]`` exact spectrum of (canonical) k-mers for one batch."""
    windows = _windows_fn(canonical)(seqs, lengths, k, normalized=normalized)
    return _count.dense_spectrum(windows, k)


def canonical_match_count(
    seqs: torch.Tensor,
    lengths: torch.Tensor,
    target_hi,
    target_lo,
    k: int,
    canonical: bool = True,
    normalized: bool = True,
) -> torch.Tensor:
    """Count of windows whose (canonical) value equals the target."""
    windows = _windows_fn(canonical)(seqs, lengths, k, normalized=normalized)
    return _count.match_count(windows, target_hi, target_lo)


def base_count(lengths: torch.Tensor) -> torch.Tensor:
    """Total bases of a batch, as an int64 scalar."""
    return lengths.to(torch.int64).sum()


def _planes_keys(
    k: int, data, lengths, vbits, packed: bool, normalized: bool,
    width: Optional[int] = None,
):
    """Flat (hi | None, lo) key planes of the window starts ``[0, width)``
    (default: every start, ``L - k + 1``) from the key-plane kernel; hi is
    dropped for k <= 15, whose keys fit lo."""
    if packed:
        khi, klo, _, _ = _kernels.canonical_key_planes_packed(
            data, vbits, lengths, k
        )
    else:
        khi, klo, _, _ = _kernels.canonical_key_planes(
            data, lengths, k, normalized
        )
    # later lanes hold sentinels anyway, and dropping them shrinks the sort
    w = khi.shape[1] - k + 1
    if width is not None:
        w = min(width, w)
    hi = None if k <= 15 else khi[:, :w].reshape(-1)
    return hi, klo[:, :w].reshape(-1)


def _window_keys(windows: _kmers.KmerWindows, k: int):
    """Flat masked (hi | None, lo) key planes of :mod:`kmers` windows."""
    hi, lo = _count.mask_keys(windows)
    return (None if k <= 15 else hi), lo


def _count_step_fns(k: int, packed: bool, canonical: bool, normalized: bool,
                    on_cuda: bool):
    """``(spectrum, keys)`` steps of :func:`count_file` over one placed
    batch ``(data, lengths, vbits)``: the int32 dense spectrum, or the
    flat masked (hi | None, lo) key planes.  Keys come from the key-plane
    kernel for canonical counts on the card, from :mod:`kmers` otherwise,
    as JAX routes them."""
    make_windows = _windows_fn(canonical)

    def windows(data, lengths, vbits):
        seqs = unpack_codes(data, vbits) if packed else data
        return make_windows(
            seqs, lengths, k, normalized=normalized, precoded=packed
        )

    def spectrum(data, lengths, vbits):
        return _count.dense_spectrum(windows(data, lengths, vbits), k)

    def keys(data, lengths, vbits):
        if canonical and on_cuda:
            return _planes_keys(k, data, lengths, vbits, packed, normalized)
        return _window_keys(windows(data, lengths, vbits), k)

    return spectrum, keys


def _place_ascii(to_device, batch, quality: bool):
    """An ASCII batch on the device: ``(seqs, int32 lengths, quals)``,
    the quality plane only under ``quality`` (else None), where a FASTA
    batch, which has none, raises."""
    quals = None
    if quality:
        if batch.quals is None:
            raise ValueError("quality_cutoff needs FASTQ input with qualities")
        quals = to_device(batch.quals)
    return (
        to_device(batch.seqs),
        to_device(batch.lengths.astype(np.int32, copy=False)),
        quals,
    )


def _place_fn(to_device, min_len: int, packed: bool, quality: bool = False):
    """A driver's ``place(batch)``: ``(num_bases, payload, layout,
    file_offset)``, the payload the wire (``layout`` its ``WireLayout``)
    or ASCII ``(seqs, lengths, quals | None)`` (``layout`` None), and
    None where the batch's reads are shorter than ``min_len``: no window
    fits, and its bases still count."""

    def place(batch):
        if batch.max_len < min_len:
            return batch.num_bases, None, None, batch.file_offset
        if packed:
            # no read padding: the short last batch ships as it is
            buf, layout = batch.wire_frame(batch.num_reads)
            return batch.num_bases, to_device(buf), layout, batch.file_offset
        payload = _place_ascii(to_device, batch, quality)
        return batch.num_bases, payload, None, batch.file_offset

    return place


def _device_args(payload, layout, qthresh: Optional[int] = None):
    """``(data, lengths, vbits)`` of a placed payload: the wire unwired
    (``layout`` given), or ASCII with its low-quality bases masked."""
    if layout is not None:
        codes, lengths, vbits, vrow_idx, vrows = unwire(payload, layout)
        return codes, lengths, resolve_vbits(vbits, vrow_idx, vrows, codes.shape[0])
    return (*_masked_ascii(payload, qthresh), None)


def _masked_ascii(payload, qthresh: Optional[int]):
    """``(seqs, lengths)`` of a placed ASCII payload, every base whose
    quality byte is below ``qthresh`` (``phred_offset + quality_cutoff``)
    masked to 'N' where the payload carries qualities: its windows are
    then invalid to every route, the key-plane kernel's as JAX's XLA
    windows."""
    seqs, lengths, quals = payload
    if quals is not None:
        seqs = quality_mask(seqs, quals, qthresh)
    return seqs, lengths


def count_file(
    path,
    k: int,
    canonical: bool = True,
    normalized: bool = True,
    batch_size: int = 512,
    max_len: Optional[int] = None,
    dense: Optional[bool] = None,
    sparse_format: str = "dict",
    bucketed: bool = False,
    quality_cutoff: Optional[int] = None,
    phred_offset: int = 33,
    host_workers: Optional[int] = None,
    spill_dir: Optional[str] = None,
    packed: Optional[bool] = None,
    checkpoint_every: Optional[int] = None,
    checkpoint_path: Optional[str] = None,
    resume_from: Optional[str] = None,
    meter=None,
    double_buffer: bool = True,
    device: Union[str, torch.device] = "cuda",
) -> Tuple[int, Union[np.ndarray, Dict[int, int], Tuple[np.ndarray, np.ndarray]]]:
    """Exact k-mer spectrum of a FASTX file (or a list of files).

    Returns ``(n_bases, spectrum)``, the values JAX's ``count_file``
    returns: a dense int64 ``[4^k]`` array for k <= 12 (or ``dense=True``),
    else a ``{packed_kmer: count}`` dict, or with ``sparse_format="arrays"``
    ``(keys uint64, counts int64)`` arrays, keys ascending.  k <= 9
    accumulates a dense table per batch; 10 <= k <= 12 counts sparse and
    densifies at the end; above that the key planes stay on the device
    until a flush of ``count.SPARSE_FLUSH_LANES`` lanes (or EOF) resolves
    them with one sort.

    ``device="cuda"`` runs the hand-written kernels and raises when CUDA
    is absent; ``device="cpu"`` runs their plain versions.  ``packed``
    (default on) ships the 2-bit one-buffer wire, else ASCII; results are
    identical.  ``host_workers``, ``spill_dir``, ``double_buffer``,
    ``meter`` and the checkpoint flags act as in :func:`hash_count_file`;
    checkpoints are of kind ``count_dense`` (k <= 9) or ``count_sparse``,
    the same files JAX's ``count_file`` writes and resumes.

    ``quality_cutoff`` masks every base whose Phred score (quality byte
    minus ``phred_offset``) is below it to 'N' on the device before
    counting (FASTQ only; a FASTA input raises ``ValueError``).
    ``bucketed=True`` frames reads in one process grouped by length
    (``io.bucketed``), each batch padded only to its bucket's width (128
    to 4096, longer reads to a multiple of 128); it excludes
    ``host_workers > 1`` and checkpoints.  Both ship ASCII with the
    quality plane beside it, so ``packed=None`` resolves to ``not
    (quality_cutoff or bucketed)`` and ``packed=True`` with either raises
    ``ValueError``.  On the card canonical keys still come from the
    key-plane kernel, over the masked bytes at every bucket width.

    A tuple of k values counts them all in one pass through
    :func:`multi_k_count_file` (``bucketed`` and ``dense`` then raise
    ``ValueError``, as in JAX).
    """
    if isinstance(k, (tuple, list, set, frozenset)):
        if bucketed or dense is not None:
            raise ValueError(
                "multi-k counting does not take bucketed/dense; call "
                "multi_k_count_file directly for full control"
            )
        return multi_k_count_file(
            path, k, canonical=canonical, normalized=normalized,
            batch_size=batch_size, max_len=max_len,
            sparse_format=sparse_format, quality_cutoff=quality_cutoff,
            phred_offset=phred_offset, host_workers=host_workers,
            spill_dir=spill_dir, packed=packed,
            checkpoint_every=checkpoint_every,
            checkpoint_path=checkpoint_path, resume_from=resume_from,
            meter=meter, double_buffer=double_buffer, device=device,
        )
    if bucketed and host_workers is not None and host_workers > 1:
        raise ValueError(
            "bucketed=True and host_workers>1 are mutually exclusive: "
            "bucketed framing is single-process (pass one or the other)"
        )
    if dense is None:
        dense = k <= _count.MAX_DENSE_K
    elif dense and k > _count.MAX_DENSE_K:
        raise ValueError(
            f"dense output needs k <= {_count.MAX_DENSE_K}, got {k}; "
            "use dense=False (sparse keys/counts) for larger k"
        )
    quality = quality_cutoff is not None
    if packed is None:
        packed = not (quality or bucketed)
    elif packed and (quality or bucketed):
        raise ValueError(
            "packed transport carries no quality planes and no bucketed "
            "shapes; drop packed=True or the conflicting option"
        )
    dev = _resolve_device(device)
    on_cuda = dev.type == "cuda"

    from ..checkpoint import (
        counting_meta,
        prepare_checkpoint_stream,
        save_stream_checkpoint,
    )

    densify_after = dense and k > _count.MXU_DENSE_K
    accumulate_dense = dense and not densify_after
    spectrum_step, keys_step = _count_step_fns(
        k, packed, canonical, normalized, on_cuda
    )
    qthresh = phred_offset + quality_cutoff if quality else None
    sem = counting_meta(
        canonical=canonical, normalized=normalized,
        quality_cutoff=quality_cutoff, phred_offset=phred_offset,
    )
    kind = "count_dense" if accumulate_dense else "count_sparse"
    ckpt_mode, ck = prepare_checkpoint_stream(
        kind, k,
        checkpoint_every=checkpoint_every, checkpoint_path=checkpoint_path,
        resume_from=resume_from, host_workers=host_workers,
        bucketed=bucketed, canonical=canonical, normalized=normalized,
        quality_cutoff=quality_cutoff, phred_offset=phred_offset,
    )

    n_bases = 0
    table = (
        torch.zeros(4**k, dtype=torch.int64, device=dev)
        if accumulate_dense else None
    )
    sparse = _count.SparseSpectrumAccumulator()
    start_offset = 0
    if ck is not None:
        start_offset = ck["file_offset"]
        n_bases = ck["n_bases"]
        if accumulate_dense:
            table.copy_(torch.from_numpy(
                np.asarray(ck["arrays"]["table"], dtype=np.int64)
            ))
        else:
            sparse.restore(ck["arrays"]["keys"], ck["arrays"]["counts"])

    def _save_checkpoint(offset):
        if accumulate_dense:
            arrays = {"table": table.cpu().numpy()}
        else:
            # finish() flushes (one sort) and leaves the accumulator live
            keys, counts = sparse.finish()
            arrays = {"keys": keys, "counts": counts}
        save_stream_checkpoint(
            checkpoint_path, kind, k, offset, n_bases, arrays,
            input_path=str(path), meta=sem,
        )

    t_wall0 = _time.perf_counter()
    batches = _batch_source(
        path, batch_size, max_len, host_workers, spill_dir, packed,
        normalized, ckpt_mode, start_offset, checkpoint_every,
        with_quals=quality, bucketed=bucketed,
    )
    place = _place_fn(_uploader(dev), k, packed, quality)
    placed = _placed_stream(
        batches, place, dev, packed, meter, double_buffer, checkpoint_every,
        _save_checkpoint, ship_quals=quality,
    )
    for nb, payload, layout, _offset in placed:
        n_bases += nb
        if payload is None:
            continue
        t0 = _time.perf_counter() if meter is not None else 0.0
        args = _device_args(payload, layout, qthresh)
        if accumulate_dense:
            table += spectrum_step(*args)
        else:
            sparse.add(*keys_step(*args))
        if meter is not None:
            meter.add("dispatch", _time.perf_counter() - t0, items=nb)

    t_drain = _time.perf_counter()
    if accumulate_dense:
        result = table.cpu().numpy()
    else:
        keys, counts = sparse.finish()
        if densify_after:
            result = np.zeros(4**k, np.int64)
            result[keys.astype(np.int64)] = counts
        elif sparse_format == "arrays":
            result = (keys, counts)
        else:
            result = _count.spectrum_arrays_to_dict(keys, counts)
    if meter is not None:
        now = _time.perf_counter()
        meter.add("drain", now - t_drain)
        meter.add("wall", now - t_wall0, items=n_bases)
    return n_bases, result


# ---------------------------------------------------------------------------
# several k values in one pass
# ---------------------------------------------------------------------------


def multi_k_tally(
    seqs: torch.Tensor,
    lengths: torch.Tensor,
    ks,
    canonical: bool = True,
    normalized: bool = True,
) -> Dict[int, Tuple[torch.Tensor, torch.Tensor]]:
    """``{k: (total valid windows, forward windows)}`` of one ASCII batch
    for every k in ``ks``, encoded once."""
    codes = encode_2bit(seqs, normalized)
    make_windows = _windows_fn(canonical)
    out = {}
    for k in tuple(ks):
        win = make_windows(codes, lengths, k, precoded=True)
        out[k] = (_count.valid_count(win), _count.forward_count(win))
    return out


def multi_k_count_file(
    path,
    ks,
    canonical: bool = True,
    normalized: bool = True,
    batch_size: int = 512,
    max_len: Optional[int] = None,
    sparse_format: str = "arrays",
    quality_cutoff: Optional[int] = None,
    phred_offset: int = 33,
    host_workers: Optional[int] = None,
    spill_dir: Optional[str] = None,
    packed: Optional[bool] = None,
    checkpoint_every: Optional[int] = None,
    checkpoint_path: Optional[str] = None,
    resume_from: Optional[str] = None,
    meter=None,
    double_buffer: bool = True,
    device: Union[str, torch.device] = "cuda",
) -> Tuple[int, Dict[int, Union[np.ndarray, Dict[int, int], Tuple[np.ndarray, np.ndarray]]]]:
    """Count several k values in one pass over a FASTX file (canonical
    4..31-mer counting).

    Returns ``(n_bases, {k: spectrum})``, the values JAX's
    ``multi_k_count_file`` returns: each k's spectrum is what
    :func:`count_file` returns for it, dense int64 ``[4^k]`` for k <= 12,
    else ``(keys uint64, counts int64)`` arrays (a dict with
    ``sparse_format="dict"``).  Each k is routed as :func:`count_file`
    routes it: k <= 9 dense per batch (the histogram kernel on CUDA),
    10..12 sparse and densified at the end, above that sparse (the
    key-plane kernel on CUDA for canonical counts).  A batch is framed,
    shipped and unwired once, and unpacked at most once for every k that
    builds windows; k values longer than a batch's reads skip it.

    ``checkpoint_every``/``checkpoint_path``/``resume_from`` write and
    resume checkpoints of kind ``multik`` (``dense_{k}`` tables and
    ``keys_{k}``/``counts_{k}`` pairs), the files JAX's flat and sharded
    multi-k drivers write; a ``sharded_multik`` file resumes too.
    ``meter``, ``double_buffer``, ``host_workers``, ``spill_dir`` and
    ``device`` act as in :func:`count_file`.  ``quality_cutoff`` masks
    low-quality bases to 'N' once per batch, before every k, as in
    :func:`count_file` (ASCII transport; ``packed=True`` with it raises
    ``ValueError``).
    """
    ks = tuple(sorted({int(k) for k in ks}))
    if not ks:
        raise ValueError("ks must be non-empty")
    for k in ks:
        if not 1 <= k <= 31:
            raise ValueError(f"every k must be in [1, 31], got {k}")
    quality = quality_cutoff is not None
    if packed is None:
        packed = not quality
    elif packed and quality:
        raise ValueError("packed transport carries no quality planes")
    dev = _resolve_device(device)
    on_cuda = dev.type == "cuda"

    from ..checkpoint import (
        counting_meta,
        prepare_checkpoint_stream,
        save_stream_checkpoint,
    )

    dense_ks = tuple(k for k in ks if k <= _count.MAX_DENSE_K)
    sparse_ks = tuple(k for k in ks if k > _count.MAX_DENSE_K)
    mxu_dense_ks = tuple(k for k in dense_ks if k <= _count.MXU_DENSE_K)
    densify_ks = tuple(k for k in dense_ks if k > _count.MXU_DENSE_K)
    acc_sparse_ks = densify_ks + sparse_ks
    make_windows = _windows_fn(canonical)

    tables = {
        k: torch.zeros(4**k, dtype=torch.int64, device=dev)
        for k in mxu_dense_ks
    }
    sparse_accs = {k: _count.SparseSpectrumAccumulator() for k in acc_sparse_ks}
    n_bases = 0

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
        ("multik", "sharded_multik"),
        checkpoint_every=checkpoint_every, checkpoint_path=checkpoint_path,
        resume_from=resume_from, host_workers=host_workers,
        validate=_check_ks, **sem,
    )
    start_offset = 0
    if ck is not None:
        start_offset = ck["file_offset"]
        n_bases = ck["n_bases"]
        arrays = ck["arrays"]
        for k in mxu_dense_ks:
            tables[k].copy_(torch.from_numpy(
                np.asarray(arrays[f"dense_{k}"], dtype=np.int64)
            ))
        for k in acc_sparse_ks:
            if f"keys_{k}" not in arrays and f"dense_{k}" in arrays:
                # written while this k rode a dense table (the sharded
                # driver's schema): back to sorted sparse pairs
                t = np.asarray(arrays[f"dense_{k}"]).astype(np.int64)
                nz = np.flatnonzero(t)
                sparse_accs[k].restore(nz.astype(np.uint64), t[nz])
            else:
                sparse_accs[k].restore(
                    arrays[f"keys_{k}"], arrays[f"counts_{k}"]
                )

    def _save_checkpoint(offset):
        arrays = {}
        for k in mxu_dense_ks:
            arrays[f"dense_{k}"] = tables[k].cpu().numpy()
        for k in acc_sparse_ks:
            # finish() flushes (one sort per k) and leaves the accumulator live
            keys, counts = sparse_accs[k].finish()
            arrays[f"keys_{k}"] = keys
            arrays[f"counts_{k}"] = counts
        save_stream_checkpoint(
            checkpoint_path, "multik", 0, offset, n_bases, arrays,
            input_path=str(path),
            meta={"ks": np.asarray(ks, np.int32), **counting_meta(**sem)},
        )

    t_wall0 = _time.perf_counter()
    batches = _batch_source(
        path, batch_size, max_len, host_workers, spill_dir, packed,
        normalized, ckpt_mode, start_offset, checkpoint_every,
        with_quals=quality,
    )
    to_device = _uploader(dev)
    qthresh = phred_offset + quality_cutoff if quality else None

    def _place(batch):
        """``(num_bases, payload, (layout, active ks), file_offset)``;
        payload None when no k fits the batch's reads."""
        active = tuple(k for k in ks if k <= batch.max_len)
        if not active:
            return batch.num_bases, None, None, batch.file_offset
        if packed:
            buf, layout = batch.wire_frame(batch.num_reads)
            payload = to_device(buf)
        else:
            layout = None
            payload = _place_ascii(to_device, batch, quality)
        return batch.num_bases, payload, (layout, active), batch.file_offset

    def _step(data, lengths, vbits, active):
        seqs = None
        for k in active:
            if k not in tables and canonical and on_cuda:
                sparse_accs[k].add(*_planes_keys(
                    k, data, lengths, vbits, packed, normalized
                ))
                continue
            if seqs is None:
                # one unpack per batch, shared by every k
                seqs = unpack_codes(data, vbits) if packed else data
            win = make_windows(
                seqs, lengths, k, normalized=normalized, precoded=packed
            )
            if k in tables:
                tables[k] += _count.dense_spectrum(win, k)
            else:
                sparse_accs[k].add(*_window_keys(win, k))

    placed = _placed_stream(
        batches, _place, dev, packed, meter, double_buffer, checkpoint_every,
        _save_checkpoint, ship_quals=quality,
    )
    for nb, payload, aux, _offset in placed:
        n_bases += nb
        if payload is None:
            continue
        t0 = _time.perf_counter() if meter is not None else 0.0
        layout, active = aux
        if packed:
            codes, lengths, vbits, vrow_idx, vrows = unwire(payload, layout)
            vbits = resolve_vbits(vbits, vrow_idx, vrows, codes.shape[0])
            _step(codes, lengths, vbits, active)
        else:
            # masked once, before every k
            _step(*_masked_ascii(payload, qthresh), None, active)
        if meter is not None:
            meter.add("dispatch", _time.perf_counter() - t0, items=nb)

    t_drain = _time.perf_counter()
    out: Dict[int, object] = {}
    for k in mxu_dense_ks:
        out[k] = tables[k].cpu().numpy()
    for k in densify_ks:
        keys, counts = sparse_accs[k].finish()
        table = np.zeros(4**k, np.int64)
        table[keys.astype(np.int64)] = counts
        out[k] = table
    for k in sparse_ks:
        keys, counts = sparse_accs[k].finish()
        out[k] = (
            _count.spectrum_arrays_to_dict(keys, counts)
            if sparse_format == "dict"
            else (keys, counts)
        )
    if meter is not None:
        now = _time.perf_counter()
        meter.add("drain", now - t_drain)
        meter.add("wall", now - t_wall0, items=n_bases)
    return n_bases, out


# ---------------------------------------------------------------------------
# the (w, k) minimizer sketch and the mean-quality filter
# ---------------------------------------------------------------------------


def _minimizer_windows_fn(k: int, w: int, packed: bool, normalized: bool,
                          on_cuda: bool):
    """The sketch's windows of one placed batch ``(data, lengths,
    vbits)``: over the key-plane kernel's planes on the card, over
    :mod:`kmers` windows (the kernel's plain route) on the CPU."""
    from . import minimizers as _minimizers

    def windows(data, lengths, vbits):
        if on_cuda:
            if packed:
                khi, klo, _, _ = _kernels.canonical_key_planes_packed(
                    data, vbits, lengths, k
                )
            else:
                khi, klo, _, _ = _kernels.canonical_key_planes(
                    data, lengths, k, normalized
                )
            win = _minimizers.window_minimizers_from_planes(khi, klo, k, w)
        else:
            seqs = unpack_codes(data, vbits) if packed else data
            win = _minimizers.window_minimizers(
                seqs, lengths, k, w, normalized=normalized, precoded=packed
            )
        return win

    return windows


def _minimizer_keys_fn(k: int, w: int, packed: bool, normalized: bool,
                       on_cuda: bool):
    """Flat masked (hi | None, lo) sketch keys of one placed batch."""
    windows = _minimizer_windows_fn(k, w, packed, normalized, on_cuda)
    return lambda data, lengths, vbits: _window_keys(
        windows(data, lengths, vbits), k
    )


def minimizer_spectrum_file(
    path,
    k: int,
    w: int,
    batch_size: int = 4096,
    max_len: Optional[int] = None,
    normalized: bool = True,
    sparse_format: str = "arrays",
    mesh=None,
    host_workers: Optional[int] = None,
    spill_dir: Optional[str] = None,
    packed: Optional[bool] = None,
    checkpoint_every: Optional[int] = None,
    checkpoint_path: Optional[str] = None,
    resume_from: Optional[str] = None,
    meter=None,
    double_buffer: bool = True,
    device: Union[str, torch.device] = "cuda",
) -> Tuple[int, Union[Dict[int, int], Tuple[np.ndarray, np.ndarray]]]:
    """(w, k) minimizer spectrum of a FASTX file (or a list of files):
    how many w-windows each canonical k-mer wins (ref sequence.rs:139-152,
    lifted to whole-file scale).

    Returns ``(n_bases, (keys uint64, counts int64))``, keys ascending, or
    a dict with ``sparse_format="dict"``: the values JAX's
    ``minimizer_spectrum_file`` returns.  A batch whose reads are shorter
    than ``k + w - 1`` adds its bases and nothing else.  On the card the
    windows come from the key-plane kernel (packed or ASCII), then
    ``minimizers.window_minimizers_from_planes``, and the sketch keys are
    counted as :func:`count_file` counts its keys.

    ``packed`` (default on) ships the 2-bit wire, else ASCII; results are
    identical.  Checkpoints are of kind ``minimizer`` with ``w`` in their
    meta, the files JAX's driver writes and resumes.  ``meter``,
    ``double_buffer``, ``host_workers``, ``spill_dir`` and ``device`` act
    as in :func:`count_file`.

    ``mesh`` (a ``parallel.make_mesh`` mesh on the device ``device``
    names, else ``ValueError``) counts the sketch over its ``data`` dim:
    each rank frames its own input (see
    ``parallel.sharded_hash_count_file``) as ASCII (``packed=True`` with it
    raises ``ValueError``, as in JAX) into a
    ``parallel.ShardedSpectrumAccumulator``, and every rank returns the
    whole sketch.
    """
    if packed is None:
        packed = mesh is None
    elif packed and mesh is not None:
        raise ValueError(
            "the mesh minimizer path rides ASCII planes; drop packed=True "
            "or mesh="
        )
    if mesh is not None:
        from ..parallel.mesh import mesh_device_for

        mesh_device_for(mesh, device)
    dev = _resolve_device(device) if mesh is None else None

    from ..checkpoint import (
        counting_meta,
        prepare_checkpoint_stream,
        save_stream_checkpoint,
    )

    def _check_w(ck):
        ck_w = int(ck["meta"].get("w", -1))
        if ck_w != w:
            raise ValueError(
                f"checkpoint {resume_from!r} is a (w={ck_w}, k={ck['k']}) "
                f"sketch, expected w={w}"
            )

    ckpt_mode, ck = prepare_checkpoint_stream(
        "minimizer", k,
        checkpoint_every=checkpoint_every, checkpoint_path=checkpoint_path,
        resume_from=resume_from, host_workers=host_workers,
        validate=_check_w, normalized=normalized,
    )
    def _save(offset, n_bases, acc):
        keys, counts = acc.finish()  # flushes; the accumulator stays live
        save_stream_checkpoint(
            checkpoint_path, "minimizer", k, offset, n_bases,
            {"keys": keys, "counts": counts}, input_path=str(path),
            meta={"w": np.int32(w), **counting_meta(normalized=normalized)},
        )

    if mesh is not None:
        return _minimizer_spectrum_sharded(
            path, k, w, mesh, batch_size, max_len, normalized, sparse_format,
            host_workers, spill_dir, ckpt_mode, ck, checkpoint_every,
            checkpoint_path, resume_from, _save, meter, double_buffer,
        )
    sparse = _count.SparseSpectrumAccumulator()
    n_bases = 0
    start_offset = 0
    if ck is not None:
        start_offset = ck["file_offset"]
        n_bases = ck["n_bases"]
        sparse.restore(ck["arrays"]["keys"], ck["arrays"]["counts"])

    def _save_checkpoint(offset):
        _save(offset, n_bases, sparse)

    keys_step = _minimizer_keys_fn(k, w, packed, normalized, dev.type == "cuda")
    t_wall0 = _time.perf_counter()
    batches = _batch_source(
        path, batch_size, max_len, host_workers, spill_dir, packed,
        normalized, ckpt_mode, start_offset, checkpoint_every,
    )
    place = _place_fn(_uploader(dev), k + w - 1, packed)
    placed = _placed_stream(
        batches, place, dev, packed, meter, double_buffer, checkpoint_every,
        _save_checkpoint,
    )
    for nb, payload, layout, _offset in placed:
        n_bases += nb
        if payload is None:
            continue
        t0 = _time.perf_counter() if meter is not None else 0.0
        sparse.add(*keys_step(*_device_args(payload, layout)))
        if meter is not None:
            meter.add("dispatch", _time.perf_counter() - t0, items=nb)

    t_drain = _time.perf_counter()
    keys, counts = sparse.finish()
    result = (
        _count.spectrum_arrays_to_dict(keys, counts)
        if sparse_format == "dict" else (keys, counts)
    )
    if meter is not None:
        now = _time.perf_counter()
        meter.add("drain", now - t_drain)
        meter.add("wall", now - t_wall0, items=n_bases)
    return n_bases, result


def _minimizer_spectrum_sharded(
    path, k, w, mesh, batch_size, max_len, normalized, sparse_format,
    host_workers, spill_dir, ckpt_mode, ck, checkpoint_every,
    checkpoint_path, resume_from, save, meter, double_buffer,
):
    """:func:`minimizer_spectrum_file` over a mesh (JAX's ``mesh``
    branch): ASCII rows, the sketch's windows from the key-plane kernel on
    the card, a ``parallel.ShardedSpectrumAccumulator``."""
    from ..parallel.distributed import refuse_world_above_one
    from ..parallel.exact import (
        ShardedSpectrumAccumulator, _require_data_mesh, _stream_into,
    )
    from ..parallel.mesh import mesh_device

    n_data = _require_data_mesh(mesh)
    refuse_world_above_one(
        "minimizer_spectrum_file(mesh=...)", mesh, path, checkpoint_every,
        checkpoint_path, resume_from,
    )
    windows = _minimizer_windows_fn(
        k, w, False, normalized, mesh_device(mesh).type == "cuda"
    )
    acc = ShardedSpectrumAccumulator(
        mesh, k, normalized=normalized,
        shard_lanes=_count.SPARSE_FLUSH_LANES,  # the flat driver's flush
        window_fn=lambda s, l: windows(s, l, None),
        window_lanes=lambda max_l: max(max_l - k - w + 2, 0),
    )
    start_offset = n_bases = 0
    if ck is not None:
        start_offset, n_bases = ck["file_offset"], ck["n_bases"]
        acc.restore(ck["arrays"]["keys"], ck["arrays"]["counts"])
    t_wall0 = _time.perf_counter()
    n_bases = _stream_into(
        acc, mesh, path, k + w - 1, -(-batch_size // n_data), max_len,
        host_workers, spill_dir, False, normalized, False, False, ckpt_mode,
        start_offset, checkpoint_every,
        lambda offset, n_now: save(offset, n_now, acc), meter, double_buffer,
        n_bases,
    )
    t_drain = _time.perf_counter()
    keys, counts = acc.finish()
    result = (
        _count.spectrum_arrays_to_dict(keys, counts)
        if sparse_format == "dict" else (keys, counts)
    )
    if meter is not None:
        now = _time.perf_counter()
        meter.add("drain", now - t_drain)
        meter.add("wall", now - t_wall0, items=n_bases)
    return n_bases, result


def quality_filter_file(
    in_path,
    out_path,
    min_mean_quality: float,
    phred_offset: int = 33,
    batch_size: int = 4096,
    max_len: Optional[int] = None,
    device: Union[str, torch.device] = "cuda",
) -> Tuple[int, int]:
    """Write the reads of a FASTQ file whose mean Phred score is at least
    ``min_mean_quality`` to ``out_path``; returns ``(n_reads_in,
    n_reads_kept)``.

    The means are computed on the device (``quality.mean_quality``, JAX's
    float32 arithmetic step for step) and compared on the host as JAX's
    driver compares them; each kept read is written as
    ``@id\nseq\n+\nqual\n``, so the file equals the one JAX's
    ``quality_filter_file`` writes, byte for byte.  A FASTA input raises
    ``ValueError``.
    """
    from ..io.fast_batch import fast_read_batches
    from .quality import mean_quality

    dev = _resolve_device(device)
    to_device = _uploader(dev)
    n_in = n_kept = 0
    with open(out_path, "wb") as out:
        for batch in fast_read_batches(
            in_path, batch_size=batch_size, max_len=max_len, with_ids=True
        ):
            if batch.quals is None:
                raise ValueError("quality filtering needs FASTQ input")
            n = batch.num_reads
            n_in += n
            means = mean_quality(
                to_device(batch.quals), to_device(batch.lengths), phred_offset
            ).cpu().numpy()[:n]
            keep = np.flatnonzero(means >= min_mean_quality)
            lens = batch.lengths
            out.write(b"".join(
                b"@%s\n%s\n+\n%s\n" % (
                    bytes(batch.ids[i]),
                    batch.seqs[i, : int(lens[i])].tobytes(),
                    batch.quals[i, : int(lens[i])].tobytes(),
                )
                for i in keep
            ))
            n_kept += len(keep)
    return n_in, n_kept


def readme_pipeline(
    path,
    k: int = 4,
    target: bytes = b"AAAA",
    device: Union[str, torch.device] = "cuda",
) -> Tuple[int, int]:
    """The reference README example (ref src/lib.rs:6-40) on the device:
    total bases and the number of canonical ``target`` k-mers."""
    from ..io.fast_batch import fast_read_batches

    if len(target) != k:
        raise ValueError(f"target {target!r} is not a {k}-mer")
    dev = _resolve_device(device)
    hi, lo = pack_target(target)
    n_bases = 0
    n_matches = 0
    for batch in fast_read_batches(path, batch_size=512):
        n_bases += batch.num_bases
        if batch.max_len < k:
            continue
        seqs = torch.from_numpy(np.ascontiguousarray(batch.seqs)).to(dev)
        lengths = torch.from_numpy(batch.lengths.astype(np.int32)).to(dev)
        n_matches += int(canonical_match_count(seqs, lengths, hi, lo, k))
    return n_bases, n_matches
