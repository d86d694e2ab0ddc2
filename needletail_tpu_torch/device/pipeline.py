"""File-level drivers of the port.

Counterpart of ``needletail_tpu/device/pipeline.py``.  This slice ports the
hash-count path: FASTX file -> host framer -> one-buffer wire -> device
``unwire`` -> canonical k-mer hash keys -> 2^16-bin histogram -> int64
table.  The device steps are plain functions on tensors; PyTorch runs them
eagerly, so there is no per-configuration compile to cache.
"""

from __future__ import annotations

import time as _time
from typing import Optional, Tuple, Union

import numpy as np
import torch

from needletail_tpu.batch import length_wire_dtype
from needletail_tpu.utils.profiling import metered_iter

from . import kernels as _kernels
from .ops import _compose_le, resolve_vbits, unwire

__all__ = ["hash_count_file"]


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
    on_cuda = dev.type == "cuda"

    from ..checkpoint import (
        checkpoint_source,
        checkpointed_batches,
        counting_meta,
        prepare_checkpoint_stream,
        save_stream_checkpoint,
    )
    from ..io.framing import _make_batch_source

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
    if ckpt_mode:
        batches = checkpoint_source(
            path, batch_size, max_len, False, packed, normalized,
            start_offset, require_offsets=checkpoint_every is not None,
        )
    else:
        batches, _ = _make_batch_source(
            path, batch_size, max_len, host_workers,
            # the hash path never reads qualities
            with_quals=False, spill_dir=spill_dir,
            packed=packed, normalized=normalized,
        )

    def _transport_nbytes(batch) -> int:
        if packed:
            return batch.wire_nbytes()
        return batch.seqs.nbytes + batch.lengths.nbytes

    t_wall0 = _time.perf_counter()
    if meter is not None:
        batches = metered_iter(
            meter, "frame", batches,
            nbytes_of=_transport_nbytes, items_of=lambda b: b.num_bases,
        )

    def _to_device(arr: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if on_cuda:
            # pinned staging, so the copy is a true async DMA on the
            # current stream
            t = t.pin_memory().to(dev, non_blocking=True)
        return t

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

    if meter is not None:
        _place_inner = _place

        def _place(batch):  # noqa: F811 — metered twin
            if on_cuda:
                # start the clock on an idle stream: the transfer queues
                # behind the steps already enqueued
                torch.cuda.current_stream(dev).synchronize()
            t0 = _time.perf_counter()
            out = _place_inner(batch)
            if on_cuda and out[1] is not None:
                torch.cuda.current_stream(dev).synchronize()
            meter.add(
                "h2d",
                _time.perf_counter() - t0,
                nbytes=_transport_nbytes(batch),
                items=out[0],
            )
            return out

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

    if double_buffer:
        from needletail_tpu.io.feed import device_feed

        # framing and placement each in a feeder thread of their own
        placed = device_feed(device_feed(batches, lambda b: b), _place)
    else:
        placed = (_place(b) for b in batches)
    # wrap the placed stream, so a save fires only after the driver folded
    # each N-th batch (the feeders prefetch ahead of it)
    placed = checkpointed_batches(
        placed, checkpoint_every, _save_checkpoint, offset_of=lambda t: t[3]
    )
    if meter is not None:
        placed = metered_iter(meter, "wait", placed)
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
