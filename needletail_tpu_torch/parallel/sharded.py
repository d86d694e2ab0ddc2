"""Sharded k-mer counting: data-parallel reads, table-parallel spectra.

Counterpart of ``needletail_tpu/parallel/sharded.py`` on
``torch.distributed``, one process a device.

  * The dense table: reads shard over the whole mesh (every rank extracts
    only its own rows); each rank histograms its windows into a full
    local ``[4^k]`` table (``count.dense_spectrum``: the 2^16-bin
    histogram kernel on the card for k <= 9), then one reduce-scatter over
    ``table`` hands column ``t`` the key range ``[t*S, (t+1)*S)``, ``S =
    4^k / table``, and an all-reduce over ``data`` merges the data rows.
  * The hash pipeline (the deployment design): every rank runs the
    hash-keys and histogram kernels on its own read shard, and one
    reduce-scatter of the ``[2^table_bits]`` local table over ``data``
    leaves rank d owning the bins ``[d*2^tb/N, (d+1)*2^tb/N)``; the total
    and forward tallies all-reduce over ``data``.

Per-step increments ride the collectives as int32 (they are bounded by the
batch's lanes); each owner accumulates its bins in int64.  Integer adds
commute, so every table equals the single-device one bit for bit.  The
collectives run on the mesh's groups (NCCL on the card), enqueued on the
current stream; nothing waits on the device until a table is read.
"""

from __future__ import annotations

import time as _time
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..device import count as _count
from ..device import kernels as _kernels
from ..device import kmers as _kmers
from .distributed import gather_table, to_device
from .mesh import mesh_device, mesh_shape

__all__ = [
    "sharded_spectrum",
    "CountState",
    "init_count_state",
    "make_update_step",
    "update_count_state",
    "HashCountState",
    "make_hash_update_step",
    "sharded_hash_count_file",
]


def _check_dense_k(k: int) -> None:
    """The dense sharded table keys on ``win.lo`` alone, the full k-mer
    only for k <= 15; dense tables stop at MAX_DENSE_K anyway."""
    if not 1 <= k <= _count.MAX_DENSE_K:
        raise ValueError(
            f"dense sharded spectrum needs k in [1, {_count.MAX_DENSE_K}], "
            f"got {k}; use make_hash_update_step for larger k"
        )


def _shard_rows(mesh, n_rows: int, dims=("data", "table")) -> slice:
    """This rank's rows of a global batch of ``n_rows`` sharded over
    ``dims`` (flattened, rank ``d * table + t``)."""
    shape = mesh_shape(mesh)
    n, idx = 1, 0
    for dim in dims:
        idx = idx * shape[dim] + mesh.get_local_rank(dim)
        n *= shape[dim]
    if n_rows % n:
        raise ValueError(
            f"batch rows {n_rows} must be divisible by the {n} shards; "
            "pad with ReadBatch.pad_reads_to"
        )
    rows = n_rows // n
    return slice(idx * rows, (idx + 1) * rows)


def _place_rows(mesh, dims, *arrays):
    """This rank's rows of each global host array, on its device (None
    stays None)."""
    dev = mesh_device(mesh)
    rows = _shard_rows(mesh, arrays[0].shape[0], dims)
    return tuple(None if a is None else to_device(a[rows], dev) for a in arrays)


def _local_partial_spectrum(mesh, seqs, lengths, k, canonical, normalized):
    """This rank's column of the merged spectrum, int32 ``[4^k / table]``:
    the local histogram, reduce-scattered over ``table``, all-reduced
    over ``data``."""
    fn = _kmers.canonical_kmers if canonical else _kmers.pack_kmers
    local = _count.dense_spectrum(fn(seqs, lengths, k, normalized=normalized), k)
    part = local.new_empty(local.numel() // mesh_shape(mesh)["table"])
    dist.reduce_scatter_tensor(part, local, group=mesh.get_group("table"))
    dist.all_reduce(part, group=mesh.get_group("data"))
    return part


def sharded_spectrum(
    mesh,
    seqs,
    lengths,
    k: int,
    canonical: bool = True,
    normalized: bool = True,
) -> torch.Tensor:
    """This rank's column of the global dense spectrum: int32 ``[4^k /
    table]``, the bins ``[t*S, (t+1)*S)`` of its ``table`` index ``t``.

    ``seqs``/``lengths`` are the global batch (every rank passes the
    same); its rows must divide over data*table, and each rank extracts
    only its own rows.
    """
    _check_dense_k(k)
    s, l = _place_rows(mesh, ("data", "table"), seqs, lengths)
    return _local_partial_spectrum(mesh, s, l, k, canonical, normalized)


@dataclass
class CountState:
    """Streaming dense count-table state: this rank's int64 column of the
    global spectrum (the bins of its ``table`` index), and the base and
    read tallies of every rank (``[n_bases, n_reads]``).  ``.table``
    gathers the columns over ``table_group`` (a collective: every rank
    reads it); ``table_group`` None means the column is the whole
    table."""

    table_column: torch.Tensor
    tallies: torch.Tensor
    table_group: Optional["dist.ProcessGroup"] = None

    @property
    def table(self) -> np.ndarray:
        """int64 ``[4^k]`` numpy copy of the whole table (syncs)."""
        return gather_table(self.table_column, self.table_group)

    @property
    def n_bases(self) -> int:
        return int(self.tallies[0])

    @property
    def n_reads(self) -> int:
        return int(self.tallies[1])


def init_count_state(mesh, k: int) -> CountState:
    """Zero state with the table laid out across the ``table`` dim."""
    _check_dense_k(k)
    dev = mesh_device(mesh)
    return CountState(
        table_column=torch.zeros(
            4**k // mesh_shape(mesh)["table"], dtype=torch.int64, device=dev
        ),
        tallies=torch.zeros(2, dtype=torch.int64, device=dev),
        table_group=mesh.get_group("table"),
    )


def make_update_step(
    mesh,
    k: int,
    canonical: bool = True,
    normalized: bool = True,
):
    """The streaming step and its placement: ``(step, place_batch)``.

    ``place_batch(seqs, lengths)`` puts this rank's rows of a global host
    batch on its device; ``step(state, seqs, lengths) -> state`` adds the
    placed rows of every rank to the table columns (a new state; the old
    one stays readable).
    """
    _check_dense_k(k)
    world = (mesh.get_group("table"), mesh.get_group("data"))

    def step(state: CountState, seqs, lengths) -> CountState:
        part = _local_partial_spectrum(
            mesh, seqs, lengths, k, canonical, normalized
        )
        # rows carrying bases only, so zero-padded rows do not count
        tallies = torch.stack([
            lengths.to(torch.int64).sum(), (lengths > 0).sum(dtype=torch.int64)
        ])
        for group in world:
            dist.all_reduce(tallies, group=group)
        return CountState(
            state.table_column + part, state.tallies + tallies,
            state.table_group,
        )

    def place_batch(seqs, lengths):
        return _place_rows(mesh, ("data", "table"), seqs, lengths)

    return step, place_batch


def update_count_state(mesh, state: CountState, seqs, lengths, k: int) -> CountState:
    """One step over a global host batch (``make_update_step``'s step and
    placement); the caller's state stays readable."""
    step, place = make_update_step(mesh, k)
    return step(state, *place(seqs, lengths))


# ---------------------------------------------------------------------------
# the hash pipeline: the hand kernels inside each rank's step
# ---------------------------------------------------------------------------


@dataclass
class HashCountState:
    """Streaming hash-spectrum state: this rank's int64 shard of the
    ``[2^table_bits]`` table (the contiguous bins it owns over ``data``)
    and the int64 ``[total, fwd]`` tallies of every rank.  ``.table``
    gathers the shards over ``group`` (a collective: every rank reads
    it); ``group`` None means the shard is the whole table."""

    table_shard: torch.Tensor
    tallies: torch.Tensor
    group: Optional["dist.ProcessGroup"] = None

    @property
    def table(self) -> np.ndarray:
        """int64 ``[2^table_bits]`` numpy copy of the whole table (syncs)."""
        return gather_table(self.table_shard, self.group)

    @property
    def total(self) -> int:
        """Valid canonical windows counted so far."""
        return int(self.tallies[0])

    @property
    def fwd(self) -> int:
        """Windows where the forward strand won."""
        return int(self.tallies[1])


def make_hash_update_step(
    mesh,
    k: int,
    table_bits: int = 16,
    normalized: bool = True,
    packed: bool = False,
):
    """The hash-counting step over the ``data`` dim of ``mesh`` (its
    ``table`` dim, if any, must be 1: this table shards over ``data``).

    Returns ``(init, step, place_batch)``.  ``step(state, seqs, lengths,
    vbits=None) -> state`` counts this rank's placed rows: ASCII ``seqs``,
    or with ``packed=True`` the 2-bit ``codes`` ``[R, L/4]`` and their
    validity plane (None for clean rows).  ``step(state)`` with no rows
    is this rank's inert step: it adds nothing and joins the collectives
    the other ranks' steps run.  ``place_batch(seqs, lengths, vbits=None)``
    puts this rank's rows of a global host batch on its device.
    """
    shape = mesh_shape(mesh)
    n_data = shape["data"]
    if shape.get("table", 1) != 1:
        raise ValueError(
            "hash pipeline shards its table over 'data'; use a mesh with "
            f"table=1 (got table={shape['table']})"
        )
    if table_bits > 16:
        raise ValueError("the histogram shard is 2^16 bins; table_bits <= 16")
    n_bins = 1 << table_bits
    if n_bins % n_data:
        raise ValueError(f"2^{table_bits} bins not divisible by data={n_data}")
    dev = mesh_device(mesh)
    group = mesh.get_group("data")

    def init() -> HashCountState:
        return HashCountState(
            torch.zeros(n_bins // n_data, dtype=torch.int64, device=dev),
            torch.zeros(2, dtype=torch.int64, device=dev),
            group,
        )

    def step(state: HashCountState, seqs=None, lengths=None, vbits=None):
        if seqs is None:
            local = torch.zeros(n_bins, dtype=torch.int32, device=dev)
            tallies = torch.zeros(2, dtype=torch.int64, device=dev)
        else:
            if packed:
                keys, total, fwd = _kernels.canonical_hash_keys_packed(
                    seqs, vbits, lengths, k, table_bits=table_bits
                )
            else:
                keys, total, fwd = _kernels.canonical_hash_keys(
                    seqs, lengths, k, table_bits=table_bits,
                    normalized=normalized,
                )
            # keys are masked to table_bits: the bins past 2^table_bits of
            # the 2^16-bin kernel stay zero, so the slice is exact
            local = _kernels.mxu_histogram16(keys)[:n_bins]
            tallies = torch.stack([total, fwd]).to(torch.int64)
        part = local.new_empty(n_bins // n_data)
        dist.reduce_scatter_tensor(part, local, group=group)
        dist.all_reduce(tallies, group=group)
        return HashCountState(
            state.table_shard + part, state.tallies + tallies, state.group
        )

    def place_batch(seqs, lengths, vbits=None):
        return _place_rows(mesh, ("data",), seqs, lengths, vbits)

    return init, step, place_batch


def sharded_hash_count_file(
    path,
    k: int,
    mesh,
    table_bits: int = 16,
    batch_size: int = 65536,
    max_len: Optional[int] = None,
    normalized: bool = True,
    host_workers: Optional[int] = None,
    spill_dir: Optional[str] = None,
    packed: Optional[bool] = None,
    checkpoint_every: Optional[int] = None,
    checkpoint_path: Optional[str] = None,
    resume_from: Optional[str] = None,
    meter=None,
    double_buffer: bool = True,
) -> Tuple[int, int, int, np.ndarray]:
    """The mesh twin of ``pipeline.hash_count_file``: ``(n_bases, total,
    fwd, table)`` on every rank, the table bit-identical to the flat
    driver's.

    Each rank frames its own input (the whole of it in a world of one;
    its byte range in a larger one, where compressed input and
    checkpoints raise ``ValueError`` up front) in batches of
    ``batch_size / data`` rows, runs the hash-keys and histogram kernels
    on them, and the reduce-scatter merges every rank's histogram into
    the bins each owns (``make_hash_update_step``).  ``packed`` (default
    on) ships the 2-bit wire, else ASCII.  Checkpoints are the flat
    driver's ``kind="hash"`` files (global table, tallies, record-aligned
    offset), so a stream checkpointed by either driver resumes on the
    other.  ``meter=`` records ``frame``, ``h2d``, ``wait``, ``dispatch``
    (enqueueing a step and its collectives), ``drain`` and ``wall``.
    """
    from ..checkpoint import (
        counting_meta, prepare_checkpoint_stream, save_stream_checkpoint,
    )
    from ..device.pipeline import _device_args, _place_fn, _uploader
    from .distributed import (
        data_rank, rank_batch_source, refuse_world_above_one, run_rank_stream,
    )

    if packed is None:
        packed = True
    init, step, _ = make_hash_update_step(
        mesh, k, table_bits=table_bits, normalized=normalized, packed=packed
    )
    n_data, rank = data_rank(mesh)
    refuse_world_above_one(
        "sharded_hash_count_file", mesh, path, checkpoint_every,
        checkpoint_path, resume_from,
    )

    def _validate(ck):
        bits = int(ck["meta"].get("table_bits", table_bits))
        if bits != table_bits:
            raise ValueError(
                f"checkpoint {resume_from!r} has table_bits={bits}, "
                f"expected {table_bits}"
            )

    ckpt_mode, ck = prepare_checkpoint_stream(
        "hash", k,
        checkpoint_every=checkpoint_every, checkpoint_path=checkpoint_path,
        resume_from=resume_from, host_workers=host_workers,
        validate=_validate, normalized=normalized,
    )
    state = init()
    n_bases = start_offset = 0
    if ck is not None:
        start_offset, n_bases = ck["file_offset"], ck["n_bases"]
        shard = state.table_shard.numel()
        table = np.asarray(ck["arrays"]["table"], dtype=np.int64)
        state.table_shard.copy_(
            torch.from_numpy(table[rank * shard : (rank + 1) * shard])
        )
        state.tallies.copy_(torch.tensor(
            [int(ck["meta"]["total"]), int(ck["meta"]["fwd"])]
        ))

    def _save_ckpt(offset, n_bases_now):
        save_stream_checkpoint(
            checkpoint_path, "hash", k, offset, n_bases_now,
            {"table": state.table}, input_path=str(path),
            meta={
                "table_bits": np.int32(table_bits),
                "total": np.int64(state.total),
                "fwd": np.int64(state.fwd),
                **counting_meta(normalized=normalized),
            },
        )

    def fold(payload, layout):
        nonlocal state
        if payload is None:
            state = step(state)
        else:
            state = step(state, *_device_args(payload, layout))

    t_wall0 = _time.perf_counter()
    batches = rank_batch_source(
        path, mesh, -(-batch_size // n_data), max_len, host_workers,
        spill_dir, packed, normalized, ckpt_mode, start_offset,
        checkpoint_every,
    )
    n_bases = run_rank_stream(
        mesh, batches, _place_fn(_uploader(mesh_device(mesh)), k, packed),
        fold, packed=packed, meter=meter, double_buffer=double_buffer,
        checkpoint_every=checkpoint_every, save_checkpoint=_save_ckpt,
        n_bases=n_bases,
    )
    t_drain = _time.perf_counter()
    table = state.table
    total, fwd = state.total, state.fwd
    if meter is not None:
        now = _time.perf_counter()
        meter.add("drain", now - t_drain, nbytes=table.nbytes)
        meter.add("wall", now - t_wall0, items=n_bases)
    return n_bases, total, fwd, table
