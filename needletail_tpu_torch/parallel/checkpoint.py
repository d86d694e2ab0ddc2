"""Checkpoints of the sharded streaming states.

Counterpart of the sharded-state half of the JAX package's
``parallel/checkpoint.py``; the stream-checkpoint half (the drivers'
``kind`` files, among them ``sharded_multik``) is the port's
``checkpoint.py``, which the sharded drivers use as the flat ones do, and
which this module re-exports under the JAX module's names.
The files carry the JAX package's ``.npz`` keys, so either package loads
the other's.

Saving gathers the table shards to the host: every rank of the state's
group calls it, and rank 0 writes the file.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from ..checkpoint import (
    check_counting_meta,
    checkpoint_source,
    checkpointed_batches,
    counting_meta,
    load_resume_checkpoint,
    load_stream_checkpoint,
    prepare_checkpoint_stream,
    save_stream_checkpoint,
    validate_checkpoint_args,
)
from .mesh import mesh_device, mesh_shape
from .sharded import CountState, HashCountState

__all__ = [
    "CountCheckpoint",
    "save_count_state",
    "load_count_state",
    "save_hash_state",
    "load_hash_state",
    "load_stream_checkpoint",
    "save_stream_checkpoint",
    "load_resume_checkpoint",
    "counting_meta",
    "check_counting_meta",
    "validate_checkpoint_args",
    "checkpoint_source",
    "prepare_checkpoint_stream",
    "checkpointed_batches",
]


def _writes() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def _column(table: np.ndarray, mesh, dim: str) -> Tuple[torch.Tensor, object]:
    """This rank's slice of a whole table along ``dim`` on its device, and
    the group the slices gather over (None without a mesh)."""
    t = torch.from_numpy(np.asarray(table, dtype=np.int64))
    if mesh is None:
        return t, None
    n = mesh_shape(mesh)[dim]
    i = mesh.get_local_rank(dim)
    size = t.numel() // n
    return t[i * size : (i + 1) * size].to(mesh_device(mesh)), mesh.get_group(dim)


class CountCheckpoint:
    """In-memory view of a saved counting job."""

    def __init__(
        self,
        table: np.ndarray,
        n_bases: int,
        n_reads: int,
        byte_offset: int,
        k: int,
        path: Optional[str] = None,
    ) -> None:
        self.table = table
        self.n_bases = n_bases
        self.n_reads = n_reads
        self.byte_offset = byte_offset
        self.k = k
        self.path = path

    def to_state(self, mesh=None) -> CountState:
        """A ``CountState`` again: this rank's column over ``mesh``'s
        ``table`` dim on its device, or the whole table on the CPU."""
        column, group = _column(self.table, mesh, "table")
        return CountState(
            table_column=column,
            tallies=torch.tensor(
                [self.n_bases, self.n_reads], dtype=torch.int64,
                device=column.device,
            ),
            table_group=group,
        )


def save_count_state(
    path: Union[str, Path],
    state: CountState,
    byte_offset: int,
    k: int,
    input_path: Optional[str] = None,
) -> None:
    """Persist (the table gathered to the host, tallies, input byte
    offset); every rank calls it, rank 0 writes."""
    table = state.table
    if _writes():
        np.savez_compressed(
            path,
            table=table,
            n_bases=np.int64(state.n_bases),
            n_reads=np.int64(state.n_reads),
            byte_offset=np.int64(byte_offset),
            k=np.int32(k),
            input_path=np.bytes_(str(input_path or "")),
        )


def load_count_state(path: Union[str, Path]) -> CountCheckpoint:
    with np.load(path, allow_pickle=False) as z:
        return CountCheckpoint(
            table=z["table"],
            n_bases=int(z["n_bases"]),
            n_reads=int(z["n_reads"]),
            byte_offset=int(z["byte_offset"]),
            k=int(z["k"]),
            path=bytes(z["input_path"]).decode() or None,
        )


def save_hash_state(
    path: Union[str, Path],
    state: HashCountState,
    byte_offset: int,
    k: int,
    input_path: Optional[str] = None,
) -> None:
    """Persist the hash-pipeline state (the table gathered to the host,
    tallies, input byte offset); every rank calls it, rank 0 writes.
    Integer adds commute, so resuming from a record-aligned offset
    reproduces the exact final table."""
    table = state.table
    if _writes():
        np.savez_compressed(
            path,
            table=table,
            total=np.int64(state.total),
            fwd=np.int64(state.fwd),
            byte_offset=np.int64(byte_offset),
            k=np.int32(k),
            input_path=np.bytes_(str(input_path or "")),
        )


def load_hash_state(
    path: Union[str, Path], mesh=None
) -> Tuple[HashCountState, int, int, Optional[str]]:
    """``(state, byte_offset, k, input_path)``: with a mesh the state
    holds this rank's shard over its ``data`` dim, on its device."""
    with np.load(path, allow_pickle=False) as z:
        shard, group = _column(z["table"], mesh, "data")
        state = HashCountState(
            table_shard=shard,
            tallies=torch.tensor(
                [int(z["total"]), int(z["fwd"])], dtype=torch.int64,
                device=shard.device,
            ),
            group=group,
        )
        return (
            state,
            int(z["byte_offset"]),
            int(z["k"]),
            bytes(z["input_path"]).decode() or None,
        )
