"""Processes and per-rank input partitioning on ``torch.distributed``.

Counterpart of ``needletail_tpu/parallel/distributed.py``.  One process
drives one device: ``initialize`` starts the process group (NCCL with the
card, gloo with the CPU; neither falls back to the other), and every rank
frames its own record-aligned byte range of the input (``split_fastx_ranges``,
the port's splitter in ``io/framing.py``), as the JAX package's multi-host
recipe does.

Ranks see different numbers of batches, and a collective one rank enters
while another never reaches it hangs both.  So the drivers step in
lockstep: every step starts with one small all-reduce (MAX) of "I still
have a batch" (:func:`lockstep`), and a rank that has run out steps
inertly.  Such host votes ride a gloo group beside the mesh's data group
(:func:`control_group`), so deciding them never waits on the device.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from ..errors import ParseError
from ..io.compression import sniff_compression
from ..io.fast_batch import RangeStream
from ..io.framing import split_fastx_ranges
from ..parser import FastaReader, FastqReader, FastxReader
from .mesh import mesh_device, mesh_shape

__all__ = [
    "initialize",
    "shutdown",
    "split_fastx_ranges",
    "read_range",
    "host_shard_ranges",
]


def initialize(
    init_method: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device: Union[str, torch.device] = "cuda",
) -> None:
    """Start the default process group (a no-op when one exists).

    ``device="cuda"`` runs NCCL, sets this process's card (its local rank)
    before the group exists, and raises when CUDA is absent;
    ``device="cpu"`` runs gloo.  Under ``torchrun`` the rank, world size
    and local rank come from its environment (``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``).  Otherwise ``num_processes in (None, 1)`` starts a
    world of one on an in-process store, and a larger world needs
    ``init_method`` (``tcp://host:port`` or ``file://path``) and
    ``process_id``.  End with :func:`shutdown`.
    """
    if dist.is_initialized():
        return
    dev = torch.device(device)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    on_cuda = dev.type == "cuda"
    if on_cuda and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} but CUDA is not available; pass "
            "device='cpu' to run gloo and the plain PyTorch versions"
        )
    env = os.environ
    if num_processes is None and "RANK" in env and "WORLD_SIZE" in env:
        rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
        local = int(env.get("LOCAL_RANK", rank))
        kwargs = dict(init_method=init_method or "env://")
    elif num_processes in (None, 1):
        rank, world, local = 0, 1, 0
        kwargs = dict(store=dist.HashStore())
    else:
        if init_method is None or process_id is None:
            raise ValueError(
                "a world above one needs init_method and process_id (or "
                "torchrun's RANK/WORLD_SIZE environment)"
            )
        rank, world = int(process_id), int(num_processes)
        local = rank % torch.cuda.device_count() if on_cuda else 0
        kwargs = dict(init_method=init_method)
    if on_cuda:
        torch.cuda.set_device(local)
    dist.init_process_group(
        "nccl" if on_cuda else "gloo", rank=rank, world_size=world, **kwargs
    )


# gloo groups for the host votes, by the name of the data group they shadow;
# they end with the default group
_CONTROL: Dict[str, "dist.ProcessGroup"] = {}


def shutdown() -> None:
    """Destroy the process group and every group made over it."""
    _CONTROL.clear()
    if dist.is_initialized():
        dist.destroy_process_group()


def data_rank(mesh) -> Tuple[int, int]:
    """``(size of the data dim, this rank's index along it)``."""
    return mesh_shape(mesh)["data"], mesh.get_local_rank("data")


def control_group(mesh) -> "dist.ProcessGroup":
    """A gloo group over the ranks of ``mesh``'s data dim, for votes on
    host values: the data group itself where it runs gloo."""
    mesh_shape(mesh)
    group = mesh.get_group("data")
    if dist.get_backend(group) == "gloo":
        return group
    name = group.group_name
    if name not in _CONTROL:
        _CONTROL[name] = dist.new_group(
            dist.get_process_group_ranks(group), backend="gloo",
            use_local_synchronization=True,
        )
    return _CONTROL[name]


def vote(values: Sequence[int], group) -> List[int]:
    """The elementwise maximum of ``values`` over ``group``'s ranks (a
    host all-reduce; every rank of the group must call it)."""
    t = torch.tensor(list(values), dtype=torch.int64)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return t.tolist()


def total(value: int, group) -> int:
    """The sum of a host integer over ``group``'s ranks."""
    t = torch.tensor([int(value)], dtype=torch.int64)
    dist.all_reduce(t, group=group)
    return int(t[0])


_DONE, _HAVE, _FAILED = 0, 1, 2


def lockstep(items: Iterable, group) -> Iterator:
    """Yield this rank's items, then None, until every rank of ``group``
    has run out.  Each step starts with a MAX vote of "I still have an
    item"; a rank whose source raised votes failure, and then every rank
    raises instead of waiting in a collective the failed rank never
    reaches."""
    it = iter(items)
    try:
        while True:
            error = None
            try:
                item = next(it)
                mine = _HAVE
            except StopIteration:
                item, mine = None, _DONE
            except Exception as exc:  # re-raised after the vote
                item, mine, error = None, _FAILED, exc
            agreed = vote([mine], group)[0]
            if agreed == _FAILED:
                if error is not None:
                    raise error
                raise RuntimeError(
                    "another rank failed while framing its input (its own "
                    "error says why)"
                )
            if agreed == _DONE:
                return
            yield item
    finally:
        close = getattr(it, "close", None)
        if close is not None:
            close()


def gather_table(shard: torch.Tensor, group) -> np.ndarray:
    """The whole table from every rank's equal 1-D ``shard``, in rank
    order, as a host numpy array: an all-gather over ``group`` (every rank
    of it calls this); ``group`` None means the shard is the whole."""
    n = 1 if group is None else dist.get_world_size(group)
    if n > 1:
        whole = shard.new_empty(n * shard.numel())
        dist.all_gather_into_tensor(whole, shard.contiguous(), group=group)
        shard = whole
    return shard.cpu().numpy()


def _is_compressed(path) -> bool:
    with open(path, "rb") as f:
        magic = f.read(2)
    return len(magic) == 2 and sniff_compression(magic) is not None


def _paths_of(path) -> list:
    return list(path) if isinstance(path, (list, tuple)) else [path]


def refuse_world_above_one(
    driver: str, mesh, path, checkpoint_every=None, checkpoint_path=None,
    resume_from=None,
) -> None:
    """Raise, on every rank and before any collective, what a world above
    one cannot run: a compressed input (its byte ranges do not exist) and
    checkpoints (a checkpoint holds one input offset)."""
    n_data, _ = data_rank(mesh)
    if n_data == 1:
        return
    if any(v is not None for v in (checkpoint_every, checkpoint_path, resume_from)):
        raise ValueError(
            f"{driver}: checkpoint/resume needs a world of one (a "
            f"checkpoint holds one input offset; this world has {n_data} "
            "data ranks)"
        )
    for p in _paths_of(path):
        if str(p) == "-" or _is_compressed(p):
            raise ValueError(
                f"{driver}: a world of {n_data} data ranks splits its input "
                f"by byte range, and {str(p)!r} has none (stdin or a "
                "compressed stream); decompress it or run a world of one"
            )


def rank_batch_source(
    path, mesh, batch_size: int, max_len, host_workers, spill_dir, packed,
    normalized, ckpt_mode=False, start_offset=0, checkpoint_every=None,
    with_quals=False, bucketed=False,
):
    """This rank's framed batches of ``batch_size`` rows.  A world of one
    frames the whole input through the flat drivers' front (compressed
    input, spill, bucketed, checkpoints); a larger one frames range
    ``rank`` of ``split_fastx_ranges(path, n_data)`` of each file: in the
    rank's own process by default, through a spawn pool of
    ``host_workers`` processes where ``host_workers > 1``."""
    from ..device.pipeline import _batch_source
    from ..io.framing import _make_batch_source

    n_data, rank = data_rank(mesh)
    if n_data == 1:
        return _batch_source(
            path, batch_size, max_len, host_workers, spill_dir, packed,
            normalized, ckpt_mode, start_offset, checkpoint_every,
            with_quals=with_quals, bucketed=bucketed,
        )
    paths = _paths_of(path)
    if bucketed and len(paths) > 1:
        raise ValueError("bucketed framing is single-file; pass one path")

    def batches():
        for p in paths:
            byte_range = split_fastx_ranges(p, n_data)[rank]
            if bucketed:
                from ..io.bucketed import bucketed_read_batches

                yield from bucketed_read_batches(
                    p, batch_size=batch_size, max_len=max_len,
                    byte_range=byte_range,
                )
                continue
            src, _ = _make_batch_source(
                p, batch_size, max_len, host_workers, with_quals=with_quals,
                spill_dir=spill_dir, packed=packed, normalized=normalized,
                byte_range=byte_range,
            )
            yield from src

    return batches()


def run_rank_stream(
    mesh, batches, place, fold, *, packed, meter=None, double_buffer=True,
    checkpoint_every=None, save_checkpoint=None, ship_quals=False,
    n_bases=0,
) -> int:
    """Drive this rank's ``batches`` in lockstep with the other ranks and
    return the bases of every rank.

    ``place(batch)`` gives ``(num_bases, payload, layout, file_offset)``
    (``pipeline._place_fn``); ``fold(payload, layout)`` runs one step,
    with ``(None, None)`` where this rank has no batch or no window fits,
    and must then still join the step's collectives.
    ``save_checkpoint(offset, n_bases)`` fires as in the flat drivers;
    ``meter`` records their stages and ``dispatch``.
    """
    import time as _time

    from ..device.pipeline import _placed_stream

    local = [n_bases]

    def save(offset):
        save_checkpoint(offset, local[0])

    placed = _placed_stream(
        batches, place, mesh_device(mesh), packed, meter, double_buffer,
        checkpoint_every, save, ship_quals=ship_quals,
    )
    for item in lockstep(placed, control_group(mesh)):
        if item is None:
            fold(None, None)
            continue
        nb, payload, layout, _offset = item
        local[0] += nb
        t0 = _time.perf_counter() if meter is not None else 0.0
        fold(payload, layout)
        if meter is not None:
            meter.add("dispatch", _time.perf_counter() - t0, items=nb)
    return total(local[0], control_group(mesh))


def read_range(path: Union[str, Path], start: int, end: int) -> FastxReader:
    """Streaming reader over one record-aligned byte range of ``path``."""
    with open(path, "rb") as f:
        first = f.read(1)
    if first not in (b">", b"@"):
        # a compressed or non-FASTX file must not become a misparsing reader
        raise ParseError.new_unknown_format(first[0] if first else 0)
    stream = RangeStream(path, start, end)
    if first == b">":
        return FastaReader(stream)
    return FastqReader(stream)


def host_shard_ranges(path: Union[str, Path]) -> Tuple[int, int]:
    """This process's byte range of ``path`` in the default group."""
    return split_fastx_ranges(path, dist.get_world_size())[dist.get_rank()]


def to_device(arr, dev: torch.device) -> torch.Tensor:
    """A numpy array or tensor on ``dev``."""
    if isinstance(arr, np.ndarray):
        arr = torch.from_numpy(np.ascontiguousarray(arr))
    return arr.to(dev)
