"""Device meshes over ``torch.distributed`` ranks.

Counterpart of ``needletail_tpu/parallel/mesh.py``.  One process drives one
device (``cuda:<local rank>``, or the CPU where the caller asks), so a mesh
is a ``DeviceMesh`` of ranks with the dims:

  * ``data``  — read batches are sharded across this dim (the only
    semantically meaningful batch parallelism for FASTX work);
  * ``table`` — the count table's key space is sharded across this dim;
    each rank owns a contiguous ``4^k / table`` slice of the spectrum.

Rank ``d * table + t`` sits at ``[d, t]``, as JAX lays devices out, and a
collective over one dim runs on ``mesh.get_group(dim)``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

__all__ = [
    "make_mesh", "mesh_shape_for", "mesh_shape", "mesh_device", "mesh_device_for",
]


def mesh_shape_for(n_devices: int) -> Tuple[int, int]:
    """Pick a (data, table) factorization: table gets the smaller power-of-two
    factor (<= 4 and never more than data) so most parallelism serves read
    throughput — table columns replicate extraction in the dense design."""
    table = 1
    remaining = n_devices
    while table < 4 and remaining % 2 == 0 and remaining // 2 >= table * 2:
        table *= 2
        remaining //= 2
    return remaining, table


def make_mesh(
    data: Optional[int] = None,
    table: Optional[int] = None,
    device_type: Optional[str] = None,
) -> DeviceMesh:
    """A ``(data, table)`` mesh over every rank of the default group
    (``distributed.initialize`` first).  ``device_type`` defaults to
    ``"cuda"`` when the group runs NCCL and ``"cpu"`` when it runs gloo."""
    if not dist.is_initialized():
        raise RuntimeError(
            "no process group: call parallel.distributed.initialize() first"
        )
    n = dist.get_world_size()
    if data is None and table is None:
        data, table = mesh_shape_for(n)
    elif data is None:
        data = n // table
    elif table is None:
        table = n // data
    if data * table != n:
        raise ValueError(f"mesh {data}x{table} != {n} devices")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(
        device_type,
        torch.arange(n).reshape(data, table),
        mesh_dim_names=("data", "table"),
    )


def mesh_shape(mesh) -> Dict[str, int]:
    """``{dim name: size}`` of a mesh (JAX's ``mesh.shape``); a value that
    is no named ``DeviceMesh`` raises ``TypeError``."""
    if not isinstance(mesh, DeviceMesh) or mesh.mesh_dim_names is None:
        raise TypeError(
            f"mesh must be a torch DeviceMesh with named dims (make_mesh), "
            f"got {type(mesh).__name__}"
        )
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank drives on ``mesh``: the current CUDA device
    (``initialize`` set it to the local rank), or the CPU."""
    mesh_shape(mesh)
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def mesh_device_for(mesh: DeviceMesh, device) -> torch.device:
    """:func:`mesh_device`, for a driver that also takes ``device=``: a
    ``device`` of another type (or CUDA index) than the mesh's raises
    ``ValueError`` rather than running elsewhere than asked."""
    dev = mesh_device(mesh)
    asked = torch.device(device)
    if asked.type != dev.type or asked.index not in (None, dev.index):
        raise ValueError(
            f"device={str(device)!r} but the mesh runs on {dev}; pass "
            f"device={dev.type!r} with this mesh"
        )
    return dev
