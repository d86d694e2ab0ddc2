"""A dry run of the sharded paths on the current process group.

    python -m needletail_tpu_torch.dryrun [--device cpu]
    torchrun --nproc-per-node=N -m needletail_tpu_torch.dryrun

Counterpart of ``dryrun_multichip`` in the JAX package's
``__graft_entry__.py``: on tiny shapes it checks

  * one step of the dense table over the default ``(data, table)`` mesh;
  * one hash step over a data-only mesh, ASCII and packed, bit-equal;
  * ``sharded_hash_count_file`` over a framed FASTQ, bit-equal to the flat
    ``hash_count_file``;
  * a BGZF mid-stream checkpoint resumed by ``sharded_hash_count_file``,
    bit-equal to the uninterrupted run.

Checkpoints are a world of one's: in a larger world each rank resumes
its own on a mesh of itself.  Every check is exact (tolerance 0) and
raises ``AssertionError`` when it fails.
"""

from __future__ import annotations

import os
import shutil
import tempfile

import numpy as np
import torch.distributed as dist


def _own_mesh(mesh):
    """``mesh`` in a world of one; else a one-rank mesh of each rank."""
    from torch.distributed.device_mesh import DeviceMesh

    from .parallel.distributed import data_rank

    if data_rank(mesh)[0] == 1:
        return mesh
    own, _ = dist.new_subgroups(group_size=1)
    return DeviceMesh.from_group(
        [own, own], mesh.device_type, mesh=[[dist.get_rank()]],
        mesh_dim_names=("data", "table"),
    )


def dryrun() -> str:
    """Run the checks on the current group (``parallel.distributed
    .initialize`` first) and return a one-line summary."""
    from .checkpoint import load_stream_checkpoint, save_stream_checkpoint
    from .device.pipeline import hash_count_file
    from .encoding import pack_codes_host_rows
    from .io.bgzf import write_bgzf
    from .io.fast_batch import fast_read_batches_bgzf
    from .parallel import (
        init_count_state, make_hash_update_step, make_mesh,
        sharded_hash_count_file,
    )
    from .parallel.mesh import mesh_device, mesh_shape
    from .parallel.sharded import make_update_step

    world = dist.get_world_size()
    rng = np.random.default_rng(1)

    # the dense table over data x table
    mesh = make_mesh()
    k = 6
    step, place = make_update_step(mesh, k)
    b = max(2 * world, 8)
    seqs = rng.choice(np.frombuffer(b"ACGTN", np.uint8), size=(b, 128))
    lengths = np.full(b, 128, np.int32)
    state = step(init_count_state(mesh, k), *place(seqs, lengths))
    table = state.table
    assert table.shape == (4**k,) and table.sum() > 0, "empty dense table"
    assert state.n_bases == b * 128, state.n_bases

    # the hash step over a data-only mesh, ASCII and packed
    hmesh = make_mesh(data=world, table=1)
    hb = max(8 * world, 8)
    hseqs = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=(hb, 128))
    hlengths = np.full(hb, 128, np.int32)
    init, hstep, hplace = make_hash_update_step(hmesh, 21)
    hstate = hstep(init(), *hplace(hseqs, hlengths)[:2])
    htable = hstate.table
    assert htable.sum() == hstate.total > 0, (htable.sum(), hstate.total)
    codes, vbits, _ = pack_codes_host_rows(hseqs, hlengths)
    pinit, pstep, pplace = make_hash_update_step(hmesh, 21, packed=True)
    pstate = pstep(pinit(), *pplace(codes, hlengths, vbits))
    assert pstate.total == hstate.total, (pstate.total, hstate.total)
    assert np.array_equal(pstate.table, htable), "packed step != ASCII step"

    # the file driver over a framed FASTQ, against the flat driver
    dev = mesh_device(hmesh)
    parts = []
    for i in range(64):
        n = int(rng.integers(40, 120))
        read = rng.choice(np.frombuffer(b"ACGT", np.uint8), n).tobytes()
        parts.append(b"@r%d\n" % i + read + b"\n+\n" + b"I" * n + b"\n")
    raw = b"".join(parts) * 4
    tmp = tempfile.mkdtemp(prefix="needletail_dryrun_")
    try:
        fq = os.path.join(tmp, "reads.fq")
        with open(fq, "wb") as f:
            f.write(raw)
        kw = dict(batch_size=64, max_len=128, host_workers=1)
        flat = hash_count_file(fq, 21, device=dev, **kw)
        got = sharded_hash_count_file(fq, 21, hmesh, **kw)
        assert got[:3] == flat[:3], (got[:3], flat[:3])
        assert np.array_equal(got[3], flat[3]), "sharded table != flat table"

        # a BGZF mid-stream checkpoint: checkpoint the decompressed prefix,
        # rebase it onto the whole file, resume
        own = _own_mesh(hmesh)
        bgz = os.path.join(tmp, "reads.fq.bgz")
        write_bgzf(raw, bgz, block_size=4096)
        it = iter(fast_read_batches_bgzf(bgz, 0, batch_size=64, max_len=128))
        next(it)
        offset = next(it).file_offset
        it.close()
        assert offset is not None, "BGZF batches report no offsets"
        prefix = os.path.join(tmp, "prefix.fq.bgz")
        write_bgzf(raw[:offset], prefix, block_size=4096)
        ck = os.path.join(tmp, "mid.npz")
        sharded_hash_count_file(
            prefix, 21, own, checkpoint_every=1, checkpoint_path=ck, **kw
        )
        mid = load_stream_checkpoint(ck)
        save_stream_checkpoint(
            ck, "hash", 21, offset, mid["n_bases"],
            {"table": mid["arrays"]["table"]}, input_path=bgz,
            meta=mid["meta"],
        )
        resumed = sharded_hash_count_file(bgz, 21, own, resume_from=ck, **kw)
        assert resumed[:3] == flat[:3], (resumed[:3], flat[:3])
        assert np.array_equal(resumed[3], flat[3]), "BGZF resume diverged"
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return (
        f"dryrun OK: world {world}, mesh {mesh_shape(mesh)} k={k} "
        f"{int(table.sum())} k-mers | hash step mesh {mesh_shape(hmesh)} "
        f"k=21 {hstate.total} windows, ASCII == packed | "
        f"sharded_hash_count_file == hash_count_file ({got[0]} bases) | "
        f"BGZF mid-stream resume from byte {offset} bit-identical"
    )


def main(argv=None) -> int:
    import argparse

    from .parallel.distributed import initialize, shutdown

    ap = argparse.ArgumentParser(prog="needletail_tpu_torch.dryrun")
    ap.add_argument("--device", default="cuda",
                    help="cuda (NCCL, the CUDA kernels; default) or cpu "
                         "(gloo, their plain PyTorch versions)")
    args = ap.parse_args(argv)
    initialize(device=args.device)
    try:
        summary = dryrun()
    finally:
        shutdown()
    print(summary)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
