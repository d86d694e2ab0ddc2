"""Ranks of the port's gloo-world tests (torch and the port; never JAX).

    python tests/_torch_dist_worker.py SUITE WORLD OUT_DIR

spawns WORLD ranks on this host (gloo, a ``file://`` rendezvous in
OUT_DIR, so parallel test workers never race for a port), runs SUITE's
checks on each and writes rank r's results to ``OUT_DIR/rank{r}.npz``.
The test that starts it (``tests/test_torch_*.py``) holds the results
against the JAX package; the inputs it wrote to OUT_DIR beforehand are
``mixed.fq``, ``reads.fq.gz``, ``genome.fa`` and ``unequal.fq``.
"""

import os
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
FQ = str(REPO / "tests" / "data" / "PRJNA271013_head.fq")
FA_28S = str(REPO / "tests" / "data" / "28S.fasta")

HASH_CASES = ((True, 16), (False, 16), (True, 12), (False, 12))
RESOLVE_CAP = 1 << 14
# (run length, distinct keys) of each rank's buffer; "one" overflows the
# cascade's first pass on rank 0 only
RESOLVE_CASES = {
    "runs": lambda rank: (300, 400),
    "dense": lambda rank: (1, RESOLVE_CAP),
    "second": lambda rank: (16, 8192 // 8),
    "one": lambda rank: (1, RESOLVE_CAP) if rank == 0 else (300, 40),
}


def random_batch(b=16, l=64, seed=0, alphabet=b"ACGTN"):
    """The global batch of JAX's ``test_parallel.random_batch``."""
    rng = np.random.default_rng(seed)
    seqs = rng.choice(list(alphabet), size=(b, l)).astype(np.uint8)
    return seqs, np.full(b, l, np.int32)


def resolve_buffer(case: str, rank: int, narrow: bool):
    """Rank ``rank``'s flat key buffer of a resolver case: runs of shuffled
    distinct keys, the tail sentinel; ``(hi | None, lo)`` uint32."""
    run_len, n_distinct = RESOLVE_CASES[case](rank)
    rng = np.random.default_rng(3 + rank)
    keys = np.full(RESOLVE_CAP, 0xFFFFFFFFFFFFFFFF, np.uint64)
    space = 2**28 if narrow else 2**40
    distinct = rng.choice(space, size=n_distinct, replace=False).astype(np.uint64)
    lanes = np.repeat(distinct, run_len)[:RESOLVE_CAP]
    rng.shuffle(lanes)
    keys[: lanes.size] = lanes
    hi = (keys >> np.uint64(32)).astype(np.uint32)
    lo = (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return (None if narrow else hi), lo


def write_inputs(out) -> None:
    """The suites' inputs, into ``out``: a mixed-length FASTQ, a gzip
    copy of the golden FASTQ's head, a 20 kbp genome, and a FASTQ whose
    first half of bytes holds few long reads and second half many short
    ones, so ranks frame unequal numbers of batches."""
    import gzip

    from needletail_tpu_torch.utils.synth import synthetic_genome

    out = Path(out)
    rng = np.random.default_rng(11)
    bases = np.frombuffer(b"ACGTN", np.uint8)
    odds = [0.24] * 4 + [0.04]
    with open(out / "mixed.fq", "wb") as f:
        for i in range(400):
            n = int(rng.choice([36, 100, 150, 300]))
            f.write(b"@r%d\n" % i + rng.choice(bases, n, p=odds).tobytes()
                    + b"\n+\n" + b"I" * n + b"\n")
    head = b"".join(Path(FQ).read_bytes().splitlines(keepends=True)[:160])
    (out / "reads.fq.gz").write_bytes(gzip.compress(head))
    (out / "genome.fa").write_bytes(synthetic_genome(20000, seed=1))
    with open(out / "unequal.fq", "wb") as f:
        for i, n in enumerate([2000] * 24 + [50] * 900):
            f.write(b"@u%d\n" % i + rng.choice(bases[:4], n).tobytes()
                    + b"\n+\n" + b"5" * n + b"\n")


class _Steps:
    """A meter that counts this rank's dispatched steps."""

    def __init__(self) -> None:
        self.steps = 0

    def add(self, name, seconds, nbytes=0, items=0) -> None:
        self.steps += name == "dispatch"


def _refusal(fn) -> str:
    try:
        fn()
    except ValueError as exc:
        return str(exc)
    return ""


def suite_parallel(rank, world, out, put):
    import torch
    import torch.distributed as dist

    from needletail_tpu_torch.device.pipeline import _place_fn
    from needletail_tpu_torch.parallel import (
        init_count_state, make_hash_update_step, make_mesh,
        sharded_hash_count_file, sharded_spectrum, update_count_state,
    )
    from needletail_tpu_torch.parallel.checkpoint import (
        load_count_state, load_hash_state, save_count_state, save_hash_state,
    )
    from needletail_tpu_torch.parallel.distributed import (
        gather_table, rank_batch_source, run_rank_stream,
    )
    from needletail_tpu_torch.parallel.sharded import make_update_step

    mesh = make_mesh(data=world, table=1)
    for packed, bits in HASH_CASES:
        n, total, fwd, table = sharded_hash_count_file(
            FQ, 21, mesh, table_bits=bits, batch_size=512, max_len=128,
            host_workers=1, packed=packed,
        )
        put(f"hash_{int(packed)}_{bits}", np.array([n, total, fwd]))
        put(f"hash_{int(packed)}_{bits}_table", table)

    put("refuse_table", _refusal(lambda: make_hash_update_step(
        make_mesh(data=1, table=world), 21)))
    put("refuse_bits", _refusal(lambda: make_hash_update_step(
        mesh, 21, table_bits=17)))
    put("refuse_divisible", _refusal(lambda: make_hash_update_step(
        mesh, 21, table_bits=world.bit_length() - 2)))

    # bucketed batches through the hash step equal the flat batches
    mixed = os.path.join(out, "mixed.fq")

    def hash_over(bucketed):
        init, step, _ = make_hash_update_step(mesh, 21)
        state = [init()]

        def fold(payload, layout):
            state[0] = (step(state[0]) if payload is None
                        else step(state[0], *payload[:2]))

        batches = rank_batch_source(mixed, mesh, 32, None, 1, None, False,
                                    True, bucketed=bucketed)
        n = run_rank_stream(mesh, batches, _place_fn(torch.as_tensor, 21, False),
                            fold, packed=False, double_buffer=False)
        return np.array([n, state[0].total, state[0].fwd]), state[0].table

    for name, bucketed in (("flat", False), ("bucketed", True)):
        tallies, table = hash_over(bucketed)
        put(f"mixed_{name}", tallies)
        put(f"mixed_{name}_table", table)

    # the dense table over the default mesh (2 x 2 in a world of 4)
    dmesh = make_mesh()
    for name, k, canonical, seed in (("canon", 5, True, 0), ("fwd", 4, False, 3)):
        seqs, lengths = random_batch(seed=seed)
        col = sharded_spectrum(dmesh, seqs, lengths, k, canonical=canonical)
        put(f"dense_{name}", gather_table(col, dmesh.get_group("table")))
    step, place = make_update_step(dmesh, 5)
    state = init_count_state(dmesh, 5)
    for seed in range(3):
        state = step(state, *place(*random_batch(seed=seed)))
    put("dense_stream", state.table)
    put("dense_stream_tallies", np.array([state.n_bases, state.n_reads]))
    once = update_count_state(dmesh, init_count_state(dmesh, 5),
                              *random_batch(seed=0), 5)
    put("dense_once", once.table)

    # state checkpoints: saved (rank 0 writes), loaded, stepped on
    init, hstep, hplace = make_hash_update_step(mesh, 9)
    rng = np.random.default_rng(5)
    seqs = rng.choice(list(b"ACGT"), size=(64, 32)).astype(np.uint8)
    lengths = np.full(64, 32, np.int32)
    hs = hstep(init(), *hplace(seqs, lengths)[:2])
    path = os.path.join(out, "hash_state.npz")
    save_hash_state(path, hs, byte_offset=1234, k=9, input_path="reads.fq")
    dist.barrier()
    loaded, offset, k, ip = load_hash_state(path, mesh=mesh)
    resumed = hstep(loaded, *hplace(seqs, lengths)[:2])
    twice = hstep(hs, *hplace(seqs, lengths)[:2])
    put("hash_state", hs.table)
    put("hash_state_meta", np.array([offset, k, loaded.total, hs.total]))
    put("hash_state_resumed", np.array_equal(resumed.table, twice.table))
    path = os.path.join(out, "count_state.npz")
    save_count_state(path, state, byte_offset=99, k=5, input_path="x.fq")
    dist.barrier()
    ck = load_count_state(path)
    again = step(ck.to_state(dmesh), *place(*random_batch(seed=0)))
    ref = step(state, *place(*random_batch(seed=0)))
    put("count_state_meta", np.array([ck.byte_offset, ck.k, ck.n_bases,
                                      ck.n_reads]))
    put("count_state_resumed", np.array_equal(again.table, ref.table))


def suite_exact(rank, world, out, put):
    import torch

    from needletail_tpu_torch.device import count as C
    from needletail_tpu_torch.device.pipeline import minimizer_spectrum_file
    from needletail_tpu_torch.device.tiling import genome_spectrum
    from needletail_tpu_torch.parallel import (
        make_mesh, sharded_count_file, sharded_multi_k_count_file,
    )
    from needletail_tpu_torch.parallel import _resolve, exact
    from needletail_tpu_torch.parallel.distributed import control_group

    mesh = make_mesh(data=world, table=1)

    def spectrum(name, result):
        n, (keys, counts) = result
        put(f"{name}_n", np.array(n))
        put(f"{name}_keys", keys)
        put(f"{name}_counts", counts)

    flushes = [0]
    merge = exact.merge_resolved_shards

    def counted(*args):
        flushes[0] += 1
        return merge(*args)

    exact.merge_resolved_shards = counted
    spectrum("k21", sharded_count_file(FQ, 21, mesh, batch_size=512,
                                       host_workers=1))
    spectrum("k31", sharded_count_file(FA_28S, 31, mesh, batch_size=64,
                                       host_workers=1))
    flushes[0] = 0
    spectrum("flushes", sharded_count_file(FQ, 9, mesh, batch_size=32,
                                           shard_lanes=4096, host_workers=1))
    put("flushes_count", np.array(flushes[0]))
    exact.merge_resolved_shards = merge
    spectrum("q20", sharded_count_file(FQ, 21, mesh, batch_size=512,
                                       quality_cutoff=20, host_workers=1))
    mixed = os.path.join(out, "mixed.fq")
    spectrum("mixed_flat", sharded_count_file(mixed, 21, mesh, batch_size=64,
                                              host_workers=1))
    spectrum("mixed_bucketed", sharded_count_file(mixed, 21, mesh,
                                                  batch_size=64, bucketed=True))
    spectrum("k13", sharded_count_file(FA_28S, 13, mesh, host_workers=1))
    steps = _Steps()
    spectrum("unequal", sharded_count_file(
        os.path.join(out, "unequal.fq"), 21, mesh, batch_size=4 * world,
        host_workers=1, meter=steps,
    ))
    put("unequal_steps", np.array(steps.steps))
    for name, ks, path in (("multik", (4, 21, 31), FQ),
                           ("mix", (11, 13, 21), FA_28S)):
        n, spec = sharded_multi_k_count_file(path, ks, mesh, batch_size=512,
                                             host_workers=1)
        put(f"{name}_n", np.array(n))
        for k, s in spec.items():
            if isinstance(s, tuple):
                put(f"{name}_{k}_keys", s[0])
                put(f"{name}_{k}_counts", s[1])
            else:
                put(f"{name}_{k}_table", s)
    genome = os.path.join(out, "genome.fa")
    got = genome_spectrum(genome, 31, tile_len=1024, mesh=mesh,
                          sparse_format="arrays", device="cpu")
    flat = genome_spectrum(genome, 31, tile_len=1024, device="cpu",
                           sparse_format="arrays")
    spectrum("genome", got)
    put("genome_equals_flat_port", got[0] == flat[0] and all(
        np.array_equal(a, b) for a, b in zip(got[1], flat[1])))
    spectrum("minimizers", minimizer_spectrum_file(
        FQ, 21, 11, mesh=mesh, batch_size=512, host_workers=1,
        device="cpu"))

    # the resolver: the cascade (forced on the CPU) against the safe route,
    # and the lanes each rank compacted, which show the route it took
    compacted = []
    compact = C.compact_runs_device

    def watched(hi, lo, counts):
        compacted.append(int(lo.numel()))
        return compact(hi, lo, counts)

    C.compact_runs_device = watched
    for case in RESOLVE_CASES:
        for narrow in (False, True):
            hi, lo = resolve_buffer(case, rank, narrow)
            planes = (lo,) if narrow else (hi, lo)
            bufs = tuple(torch.from_numpy(p.view(np.int32)) for p in planes)
            name = f"resolve_{case}_{'narrow' if narrow else 'wide'}"
            compacted.clear()
            fast = _resolve.make_sharded_resolver(mesh, True, True, narrow)(*bufs)
            put(f"{name}_lanes", np.array(compacted[0]))
            safe = _resolve.make_sharded_resolver(mesh, True, False, narrow)(*bufs)
            got = exact.merge_resolved_shards(
                fast, narrow, True, np.zeros(0, np.uint64), np.zeros(0, np.int64))
            want = exact.merge_resolved_shards(
                safe, narrow, True, np.zeros(0, np.uint64), np.zeros(0, np.int64))
            put(f"{name}_equal", np.array_equal(got[0], want[0])
                and np.array_equal(got[1], want[1]))
            keys, counts = exact.gather_spectra(*got, control_group(mesh))
            put(f"{name}_keys", keys)
            put(f"{name}_counts", counts)
    C.compact_runs_device = compact


def suite_distributed(rank, world, out, put):
    import torch.distributed as dist

    from needletail_tpu_torch.device.pipeline import minimizer_spectrum_file
    from needletail_tpu_torch.dryrun import dryrun
    from needletail_tpu_torch.parallel import (
        make_mesh, sharded_count_file, sharded_hash_count_file,
        sharded_multi_k_count_file,
    )
    from needletail_tpu_torch.parallel.distributed import host_shard_ranges

    mesh = make_mesh(data=world, table=1)
    gz = os.path.join(out, "reads.fq.gz")
    ck = os.path.join(out, f"never_written_{rank}.npz")
    cases = {
        "hash_compressed": lambda: sharded_hash_count_file(gz, 21, mesh),
        "hash_checkpoint": lambda: sharded_hash_count_file(
            FQ, 21, mesh, checkpoint_every=1, checkpoint_path=ck),
        "exact_compressed": lambda: sharded_count_file(gz, 21, mesh),
        "exact_resume": lambda: sharded_count_file(
            FQ, 21, mesh, resume_from=ck),
        "multik_compressed": lambda: sharded_multi_k_count_file(
            gz, (4, 21), mesh),
        "minimizers_checkpoint": lambda: minimizer_spectrum_file(
            FQ, 21, 11, mesh=mesh, checkpoint_every=1, checkpoint_path=ck,
            device="cpu"),
    }
    for name, fn in cases.items():
        put(f"refuse_{name}", _refusal(fn))
    put("ranges", np.array(host_shard_ranges(FQ)))
    # every rank reaches this collective: none waits on a refused driver
    dist.barrier()
    if world == 2:
        put("dryrun", dryrun())


SUITES = {
    "parallel": suite_parallel,
    "exact": suite_exact,
    "distributed": suite_distributed,
}


class Worlds:
    """SUITE in gloo worlds of 2 and 4 at once, each in a process of its
    own (this file, run as a script) with a timeout of its own, so a rank
    that hangs fails its test instead of the run.  ``get(world)`` waits
    for one world and returns its ranks' results."""

    WORLDS = (2, 4)

    def __init__(self, suite: str, make_dir, timeout: float = 300.0) -> None:
        import subprocess

        env = dict(os.environ, OMP_NUM_THREADS="1",
                   PYTHONPATH=os.pathsep.join([str(REPO), os.environ.get(
                       "PYTHONPATH", "")]))
        self._timeout = timeout
        self._dirs, self._procs, self._done = {}, {}, {}
        for world in self.WORLDS:
            out = make_dir(f"{suite}_world{world}")
            write_inputs(out)
            self._dirs[world] = Path(out)
            self._procs[world] = subprocess.Popen(
                [sys.executable, __file__, suite, str(world), str(out)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
                cwd=str(REPO),
            )

    def dir(self, world: int) -> Path:
        return self._dirs[world]

    def get(self, world: int) -> list:
        import subprocess

        if world not in self._done:
            proc = self._procs[world]
            try:
                log, _ = proc.communicate(timeout=self._timeout)
            except subprocess.TimeoutExpired:
                proc.kill()
                log, _ = proc.communicate()
                raise AssertionError(
                    f"world of {world} passed its {self._timeout} s timeout "
                    f"(a rank hung?):\n{log.decode()[-4000:]}"
                )
            if proc.returncode != 0:
                raise AssertionError(
                    f"world of {world} failed:\n{log.decode()[-6000:]}"
                )
            self._done[world] = [
                dict(np.load(self._dirs[world] / f"rank{r}.npz"))
                for r in range(world)
            ]
        return self._done[world]

    def close(self) -> None:
        for proc in self._procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()


def _rank(rank, suite, world, out):
    import warnings

    import torch

    from needletail_tpu_torch.parallel.distributed import initialize, shutdown

    torch.set_num_threads(1)
    # newer torches name reduce_scatter_tensor reduce_scatter_single
    warnings.filterwarnings("ignore", ".*reduce_scatter_tensor", FutureWarning)
    results = {}

    def put(name, value):
        results[name] = np.asarray(value)

    initialize(init_method=f"file://{out}/rendezvous", num_processes=world,
               process_id=rank, device="cpu")
    try:
        SUITES[suite](rank, world, out, put)
    finally:
        shutdown()
    put("jax_free", not any(
        m.split(".")[0] in ("jax", "jaxlib", "needletail_tpu")
        for m in sys.modules
    ))
    np.savez(os.path.join(out, f"rank{rank}.npz"), **results)


def main() -> None:
    import torch.multiprocessing as mp

    suite, world, out = sys.argv[1], int(sys.argv[2]), sys.argv[3]
    sys.path.insert(0, str(REPO))
    mp.start_processes(_rank, args=(suite, world, out), nprocs=world,
                       start_method="spawn")


if __name__ == "__main__":
    main()
