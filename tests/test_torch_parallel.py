"""The port's ``parallel`` package against the JAX package's: meshes, the
sharded hash pipeline, the dense table, state checkpoints.

Gloo worlds of 2 and 4 run ``tests/_torch_dist_worker.py``'s ``parallel``
suite (no JAX in their processes); each result is held at tolerance 0
against the JAX sharded driver on a ``data``-sized slice of the 8 CPU
devices and against the flat JAX driver.  Worlds of one run in this
process: checkpoints interchange with the flat drivers, and the
``--sharded`` command prints what the flat one prints.
"""

import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist_worker as W
from needletail_tpu.device import count as jcount
from needletail_tpu.device import kmers as jkmers
from needletail_tpu.device.pipeline import hash_count_file as j_hash_count_file
from needletail_tpu.parallel import make_mesh as j_make_mesh
from needletail_tpu.parallel import mesh_shape_for as j_mesh_shape_for
from needletail_tpu.parallel import sharded_hash_count_file as j_sharded_hash
from needletail_tpu.parallel import sharded_spectrum as j_sharded_spectrum
from needletail_tpu.parallel.checkpoint import load_count_state as j_load_count
from needletail_tpu.parallel.checkpoint import load_hash_state as j_load_hash
from needletail_tpu_torch import cli
from needletail_tpu_torch.device import pipeline as tpipe
from needletail_tpu_torch.parallel import distributed as tdist
from needletail_tpu_torch.parallel import make_mesh, mesh_shape_for
from needletail_tpu_torch.parallel import sharded_hash_count_file
from needletail_tpu_torch.utils.profiling import ThroughputMeter

FQ = W.FQ
GOLD = (250_000, 209_965, 106_181)
WORLDS = W.Worlds.WORLDS
# newer torches name reduce_scatter_tensor reduce_scatter_single
pytestmark = pytest.mark.filterwarnings(
    "ignore:.*reduce_scatter_tensor:FutureWarning")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread, as each spawned rank runs: the test workers
    share the cores, and more threads only contend for them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    spawned = W.Worlds("parallel", tmp_path_factory.mktemp)
    yield spawned
    spawned.close()


@pytest.fixture(scope="module")
def jax_hash():
    """The JAX tables at k=21: flat by table_bits, and sharded (table_bits
    16) on a data-sized slice of the CPU devices by world."""
    flat = {
        bits: j_hash_count_file(FQ, 21, table_bits=bits, batch_size=512,
                                max_len=128, host_workers=1)
        for bits in (16, 12)
    }
    sharded = {
        w: j_sharded_hash(
            FQ, 21, mesh=j_make_mesh(jax.devices()[:w], data=w, table=1),
            batch_size=512, max_len=128, host_workers=1,
        )
        for w in WORLDS
    }
    return flat, sharded


@pytest.fixture
def world_of_one():
    tdist.initialize(device="cpu")
    try:
        yield make_mesh(data=1, table=1)
    finally:
        tdist.shutdown()


@pytest.mark.parametrize("n", range(1, 17))
def test_mesh_shape_for(n):
    assert mesh_shape_for(n) == j_mesh_shape_for(n)


@pytest.mark.parametrize("packed,bits", W.HASH_CASES)
@pytest.mark.parametrize("world", WORLDS)
def test_sharded_hash_count_file(worlds, jax_hash, world, packed, bits):
    flat, sharded = jax_hash
    ranks = worlds.get(world)
    for r in ranks:
        assert bool(r["jax_free"])
        assert tuple(r[f"hash_{int(packed)}_{bits}"]) == GOLD
        table = r[f"hash_{int(packed)}_{bits}_table"]
        assert table.dtype == np.int64 and table.shape == (1 << bits,)
        np.testing.assert_array_equal(table, flat[bits][3])
        if bits == 16:
            assert sharded[world][:3] == GOLD
            np.testing.assert_array_equal(table, sharded[world][3])


@pytest.mark.parametrize("world", WORLDS)
def test_hash_refusals(worlds, world):
    for r in worlds.get(world):
        assert "table=1" in str(r["refuse_table"])
        assert "table_bits <= 16" in str(r["refuse_bits"])
        assert "not divisible by data" in str(r["refuse_divisible"])


@pytest.mark.parametrize("world", WORLDS)
def test_bucketed_hash_matches_flat(worlds, world):
    want = j_hash_count_file(str(worlds.dir(world) / "mixed.fq"), 21,
                             batch_size=64, host_workers=1, packed=False)
    for r in worlds.get(world):
        for name in ("flat", "bucketed"):
            assert tuple(r[f"mixed_{name}"]) == want[:3]
            np.testing.assert_array_equal(r[f"mixed_{name}_table"], want[3])
        assert want[1] > 10_000  # windows enough to mean something


def _jax_dense(seed, k, canonical):
    seqs, lengths = W.random_batch(seed=seed)
    fn = jkmers.canonical_kmers if canonical else jkmers.pack_kmers
    win = fn(jnp.asarray(seqs), jnp.asarray(lengths), k)
    return np.asarray(jcount.dense_spectrum(win, k)).astype(np.int64)


@pytest.mark.parametrize("case", ["canon", "fwd"])
@pytest.mark.parametrize("world", WORLDS)
def test_sharded_spectrum(worlds, world, case):
    k, canonical, seed = {"canon": (5, True, 0), "fwd": (4, False, 3)}[case]
    want = _jax_dense(seed, k, canonical)
    mesh = j_make_mesh(jax.devices()[:world])
    seqs, lengths = W.random_batch(seed=seed)
    jsharded = np.asarray(j_sharded_spectrum(
        mesh, jnp.asarray(seqs), jnp.asarray(lengths), k, canonical=canonical
    ))
    np.testing.assert_array_equal(jsharded, want)
    for r in worlds.get(world):
        np.testing.assert_array_equal(r[f"dense_{case}"], want)


@pytest.mark.parametrize("world", WORLDS)
def test_count_state_streams(worlds, world):
    want = sum(_jax_dense(seed, 5, True) for seed in range(3))
    for r in worlds.get(world):
        np.testing.assert_array_equal(r["dense_stream"], want)
        assert tuple(r["dense_stream_tallies"]) == (3 * 16 * 64, 48)
        np.testing.assert_array_equal(r["dense_once"], _jax_dense(0, 5, True))


@pytest.mark.parametrize("world", WORLDS)
def test_state_checkpoints_round_trip(worlds, world):
    ranks = worlds.get(world)
    for r in ranks:
        offset, k, loaded_total, total = r["hash_state_meta"]
        assert (offset, k) == (1234, 9) and loaded_total == total > 0
        assert bool(r["hash_state_resumed"])
        assert tuple(r["count_state_meta"]) == (99, 5, 3 * 16 * 64, 48)
        assert bool(r["count_state_resumed"])
    # the files rank 0 wrote load in the JAX package
    state, offset, k, ip = j_load_hash(worlds.dir(world) / "hash_state.npz")
    assert (offset, k, ip) == (1234, 9, "reads.fq")
    np.testing.assert_array_equal(np.asarray(state.table), ranks[0]["hash_state"])
    ck = j_load_count(worlds.dir(world) / "count_state.npz")
    assert (ck.byte_offset, ck.k, ck.path, ck.n_reads) == (99, 5, "x.fq", 48)
    np.testing.assert_array_equal(ck.table, ranks[0]["dense_stream"])


def _prefix_checkpoint(tmp_path, write):
    """A stream of two copies of the golden FASTQ checkpointed after its
    second batch by ``write(prefix, ckpt)`` and rebased onto the whole
    stream (kind, k and arrays as written); returns ``(corpus, ckpt)``."""
    from needletail_tpu_torch.checkpoint import (
        load_stream_checkpoint, save_stream_checkpoint,
    )
    from needletail_tpu_torch.io.fast_batch import fast_read_batches

    src = open(FQ, "rb").read() * 2
    corpus = tmp_path / "reads.fq"
    corpus.write_bytes(src)
    it = iter(fast_read_batches(str(corpus), batch_size=512, max_len=128,
                                packed=True))
    next(it)
    off = next(it).file_offset
    it.close()
    prefix = tmp_path / "prefix.fq"
    prefix.write_bytes(src[:off])
    ck = str(tmp_path / "ckpt.npz")
    write(str(prefix), ck)
    mid = load_stream_checkpoint(ck)
    save_stream_checkpoint(
        ck, mid["kind"], mid["k"], off, mid["n_bases"], mid["arrays"],
        input_path=str(corpus), meta=mid["meta"],
    )
    return str(corpus), ck


KW = dict(batch_size=512, max_len=128, host_workers=1)


@pytest.mark.parametrize("writer", ["port_flat", "port_sharded", "jax_flat"])
def test_checkpoint_interchangeable_with_flat(tmp_path, world_of_one, writer):
    """``kind="hash"`` checkpoints cross drivers and packages: a stream
    checkpointed by the flat or the sharded driver (or by JAX's) resumes
    on the other port driver, to the uninterrupted table."""
    mesh = world_of_one
    ck_kw = dict(checkpoint_every=2, **KW)
    write = {
        "port_flat": lambda p, ck: tpipe.hash_count_file(
            p, 9, checkpoint_path=ck, device="cpu", **ck_kw),
        "port_sharded": lambda p, ck: sharded_hash_count_file(
            p, 9, mesh, checkpoint_path=ck, **ck_kw),
        "jax_flat": lambda p, ck: j_hash_count_file(
            p, 9, checkpoint_path=ck, **ck_kw),
    }[writer]
    corpus, ck = _prefix_checkpoint(tmp_path, write)
    want = j_hash_count_file(corpus, 9, **KW)
    if writer == "port_sharded":
        got = tpipe.hash_count_file(corpus, 9, resume_from=ck, device="cpu",
                                    **KW)
    else:
        got = sharded_hash_count_file(corpus, 9, mesh, resume_from=ck, **KW)
    assert got[:3] == want[:3]
    np.testing.assert_array_equal(got[3], want[3])


@pytest.mark.parametrize("writer", ["port_flat", "port_sharded", "jax_flat"])
def test_exact_checkpoint_interchangeable_with_flat(tmp_path, world_of_one,
                                                   writer):
    """A world of one checkpoints the exact spectrum in the flat driver's
    ``count_sparse`` file: either port driver resumes the other's (and
    JAX's), to the uninterrupted spectrum."""
    from needletail_tpu.device.pipeline import count_file as j_count_file
    from needletail_tpu_torch.checkpoint import load_stream_checkpoint
    from needletail_tpu_torch.parallel import sharded_count_file

    mesh = world_of_one
    kw = dict(sparse_format="arrays", **KW)
    write = {
        "port_flat": lambda p, ck: tpipe.count_file(
            p, 21, checkpoint_path=ck, checkpoint_every=2, device="cpu", **kw),
        "port_sharded": lambda p, ck: sharded_count_file(
            p, 21, mesh, checkpoint_path=ck, checkpoint_every=2, **KW),
        "jax_flat": lambda p, ck: j_count_file(
            p, 21, checkpoint_path=ck, checkpoint_every=2, **kw),
    }[writer]
    corpus, ck = _prefix_checkpoint(tmp_path, write)
    assert load_stream_checkpoint(ck)["kind"] == "count_sparse"
    want = j_count_file(corpus, 21, **kw)
    if writer == "port_sharded":
        got = tpipe.count_file(corpus, 21, resume_from=ck, device="cpu", **kw)
    else:
        got = sharded_count_file(corpus, 21, mesh, resume_from=ck, **KW)
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1][0], want[1][0])
    np.testing.assert_array_equal(got[1][1], want[1][1])


@pytest.mark.parametrize("driver", ["genome", "minimizers"])
def test_mesh_and_device_must_agree(world_of_one, driver):
    """A gloo mesh with the default ``device="cuda"`` raises instead of
    running the plain versions on the CPU."""
    from needletail_tpu_torch.device.tiling import genome_spectrum

    run = {
        "genome": lambda **kw: genome_spectrum(W.FA_28S, 31, **kw),
        "minimizers": lambda **kw: tpipe.minimizer_spectrum_file(
            FQ, 21, 11, host_workers=1, **kw),
    }[driver]
    with pytest.raises(ValueError, match="the mesh runs on cpu"):
        run(mesh=world_of_one)
    with pytest.raises(ValueError, match="the mesh runs on cpu"):
        run(mesh=world_of_one, device="cuda:0")
    assert run(mesh=world_of_one, device="cpu")[0] > 0


def test_sharded_hash_metered(world_of_one):
    meter = ThroughputMeter()
    got = sharded_hash_count_file(FQ, 21, world_of_one, meter=meter, **KW)
    assert got[:3] == GOLD
    for stage in ("frame", "h2d", "wait", "dispatch", "drain", "wall"):
        assert stage in meter.stages, meter.stages.keys()
    assert meter.stages["wall"].items == GOLD[0]


def test_mesh_refusals(world_of_one):
    with pytest.raises(TypeError, match="DeviceMesh"):
        sharded_hash_count_file(FQ, 21, object())
    with pytest.raises(ValueError, match="mesh 2x1 != 1 devices"):
        make_mesh(data=2, table=1)


def test_without_a_group_make_mesh_raises():
    with pytest.raises(RuntimeError, match="initialize"):
        make_mesh()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tdist.initialize(device="cuda")
    with pytest.raises(ValueError, match="init_method and process_id"):
        tdist.initialize(num_processes=2, device="cpu")


def _cli(*argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert cli.main(list(argv)) == 0
    return out.getvalue()


def test_hash_count_sharded_cli_prints_the_flat_json():
    argv = ("hash-count", FQ, "-k", "21", "--device", "cpu",
            "--host-workers", "1")
    flat = _cli(*argv)
    assert flat.startswith('{"bases": 250000, "windows": 209965, "forward": 106181,')
    assert _cli(*argv, "--sharded") == flat
