"""The port's sharded exact paths against the JAX package's: the per-rank
spectrum accumulator and resolver, multi-k, the genome and the sketch.

Gloo worlds of 2 and 4 run ``tests/_torch_dist_worker.py``'s ``exact``
suite (no JAX in their processes); every rank returns the whole result,
held at tolerance 0 against the flat JAX driver and the JAX sharded driver
on a ``data``-sized slice of the 8 CPU devices.  JAX's sharded results do
not depend on the mesh (its own tests hold them to its flat driver), so
each case runs it once, on a data axis of 2 or of 4, and is held there to
the flat one.
"""

import jax
import numpy as np
import pytest
import torch

import _torch_dist_worker as W
from needletail_tpu.device.pipeline import count_file as j_count_file
from needletail_tpu.device.pipeline import (
    minimizer_spectrum_file as j_minimizer_spectrum_file,
)
from needletail_tpu.device.pipeline import (
    multi_k_count_file as j_multi_k_count_file,
)
from needletail_tpu.device.tiling import genome_spectrum as j_genome_spectrum
from needletail_tpu.parallel import make_mesh as j_make_mesh
from needletail_tpu.parallel import sharded_count_file as j_sharded_count_file
from needletail_tpu.parallel import (
    sharded_multi_k_count_file as j_sharded_multi_k,
)

FQ, FA = W.FQ, W.FA_28S
WORLDS = W.Worlds.WORLDS


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread, as each spawned rank runs: the test workers
    share the cores, and more threads only contend for them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh(data):
    return j_make_mesh(jax.devices()[:data], data=data, table=1)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    spawned = W.Worlds("exact", tmp_path_factory.mktemp)
    yield spawned
    spawned.close()


# case -> (flat JAX run, sharded JAX run or None, its data axis); ``d``
# holds the inputs the worlds wrote (the same bytes in every world)
ONE = dict(host_workers=1)
CASES = {
    "k21": (
        lambda d: j_count_file(FQ, 21, sparse_format="arrays", **ONE),
        lambda d, m: j_sharded_count_file(FQ, 21, mesh=m, batch_size=512, **ONE),
        2,
    ),
    "k31": (
        lambda d: j_count_file(FA, 31, sparse_format="arrays", **ONE),
        lambda d, m: j_sharded_count_file(FA, 31, mesh=m, batch_size=512, **ONE),
        4,
    ),
    "flushes": (
        lambda d: j_count_file(FQ, 9, dense=False, sparse_format="arrays", **ONE),
        lambda d, m: j_sharded_count_file(FQ, 9, mesh=m, batch_size=128,
                                          shard_lanes=4096, **ONE),
        4,
    ),
    "q20": (
        lambda d: j_count_file(FQ, 21, sparse_format="arrays",
                               quality_cutoff=20, **ONE),
        lambda d, m: j_sharded_count_file(FQ, 21, mesh=m, batch_size=512,
                                          quality_cutoff=20, **ONE),
        2,
    ),
    "mixed_bucketed": (
        lambda d: j_count_file(str(d / "mixed.fq"), 21, sparse_format="arrays",
                               **ONE),
        lambda d, m: j_sharded_count_file(str(d / "mixed.fq"), 21, mesh=m,
                                          batch_size=64, bucketed=True),
        2,
    ),
    "k13": (
        lambda d: j_count_file(FA, 13, dense=False, sparse_format="arrays",
                               **ONE),
        None, 0,
    ),
    "unequal": (
        lambda d: j_count_file(str(d / "unequal.fq"), 21,
                               sparse_format="arrays", **ONE),
        None, 0,
    ),
    "genome": (
        lambda d: j_genome_spectrum(str(d / "genome.fa"), 31, tile_len=1024,
                                    sparse_format="arrays"),
        lambda d, m: j_genome_spectrum(str(d / "genome.fa"), 31, tile_len=1024,
                                       sparse_format="arrays", mesh=m),
        4,
    ),
    "minimizers": (
        lambda d: j_minimizer_spectrum_file(FQ, 21, 11, **ONE),
        lambda d, m: j_minimizer_spectrum_file(FQ, 21, 11, batch_size=512,
                                               mesh=m, **ONE),
        2,
    ),
}


@pytest.fixture(scope="module")
def jax_refs(worlds):
    """Each case's flat JAX result, held here against its sharded JAX
    result where the case has one."""
    d = worlds.dir(WORLDS[0])
    refs = {}
    for case, (flat, sharded, data) in CASES.items():
        refs[case] = flat(d)
        if sharded is not None:
            _equal(sharded(d, _mesh(data)), refs[case])
    return refs


GOLDEN = {  # (bases, k-mers, distinct)
    "k21": (250_000, 209_965, 164_963),
    "k31": (738_580, 718_007, 283_237),
    "q20": (250_000, 146_651, 116_744),
    "minimizers": (250_000, 189_960, 28_606),
}


def _equal(got, want):
    n, (keys, counts) = got
    assert n == want[0]
    assert keys.dtype == np.uint64 and counts.dtype == np.int64
    np.testing.assert_array_equal(keys, np.asarray(want[1][0]))
    np.testing.assert_array_equal(counts, np.asarray(want[1][1]))


def _spectrum(r, name):
    return int(r[f"{name}_n"]), (r[f"{name}_keys"], r[f"{name}_counts"])


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", CASES)
def test_sharded_spectra_match_jax(worlds, jax_refs, case, world):
    want = jax_refs[case]
    for r in worlds.get(world):
        assert bool(r["jax_free"])
        got = _spectrum(r, case)
        _equal(got, want)
        if case in GOLDEN:
            n, (keys, counts) = got
            assert (n, int(counts.sum()), len(keys)) == GOLDEN[case]


@pytest.mark.parametrize("world", WORLDS)
def test_genome_mesh_equals_the_flat_port(worlds, world):
    for r in worlds.get(world):
        assert bool(r["genome_equals_flat_port"])


@pytest.mark.parametrize("world", WORLDS)
def test_buffers_flush_many_times(worlds, world):
    for r in worlds.get(world):
        assert int(r["flushes_count"]) > 4


@pytest.mark.parametrize("world", WORLDS)
def test_bucketed_equals_flat(worlds, world):
    for r in worlds.get(world):
        _equal(_spectrum(r, "mixed_bucketed"),
               _spectrum(worlds.get(world)[0], "mixed_flat"))


@pytest.mark.parametrize("world", WORLDS)
def test_unequal_batch_counts_do_not_hang(worlds, world):
    """Ranks that frame different numbers of batches step in lockstep:
    the run ended (inside its timeout) with the exact spectrum."""
    steps = [int(r["unequal_steps"]) for r in worlds.get(world)]
    assert max(steps) > 4 * min(steps), steps


def _oracle(case, narrow, world):
    keys = []
    for rank in range(world):
        hi, lo = W.resolve_buffer(case, rank, narrow)
        k = lo.astype(np.uint64)
        if hi is not None:
            k |= hi.astype(np.uint64) << np.uint64(32)
        keys.append(k)
    keys = np.concatenate(keys)
    sentinel = 0xFFFFFFFF if narrow else 0xFFFFFFFFFFFFFFFF
    return np.unique(keys[keys != np.uint64(sentinel)], return_counts=True)


# lanes compacted after the cascade: the second pass's output where both
# passes held everywhere, the first's where the second overflowed, the
# whole stream where any rank's first pass overflowed
ROUTE_LANES = {"runs": 1024, "second": 2048, "dense": W.RESOLVE_CAP,
               "one": W.RESOLVE_CAP}


@pytest.mark.parametrize("narrow", [False, True])
@pytest.mark.parametrize("case", list(W.RESOLVE_CASES))
@pytest.mark.parametrize("world", WORLDS)
def test_resolver_routes(worlds, world, case, narrow):
    """The cascade equals the safe route on every rank, and every rank
    takes the same route: with overflow on rank 0 only ("one"), every
    rank compacts its whole stream."""
    name = f"resolve_{case}_{'narrow' if narrow else 'wide'}"
    keys, counts = _oracle(case, narrow, world)
    for r in worlds.get(world):
        assert bool(r[f"{name}_equal"])
        assert int(r[f"{name}_lanes"]) == ROUTE_LANES[case]
        np.testing.assert_array_equal(r[f"{name}_keys"], keys)
        np.testing.assert_array_equal(r[f"{name}_counts"], counts)


@pytest.fixture(scope="module")
def jax_multi():
    return {
        "multik": (
            j_multi_k_count_file(FQ, (4, 21, 31), **ONE),
            j_sharded_multi_k(FQ, (4, 21, 31), mesh=_mesh(2), batch_size=512,
                              **ONE),
        ),
        # JAX's own tests hold its sharded run of this mix to the flat one
        "mix": (j_multi_k_count_file(FA, (11, 13, 21), **ONE), None),
    }


MULTI_GOLDEN = {4: (243_982, 136), 21: (209_965, 164_963),
                31: (189_960, 153_526)}


@pytest.mark.parametrize("case", ["multik", "mix"])
@pytest.mark.parametrize("world", WORLDS)
def test_sharded_multi_k_matches_jax(worlds, jax_multi, world, case):
    flat, sharded = jax_multi[case]
    for r in worlds.get(world):
        assert int(r[f"{case}_n"]) == flat[0]
        assert sharded is None or sharded[0] == flat[0]
        for k, want in flat[1].items():
            for ref in (want,) if sharded is None else (want, sharded[1][k]):
                if isinstance(ref, tuple):
                    np.testing.assert_array_equal(r[f"{case}_{k}_keys"], ref[0])
                    np.testing.assert_array_equal(r[f"{case}_{k}_counts"], ref[1])
                else:
                    np.testing.assert_array_equal(r[f"{case}_{k}_table"],
                                                  np.asarray(ref))
            if case == "multik":
                counts = (r[f"{case}_{k}_counts"] if k > 12
                          else r[f"{case}_{k}_table"])
                distinct = (len(r[f"{case}_{k}_keys"]) if k > 12
                            else int((counts > 0).sum()))
                assert (int(counts.sum()), distinct) == MULTI_GOLDEN[k]
