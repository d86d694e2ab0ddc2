"""The port's halo tiling and whole-genome spectrum against the JAX
package's: ``synthetic_genome``, ``tile_sequence``, the framer-backed
``_TileStream`` (packed and ASCII, block for block), ``genome_spectrum``
(dense, sparse arrays, the device flush) and the ``spectrum`` CLI, on the
same seeded inputs, the port on the CPU.  All integer: tolerance 0.
"""

import numpy as np
import pytest
import torch

from needletail_tpu.device import tiling as jt
from needletail_tpu.utils.synth import synthetic_genome as j_genome
from needletail_tpu_torch.device import tiling as tt
from needletail_tpu_torch.utils.synth import synthetic_genome as t_genome


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in parallel worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("n,seed,width", [
    (0, 31, 80), (79, 1, 80), (160, 31, 80), (12_345, 7, 60),
])
def test_synthetic_genome_bytes_match(n, seed, width):
    assert t_genome(n, seed=seed, line_width=width) == j_genome(
        n, seed=seed, line_width=width
    )


@pytest.mark.parametrize("n,k,tile_len", [
    (1000, 31, 128), (1024, 21, 256), (500, 31, 470), (31, 31, 64),
    (30, 31, 64), (997, 17, 100),
])
def test_tile_sequence_matches(n, k, tile_len):
    rng = np.random.default_rng(n * 1000 + k)
    seq = bytes(rng.choice(list(b"ACGTNacgt"), size=n).astype(np.uint8))
    got = tt.tile_sequence(seq, k, tile_len)
    want = jt.tile_sequence(seq, k, tile_len)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


RECORD_LENGTHS = (3000, 40, 5, 1200, 900, 700, 1500, 600, 2600, 777, 4100)


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """A FASTA of wrapped records: one framer batch (8 records) of clean
    ones, one of them shorter than k, then a batch with an N in two
    records, so a block's validity plane appears mid-block."""
    rng = np.random.default_rng(17)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    recs = []
    for i, n in enumerate(RECORD_LENGTHS):
        seq = acgt[rng.integers(0, 4, n)].copy()
        if i in (8, 10):
            seq[n // 3] = ord("N")
        recs.append(seq.tobytes())
    p = tmp_path_factory.mktemp("torch_tiling") / "recs.fa"
    p.write_bytes(b"".join(
        b">r%d\n" % i + b"\n".join(s[j : j + 70] for j in range(0, len(s), 70))
        + b"\n"
        for i, s in enumerate(recs)
    ))
    return str(p)


@pytest.mark.parametrize("packed", [True, False])
def test_tile_stream_matches_block_for_block(records, packed):
    kw = dict(tile_len=512, batch_tiles=5, packed=packed)
    got_s = tt._TileStream(records, 21, **kw)
    want_s = jt._TileStream(records, 21, **kw)
    got, want = list(got_s), list(want_s)
    assert len(got) == len(want) > 3
    for gb, wb in zip(got, want):
        assert len(gb) == len(wb)
        for a, b in zip(gb, wb):
            if b is None:
                assert a is None
            else:
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
    if packed:
        # the validity plane appears with the first dirty record only
        assert any(b[1] is None for b in want) and any(b[1] is not None for b in want)
    assert got_s.n_bases == want_s.n_bases == sum(RECORD_LENGTHS)


def test_tiled_batches_match(records):
    got = list(tt.tiled_batches(records, 9, tile_len=300, batch_tiles=4))
    want = list(jt.tiled_batches(records, 9, tile_len=300, batch_tiles=4))
    assert len(got) == len(want)
    for (a, la), (b, lb) in zip(got, want):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(la, lb)


@pytest.fixture(scope="module")
def genome(tmp_path_factory):
    """40 kbp with 4% N, wrapped at 70 columns."""
    rng = np.random.default_rng(11)
    seq = rng.choice(np.frombuffer(b"ACGTN", np.uint8), 40_000,
                     p=[0.24, 0.24, 0.24, 0.24, 0.04]).tobytes()
    p = tmp_path_factory.mktemp("torch_genome") / "genome.fa"
    p.write_bytes(b">chr1\n" + b"\n".join(
        seq[i : i + 70] for i in range(0, len(seq), 70)) + b"\n")
    return str(p)


GENOME_CASES = {
    "k7_dense": dict(k=7),
    "k31_arrays": dict(k=31, sparse_format="arrays"),
    "k31_ascii": dict(k=31, sparse_format="arrays", packed=False),
    "k15_arrays": dict(k=15, sparse_format="arrays"),
    "k21_dict_fwd": dict(k=21, canonical=False),
}


@pytest.mark.parametrize("case", list(GENOME_CASES))
def test_genome_spectrum_matches_jax(genome, case):
    kw = dict(tile_len=1024, batch_tiles=8, **GENOME_CASES[case])
    got = tt.genome_spectrum(genome, device="cpu", **kw)
    want = jt.genome_spectrum(genome, **kw)
    assert got[0] == want[0] == 40_000
    if isinstance(want[1], tuple):
        for a, b in zip(got[1], want[1]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    elif isinstance(want[1], dict):
        assert got[1] == want[1]
    else:
        assert got[1].dtype == want[1].dtype == np.int64
        np.testing.assert_array_equal(got[1], want[1])


def test_genome_spectrum_device_flush_matches_jax(genome):
    kw = dict(k=31, tile_len=1024, batch_tiles=8, sparse_format="device")
    n, (hi, lo, counts) = tt.genome_spectrum(genome, device="cpu", **kw)
    jn, (jhi, jlo, jcounts) = jt.genome_spectrum(genome, **kw)
    assert n == jn
    np.testing.assert_array_equal(hi.numpy().view(np.uint32), np.asarray(jhi))
    np.testing.assert_array_equal(lo.numpy().view(np.uint32), np.asarray(jlo))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))


def test_genome_spectrum_refusals(genome):
    with pytest.raises(TypeError, match="DeviceMesh"):
        tt.genome_spectrum(genome, 31, mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="dense output"):
        tt.genome_spectrum(genome, 13, dense=True, device="cpu")
    with pytest.raises(ValueError, match="tile_len % 8"):
        tt.genome_spectrum(genome, 31, tile_len=1001, device="cpu")
    with pytest.raises(ValueError, match="flush bound"):
        from needletail_tpu_torch.device import count as tc

        bound = tc.SPARSE_FLUSH_LANES
        tc.SPARSE_FLUSH_LANES = 1000
        try:
            tt.genome_spectrum(genome, 31, tile_len=1024,
                               sparse_format="device", device="cpu")
        finally:
            tc.SPARSE_FLUSH_LANES = bound
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tt.genome_spectrum(genome, 31)


def test_tile_key_fn_is_memoized_and_matches(genome):
    a = tt.make_tile_key_fn(31, 1024, device="cpu")
    assert a is tt.make_tile_key_fn(31, 1024, device=torch.device("cpu"))
    assert a is not tt.make_tile_key_fn(31, 1024, packed=False, device="cpu")
    tiles, lengths = tt.tile_sequence(b"ACGT" * 600, 31, 1024)
    hi, lo = tt.make_tile_key_fn(31, 1024, packed=False, device="cpu")(
        torch.from_numpy(tiles), torch.from_numpy(lengths), None
    )
    assert hi.numel() == lo.numel() == tiles.shape[0] * 1024
    assert int((lo != -1).sum()) == 4 * 600 - 31 + 1


def test_spectrum_cli_matches_jax(genome, capsys, tmp_path):
    from needletail_tpu import cli as jcli
    from needletail_tpu_torch import cli as tcli

    args = ["spectrum", genome, "-k", "21", "--tile-len", "1024", "--top", "4"]
    outs = {}
    for name, main, extra in (("torch", tcli.main, ["--device", "cpu"]),
                              ("jax", jcli.main, [])):
        dump, npz = tmp_path / f"{name}.tsv", tmp_path / f"{name}.npz"
        assert main(args + extra + ["--dump", str(dump), "-o", str(npz)]) == 0
        out = capsys.readouterr()
        stored = np.load(npz)
        outs[name] = (
            out.out,
            [line for line in out.err.splitlines() if "written to" not in line],
            dump.read_bytes(),
            {key: stored[key] for key in stored.files},
        )
    (tout, terr, tdump, tnpz), (jout, jerr, jdump, jnpz) = outs["torch"], outs["jax"]
    assert tout == jout and terr == jerr and tdump == jdump
    assert terr[0].startswith("# 40000 bases, ")
    assert tnpz.keys() == jnpz.keys()
    for key in jnpz:
        assert tnpz[key].dtype == jnpz[key].dtype
        np.testing.assert_array_equal(tnpz[key], jnpz[key])
