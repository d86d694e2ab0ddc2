"""The port's ``count_file`` end to end against the JAX package's.

Both drivers read the same files, the port on the CPU (its kernels' plain
versions), JAX on the CPU.  The spectra must be equal key for key and count
for count, in the same types, and reach the corpus goldens.  Also: both
checkpoint kinds resume within the port and across the packages in both
directions, the ``count`` CLIs print the same, and the options JAX refuses
are refused.
"""

import os
from pathlib import Path

import numpy as np
import pytest
import torch

from needletail_tpu.device import pipeline as jpipe
from needletail_tpu_torch.device import pipeline as tpipe

FQ = "tests/data/PRJNA271013_head.fq"
FA = "tests/data/28S.fasta"
GOLD_FQ = (250_000, 209_965)  # bases, canonical 21-mers
GOLD_28S = (738_580, 718_007, 8_108)  # bases, canonical 31-mers, AAAA
RUN = dict(batch_size=512, host_workers=1)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in parallel worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _equal(got, want):
    assert got[0] == want[0]
    a, b = got[1], want[1]
    if isinstance(b, dict):
        assert isinstance(a, dict) and a == b
    elif isinstance(b, tuple):
        for x, y in zip(a, b):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
    else:
        assert a.dtype == b.dtype == np.int64
        np.testing.assert_array_equal(a, b)


# sparse k=21, dense k=4 (accumulated), k=11 (sparse, densified at the
# end) and forward-strand k=21
CASES = {
    "k21": dict(k=21, sparse_format="arrays"),
    "k4": dict(k=4),
    "k11": dict(k=11),
    "fwd21": dict(k=21, canonical=False, sparse_format="arrays"),
}


@pytest.fixture(scope="module")
def jax_ref():
    """JAX results on the FASTQ corpus, by case."""
    return {
        name: jpipe.count_file(FQ, max_len=128, **RUN, **kw)
        for name, kw in CASES.items()
    }


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("case", list(CASES))
def test_count_file_matches_jax(jax_ref, case, packed):
    got = tpipe.count_file(FQ, max_len=128, packed=packed, device="cpu",
                           **RUN, **CASES[case])
    _equal(got, jax_ref[case])
    if case == "k21":
        assert (got[0], int(got[1][1].sum())) == GOLD_FQ


def test_sparse_dict_matches_jax(jax_ref):
    got = tpipe.count_file(FQ, 21, max_len=128, device="cpu", **RUN)
    keys, counts = jax_ref["k21"][1]
    assert got[0] == GOLD_FQ[0]
    assert got[1] == {int(k): int(c) for k, c in zip(keys, counts)}


def test_28s_goldens_match_jax():
    got = tpipe.count_file(FA, 31, sparse_format="arrays", device="cpu", **RUN)
    want = jpipe.count_file(FA, 31, sparse_format="arrays", **RUN)
    _equal(got, want)
    assert (got[0], int(got[1][1].sum())) == GOLD_28S[:2]


def test_readme_pipeline_matches_jax():
    got = tpipe.readme_pipeline(FA, device="cpu")
    assert got == jpipe.readme_pipeline(FA) == (GOLD_28S[0], GOLD_28S[2])


@pytest.mark.parametrize("canonical", [True, False])
@pytest.mark.parametrize("normalized", [True, False])
def test_batch_functions_match_jax(canonical, normalized):
    """``canonical_dense_count``, ``canonical_match_count`` and
    ``base_count`` on one seeded batch with dirty bases."""
    import jax.numpy as jnp

    from needletail_tpu_torch.utils.synth import random_reads

    rng = np.random.default_rng(5)
    seqs, lengths = random_reads(rng, 24, 60, dirty_frac=0.4)
    t = (torch.from_numpy(seqs), torch.from_numpy(lengths))
    j = (jnp.asarray(seqs), jnp.asarray(lengths))
    kw = dict(canonical=canonical, normalized=normalized)
    got = tpipe.canonical_dense_count(*t, 5, **kw)
    want = jpipe.canonical_dense_count(*j, 5, **kw)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    hi, lo = tpipe.pack_target(b"ACGTT")
    assert int(tpipe.canonical_match_count(*t, hi, lo, 5, **kw)) == int(
        jpipe.canonical_match_count(*j, jnp.uint32(hi), jnp.uint32(lo), 5, **kw)
    )
    assert int(tpipe.base_count(t[1])) == int(jpipe.base_count(j[1])) == int(
        lengths.sum()
    )


def test_spawn_workers_and_paths_match(jax_ref):
    """Two spawn workers, a list of paths and the single-thread feed give
    the one-stream spectrum (integer adds commute)."""
    keys, counts = jax_ref["k21"][1]
    got = tpipe.count_file(FQ, 21, batch_size=512, max_len=128,
                           host_workers=2, sparse_format="arrays", device="cpu")
    _equal(got, jax_ref["k21"])
    two = tpipe.count_file([FQ, FQ], 21, max_len=128, sparse_format="arrays",
                           double_buffer=False, device="cpu", **RUN)
    assert two[0] == 2 * GOLD_FQ[0]
    np.testing.assert_array_equal(two[1][0], keys)
    np.testing.assert_array_equal(two[1][1], 2 * counts)


def test_meter_records_every_stage():
    from needletail_tpu_torch.utils.profiling import ThroughputMeter

    meter = ThroughputMeter()
    got = tpipe.count_file(FQ, 21, max_len=128, sparse_format="arrays",
                           meter=meter, device="cpu", **RUN)
    assert got[0] == GOLD_FQ[0]
    stages = meter.as_dict()
    assert {"frame", "h2d", "wait", "dispatch", "drain", "wall"} <= set(stages)
    assert stages["wall"]["items"] == GOLD_FQ[0]


@pytest.mark.parametrize("packed", [True, False])
def test_max_len_below_k_counts_bases_only(tmp_path, packed):
    p = tmp_path / "short.fq"
    p.write_bytes(b"@a\nACGTACGTACGTAC\n+\nIIIIIIIIIIIIII\n" * 40)
    kw = dict(batch_size=16, max_len=16, host_workers=1, packed=packed,
              sparse_format="arrays")
    got = tpipe.count_file(str(p), 21, device="cpu", **kw)
    _equal(got, jpipe.count_file(str(p), 21, **kw))
    assert got[0] == 40 * 14 and got[1][0].size == 0


def test_not_ported_options_raise(tmp_path):
    """The refusals of the ported options, as JAX refuses them, and the
    one option still not ported (a mesh)."""
    for kw in (dict(quality_cutoff=20), dict(bucketed=True)):
        with pytest.raises(ValueError, match="packed transport"):
            tpipe.count_file(FQ, 21, packed=True, device="cpu", **kw)
    fa = tmp_path / "reads.fa"
    fa.write_bytes(b">a\n" + b"ACGT" * 10 + b"\n")
    with pytest.raises(ValueError, match="quality_cutoff needs FASTQ"):
        tpipe.count_file(str(fa), 21, quality_cutoff=20, device="cpu", **RUN)
    with pytest.raises(NotImplementedError, match="parallel/"):
        tpipe.minimizer_spectrum_file(FQ, 21, 11, mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="bucketed/dense"):
        tpipe.count_file(FQ, (4, 21), bucketed=True, device="cpu")
    with pytest.raises(ValueError, match="dense output"):
        tpipe.count_file(FQ, 21, dense=True, device="cpu")


def test_cuda_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tpipe.count_file(FQ, 21, **RUN)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tpipe.readme_pipeline(FA)


# ---------------------------------------------------------------------------
# checkpoints: count_dense (k <= 9) and count_sparse
# ---------------------------------------------------------------------------


class _Interrupt(Exception):
    pass


class _StopAfter:
    """A meter that stops a driver at its n-th step, as a kill would."""

    def __init__(self, n):
        self.n = n
        self.steps = 0

    def add(self, name, seconds, nbytes=0, items=0):
        if name == "dispatch":
            self.steps += 1
            if self.steps == self.n:
                raise _Interrupt


@pytest.fixture(scope="module")
def corpus2(tmp_path_factory):
    """The corpus written twice: 8 batches of 512 reads."""
    p = tmp_path_factory.mktemp("torch_count_ckpt") / "reads.fq"
    p.write_bytes(Path(FQ).read_bytes() * 2)
    return str(p)


CKPT = dict(batch_size=512, max_len=128, host_workers=1)


def _interrupted(driver, corpus, ck, k, **kw):
    with pytest.raises(_Interrupt):
        driver(corpus, k, checkpoint_every=1, checkpoint_path=ck,
               meter=_StopAfter(4), **kw, **CKPT)


@pytest.mark.parametrize("k,kind", [(4, "count_dense"), (21, "count_sparse")])
@pytest.mark.parametrize("writer,reader", [
    ("torch", "torch"), ("jax", "torch"), ("torch", "jax"),
])
def test_checkpoint_resumes(corpus2, tmp_path, k, kind, writer, reader):
    from needletail_tpu_torch.checkpoint import load_stream_checkpoint

    drivers = {
        "torch": lambda *a, **kw: tpipe.count_file(*a, device="cpu", **kw),
        "jax": jpipe.count_file,
    }
    fmt = dict(sparse_format="arrays")
    ck = str(tmp_path / f"{writer}.npz")
    _interrupted(drivers[writer], corpus2, ck, k, **fmt)
    saved = load_stream_checkpoint(ck)
    assert saved["kind"] == kind and saved["k"] == k
    assert 0 < saved["file_offset"] < os.path.getsize(corpus2)
    got = drivers[reader](corpus2, k, resume_from=ck, **fmt, **CKPT)
    want = jpipe.count_file(corpus2, k, **fmt, **CKPT)
    _equal(got, want)


def test_resume_refuses_other_semantics(corpus2, tmp_path):
    ck = str(tmp_path / "n.npz")
    _interrupted(tpipe.count_file, corpus2, ck, 21, device="cpu")
    with pytest.raises(ValueError, match="canonical"):
        tpipe.count_file(corpus2, 21, resume_from=ck, canonical=False,
                         device="cpu", **CKPT)
    with pytest.raises(ValueError, match="kind=count_sparse"):
        tpipe.count_file(corpus2, 4, resume_from=ck, device="cpu", **CKPT)


# ---------------------------------------------------------------------------
# the count CLI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", ["4", "31"])
def test_count_cli_matches_jax(capsys, tmp_path, k):
    from needletail_tpu import cli as jcli
    from needletail_tpu_torch import cli as tcli

    path = FQ if k == "4" else FA
    args = ["count", path, "-k", k, "--batch-size", "512", "--host-workers",
            "1", "--top", "5"]
    outs = {}
    for name, main, extra in (("torch", tcli.main, ["--device", "cpu"]),
                              ("jax", jcli.main, [])):
        dump = tmp_path / f"{name}.tsv"
        npz = tmp_path / f"{name}.npz"
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
    assert tnpz.keys() == jnpz.keys()
    for key in jnpz:
        assert tnpz[key].dtype == jnpz[key].dtype
        np.testing.assert_array_equal(tnpz[key], jnpz[key])
    if k == "31":
        assert terr[0].startswith(f"# {GOLD_28S[0]} bases, {GOLD_28S[1]} ")
