"""The port's length-bucketed batching against the JAX package's.

``io/bucketed.py`` must yield JAX's batches (widths, rows, lengths, bases
and qualities, in order) over a seeded FASTQ mixing 30, 200, 700 and
5,000 bp reads, and over its FASTA twin, which carries no quality plane;
``count_file(bucketed=True)`` must return JAX's spectrum and the flat
port's, with and without ``quality_cutoff``, and the ``count --bucketed
--quality-cutoff`` CLIs must print the same.  Integer code: tolerance 0.
"""

import numpy as np
import pytest
import torch

from needletail_tpu.device import pipeline as jpipe
from needletail_tpu.io import bucketed as jb
from needletail_tpu_torch.device import pipeline as tpipe
from needletail_tpu_torch.io import bucketed as tb

LENGTHS = (30, 200, 700, 5000)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in parallel worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mixed_records(rng, n):
    bases = np.frombuffer(b"ACGTN", np.uint8)
    out = []
    for i in range(n):
        ln = int(rng.choice(LENGTHS))
        seq = bases[rng.choice(5, ln, p=[0.24, 0.24, 0.24, 0.24, 0.04])]
        qual = rng.integers(33, 75, ln).astype(np.uint8)
        out.append((b"r%d" % i, seq.tobytes(), qual.tobytes()))
    return out


@pytest.fixture(scope="module")
def mixed(tmp_path_factory):
    """``(fastq, fasta)`` paths of one seeded mix of read lengths."""
    d = tmp_path_factory.mktemp("torch_bucketed")
    recs = _mixed_records(np.random.default_rng(2207), 90)
    fq, fa = d / "mixed.fq", d / "mixed.fa"
    fq.write_bytes(b"".join(b"@%s\n%s\n+\n%s\n" % r for r in recs))
    fa.write_bytes(b"".join(b">%s\n%s\n" % r[:2] for r in recs))
    return str(fq), str(fa)


def _batches(mod, path, **kw):
    return [(b.seqs, b.lengths, b.quals) for b in mod.bucketed_read_batches(path, **kw)]


@pytest.mark.parametrize("fmt", ["fastq", "fasta"])
@pytest.mark.parametrize("kw", [
    dict(batch_size=16),
    dict(batch_size=7, buckets=(64, 256, 1024)),
    dict(batch_size=16, with_quals=False),
])
def test_bucketed_batches_match_jax(mixed, fmt, kw):
    path = mixed[0] if fmt == "fastq" else mixed[1]
    got, want = _batches(tb, path, **kw), _batches(jb, path, **kw)
    assert len(got) == len(want) > 3
    for (gs, gl, gq), (ws, wl, wq) in zip(got, want):
        assert gs.dtype == ws.dtype and gl.dtype == wl.dtype
        np.testing.assert_array_equal(gs, ws)
        np.testing.assert_array_equal(gl, wl)
        if wq is None:
            assert gq is None
        else:
            np.testing.assert_array_equal(gq, wq)
    widths = {s.shape[1] for s, _, _ in got}
    if "buckets" not in kw:
        # the four lengths land in 128, 256, 1024 and a dynamic 5,120
        assert widths == {128, 256, 1024, 5120}
    if fmt == "fasta" or kw.get("with_quals") is False:
        assert all(q is None for _, _, q in got)


def test_bucketed_refusals_match_jax(mixed):
    for mod in (tb, jb):
        with pytest.raises(ValueError, match="single-file"):
            list(mod.bucketed_read_batches([mixed[0], mixed[0]]))
        # max_len 4998 rounds up to 5000: the 5,000 bp reads fit
        assert sum(b.num_reads for b in mod.bucketed_read_batches(
            mixed[0], batch_size=16, max_len=4998)) == 90
        with pytest.raises(ValueError, match="exceed max_len=4992"):
            list(mod.bucketed_read_batches(mixed[0], max_len=4990))


def _equal(got, want):
    assert got[0] == want[0]
    for x, y in zip(got[1], want[1]):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("k,cutoff", [(31, None), (31, 20), (21, 20), (9, 20)])
def test_count_file_bucketed_matches_jax_and_flat(mixed, k, cutoff):
    kw = dict(batch_size=16, sparse_format="arrays", quality_cutoff=cutoff)
    got = tpipe.count_file(mixed[0], k, bucketed=True, device="cpu", **kw)
    want = jpipe.count_file(mixed[0], k, bucketed=True, **kw)
    if k <= 9:
        assert got[0] == want[0] and got[1].dtype == want[1].dtype
        np.testing.assert_array_equal(got[1], want[1])
        return
    _equal(got, want)
    flat = tpipe.count_file(mixed[0], k, host_workers=1, device="cpu", **kw)
    _equal(got, flat)


def test_count_file_bucketed_refusals(mixed, tmp_path):
    with pytest.raises(ValueError, match="mutually exclusive"):
        tpipe.count_file(mixed[0], 21, bucketed=True, host_workers=2,
                         device="cpu")
    with pytest.raises(ValueError, match="bucketed batching"):
        tpipe.count_file(mixed[0], 21, bucketed=True, device="cpu",
                         checkpoint_every=1,
                         checkpoint_path=str(tmp_path / "c.npz"))
    with pytest.raises(ValueError, match="packed transport"):
        tpipe.count_file(mixed[0], 21, bucketed=True, packed=True,
                         device="cpu")
    with pytest.raises(ValueError, match="bucketed/dense"):
        tpipe.count_file(mixed[0], (4, 21), bucketed=True, device="cpu")


def test_count_cli_bucketed_quality_matches_jax(capsys, mixed, tmp_path):
    from needletail_tpu import cli as jcli
    from needletail_tpu_torch import cli as tcli

    args = ["count", mixed[0], "-k", "31", "--bucketed", "--quality-cutoff",
            "20", "--batch-size", "16", "--top", "3"]
    outs = {}
    for name, main, extra in (("torch", tcli.main, ["--device", "cpu"]),
                              ("jax", jcli.main, [])):
        dump = tmp_path / f"{name}.tsv"
        assert main(args + extra + ["--dump", str(dump)]) == 0
        out = capsys.readouterr()
        outs[name] = (out.out, out.err, dump.read_bytes())
    assert outs["torch"] == outs["jax"]
    assert outs["torch"][1].startswith("# ")
