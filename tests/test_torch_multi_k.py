"""The port's one-pass multi-k counting against the JAX package's.

``multi_k_count_file``, ``count_file`` with a tuple ``k`` and
``multi_k_tally`` on the first 200 reads of the FASTQ corpus, the port on
the CPU; ``multik`` checkpoints written by either package and resumed by
the other; ``count -k 4,21`` printing what JAX's CLI prints.  All integer:
tolerance 0.
"""

import os
from pathlib import Path

import numpy as np
import pytest
import torch

from needletail_tpu.device import pipeline as jpipe
from needletail_tpu_torch.checkpoint import (
    load_stream_checkpoint,
    save_stream_checkpoint,
)
from needletail_tpu_torch.device import pipeline as tpipe

FQ = "tests/data/PRJNA271013_head.fq"
KS = (4, 11, 21, 31)  # dense, densified, sparse, wide sparse
RUN = dict(batch_size=64, max_len=128, host_workers=1)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in parallel worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def head(tmp_path_factory):
    """The first 200 reads: four batches of 64 and a short one."""
    lines = Path(FQ).read_bytes().split(b"\n")[: 200 * 4]
    p = tmp_path_factory.mktemp("torch_multik") / "head.fq"
    p.write_bytes(b"\n".join(lines) + b"\n")
    return str(p)


@pytest.fixture(scope="module")
def jax_ref(head):
    return jpipe.multi_k_count_file(head, KS, **RUN)


def _equal(got, want):
    assert got[0] == want[0]
    assert list(got[1]) == list(want[1])
    for k, b in want[1].items():
        a = got[1][k]
        if isinstance(b, tuple):
            for x, y in zip(a, b):
                assert x.dtype == y.dtype, k
                np.testing.assert_array_equal(x, y, err_msg=str(k))
        elif isinstance(b, dict):
            assert a == b, k
        else:
            assert a.dtype == b.dtype == np.int64, k
            np.testing.assert_array_equal(a, b, err_msg=str(k))


@pytest.mark.parametrize("packed", [True, False])
def test_multi_k_count_file_matches_jax(head, jax_ref, packed):
    got = tpipe.multi_k_count_file(head, KS, packed=packed, device="cpu", **RUN)
    _equal(got, jax_ref)
    assert int(got[1][21][1].sum()) > 0


def test_count_file_tuple_k_matches_jax(head, jax_ref):
    """``count_file`` with a tuple delegates (order and repeats of k do not
    matter); its default format is the dict, as JAX's."""
    got = tpipe.count_file(head, k=(31, 4, 21, 11, 4), device="cpu", **RUN)
    want = jpipe.count_file(head, k=(31, 4, 21, 11, 4), **RUN)
    _equal(got, want)
    assert isinstance(got[1][21], dict)
    _equal(
        (got[0], {k: got[1][k] for k in (4, 11)}),
        (jax_ref[0], {k: jax_ref[1][k] for k in (4, 11)}),
    )


def test_multi_k_refusals(head):
    with pytest.raises(ValueError, match="bucketed/dense"):
        tpipe.count_file(head, k=(4, 21), dense=True, device="cpu")
    with pytest.raises(ValueError, match="non-empty"):
        tpipe.multi_k_count_file(head, (), device="cpu")
    with pytest.raises(ValueError, match="every k"):
        tpipe.multi_k_count_file(head, (4, 32), device="cpu")
    with pytest.raises(ValueError, match="packed transport"):
        tpipe.multi_k_count_file(head, (4, 21), quality_cutoff=20,
                                 packed=True, device="cpu")


@pytest.mark.parametrize("canonical,normalized", [
    (True, True), (False, True), (True, False),
])
def test_multi_k_tally_matches_jax(canonical, normalized):
    import jax.numpy as jnp

    from needletail_tpu_torch.utils.synth import random_reads

    seqs, lengths = random_reads(np.random.default_rng(9), 32, 90, dirty_frac=0.4)
    ks = (3, 16, 17, 31)
    got = tpipe.multi_k_tally(torch.from_numpy(seqs), torch.from_numpy(lengths),
                              ks, canonical, normalized)
    want = jpipe.multi_k_tally(jnp.asarray(seqs), jnp.asarray(lengths), ks,
                               canonical, normalized)
    assert list(got) == list(want)
    for k in ks:
        assert tuple(int(x) for x in got[k]) == tuple(int(x) for x in want[k])


class _Interrupt(Exception):
    pass


class _StopAfter:
    """A meter that stops the port's driver at its n-th step."""

    def __init__(self, n):
        self.n = n
        self.steps = 0

    def add(self, name, seconds, nbytes=0, items=0):
        if name == "dispatch":
            self.steps += 1
            if self.steps == self.n:
                raise _Interrupt


def _jax_checkpoint(head, ck, tmp_path):
    """A JAX ``multik`` checkpoint after the first two batches: JAX runs
    the byte prefix those batches cover, then the file is rebased onto the
    whole corpus."""
    from needletail_tpu.io.fast_batch import fast_read_batches

    it = iter(fast_read_batches(head, batch_size=64, max_len=128))
    next(it)
    off = next(it).file_offset
    it.close()
    prefix = tmp_path / "prefix.fq"
    prefix.write_bytes(Path(head).read_bytes()[:off])
    jpipe.multi_k_count_file(str(prefix), KS, checkpoint_every=2,
                             checkpoint_path=ck, **RUN)
    saved = load_stream_checkpoint(ck)
    save_stream_checkpoint(ck, saved["kind"], saved["k"], off,
                           saved["n_bases"], saved["arrays"],
                           input_path=head, meta=saved["meta"])


def _torch_checkpoint(head, ck, tmp_path):
    with pytest.raises(_Interrupt):
        tpipe.multi_k_count_file(head, KS, checkpoint_every=1,
                                 checkpoint_path=ck, meter=_StopAfter(3),
                                 device="cpu", **RUN)


@pytest.mark.parametrize("writer,reader", [
    ("torch", "torch"), ("jax", "torch"), ("torch", "jax"),
])
def test_multik_checkpoint_resumes(head, jax_ref, tmp_path, writer, reader):
    ck = str(tmp_path / f"{writer}.npz")
    {"torch": _torch_checkpoint, "jax": _jax_checkpoint}[writer](head, ck, tmp_path)
    saved = load_stream_checkpoint(ck)
    assert saved["kind"] == "multik" and saved["k"] == 0
    assert tuple(int(x) for x in saved["meta"]["ks"]) == KS
    assert 0 < saved["file_offset"] < os.path.getsize(head)
    assert {"dense_4", "keys_11", "counts_31"} <= set(saved["arrays"])
    if reader == "torch":
        got = tpipe.multi_k_count_file(head, KS, resume_from=ck, device="cpu",
                                       **RUN)
    else:
        got = jpipe.multi_k_count_file(head, KS, resume_from=ck, **RUN)
    _equal(got, jax_ref)


def test_sharded_multik_checkpoint_resumes(head, jax_ref, tmp_path):
    """A ``sharded_multik`` file, with k=11 stored as a dense table as the
    sharded driver may store it, resumes in the port."""
    ck = str(tmp_path / "sharded.npz")
    _torch_checkpoint(head, ck, tmp_path)
    saved = load_stream_checkpoint(ck)
    arrays = dict(saved["arrays"])
    table = np.zeros(4**11, np.int64)
    table[arrays.pop("keys_11").astype(np.int64)] = arrays.pop("counts_11")
    arrays["dense_11"] = table
    save_stream_checkpoint(ck, "sharded_multik", 0, saved["file_offset"],
                           saved["n_bases"], arrays, input_path=head,
                           meta=saved["meta"])
    got = tpipe.multi_k_count_file(head, KS, resume_from=ck, device="cpu", **RUN)
    _equal(got, jax_ref)
    with pytest.raises(ValueError, match="ks="):
        tpipe.multi_k_count_file(head, (4, 21), resume_from=ck, device="cpu",
                                 **RUN)
    with pytest.raises(ValueError, match="kind=sharded_multik"):
        tpipe.count_file(head, 21, resume_from=ck, device="cpu", **RUN)


def test_count_cli_multi_k_matches_jax(head, capsys, tmp_path):
    from needletail_tpu import cli as jcli
    from needletail_tpu_torch import cli as tcli

    args = ["count", head, "-k", "4,21", "--batch-size", "64",
            "--host-workers", "1", "--top", "3"]
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
    assert terr[-1].endswith("(2 k values in one pass)")
    assert tnpz.keys() == jnpz.keys()
    for key in jnpz:
        assert tnpz[key].dtype == jnpz[key].dtype
        np.testing.assert_array_equal(tnpz[key], jnpz[key])
