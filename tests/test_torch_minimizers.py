"""The port's minimizers against the JAX package's.

``global_minimizer`` and ``window_minimizers`` over seeded reads with N
bases and short rows, ``window_minimizers_from_planes`` over the key-plane
kernel's plain planes (the card's route; keys whose ``lo`` has bit 31 set,
which a signed compare of the int32 planes would misorder, are asserted
present), and ``minimizer_spectrum_file`` end to end: packed, ASCII, over
several files, through checkpoints either package writes, and the
``minimizers`` CLI.  Integer code: tolerance 0, invalid positions
included.
"""

import os
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from needletail_tpu.device import minimizers as jm
from needletail_tpu.device import pipeline as jpipe
from needletail_tpu_torch.device import kernels as tk
from needletail_tpu_torch.device import minimizers as tm
from needletail_tpu_torch.device import pipeline as tpipe
from needletail_tpu_torch.utils.synth import packed_batch, random_reads
from needletail_tpu_torch.device.ops import resolve_vbits, unwire

FQ = "tests/data/PRJNA271013_head.fq"
KS = [5, 15, 16, 21, 31]
WS = [1, 2, 5, 11]
RUN = dict(batch_size=512, host_workers=1, max_len=128)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in parallel worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def reads():
    """Dirty and clean reads of every length up to 72 (short rows hold no
    window, or fewer than w)."""
    rng = np.random.default_rng(1201)
    return random_reads(rng, 32, 72, dirty_frac=0.4)


def _u32(t):
    return t.numpy().view(np.uint32)


def _assert_sketch_equal(got, want):
    """Every lane: hi, lo and valid, invalid positions too."""
    for name in ("hi", "lo", "valid", "was_rc"):
        g = getattr(got, name)
        w = np.asarray(getattr(want, name))
        assert tuple(g.shape) == w.shape, name
        g = _u32(g) if name in ("hi", "lo") else g.numpy()
        np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("k", KS)
def test_global_minimizer_matches_jax(reads, k):
    seqs, lengths = reads
    got = tm.global_minimizer(torch.from_numpy(seqs), torch.from_numpy(lengths), k)
    want = jm.global_minimizer(jnp.asarray(seqs), jnp.asarray(lengths), k)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(_u32(g), np.asarray(w))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert not got[2].all() and got[2].any()


@pytest.mark.parametrize("w", WS)
@pytest.mark.parametrize("k", KS)
def test_window_minimizers_match_jax(reads, k, w):
    seqs, lengths = reads
    got = tm.window_minimizers(
        torch.from_numpy(seqs), torch.from_numpy(lengths), k, w
    )
    want = jm.window_minimizers(jnp.asarray(seqs), jnp.asarray(lengths), k, w)
    _assert_sketch_equal(got, want)
    assert got.hi.shape[1] == seqs.shape[1] - k - w + 2


@pytest.mark.parametrize("w", [2, 11])
@pytest.mark.parametrize("k", [15, 16, 21, 31])
@pytest.mark.parametrize("vmode", [None, 0, 1, 2])
def test_sketch_from_planes_matches_jax(reads, k, w, vmode):
    """The card's route, with the planes of the key-plane kernel's plain
    version: ASCII (vmode None) and packed in each validity shape."""
    seqs, lengths = reads
    if vmode == 0:  # the clean wire: no ambiguous base
        seqs, lengths = random_reads(np.random.default_rng(1202), 32, 72)
    if vmode is None:
        khi, klo, _, _ = tk.canonical_key_planes_plain(
            torch.from_numpy(seqs), torch.from_numpy(lengths), k
        )
    else:
        buf, layout = packed_batch(seqs, lengths, vmode).wire_frame(32)
        codes, ln, vbits, vrow_idx, vrows = unwire(torch.from_numpy(buf), layout)
        vb = resolve_vbits(vbits, vrow_idx, vrows, 32)
        khi, klo, _, _ = tk.canonical_key_planes_packed_plain(codes, vb, ln, k)
    got = tm.window_minimizers_from_planes(khi, klo, k, w)
    want = jm.window_minimizers(jnp.asarray(seqs), jnp.asarray(lengths), k, w)
    _assert_sketch_equal(got, want)
    if k >= 16:
        # keys whose lo reads negative as int32 enter the sketch, and for
        # k > 16 (lo bit 31 a middle base) some of them win
        assert bool(((khi != -1) & (klo < 0)).any())
    if k > 16:
        assert bool((got.valid & (got.lo < 0)).any())


def test_sketch_orders_lo_as_unsigned():
    """Two keys with one hi: lo 0x7FFFFFFF is smaller than lo 0x80000000,
    which reads as negative in the int32 plane."""
    hi = torch.tensor([[5, 5, -1]], dtype=torch.int32)
    lo = torch.tensor([[0x7FFFFFFF, -(1 << 31), -1]], dtype=torch.int32)
    got = tm.window_minimizers_from_planes(hi, lo, 1, 2)
    assert got.valid.tolist() == [[True, False]]
    assert got.hi.tolist() == [[5, 5]]
    assert got.lo.tolist() == [[0x7FFFFFFF, -(1 << 31)]]


def test_refusals(reads):
    seqs, lengths = reads
    s, ln = torch.from_numpy(seqs), torch.from_numpy(lengths)
    with pytest.raises(ValueError, match="w must be >= 1"):
        tm.window_minimizers(s, ln, 21, 0)
    with pytest.raises(ValueError, match="shorter than w"):
        tm.window_minimizers(s, ln, 21, 60)
    with pytest.raises(NotImplementedError, match="parallel/"):
        tpipe.minimizer_spectrum_file(FQ, 21, 11, mesh=object(), device="cpu")


def _equal(got, want):
    assert got[0] == want[0]
    for x, y in zip(got[1], want[1]):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("k,w", [(21, 11), (15, 5)])
def test_minimizer_spectrum_file_matches_jax(k, w, packed):
    got = tpipe.minimizer_spectrum_file(FQ, k, w, packed=packed,
                                        device="cpu", **RUN)
    want = jpipe.minimizer_spectrum_file(FQ, k, w, packed=packed, **RUN)
    _equal(got, want)
    assert got[0] == 250_000 and got[1][0].size > 0


def test_minimizer_spectrum_several_files(tmp_path):
    """A list of paths accumulates one sketch; a file of reads shorter
    than k + w - 1 adds only its bases."""
    short = tmp_path / "short.fq"
    short.write_bytes(b"@s\nACGTACGTACGTACGTACGTAC\n+\nIIIIIIIIIIIIIIIIIIIIII\n" * 9)
    paths = [FQ, str(short), FQ]
    got = tpipe.minimizer_spectrum_file(paths, 21, 11, device="cpu", **RUN)
    want = jpipe.minimizer_spectrum_file(paths, 21, 11, **RUN)
    _equal(got, want)
    one = tpipe.minimizer_spectrum_file(FQ, 21, 11, device="cpu", **RUN)
    assert got[0] == 2 * one[0] + 9 * 22
    np.testing.assert_array_equal(got[1][1], 2 * one[1][1])
    as_dict = tpipe.minimizer_spectrum_file(FQ, 21, 11, sparse_format="dict",
                                            device="cpu", **RUN)
    assert as_dict[1] == jpipe.minimizer_spectrum_file(
        FQ, 21, 11, sparse_format="dict", **RUN)[1]


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
    p = tmp_path_factory.mktemp("torch_minimizer_ckpt") / "reads.fq"
    p.write_bytes(Path(FQ).read_bytes() * 2)
    return str(p)


@pytest.mark.parametrize("writer,reader", [
    ("torch", "torch"), ("jax", "torch"), ("torch", "jax"),
])
def test_minimizer_checkpoint_resumes(corpus2, tmp_path, writer, reader):
    from needletail_tpu_torch.checkpoint import load_stream_checkpoint

    drivers = {
        "torch": lambda *a, **kw: tpipe.minimizer_spectrum_file(
            *a, device="cpu", **kw),
        "jax": jpipe.minimizer_spectrum_file,
    }
    ck = str(tmp_path / f"{writer}.npz")
    with pytest.raises(_Interrupt):
        drivers[writer](corpus2, 21, 11, checkpoint_every=1,
                        checkpoint_path=ck, meter=_StopAfter(4), **RUN)
    saved = load_stream_checkpoint(ck)
    assert saved["kind"] == "minimizer" and saved["k"] == 21
    assert int(saved["meta"]["w"]) == 11
    assert 0 < saved["file_offset"] < os.path.getsize(corpus2)
    got = drivers[reader](corpus2, 21, 11, resume_from=ck, **RUN)
    _equal(got, jpipe.minimizer_spectrum_file(corpus2, 21, 11, **RUN))
    with pytest.raises(ValueError, match="expected w=5"):
        tpipe.minimizer_spectrum_file(corpus2, 21, 5, resume_from=ck,
                                      device="cpu", **RUN)


def test_minimizers_cli_matches_jax(capsys, tmp_path):
    from needletail_tpu import cli as jcli
    from needletail_tpu_torch import cli as tcli

    args = ["minimizers", FQ, "-k", "21", "-w", "11", "--top", "5"]
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
    (tout, terr, tdump, tnpz), (jout, jerr, jdump, jnpz) = (
        outs["torch"], outs["jax"])
    assert tout == jout and terr == jerr and tdump == jdump
    assert terr == ["# 250000 bases, 28606 distinct (11,21)-minimizers, "
                    "189960 winning windows"]
    assert tnpz.keys() == jnpz.keys()
    for key in jnpz:
        assert tnpz[key].dtype == jnpz[key].dtype
        np.testing.assert_array_equal(tnpz[key], jnpz[key])
