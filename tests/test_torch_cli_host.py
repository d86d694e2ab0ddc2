"""The port's host commands ``stats``, ``bgzip`` and ``convert`` against
``needletail-tpu``'s, in process, and a CPU twin of the card's check of the
host surface against the device.

Each command runs through both packages' ``cli.main`` on the same input:
the standard output (``stats``' JSON but for its two clock readings) and
the ``#`` lines on standard error are equal, and so are the files written,
byte for byte, over every codec of the fixtures, CRLF input and
``--unix``.  The canonical ``bit_kmers`` spectrum of ``28S.fasta`` at k=31
(``chip_smoke.host_spectrum``, vectorised through ``pack_kmers``) equals
the port's ``count_file`` on the CPU, as ``chip_smoke.py`` holds it against
the card.
"""

import contextlib
import importlib.util
import io
import json
from pathlib import Path

import numpy as np
import pytest

from needletail_tpu import cli as jcli
from needletail_tpu_torch import cli as tcli

REPO = Path(__file__).resolve().parent.parent
DATA = REPO / "tests" / "data"
CODECS = ["test.fa", "test.fa.gz", "test.fa.bz2", "test.fa.xz", "test.fa.zst"]
CLOCK = ("seconds", "bases_per_sec")  # wall-clock readings of `stats`


def run(cli, *argv):
    """``(rc or the error's (name, text), stdout, '#' lines of stderr)``."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            rc = cli.main([str(a) for a in argv])
        except (Exception, SystemExit) as exc:
            rc = (type(exc).__name__, str(exc))
    return rc, out.getvalue(), [
        line for line in err.getvalue().splitlines() if line.startswith("#")]


def both(*argv):
    """The two CLIs' outcomes of one command; the JAX one first."""
    return run(jcli, *argv), run(tcli, *argv)


def _crlf(tmp_path, name: str) -> Path:
    out = tmp_path / f"crlf_{name}"
    out.write_bytes((DATA / name).read_bytes().replace(b"\n", b"\r\n"))
    return out


def _without_clock(stdout: str) -> dict:
    out = json.loads(stdout)
    for key in CLOCK:
        assert key in out
        del out[key]
    return out


@pytest.mark.parametrize("fixture", CODECS + ["PRJNA271013_head.fq",
                                              "28S.fasta", "crlf"])
def test_stats(tmp_path, fixture):
    path = (_crlf(tmp_path, "PRJNA271013_head.fq") if fixture == "crlf"
            else DATA / fixture)
    for flags in ((), ("--composition",), ("--batch-size", "7",
                                           "--composition")):
        (jrc, jout, jerr), (trc, tout, terr) = both("stats", path, *flags)
        assert (trc, terr) == (jrc, jerr) == (0, [])
        assert _without_clock(tout) == _without_clock(jout)


def test_stats_golden_and_errors(tmp_path):
    (jrc, jout, _), (trc, tout, _) = both("stats", DATA / "PRJNA271013_head.fq")
    got = json.loads(tout)
    assert (got["reads"], got["bases"]) == (2000, 250000)
    for path in (DATA / "bad_test.fa", tmp_path / "missing.fq",
                 DATA / "random_tsv.fq"):
        (jrc, jout, jerr), (trc, tout, terr) = both("stats", path)
        assert (trc, terr) == (jrc, jerr)
        if jrc == 0:
            assert _without_clock(tout) == _without_clock(jout)
        else:
            assert tout == jout


@pytest.mark.parametrize("fixture", CODECS + ["PRJNA271013_head.fq"])
def test_bgzip(tmp_path, fixture):
    """Every codec is decoded and written again as BGZF, byte for byte as
    ``needletail-tpu bgzip`` writes it."""
    out = tmp_path / "out.bgz"
    for flags in ((), ("--block-size", "1000")):
        want = run(jcli, "bgzip", DATA / fixture, "-o", out, *flags)
        want_bytes = out.read_bytes()
        out.unlink()
        got = run(tcli, "bgzip", DATA / fixture, "-o", out, *flags)
        assert got == want
        assert want == (0, "", [f"# {len(_plain(fixture))} bytes -> {out}"])
        assert out.read_bytes() == want_bytes


def _plain(fixture: str) -> bytes:
    import needletail_tpu_torch.io as tio

    with open(DATA / fixture, "rb") as f:
        stream, _ = tio.open_uncompressed(f)
        return stream.read()


def test_bgzip_refuses_a_bad_block_size(tmp_path):
    for size in ("0", "70000"):
        j, t = both("bgzip", DATA / "test.fa", "-o", tmp_path / "x.bgz",
                    "--block-size", size)
        assert t == j and j[0][0] == "ValueError"


@pytest.mark.parametrize("fixture", ["PRJNA271013_head.fq", "test.fa.gz",
                                     "28S.fasta", "crlf"])
def test_convert(tmp_path, fixture):
    """FASTA <-> FASTQ both ways, with and without ``--unix``, the target
    named or inferred from the output's name; then a round trip."""
    path = (_crlf(tmp_path, "PRJNA271013_head.fq") if fixture == "crlf"
            else DATA / fixture)
    for out_name, flags in (("out.fa", ()), ("out.fq", ()),
                            ("out.fasta", ("--unix",)),
                            ("out.txt", ("--to", "fastq")),
                            ("out.txt", ("--to", "fasta", "--unix"))):
        out = tmp_path / out_name
        want = run(jcli, "convert", path, out, *flags)
        want_bytes = out.read_bytes()
        out.unlink()
        got = run(tcli, "convert", path, out, *flags)
        assert got == want and want[0] == 0
        assert out.read_bytes() == want_bytes
    # the round trip: FASTQ -> FASTA -> FASTQ (qualities filled with 'I')
    back = tmp_path / "back.fq"
    for cli in (jcli, tcli):
        assert run(cli, "convert", tmp_path / "out.fasta", back)[0] == 0
        data = back.read_bytes()
        back.unlink()
        assert b"\r" not in data and data.count(b"\n+\n") > 0
        if cli is jcli:
            want_back = data
    assert data == want_back


def test_convert_refuses_an_unknown_target(tmp_path):
    j, t = both("convert", DATA / "test.fa", tmp_path / "out.txt")
    assert t == j and j[0][0] == "SystemExit"


def test_host_commands_need_no_device_flag():
    for argv in (("stats", "x", "--device", "cpu"),
                 ("bgzip", "x", "-o", "y", "--device", "cpu"),
                 ("convert", "x", "y", "--device", "cpu")):
        rc, _, _ = run(tcli, *argv)
        assert rc[0] == "SystemExit"  # argparse: unrecognized argument


def test_host_spectrum_equals_count_file():
    """The CPU twin of the card's check: the canonical ``bit_kmers``
    spectrum of ``28S.fasta`` at k=31 equals ``count_file`` on the CPU, and
    the vectorised spectrum equals the generator's on a slice."""
    spec = importlib.util.spec_from_file_location("chip_smoke_host",
                                                  REPO / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    from needletail_tpu_torch import bitkmer
    from needletail_tpu_torch.device.pipeline import count_file

    path = DATA / "28S.fasta"
    keys, counts = chip_smoke.host_spectrum(path, 31)
    assert (int(counts.sum()), len(keys)) == (718_007, 283_237)
    n, (dkeys, dcounts) = count_file(str(path), 31, device="cpu",
                                     host_workers=1, sparse_format="arrays")
    assert n == 738_580
    np.testing.assert_array_equal(keys, dkeys)
    np.testing.assert_array_equal(counts, dcounts)
    assert keys.dtype == dkeys.dtype and counts.dtype == dcounts.dtype

    import needletail_tpu_torch as nt

    seq = next(iter(nt.parse_fastx_file(path))).seq.encode()[:20_000]
    values = [v for _, (v, _), _ in bitkmer.bit_kmers(seq, 31, True)]
    want_keys, want_counts = np.unique(np.asarray(values, np.uint64),
                                       return_counts=True)
    got_keys, got_counts = chip_smoke.canonical_spectrum([seq], 31)
    np.testing.assert_array_equal(got_keys, want_keys)
    np.testing.assert_array_equal(got_counts, want_counts)
