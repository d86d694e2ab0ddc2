"""The port's host side: it stands without the JAX package, and frames
exactly as the JAX package does.

A subprocess refuses every import of ``needletail_tpu`` (and of JAX) through
a ``sys.meta_path`` finder installed by ``sitecustomize``, so spawned
framing workers refuse them too; in it the port imports every module,
imports ``chip_smoke`` and runs the hash, exact, multi-k, genome,
quality, bucketed, minimizer and filter drivers and the ``filter`` and
``minimizers`` commands on the CPU.  The port's copies
of the framers, batches and codecs then produce the JAX package's batches,
field for field, over every fixture.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from needletail_tpu.io import fast_batch as jfb
from needletail_tpu_torch import encoding as tenc
from needletail_tpu_torch.io import fast_batch as tfb

REPO = Path(__file__).resolve().parent.parent
DATA = REPO / "tests" / "data"
FIXTURES = [
    "28S.fasta", "PRJNA271013_head.fq", "random_tsv.fq", "test.fa",
    "test.fa.gz", "test.fa.bz2", "test.fa.xz", "test.fa.zst",
]

BLOCKER = '''
import sys


class _Refuse:
    """Refuses the JAX package and JAX itself (not the port)."""

    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("needletail_tpu", "jax", "jaxlib"):
            raise ImportError(f"blocked import of {name}")
        return None


sys.meta_path.insert(0, _Refuse())
'''

CHECK = '''
import importlib
import pkgutil
import sys

import needletail_tpu_torch

names = [m.name for m in pkgutil.walk_packages(
    needletail_tpu_torch.__path__, "needletail_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke  # noqa: F401

from needletail_tpu_torch.device.pipeline import count_file, hash_count_file
from needletail_tpu_torch.io import native

assert native.available(), "the port's native framer did not load"
fq = "tests/data/PRJNA271013_head.fq"
h = hash_count_file(fq, 21, batch_size=512, max_len=128, device="cpu",
                    host_workers=2)
assert h[:3] == (250000, 209965, 106181), h[:3]
n, (keys, counts) = count_file(fq, 21, batch_size=512, max_len=128,
                               device="cpu", host_workers=2,
                               sparse_format="arrays")
assert (n, int(counts.sum())) == (250000, 209965), (n, counts.sum())

import os
import tempfile

from needletail_tpu_torch.device.pipeline import multi_k_count_file
from needletail_tpu_torch.device.tiling import genome_spectrum
from needletail_tpu_torch.utils.synth import synthetic_genome

n, spec = multi_k_count_file(fq, (4, 21), batch_size=512, max_len=128,
                             device="cpu", host_workers=2)
assert (n, int(spec[4].sum()), int(spec[21][1].sum())) == (
    250000, 243982, 209965), (n, spec[4].sum(), spec[21][1].sum())
fa = os.path.join(tempfile.mkdtemp(), "genome.fa")
with open(fa, "wb") as f:
    f.write(synthetic_genome(20000, seed=1))
n, (keys, counts) = genome_spectrum(fa, 31, tile_len=1024, device="cpu",
                                    sparse_format="arrays")
assert (n, int(counts.sum())) == (20000, 20000 - 30), (n, counts.sum())
from needletail_tpu_torch import cli
from needletail_tpu_torch.device.pipeline import (
    minimizer_spectrum_file, quality_filter_file,
)

n, (keys, counts) = count_file(fq, 21, batch_size=512, max_len=128,
                               device="cpu", host_workers=2,
                               quality_cutoff=20, sparse_format="arrays")
assert (n, int(counts.sum()), len(keys)) == (250000, 146651, 116744), (
    n, counts.sum(), len(keys))
n, (keys, counts) = count_file(fq, 31, batch_size=512, device="cpu",
                               bucketed=True, sparse_format="arrays")
assert (n, int(counts.sum()), len(keys)) == (250000, 189960, 153526), (
    n, counts.sum(), len(keys))
n, (keys, counts) = minimizer_spectrum_file(fq, 21, 11, batch_size=512,
                                            max_len=128, device="cpu",
                                            host_workers=2)
assert (n, len(keys), int(counts.sum())) == (250000, 28606, 189960), (
    n, len(keys), counts.sum())
kept = os.path.join(tempfile.mkdtemp(), "kept.fq")
assert quality_filter_file(fq, kept, 30, device="cpu") == (2000, 1732)
import contextlib
import io

with contextlib.redirect_stdout(io.StringIO()) as printed:
    assert cli.main(["filter", fq, kept, "--min-quality", "30",
                     "--device", "cpu"]) == 0
    assert cli.main(["minimizers", fq, "-k", "21", "-w", "11", "--top", "1",
                     "--device", "cpu"]) == 0
assert printed.getvalue().splitlines() == [
    '{"reads_in": 2000, "reads_kept": 1732}',
    "AAGAGCGTCGTGTAGGGAAAG\t586",
], printed.getvalue()
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("needletail_tpu", "jax", "jaxlib"))
assert not leaked, leaked
print("ok", len(names))
'''


def test_port_runs_with_the_jax_package_refused(tmp_path):
    (tmp_path / "sitecustomize.py").write_text(BLOCKER)
    env = dict(
        os.environ,
        PYTHONPATH=os.pathsep.join([str(tmp_path), str(REPO)]),
        OMP_NUM_THREADS="1",
    )
    out = subprocess.run(
        [sys.executable, "-c", CHECK], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=600,
    )
    assert out.returncode == 0, out.stderr[-4000:]
    words = out.stdout.split()
    assert words[0] == "ok" and int(words[1]) > 25, out.stdout


def test_blocker_refuses_the_jax_package(tmp_path):
    """The finder above does refuse what it should, and only that."""
    (tmp_path / "sitecustomize.py").write_text(BLOCKER)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(tmp_path), str(REPO)]))
    code = (
        "import needletail_tpu_torch.batch\n"
        "try:\n    import needletail_tpu.batch\nexcept ImportError:\n"
        "    print('refused')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "refused"


def test_no_source_names_the_jax_package():
    """No module of the port and nothing in chip_smoke.py imports or names
    ``needletail_tpu`` (the port's own name aside)."""
    pattern = re.compile(r"needletail_tpu(?!_torch)[ .]")
    files = sorted((REPO / "needletail_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    offenders = []
    for f in files:
        for i, line in enumerate(f.read_text().splitlines(), 1):
            if pattern.search(line) and "pallas_kernels.py" not in line:
                offenders.append(f"{f.relative_to(REPO)}:{i}: {line.strip()}")
    assert not offenders, offenders


def test_encode_tables_match():
    from needletail_tpu import encoding as jenc

    for name in ("ENCODE_RAW_LUT", "ENCODE_NORMALIZED_LUT"):
        np.testing.assert_array_equal(getattr(tenc, name), getattr(jenc, name))


@pytest.mark.parametrize("normalized", [True, False])
def test_host_packers_match(normalized):
    from needletail_tpu import encoding as jenc
    from needletail_tpu_torch.utils.synth import random_reads

    rng = np.random.default_rng(7)
    seqs, lengths = random_reads(rng, 64, 152, dirty_frac=0.3)
    got = tenc.pack_codes_host_rows(seqs, lengths, normalized=normalized)
    want = jenc.pack_codes_host_rows(seqs, lengths, normalized=normalized)
    for a, b in zip(got, want):
        if b is None:
            assert a is None
        else:
            np.testing.assert_array_equal(a, b)


def _crlf_fastq(tmp_path) -> str:
    p = tmp_path / "crlf.fq"
    p.write_bytes((DATA / "PRJNA271013_head.fq").read_bytes().replace(b"\n", b"\r\n"))
    return str(p)


def _fields(batch):
    """Every array and scalar a batch carries, by name."""
    out = {}
    for name, value in vars(batch).items():
        if name.startswith("_"):
            continue
        out[name] = list(value) if name == "ids" else value
    return out


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert type(g).__name__ == type(w).__name__
        gf, wf = _fields(g), _fields(w)
        assert gf.keys() == wf.keys()
        for name in wf:
            a, b = gf[name], wf[name]
            if isinstance(b, np.ndarray):
                assert a.dtype == b.dtype, name
                np.testing.assert_array_equal(a, b, err_msg=name)
            else:
                assert a == b, name
        if hasattr(w, "wire_frame"):
            (gbuf, glay) = g.wire_frame(g.num_reads)
            (wbuf, wlay) = w.wire_frame(w.num_reads)
            np.testing.assert_array_equal(gbuf, wbuf)
            assert tuple(glay) == tuple(wlay)


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("fixture", FIXTURES + ["crlf"])
def test_framing_matches_jax(tmp_path, fixture, packed):
    path = _crlf_fastq(tmp_path) if fixture == "crlf" else str(DATA / fixture)
    kw = dict(batch_size=700, packed=packed, with_ids=True)
    if fixture.endswith(".fq") or fixture == "crlf":
        kw["max_len"] = 128
    try:
        want = list(jfb.fast_read_batches(path, **kw))
    except Exception as exc:  # a malformed fixture: the same error
        with pytest.raises(Exception) as got_exc:
            list(tfb.fast_read_batches(path, **kw))
        assert type(got_exc.value).__name__ == type(exc).__name__
        assert str(got_exc.value) == str(exc)
        return
    got = list(tfb.fast_read_batches(path, **kw))
    assert got
    _assert_batches_equal(got, want)


@pytest.mark.parametrize("packed", [True, False])
def test_range_framing_matches_jax(packed):
    """The byte-range framer the spawn workers run, over the record-aligned
    ranges of a three-way split."""
    from needletail_tpu_torch.io.framing import split_fastx_ranges

    path = str(DATA / "PRJNA271013_head.fq")
    ranges = split_fastx_ranges(path, 3)
    assert len(ranges) == 3
    for start, end in ranges:
        kw = dict(batch_size=300, max_len=128, packed=packed)
        _assert_batches_equal(
            list(tfb.fast_read_batches_range(path, start, end, **kw)),
            list(jfb.fast_read_batches_range(path, start, end, **kw)),
        )
