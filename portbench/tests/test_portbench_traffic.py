"""The generator: the same seed gives the same bytes, every seed the same
sizes, and the sizes are those the traffic files state."""

import json
from pathlib import Path

import numpy as np
import pytest

import _tiny  # noqa: F401  (the import path)
from portbench.traffic import fastx

TRAFFIC = Path(fastx.__file__).resolve().parent
READS = {"genome_bp": 20000, "gc": 0.5}


def _traffic(name, **over):
    t = json.loads((TRAFFIC / f"{name}.json").read_text())
    t.update(over)
    return t


def _files(inputs):
    return [Path(p).read_bytes() for inp in inputs for p in inp.paths]


@pytest.mark.parametrize("name,config,over", [
    ("illumina30x", READS, {}),
    ("hifi30x", READS, {"length": {"mean": 2000, "sigma": 0.35,
                                   "min": 700, "max": 4000}}),
    ("bacteria", {}, {"count": 4, "size": {"median": 9000, "sigma": 0.3,
                                           "min": 3000, "max": 20000}}),
    ("phages", {}, {"count": 5, "size": {"median": 3000, "sigma": 0.6,
                                         "min": 1000, "max": 9000}}),
])
def test_same_seed_same_bytes_other_seed_same_sizes(tmp_path, name, config, over):
    t = _traffic(name, **over)
    a = fastx.generate(config, t, 2**33 + 1, tmp_path / "a")
    b = fastx.generate(config, t, 2**33 + 1, tmp_path / "b")
    c = fastx.generate(config, t, 5, tmp_path / "c")
    assert _files(a) == _files(b)
    assert _files(a) != _files(c)
    assert sorted(i.bases for i in a) == sorted(i.bases for i in c)


def test_illumina_sizes(tmp_path):
    t = _traffic("illumina30x")
    (inp,) = fastx.generate(READS, t, 3, tmp_path)
    pairs = -(-30 * 20000 // 300)
    r1, r2 = inp.seqs
    assert r1.shape == r2.shape == (pairs, 150)
    assert inp.bases == 2 * pairs * 150
    flat = np.concatenate([r1.ravel(), r2.ravel()])
    assert np.count_nonzero(flat == ord("N")) <= round(flat.size * 1e-4) + 1
    lines = Path(inp.paths[0]).read_bytes().split(b"\n")
    assert lines[0].startswith(b"@pair") and lines[0].endswith(b"/1")
    assert lines[1] == r1[0].tobytes() and lines[2] == b"+" and len(lines[3]) == 150


def test_full_size_read_totals_match_the_issue():
    # 30x of E. coli K-12 MG1655 (4,641,652 bp)
    assert -(-30 * 4641652 // 300) == 464166
    lengths = fastx.quantile_lengths(
        -(-30 * 4641652 // 15000),
        {"mean": 15000, "sigma": 0.35, "min": 5000, "max": 30000})
    assert lengths.min() >= 5000 and lengths.max() <= 30000
    assert abs(lengths.mean() - 15000) < 300


def test_hifi_total_is_exact(tmp_path):
    t = _traffic("hifi30x", length={"mean": 2000, "sigma": 0.35,
                                    "min": 700, "max": 4000})
    (inp,) = fastx.generate({"genome_bp": 30011, "gc": 0.5}, t, 9, tmp_path)
    assert inp.bases == 30 * 30011
    text = Path(inp.paths[0]).read_bytes().split(b"\n")
    seqs = text[1::4]
    assert sum(len(s) for s in seqs) == inp.bases
    assert all(700 <= len(s) <= 4000 for s in seqs)
    assert b"\n".join(seqs) + b"\n" == inp.seqs[0].tobytes()


def test_assembly_sizes_are_quantiles(tmp_path):
    t = _traffic("phages", count=7, size={"median": 3000, "sigma": 0.6,
                                          "min": 1000, "max": 9000})
    inputs = fastx.generate({}, t, 4, tmp_path)
    want = fastx.quantile_lengths(7, t["size"])
    assert sorted(i.bases for i in inputs) == sorted(want.tolist())
    for inp in inputs:
        lines = Path(inp.paths[0]).read_bytes().split(b"\n")
        assert lines[0].startswith(b">") and max(len(x) for x in lines[1:]) <= 80
        assert b"".join(lines[1:]) == inp.seqs[0].tobytes()
