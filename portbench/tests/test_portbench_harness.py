"""Whole runs of the harness on the CPU at tiny sizes: each cell proves
correct, the control and each fault a cell can have come out as not
correct, and a cell added as data files alone is found and run."""

import json
import shutil

import pytest

import _tiny
from portbench import harness

CELLS = sorted(_tiny.TINY)


@pytest.fixture(autouse=True)
def _held_cells(tmp_path, monkeypatch):
    """Run against a copy of ``BENCHMARK.json`` with the held cells added
    back, as data alone."""
    bench = json.loads((harness.REPO / "BENCHMARK.json").read_text())
    (tmp_path / "BENCHMARK.json").write_text(
        json.dumps(_tiny.bench_with_held(bench)))
    monkeypatch.setattr(harness, "REPO", tmp_path)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_is_correct(cell):
    r = _tiny.run_tiny(harness, cell)
    assert r["correct"], r["check"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert set(r["metrics"]) == {
        m["name"] for m in harness.load_cell(cell).end_to_end}
    assert list(r)[-1] == "check"


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reads_the_program_spans(cell):
    r = _tiny.run_tiny(harness, cell, trace=True)
    assert r["correct"], r["check"]
    share = {"spectrum31.bacteria": "flush.share.genomes",
             "spectrum31.phages": "flush.share.phages"}.get(
                 cell, "flush.share.reads")
    assert 0 < r["metrics"][share]["value"] < 1
    if "21" in cell:
        assert 0 <= r["metrics"]["driver.wait_share"]["value"] < 1
        assert r["metrics"]["framing.mb_per_s"]["value"] > 0
    # no card: no device operation, so no device metric
    assert "device.idle_share" not in r["metrics"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    # the control: the program's own forward-strand path, which breaks
    # the canonical guarantee the configuration states
    r = _tiny.run_tiny(harness, cell, options={"canonical": False})
    assert not r["correct"]
    assert r["check"]["keys_off"]["value"] > r["check"]["keys_off"]["max"]


def _keep_nothing(self, hi, lo):
    """A step that returns its state unchanged."""


def _keep_half(add):
    """Half of the batch left out: every second lane's key becomes the
    invalid-window sentinel, wherever the real lanes lie."""
    def half(self, hi, lo):
        lo = lo.clone()
        lo[1::2] = -1
        if hi is not None:
            hi = hi.clone()
            hi[1::2] = -1
        return add(self, hi, lo)
    return half


def _alter_one(finalize):
    def altered(*args, **kwargs):
        keys, counts = finalize(*args, **kwargs)
        counts = counts.copy()
        if counts.size:
            counts[counts.size // 2] += 1
        return keys, counts
    return altered


@pytest.mark.parametrize("fault", ["state_unchanged", "half_the_batch",
                                   "answer_altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(cell, fault, monkeypatch):
    from needletail_tpu_torch.device import count

    acc = count.SparseSpectrumAccumulator
    if fault == "state_unchanged":
        monkeypatch.setattr(acc, "add", _keep_nothing)
    elif fault == "half_the_batch":
        monkeypatch.setattr(acc, "add", _keep_half(acc.add))
    else:
        monkeypatch.setattr(count, "finalize_sparse",
                            _alter_one(count.finalize_sparse))
    r = _tiny.run_tiny(harness, cell)
    assert not r["correct"]
    assert r["check"]["keys_off"]["value"] > 0


def test_a_failing_job_is_counted(monkeypatch):
    from needletail_tpu_torch.device import count

    finalize = count.finalize_sparse
    calls = []

    def boom(*a, **k):
        # the two warm-up jobs pass; every job of the window fails
        calls.append(1)
        if len(calls) > 2:
            raise RuntimeError("planted")
        return finalize(*a, **k)

    monkeypatch.setattr(count, "finalize_sparse", boom)
    r = _tiny.run_tiny(harness, "spectrum31.phages")
    assert not r["correct"]
    assert r["failed"] == r["attempted"] >= 1
    assert r["check"]["jobs_failed"]["value"] == r["failed"]


def test_a_failing_warm_up_fails_the_run(monkeypatch):
    from needletail_tpu_torch.device import count

    def boom(*a, **k):
        raise RuntimeError("planted")

    monkeypatch.setattr(count, "finalize_sparse", boom)
    with pytest.raises(RuntimeError, match="planted"):
        _tiny.run_tiny(harness, "spectrum31.phages")


def test_cell_added_as_data_alone_is_found(tmp_path, monkeypatch):
    root = tmp_path / "portbench"
    for part in ("configs", "traffic", "metrics"):
        shutil.copytree(harness.ROOT / part, root / part)
    shutil.copy(harness.ROOT / "kernels.json", root)
    bench = json.loads((harness.REPO / "BENCHMARK.json").read_text())
    # a new mix: shorter single-end reads, and a new per-layer metric
    mix = json.loads((root / "traffic" / "illumina30x.json").read_text())
    mix.update(read_len=100)
    (root / "traffic" / "se100.json").write_text(json.dumps(mix))
    (root / "metrics" / "jobs_in_window.py").write_text(
        "def read(run):\n    return len(run.jobs)\n")
    bench["workloads"].append({"name": "spectrum21.se100", "config":
                               "reads_k21_spectrum", "traffic": "se100",
                               "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "jobs_in_window", "unit": "jobs",
                               "better": "higher", "source": "host_clock",
                               "layer": "driver", "moves": "bases_per_s",
                               "workloads": ["spectrum21.se100"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    monkeypatch.setattr(harness, "ROOT", root)
    monkeypatch.setattr(harness, "REPO", tmp_path)
    r = harness.run_cell("spectrum21.se100", 11, 0.2, True, device="cpu",
                         options={"host_workers": 1},
                         config={"genome_bp": 9000}, traffic={"coverage": 3})
    assert r["correct"], r["check"]
    assert r["metrics"]["jobs_in_window"]["value"] == r["attempted"]
    assert "transfer.h2d_gb_per_s" not in r["metrics"]


def test_config_names_its_own_reference(tmp_path, monkeypatch):
    # a configuration whose answer has another shape brings its own
    # reference and comparison as a new module, with no edit elsewhere
    (tmp_path / "bases_only_ref.py").write_text(
        "def answer(inp, options):\n"
        "    return inp.bases\n"
        "def compare(got, want):\n"
        "    return {'bases_off': abs(int(got[0]) - want)}\n")
    monkeypatch.syspath_prepend(str(tmp_path))
    config = dict(_tiny.TINY["spectrum31.phages"][0],
                  reference="bases_only_ref:answer",
                  compare="bases_only_ref:compare",
                  limits={"bases_off": 0})
    r = harness.run_cell("spectrum31.phages", 5, 0.2, False, device="cpu",
                         config=config, traffic=_tiny.TINY["spectrum31.phages"][1])
    assert r["correct"], r["check"]
    assert set(r["check"]) == {"bases_off", "checked", "jobs_failed"}


def test_one_answer_is_kept_for_each_checked_input():
    picks = []
    for seed in range(400):
        kept = harness._Kept({0, 2}, seed)
        for job in range(12):
            kept.offer(job % 3, job)
        assert set(kept.answers) == {0, 2}
        assert kept.answers[2] % 3 == 2
        picks.append(kept.answers[0])
    # a uniform sample of input 0's four answers (jobs 0, 3, 6, 9)
    assert {picks.count(j) for j in (0, 3, 6, 9)} <= set(range(70, 131))
    again = harness._Kept({0}, 7)
    first = harness._Kept({0}, 7)
    for job in range(9):
        again.offer(0, job)
        first.offer(0, job)
    assert again.answers == first.answers


def test_check_sample_holds_the_largest():
    sizes = [5, 9, 2, 7, 1]
    for seed in range(20):
        got = harness._check_set(5, sizes, 3, seed)
        assert 1 in got and len(got) == 3
    assert harness._check_set(5, sizes, 9, 1) == set(range(5))


@pytest.mark.cuda
def test_cell_on_the_card():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    config, traffic, opts = _tiny.TINY["spectrum31.phages"]
    r = harness.run_cell("spectrum31.phages", 3, 1.0, True, options=opts,
                         config=config, traffic=traffic)
    assert r["correct"], r["check"]
    assert r["device"]["busy_s"] > 0
    assert 0 < r["metrics"]["device.idle_share"]["value"] < 1
