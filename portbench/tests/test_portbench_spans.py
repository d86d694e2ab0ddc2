"""The program's own spans and stages in the benchmark: the device
trace counts the profiler's device-side mirror of a ``needletail.*`` span
as no work and names the gaps as before; the meter's stages give shares
of the window; and the readers of the new per-layer metrics in tiny
traced runs on the CPU."""

import json
import types

import pytest

import _tiny
from portbench import devtrace, harness, meter_stages

NEW = ["framing.start_share", "flush.resolve_share", "flush.pull_share",
       "flush.merge_share", "flush.lane_use"]


class _Evt:
    """One event as ``kineto_results.events()`` gives it (seconds)."""

    def __init__(self, name, start, end, cuda=False, kind="", annotation=False):
        self._name, self._s, self._e = name, start, end
        self._cuda, self._kind, self._annotation = cuda, kind, annotation

    def name(self):
        return self._name

    def device_type(self):
        return "DeviceType.CUDA" if self._cuda else "DeviceType.CPU"

    def activity_type(self):
        return self._kind

    def is_user_annotation(self):
        return self._annotation

    def start_ns(self):
        return int(self._s * 1e9)

    def duration_ns(self):
        return int((self._e - self._s) * 1e9)


class _Prof:
    def __init__(self, events):
        class _Results:
            def events(_self):
                return events

        class _Profiler:
            kineto_results = _Results()

        self.profiler = _Profiler()


def _trace(program_spans_too=True):
    events = [
        _Evt(devtrace.WINDOW, 0, 10), _Evt("portbench.job", 0, 10),
        _Evt("kernel_a", 1, 2, cuda=True, kind="kernel"),
        _Evt("kernel_b", 7, 8, cuda=True, kind="kernel"),
    ]
    if program_spans_too:
        events += [
            _Evt("needletail.count_file", 0.2, 9.8),
            _Evt("needletail.flush.merge", 3, 6),
            # the profiler's mirror of a host span on the device's
            # timeline, as an H100 profile gives it: no kind, marked as a
            # user annotation
            _Evt("needletail.flush.merge", 3, 6, cuda=True, annotation=True),
        ]
    return devtrace._collect(_Prof(events))


def test_program_span_is_no_device_work():
    t = _trace()
    assert t.busy_s() == pytest.approx(2.0)
    assert [n for n, *_ in t.ops] == ["kernel_a", "kernel_b"]
    # the gaps read as with an older port, which opens no spans
    assert t.idle_gaps() == _trace(False).idle_gaps()
    assert {name for name, _ in t.idle_gaps()} == {"portbench.job"}


def _run(meters, window=(0.0, 10.0)):
    jobs = [types.SimpleNamespace(meter=m) for m in meters]
    run = types.SimpleNamespace(jobs=jobs, window_s=window[1] - window[0])
    run.meter_stage = lambda stage, key: sum(
        (j.meter or {}).get(stage, {}).get(key, 0.0) for j in jobs)
    return run


def test_stage_share_sums_the_jobs_over_the_window():
    run = _run([{"flush.merge": {"s": 1.5}}, {"flush.merge": {"s": 2.5}},
                {"wall": {"s": 3.0}}])
    assert meter_stages.share(run, "flush.merge") == pytest.approx(0.4)
    # an older port's meter, no meter, or no window: nothing to read
    assert meter_stages.share(run, "flush.resolve") is None
    assert meter_stages.share(_run([None, None]), "flush.merge") is None
    assert meter_stages.share(
        _run([{"flush.merge": {"s": 1.0}}], (0.0, 0.0)), "flush.merge") is None


@pytest.fixture(autouse=True)
def _held_cells(tmp_path, monkeypatch):
    bench = json.loads((harness.REPO / "BENCHMARK.json").read_text())
    (tmp_path / "BENCHMARK.json").write_text(
        json.dumps(_tiny.bench_with_held(bench)))
    monkeypatch.setattr(harness, "REPO", tmp_path)


# the new metrics each tiny traced run must report: the flush's where a
# metered cell lists them; the pool's start only where a pool runs
READ = {
    "spectrum21.hifi30x": {"flush.resolve_share", "flush.pull_share",
                           "flush.merge_share", "flush.lane_use"},
    "spectrum21.illumina30x": set(),
    "spectrum31.phages": set(),
    "spectrum31.bacteria": set(),
}


@pytest.mark.parametrize("cell,workers", [(c, 1) for c in sorted(READ)]
                         + [("spectrum21.hifi30x", 2)])
def test_traced_run_reads_the_port_spans(cell, workers):
    opts = {"host_workers": workers} if "21" in cell else None
    r = _tiny.run_tiny(harness, cell, trace=True, options=opts)
    assert r["correct"], r["check"]
    got = {m: r["metrics"][m]["value"] for m in NEW if m in r["metrics"]}
    want = READ[cell] | ({"framing.start_share"} if workers > 1 else set())
    assert set(got) == want
    for name, value in got.items():
        # a tiny job's one flush merges into an empty spectrum, which the
        # meter's seconds (rounded to 0.1 ms) read as none
        low = 0 <= value if name == "flush.merge_share" else 0 < value
        assert low and value <= 1, (name, value)
    assert sum(got.get(m, 0) for m in NEW if m.startswith("flush.") and
               m.endswith("_share")) <= 1
