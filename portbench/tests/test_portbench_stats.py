"""Window, rate and percentile arithmetic, the interval union, and the
work counts behind the rooflines."""

import math

import numpy as np
import pytest

import _tiny  # noqa: F401  (the import path)
from portbench import devtrace, harness, peaks, stats


def test_window_and_rate():
    jobs = [(10.0, 12.0), (12.0, 15.5), (15.5, 16.0)]
    assert stats.window_s(jobs) == 6.0
    assert stats.rate(300, stats.window_s(jobs)) == 50.0
    assert stats.rate(5, 0.0) == 0.0


@pytest.mark.parametrize("n", [1, 2, 7, 100, 101])
def test_percentile_matches_numpy(n):
    xs = list(np.random.default_rng(n).random(n))
    for q in (0, 50, 90, 100):
        assert math.isclose(stats.percentile(xs, q), float(np.percentile(xs, q)))


def test_union_counts_overlaps_once():
    iv = [(0, 2), (1, 3), (5, 6), (5.5, 5.7), (9, 12)]
    assert stats.union_length(iv, 0, 10) == 3 + 1 + 1
    assert stats.gaps(iv, 0, 10) == [(3, 5), (6, 9)]
    assert stats.union_length([], 0, 10) == 0
    assert stats.gaps([], 0, 10) == [(0, 10)]


def test_bound():
    assert peaks.bound_s(3.35e12) == (1.0, "bytes")
    assert peaks.bound_s(0, 67e12) == (1.0, "operations")


def _trace():
    t = devtrace.DeviceTrace(window=(0.0, 10.0))
    t.ops = [
        ("void nt::window_kernel<21>(...)", 1.0, 1.5),
        ("void nt::window_kernel<21>(...)", 1.4, 2.0),
        ("cub::DeviceRadixSortOnesweepKernel<long>", 4.0, 5.0),
        ("Memcpy HtoD (Pinned -> Device)", 4.5, 6.0),
        ("void nt::window_kernel<21>(...)", 11.0, 12.0),  # after the window
    ]
    t.spans = [(devtrace.WINDOW, 0.0, 10.0), ("portbench.job", 0.0, 9.0),
               ("portbench.flush", 3.0, 7.0)]
    return t


def test_trace_busy_matching_and_gaps():
    t = _trace()
    assert math.isclose(t.busy_s(), 1.0 + 2.0)
    spent, n = t.seconds_matching(["window_kernel"])
    assert (round(spent, 9), n) == (1.1, 2)
    assert t.top_ops(1) == [["Memcpy HtoD (Pinned -> Device)", 1.5]]
    gaps = t.idle_gaps()
    # gaps (6, 10), (2, 4) and (0, 1), named by the innermost span
    assert gaps == [["portbench.job", 4.0], ["portbench.flush", 2.0],
                    ["portbench.job", 1.0]]
    t.spans = [(devtrace.WINDOW, 0.0, 10.0)]
    assert t.idle_gaps(1) == [["between jobs", 4.0]]


def _run(trace):
    inp = _tiny_input()
    run = harness.Run(cell=None, inputs=[inp], jobs=[
        harness.Job(input=0, start=0.0, end=4.0, bases=inp.bases),
        harness.Job(input=0, start=4.0, end=10.0, bases=inp.bases),
    ], setup_s=3.0, k=4, trace=trace,
        patterns={"window_kernel": ["window_kernel"],
                  "flush_sort": ["DeviceRadixSort"]})
    return run


def _tiny_input():
    from portbench.traffic.fastx import Input

    seqs = [np.frombuffer(b"ACGTACGTNN" * 3, np.uint8).reshape(3, 10)]
    return Input(paths=[], seqs=seqs, bases=30)


def test_roofline_work_counts():
    run = _run(_trace())
    # per job 3 rows of ACGTACGTNN: 5 windows of 4 a row, 15 a job
    assert run.windows() == 30
    read = harness._read_metrics([
        {"name": "window_kernel_roofline", "unit": "%"},
        {"name": "flush_sort_roofline", "unit": "%"},
        {"name": "device.idle_share", "unit": "share"},
        {"name": "bases_per_s", "unit": "bases/s"},
    ], run)
    least_window = (math.ceil(60 / 4) + 8 * 30) / peaks.HBM_BYTES_PER_S
    assert math.isclose(read["window_kernel_roofline"]["value"],
                        100 * least_window / 1.1)
    assert math.isclose(read["flush_sort_roofline"]["value"],
                        100 * 16 * 30 / peaks.HBM_BYTES_PER_S / 1.0)
    assert math.isclose(read["device.idle_share"]["value"], 0.7)
    assert read["bases_per_s"]["value"] == 6.0


def test_readers_with_nothing_to_read_return_nothing():
    run = _run(None)
    assert harness._read_metrics([
        {"name": "window_kernel_roofline", "unit": "%"},
        {"name": "device.idle_share", "unit": "share"},
        {"name": "driver.wait_share", "unit": "share"},
        {"name": "flush.share.reads", "unit": "share"},
    ], run) == {}
