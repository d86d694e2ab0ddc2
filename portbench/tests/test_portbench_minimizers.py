"""The minimizer cell on the CPU at a tiny size: correct untraced and
traced, its sketch and flush metrics read from the program's meter, and
the faults and the control of the k-mer cells' tests not correct."""

import pytest

import _tiny
from portbench import harness

CELL = "minimizers19w19.hifi30x"
# the tiny HiFi cell's sizes: the same files, overridden
TINY = _tiny.TINY["spectrum21.hifi30x"]


@pytest.fixture(autouse=True)
def _tiny_cell(monkeypatch):
    monkeypatch.setitem(_tiny.TINY, CELL, TINY)


def test_cell_is_correct():
    r = _tiny.run_tiny(harness, CELL)
    assert r["correct"], r["check"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert set(r["metrics"]) == {
        m["name"] for m in harness.load_cell(CELL).end_to_end}


def test_traced_run_reads_the_sketch():
    r = _tiny.run_tiny(harness, CELL, trace=True)
    assert r["correct"], r["check"]
    assert 0 < r["metrics"]["sketch.lane_use"]["value"] <= 1
    assert 0 < r["metrics"]["flush.resolve_share"]["value"] < 1
    # the driver's stages that the k-mer HiFi cell's metrics read (one
    # framing worker here, so no pool to start)
    for name in ("driver.wait_share", "framing.mb_per_s",
                 "transfer.h2d_gb_per_s", "flush.share.reads",
                 "flush.pull_share", "flush.merge_share", "flush.lane_use"):
        assert r["metrics"][name]["value"] >= 0, name
    assert 0 < r["metrics"]["flush.lane_use"]["value"] <= 1
    # no card: no device operation, so no device metric
    for name in ("device.idle_share", "sketch_kernel_roofline",
                 "window_kernel_roofline"):
        assert name not in r["metrics"]


@pytest.mark.parametrize("options", [{"w": 11}, {"k": 21}])
def test_another_sketch_is_not_correct(options):
    # the program's own sketch at another w or k than the configuration's
    r = _tiny.run_tiny(harness, CELL, options=options)
    assert not r["correct"]
    assert r["check"]["keys_off"]["value"] > 0


def test_half_the_batch_is_not_correct(monkeypatch):
    from needletail_tpu_torch.device import count

    add = count.SparseSpectrumAccumulator.add

    def half(self, hi, lo):
        lo = lo.clone()
        lo[1::2] = -1
        if hi is not None:
            hi = hi.clone()
            hi[1::2] = -1
        return add(self, hi, lo)

    monkeypatch.setattr(count.SparseSpectrumAccumulator, "add", half)
    r = _tiny.run_tiny(harness, CELL)
    assert not r["correct"]
    assert r["check"]["keys_off"]["value"] > 0
