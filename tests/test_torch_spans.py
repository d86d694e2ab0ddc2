"""The port's spans and counters (``utils/profiling.span``) on the CPU.

Under a ``torch.profiler`` session the entries emit ``needletail.*``
spans, each child inside its parent and the flush's three children
partitioning it; a meter gets the same stages with their counters; the
framing front reports its start and stop to the meter, on the stream
and on the pool alike; and with neither a profile nor a meter no
``record_function`` is ever made, with answers equal to a traced run's.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from needletail_tpu_torch.device import pipeline as tpipe
from needletail_tpu_torch.device import tiling as ttiling
from needletail_tpu_torch.io.framing import (
    _make_batch_source,
    parallel_read_batches,
)
from needletail_tpu_torch.utils.profiling import ThroughputMeter

FQ = "tests/data/PRJNA271013_head.fq"
FA = "tests/data/28S.fasta"
PREFIX = "needletail."

ENTRIES = {
    "count_file": lambda **kw: tpipe.count_file(
        FQ, 21, batch_size=512, host_workers=1, sparse_format="arrays",
        device="cpu", **kw),
    "genome_spectrum": lambda **kw: ttiling.genome_spectrum(
        FA, 31, tile_len=1024, sparse_format="arrays", device="cpu", **kw),
}
# each entry's spans on the caller's thread, child -> parent
PARENTS = {
    "count_file": {
        "wait": "count_file", "dispatch": "count_file", "drain": "count_file",
        "flush": "drain", "flush.resolve": "flush", "flush.pull": "flush",
        "flush.merge": "flush",
    },
    "genome_spectrum": {
        "tiling.block": "genome_spectrum", "h2d": "genome_spectrum",
        "dispatch": "genome_spectrum", "drain": "genome_spectrum",
        "flush": "drain", "flush.resolve": "flush", "flush.pull": "flush",
        "flush.merge": "flush",
    },
}
# stages the meter gets beside the timeline's (frame and h2d run on a
# feeder thread in count_file)
STAGES = {
    "count_file": {"frame", "h2d", "wall"},
    "genome_spectrum": {"wall"},
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in parallel worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def traced():
    """Each entry once, profiled on the CPU and metered: its answer, its
    spans ``{name: [(start_us, end_us), ...]}`` and its meter."""
    out = {}
    for entry, call in ENTRIES.items():
        meter = ThroughputMeter()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            answer = call(meter=meter)
        spans = {}
        for evt in prof.events():
            if evt.name.startswith(PREFIX):
                spans.setdefault(evt.name[len(PREFIX):], []).append(
                    (evt.time_range.start, evt.time_range.end))
        out[entry] = answer, spans, meter
    return out


def _inside(inner, outer):
    return outer[0] <= inner[0] and inner[1] <= outer[1]


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_each_span_lies_inside_its_parent(traced, entry):
    _, spans, _ = traced[entry]
    assert len(spans[entry]) == 1
    assert set(PARENTS[entry]) | {entry} == set(spans)
    for child, parent in PARENTS[entry].items():
        for s in spans[child]:
            assert any(_inside(s, p) for p in spans[parent]), (child, parent)


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_flush_children_partition_the_flush(traced, entry):
    _, spans, _ = traced[entry]
    parts = ("flush.resolve", "flush.pull", "flush.merge")
    for flush in spans["flush"]:
        inner = sorted(s for p in parts for s in spans[p] if _inside(s, flush))
        # one of each, in order, never overlapping
        assert [
            next(p for p in parts if s in spans[p]) for s in inner
        ] == list(parts)
        assert all(a[1] <= b[0] for a, b in zip(inner, inner[1:]))


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_meter_takes_the_spans_and_their_counters(traced, entry):
    (_, (keys, _)), spans, meter = traced[entry]
    stages = meter.as_dict()
    assert set(PARENTS[entry]) - {entry} | STAGES[entry] <= set(stages)
    assert entry not in stages  # the root reaches the timeline alone
    for name in PARENTS[entry]:
        assert meter.stages[name].seconds > 0, name
    # one flush: lanes padded to 2^20, the pull returns the distinct keys
    assert len(spans["flush"]) == 1
    lanes = meter.stages["flush.resolve"].items
    assert lanes > 0 and lanes % (1 << 20) == 0
    assert meter.stages["flush.pull"].items == len(keys)
    assert meter.stages["flush.pull"].bytes >= 12 * len(keys)
    if entry == "genome_spectrum":
        assert meter.stages["tiling.block"].bytes == meter.stages["h2d"].bytes > 0
        assert meter.stages["wall"].items == 738_580


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_untraced_calls_no_record_function(traced, entry, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function with nothing recording")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    n, (keys, counts) = ENTRIES[entry]()
    tn, (tkeys, tcounts) = traced[entry][0]
    assert n == tn
    np.testing.assert_array_equal(keys, tkeys)
    np.testing.assert_array_equal(counts, tcounts)


@pytest.mark.parametrize("route", ["stream", "pool"])
def test_pool_start_and_stop_reach_the_meter(route):
    meter = ThroughputMeter()
    if route == "pool":
        batches = parallel_read_batches(
            FQ, workers=2, batch_size=512, max_len=128, packed=True,
            meter=meter)
    else:
        # the drivers' default front: one stream in this process
        batches, _ = _make_batch_source(
            FQ, 512, 128, None, with_quals=False, packed=True, meter=meter)
    n = sum(b.num_bases for b in batches)
    assert n == 250_000
    st = meter.stages
    assert {"framing.start", "framing.stop"} <= set(st)
    if route == "stream":
        assert st["framing.start"].items == 1
        assert not {"framing.split", "framing.spawn"} & set(st)
        return
    assert {"framing.split", "framing.spawn"} <= set(st)
    assert st["framing.start"].items == 2
    assert st["framing.split"].seconds + st["framing.spawn"].seconds <= (
        st["framing.start"].seconds)
