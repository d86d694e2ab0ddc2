"""Shared by the benchmark's tests: the checkout's root on the import
path (so ``portbench`` and the port import by name, however pytest was
started), and tiny versions of the cells for runs on the CPU: the same
files and paths, with the sizes cut by overrides.  ``HELD`` holds the
cells that ``BENCHMARK.json`` leaves out for now (their runs spread too
widely to hold a bound), as the entries that would add them back; the
tests run them from a copy of ``BENCHMARK.json`` with those entries."""

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY = {
    "spectrum21.illumina30x": (
        {"genome_bp": 12000}, {"coverage": 4}, {"host_workers": 1},
    ),
    "spectrum21.hifi30x": (
        {"genome_bp": 30000},
        {"coverage": 2,
         "length": {"mean": 2500, "sigma": 0.35, "min": 800, "max": 5000}},
        {"host_workers": 1},
    ),
    "spectrum31.bacteria": (
        {}, {"count": 3, "check_inputs": 2,
             "size": {"median": 30000, "sigma": 0.3, "min": 8000, "max": 60000}},
        {},
    ),
    "spectrum31.phages": (
        {}, {"count": 6, "check_inputs": 3,
             "size": {"median": 4000, "sigma": 0.6, "min": 1500, "max": 20000}},
        {},
    ),
}


def run_tiny(harness, cell, seed=2**33 + 7, seconds=0.3, trace=False, options=None):
    config, traffic, opts = TINY[cell]
    return harness.run_cell(
        cell, seed, seconds, trace, device="cpu",
        options=dict(opts, **(options or {})), config=dict(config),
        traffic=dict(traffic),
    )


HELD = {
    "workloads": [
        {"name": "spectrum21.illumina30x", "config": "reads_k21_spectrum",
         "traffic": "illumina30x", "chips": 1,
         "why": "2x150 bp pairs, 30x of 4.64 Mbp a job: framing and flushes"},
        {"name": "spectrum31.bacteria", "config": "genome_k31_spectrum",
         "traffic": "bacteria", "chips": 1,
         "why": "32 assemblies of 1-8 Mbp, one a job: the host filter"},
    ],
    "job_s_p90": {"name": "job_s_p90", "unit": "s", "better": "lower",
                  "bound": 0.25, "source": "host_clock",
                  "workloads": ["spectrum31.bacteria"]},
    "flush.share.genomes": {"name": "flush.share.genomes", "unit": "share",
                            "better": "lower", "source": "program_span",
                            "layer": "flush", "moves": "job_s_p90",
                            "workloads": ["spectrum31.bacteria"]},
}


def bench_with_held(bench: dict) -> dict:
    """``BENCHMARK.json``'s object with the held cells added back."""
    bench = json.loads(json.dumps(bench))
    bench["workloads"] += HELD["workloads"]
    bench["end_to_end"].append(HELD["job_s_p90"])
    bench["per_layer"].append(HELD["flush.share.genomes"])
    for m in bench["per_layer"]:
        listed = m.get("workloads", [])
        if "spectrum21.hifi30x" in listed and m["layer"] != "flush":
            listed.append("spectrum21.illumina30x")
        if "spectrum31.phages" in listed and m["layer"] != "flush":
            listed.append("spectrum31.bacteria")
        if m["name"] == "flush.share.reads":
            listed.append("spectrum21.illumina30x")
    return bench
