"""One run of one cell: set up, time whole jobs, check, report.

Everything a cell is made of is found by name: the cell in
``BENCHMARK.json``, its configuration in ``configs/<config>.json`` (which
names its entry, and the reference and the comparison that decide
``correct``), its traffic in ``traffic/<traffic>.json`` (which names its
generator module in ``traffic/``), each metric's reader in
``metrics/<name>.py`` and the kernels' name patterns in ``kernels.json``.  A cell, a mix, a metric or a
kernel name is added as files and entries, with no edit here.
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import importlib.util
import json
import shutil
import sys
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from . import devtrace, guard, peaks, stats
from .reference import spectrum as reference

__all__ = [
    "ROOT", "REPO", "Job", "Run", "load_cell", "run_cell", "stop_children",
    "NoDevice",
]

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent


class NoDevice(RuntimeError):
    """The cell needs more CUDA devices than this machine has."""


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _module(path: Path, name: str):
    """The module in file ``path``, loaded once under ``name``."""
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        del sys.modules[name]
        raise
    return mod


def _callable(ref: str) -> Callable:
    """``"package.module:function"`` -> the function."""
    mod, _, attr = ref.partition(":")
    return getattr(importlib.import_module(mod), attr)


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def _reports(metric: dict, cell: str) -> bool:
    listed = metric.get("workloads")
    return listed is None or cell in listed


def load_cell(name: str, bench_path: Optional[Path] = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its configuration,
    traffic and the metrics it reports."""
    bench = _json(bench_path or REPO / "BENCHMARK.json")
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload named {name!r} in BENCHMARK.json")
    cell = found[0]
    return Cell(
        name=name,
        chips=int(cell["chips"]),
        config=_json(ROOT / "configs" / f"{cell['config']}.json"),
        traffic=_json(ROOT / "traffic" / f"{cell['traffic']}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)],
    )


@dataclass
class Job:
    """One call of the entry: which input, when, and what came back."""

    input: int
    start: float
    end: float
    bases: int
    error: Optional[str] = None
    meter: Optional[Dict[str, Dict[str, float]]] = None

    @property
    def seconds(self) -> float:
        return self.end - self.start


@dataclass
class Run:
    """What the metric readers read: the window's jobs, its inputs, the
    traced run's spans, meters and device timeline."""

    cell: Cell
    inputs: list
    jobs: List[Job]
    setup_s: float
    k: int
    trace: Optional[devtrace.DeviceTrace] = None
    flush_s: Optional[float] = None
    patterns: Dict[str, List[str]] = field(default_factory=dict)
    power_limit_w: Optional[float] = None

    @property
    def window_s(self) -> float:
        return stats.window_s([(j.start, j.end) for j in self.jobs])

    @property
    def bases(self) -> int:
        return sum(j.bases for j in self.jobs)

    def windows(self) -> int:
        """Valid k-mer windows of the window's jobs, counted from the
        generated sequences."""
        total = 0
        for j in self.jobs:
            inp = self.inputs[j.input]
            if self.k not in inp.windows:
                inp.windows[self.k] = sum(
                    reference.valid_windows(s, self.k) for s in inp.seqs
                )
            total += inp.windows[self.k]
        return total

    def meter_stage(self, stage: str, key: str) -> float:
        """``key`` (``s`` or ``bytes``) of meter stage ``stage``, summed
        over the window's jobs."""
        return sum(
            (j.meter or {}).get(stage, {}).get(key, 0.0) for j in self.jobs
        )


def _check_set(n_inputs: int, sizes: List[int], want: int, seed: int) -> set:
    """Inputs whose answers are checked: the largest and a sample of the
    rest drawn from the seed."""
    want = min(want, n_inputs)
    largest = int(np.argmax(sizes))
    rng = np.random.default_rng([seed % (1 << 64), 0x636865636B])
    rest = [i for i in rng.permutation(n_inputs) if i != largest]
    return {largest, *map(int, rest[:want - 1])}


def _process_age() -> float:
    """Seconds since this process started, from ``/proc``; 0 where that
    cannot be read."""
    try:
        import os

        ticks = os.sysconf("SC_CLK_TCK")
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19]) / ticks
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(up - start, 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0


def stop_children() -> List[str]:
    """Stop the framing pool's workers (joined already on every normal
    path) and the ``multiprocessing`` resource tracker, which would
    outlive this process by a moment; returns what is still alive."""
    import multiprocessing as mp
    import os
    from multiprocessing import resource_tracker

    for p in mp.active_children():
        p.terminate()
        p.join(10)
    stop = getattr(resource_tracker._resource_tracker, "_stop", None)
    if stop is not None:
        stop()
    alive = []
    me = str(os.getpid())
    for entry in Path("/proc").iterdir():
        if not entry.name.isdigit():
            continue
        try:
            stat = (entry / "stat").read_text()
        except OSError:
            continue
        fields = stat[stat.rindex(")") + 2:].split()
        if fields[1] == me and fields[0] != "Z":
            alive.append(entry.name)
    return alive


class _Kept:
    """The answers kept for the check: one for each checked input, a
    uniform sample drawn from the seed of that input's answers in the
    window (a reservoir of one), so that the host holds at most one
    answer an input however many jobs the window runs."""

    def __init__(self, checked: set, seed: int) -> None:
        self.checked = checked
        self.answers: Dict[int, Any] = {}
        self._seen: Dict[int, int] = {}
        self._rng = np.random.default_rng([seed % (1 << 64), 0x6B656570])

    def offer(self, idx: int, answer: Any) -> None:
        if idx not in self.checked:
            return
        n = self._seen[idx] = self._seen.get(idx, 0) + 1
        if self._rng.integers(n) == 0:
            self.answers[idx] = answer


def _check(cell: Cell, inputs, kept: Dict[int, Any]) -> Dict[str, dict]:
    """Compare each kept answer with the reference's answer for its
    input, by the reference and the comparison that the configuration
    names: the numbers compared, each the worst over the answers, with
    its limit from the configuration's ``limits``."""
    reference = _callable(cell.config["reference"])
    compare = _callable(cell.config["compare"])
    limits = cell.config["limits"]
    worst = {name: 0 for name in limits}
    for idx in sorted(kept):
        want = reference(inputs[idx], cell.config["options"])
        for name, value in compare(kept[idx], want).items():
            worst[name] = max(worst[name], value)
        del want
    check = {name: {"value": v, "max": limits[name]} for name, v in worst.items()}
    check["checked"] = {"value": len(kept), "min": 1}
    return check


def log(line: str) -> None:
    print(line, file=sys.stderr, flush=True)


def _passes(check: Dict[str, dict]) -> bool:
    return all(
        ("max" not in c or c["value"] <= c["max"])
        and ("min" not in c or c["value"] >= c["min"])
        for c in check.values()
    )


def _read_metrics(entries: List[dict], run: Run) -> Dict[str, dict]:
    out = {}
    for m in entries:
        reader = _module(ROOT / "metrics" / f"{m['name']}.py",
                         "portbench_metric_" + m["name"].replace(".", "_"))
        value = reader.read(run)
        if value is None:
            continue
        entry = {"value": float(value), "unit": m["unit"]}
        if m["unit"] == "%":
            entry["power_limit_w"] = run.power_limit_w
        out[m["name"]] = entry
    return out


def run_cell(
    name: str,
    seed: int,
    seconds: float,
    trace: bool,
    device: str = "cuda",
    options: Optional[Dict[str, Any]] = None,
    config: Optional[Dict[str, Any]] = None,
    traffic: Optional[Dict[str, Any]] = None,
) -> dict:
    """One run of cell ``name``: the result line's object.

    ``options`` overrides the entry's options (the control switches a
    path of the program with it), ``config`` and ``traffic`` override
    keys of the cell's files (the tests shrink a cell with them), and
    ``device="cpu"`` runs the port's plain versions with no profile of a
    card: neither is a benchmark run.
    """
    t_start = time.perf_counter() - _process_age()
    cell = load_cell(name)
    cell.config.update(config or {})
    cell.traffic.update(traffic or {})
    on_cuda = device == "cuda"

    import torch

    if on_cuda and (
        not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips
    ):
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        raise NoDevice(f"{name} needs {cell.chips} CUDA device(s); found {have}")

    entry = _callable(cell.config["entry"])
    opts = dict(cell.config["options"], **(options or {}), device=device)
    k = int(cell.config["options"]["k"])
    meter_cls = None
    if trace and "meter" in cell.config:
        meter_cls = _callable(cell.config["meter"]["factory"])
    generator = _module(ROOT / "traffic" / f"{cell.traffic['generator']}.py",
                        "portbench_traffic_" + cell.traffic["generator"])

    workdir = Path(tempfile.mkdtemp(prefix="portbench-"))
    try:
        inputs = generator.generate(cell.config, cell.traffic, seed, workdir)
        sizes = [inp.bases for inp in inputs]
        checked = _check_set(len(inputs), sizes,
                             int(cell.traffic.get("check_inputs", len(inputs))), seed)
        one_path = cell.config.get("input") == "path"

        def call(idx: int, meter=None):
            paths = inputs[idx].paths
            kw = dict(opts)
            if meter is not None:
                kw[cell.config["meter"]["option"]] = meter
            return entry(paths[0] if one_path else list(paths), **kw)

        warm = {int(np.argmax(sizes)), int(np.argmin(sizes))}
        for idx in sorted(warm):
            call(idx)
        if on_cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        gc.collect()

        jobs: List[Job] = []
        kept = _Kept(checked, seed)
        flush = None
        with contextlib.ExitStack() as stack:
            traced = [None]
            if trace:
                from .spans import FlushSpans

                traced = stack.enter_context(devtrace.record(on_cuda))
                flush = stack.enter_context(FlushSpans(on_cuda))
            t_window = time.perf_counter()
            setup_s = t_window - t_start
            deadline = t_window + seconds
            j = 0
            with devtrace.span(devtrace.WINDOW):
                while not jobs or time.perf_counter() < deadline:
                    idx = j % len(inputs)
                    meter = meter_cls() if meter_cls is not None else None
                    t0 = time.perf_counter()
                    err = None
                    try:
                        with devtrace.span("portbench.job"):
                            answer = call(idx, meter)
                    except Exception as exc:  # a failed job is counted, not fatal
                        err = f"{type(exc).__name__}: {exc}"
                    t1 = time.perf_counter()
                    jobs.append(Job(
                        input=idx, start=t0, end=t1, bases=inputs[idx].bases,
                        error=err,
                        meter=meter.as_dict() if meter is not None else None,
                    ))
                    if err is None:
                        kept.offer(idx, answer)
                    answer = None
                    j += 1
        t_closed = time.perf_counter()
        found = guard.forbidden_in()
        if found:
            raise ImportError(
                "the run loaded forbidden modules: " + ", ".join(found))
        memory_peak = torch.cuda.max_memory_allocated() if on_cuda else 0
        if on_cuda:
            torch.cuda.empty_cache()

        run = Run(
            cell=cell, inputs=inputs, jobs=jobs, setup_s=setup_s, k=k,
            trace=traced[0],
            flush_s=flush.seconds if flush is not None else None,
            patterns=_json(ROOT / "kernels.json"),
            power_limit_w=peaks.power_limit_w() if on_cuda else None,
        )
        metrics = _read_metrics(cell.per_layer if trace else cell.end_to_end, run)
        failed = sum(1 for j in jobs if j.error is not None)
        for job in jobs:
            if job.error is not None:
                log(f"job on input {job.input} failed: {job.error}")
        if flush is not None:
            log(f"flush routes in the window: {json.dumps(flush.routes)}; "
                f"{flush.calls} flushes, {flush.seconds:.6f} s")
        t_check = time.perf_counter()
        check = _check(cell, inputs, kept.answers)
        check["jobs_failed"] = {"value": failed, "max": 0}
        log(f"setup_s {setup_s:.3f}; window {run.window_s:.3f} s, "
            f"{len(jobs)} jobs; trace and metrics {t_check - t_closed:.3f} s; "
            f"check {time.perf_counter() - t_check:.3f} s")
        walls = sorted(j.seconds for j in jobs)
        log(f"job seconds: min {walls[0]:.4f}, median "
            f"{walls[len(walls) // 2]:.4f}, max {walls[-1]:.4f}; first "
            + " ".join(f"{j.seconds:.4f}" for j in jobs[:12]))
        dev = {
            "platform": "gpu" if on_cuda else "cpu",
            "kind": torch.cuda.get_device_name(0) if on_cuda else "cpu",
            "count": cell.chips,
            "memory_peak_bytes": int(memory_peak),
            "power_limit_w": run.power_limit_w,
        }
        result = {
            "correct": _passes(check),
            "attempted": len(jobs),
            "failed": failed,
            "metrics": metrics,
            "device": dev,
        }
        if run.trace is not None:
            dev["busy_s"] = run.trace.busy_s()
            dev["window_s"] = run.trace.window_s
            result["breakdown"] = {
                "device_ops": run.trace.top_ops(),
                "idle_gaps": run.trace.idle_gaps(),
            }
        result["check"] = check
        return result
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
