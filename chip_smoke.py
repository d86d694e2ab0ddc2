#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``needletail_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. print the card (``nvidia-smi`` name and power limit), the torch and CUDA
   versions and whether the native framer loads; build the CUDA kernels
   from ``needletail_tpu_torch/csrc`` and print the build time;
2. hold each kernel against its plain PyTorch version on the card, bit for
   bit (tolerance 0: the path is all integer), over k, ASCII and packed
   input, the three wire validity shapes and several read widths, and the
   histogram on uniform, skewed and mostly-invalid keys;
3. the main path at full size: ``hash_count_file`` over the golden FASTQ
   written 256 times (64M bases) at batch 131072 x 128, through both
   kernels (launch counts read around this run), to the x256 goldens and
   256 x the one-copy table of the plain path; then its bases/s (best of 2
   after a warm-up) and the metered stage table;
4. ``packed=False`` and an interrupted checkpoint/resume at a smaller depth,
   equal to the per-copy results;
5. each kernel's time beside its plain version's at the main path's
   shapes;
6. stop every process the run started (the framing pool's resource
   tracker) and fail if a child is still alive; then a
   ``{"kernels": [...]}`` line and the last line
   ``{"ok": true, "device": {...}}``.

Exits non-zero without a result when CUDA is unavailable or the script
stands outside a checkout of the repository.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
FQ = ROOT / "tests" / "data" / "PRJNA271013_head.fq"

# per-copy goldens of PRJNA271013_head.fq at k=21
GOLD_BASES = 250_000
GOLD_TOTAL_K21 = 209_965
GOLD_FWD_K21 = 106_181

K = 21
COPIES = 256  # 64M bases, as the JAX package's e2e bench writes it
SMALL_COPIES = 16
BATCH = 131072
MAX_LEN = 128
SEED = 20261016

HASH_KS = (1, 16, 17, 21, 31)
ASCII_WIDTHS = {128: 512, 150: 512, 40_000: 16}  # width -> rows
PACKED_WIDTHS = {128: 512, 152: 512, 40_000: 16}  # packed widths are x8
HIST_KEYS = BATCH * MAX_LEN  # 16.7M keys, one main-path batch


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean milliseconds of ``fn()`` on the card, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


class Errors:
    """Largest absolute difference seen per kernel (0 when bit-equal)."""

    def __init__(self) -> None:
        self.worst = {"hash_keys": 0, "histogram16": 0}

    def hold(self, name: str, what: str, got, want) -> None:
        import torch

        got = torch.as_tensor(got).to(torch.int64)
        want = torch.as_tensor(want).to(got.device, torch.int64)
        if got.shape != want.shape:
            raise AssertionError(
                f"{name} {what}: shape {tuple(got.shape)} != "
                f"{tuple(want.shape)}"
            )
        err = int((got - want).abs().max()) if got.numel() else 0
        self.worst[name] = max(self.worst[name], err)
        if err != 0:
            raise AssertionError(f"{name} {what}: max abs error {err}")


def check_hash_kernel(errors: Errors, rng) -> int:
    import torch

    from needletail_tpu_torch.device import kernels as K_
    from needletail_tpu_torch.device.ops import resolve_vbits, unwire
    from needletail_tpu_torch.utils.synth import packed_batch, random_reads

    dev = torch.device("cuda")
    cases = 0
    for width, rows in ASCII_WIDTHS.items():
        seqs, lengths = random_reads(rng, rows, width, dirty_frac=0.5)
        s = torch.from_numpy(seqs).to(dev)
        ln = torch.from_numpy(lengths).to(dev)
        for k in HASH_KS:
            for normalized in (True, False):
                got = K_.canonical_hash_keys(s, ln, k, 16, normalized)
                want = K_.canonical_hash_keys_plain(s, ln, k, 16, normalized)
                what = f"ascii L={width} k={k} normalized={normalized}"
                for g, w, part in zip(got, want, ("keys", "total", "fwd")):
                    errors.hold("hash_keys", f"{what} {part}", g, w)
                cases += 1
    for width, rows in PACKED_WIDTHS.items():
        for vmode, dirty in ((0, 0.0), (1, 1.0), (2, 0.05)):
            seqs, lengths = random_reads(rng, rows, width, dirty_frac=dirty)
            batch = packed_batch(seqs, lengths, vmode)
            buf, layout = batch.wire_frame(rows)
            assert layout.vmode == vmode, (layout.vmode, vmode)
            wire = torch.from_numpy(buf).to(dev)
            codes, ln, vbits, vrow_idx, vrows = unwire(wire, layout)
            vb = resolve_vbits(vbits, vrow_idx, vrows, rows)
            for k in HASH_KS:
                got = K_.canonical_hash_keys_packed(codes, vb, ln, k, 16)
                want = K_.canonical_hash_keys_packed_plain(codes, vb, ln, k, 16)
                what = f"packed vmode={vmode} L={width} k={k}"
                for g, w, part in zip(got, want, ("keys", "total", "fwd")):
                    errors.hold("hash_keys", f"{what} {part}", g, w)
                cases += 1
    torch.cuda.synchronize()
    return cases


def check_histogram(errors: Errors, rng) -> int:
    import numpy as np
    import torch

    from needletail_tpu_torch.device import kernels as K_

    n = HIST_KEYS
    uniform = rng.integers(0, 1 << 16, n, dtype=np.int32)
    inputs = {
        "uniform": uniform,
        "skewed": np.full(n, 12345, np.int32),
        "mostly_invalid": np.where(rng.random(n) < 0.9, -1, uniform).astype(
            np.int32
        ),
        "wide": rng.integers(0, 1 << 31, n, dtype=np.int64).astype(np.int32),
    }
    for what, keys in inputs.items():
        t = torch.from_numpy(keys).to("cuda").view(BATCH, MAX_LEN)
        errors.hold(
            "histogram16", what, K_.mxu_histogram16(t), K_.histogram16_plain(t)
        )
    t = torch.from_numpy(uniform).to("cuda").view(BATCH, MAX_LEN)
    w = torch.from_numpy(rng.integers(-1, 2, n, dtype=np.int32)).to("cuda")
    w = w.view(BATCH, MAX_LEN)
    errors.hold(
        "histogram16", "weighted",
        K_.mxu_histogram16(t, w), K_.histogram16_plain(t, w),
    )
    torch.cuda.synchronize()
    return len(inputs) + 1


def main_path_batch(path: str):
    """The first batch the main path frames, as device tensors: the
    packed planes and the ASCII planes at batch 131072 x 128."""
    import numpy as np
    import torch

    from needletail_tpu.io.fast_batch import fast_read_batches
    from needletail_tpu_torch.device.ops import resolve_vbits, unwire

    packed = next(iter(fast_read_batches(
        path, batch_size=BATCH, max_len=MAX_LEN, packed=True,
    )))
    buf, layout = packed.wire_frame(BATCH)
    wire = torch.from_numpy(buf).to("cuda")
    codes, lengths, vbits, vrow_idx, vrows = unwire(wire, layout)
    vb = resolve_vbits(vbits, vrow_idx, vrows, BATCH)
    ascii_b = next(iter(fast_read_batches(
        path, batch_size=BATCH, max_len=MAX_LEN, with_quals=False,
    )))
    seqs = torch.from_numpy(np.ascontiguousarray(ascii_b.seqs)).to("cuda")
    ln = torch.from_numpy(ascii_b.lengths.astype(np.int32)).to("cuda")
    return (codes, vb, lengths), (seqs, ln)


def time_kernels(errors: Errors, path: str) -> dict:
    """Kernel and plain times (ms) at the main path's shapes."""
    from needletail_tpu_torch.device import kernels as K_

    (codes, vb, lengths), (seqs, ln) = main_path_batch(path)
    got = K_.canonical_hash_keys_packed(codes, vb, lengths, K, 16)
    want = K_.canonical_hash_keys_packed_plain(codes, vb, lengths, K, 16)
    for g, w, part in zip(got, want, ("keys", "total", "fwd")):
        errors.hold("hash_keys", f"main-path batch {part}", g, w)
    keys = got[0]
    errors.hold(
        "histogram16", "main-path keys",
        K_.mxu_histogram16(keys), K_.histogram16_plain(keys),
    )
    return {
        "hash_keys": cuda_ms(
            lambda: K_.canonical_hash_keys_packed(codes, vb, lengths, K, 16), 20
        ),
        "hash_keys_plain": cuda_ms(
            lambda: K_.canonical_hash_keys_packed_plain(
                codes, vb, lengths, K, 16
            ), 5, warmup=1,
        ),
        "hash_keys_ascii": cuda_ms(
            lambda: K_.canonical_hash_keys(seqs, ln, K, 16), 20
        ),
        "hash_keys_ascii_plain": cuda_ms(
            lambda: K_.canonical_hash_keys_plain(seqs, ln, K, 16), 5, warmup=1
        ),
        "histogram16": cuda_ms(lambda: K_.mxu_histogram16(keys), 20),
        "histogram16_plain": cuda_ms(
            lambda: K_.histogram16_plain(keys), 5, warmup=1
        ),
    }


class _Interrupt(Exception):
    pass


class _StopAfter:
    """A meter that stops the driver at its ``n``-th step, as a kill
    would; the checkpoint on disk then holds the batches before it."""

    def __init__(self, n: int) -> None:
        self.n = n
        self.steps = 0

    def add(self, name, seconds, nbytes=0, items=0) -> None:
        if name == "dispatch":
            self.steps += 1
            if self.steps == self.n:
                raise _Interrupt


def write_copies(path: Path, copies: int) -> None:
    src = FQ.read_bytes()
    with open(path, "wb") as f:
        for _ in range(copies):
            f.write(src)


def expect(result, copies: int, table1, what: str) -> None:
    import numpy as np

    n_bases, total, fwd, table = result
    want = (GOLD_BASES * copies, GOLD_TOTAL_K21 * copies, GOLD_FWD_K21 * copies)
    if (n_bases, total, fwd) != want:
        raise AssertionError(f"{what}: {(n_bases, total, fwd)} != {want}")
    if table.dtype != np.int64 or not np.array_equal(table, table1 * copies):
        raise AssertionError(f"{what}: table != {copies} x the one-copy table")


def child_processes() -> dict:
    """``{pid: command line}`` of this process's live children."""
    me = str(os.getpid())
    found = {}
    for entry in Path("/proc").iterdir():
        if not entry.name.isdigit():
            continue
        try:
            stat = (entry / "stat").read_text()
            cmd = (entry / "cmdline").read_bytes()
        except OSError:
            continue  # exited while we looked
        # the command name in parentheses may hold spaces: split after it
        fields = stat[stat.rindex(")") + 2:].split()
        if fields[1] == me and fields[0] != "Z":
            found[int(entry.name)] = cmd.replace(b"\0", b" ").decode().strip()
    return found


def stop_children() -> dict:
    """Stop what the run started: the framing workers (joined already on
    every normal path) and the ``multiprocessing`` resource tracker that
    the spawn context starts and would otherwise outlive this process by
    a moment.  Returns the children still alive afterwards."""
    import multiprocessing as mp
    from multiprocessing import resource_tracker

    for p in mp.active_children():
        p.terminate()
        p.join(10)
    stop = getattr(resource_tracker._resource_tracker, "_stop", None)
    if stop is not None:
        stop()
    return child_processes()


def run() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this needs one GPU",
              file=sys.stderr)
        return 2
    if not (ROOT / "needletail_tpu_torch").is_dir() or not FQ.exists():
        print("chip_smoke: run it from a checkout of the repository",
              file=sys.stderr)
        return 2

    import numpy as np

    from needletail_tpu.io import native
    from needletail_tpu.utils.profiling import ThroughputMeter
    from needletail_tpu_torch.checkpoint import load_stream_checkpoint
    from needletail_tpu_torch.device import _build
    from needletail_tpu_torch.device import kernels as K_
    from needletail_tpu_torch.device.pipeline import hash_count_file

    # ---- 1. card, versions, build ------------------------------------
    card = card_line()
    log(card)
    log(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"cuda {torch.version.cuda}  device {torch.cuda.get_device_name(0)}")
    if native.available():
        log("native framer: available")
    else:
        log("native framer: MISSING — framing runs the pure-Python path")
    t0 = time.perf_counter()
    logs = _build.build_all()
    build_s = time.perf_counter() - t0
    log(f"build: {len(logs)} kernel source(s) compiled in {build_s:.2f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "Compiling entry" in line:
                log(f"  {name}: {line.strip()}")

    # ---- 2. each kernel against its plain version ---------------------
    rng = np.random.default_rng(SEED)
    errors = Errors()
    t0 = time.perf_counter()
    n_hash = check_hash_kernel(errors, rng)
    n_hist = check_histogram(errors, rng)
    log(f"kernel checks: hash_keys {n_hash} cases, histogram16 {n_hist} "
        f"cases equal to the plain versions at tolerance 0 in "
        f"{time.perf_counter() - t0:.1f} s")

    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        tmp = Path(tmp)
        big = tmp / "reads_x256.fq"
        write_copies(big, COPIES)
        small = tmp / "reads_x16.fq"
        write_copies(small, SMALL_COPIES)
        n_bytes = big.stat().st_size

        # ---- 3. main path at full size --------------------------------
        ref = hash_count_file(
            str(FQ), K, batch_size=BATCH, max_len=MAX_LEN, device="cpu",
            host_workers=1,
        )
        table1 = ref[3]
        expect(ref, 1, table1, "plain one-copy run")
        K_.reset_launches()
        t0 = time.perf_counter()
        result = hash_count_file(
            str(big), K, batch_size=BATCH, max_len=MAX_LEN, device="cuda"
        )
        first_s = time.perf_counter() - t0
        launches = dict(K_.LAUNCHES)
        expect(result, COPIES, table1, "main path")
        for name, n in launches.items():
            if n <= 0:
                raise AssertionError(f"main path launched no {name} kernel")
        log(f"main path: {result[0]} bases, {result[1]} windows, {result[2]} "
            f"forward; launches {launches}; first run {first_s:.3f} s")
        best = float("inf")
        for _ in range(2):
            t0 = time.perf_counter()
            again = hash_count_file(
                str(big), K, batch_size=BATCH, max_len=MAX_LEN, device="cuda"
            )
            best = min(best, time.perf_counter() - t0)
            expect(again, COPIES, table1, "timed main path")
        log(f"e2e: best of 2 {best:.3f} s = {result[0] / best:.6e} bases/s, "
            f"{n_bytes / best / 1e6:.1f} MB/s of file ({card})")
        meter = ThroughputMeter()
        expect(
            hash_count_file(
                str(big), K, batch_size=BATCH, max_len=MAX_LEN,
                device="cuda", meter=meter,
            ),
            COPIES, table1, "metered main path",
        )
        log("metered stages:\n" + meter.report())
        log("metered stages json: " + json.dumps(meter.as_dict()))

        # ---- 4. ASCII transport, checkpoint and resume ----------------
        expect(
            hash_count_file(
                str(small), K, batch_size=BATCH, max_len=MAX_LEN,
                device="cuda", packed=False,
            ),
            SMALL_COPIES, table1, "packed=False",
        )
        ck = tmp / "hash.npz"
        try:
            hash_count_file(
                str(small), K, batch_size=8192, max_len=MAX_LEN,
                device="cuda", host_workers=1, checkpoint_every=1,
                checkpoint_path=str(ck), meter=_StopAfter(3),
            )
        except _Interrupt:
            pass
        else:
            raise AssertionError("the interrupted run ran to its end")
        saved = load_stream_checkpoint(ck)
        if not 0 < saved["file_offset"] < small.stat().st_size:
            raise AssertionError(f"checkpoint offset {saved['file_offset']}")
        expect(
            hash_count_file(
                str(small), K, batch_size=8192, max_len=MAX_LEN,
                device="cuda", host_workers=1, resume_from=str(ck),
            ),
            SMALL_COPIES, table1, "resumed run",
        )
        log(f"packed=False and resume from byte {saved['file_offset']}: "
            "equal to the per-copy results")

        # ---- 5. kernel times at the main path's shapes -----------------
        times = time_kernels(errors, str(big))

    # ---- 6. nothing this run started outlives it ----------------------
    running = child_processes()
    log(f"children before the stop: {running or 'none'}")
    left = stop_children()
    if left:
        raise AssertionError(f"processes still running after the stop: {left}")
    log("children after the stop: none")

    name, power = [s.strip() for s in card.split(",", 1)]
    kernels = [
        {
            "name": "hash_keys",
            "route": "cuda",
            "source": "needletail_tpu_torch/csrc/hash_keys.cu",
            "replaces": "needletail_tpu/device/pallas_kernels.py:368",
            "also_replaces": "needletail_tpu/device/pallas_kernels.py:301",
            "launches": launches["hash_keys"],
            "max_abs_err": errors.worst["hash_keys"],
            "tolerance": 0,
            "ms": times["hash_keys"],
            "plain_ms": times["hash_keys_plain"],
            "ascii_ms": times["hash_keys_ascii"],
            "ascii_plain_ms": times["hash_keys_ascii_plain"],
            "shape": f"[{BATCH}, {MAX_LEN}] k={K}",
            "card": name,
            "power_limit": power,
        },
        {
            "name": "histogram16",
            "route": "cuda",
            "source": "needletail_tpu_torch/csrc/histogram16.cu",
            "replaces": "needletail_tpu/device/pallas_kernels.py:503",
            "launches": launches["histogram16"],
            "max_abs_err": errors.worst["histogram16"],
            "tolerance": 0,
            "ms": times["histogram16"],
            "plain_ms": times["histogram16_plain"],
            "shape": f"[{BATCH * MAX_LEN}] keys",
            "card": name,
            "power_limit": power,
        },
    ]
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    try:
        rc = run()
    finally:
        # on a failed phase too: leave no process behind
        stop_children()
    sys.exit(rc)
