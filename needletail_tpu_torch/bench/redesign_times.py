"""Card times of the window kernels (``csrc/hash_keys.cu``) and the block
sort (``csrc/block_sort.cu``) of this checkout and, with ``--against DIR``,
of another checkout of the repository, on the same inputs in one run.

    python3 needletail_tpu_torch/bench/redesign_times.py [--against DIR]

Each checkout is timed in a process of its own that imports that
checkout's ``needletail_tpu_torch``, so its wrappers build its own
``csrc/`` into its own ``build/``; with ``--against`` the order is DIR,
this checkout, this checkout, DIR.  Every process times with this
checkout's ``bench.cuda_ms`` (the calls queued behind a spin kernel), so
both read on one clock whatever the other checkout's ``cuda_ms`` does.
The inputs are ``chip_smoke.py``'s: the first 131,072 x 128 batch of
``tests/data/PRJNA271013_head.fq`` written over and over, framed packed
(with its validity plane and without one) and as ASCII, and 2^23 random
uint32 keys of seed 0 for the block sort at spans of 2^14, 2^16 and 2^17.
Each output's digest (its parts summed as int64) must be the same in
every process, or the run fails.

Prints one JSON line per process, the card's name and power limit, and a
last line ``{"card": ..., "ms": {label: {name: [ms, ...]}}}``.  It needs a
CUDA GPU and ``nvidia-smi``.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import subprocess
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve()
ROOT = HERE.parents[2]
FQ = ROOT / "tests" / "data" / "PRJNA271013_head.fq"
BATCH, MAX_LEN, K = 131072, 128, 21
SORT_LANES = 1 << 23
SORT_BLOCKS = (1 << 14, 1 << 16, 1 << 17)
WINDOW_REPS, SORT_REPS = 20, 10


def _bench():
    """This checkout's ``bench/__init__.py``, loaded by path, so a process
    that imports another checkout's package still times on this clock."""
    spec = importlib.util.spec_from_file_location(
        "_redesign_timing", HERE.with_name("__init__.py")
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _digest(out) -> list:
    import torch

    parts = out if isinstance(out, tuple) else (out,)
    return [int(p.to(torch.int64).sum()) if torch.is_tensor(p) else int(p)
            for p in parts]


def _inputs(tmp: Path):
    """The packed planes, the ASCII planes and the sort keys on the card."""
    import numpy as np
    import torch

    from needletail_tpu_torch.device.ops import resolve_vbits, unwire
    from needletail_tpu_torch.io.fast_batch import fast_read_batches

    text = FQ.read_bytes()
    copies = math.ceil(BATCH / (text.count(b"\n") // 4))
    path = tmp / "reads.fq"
    path.write_bytes(text * copies)

    def first_batch(**kw):
        batches = fast_read_batches(
            str(path), batch_size=BATCH, max_len=MAX_LEN, **kw
        )
        try:
            return next(batches)
        finally:
            batches.close()

    packed = first_batch(packed=True)
    buf, layout = packed.wire_frame(BATCH)
    codes, lengths, vbits, vrow_idx, vrows = unwire(
        torch.from_numpy(buf).to("cuda"), layout
    )
    vb = resolve_vbits(vbits, vrow_idx, vrows, BATCH)
    if vb is None:
        raise AssertionError("the batch has no validity plane to time")
    ascii_b = first_batch(with_quals=False)
    seqs = torch.from_numpy(np.ascontiguousarray(ascii_b.seqs)).to("cuda")
    ln = torch.from_numpy(ascii_b.lengths.astype(np.int32)).to("cuda")
    host = np.random.default_rng(0).integers(
        0, 1 << 32, size=SORT_LANES, dtype=np.uint32
    )
    x = torch.from_numpy(host.view(np.int32)).to("cuda")
    return (codes, vb, lengths), (seqs, ln), x


def time_tree(tree: Path) -> dict:
    """``{name: {"ms", "digest"}}`` of ``tree``'s kernels on this process's
    card."""
    sys.path.insert(0, str(tree))
    import torch

    from needletail_tpu_torch.device import kernels as K_

    if Path(K_.__file__).resolve().parents[2] != tree.resolve():
        raise AssertionError(f"imported {K_.__file__}, not {tree}'s package")
    cuda_ms = _bench().cuda_ms
    with tempfile.TemporaryDirectory() as tmp:
        (codes, vb, lengths), (seqs, ln), x = _inputs(Path(tmp))
    calls = {
        "hash_keys packed": lambda: K_.canonical_hash_keys_packed(
            codes, vb, lengths, K, 16),
        "hash_keys packed, no validity plane":
            lambda: K_.canonical_hash_keys_packed(codes, None, lengths, K, 16),
        "hash_keys ascii": lambda: K_.canonical_hash_keys(seqs, ln, K, 16),
        "key_planes packed k=21": lambda: K_.canonical_key_planes_packed(
            codes, vb, lengths, 21),
        "key_planes packed k=21, no validity plane":
            lambda: K_.canonical_key_planes_packed(codes, None, lengths, 21),
        "key_planes packed k=31": lambda: K_.canonical_key_planes_packed(
            codes, vb, lengths, 31),
        "key_planes ascii k=21": lambda: K_.canonical_key_planes(seqs, ln, 21),
        "hash_tally ascii": lambda: K_.canonical_hash_tally(seqs, ln, K, 16),
    }
    for bl in SORT_BLOCKS:
        calls[f"block_sort {bl}"] = (lambda b=bl: K_.bitonic_block_sort(x, b))
    out = {}
    for name, fn in calls.items():
        reps = SORT_REPS if name.startswith("block_sort") else WINDOW_REPS
        out[name] = {"ms": cuda_ms(fn, reps), "digest": _digest(fn())}
    torch.cuda.synchronize()
    return out


def compare(against: Path | None) -> dict:
    """Time each checkout in its own process; fail on differing digests."""
    order = [("this", ROOT)]
    if against is not None:
        order = [("previous", against), ("this", ROOT), ("this", ROOT),
                 ("previous", against)]
    ms: dict = {}
    digests: dict = {}
    for label, tree in order:
        proc = subprocess.run(
            [sys.executable, str(HERE), "--tree", str(tree)],
            capture_output=True, text=True, timeout=900,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"timing {tree} failed:\n{proc.stderr[-4000:]}")
        got = json.loads(proc.stdout.strip().splitlines()[-1])
        print(json.dumps({"label": label, "tree": str(tree), **got}), flush=True)
        for name, t in got.items():
            ms.setdefault(label, {}).setdefault(name, []).append(t["ms"])
            if digests.setdefault(name, t["digest"]) != t["digest"]:
                raise AssertionError(f"{name}: {tree} computes another result")
    return ms


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--against", type=Path, default=None,
                    help="another checkout of the repository to time")
    ap.add_argument("--tree", type=Path, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.tree is not None:
        print(json.dumps(time_tree(args.tree)))
        return 0
    ms = compare(args.against)
    card = _bench().card_line()
    print(card)
    print(json.dumps({"card": card, "ms": ms}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
