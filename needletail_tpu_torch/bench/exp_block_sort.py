"""The block-sort experiment on the card: the hand-written bitonic block
sort against a flat sort and a row sort of the same keys.

Port of ``benchmarks/exp_mosaic_sort.py``'s ``main()``, which measured a
VMEM-resident bitonic network against XLA's sort on the TPU.  Here the
block sort is ``kernels.bitonic_block_sort`` (``csrc/block_sort.cu``):
first its result on 2^18 lanes is held against ``block_sort_plain`` at
every block size, then, on 2^23 random uint32 keys, it is timed at each
block size beside ``block_sort_plain``, ``torch.sort`` of all the keys and
``torch.sort`` over rows of each block size and of 65,536.  Times are CUDA events over ``reps`` calls after a
warm-up, each printed with the card's name and power limit.

    python -m needletail_tpu_torch.bench.exp_block_sort [--lanes N] [--blocks B ...]

It needs a CUDA GPU and ``nvidia-smi``, and fails without them.
"""

from __future__ import annotations

import argparse
from typing import Callable, Dict, Sequence

import numpy as np
import torch

from ..device.kernels import bitonic_block_sort, block_sort_plain
from . import card_line, cuda_ms

__all__ = ["keys", "run", "BLOCKS", "LANES", "CHECK_LANES"]

LANES = 1 << 23
BLOCKS = (1 << 14, 1 << 16, 1 << 17)
CHECK_LANES = 1 << 18
ROW_LANES = 1 << 16
_SIGN = -(1 << 31)


def keys(lanes: int = LANES, seed: int = 0):
    """The experiment's random uint32 keys, as int32 on the card."""
    host = np.random.default_rng(seed).integers(
        0, 1 << 32, size=lanes, dtype=np.uint32
    )
    return torch.from_numpy(host.view(np.int32)).to("cuda")


def run(
    lanes: int = LANES,
    blocks: Sequence[int] = BLOCKS,
    seed: int = 0,
    reps: int = 10,
    log: Callable[[str], None] = print,
) -> Dict[str, object]:
    """Check, then time; returns ``{"card", "lanes", "seed", "ms": {label:
    ms}}`` with labels ``flat``, ``block_<B>`` (the kernel), ``plain_<B>``
    (``block_sort_plain``) and ``rows_<R>`` (``torch.sort`` over rows of
    R, for R each block size and 65,536)."""
    if not torch.cuda.is_available():
        raise RuntimeError("the block-sort experiment needs a CUDA GPU")
    card = card_line()
    x = keys(lanes, seed)

    small = x[: min(CHECK_LANES, lanes)]
    for bl in blocks:
        if not torch.equal(bitonic_block_sort(small, bl), block_sort_plain(small, bl)):
            raise AssertionError(f"block sort wrong at {bl}-lane blocks")
    log(f"correctness: block sorts == block_sort_plain on {small.numel()} "
        f"lanes at blocks {list(blocks)}")

    # the unsigned keys as order-preserving int32, for torch's signed sort
    biased = x ^ _SIGN
    times = {}

    def report(label: str, what: str, ms: float) -> None:
        times[label] = ms
        log(f"{what:<32} {lanes} lanes: {ms:9.4f} ms "
            f"({ms * 1e6 / lanes:.4f} ns/lane) ({card})")

    report("flat", "torch.sort flat",
           cuda_ms(lambda: torch.sort(biased), reps))
    for bl in blocks:
        report(f"block_{bl}", f"bitonic block sort {bl}-lane blocks",
               cuda_ms(lambda: bitonic_block_sort(x, bl), reps))
        report(f"plain_{bl}", f"block_sort_plain {bl}-lane blocks",
               cuda_ms(lambda: block_sort_plain(x, bl), reps, warmup=1))
    for rl in sorted({*blocks, ROW_LANES}):
        if lanes % rl == 0:
            rows = biased.view(-1, rl)
            report(f"rows_{rl}", f"torch.sort rows {rl}",
                   cuda_ms(lambda: torch.sort(rows, dim=1), reps))
    return {"card": card, "lanes": lanes, "seed": seed, "ms": times}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--lanes", type=int, default=LANES)
    ap.add_argument("--blocks", type=int, nargs="*", default=list(BLOCKS))
    args = ap.parse_args(argv)
    run(args.lanes, args.blocks)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
