"""Run one cell of the port's benchmark and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Exits 3 with no result where CUDA is missing or has fewer cards than the
cell asks for, and 1 where the run fails or has loaded JAX or the JAX
package.  The last line of standard output is the JSON result; the last
lines of standard error are the numbers compared, each with its limit.
"""

import argparse
import json
import os
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
# every build and kernel cache at a fixed path inside the checkout; the
# port's own kernels build under build/needletail_tpu_torch/ already
_CACHE = REPO / "build" / "portbench"
os.environ["TRITON_CACHE_DIR"] = str(_CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(_CACHE / "torch_extensions")
# one host thread for the intra-op pools of torch, OpenMP and MKL (the
# framing pool's spawned workers inherit it): on a host whose cores are
# shared, a parallel region waits for its slowest thread, and runs of one
# seed then spread by a third
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[_var] = "1"
# the package by its name from the checkout's root, never this folder's
# files as top-level modules
sys.path[0] = str(REPO)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench import harness

    try:
        result = harness.run_cell(
            args.workload, args.seed, args.seconds, bool(args.trace)
        )
    except harness.NoDevice as exc:
        print(f"portbench: {exc}", file=sys.stderr)
        return 3
    finally:
        alive = harness.stop_children()
        if alive:
            print(f"portbench: children still alive: {alive}", file=sys.stderr)
    for name, c in result["check"].items():
        limit = f"max {c['max']}" if "max" in c else f"min {c['min']}"
        print(f"check {name} {c['value']} ({limit})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
