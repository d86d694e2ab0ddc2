"""The control of ``correct``, run on the card at a cell's own size.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 --seconds 5

For each seed, runs the cell with the program's own forward-strand path
switched on (``canonical=False``), which breaks the canonical guarantee
that the configuration states, and prints the numbers compared with
their limits: the control has to come out as not correct.  The lower
readings are the cell's own runs.  The benchmark's own runs never run
this.
"""

import argparse
import json
import sys
from pathlib import Path

sys.path[0] = str(Path(__file__).resolve().parent.parent)

from portbench import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    try:
        for seed in (int(s) for s in args.seeds.split(",")):
            r = harness.run_cell(args.workload, seed, args.seconds, False,
                                 options={"canonical": False})
            print(json.dumps({
                "workload": args.workload, "seed": seed,
                "correct": r["correct"], "attempted": r["attempted"],
                "check": r["check"],
            }), flush=True)
    finally:
        harness.stop_children()
    return 0


if __name__ == "__main__":
    sys.exit(main())
