"""Command line of the port: ``python -m needletail_tpu_torch.cli <command>``.

    python -m needletail_tpu_torch.cli hash-count reads.fq -k 21

prints the same JSON line as ``needletail-tpu hash-count``.  Only the
hash-count command is ported so far.
"""

from __future__ import annotations

import argparse
import json
import sys


def _cmd_hash_count(args) -> int:
    import numpy as np

    from .device.pipeline import hash_count_file

    meter = None
    if args.profile:
        from needletail_tpu.utils.profiling import ThroughputMeter

        meter = ThroughputMeter()
    path = args.path if len(args.path) > 1 else args.path[0]
    n_bases, total, fwd, table = hash_count_file(
        path,
        k=args.k,
        table_bits=args.table_bits,
        batch_size=args.batch_size,
        host_workers=args.host_workers,
        checkpoint_every=args.checkpoint_every,
        checkpoint_path=args.checkpoint,
        resume_from=args.resume_from,
        meter=meter,
        device=args.device,
    )
    if meter is not None:
        print(meter.report(), file=sys.stderr)
    print(
        json.dumps(
            {
                "bases": n_bases,
                "windows": total,
                "forward": fwd,
                "bins": len(table),
                "nonzero_bins": int((table > 0).sum()),
            }
        )
    )
    if args.output:
        np.savez_compressed(args.output, table=table, k=args.k)
        print(f"# table written to {args.output}", file=sys.stderr)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="needletail_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("hash-count", help="hash count table (headline pipeline)")
    p.add_argument("path", nargs="+",
                   help="input file(s); several files accumulate into ONE "
                        "table")
    p.add_argument("-k", type=int, required=True)
    p.add_argument("--table-bits", type=int, default=16)
    p.add_argument("--batch-size", type=int, default=65536)
    p.add_argument("--host-workers", type=int, default=None,
                   help="framing processes (default: auto from CPU count)")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (the CUDA kernels, default) or "
                        "cpu (their plain PyTorch versions)")
    p.add_argument("-o", "--output", help="write table .npz")
    p.add_argument("--profile", action="store_true",
                   help="print a per-stage throughput breakdown (frame, "
                        "h2d, wait, dispatch, drain) to stderr")
    p.add_argument("--checkpoint", default=None, metavar="PATH",
                   help="write a resumable state file here every "
                        "--checkpoint-every batches")
    p.add_argument("--checkpoint-every", type=int, default=None, metavar="N",
                   help="batches between checkpoints (needs --checkpoint; "
                        "single-stream, uncompressed input)")
    p.add_argument("--resume-from", default=None, metavar="PATH",
                   help="resume from a checkpoint written by either package")
    p.set_defaults(fn=_cmd_hash_count)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
