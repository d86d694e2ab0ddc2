"""Command line of the port: ``python -m needletail_tpu_torch.cli <command>``.

    python -m needletail_tpu_torch.cli hash-count reads.fq -k 21
    python -m needletail_tpu_torch.cli count reads.fq -k 31 --top 10

print what ``needletail-tpu hash-count`` and ``needletail-tpu count``
print.  ``--sharded`` and, for ``count``, a list of k values, ``--bucketed``
and ``--quality-cutoff`` are not ported yet.
"""

from __future__ import annotations

import argparse
import json
import sys


def _profile_meter(args):
    if not args.profile:
        return None
    from .utils.profiling import ThroughputMeter

    return ThroughputMeter()


def _paths(args):
    return args.path if len(args.path) > 1 else args.path[0]


def _decode(key: int, k: int) -> str:
    """ASCII bases of a packed k-mer (first base most significant)."""
    return "".join("ACGT"[(key >> (2 * (k - 1 - i))) & 3] for i in range(k))


def _dump_spectrum(fh, keys, counts, k: int) -> None:
    """``kmer\\tcount`` TSV lines, keys ascending, decoded a chunk at a
    time with one table lookup."""
    import numpy as np

    lut = np.frombuffer(b"ACGT", dtype=np.uint8)
    shifts = (2 * (k - 1 - np.arange(k))).astype(np.uint64)
    step = 1 << 18
    for lo in range(0, len(keys), step):
        kc = np.asarray(keys[lo : lo + step], dtype=np.uint64)
        codes = ((kc[:, None] >> shifts[None, :]) & np.uint64(3)).astype(np.uint8)
        rows = np.ascontiguousarray(lut[codes]).view(f"S{k}").ravel()
        cs = np.char.mod(b"%d", np.asarray(counts[lo : lo + step]))
        lines = np.char.add(np.char.add(rows, b"\t"), cs)
        fh.write(b"\n".join(lines.tolist()) + b"\n")


def _cmd_count(args) -> int:
    import numpy as np

    from .device.pipeline import count_file

    meter = _profile_meter(args)
    n_bases, spec = count_file(
        _paths(args),
        k=args.k,
        batch_size=args.batch_size,
        sparse_format="arrays",
        host_workers=args.host_workers,
        checkpoint_every=args.checkpoint_every,
        checkpoint_path=args.checkpoint,
        resume_from=args.resume_from,
        meter=meter,
        device=args.device,
    )
    if meter is not None:
        print(meter.report(), file=sys.stderr)
    if isinstance(spec, tuple):
        keys, counts = spec
    else:
        keys = np.flatnonzero(spec).astype(np.uint64)
        counts = spec[keys.astype(np.int64)]
    k = args.k
    print(
        f"# {n_bases} bases, {int(counts.sum())} canonical {k}-mers, "
        f"{len(keys)} distinct",
        file=sys.stderr,
    )
    if args.output:
        np.savez_compressed(args.output, keys=keys, counts=counts, k=k)
        print(f"# spectrum written to {args.output}", file=sys.stderr)
    if args.dump:
        if args.dump == "-":
            _dump_spectrum(sys.stdout.buffer, keys, counts, k)
        else:
            with open(args.dump, "wb") as fh:
                _dump_spectrum(fh, keys, counts, k)
    if args.top:
        for i in np.argsort(counts)[::-1][: args.top]:
            print(f"{_decode(int(keys[i]), k)}\t{int(counts[i])}")
    return 0


def _cmd_hash_count(args) -> int:
    import numpy as np

    from .device.pipeline import hash_count_file

    meter = _profile_meter(args)
    n_bases, total, fwd, table = hash_count_file(
        _paths(args),
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


def _add_common_flags(p, batch_size: int) -> None:
    p.add_argument("path", nargs="+",
                   help="input file(s); several files accumulate into ONE "
                        "result")
    p.add_argument("-k", type=int, required=True)
    p.add_argument("--batch-size", type=int, default=batch_size)
    p.add_argument("--host-workers", type=int, default=None,
                   help="framing processes (default: auto from CPU count)")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (the CUDA kernels, default) or "
                        "cpu (their plain PyTorch versions)")
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="needletail_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("count", help="exact canonical k-mer spectrum")
    _add_common_flags(p, batch_size=4096)
    p.add_argument("--top", type=int, default=0,
                   help="print the N most frequent")
    p.add_argument("-o", "--output", help="write spectrum .npz")
    p.add_argument("--dump",
                   help="write the FULL spectrum as kmer\\tcount TSV "
                        "(keys ascending; '-' = stdout)")
    p.set_defaults(fn=_cmd_count)

    p = sub.add_parser("hash-count", help="hash count table (headline pipeline)")
    _add_common_flags(p, batch_size=65536)
    p.add_argument("--table-bits", type=int, default=16)
    p.add_argument("-o", "--output", help="write table .npz")
    p.set_defaults(fn=_cmd_hash_count)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
