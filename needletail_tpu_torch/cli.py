"""Command line of the port: ``python -m needletail_tpu_torch.cli <command>``.

    python -m needletail_tpu_torch.cli hash-count reads.fq -k 21
    python -m needletail_tpu_torch.cli count reads.fq -k 31 --top 10
    python -m needletail_tpu_torch.cli count reads.fq -k 4,21,31
    python -m needletail_tpu_torch.cli count reads.fq -k 31 --bucketed --quality-cutoff 20
    python -m needletail_tpu_torch.cli minimizers reads.fq -k 21 -w 11
    python -m needletail_tpu_torch.cli filter reads.fq kept.fq --min-quality 30
    python -m needletail_tpu_torch.cli spectrum genome.fa -k 31 -o spec.npz
    python -m needletail_tpu_torch.cli stats reads.fq.gz --composition
    python -m needletail_tpu_torch.cli bgzip reads.fq.gz -o reads.fq.bgz
    python -m needletail_tpu_torch.cli convert reads.fq reads.fa --unix

print what the same ``needletail-tpu`` commands print and write the same
bytes.  ``stats``, ``bgzip`` and ``convert`` run on the host alone: they
take no ``--device`` and import no ``torch``.

``--sharded`` (``count``, ``hash-count``, ``minimizers``, ``spectrum``)
runs the ``parallel`` drivers over every rank of a process group: a world
of one on this process's device, or under ``torchrun --nproc-per-node=N``
the group its environment describes (NCCL on the cards, gloo with
``--device cpu``).  Rank 0 prints, the same output as the flat command.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from typing import Optional


def _profile_meter(args):
    if not args.profile:
        return None
    from .utils.profiling import ThroughputMeter

    return ThroughputMeter()


def _paths(args):
    return args.path if len(args.path) > 1 else args.path[0]


@contextlib.contextmanager
def _sharded(args):
    """``--sharded``: yields a ``(data, 1)`` mesh over every rank of the
    process group (started here, ended on the way out) and whether this
    rank prints; ``(None, True)`` without the flag."""
    if not getattr(args, "sharded", False):
        yield None, True
        return
    import torch.distributed as dist

    from .parallel import make_mesh
    from .parallel.distributed import initialize, shutdown

    initialize(device=args.device)
    try:
        yield make_mesh(data=dist.get_world_size(), table=1), dist.get_rank() == 0
    finally:
        shutdown()


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


def _sparse_pairs(spec):
    """One k's spectrum as sorted ``(keys, counts)`` pairs (a dense table
    through its nonzero bins)."""
    import numpy as np

    if isinstance(spec, tuple):
        return spec
    keys = np.flatnonzero(spec).astype(np.uint64)
    return keys, spec[keys.astype(np.int64)]


def _top_kmers(keys, counts, k: int, top: int) -> None:
    import numpy as np

    from .bitkmer import bitmer_to_bytes

    for i in np.argsort(counts)[::-1][:top]:
        print(f"{bitmer_to_bytes((int(keys[i]), k)).decode()}\t{int(counts[i])}")


def _write_dump(dump: str, spectra) -> None:
    """``--dump``: every ``(keys, counts, k)`` spectrum as TSV, to a file
    or with ``-`` to stdout."""
    if dump == "-":
        for keys, counts, k in spectra:
            _dump_spectrum(sys.stdout.buffer, keys, counts, k)
        return
    with open(dump, "wb") as fh:
        for keys, counts, k in spectra:
            _dump_spectrum(fh, keys, counts, k)


def _report_multi_k(spec, n_bases, ks, args) -> None:
    """Per-k summaries on stderr, one npz of every spectrum, the TSV dump
    and the top listings, as ``needletail-tpu count -k 4,21,31`` prints
    them."""
    import numpy as np

    out = {k: _sparse_pairs(sp) for k, sp in spec.items()}
    for k, (keys, counts) in out.items():
        print(
            f"# k={k}: {int(counts.sum())} canonical k-mers, "
            f"{len(keys)} distinct",
            file=sys.stderr,
        )
    print(f"# {n_bases} bases ({len(ks)} k values in one pass)",
          file=sys.stderr)
    if args.output:
        np.savez_compressed(
            args.output,
            ks=np.asarray(ks),
            **{f"keys_{k}": v[0] for k, v in out.items()},
            **{f"counts_{k}": v[1] for k, v in out.items()},
        )
        print(f"# spectra written to {args.output}", file=sys.stderr)
    if args.dump:
        _write_dump(args.dump, [(keys, counts, k) for k, (keys, counts) in out.items()])
    if args.top:
        for k, (keys, counts) in out.items():
            print(f"# top {args.top} for k={k}:")
            _top_kmers(keys, counts, k, args.top)


def _cmd_stats(args) -> int:
    import numpy as np

    from .io.fast_batch import fast_read_batches

    n_reads = n_bases = 0
    min_len = None
    max_len = 0
    byte_counts = np.zeros(256, np.int64) if args.composition else None
    t0 = time.perf_counter()
    for b in fast_read_batches(args.path, batch_size=args.batch_size):
        n = b.num_reads
        n_reads += n
        lens = b.lengths[:n]
        n_bases += int(lens.sum())
        if n:
            lo = int(lens.min())
            min_len = lo if min_len is None else min(min_len, lo)
            max_len = max(max_len, int(lens.max()))
        if byte_counts is not None and n:
            # one bincount over the padded plane; bin 0 is exactly the
            # padding (real bases are ASCII letters, never NUL)
            byte_counts += np.bincount(
                b.seqs[:n].reshape(-1), minlength=256
            )
    el = time.perf_counter() - t0
    out = {
        "reads": n_reads,
        "bases": n_bases,
        "min_len": min_len or 0,
        "max_len": max_len,
        "mean_len": round(n_bases / n_reads, 2) if n_reads else 0,
        "seconds": round(el, 3),
        "bases_per_sec": round(n_bases / el) if el > 0 else None,
    }
    if byte_counts is not None:
        byte_counts[0] = 0  # padding
        comp = {}
        for base in "ACGT":
            comp[base] = int(
                byte_counts[ord(base)] + byte_counts[ord(base.lower())]
            )
        comp["N"] = int(byte_counts[ord("N")] + byte_counts[ord("n")])
        comp["other"] = int(byte_counts.sum() - sum(comp.values()))
        acgt = sum(comp[b] for b in "ACGT")
        out["composition"] = comp
        out["gc_fraction"] = (
            round((comp["G"] + comp["C"]) / acgt, 6) if acgt else None
        )
    print(json.dumps(out))
    return 0


def _cmd_bgzip(args) -> int:
    from .io.bgzf import write_bgzf_stream
    from .io.compression import open_uncompressed

    # transparently decode any supported codec, then re-block as BGZF —
    # streamed, O(block_size) memory (open_uncompressed chains the
    # sniffed first byte back in front)
    with open(args.path, "rb") as f:
        stream, _first = open_uncompressed(f)
        total = write_bgzf_stream(stream, args.output, block_size=args.block_size)
    print(f"# {total} bytes -> {args.output}", file=sys.stderr)
    return 0


def _cmd_convert(args) -> int:
    """FASTA/FASTQ conversion through the reference round-trip writers
    (ref record.rs:207-247): sequences unwrap to one line, FASTA -> FASTQ
    fills qualities with 'I' (the reference's missing-qual rule), input
    line endings are preserved unless --unix."""
    from .parser import parse_fastx_file
    from .parser.record import write_fasta, write_fastq
    from .parser.utils import LineEnding

    fmt = args.to
    if fmt is None:
        low = args.output.lower()
        if low.endswith((".fa", ".fasta", ".fna")):
            fmt = "fasta"
        elif low.endswith((".fq", ".fastq")):
            fmt = "fastq"
        else:
            raise SystemExit(
                "cannot infer the target format from the output name; "
                "pass --to fasta|fastq"
            )
    forced = LineEnding.UNIX if args.unix else None
    n = 0
    reader = parse_fastx_file(args.path)
    with open(args.output, "wb") as out:
        while (rec := reader.next()) is not None:
            ending = forced or rec.line_ending()
            seq = rec.strip_returns()
            if fmt == "fasta":
                write_fasta(rec.id(), seq, out, ending)
            else:
                write_fastq(rec.id(), seq, rec.qual(), out, ending)
            n += 1
    print(f"# {n} records -> {args.output} ({fmt})", file=sys.stderr)
    return 0


def _cmd_count(args) -> int:
    import numpy as np

    from .device.pipeline import count_file

    ks = tuple(int(x) for x in str(args.k).split(","))
    if args.profile and (args.sharded or len(ks) > 1):
        raise SystemExit(
            "--profile instruments the single-k flat stream "
            "(drop --sharded / use one k)"
        )
    meter = _profile_meter(args)
    kw = dict(
        batch_size=args.batch_size,
        bucketed=args.bucketed,
        quality_cutoff=args.quality_cutoff,
        host_workers=args.host_workers,
        checkpoint_every=args.checkpoint_every,
        checkpoint_path=args.checkpoint,
        resume_from=args.resume_from,
    )
    with _sharded(args) as (mesh, prints):
        if mesh is None:
            n_bases, spec = count_file(
                _paths(args), k=ks if len(ks) > 1 else ks[0],
                sparse_format="arrays", meter=meter, device=args.device, **kw
            )
        elif len(ks) > 1:
            from .parallel import sharded_multi_k_count_file

            n_bases, spec = sharded_multi_k_count_file(
                _paths(args), ks, mesh, **kw
            )
        else:
            from .parallel import sharded_count_file

            n_bases, spec = sharded_count_file(_paths(args), ks[0], mesh, **kw)
    if not prints:
        return 0
    if len(ks) > 1:
        _report_multi_k(spec, n_bases, ks, args)
        return 0
    if meter is not None:
        print(meter.report(), file=sys.stderr)
    keys, counts = _sparse_pairs(spec)
    k = ks[0]
    print(
        f"# {n_bases} bases, {int(counts.sum())} canonical {k}-mers, "
        f"{len(keys)} distinct",
        file=sys.stderr,
    )
    if args.output:
        np.savez_compressed(args.output, keys=keys, counts=counts, k=k)
        print(f"# spectrum written to {args.output}", file=sys.stderr)
    if args.dump:
        _write_dump(args.dump, [(keys, counts, k)])
    if args.top:
        _top_kmers(keys, counts, k, args.top)
    return 0


def _cmd_spectrum(args) -> int:
    import numpy as np

    from .device.tiling import genome_spectrum

    with _sharded(args) as (mesh, prints):
        n_bases, spec = genome_spectrum(
            args.path, k=args.k, tile_len=args.tile_len,
            sparse_format="arrays", mesh=mesh, device=args.device,
        )
    if not prints:
        return 0
    keys, counts = _sparse_pairs(spec)
    print(f"# {n_bases} bases, {len(keys)} distinct {args.k}-mers",
          file=sys.stderr)
    if args.output:
        np.savez_compressed(args.output, keys=keys, counts=counts, k=args.k)
        print(f"# spectrum written to {args.output}", file=sys.stderr)
    if args.dump:
        _write_dump(args.dump, [(keys, counts, args.k)])
    if args.top:
        _top_kmers(keys, counts, args.k, args.top)
    return 0


def _cmd_minimizers(args) -> int:
    import numpy as np

    from .device.pipeline import minimizer_spectrum_file

    meter = _profile_meter(args)
    with _sharded(args) as (mesh, prints):
        n_bases, (keys, counts) = minimizer_spectrum_file(
            args.path, k=args.k, w=args.w, batch_size=args.batch_size,
            mesh=mesh, meter=meter,
            checkpoint_every=args.checkpoint_every,
            checkpoint_path=args.checkpoint,
            resume_from=args.resume_from,
            device=args.device,
        )
    if not prints:
        return 0
    if meter is not None:
        print(meter.report(), file=sys.stderr)
    print(
        f"# {n_bases} bases, {len(keys)} distinct ({args.w},{args.k})-minimizers, "
        f"{int(counts.sum())} winning windows",
        file=sys.stderr,
    )
    if args.output:
        np.savez_compressed(args.output, keys=keys, counts=counts, k=args.k,
                            w=args.w)
        print(f"# spectrum written to {args.output}", file=sys.stderr)
    if args.dump:
        _write_dump(args.dump, [(keys, counts, args.k)])
    if args.top:
        _top_kmers(keys, counts, args.k, args.top)
    return 0


def _cmd_filter(args) -> int:
    from .device.pipeline import quality_filter_file

    n_in, n_kept = quality_filter_file(
        args.path, args.output, args.min_quality, batch_size=args.batch_size,
        device=args.device,
    )
    print(json.dumps({"reads_in": n_in, "reads_kept": n_kept}))
    return 0


def _cmd_hash_count(args) -> int:
    import numpy as np

    from .device.pipeline import hash_count_file

    meter = _profile_meter(args)
    kw = dict(
        table_bits=args.table_bits,
        batch_size=args.batch_size,
        host_workers=args.host_workers,
        checkpoint_every=args.checkpoint_every,
        checkpoint_path=args.checkpoint,
        resume_from=args.resume_from,
        meter=meter,
    )
    with _sharded(args) as (mesh, prints):
        if mesh is None:
            n_bases, total, fwd, table = hash_count_file(
                _paths(args), k=args.k, device=args.device, **kw
            )
        else:
            from .parallel import sharded_hash_count_file

            n_bases, total, fwd, table = sharded_hash_count_file(
                _paths(args), args.k, mesh, **kw
            )
    if not prints:
        return 0
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


def _add_device_flag(p) -> None:
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (the CUDA kernels, default) or "
                        "cpu (their plain PyTorch versions)")


def _add_output_flags(p, what: str) -> None:
    p.add_argument("--top", type=int, default=0,
                   help="print the N most frequent")
    p.add_argument("-o", "--output", help=f"write {what} .npz")
    p.add_argument("--dump",
                   help="write the FULL spectrum as kmer\\tcount TSV "
                        "(keys ascending; '-' = stdout)")


def _add_common_flags(p, batch_size: int, k_help: Optional[str] = None) -> None:
    p.add_argument("path", nargs="+",
                   help="input file(s); several files accumulate into ONE "
                        "result")
    if k_help is None:
        p.add_argument("-k", type=int, required=True)
    else:
        p.add_argument("-k", required=True, help=k_help)
    p.add_argument("--batch-size", type=int, default=batch_size)
    p.add_argument("--host-workers", type=int, default=None,
                   help="framing processes (default: auto from CPU count)")
    _add_device_flag(p)
    _add_stream_flags(p)


def _add_stream_flags(p) -> None:
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

    p = sub.add_parser("stats", help="read/base counts at framer speed (no device)")
    p.add_argument("path")
    p.add_argument("--batch-size", type=int, default=8192)
    p.add_argument("--composition", action="store_true",
                   help="also report A/C/G/T/N/other counts and GC fraction")
    p.set_defaults(fn=_cmd_stats)

    p = sub.add_parser("count", help="exact canonical k-mer spectrum")
    _add_common_flags(
        p, batch_size=4096,
        k_help="k, or a comma list (e.g. 4,21,31) counted in ONE pass",
    )
    p.add_argument("--bucketed", action="store_true",
                   help="length-bucketed batching")
    p.add_argument("--quality-cutoff", type=int, default=None,
                   help="mask bases below this Phred score before counting "
                        "(FASTQ)")
    p.add_argument("--sharded", action="store_true",
                   help="exact spectrum over every rank (per-rank sorts)")
    _add_output_flags(p, "spectrum")
    p.set_defaults(fn=_cmd_count)

    p = sub.add_parser("hash-count", help="hash count table (headline pipeline)")
    _add_common_flags(p, batch_size=65536)
    p.add_argument("--table-bits", type=int, default=16)
    p.add_argument("--sharded", action="store_true",
                   help="run the hash pipeline over every rank (table "
                        "sharded by reduce-scatter; same result)")
    p.add_argument("-o", "--output", help="write table .npz")
    p.set_defaults(fn=_cmd_hash_count)

    p = sub.add_parser("bgzip", help="recompress to BGZF (block-parallel decompressible)")
    p.add_argument("path")
    p.add_argument("-o", "--output", required=True)
    p.add_argument("--block-size", type=int, default=65280)
    p.set_defaults(fn=_cmd_bgzip)

    p = sub.add_parser("filter", help="drop reads below a mean Phred score")
    p.add_argument("path")
    p.add_argument("output")
    p.add_argument("--min-quality", type=float, required=True)
    p.add_argument("--batch-size", type=int, default=4096)
    _add_device_flag(p)
    p.set_defaults(fn=_cmd_filter)

    p = sub.add_parser("minimizers", help="(w,k) minimizer spectrum")
    p.add_argument("path")
    p.add_argument("-k", type=int, required=True)
    p.add_argument("-w", type=int, required=True,
                   help="windows per sketch position")
    p.add_argument("--batch-size", type=int, default=4096)
    p.add_argument("--sharded", action="store_true",
                   help="shard the sketch over every rank")
    _add_device_flag(p)
    _add_stream_flags(p)
    _add_output_flags(p, "spectrum")
    p.set_defaults(fn=_cmd_minimizers)

    p = sub.add_parser(
        "convert", help="FASTA<->FASTQ conversion (reference writer semantics)"
    )
    p.add_argument("path")
    p.add_argument("output")
    p.add_argument("--to", choices=("fasta", "fastq"), default=None,
                   help="target format (default: inferred from the output name)")
    p.add_argument("--unix", action="store_true",
                   help="force Unix line endings (default: preserve input's)")
    p.set_defaults(fn=_cmd_convert)

    p = sub.add_parser("spectrum", help="whole-genome spectrum via halo tiling")
    p.add_argument("path")
    p.add_argument("-k", type=int, required=True)
    p.add_argument("--tile-len", type=int, default=8192)
    p.add_argument("--sharded", action="store_true",
                   help="tile batches over every rank (halo tiling x mesh)")
    _add_device_flag(p)
    _add_output_flags(p, "spectrum")
    p.set_defaults(fn=_cmd_spectrum)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
