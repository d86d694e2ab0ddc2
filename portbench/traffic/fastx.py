"""The one generator of the benchmark's inputs: FASTQ read sets sampled
from a seeded genome, and FASTA assemblies, written from a traffic file's
parameters.

Every size is fixed by the traffic file and the configuration: the seed
draws the sequences, the sampling positions, the errors and the order of
the inputs, never how many there are or how long.  Lengths that follow a
distribution are its quantiles, the same set for every seed.

``generate(config, traffic, seed, outdir)`` returns the list of inputs a
cell's jobs cycle through; each holds the paths a job hands the program,
the same bases as ASCII for the reference (``seqs``: ``[n, L]`` blocks of
reads of one length, or one sequence in which a newline separates reads),
and its base count.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass, field
from pathlib import Path
from statistics import NormalDist
from typing import Dict, List

import numpy as np

__all__ = ["Input", "generate", "quantile_lengths"]

ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)
COMPLEMENT = np.zeros(256, dtype=np.uint8)
for _a, _b in zip(b"ACGTN", b"TGCAN"):
    COMPLEMENT[_a] = _b
_N = ord("N")
_FASTA_LINE = 80


@dataclass
class Input:
    """One job's input: ``paths`` for the program, ``seqs`` for the
    reference, ``bases`` in all."""

    paths: List[str]
    seqs: List[np.ndarray]
    bases: int
    windows: Dict[int, int] = field(default_factory=dict)


def quantile_lengths(n: int, dist: dict) -> np.ndarray:
    """``n`` lengths at the midpoint quantiles of a lognormal given by its
    ``median`` (or ``mean``) and ``sigma``, clipped to ``[min, max]``, in
    ascending order: the same set for every seed."""
    sigma = float(dist["sigma"])
    if "median" in dist:
        mu = math.log(dist["median"])
    else:
        mu = math.log(dist["mean"]) - sigma * sigma / 2
    z = NormalDist()
    q = np.array([z.inv_cdf((i + 0.5) / n) for i in range(n)])
    lengths = np.exp(mu + sigma * q)
    return np.clip(np.rint(lengths), dist["min"], dist["max"]).astype(np.int64)


def _bases(rng: np.random.Generator, n: int, gc: float) -> np.ndarray:
    """``n`` random ASCII bases with GC share ``gc``."""
    at = (1.0 - gc) / 2
    edges = np.cumsum([at, gc / 2, gc / 2]) * 65536
    lut = ACGT[np.searchsorted(edges, np.arange(65536), side="right")]
    return lut[rng.integers(0, 65536, n, dtype=np.uint16)]


def _revcomp(seqs: np.ndarray) -> np.ndarray:
    return COMPLEMENT[seqs[..., ::-1]]


def _mutate(rng: np.random.Generator, flat: np.ndarray, rates: dict) -> None:
    """Substitute ``sub_rate`` of the bases in place by another base, then
    set ``n_rate`` of them to N; the numbers of each are fixed by the
    rates, the positions drawn."""
    n_sub = int(round(flat.size * rates.get("sub_rate", 0.0)))
    if n_sub:
        at = rng.integers(0, flat.size, n_sub)
        code = np.searchsorted(ACGT, flat[at])
        flat[at] = ACGT[(code + rng.integers(1, 4, n_sub)) % 4]
    n_n = int(round(flat.size * rates.get("n_rate", 0.0)))
    if n_n:
        flat[rng.integers(0, flat.size, n_n)] = _N


def _qualities(rng: np.random.Generator, seqs: np.ndarray, mix) -> np.ndarray:
    """Phred+33 quality bytes drawn from ``mix`` (``[[phred, weight],
    ...]``), Phred 2 at every N."""
    phred = np.array([p for p, _ in mix], dtype=np.uint8)
    weight = np.array([w for _, w in mix], dtype=np.float64)
    edges = np.cumsum(weight / weight.sum())[:-1] * 65536
    lut = phred[np.searchsorted(edges, np.arange(65536), side="right")] + 33
    quals = lut[rng.integers(0, 65536, seqs.shape, dtype=np.uint16)]
    quals[seqs == _N] = 33 + 2
    return quals


def _digits(values: np.ndarray, width: int) -> np.ndarray:
    """``[n, width]`` ASCII decimal digits of ``values``, zero-padded."""
    powers = 10 ** np.arange(width - 1, -1, -1, dtype=np.int64)
    return ((values[:, None] // powers) % 10 + ord("0")).astype(np.uint8)


def _write_fixed_fastq(path: Path, prefix: bytes, suffix: bytes,
                       seqs: np.ndarray, quals: np.ndarray) -> None:
    """FASTQ of reads of one length, laid out as one byte matrix:
    ``@<prefix><index><suffix>``, the bases, ``+``, the qualities."""
    n, length = seqs.shape
    width = len(str(max(n - 1, 0)))
    head = b"@" + prefix
    tail_name = suffix + b"\n"
    rec = len(head) + width + len(tail_name) + length + 3 + length + 1
    out = np.empty((n, rec), dtype=np.uint8)
    col = 0

    def put(block) -> None:
        nonlocal col
        w = block.shape[-1] if isinstance(block, np.ndarray) else len(block)
        out[:, col:col + w] = (
            block if isinstance(block, np.ndarray)
            else np.frombuffer(block, np.uint8)
        )
        col += w

    put(head)
    put(_digits(np.arange(n), width))
    put(tail_name)
    put(seqs)
    put(b"\n+\n")
    put(quals)
    put(b"\n")
    path.write_bytes(out.tobytes())


def _write_fastq(path: Path, prefix: bytes, reads) -> None:
    """FASTQ of ``(bases, qualities)`` reads of any length, one a record."""
    pieces = []
    for i, (seq, qual) in enumerate(reads):
        pieces += [b"@%s%d\n" % (prefix, i), seq.tobytes(), b"\n+\n",
                   qual.tobytes(), b"\n"]
    path.write_bytes(b"".join(pieces))


def _write_fasta(path: Path, name: bytes, seq: np.ndarray) -> None:
    """One record, the sequence in lines of 80 bases."""
    full = seq.size // _FASTA_LINE * _FASTA_LINE
    lines = np.empty((full // _FASTA_LINE, _FASTA_LINE + 1), dtype=np.uint8)
    lines[:, :-1] = seq[:full].reshape(-1, _FASTA_LINE)
    lines[:, -1] = ord("\n")
    with open(path, "wb") as f:
        f.write(b">" + name + b"\n")
        f.write(lines.tobytes())
        if full < seq.size:
            f.write(seq[full:].tobytes() + b"\n")


def _paired_reads(config: dict, traffic: dict, rng, outdir: Path) -> List[Input]:
    """Paired-end reads of one length from both strands of one genome,
    as an R1 and an R2 file."""
    genome = _bases(rng, config["genome_bp"], config["gc"])
    length = traffic["read_len"]
    pairs = math.ceil(traffic["coverage"] * config["genome_bp"] / (2 * length))
    ins = traffic["insert"]
    frag = np.clip(
        np.rint(rng.normal(ins["mean"], ins["sd"], pairs)),
        length, ins["max"],
    ).astype(np.int64)
    start = (rng.random(pairs) * (genome.size - frag + 1)).astype(np.int64)
    cols = np.arange(length)
    fwd = genome[start[:, None] + cols]
    back = _revcomp(genome[(start + frag - length)[:, None] + cols])
    flip = rng.random(pairs) < 0.5
    r1 = np.where(flip[:, None], back, fwd)
    r2 = np.where(flip[:, None], fwd, back)
    del fwd, back, genome
    paths = []
    for mate, reads in ((1, r1), (2, r2)):
        _mutate(rng, reads.reshape(-1), traffic)
        quals = _qualities(rng, reads, traffic["quality"])
        path = outdir / f"reads_R{mate}.fastq"
        _write_fixed_fastq(path, b"pair", b"/%d" % mate, reads, quals)
        paths.append(str(path))
    return [Input(paths=paths, seqs=[r1, r2], bases=int(r1.size + r2.size))]


def _long_reads(config: dict, traffic: dict, rng, outdir: Path) -> List[Input]:
    """Reads of lognormal lengths from both strands of one genome, one
    FASTQ file; their total is ``coverage`` times the genome."""
    genome = _bases(rng, config["genome_bp"], config["gc"])
    total = int(round(traffic["coverage"] * config["genome_bp"]))
    dist = traffic["length"]
    n = max(1, math.ceil(total / dist["mean"]))
    lengths = quantile_lengths(n, dist)
    # scale the set to the total, keeping every length inside its clip
    lengths = np.clip(
        np.floor(lengths * (total / lengths.sum())), dist["min"], dist["max"]
    ).astype(np.int64)
    short = total - int(lengths.sum())
    while short:
        step = 1 if short > 0 else -1
        room = dist["max"] - lengths if step > 0 else lengths - dist["min"]
        take = np.flatnonzero(room > 0)[:abs(short)]
        if not take.size:
            raise ValueError("coverage does not fit the clipped lengths")
        lengths[take] += step
        short -= step * take.size
    lengths = lengths[rng.permutation(n)]
    start = (rng.random(n) * (genome.size - lengths + 1)).astype(np.int64)
    flip = rng.random(n) < 0.5
    # the reads end to end, each followed by a newline
    ends = np.cumsum(lengths + 1) - 1
    joined = np.full(int(ends[-1]) + 1, ord("\n"), dtype=np.uint8)
    for s, ln, fl, e in zip(start, lengths, flip, ends):
        read = genome[s:s + ln]
        joined[e - ln:e] = _revcomp(read) if fl else read
    # errors are drawn over the joined bases, then cut back into reads
    body = joined != ord("\n")
    flat = joined[body]
    _mutate(rng, flat, traffic)
    joined[body] = flat
    quals = _qualities(rng, joined, traffic["quality"])
    path = outdir / "reads.fastq"
    _write_fastq(path, b"read", [
        (joined[e - ln:e], quals[e - ln:e]) for e, ln in zip(ends, lengths)
    ])
    return [Input(paths=[str(path)], seqs=[joined], bases=int(lengths.sum()))]


def _assemblies(config: dict, traffic: dict, rng, outdir: Path) -> List[Input]:
    """``count`` complete assemblies of lognormal sizes and GC shares
    spread evenly over a range, one single-record FASTA each, in an order
    drawn from the seed."""
    n = traffic["count"]
    sizes = quantile_lengths(n, traffic["size"])
    lo, hi = traffic["gc"]
    gcs = lo + (hi - lo) * (np.arange(n) + 0.5) / n
    order = rng.permutation(n)
    out = []
    for j, i in enumerate(order):
        seq = _bases(rng, int(sizes[i]), float(gcs[i]))
        path = outdir / f"genome_{j:04d}.fa"
        _write_fasta(path, b"genome_%d" % j, seq)
        out.append(Input(paths=[str(path)], seqs=[seq], bases=int(seq.size)))
    return out


KINDS = {
    "paired_reads": _paired_reads,
    "long_reads": _long_reads,
    "assemblies": _assemblies,
}


def generate(config: dict, traffic: dict, seed: int, outdir: Path) -> List[Input]:
    """The inputs of one cell for ``seed``, written under ``outdir``."""
    rng = np.random.default_rng([seed % (1 << 64), 0x6B6D6572])
    outdir.mkdir(parents=True, exist_ok=True)
    inputs = KINDS[traffic["kind"]](config, traffic, rng, outdir)
    # the files reach the disk now, in set-up, and not by writeback
    # inside the measured window
    os.sync()
    return inputs
