"""The plain (w, k) minimizer spectrum that decides ``correct``.

NumPy only, like the k-mer spectrum beside it (``spectrum.py``, whose
window packing it shares), written from the definition and from nothing
of the program: a base is A, C, G or T in either case (codes 0-3), every
other byte breaks the windows that hold it; a k-window packs its bases
first base most significant, and its canonical key is the smaller of it
and its reverse complement.  Sketch position p of a read covers the
k-windows starting at p .. p+w-1; it is valid when all w are, and its key
is the smallest of their keys.  The spectrum is every distinct key of
every valid position with the number of positions that hold it, keys
ascending.  No window and no position spans two reads.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Tuple

import numpy as np

from .spectrum import _ladder, _stream, _valid

__all__ = [
    "sketch_keys", "valid_positions", "run_positions", "spectrum", "answer",
]

# sketch positions a block of the flat stream: its uint64 temporaries stay
# tens of MB, so a 139 Mbp input fits the host many times over
_BLOCK = 1 << 20


def _blocks(codes: np.ndarray, span: int):
    """Slices of a code stream, each overlapping the next by ``span - 1``
    bases, whose ``span``-base stretches are each stretch of the stream
    once."""
    for start in range(0, max(codes.size - span + 1, 0), _BLOCK):
        yield codes[start:start + _BLOCK + span - 1]


def sketch_keys(rows: np.ndarray, k: int, w: int) -> Tuple[np.ndarray, np.ndarray]:
    """``(keys uint64 ascending, counts int64)`` of the valid sketch
    positions of ASCII ``rows`` (``[n, L]`` uint8, or one sequence as
    ``[L]`` in which any other byte, such as a newline, separates reads)."""
    if not 1 <= k <= 31:
        raise ValueError(f"k must be in [1, 31], got {k}")
    if w < 1:
        raise ValueError(f"w must be >= 1, got {w}")
    keys: List[np.ndarray] = [np.zeros(0, np.uint64)]
    counts: List[np.ndarray] = [np.zeros(0, np.int64)]
    for codes in _blocks(_stream(rows), k + w - 1):
        clean = codes & 3
        canon = np.minimum(_ladder(clean, k, reverse=False),
                           _ladder(3 - clean, k, reverse=True))
        n = canon.size - w + 1
        smallest = canon[:n].copy()
        for j in range(1, w):  # position p: the windows p .. p+w-1
            np.minimum(smallest, canon[j:j + n], out=smallest)
        part, held = np.unique(smallest[_valid(codes, k + w - 1)],
                               return_counts=True)
        keys.append(part)
        counts.append(held.astype(np.int64))
    return _sum_equal(np.concatenate(keys), np.concatenate(counts))


def _sum_equal(keys: np.ndarray, counts: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Each distinct key once, ascending, with the sum of its counts."""
    if not keys.size:
        return keys, counts
    order = np.argsort(keys, kind="stable")
    keys, counts = keys[order], counts[order]
    head = np.empty(keys.size, dtype=bool)
    head[0] = True
    np.not_equal(keys[1:], keys[:-1], out=head[1:])
    starts = np.flatnonzero(head)
    return keys[starts], np.add.reduceat(counts, starts)


def valid_positions(seqs: Iterable[np.ndarray], k: int, w: int) -> int:
    """Number of valid sketch positions of every sequence of ``seqs``: the
    stretches of ``k + w - 1`` bases that hold no other byte."""
    span = k + w - 1
    return sum(
        int(_valid(c, span).sum())
        for s in seqs for c in _blocks(_stream(s), span)
    )


def run_positions(run) -> int:
    """Valid sketch positions of a benchmark run's jobs at its
    configuration's ``k`` and ``w``, counted from the generated input (as
    the metric readers count them), each input's count kept on it."""
    opts = run.cell.config["options"]
    k, w = int(opts["k"]), int(opts["w"])
    total = 0
    for job in run.jobs:
        inp = run.inputs[job.input]
        key = f"sketch{k},{w}"
        if key not in inp.windows:
            inp.windows[key] = valid_positions(inp.seqs, k, w)
        total += inp.windows[key]
    return total


def spectrum(
    seqs: Iterable[np.ndarray], k: int, w: int
) -> Tuple[np.ndarray, np.ndarray]:
    """``(keys uint64 ascending, counts int64)`` over every valid sketch
    position of every sequence; each item of ``seqs`` is as
    :func:`sketch_keys` takes it."""
    parts = [sketch_keys(s, k, w) for s in seqs]
    if not parts:
        return np.zeros(0, np.uint64), np.zeros(0, np.int64)
    return _sum_equal(np.concatenate([p[0] for p in parts]),
                      np.concatenate([p[1] for p in parts]))


def answer(inp, options: Dict) -> Tuple[int, Tuple[np.ndarray, np.ndarray]]:
    """The answer ``minimizer_spectrum_file`` owes for one generated input
    under the configuration's ``options`` (``k``, ``w``): ``(bases, (keys,
    counts))``, as it returns it with ``sparse_format="arrays"``;
    ``spectrum.compare`` compares the two."""
    k, w = int(options["k"]), int(options["w"])
    return inp.bases, spectrum(inp.seqs, k, w)
