"""The drivers' default framing front: one native stream in the caller's
process, where a spawn pool used to start for every file.

The stream frames the records a pool frames, bit for bit (as multisets:
the batch boundaries and order differ); the drivers' answers agree on
both routes; the default route starts no process, while an explicit
``host_workers > 1`` and the decode-to-spill opt-in still take the pool;
and a parse error on the stream carries the pool's file-global line.
"""

import gzip
from collections import Counter

import numpy as np
import pytest
import torch

from needletail_tpu_torch.device import pipeline as tpipe
from needletail_tpu_torch.errors import ParseError
from needletail_tpu_torch.io import framing
from needletail_tpu_torch.parallel import distributed

ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in parallel worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reads(kind: str, seed: int):
    """HiFi-like reads of 1.5-6 kbp or 150 bp ones, a few holding N."""
    rng = np.random.default_rng(seed)
    lengths = (rng.integers(1500, 6000, 24) if kind == "hifi"
               else np.full(700, 150))
    out = []
    for i, n in enumerate(lengths):
        seq = ACGT[rng.integers(0, 4, int(n))]
        if i % 7 == 3:
            seq[rng.integers(0, n, 3)] = ord("N")
        out.append(seq.tobytes())
    return out


def _write(path, fmt: str, kind: str, seed: int, bad_record=None):
    """A FASTQ or FASTA file of ``_reads``; ``bad_record`` gets a quality
    line one byte short (a parse error on its record)."""
    lines = []
    for i, seq in enumerate(_reads(kind, seed)):
        if fmt == "fastq":
            qual = bytes(33 + (j * 7 + i) % 41 for j in range(len(seq)))
            if i == bad_record:
                qual = qual[:-1]
            lines += [b"@r%d" % i, seq, b"+", qual]
        else:
            # FASTA wraps its sequence lines at 80 columns
            lines += [b">r%d" % i] + [seq[j:j + 80]
                                      for j in range(0, len(seq), 80)]
    path.write_bytes(b"\n".join(lines) + b"\n")
    return str(path)


def _records(batches, packed: bool):
    """Each framed read as ``(length, its planes' bytes)``, as a multiset."""
    recs = Counter()
    for b in batches:
        if packed:
            unpacked = b.unpack_host()
            for i, n in enumerate(b.lengths.tolist()):
                recs[(n, b.codes[i, : n // 4].tobytes(),
                      unpacked[i, :n].tobytes())] += 1
        else:
            for i, n in enumerate(b.lengths.tolist()):
                qual = b.quals[i, :n].tobytes() if b.quals is not None else b""
                recs[(n, b.seqs[i, :n].tobytes(), qual)] += 1
    return recs


def _front(path, host_workers, packed, byte_range=None):
    batches, _ = framing._make_batch_source(
        path, 64, None, host_workers, with_quals=not packed, packed=packed,
        byte_range=byte_range,
    )
    return batches


SHAPES = (
    [("file", fmt, kind, packed) for fmt in ("fastq", "fasta")
     for kind in ("hifi", "short") for packed in (True, False)]
    + [("byte_range", fmt, "short", packed) for fmt in ("fastq", "fasta")
       for packed in (True, False)]
    + [("two_files", "fastq", "hifi", True),
       ("two_files", "fasta", "short", False)]
)


@pytest.mark.parametrize("shape,fmt,kind,packed", SHAPES)
def test_default_front_frames_the_pools_records(tmp_path, shape, fmt, kind,
                                                packed):
    path = _write(tmp_path / f"a.{fmt}", fmt, kind, 1)
    byte_range = None
    if shape == "byte_range":
        byte_range = framing.split_fastx_ranges(path, 3)[1]
    elif shape == "two_files":
        path = [path, _write(tmp_path / f"b.{fmt}", fmt, kind, 2)]
    framing.reset_framing_routes()
    stream = _records(_front(path, None, packed, byte_range), packed)
    assert framing.FRAMING_ROUTES == {
        "stream": 2 if shape == "two_files" else 1, "pool": 0}
    pool = _records(_front(path, 2, packed, byte_range), packed)
    assert framing.FRAMING_ROUTES["pool"] == (2 if shape == "two_files" else 1)
    assert stream == pool
    n = sum(stream.values())
    if shape == "byte_range":
        assert 0 < n < len(_reads(kind, 1))
    else:
        assert n == len(_reads(kind, 1)) * (2 if shape == "two_files" else 1)


@pytest.mark.parametrize("entry", ["count_file", "minimizer_spectrum_file"])
def test_drivers_agree_on_both_routes(tmp_path, entry):
    path = _write(tmp_path / "reads.fq", "fastq", "hifi", 3)
    if entry == "count_file":
        def run(hw):
            return tpipe.count_file(path, 21, batch_size=8, host_workers=hw,
                                    sparse_format="arrays", device="cpu")
    else:
        def run(hw):
            return tpipe.minimizer_spectrum_file(
                path, 19, 19, batch_size=8, host_workers=hw,
                sparse_format="arrays", device="cpu")
    n, (keys, counts) = run(None)
    pn, (pkeys, pcounts) = run(2)
    assert n == pn == sum(len(r) for r in _reads("hifi", 3))
    assert keys.size > 0
    np.testing.assert_array_equal(keys, pkeys)
    np.testing.assert_array_equal(counts, pcounts)


def _no_spawn(*args, **kwargs):
    raise AssertionError("the default framing front started a process")


@pytest.mark.parametrize("entry", ["count_file", "two_files", "hash_count_file",
                                   "minimizer_spectrum_file", "rank_source"])
def test_default_route_spawns_nothing(tmp_path, monkeypatch, entry):
    monkeypatch.setattr(framing.mp, "get_context", _no_spawn)
    path = _write(tmp_path / "reads.fq", "fastq", "short", 4)
    framing.reset_framing_routes()
    kw = dict(batch_size=64, device="cpu")
    if entry == "count_file":
        n = tpipe.count_file(path, 21, sparse_format="arrays", **kw)[0]
    elif entry == "two_files":
        other = _write(tmp_path / "more.fq", "fastq", "short", 5)
        n = tpipe.count_file([path, other], 21, sparse_format="arrays",
                             **kw)[0] - 700 * 150
    elif entry == "hash_count_file":
        n = tpipe.hash_count_file(path, 21, **kw)[0]
    elif entry == "minimizer_spectrum_file":
        n = tpipe.minimizer_spectrum_file(path, 21, 11, sparse_format="arrays",
                                          **kw)[0]
    else:
        # each rank of a world of two frames its byte range of the file
        parts = []
        for rank in (0, 1):
            monkeypatch.setattr(distributed, "data_rank",
                                lambda mesh, rank=rank: (2, rank))
            batches = distributed.rank_batch_source(
                path, None, 64, None, None, None, True, True)
            parts.append(sum(b.num_bases for b in batches))
        assert min(parts) > 0
        n = sum(parts)
    assert n == 700 * 150
    assert framing.FRAMING_ROUTES == {
        "stream": 1 if entry in ("count_file", "hash_count_file",
                                 "minimizer_spectrum_file") else 2,
        "pool": 0}


@pytest.mark.parametrize("opt_in", ["host_workers", "gz_host_workers",
                                    "gz_spill_dir"])
def test_explicit_pool_still_spawns(tmp_path, monkeypatch, opt_in):
    # a pool sized without an explicit host_workers stays small here
    monkeypatch.setattr(framing, "auto_host_workers", lambda: 3)
    path = _write(tmp_path / "reads.fq", "fastq", "short", 6)
    kw = {"host_workers": 2}
    if opt_in.startswith("gz"):
        gz = tmp_path / "reads.fq.gz"
        gz.write_bytes(gzip.compress((tmp_path / "reads.fq").read_bytes()))
        path = str(gz)
        if opt_in == "gz_spill_dir":
            kw = {"host_workers": None, "spill_dir": str(tmp_path)}
    framing.reset_framing_routes()
    batches, workers = framing._make_batch_source(
        path, 64, None, with_quals=False, packed=True, **kw)
    assert sum(b.num_bases for b in batches) == 700 * 150
    assert framing.FRAMING_ROUTES == {"stream": 0, "pool": 1}
    assert workers == (kw["host_workers"] or 3)


@pytest.mark.parametrize("ranged", [False, True])
def test_parse_error_line_matches_the_pools(tmp_path, ranged):
    # record 600 of 700 starts on line 2401 and lies in the last third
    path = _write(tmp_path / "bad.fq", "fastq", "short", 7, bad_record=600)
    byte_range = framing.split_fastx_ranges(path, 3)[2] if ranged else None

    def error(host_workers):
        with pytest.raises(ParseError) as info:
            for _ in _front(path, host_workers, True, byte_range):
                pass
        return info.value

    stream, pool = error(None), error(2)
    assert stream.position.line == pool.position.line == 4 * 600 + 1
    assert stream.msg == pool.msg
