"""The port's ``parallel.distributed`` against the JAX package's: record-
aligned byte ranges, the world-above-one refusals, the dryrun, and the
``--sharded`` commands.

Gloo worlds of 2 and 4 run ``tests/_torch_dist_worker.py``'s
``distributed`` suite (no JAX in their processes); the command line runs
a world of one in this process.
"""

import contextlib
import io

import pytest
import torch

import _torch_dist_worker as W
from needletail_tpu.parallel.distributed import (
    read_range as j_read_range,
    split_fastx_ranges as j_split_fastx_ranges,
)
from needletail_tpu.parser import parse_fastx_file
from needletail_tpu_torch import cli
from needletail_tpu_torch.parallel.distributed import (
    read_range,
    split_fastx_ranges,
)

WORLDS = W.Worlds.WORLDS
# newer torches name reduce_scatter_tensor reduce_scatter_single
pytestmark = pytest.mark.filterwarnings(
    "ignore:.*reduce_scatter_tensor:FutureWarning")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread, as each spawned rank runs: the test workers
    share the cores, and more threads only contend for them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    spawned = W.Worlds("distributed", tmp_path_factory.mktemp)
    yield spawned
    spawned.close()


def _records(reader):
    out = []
    while (rec := reader.next()) is not None:
        out.append((bytes(rec.id()), bytes(rec.seq()), bytes(rec.qual() or b"")))
    return out


def _by_ranges(path, ranges):
    got = []
    for start, end in ranges:
        if start != end:
            got.extend(_records(read_range(path, start, end)))
    return got


def _check_ranges(path, n):
    whole = _records(parse_fastx_file(str(path)))
    ranges = split_fastx_ranges(path, n)
    assert ranges == j_split_fastx_ranges(path, n)
    assert ranges[0][0] == 0 and ranges[-1][1] == path.stat().st_size
    for (_, e0), (s1, _) in zip(ranges, ranges[1:]):
        assert e0 == s1
    assert _by_ranges(path, ranges) == whole
    for start, end in ranges:
        if start != end:
            assert _records(read_range(path, start, end)) == _records(
                j_read_range(path, start, end)
            )


@pytest.mark.parametrize("n", [1, 2, 3, 4, 7])
def test_fastq_ranges_cover_all_records(data_dir, n):
    _check_ranges(data_dir / "PRJNA271013_head.fq", n)


@pytest.mark.parametrize("n", [2, 3])
def test_fasta_ranges(data_dir, n):
    _check_ranges(data_dir / "28S.fasta", n)


def test_quality_lines_with_at_signs(tmp_path):
    """'@' opening a quality line is no record start."""
    p = tmp_path / "at.fq"
    p.write_bytes(b"".join(b"@r%d\nACGTACGT\n+\n@@@@@@@@\n" % i for i in range(50)))
    _check_ranges(p, 4)


def test_more_ranges_than_records(tmp_path):
    p = tmp_path / "two.fq"
    p.write_bytes(b"@a\nAC\n+\nII\n@b\nGT\n+\n!!\n")
    assert [r[0] for r in _by_ranges(p, split_fastx_ranges(p, 8))] == [b"a", b"b"]


@pytest.mark.parametrize("n", [2, 3])
def test_a_range_splits_into_its_own_ranges(data_dir, n):
    """A rank's range splits again for its framing workers: disjoint,
    covering it, record-aligned."""
    path = data_dir / "PRJNA271013_head.fq"
    outer = split_fastx_ranges(path, 3)[1]
    inner = split_fastx_ranges(path, n, byte_range=outer)
    assert inner[0][0] == outer[0] and inner[-1][1] == outer[1]
    assert _by_ranges(path, inner) == _by_ranges(path, [outer])


@pytest.mark.parametrize("case", [
    "hash_compressed", "hash_checkpoint", "exact_compressed", "exact_resume",
    "multik_compressed", "minimizers_checkpoint",
])
@pytest.mark.parametrize("world", WORLDS)
def test_world_above_one_refusals(worlds, world, case):
    """Raised on every rank before any collective: the run then passed the
    barrier that follows and ended."""
    why = "checkpoint" if case.endswith(("checkpoint", "resume")) else "byte range"
    for r in worlds.get(world):
        assert bool(r["jax_free"])
        message = str(r[f"refuse_{case}"])
        assert why in message and f"{world} data ranks" in message, message


@pytest.mark.parametrize("world", WORLDS)
def test_host_shard_ranges(worlds, world):
    ranges = j_split_fastx_ranges(W.FQ, world)
    for rank, r in enumerate(worlds.get(world)):
        assert tuple(r["ranges"]) == ranges[rank]


def test_dryrun(worlds):
    """The dryrun in a gloo world of 2 (``chip_smoke.py`` runs it on a
    NCCL world of one)."""
    for r in worlds.get(2):
        line = str(r["dryrun"])
        assert line.startswith("dryrun OK: world 2"), line
        assert "BGZF mid-stream resume" in line


def _cli(*argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        assert cli.main(list(argv)) == 0
    summary = [line for line in err.getvalue().splitlines() if line.startswith("#")]
    return out.getvalue(), summary


@pytest.mark.parametrize("argv", [
    ("count", W.FA_28S, "-k", "31", "--top", "3"),
    ("count", W.FQ, "-k", "4,21,31", "--top", "1"),
    ("minimizers", W.FQ, "-k", "21", "-w", "11", "--top", "1"),
    # tiles of 1,024 bases: the records are ~1.3 kbp, so the default
    # 8,192 would pad six lanes in seven (the spectrum is the same)
    ("spectrum", W.FA_28S, "-k", "31", "--top", "1", "--tile-len", "1024"),
], ids=["count", "multi-k", "minimizers", "spectrum"])
def test_sharded_commands_print_the_flat_output(argv):
    extra = ("--device", "cpu") + (
        ("--host-workers", "1") if argv[0] == "count" else ()
    )
    flat = _cli(*argv, *extra)
    assert flat[1], "the flat command printed no summary"
    assert _cli(*argv, *extra, "--sharded") == flat
    if argv[2:4] == ("-k", "31") and argv[0] == "count":
        assert flat[1] == [
            "# 738580 bases, 718007 canonical 31-mers, 283237 distinct"
        ]
        assert flat[0].startswith("ATAGGGTGAAGCCAGAGGAAACTCTGGTGGA\t366\n")


def test_sharded_count_refuses_profile():
    with pytest.raises(SystemExit, match="drop --sharded"):
        cli.main(["count", W.FQ, "-k", "21", "--sharded", "--profile",
                  "--device", "cpu"])
