"""The sketch kernel's arithmetic, the minimizer driver and the benchmark's
plain minimizer reference.

``csrc/minimizer_sketch.cu`` runs only on the card, so its arithmetic is
modelled here in numpy (tiles of positions, each staged with its halo as
key + 1 or 0, van Herk / Gil-Werman blocks of w from the tile's first
lane; past its shared-memory tile, the same blocks cut from each row's
first lane with their minima kept whole) and held bit for bit against
the kernel's plain version, the ladder of
``minimizers.window_minimizers_from_planes`` masked by
``count.mask_keys``.  ``minimizer_spectrum_file`` on the CPU is held
against ``portbench/reference/minimizers.py``, and that reference against
the JAX package's ``minimizer_spectrum_file``.  Integer code: tolerance
0, invalid positions included.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from needletail_tpu.device import pipeline as jpipe
from needletail_tpu_torch.device import kernels as tk
from needletail_tpu_torch.device.pipeline import minimizer_spectrum_file
from needletail_tpu_torch.utils.profiling import ThroughputMeter
from needletail_tpu_torch.utils.synth import random_reads

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.reference import minimizers as ref  # noqa: E402
from portbench.reference.spectrum import compare  # noqa: E402

FQ = ROOT / "tests" / "data" / "PRJNA271013_head.fq"
_NONE = np.uint64(0xFFFFFFFFFFFFFFFF)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in parallel worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def planes():
    """Key planes of seeded reads with N bases, rows of every length up to
    200 (some shorter than k + w - 1), at each k of the tests."""
    rng = np.random.default_rng(1601)
    seqs, lengths = random_reads(rng, 48, 200, dirty_frac=0.4)
    s, ln = torch.from_numpy(seqs), torch.from_numpy(lengths)
    return {k: tk.canonical_key_planes_plain(s, ln, k)[:2] for k in (15, 19, 31)}


def _staged(khi, klo):
    """The planes as the kernel stages them: key + 1, or 0 where invalid."""
    hi = khi.numpy().astype(np.int64)
    lo = klo.numpy().view(np.uint32).astype(np.uint64)
    return np.where(
        hi == -1, np.uint64(0),
        ((hi.astype(np.uint64) << np.uint64(32)) | lo) + np.uint64(1),
    )


def _block_minima(staged, w: int):
    """Prefix and suffix minima within blocks of w lanes from lane 0."""
    rows, n = staged.shape
    blocks = np.full((rows, -(-n // w) * w), _NONE)
    blocks[:, :n] = staged
    blocks = blocks.reshape(rows, -1, w)
    prefix = np.minimum.accumulate(blocks, axis=2).reshape(rows, -1)
    suffix = np.minimum.accumulate(blocks[:, :, ::-1], axis=2)[:, :, ::-1]
    return prefix, suffix.reshape(rows, -1)


def _written(out):
    """The flat (hi, lo) int32 planes the kernel writes from the minima."""
    out = out.reshape(-1)
    key = out - np.uint64(1)
    invalid = out == 0
    hi_o = np.where(invalid, -1, (key >> np.uint64(32)).astype(np.int64))
    lo_o = np.where(invalid, np.uint32(0xFFFFFFFF),
                    (key & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    return hi_o.astype(np.int32), lo_o.view(np.int32)


def kernel_model(khi, klo, k: int, w: int, tile: int):
    """The kernel's arithmetic at w up to its shared-memory tile: the flat
    (hi, lo) int32 planes it writes."""
    staged = _staged(khi, klo)
    rows, lanes = staged.shape
    positions = lanes - k - w + 2
    out = np.empty((rows, positions), np.uint64)
    for p0 in range(0, positions, tile):
        n = min(tile, positions - p0)
        prefix, suffix = _block_minima(staged[:, p0:p0 + n + w - 1], w)
        out[:, p0:p0 + n] = np.minimum(suffix[:, :n], prefix[:, w - 1:w - 1 + n])
    return _written(out)


def block_minima_model(khi, klo, k: int, w: int):
    """The kernel's arithmetic past its shared-memory tile: the minima of
    every row's blocks in device memory, then a position's from two."""
    staged = _staged(khi, klo)[:, :khi.shape[1] - k + 1]
    positions = staged.shape[1] - w + 1
    prefix, suffix = _block_minima(staged, w)
    return _written(np.minimum(suffix[:, :positions],
                               prefix[:, w - 1:w - 1 + positions]))


def _equal_to_the_ladder(got_hi, got_lo, khi, klo, k, w):
    want_hi, want_lo = tk.minimizer_sketch_plain(khi, klo, k, w)
    np.testing.assert_array_equal(got_lo, want_lo.numpy())
    if k <= 15:
        assert want_hi is None
    else:
        np.testing.assert_array_equal(got_hi, want_hi.numpy())
    return want_lo.numpy() != -1


@pytest.mark.parametrize("tile", [2048, 16])
@pytest.mark.parametrize("w", [1, 11, 19])
@pytest.mark.parametrize("k", [15, 19, 31])
def test_kernel_model_matches_the_ladder(planes, k, w, tile):
    """At the kernel's tile and at one smaller than w, so that halos cross
    tiles and a position's windows span two blocks."""
    khi, klo = planes[k]
    got_hi, got_lo = kernel_model(khi, klo, k, w, tile)
    valid = _equal_to_the_ladder(got_hi, got_lo, khi, klo, k, w)
    assert valid.any() and not valid.all()
    if k > 16:
        # keys whose lo reads negative as int32 win positions
        assert (got_lo[valid] < 0).any()


@pytest.mark.parametrize("w", [1, 11, 19, 64])
@pytest.mark.parametrize("k", [15, 19, 31])
def test_block_minima_model_matches_the_ladder(planes, k, w):
    """The route past the tile, at every w: its blocks start at each row's
    first lane, not at a tile's."""
    khi, klo = planes[k]
    valid = _equal_to_the_ladder(*block_minima_model(khi, klo, k, w),
                                 khi, klo, k, w)
    assert valid.any() and not valid.all()


def test_sketch_wrapper_on_the_cpu_is_its_plain_version(planes):
    khi, klo = planes[19]
    got = tk.minimizer_sketch(khi, klo, 19, 19)
    want = tk.minimizer_sketch_plain(khi, klo, 19, 19)
    assert got[1].numel() == 48 * (200 - 19 - 19 + 2)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert tk.LAUNCHES["minimizer_sketch"] == 0
    with pytest.raises(ValueError, match="w must be >= 1"):
        tk.minimizer_sketch(khi, klo, 19, 0)
    with pytest.raises(ValueError, match="shorter than w"):
        tk.minimizer_sketch(khi, klo, 19, 190)
    with pytest.raises(ValueError, match="differ"):
        tk.minimizer_sketch(khi, klo[:, :-1], 19, 19)
    with pytest.raises(TypeError, match="int32"):
        tk.minimizer_sketch(khi.long(), klo, 19, 19)


def _write_reads(path: Path, seed: int):
    """A FASTQ of seeded reads of 0-400 bases (some with N or in lower
    case) and the same bases as one newline-separated stream."""
    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(b"ACGTACGTACGTacgtN", np.uint8)
    reads = []
    for i in range(90):
        n = int(rng.integers(0, 401))
        top = alphabet.size if i % 4 == 0 else 4
        reads.append(alphabet[rng.integers(0, top, n)].tobytes())
    with open(path, "wb") as f:
        for i, r in enumerate(reads):
            f.write(b"@r%d\n%s\n+\n%s\n" % (i, r, b"I" * len(r)))
    joined = np.frombuffer(b"\n".join(reads), np.uint8)
    return sum(map(len, reads)), joined


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("k, w", [(19, 19), (21, 11)])
def test_driver_matches_the_reference(tmp_path, k, w, packed):
    path = tmp_path / "reads.fq"
    bases, joined = _write_reads(path, 1602 + k)
    meter = ThroughputMeter()
    got = minimizer_spectrum_file(str(path), k, w, packed=packed,
                                  batch_size=32, host_workers=1,
                                  device="cpu", meter=meter)
    want = (bases, ref.spectrum([joined], k, w))
    assert compare(got, want) == {"bases_off": 0, "keys_off": 0}
    assert want[1][0].size > 100
    stages = meter.as_dict()
    # the sketch's lanes, padding included, hold every valid position
    positions = ref.valid_positions([joined], k, w)
    assert int(want[1][1].sum()) == positions
    assert stages["sketch"]["items"] > positions
    assert stages["flush.resolve"]["items"] >= stages["sketch"]["items"]


@pytest.mark.parametrize("k, w", [(19, 19), (21, 11)])
def test_reference_matches_jax(k, w):
    reads = FQ.read_bytes().split(b"\n")[1::4]
    joined = np.frombuffer(b"\n".join(reads), np.uint8)
    want = jpipe.minimizer_spectrum_file(str(FQ), k, w, batch_size=512,
                                         max_len=128, host_workers=1)
    got = (sum(map(len, reads)), ref.spectrum([joined], k, w))
    assert compare(got, want) == {"bases_off": 0, "keys_off": 0}
    assert got[1][0].size > 1000


def test_reference_blocks_count_each_position_once(monkeypatch):
    """Blocks smaller than a read: each position is counted once across
    the overlaps."""
    rng = np.random.default_rng(1603)
    seq = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, 5000)].copy()
    seq[1234] = ord("N")
    whole = ref.sketch_keys(seq, 19, 19)
    monkeypatch.setattr(ref, "_BLOCK", 97)
    for a, b in zip(ref.sketch_keys(seq, 19, 19), whole):
        np.testing.assert_array_equal(a, b)
    # 37-base stretches: 4,964 positions, 37 of them over the N
    assert ref.valid_positions([seq], 19, 19) == int(whole[1].sum()) == 4927
