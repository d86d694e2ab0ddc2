"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and skips without one.  The module
imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -q -m cuda tests/test_torch_cuda.py

(``--noconftest`` because ``tests/conftest.py`` imports JAX).  The path is
all integer, so the tolerance is 0.
"""

import numpy as np
import pytest
import torch

from needletail_tpu_torch.device import kernels as tk
from needletail_tpu_torch.device.ops import resolve_vbits, unwire
from needletail_tpu_torch.utils.synth import (
    odd_offset_view, packed_batch, packed_rows, random_reads,
)

pytestmark = pytest.mark.cuda

KS = [1, 5, 16, 17, 21, 31]
FQ = "tests/data/PRJNA271013_head.fq"
GOLD = (250_000, 209_965, 106_181)  # bases, windows, forward at k=21


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the CUDA kernels run only on the card")
    return torch.device("cuda")


def test_cuda_kernels_match_plain(cuda_device):
    """ASCII mode at a width beyond the TPU kernel's VMEM limit."""
    rng = np.random.default_rng(31)
    seqs, lengths = random_reads(rng, 64, 40_000, dirty_frac=0.3)
    s = torch.from_numpy(seqs).to(cuda_device)
    ln = torch.from_numpy(lengths).to(cuda_device)
    for k in KS:
        for normalized in (True, False):
            got = tk.canonical_hash_keys(s, ln, k, 16, normalized)
            want = tk.canonical_hash_keys_plain(s, ln, k, 16, normalized)
            for a, b in zip(got, want):
                assert torch.equal(a, b)
        assert int(tk.mxu_histogram16(got[0]).sum()) == int(got[1])
        assert torch.equal(
            tk.mxu_histogram16(got[0]), tk.histogram16_plain(got[0])
        )


@pytest.mark.parametrize("vmode", [0, 1, 2])
def test_cuda_packed_hash_keys_match_plain(cuda_device, vmode):
    rng = np.random.default_rng(40 + vmode)
    dirty = {0: 0.0, 1: 1.0, 2: 0.05}[vmode]
    seqs, lengths = random_reads(rng, 256, 152, dirty_frac=dirty)
    batch = packed_batch(seqs, lengths, vmode)
    buf, layout = batch.wire_frame(256)
    codes, ln, vbits, vrow_idx, vrows = unwire(
        torch.from_numpy(buf).to(cuda_device), layout
    )
    vb = resolve_vbits(vbits, vrow_idx, vrows, 256)
    for k in KS:
        got = tk.canonical_hash_keys_packed(codes, vb, ln, k, 16)
        want = tk.canonical_hash_keys_packed_plain(codes, vb, ln, k, 16)
        for a, b in zip(got, want):
            assert torch.equal(a, b)


def test_cuda_histogram_weighted_matches_plain(cuda_device):
    rng = np.random.default_rng(9)
    keys = torch.from_numpy(
        rng.integers(-1, 1 << 20, (512, 1000), dtype=np.int64).astype(np.int32)
    ).to(cuda_device)
    weight = torch.from_numpy(
        rng.integers(-1, 2, (512, 1000), dtype=np.int32)
    ).to(cuda_device)
    assert torch.equal(
        tk.mxu_histogram16(keys, weight), tk.histogram16_plain(keys, weight)
    )


def test_cuda_hash_count_file_reaches_goldens(cuda_device):
    from needletail_tpu_torch.device.pipeline import hash_count_file

    tk.reset_launches()
    got = hash_count_file(
        FQ, 21, batch_size=512, max_len=128, host_workers=1, device="cuda"
    )
    assert tk.LAUNCHES["hash_keys"] > 0 and tk.LAUNCHES["histogram16"] > 0
    want = hash_count_file(
        FQ, 21, batch_size=512, max_len=128, host_workers=1, device="cpu"
    )
    assert got[:3] == want[:3] == GOLD
    np.testing.assert_array_equal(got[3], want[3])


@pytest.mark.parametrize("vmode", [None, 0, 1, 2])
def test_cuda_key_planes_match_plain(cuda_device, vmode):
    """The planes mode of the window kernel, ASCII (vmode None) and packed
    in each validity shape, at a width that is no multiple of the block."""
    rng = np.random.default_rng(50 + (vmode or 0))
    dirty = {None: 0.5, 0: 0.0, 1: 1.0, 2: 0.05}[vmode]
    seqs, lengths = random_reads(rng, 256, 152, dirty_frac=dirty)
    for k in KS:
        if vmode is None:
            s = torch.from_numpy(seqs).to(cuda_device)
            ln = torch.from_numpy(lengths).to(cuda_device)
            for normalized in (True, False):
                got = tk.canonical_key_planes(s, ln, k, normalized)
                want = tk.canonical_key_planes_plain(s, ln, k, normalized)
                for a, b in zip(got, want):
                    assert torch.equal(a, b)
            continue
        buf, layout = packed_batch(seqs, lengths, vmode).wire_frame(256)
        codes, ln, vbits, vrow_idx, vrows = unwire(
            torch.from_numpy(buf).to(cuda_device), layout
        )
        vb = resolve_vbits(vbits, vrow_idx, vrows, 256)
        got = tk.canonical_key_planes_packed(codes, vb, ln, k)
        want = tk.canonical_key_planes_packed_plain(codes, vb, ln, k)
        for a, b in zip(got, want):
            assert torch.equal(a, b)


@pytest.mark.parametrize("wide", [True, False])
@pytest.mark.parametrize("n", [100, 8192, 100_003])
def test_cuda_compact_slots_match_plain(cuda_device, wide, n):
    """Random flags with an overflowing chunk, and the sorted runs of
    ``unique_counts``, wide and narrow, at ragged lengths."""
    from needletail_tpu_torch.device import count as tc

    rng = np.random.default_rng(n)
    planes = rng.integers(-(1 << 31), 1 << 31, (2, n), dtype=np.int64)
    hi, lo = torch.from_numpy(planes.astype(np.int32)).to(cuda_device)
    counts = np.where(rng.random(n) < 0.1, rng.integers(1, 9, n), 0)
    overflow = n >= 300
    if overflow:
        counts[:300] = 1  # more flags than slots in the first chunk
    c = torch.from_numpy(counts.astype(np.int32)).to(cuda_device)
    keys = torch.from_numpy(rng.integers(0, n // 4 + 1, n).astype(np.int32))
    runs = tc.unique_counts(
        keys.to(cuda_device) if wide else None, keys.flip(0).to(cuda_device)
    )
    for args in ((hi if wide else None, lo, c), runs):
        got = tk.mxu_compact_slots(*args)
        want = tk.compact_slots_plain(*args)
        for a, b in zip(got, want):
            assert (a is None and b is None) or torch.equal(a, b)
    ok = bool(tk.mxu_compact_slots(hi if wide else None, lo, c)[3])
    assert ok is not overflow


def test_cuda_count_file_matches_plain(cuda_device, tmp_path):
    """``count_file`` through both new kernels, over the corpus written 8
    times: every run is then at least 8 lanes long, so no 1024-lane chunk
    holds more than 128 run heads and the cascade's first pass holds."""
    from pathlib import Path

    from needletail_tpu_torch.device import count as tc
    from needletail_tpu_torch.device.pipeline import count_file

    copies = tmp_path / "x8.fq"
    copies.write_bytes(Path(FQ).read_bytes() * 8)
    kw = dict(batch_size=4096, max_len=128, host_workers=1,
              sparse_format="arrays")
    tk.reset_launches()
    tc.reset_flush_routes()
    got = count_file(str(copies), 21, device="cuda", **kw)
    assert tk.LAUNCHES["key_planes"] > 0 and tk.LAUNCHES["compact_slots"] > 0
    assert tc.FLUSH_ROUTES == {r: int(r == "cascade") for r in tc.FLUSH_ROUTES}
    want = count_file(FQ, 21, device="cpu", **kw)
    assert got[0] == 8 * want[0] == 8 * GOLD[0]
    np.testing.assert_array_equal(got[1][0], want[1][0])
    np.testing.assert_array_equal(got[1][1], 8 * want[1][1])
    assert int(got[1][1].sum()) == 8 * GOLD[1]


def test_cuda_hash_tally_matches_plain(cuda_device):
    """The tally mode of the window kernel, at a width that is no multiple
    of the block and one beyond the TPU kernel's VMEM limit."""
    rng = np.random.default_rng(60)
    for rows, width in ((256, 152), (16, 40_000)):
        seqs, lengths = random_reads(rng, rows, width, dirty_frac=0.5)
        s = torch.from_numpy(seqs).to(cuda_device)
        ln = torch.from_numpy(lengths).to(cuda_device)
        for k in KS:
            for normalized in (True, False):
                got = tk.canonical_hash_tally(s, ln, k, 16, normalized)
                want = tk.canonical_hash_tally_plain(s, ln, k, 16, normalized)
                for a, b in zip(got, want):
                    assert torch.equal(a, b)
                # the weighted histogram counts what the keys route counts
                keys = tk.canonical_hash_keys(s, ln, k, 16, normalized)[0]
                assert torch.equal(
                    tk.mxu_histogram16(got[0], got[1]),
                    tk.mxu_histogram16(keys),
                )


@pytest.mark.parametrize("block", [128, 1024, 1 << 14, 1 << 15, 1 << 16, 1 << 17])
def test_cuda_block_sort_matches_plain(cuda_device, block):
    """Spans that fit one CTA's shared memory (up to 2^15 lanes) and spans
    that also take passes over device memory; random keys, keys with the
    top bit set, and all-equal keys."""
    rng = np.random.default_rng(block)
    keys = rng.integers(0, 1 << 32, 1 << 18, dtype=np.uint32)
    for plane in (keys, keys | np.uint32(1 << 31), np.full_like(keys, 7)):
        x = torch.from_numpy(plane.view(np.int32)).to(cuda_device)
        got = tk.bitonic_block_sort(x, block)
        assert torch.equal(got, tk.block_sort_plain(x, block))
        want = np.sort(plane.reshape(-1, block), axis=1).reshape(-1)
        np.testing.assert_array_equal(got.cpu().numpy().view(np.uint32), want)


def test_cuda_genome_spectrum_matches_plain(cuda_device, tmp_path):
    """``genome_spectrum`` through the key-plane kernel (packed and ASCII
    tiles, arrays and the device flush) and k=7 dense through the
    histogram kernel, on a genome with ambiguous bases."""
    from needletail_tpu_torch.device.tiling import genome_spectrum

    rng = np.random.default_rng(61)
    genome = rng.choice(np.frombuffer(b"ACGTN", np.uint8), 60_000,
                        p=[0.24, 0.24, 0.24, 0.24, 0.04]).tobytes()
    fa = tmp_path / "g.fa"
    fa.write_bytes(b">g\n" + genome + b"\n")
    kw = dict(tile_len=2048, batch_tiles=8)
    for packed in (True, False):
        tk.reset_launches()
        got = genome_spectrum(str(fa), 31, sparse_format="arrays",
                              packed=packed, device="cuda", **kw)
        assert tk.LAUNCHES["key_planes"] > 0
        want = genome_spectrum(str(fa), 31, sparse_format="arrays",
                               packed=packed, device="cpu", **kw)
        assert got[0] == want[0] == 60_000
        for a, b in zip(got[1], want[1]):
            np.testing.assert_array_equal(a, b)
    n, (hi_s, lo_s, counts) = genome_spectrum(
        str(fa), 31, sparse_format="device", device="cuda", **kw
    )
    assert counts.is_cuda and int((counts > 0).sum()) == len(want[1][0])
    tk.reset_launches()
    got = genome_spectrum(str(fa), 7, device="cuda", **kw)
    assert tk.LAUNCHES["histogram16"] > 0
    np.testing.assert_array_equal(
        got[1], genome_spectrum(str(fa), 7, device="cpu", **kw)[1]
    )


def test_cuda_multi_k_matches_plain(cuda_device, tmp_path):
    """``multi_k_count_file`` over the corpus written 8 times (so the
    cascade holds), k=4 dense through the histogram kernel and k=21, 31
    through the key-plane kernel."""
    from pathlib import Path

    from needletail_tpu_torch.device.pipeline import multi_k_count_file

    copies = tmp_path / "x8.fq"
    copies.write_bytes(Path(FQ).read_bytes() * 8)
    kw = dict(batch_size=4096, max_len=128, host_workers=1)
    tk.reset_launches()
    got = multi_k_count_file(str(copies), (4, 21, 31), device="cuda", **kw)
    assert tk.LAUNCHES["histogram16"] > 0 and tk.LAUNCHES["key_planes"] > 0
    want = multi_k_count_file(FQ, (4, 21, 31), device="cpu", **kw)
    assert got[0] == 8 * want[0]
    np.testing.assert_array_equal(got[1][4], 8 * want[1][4])
    for k in (21, 31):
        np.testing.assert_array_equal(got[1][k][0], want[1][k][0])
        np.testing.assert_array_equal(got[1][k][1], 8 * want[1][k][1])


def _assert_window_modes(packed, args, k, normalized=True):
    """Keys, planes and (ASCII only) tally of one input equal to their
    plain versions."""
    if packed:
        pairs = (
            (tk.canonical_hash_keys_packed, tk.canonical_hash_keys_packed_plain,
             (*args, k, 16)),
            (tk.canonical_key_planes_packed,
             tk.canonical_key_planes_packed_plain, (*args, k)),
        )
    else:
        pairs = (
            (tk.canonical_hash_keys, tk.canonical_hash_keys_plain,
             (*args, k, 16, normalized)),
            (tk.canonical_key_planes, tk.canonical_key_planes_plain,
             (*args, k, normalized)),
            (tk.canonical_hash_tally, tk.canonical_hash_tally_plain,
             (*args, k, 16, normalized)),
        )
    for fn, plain, a in pairs:
        for got, want in zip(fn(*a), plain(*a)):
            assert torch.equal(got, want), (fn.__name__, k)


@pytest.mark.parametrize("width", [150, 152, 156, 40_000])
def test_cuda_window_modes_ascii_widths(cuda_device, width):
    """Every mode over ASCII rows whose pitch is no multiple of 4 (150,
    156), of 8 but not 16 (152), and wider than one segment (40,000)."""
    rng = np.random.default_rng(70 + width % 97)
    rows = 16 if width > 1000 else 300
    seqs, lengths = random_reads(rng, rows, width, dirty_frac=0.5)
    args = (torch.from_numpy(seqs).to(cuda_device),
            torch.from_numpy(lengths).to(cuda_device))
    for k in KS:
        for normalized in (True, False):
            _assert_window_modes(False, args, k, normalized)


@pytest.mark.parametrize("width", [152, 40_000])
def test_cuda_window_modes_packed_unaligned_vbits(cuda_device, width):
    """Packed rows of 38-byte pitch and wider than a segment, with the
    validity plane a view at an odd byte offset."""
    rng = np.random.default_rng(80 + width % 89)
    rows = 16 if width > 1000 else 300
    seqs, lengths = random_reads(rng, rows, width, dirty_frac=1.0)
    batch = packed_batch(seqs, lengths, 1)
    codes = torch.from_numpy(batch.codes).to(cuda_device)
    vb = odd_offset_view(torch.from_numpy(batch.vbits).to(cuda_device))
    assert vb.data_ptr() % 2 == 1
    ln = torch.from_numpy(lengths).to(cuda_device)
    for k in KS:
        _assert_window_modes(True, (codes, vb, ln), k)


def test_cuda_window_modes_packed_width_156(cuda_device):
    """Clean packed rows of 156 bases (39 bytes): no validity plane, and a
    last validity byte that covers only four bases."""
    codes, _, lengths = packed_rows(np.random.default_rng(90), 300, 156)
    codes = torch.from_numpy(codes).to(cuda_device)
    ln = torch.from_numpy(lengths).to(cuda_device)
    for k in KS:
        _assert_window_modes(True, (codes, None, ln), k)


@pytest.mark.parametrize("block", [1 << 18, 1 << 20])
def test_cuda_block_sort_merge_passes(cuda_device, block):
    """Spans that take 5 and 7 merge passes, over keys with many
    duplicates, the top bit set on a third of them; ``x`` is unchanged."""
    rng = np.random.default_rng(block)
    keys = rng.integers(0, 97, 1 << 21).astype(np.uint32) * np.uint32(0x01010101)
    keys[::3] |= np.uint32(1 << 31)
    for plane in (keys, np.full_like(keys, 0xFFFFFFFF)):
        x = torch.from_numpy(plane.view(np.int32)).to(cuda_device)
        before = x.clone()
        got = tk.bitonic_block_sort(x, block)
        assert torch.equal(x, before)
        assert torch.equal(got, tk.block_sort_plain(x, block))


@pytest.mark.parametrize("offset,n", [
    (1, 1_000_000), (2, 4 * 5_000 + 1), (3, 4 * 777 + 3), (0, 4 * 9_999 + 2),
    (1, 3), (0, 1),
])
def test_cuda_histogram_views_and_ragged_lengths(cuda_device, offset, n):
    """A view off a 16-byte boundary (scalar head), a length that is no
    multiple of 4 (scalar tail), and lengths shorter than one step."""
    rng = np.random.default_rng(offset * 7 + n)
    flat = torch.from_numpy(
        rng.integers(-(1 << 20), 1 << 20, n + 4, dtype=np.int64).astype(np.int32)
    ).to(cuda_device)
    keys = flat[offset:offset + n]
    assert torch.equal(tk.mxu_histogram16(keys), tk.histogram16_plain(keys))


@pytest.mark.parametrize("chunk,slots", [(32, 8), (96, 16), (2048, 256), (128, 200)])
@pytest.mark.parametrize("offset", [0, 1])
def test_cuda_compact_slots_chunks_and_views(cuda_device, chunk, slots, offset):
    """Chunks off the 128-lane segments and of several 512-lane tiles,
    slots past the chunk, and counts that start off a 16-byte boundary."""
    rng = np.random.default_rng(chunk + offset)
    n = 50_003
    planes = rng.integers(-(1 << 31), 1 << 31, (3, n + 1), dtype=np.int64)
    planes[2] = np.where(rng.random(n + 1) < 0.1, rng.integers(1, 9, n + 1), 0)
    hi, lo, c = torch.from_numpy(planes.astype(np.int32)).to(cuda_device)
    hi, lo, c = (t[offset:offset + n] for t in (hi, lo, c))
    for args in ((hi, lo, c), (None, lo, c)):
        got = tk.mxu_compact_slots(*args, chunk=chunk, slots=slots)
        want = tk.compact_slots_plain(*args, chunk=chunk, slots=slots)
        for a, b in zip(got, want):
            assert (a is None and b is None) or torch.equal(a, b)


# every width a length-bucketed stream gives the ASCII key-plane kernel:
# the default buckets and a dynamic width (a multiple of 128, no power of 2)
BUCKET_WIDTHS = [128, 256, 512, 1024, 2048, 4096, 8064]


@pytest.mark.parametrize("width", BUCKET_WIDTHS)
def test_cuda_key_planes_bucket_widths(cuda_device, width):
    """The ASCII planes mode at every bucket width, k=21 and 31, on
    quality-masked reads (the bucketed and quality paths' input)."""
    from needletail_tpu_torch.device.ops import quality_mask

    rng = np.random.default_rng(width)
    rows = max(8, (1 << 20) // width)
    seqs, lengths = random_reads(rng, rows, width, dirty_frac=0.3)
    quals = rng.integers(33, 75, seqs.shape).astype(np.uint8)
    s = quality_mask(torch.from_numpy(seqs), torch.from_numpy(quals), 53)
    s, ln = s.to(cuda_device), torch.from_numpy(lengths).to(cuda_device)
    for k in (21, 31):
        for normalized in (True, False):
            got = tk.canonical_key_planes(s, ln, k, normalized)
            want = tk.canonical_key_planes_plain(s, ln, k, normalized)
            for a, b in zip(got, want):
                assert torch.equal(a, b), (width, k, normalized)


def test_cuda_quality_paths_match_plain(cuda_device, tmp_path):
    """``count_file`` and ``multi_k_count_file`` under ``quality_cutoff``
    (key planes over the masked bytes, k=9 dense through the histogram)
    and ``quality_filter_file`` on the card equal to the CPU's."""
    from pathlib import Path

    from needletail_tpu_torch.device.pipeline import (
        count_file, multi_k_count_file, quality_filter_file,
    )

    copies = tmp_path / "x8.fq"
    copies.write_bytes(Path(FQ).read_bytes() * 8)
    kw = dict(batch_size=4096, max_len=128, host_workers=1,
              sparse_format="arrays", quality_cutoff=20)
    for k, kernel in ((21, "key_planes"), (9, "histogram16")):
        tk.reset_launches()
        got = count_file(str(copies), k, device="cuda", **kw)
        assert tk.LAUNCHES[kernel] > 0, (k, tk.LAUNCHES)
        want = count_file(FQ, k, device="cpu", **kw)
        assert got[0] == 8 * want[0]
        if k == 9:
            np.testing.assert_array_equal(got[1], 8 * want[1])
        else:
            np.testing.assert_array_equal(got[1][0], want[1][0])
            np.testing.assert_array_equal(got[1][1], 8 * want[1][1])
    tk.reset_launches()
    got = multi_k_count_file(str(copies), (4, 21), device="cuda", **kw)
    assert tk.LAUNCHES["histogram16"] > 0 and tk.LAUNCHES["key_planes"] > 0
    want = multi_k_count_file(FQ, (4, 21), device="cpu", **kw)
    np.testing.assert_array_equal(got[1][4], 8 * want[1][4])
    np.testing.assert_array_equal(got[1][21][1], 8 * want[1][21][1])
    outs = {}
    for device in ("cuda", "cpu"):
        out = tmp_path / f"{device}.fq"
        outs[device] = (quality_filter_file(FQ, str(out), 30, device=device),
                        out.read_bytes())
    assert outs["cuda"] == outs["cpu"] and outs["cpu"][0] == (2000, 1732)


def test_cuda_minimizers_match_plain(cuda_device, tmp_path):
    """The planes route of the sketch on the card: the kernel's planes
    through ``window_minimizers_from_planes`` equal to ``window_minimizers``
    on the same tensors, and ``minimizer_spectrum_file`` packed and ASCII
    equal to the CPU's."""
    from needletail_tpu_torch.device import minimizers as tm
    from needletail_tpu_torch.device.pipeline import minimizer_spectrum_file

    rng = np.random.default_rng(62)
    seqs, lengths = random_reads(rng, 512, 152, dirty_frac=0.3)
    s = torch.from_numpy(seqs).to(cuda_device)
    ln = torch.from_numpy(lengths).to(cuda_device)
    for k, w in ((15, 5), (21, 11), (31, 11)):
        khi, klo, _, _ = tk.canonical_key_planes(s, ln, k)
        got = tm.window_minimizers_from_planes(khi, klo, k, w)
        want = tm.window_minimizers(s, ln, k, w)
        for a, b in zip(got, want):
            assert torch.equal(a, b), (k, w)
    kw = dict(batch_size=4096, max_len=128, host_workers=1)
    for packed in (True, False):
        tk.reset_launches()
        got = minimizer_spectrum_file(FQ, 21, 11, packed=packed,
                                      device="cuda", **kw)
        assert tk.LAUNCHES["key_planes"] > 0
        want = minimizer_spectrum_file(FQ, 21, 11, packed=packed,
                                       device="cpu", **kw)
        assert got[0] == want[0] == GOLD[0]
        for a, b in zip(got[1], want[1]):
            np.testing.assert_array_equal(a, b)


def test_cuda_bucketed_matches_plain(cuda_device, tmp_path):
    """``count_file(bucketed=True, quality_cutoff=20)`` over mixed read
    lengths (widths 128, 256, 4096 and a dynamic one) on the card equal
    to the CPU's and to the flat stream's."""
    from needletail_tpu_torch.device.pipeline import count_file
    from needletail_tpu_torch.utils.synth import mixed_length_fastq

    fq = tmp_path / "mixed.fq"
    fq.write_bytes(mixed_length_fastq(7, short_reads=400, long_reads=8))
    kw = dict(batch_size=512, sparse_format="arrays", quality_cutoff=20)
    tk.reset_launches()
    got = count_file(str(fq), 31, bucketed=True, device="cuda", **kw)
    assert tk.LAUNCHES["key_planes"] > 0
    for want in (
        count_file(str(fq), 31, bucketed=True, device="cpu", **kw),
        count_file(str(fq), 31, device="cuda", host_workers=1, **kw),
    ):
        assert got[0] == want[0]
        for a, b in zip(got[1], want[1]):
            np.testing.assert_array_equal(a, b)


@pytest.fixture
def nccl_world_of_one(cuda_device):
    from needletail_tpu_torch.parallel import make_mesh
    from needletail_tpu_torch.parallel.distributed import initialize, shutdown

    initialize(device="cuda")
    try:
        yield make_mesh(data=1, table=1)
    finally:
        shutdown()


def test_cuda_sharded_drivers_match_plain(nccl_world_of_one, tmp_path):
    """The sharded drivers on a NCCL world of one, through the hand
    kernels, equal to the flat drivers' plain versions."""
    from needletail_tpu_torch.device import kernels as K
    from needletail_tpu_torch.device.pipeline import count_file, hash_count_file
    from needletail_tpu_torch.parallel import (
        sharded_count_file, sharded_hash_count_file, sharded_multi_k_count_file,
    )

    mesh = nccl_world_of_one
    kw = dict(batch_size=512, max_len=128, host_workers=1)
    K.reset_launches()
    got = sharded_hash_count_file(FQ, 21, mesh, **kw)
    want = hash_count_file(FQ, 21, device="cpu", **kw)
    assert got[:3] == want[:3] == GOLD
    assert np.array_equal(got[3], want[3])
    got = sharded_count_file(FQ, 21, mesh, **kw)
    want = count_file(FQ, 21, device="cpu", sparse_format="arrays", **kw)
    assert got[0] == want[0]
    for a, b in zip(got[1], want[1]):
        assert np.array_equal(a, b)
    n, spec = sharded_multi_k_count_file(FQ, (4, 21, 31), mesh, **kw)
    assert n == GOLD[0] and int(spec[4].sum()) == 243_982
    for name in ("hash_keys", "histogram16", "key_planes", "compact_slots"):
        assert K.LAUNCHES[name] > 0, name
