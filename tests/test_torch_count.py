"""The exact path's pieces in the port against the JAX package's.

The key-plane and slot-compaction kernels are held through their plain
versions against the Pallas kernels in interpret mode; the sort-based run
counting, the compaction routes and the streaming accumulator of
``device/count.py`` against ``needletail_tpu/device/count.py``.  Inputs
come from seeded numpy generators; everything is integer, so the tolerance
is 0.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from needletail_tpu.device import count as jc
from needletail_tpu.device import kmers as jk
from needletail_tpu.device import pallas_kernels as jpk
from needletail_tpu_torch.device import count as tc
from needletail_tpu_torch.device import kernels as tkr
from needletail_tpu_torch.device import kmers as tkm
from needletail_tpu_torch.device.ops import resolve_vbits, unwire
from needletail_tpu_torch.utils.synth import packed_batch, random_reads


def _i32(a) -> torch.Tensor:
    """int32 tensor of a uint32 (or int32) array's bit patterns."""
    a = np.ascontiguousarray(np.asarray(a))
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


def _equal(got, want, what=""):
    """A port tensor equal to a JAX array, uint32 read as int32."""
    if want is None:
        assert got is None, what
        return
    w = np.asarray(want)
    if w.dtype == np.uint32:
        w = w.view(np.int32)
    g = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert g.shape == w.shape, what
    np.testing.assert_array_equal(g, w, err_msg=what)


# ---------------------------------------------------------------------------
# key planes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [1, 15, 16, 17, 31])
def test_key_planes_match_pallas(k):
    rng = np.random.default_rng(k)
    seqs, lengths = random_reads(rng, 16, 64, dirty_frac=0.5)
    for normalized in (True, False):
        got = tkr.canonical_key_planes(
            torch.from_numpy(seqs), torch.from_numpy(lengths), k, normalized
        )
        want = jpk.canonical_key_planes(
            jnp.asarray(seqs), jnp.asarray(lengths), k, normalized=normalized
        )
        for g, w, part in zip(got, want, ("hi", "lo", "total", "fwd")):
            _equal(g, w, f"k={k} normalized={normalized} {part}")


@pytest.mark.parametrize("vmode", [0, 1, 2])
def test_packed_key_planes_match_pallas(vmode):
    rng = np.random.default_rng(60 + vmode)
    dirty = {0: 0.0, 1: 1.0, 2: 0.05}[vmode]
    seqs, lengths = random_reads(rng, 16, 64, dirty_frac=dirty)
    buf, layout = packed_batch(seqs, lengths, vmode).wire_frame(16)
    assert layout.vmode == vmode
    codes, ln, vbits, vrow_idx, vrows = unwire(torch.from_numpy(buf), layout)
    vb = resolve_vbits(vbits, vrow_idx, vrows, 16)
    for k in (4, 21, 31):
        got = tkr.canonical_key_planes_packed(codes, vb, ln, k)
        want = jpk.canonical_key_planes_packed(
            jnp.asarray(codes.numpy()),
            None if vb is None else jnp.asarray(vb.numpy()),
            jnp.asarray(ln.numpy()), k,
        )
        for g, w, part in zip(got, want, ("hi", "lo", "total", "fwd")):
            _equal(g, w, f"vmode={vmode} k={k} {part}")


def test_key_planes_equal_masked_windows():
    """The planes are ``mask_keys`` of the canonical windows, lane for
    lane over the window positions, sentinel beyond them."""
    rng = np.random.default_rng(3)
    seqs, lengths = random_reads(rng, 8, 48, dirty_frac=0.5)
    s, ln = torch.from_numpy(seqs), torch.from_numpy(lengths)
    for k in (9, 21):
        hi, lo, total, fwd = tkr.canonical_key_planes(s, ln, k)
        win = tkm.canonical_kmers(s, ln, k)
        mhi, mlo = tc.mask_keys(win)
        w = 48 - k + 1
        assert torch.equal(hi[:, :w].reshape(-1), mhi)
        assert torch.equal(lo[:, :w].reshape(-1), mlo)
        assert (hi[:, w:] == -1).all() and (lo[:, w:] == -1).all()
        assert int(total) == int(tc.valid_count(win))
        assert int(fwd) == int(tc.forward_count(win))


# ---------------------------------------------------------------------------
# slot compaction
# ---------------------------------------------------------------------------


def _compact_inputs(rng, n, share, wide):
    planes = rng.integers(0, 2**32, (2, n), dtype=np.uint64).astype(np.uint32)
    counts = np.where(rng.random(n) < share, rng.integers(1, 100, n), 0)
    return (planes[0] if wide else None), planes[1], counts.astype(np.int32)


@pytest.mark.parametrize("wide", [True, False])
@pytest.mark.parametrize("n,share,overflow", [
    (3000, 0.08, False),     # one 8-chunk group, ragged
    (20_000, 0.08, True),    # a chunk with 300 flags
    (8192 * 2, 0.06, False), # a whole number of groups
])
def test_compact_slots_plain_matches_pallas(wide, n, share, overflow):
    rng = np.random.default_rng(n)
    hi, lo, counts = _compact_inputs(rng, n, share, wide)
    if overflow:
        counts[3000:3300] = 1
    got = tkr.compact_slots_plain(
        None if hi is None else _i32(hi), _i32(lo), torch.from_numpy(counts)
    )
    want = jpk.mxu_compact_slots(
        None if hi is None else jnp.asarray(hi), jnp.asarray(lo),
        jnp.asarray(counts),
    )
    # on overflow too: slot j of each chunk holds its j-th flagged entry
    for g, w, part in zip(got[:3], want[:3], ("hi", "lo", "counts")):
        _equal(g, w, part)
    assert bool(got[3]) == bool(want[3]) == (not overflow)
    # the wrapper takes the plain version for CPU tensors
    again = tkr.mxu_compact_slots(
        None if hi is None else _i32(hi), _i32(lo), torch.from_numpy(counts)
    )
    for a, b in zip(again, got):
        assert (a is None and b is None) or torch.equal(a, b)


def test_compact_slots_overflow_keeps_first_flags():
    """On overflow slot j of a chunk holds its j-th flagged entry."""
    counts = np.zeros(8192, np.int32)
    counts[:200] = np.arange(1, 201)
    lo = np.arange(8192, dtype=np.int32)
    _, lo_c, c_c, ok = tkr.compact_slots_plain(
        None, torch.from_numpy(lo), torch.from_numpy(counts)
    )
    assert not bool(ok)
    assert lo_c[:128].tolist() == list(range(128))
    assert c_c[:128].tolist() == list(range(1, 129))
    assert not c_c[128:].any()


def test_compact_slots_rejects_bad_shapes():
    lo = torch.zeros(10, dtype=torch.int32)
    with pytest.raises(ValueError):
        tkr.mxu_compact_slots(None, lo, torch.zeros(9, dtype=torch.int32))
    with pytest.raises(ValueError):
        tkr.mxu_compact_slots(None, lo, lo, chunk=100)
    with pytest.raises(TypeError):
        tkr.mxu_compact_slots(None, lo.long(), lo)


# ---------------------------------------------------------------------------
# run counting and the compaction routes
# ---------------------------------------------------------------------------


def _key_stream(seed, n, wide, distinct=64):
    """Keys with repeats, sentinels, and (wide) the largest valid k=31 key
    and a key whose low half is all ones."""
    rng = np.random.default_rng(seed)
    lo = rng.integers(0, distinct, n).astype(np.uint32)
    hi = rng.integers(0, 4, n).astype(np.uint32) if wide else None
    sent = rng.random(n) < 0.2
    lo[sent] = 0xFFFFFFFF
    if wide:
        hi[sent] = 0xFFFFFFFF
        hi[5], lo[5] = (1 << 30) - 1, 0xFFFFFFFF  # 2^62 - 1
        hi[6], lo[6] = 3, 0xFFFFFFFF
        hi[7], lo[7] = (1 << 30) - 1, 0xFFFFFFFF  # a repeat of lane 5
    return hi, lo


def _both(hi, lo):
    return (
        (None if hi is None else jnp.asarray(hi), jnp.asarray(lo)),
        (None if hi is None else _i32(hi), _i32(lo)),
    )


@pytest.mark.parametrize("wide", [True, False])
def test_unique_counts_match_jax(wide):
    hi, lo = _key_stream(1, 5000, wide)
    j, t = _both(hi, lo)
    want = jc.unique_counts(*j)
    got = tc.unique_counts(*t)
    for g, w, part in zip(got, want, ("hi", "lo", "counts")):
        _equal(g, w, part)
    assert got[2].dtype == torch.int32
    if wide:
        # the sentinel sorts last; 2^62 - 1 sorts just before it, twice
        assert got[0][-1] == -1 and got[1][-1] == -1
        last = int((got[2] > 0).nonzero().max())
        assert (int(got[0][last]), int(got[1][last])) == ((1 << 30) - 1, -1)
        assert int(got[2][last]) == 2


@pytest.mark.parametrize("wide", [True, False])
def test_compact_runs_match_jax(wide):
    hi, lo = _key_stream(2, 5000, wide)
    j, t = _both(hi, lo)
    jruns, truns = jc.unique_counts(*j), tc.unique_counts(*t)
    for g, w in zip(tc.compact_runs_device(*truns), jc.compact_runs_device(*jruns)):
        _equal(g, w)
    got = tc.compact_runs_cascade(*truns)
    want = jc.compact_runs_cascade(*jruns)
    assert got[3] == want[3]
    for g, w in zip(got[:3], want[:3]):
        _equal(g, w)


def test_cascade_overflow_reports_n():
    """A mostly-distinct stream overflows the first pass."""
    rng = np.random.default_rng(4)
    lo = rng.permutation(20_000).astype(np.uint32)
    j, t = _both(None, lo)
    jruns, truns = jc.unique_counts(*j), tc.unique_counts(*t)
    assert tc.compact_runs_cascade(*truns) is None
    assert jc.compact_runs_cascade(*jruns) is None
    got = tc.compact_runs_cascade(*truns, n_on_overflow=True)
    assert got[:3] == (None, None, None) and got[3] == 20_000
    assert jc.compact_runs_cascade(*jruns, n_on_overflow=True)[3] == 20_000


def _parts(hi, lo, cut):
    j = [_both(None if hi is None else hi[a:b], lo[a:b])[0] for a, b in cut]
    t = [_both(None if hi is None else hi[a:b], lo[a:b])[1] for a, b in cut]
    return j, t


@pytest.mark.parametrize("wide", [True, False])
@pytest.mark.parametrize("route,distinct", [
    ("cascade", 64),
    ("stable_partition", 3000),
    ("host_filter", 1 << 22),
])
def test_finalize_sparse_routes_match_jax(wide, route, distinct):
    n = 6000
    hi, lo = _key_stream(5, n, wide, distinct)
    cut = [(0, 2500), (2500, n)]
    jparts, tparts = _parts(hi, lo, cut)
    pad = 1024 if route == "cascade" else 8192
    want = jc.finalize_sparse(jparts, pad_multiple=pad, device_compact=False)
    for dc, cas in ((False, False), (True, False), (True, True)):
        tc.reset_flush_routes()
        got = tc.finalize_sparse(
            tparts, pad_multiple=pad, device_compact=dc, cascade=cas
        )
        assert got[0].dtype == np.uint64 and got[1].dtype == np.int64
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        expect = "host" if not dc else ("stable_partition" if not cas else route)
        assert tc.FLUSH_ROUTES == {r: int(r == expect) for r in tc.FLUSH_ROUTES}
    jd = jc.finalize_sparse(jparts, pad_multiple=pad, device_compact=True,
                            cascade=True)
    np.testing.assert_array_equal(jd[0], want[0])


def test_finalize_sparse_device_matches_jax():
    hi, lo = _key_stream(6, 3000, True)
    jparts, tparts = _parts(hi, lo, [(0, 1000), (1000, 3000)])
    got = tc.finalize_sparse_device(tparts, pad_multiple=2048)
    want = jc.finalize_sparse_device(jparts, pad_multiple=2048)
    for g, w in zip(got, want):
        _equal(g, w)
    with pytest.raises(ValueError, match="mix"):
        tc.finalize_sparse([tparts[0], (None, tparts[1][1])])


@pytest.mark.parametrize("wide", [True, False])
def test_accumulator_with_tiny_flushes_matches_jax(wide):
    hi, lo = _key_stream(7, 4000, wide, distinct=500)
    cut = [(i, i + 400) for i in range(0, 4000, 400)]
    jparts, tparts = _parts(hi, lo, cut)
    whole = jc.finalize_sparse(jparts, pad_multiple=1024)
    for flush in (1, 900, 1 << 26):
        ta = tc.SparseSpectrumAccumulator(flush_lanes=flush)
        ja = jc.SparseSpectrumAccumulator(flush_lanes=flush)
        for (jh, jl), (th, tl) in zip(jparts, tparts):
            ja.add(jh, jl)
            ta.add(th, tl)
        got, want = ta.finish(), ja.finish()
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(got[0], whole[0])
        np.testing.assert_array_equal(got[1], whole[1])
    fresh = tc.SparseSpectrumAccumulator()
    fresh.restore(*got)
    assert tc.spectrum_arrays_to_dict(*fresh.finish()) == {
        int(k): int(c) for k, c in zip(*whole)
    }
    with pytest.raises(ValueError, match="fresh"):
        fresh.restore(*got)


def test_merge_and_dict_views_match_jax():
    rng = np.random.default_rng(8)
    a = np.unique(rng.integers(0, 1000, 300)).astype(np.uint64)
    b = np.unique(rng.integers(0, 1000, 300)).astype(np.uint64)
    ac = rng.integers(1, 9, a.size).astype(np.int64)
    bc = rng.integers(1, 9, b.size).astype(np.int64)
    for g, w in zip(tc.merge_sorted_spectra(a, ac, b, bc),
                    jc.merge_sorted_spectra(a, ac, b, bc)):
        np.testing.assert_array_equal(g, w)
    hi, lo = _key_stream(9, 2000, True)
    j, t = _both(hi, lo)
    jr, tr = jc.unique_counts(*j), tc.unique_counts(*t)
    assert tc.spectrum_to_dict(*tr, k=31) == jc.spectrum_to_dict(
        *(np.asarray(x) for x in jr), k=31
    )


# ---------------------------------------------------------------------------
# dense spectra and targeted counts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [4, 9])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_dense_spectrum_matches_jax(k, use_kernel):
    """Both routes: ``bincount``, and the histogram kernel's (plain on the
    CPU), with 4^9 as four masked passes."""
    rng = np.random.default_rng(k)
    seqs, lengths = random_reads(rng, 32, 80, dirty_frac=0.3)
    t = tkm.canonical_kmers(torch.from_numpy(seqs), torch.from_numpy(lengths), k)
    j = jk.canonical_kmers(jnp.asarray(seqs), jnp.asarray(lengths), k)
    got = tc.dense_spectrum(t, k, use_kernel=use_kernel)
    want = jc.dense_spectrum(j, k, use_mxu=False)
    assert got.dtype == torch.int32
    _equal(got, want)
    assert int(got.sum()) == int(tc.valid_count(t)) == int(jc.valid_count(j))
    assert int(tc.forward_count(t)) == int(jc.forward_count(j))
    with pytest.raises(ValueError):
        tc.dense_spectrum(t, 13)


def test_match_count_matches_jax():
    from needletail_tpu.device import pipeline as jp
    from needletail_tpu_torch.device import pipeline as tp

    rng = np.random.default_rng(11)
    seqs, lengths = random_reads(rng, 32, 80, dirty_frac=0.3)
    for target in (b"AAAA", b"ACGT", b"GGCC"):
        thi, tlo = tp.pack_target(target)
        assert (thi, tlo) == jp.pack_target(target)
        t = tkm.canonical_kmers(torch.from_numpy(seqs), torch.from_numpy(lengths), 4)
        j = jk.canonical_kmers(jnp.asarray(seqs), jnp.asarray(lengths), 4)
        assert int(tc.match_count(t, thi, tlo)) == int(
            jc.match_count(j, jnp.uint32(thi), jnp.uint32(tlo))
        )
