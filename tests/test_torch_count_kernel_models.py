"""The index arithmetic of the port's histogram, slot-compaction and
spectrum-merge CUDA kernels, modelled in numpy and held against the
references.

``csrc/histogram16.cu`` runs clusters of two CTAs; rank r holds bins
[32768 r, 32768 r + 32768) in shared memory.  The keys are read once, as
16-byte int4s from the first 16-byte boundary with a scalar head and
tail, in grid-stride steps of ``UNROLL`` loads a thread; a CTA adds the
keys of its own half, ``(key >> 15) & 1``, and stores the others into
its peer's double-buffered inbox, which the peer adds once its warp has
seen the sending warp's arrivals.  Each cluster stores its table as one row of a partial table,
whose columns a second kernel sums.  ``csrc/compact_slots.cu`` gives each
chunk to one warp, whose thread t holds lanes [V t, V t + V) of each
32 V-lane segment (V = 4 when chunk is a multiple of 128 and counts is
16-byte aligned, else 1); V ballots give each thread its flags' ranks,
and the running count carries across segments and tiles of four
segments.  ``csrc/merge_spectra.cu`` cuts the merge of two sorted spectra
into tiles of ``THREADS * ITEMS`` outputs at diagonals found by binary
search, merges each tile twice in shared memory (run heads, then the
output at each tile's scanned offset) and adds B's equal key's count to
A's, wherever B's key lies.

``csrc/run_counts.cu`` cuts a sorted key stream into tiles of
``RUN_THREADS * RUN_ITEMS`` lanes; a head finds the next head in its
thread's lanes, its warp (a ballot) or a later warp (a table of each
warp's first head), and the tile's last run searches past the tile,
32 probes a step.

The models follow the kernels' steps once, written here; the tests hold
them against the port's plain versions and JAX's ``mxu_histogram16`` /
``mxu_compact_slots`` (the Pallas kernels in interpret mode, as
``tests/test_torch_kernels.py`` runs them).  The kernels themselves are
held against the plain versions on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).  All integer: tolerance 0.

The end of the file tests ``chip_smoke.device_time_by_name``, the
profile table the card run prints.
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from needletail_tpu.device import pallas_kernels as jpk
from needletail_tpu_torch.device import count as tc
from needletail_tpu_torch.device import kernels as tk

# ---------------------------------------------------------------------------
# histogram16.cu
# ---------------------------------------------------------------------------

THREADS = 1024
CLUSTER = 2
BINS = 1 << 16
HALF = BINS // CLUSTER
UNROLL = 4
NONE = 0xFFFF  # an empty half of an inbox word
MAX_CLUSTERS = 66  # 132 SMs, one 192 KiB CTA each


def hist_clusters(n, max_clusters=MAX_CLUSTERS, threads=THREADS):
    """``nt_histogram16_clusters``: no more clusters than one step of
    loads needs, nor than fit on the card at once."""
    step = CLUSTER * threads * 4 * UNROLL
    return min(-(-n // step), max_clusters)


def hist_split(n, offset):
    """``(head, n4, tail)`` of n keys that start ``offset`` int32s past a
    16-byte boundary."""
    head = min(n, (4 - offset % 4) % 4)
    n4 = (n - head) // 4
    return head, n4, n - head - 4 * n4


def owner(keys):
    """The cluster rank whose half of the table holds each key."""
    return (keys >> 15) & 1


def hist_steps(n, offset, clusters, threads=THREADS):
    """Yields, for each step of the kernel's loop, ``pos[cta, u, t, 4]``:
    the key positions that thread t of each CTA holds in its u-th int4
    (-1 past the keys)."""
    head, n4, _ = hist_split(n, offset)
    grid = clusters * CLUSTER
    stride = grid * threads
    b = np.arange(grid)[:, None, None]
    u = np.arange(UNROLL)[None, :, None]
    t = np.arange(threads)[None, None, :]
    for s in range(0, n4, stride * UNROLL):
        i = s + u * stride + b * threads + t  # int4 index
        pos = head + 4 * i[..., None] + np.arange(4)
        yield np.where((i < n4)[..., None], pos, -1)


def pack(keys, peer):
    """``pack``: pairs of keys ``[..., 2]`` for the peer as one word each,
    their offsets in its half or ``NONE``."""
    keys = keys.astype(np.int64)
    mine = (keys >= 0) & (owner(keys) == peer)
    half = np.where(mine, keys & (HALF - 1), NONE)
    return (half[..., 0] | half[..., 1] << 16).astype(np.uint32)


def unpack(words):
    """``add_pair``: the offsets in inbox words, ``NONE`` halves dropped."""
    halves = np.stack([words & 0xFFFF, words >> 16], -1).reshape(-1)
    return halves[halves != NONE].astype(np.int64)


def hist_model(keys, offset=0, max_clusters=MAX_CLUSTERS, threads=THREADS):
    """The two kernels over ``keys``: ``(counts, partials, reads, sends)``;
    ``reads[p]`` how often key p was loaded, ``sends`` the keys that went
    through an inbox."""
    n = keys.size
    clusters = hist_clusters(n, max_clusters, threads)
    grid = clusters * CLUSTER
    rank = np.arange(grid) % CLUSTER
    peer = np.arange(grid) ^ 1  # the other CTA of the cluster
    bins = np.zeros((grid, HALF), np.int64)  # each CTA's shared memory
    # [cta, buffer, UNROLL / 2 slots, thread, 4 words]: the uint4 slots
    inbox = np.full((grid, 2, UNROLL // 2, threads, 4), 7, np.int64)
    fresh = np.zeros((grid, 2), bool)
    reads = np.zeros(n, np.int64)
    sends = 0
    buf = 0
    for pos in hist_steps(n, offset, clusters, threads):
        live = pos >= 0
        np.add.at(reads, pos[live], 1)
        v = np.where(live, keys[np.where(live, pos, 0)], -1)  # [cta, u, t, 4]
        for cta in range(grid):
            # int4s u and u + 1 of a thread fill one slot of the peer's inbox
            pairs = v[cta].reshape(UNROLL // 2, 2, threads, 2, 2)
            words = pack(pairs.transpose(0, 2, 1, 3, 4), rank[peer[cta]])
            assert not fresh[peer[cta], buf]  # the peer read it last time
            inbox[peer[cta], buf] = words.reshape(UNROLL // 2, threads, 4)
            fresh[peer[cta], buf] = True
            mine = v[cta][(v[cta] >= 0) & (owner(v[cta]) == rank[cta])]
            np.add.at(bins[cta], mine & (HALF - 1), 1)
        # each warp waits for its peer warp's arrivals, then adds what the
        # peer sent
        for cta in range(grid):
            assert fresh[cta, buf]
            got = unpack(inbox[cta, buf].reshape(-1))
            fresh[cta, buf] = False
            sends += got.size
            np.add.at(bins[cta], got, 1)
        buf ^= 1
    head, n4, tail = hist_split(n, offset)
    ends = np.r_[np.arange(head), head + 4 * n4 + np.arange(tail)]
    np.add.at(reads, ends, 1)
    for k in keys[ends]:
        if k >= 0:  # CTA 0's cluster, the rank that owns the key
            bins[owner(k)][k & (HALF - 1)] += 1
    # each cluster's row: rank 0's half, then rank 1's
    partials = bins.reshape(clusters, BINS)
    return partials.sum(0).astype(np.int32), partials, reads, sends


def _hist_keys(kind, n, rng):
    uniform = rng.integers(0, 1 << 16, n, dtype=np.int32)
    return {
        "uniform": uniform,
        "single key": np.full(n, 40_000, np.int32),
        "mostly invalid": np.where(rng.random(n) < 0.9, -1, uniform),
        "wide": rng.integers(-(1 << 31), 1 << 31, n, dtype=np.int64),
    }[kind].astype(np.int32)


@pytest.mark.parametrize("threads", [THREADS, 32])
@pytest.mark.parametrize("n,offset", [
    (1, 0), (3, 1), (5, 3), (129, 0), (4 * 1000 + 2, 2), (20_001, 1),
    (70_000, 0),
])
def test_hist_reads_each_key_once(n, offset, threads):
    """Head, int4 body and tail cover every key once, whatever the offset,
    and each int4 starts on a 16-byte boundary."""
    clusters = hist_clusters(n, 3, threads)
    head, n4, tail = hist_split(n, offset)
    assert head + 4 * n4 + tail == n and head < 4 and tail < 4
    assert n4 == 0 or (offset + head) % 4 == 0
    reads = np.zeros(n, np.int64)
    for pos in hist_steps(n, offset, clusters, threads):
        np.add.at(reads, pos[pos >= 0], 1)
    reads[:head] += 1
    reads[head + 4 * n4:] += 1
    np.testing.assert_array_equal(reads, np.ones(n))


def test_hist_clusters():
    step = CLUSTER * THREADS * 4 * UNROLL
    assert hist_clusters(1) == 1
    assert hist_clusters(step) == 1 and hist_clusters(step + 1) == 2
    assert hist_clusters(1 << 24) == MAX_CLUSTERS


@pytest.mark.parametrize("kind", ["uniform", "single key", "mostly invalid", "wide"])
def test_hist_model_matches_plain_and_jax(kind):
    rng = np.random.default_rng(61)
    n, offset = 9_003, 1
    keys = _hist_keys(kind, n, rng)
    got, partials, reads, sends = hist_model(keys, offset, max_clusters=2,
                                             threads=64)
    assert (reads == 1).all()
    assert partials.shape == (hist_clusters(n, 2, 64), BINS)
    want = tk.histogram16_plain(torch.from_numpy(keys)).numpy()
    np.testing.assert_array_equal(got, want)
    jax_want = jpk.mxu_histogram16(jnp.asarray(keys), None, chunk=4096,
                                   sub=1024)
    np.testing.assert_array_equal(got, np.asarray(jax_want))
    assert sends <= int((keys >= 0).sum())


def test_hist_model_at_kernel_shape():
    """1024-thread CTAs, two clusters, a head at offset 3 and a short
    tail: about half the valid keys cross to the peer's inbox, and the
    upper halves of the rows hold the keys with bit 15 set."""
    rng = np.random.default_rng(62)
    keys = _hist_keys("uniform", 2 * CLUSTER * THREADS * 4 * UNROLL - 5, rng)
    got, partials, _, sends = hist_model(keys, offset=3)
    assert partials.shape[0] == 2
    assert partials[:, HALF:].sum() == int(owner(keys).sum())
    assert 0.4 < sends / keys.size < 0.6
    np.testing.assert_array_equal(
        got, tk.histogram16_plain(torch.from_numpy(keys)).numpy()
    )


# ---------------------------------------------------------------------------
# compact_slots.cu
# ---------------------------------------------------------------------------

SEGS = 4  # segments a warp loads before it uses any
GROUP = 8
LANE = np.arange(32)
BELOW = (np.uint64(1) << LANE.astype(np.uint64)) - np.uint64(1)


def lanes_per_thread(chunk, aligned):
    return 4 if chunk % 128 == 0 and aligned else 1


def zero_spans(from_, to, aligned=True):
    """``zero_slots``: the scalar head, the int4 stores (their first
    slots) and the scalar tail that zero slots [from_, to)."""
    a = b = to
    if aligned:
        a = min(to, (from_ + 3) & ~3)
        b = max(a, to & ~3)
    return list(range(from_, a)), list(range(a, b, 4)), list(range(b, to))


def _popc(x):
    return bin(int(x)).count("1")


def compact_model(hi, lo, counts, chunk=1024, slots=128, aligned=True):
    """The kernel over numpy planes: ``(hi_c, lo_c, counts_c, ok)``, and
    how many times each output slot was written (must be once)."""
    v = lanes_per_thread(chunk, aligned)
    seg = 32 * v
    n = counts.size
    n_chunks = -(-n // (GROUP * chunk)) * GROUP
    out = {name: np.zeros(n_chunks * slots, np.int32) for name in ("hi", "lo", "c")}
    writes = np.zeros(n_chunks * slots, np.int64)
    overflow = False
    for w in range(n_chunks):
        first, slot0, seen = w * chunk, w * slots, 0
        for tile in range(0, chunk, SEGS * seg):
            # every load of the tile before any use: lanes i of the chunk
            i = tile + np.arange(SEGS)[:, None, None] * seg + (
                LANE[None, :, None] * v + np.arange(v)[None, None, :]
            )  # [SEGS, 32, V]
            g = first + i
            live = (i < chunk) & (g < n)
            c = np.where(live, counts[np.where(live, g, 0)], 0)
            for s in range(SEGS):
                mask = c[s] > 0  # [32, V]: the thread's V-bit mask
                before = np.zeros(32, np.int64)
                total = 0
                for j in range(v):
                    ballot = int((mask[:, j].astype(np.uint64) << LANE.astype(np.uint64)).sum())
                    before += [_popc(ballot & int(BELOW[t])) for t in LANE]
                    total += _popc(ballot)
                for t in LANE:
                    slot = seen + before[t]
                    for j in range(v):
                        if mask[t, j]:
                            if slot < slots:
                                src = g[s, t, j]
                                if hi is not None:
                                    out["hi"][slot0 + slot] = hi[src]
                                out["lo"][slot0 + slot] = lo[src]
                                out["c"][slot0 + slot] = c[s, t, j]
                                writes[slot0 + slot] += 1
                            slot += 1
                seen += total
        used = slot0 + min(seen, slots)
        scalar_head, vectors, scalar_tail = zero_spans(used, slot0 + slots)
        for j in scalar_head + scalar_tail:
            writes[j] += 1
        for j in vectors:
            assert j % 4 == 0
            writes[j:j + 4] += 1
        overflow |= seen > slots
    return (None if hi is None else out["hi"]), out["lo"], out["c"], not overflow, writes


def _runs(kind, n, rng, wide):
    """``unique_counts`` of a key stream: sorted runs, heads flagged."""
    keys = {
        "uniform": rng.integers(0, n // 3 + 1, n),
        "single key": np.full(n, 77),
        "mostly invalid": np.where(rng.random(n) < 0.9, -1, rng.integers(0, 500, n)),
        "wide": rng.integers(0, 1 << 62, n, dtype=np.int64),
    }[kind]
    lo = torch.from_numpy((keys & 0xFFFFFFFF).astype(np.uint32).view(np.int32))
    lo[torch.from_numpy(keys < 0)] = -1
    if not wide:
        return tc.unique_counts(None, lo)
    hi = torch.from_numpy((keys >> 32).astype(np.uint32).view(np.int32))
    hi[torch.from_numpy(keys < 0)] = -1
    return tc.unique_counts(hi, lo)


def _np(t):
    return None if t is None else t.numpy()


@pytest.mark.parametrize("from_,to,aligned", [
    (0, 128, True), (3, 128, True), (5, 7, True), (6, 6, True),
    (130, 257, True), (1, 9, False),
])
def test_zero_spans_cover_once(from_, to, aligned):
    head, vectors, tail = zero_spans(from_, to, aligned)
    covered = head + tail + [j + d for j in vectors for d in range(4)]
    assert sorted(covered) == list(range(from_, to))
    assert all(j % 4 == 0 for j in vectors)
    assert len(head) < 4 and len(tail) < 4 or not aligned


@pytest.mark.parametrize("chunk,slots", [
    (32, 8), (96, 16), (1024, 128), (2048, 256), (128, 160),
])
@pytest.mark.parametrize("kind", ["uniform", "single key", "mostly invalid", "wide"])
def test_compact_model_matches_plain(kind, chunk, slots):
    rng = np.random.default_rng(chunk + slots)
    n = 5_003
    for wide in (True, False):
        runs = _runs(kind, n, rng, wide)
        *got, writes = compact_model(*map(_np, runs), chunk=chunk, slots=slots)
        assert (writes == 1).all()
        want = tk.compact_slots_plain(*runs, chunk=chunk, slots=slots)
        for g, w in zip(got[:3], want[:3]):
            assert (g is None) == (w is None)
            if g is not None:
                np.testing.assert_array_equal(g, w.numpy())
        assert got[3] == bool(want[3])


@pytest.mark.parametrize("chunk,slots,share", [
    (32, 8, 0.3), (96, 16, 0.1), (1024, 128, 0.2), (2048, 256, 0.05),
])
def test_compact_model_matches_jax(chunk, slots, share):
    """Random flags on wide planes against the Pallas kernel, an
    overflowing chunk included where the share makes one likely."""
    rng = np.random.default_rng(chunk)
    n = chunk * GROUP - 3  # one padded group
    planes = rng.integers(0, 1 << 32, (2, n), dtype=np.uint64).astype(np.uint32)
    counts = np.where(rng.random(n) < share, rng.integers(1, 100, n), 0)
    counts = counts.astype(np.int32)
    *got, writes = compact_model(*planes.view(np.int32), counts, chunk, slots)
    assert (writes == 1).all()
    want = jpk.mxu_compact_slots(
        jnp.asarray(planes[0]), jnp.asarray(planes[1]), jnp.asarray(counts),
        chunk=chunk, slots=slots,
    )
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g.view(np.uint32), np.asarray(w).view(np.uint32))
    assert got[3] == bool(want[3])


@pytest.mark.parametrize("chunk", [128, 1024, 2048])
def test_compact_model_scalar_path_on_misaligned_counts(chunk):
    """Counts off a 16-byte boundary take one lane a thread; the result
    is the vector path's."""
    rng = np.random.default_rng(5)
    runs = _runs("uniform", 4_001, rng, True)
    assert lanes_per_thread(chunk, False) == 1
    assert lanes_per_thread(chunk, True) == 4
    vec = compact_model(*map(_np, runs), chunk=chunk, slots=128)
    sca = compact_model(*map(_np, runs), chunk=chunk, slots=128, aligned=False)
    for a, b in zip(vec[:3] + vec[4:], sca[:3] + sca[4:]):
        np.testing.assert_array_equal(a, b)
    assert vec[3] == sca[3]


def test_compact_model_overflow_keeps_first_flags():
    """More flags than slots: slot j still holds the j-th flagged entry,
    and ok is False."""
    counts = np.zeros(8192, np.int32)
    counts[:200] = np.arange(1, 201)
    lo = np.arange(8192, dtype=np.int32)
    _, lo_c, c_c, ok, writes = compact_model(None, lo, counts)
    assert not ok and (writes == 1).all()
    assert lo_c[:128].tolist() == list(range(128))
    assert c_c[:128].tolist() == list(range(1, 129))
    assert not c_c[128:].any()


def test_compact_model_short_stream():
    """A stream shorter than one chunk pads to a whole 8-chunk group."""
    counts = np.array([0, 3, 0, 1, 2], np.int32)
    lo = np.arange(5, dtype=np.int32) + 10
    _, lo_c, c_c, ok, writes = compact_model(None, lo, counts, chunk=32, slots=4)
    assert ok and lo_c.size == GROUP * 4 and (writes == 1).all()
    assert lo_c[:4].tolist() == [11, 13, 14, 0] and c_c[:4].tolist() == [3, 1, 2, 0]


# ---------------------------------------------------------------------------
# merge_spectra.cu
# ---------------------------------------------------------------------------

MERGE_THREADS = 256
MERGE_ITEMS = 8


def merge_path(a, b, d):
    """Number of A's keys among the first d of the merge, ties A first."""
    lo, hi = max(0, d - len(b)), min(d, len(a))
    while lo < hi:
        mid = (lo + hi) // 2
        if a[mid] <= b[d - 1 - mid]:
            lo = mid + 1
        else:
            hi = mid
    return lo


def merge_model(ak, ac, bk, bc, threads=MERGE_THREADS, items=MERGE_ITEMS):
    """The kernel's four launches over int64 arrays: ``(keys, counts,
    n_out)``, each output slot written once.  Shared memory is a dict
    holding only what the tile loaded, so a read of a key that was not
    loaded raises."""
    tile = threads * items
    na, nb = len(ak), len(bk)
    total = na + nb
    tiles = -(-total // tile)
    splits = [merge_path(ak, bk, min(t * tile, total)) for t in range(tiles + 1)]

    def merge_tile(t):
        i0, i1 = splits[t], splits[t + 1]
        j0, j1 = t * tile - i0, min(t * tile + tile, total) - i1
        la, lb = i1 - i0, j1 - j0
        sk, sc = {}, {}
        for x in range(la + lb):
            if x < la:
                sk[1 + x], sc[1 + x] = ak[i0 + x], ac[i0 + x]
            else:
                sk[3 + x], sc[3 + x] = bk[j0 + x - la], bc[j0 + x - la]
        if i0 > 0:
            sk[0] = ak[i0 - 1]
        if i1 < na:
            sk[1 + la], sc[1 + la] = ak[i1], ac[i1]
        if j0 > 0:
            sk[2 + la] = bk[j0 - 1]
        if j1 < nb:
            sk[3 + la + lb], sc[3 + la + lb] = bk[j1], bc[j1]
        sa = lambda i: sk[1 + i]  # noqa: E731
        sb = lambda i: sk[3 + la + i]  # noqa: E731
        per_thread = []
        for tid in range(threads):
            diag = min(tid * items, la + lb)
            lo, hi = max(0, diag - lb), min(diag, la)
            while lo < hi:
                mid = (lo + hi) // 2
                if sa(mid) <= sb(diag - 1 - mid):
                    lo = mid + 1
                else:
                    hi = mid
            ai, bi = lo, diag - lo
            prev = None
            if i0 + ai > 0:
                prev = sa(ai - 1)
            if j0 + bi > 0:
                p = sb(bi - 1)
                prev = p if prev is None or p > prev else prev
            out = []
            for _ in range(min(items, la + lb - diag)):
                if bi >= lb or (ai < la and sa(ai) <= sb(bi)):
                    key, c = sa(ai), sc[1 + ai]
                    if j0 + bi < nb and sb(bi) == key:
                        c += sc[3 + la + bi]
                    ai += 1
                else:
                    key, c = sb(bi), sc[3 + la + bi]
                    bi += 1
                out.append((key, c, prev is None or key != prev))
                prev = key
            per_thread.append(out)
        return per_thread

    heads = [sum(h for th in merge_tile(t) for _, _, h in th)
             for t in range(tiles)]
    first = np.concatenate([[0], np.cumsum(heads)]).astype(np.int64)
    n_out = int(first[-1])
    out_k = np.full(total, -7, np.int64)
    out_c = np.full(total, -7, np.int64)
    writes = np.zeros(total, np.int64)
    for t in range(tiles):
        rank = first[t]
        for th in merge_tile(t):
            for key, c, head in th:
                if head:
                    out_k[rank], out_c[rank] = key, c
                    writes[rank] += 1
                    rank += 1
        assert rank == first[t + 1]
    return out_k, out_c, n_out, writes


def _merge_sides(kind, rng, n=3000):
    """Two sorted int64 spectra (distinct keys a side) and their counts."""
    if kind == "overlap":
        pool = np.unique(rng.integers(-(1 << 62), 1 << 62, 2 * n))
        a = np.sort(rng.choice(pool, n, replace=False))
        b = np.sort(np.concatenate([rng.choice(a, n // 3, replace=False),
                                    rng.choice(pool, n // 3)]))
        b = np.unique(b)
    elif kind == "identical":
        a = np.unique(rng.integers(-(1 << 40), 1 << 40, n))
        b = a.copy()
    elif kind == "disjoint":
        a = np.arange(n, dtype=np.int64) * 2
        b = a + 1
    elif kind == "a_empty":
        a, b = np.zeros(0, np.int64), np.unique(rng.integers(0, 1 << 20, n))
    elif kind == "b_short":
        a, b = np.unique(rng.integers(0, 1 << 20, n)), np.array([5], np.int64)
    else:  # "blocks": long stretches of one side, then equal keys
        a = np.concatenate([np.arange(0, 2500), np.arange(5000, 5100)])
        b = np.concatenate([np.arange(2499, 5001), np.arange(5099, 5200)])
    a, b = a.astype(np.int64), b.astype(np.int64)
    return (a, rng.integers(1, 1000, a.size), b, rng.integers(1, 1000, b.size))


@pytest.mark.parametrize("threads,items", [(MERGE_THREADS, MERGE_ITEMS), (4, 3), (1, 1)])
@pytest.mark.parametrize("kind", ["overlap", "identical", "disjoint",
                                  "a_empty", "b_short", "blocks"])
def test_merge_model_matches_plain(kind, threads, items):
    """Tile edges fall inside runs of equal keys, on each side's first and
    last keys, and between A's key and B's equal one."""
    ak, ac, bk, bc = _merge_sides(kind, np.random.default_rng(len(kind)))
    if threads == 1 and ak.size + bk.size > 600:
        ak, ac, bk, bc = ak[:200], ac[:200], bk[:250], bc[:250]
    out_k, out_c, n_out, writes = merge_model(ak, ac, bk, bc, threads, items)
    want = tk.merge_sorted_counts_plain(*(torch.from_numpy(x) for x in (ak, ac, bk, bc)))
    assert n_out == int(want[2])
    np.testing.assert_array_equal(out_k[:n_out], want[0].numpy())
    np.testing.assert_array_equal(out_c[:n_out], want[1].numpy())
    assert (writes[:n_out] == 1).all() and (writes[n_out:] == 0).all()
    assert int(out_c[:n_out].sum()) == int(ac.sum() + bc.sum())


# ---------------------------------------------------------------------------
# run_counts.cu
# ---------------------------------------------------------------------------

RUN_THREADS = 256
RUN_ITEMS = 4
WARP = 32
NO_HEAD = (1 << 63) - 1


def run_end_model(keys, n, lo, key):
    """``run_end``: the first position past ``lo`` (whose key is ``key``)
    that is ``n`` or holds another key, 32 probes a step at strides
    growing, then narrowing, 32-fold; and the number of steps."""
    lanes = np.arange(1, WARP + 1)

    def ends(probes):
        return [bool(p >= n or keys[p] != key) for p in probes]

    stride, steps = 1, 0
    while True:
        hit = ends(lo + lanes * stride)
        steps += 1
        if any(hit):
            f = hit.index(True)
            hi = lo + (f + 1) * stride
            lo += f * stride
            break
        lo += WARP * stride
        stride *= WARP
    hi = min(hi, n)
    while hi - lo > 1:
        s = -(-(hi - lo) // WARP)
        hit = ends(np.minimum(lo + lanes * s, hi))
        steps += 1
        f = hit.index(True)
        lo, hi = lo + f * s, min(hi, lo + (f + 1) * s)
    return hi, steps


def run_counts_model(keys, wide, threads=RUN_THREADS, items=RUN_ITEMS):
    """The kernel's steps over int64 sorted packed keys: ``(counts, writes,
    searches)``, ``writes`` the number of writers of each output lane and
    ``searches`` the ``(tile, steps)`` of each search past a tile."""
    n = keys.size
    sentinel = (1 << 63) - 1 if wide else 0xFFFFFFFF
    tile = threads * items
    counts = np.zeros(n, np.int64)
    writes = np.zeros(n, np.int64)
    searches = []
    for t0 in range(0, n, tile):
        p = t0 + np.arange(tile)
        key = np.where(p < n, keys[np.minimum(p, n - 1)], sentinel)
        prev = np.where((p > 0) & (p <= n), keys[np.clip(p - 1, 0, n - 1)], 0)
        head = np.where(p < n, (p == 0) | (key != prev), p == n)
        head = head.reshape(threads, items)
        key = key.reshape(threads, items)
        base = t0 + items * np.arange(threads)
        has = head.any(1)
        first = np.where(has, base + head.argmax(1), NO_HEAD)
        # the ballot in each warp, then the table of each warp's first head
        nxt = np.full(threads, NO_HEAD)
        for w0 in range(0, threads, WARP):
            seen = NO_HEAD
            for t in range(w0 + WARP - 1, w0 - 1, -1):
                nxt[t] = seen
                if has[t]:
                    seen = first[t]
        warp_first = [
            first[w0 + int(has[w0:w0 + WARP].argmax())]
            if has[w0:w0 + WARP].any() else NO_HEAD
            for w0 in range(0, threads, WARP)
        ]
        for t in np.flatnonzero(has & (nxt == NO_HEAD)):
            later = [f for f in warp_first[t // WARP + 1:] if f != NO_HEAD]
            nxt[t] = later[0] if later else NO_HEAD
        last = items - 1 - head[:, ::-1].argmax(1)
        below = head & (base[:, None] + np.arange(items) < n)
        last_key = np.array([
            key[t, np.flatnonzero(below[t])[-1]] if below[t].any() else 0
            for t in range(threads)
        ])
        crosses = (has & (nxt == NO_HEAD) & (base + last < n)
                   & (last_key != sentinel))
        assert crosses.sum() <= 1  # only the tile's last run
        for t in np.flatnonzero(crosses):
            nxt[t], steps = run_end_model(keys, n, t0 + tile - 1, last_key[t])
            searches.append((t0 // tile, steps))
        for t in range(threads):
            after = nxt[t]
            for i in range(items - 1, -1, -1):
                q = base[t] + i
                if q < n:
                    if head[t, i] and key[t, i] != sentinel:
                        assert after != NO_HEAD
                        counts[q] = after - q
                    writes[q] += 1
                if head[t, i]:  # position n too
                    after = q
    return counts.astype(np.int32), writes, searches


def _run_streams():
    from needletail_tpu_torch.utils.synth import run_count_streams

    return [(name, wide) for wide in (True, False)
            for name in run_count_streams(np.random.default_rng(0), wide)]


@pytest.mark.parametrize("name,wide", _run_streams())
def test_run_counts_model_matches_plain(name, wide):
    """The model over the run-count edge cases equals the plain version,
    every lane written once; a search past a tile takes a few steps even
    for a run of 2^20 lanes."""
    from needletail_tpu_torch.utils.synth import run_count_streams

    keys = run_count_streams(np.random.default_rng(len(name)), wide)[name]
    counts, writes, searches = run_counts_model(keys, wide)
    want = tk.run_counts_plain(torch.from_numpy(keys), wide)
    np.testing.assert_array_equal(counts, want[2].numpy())
    assert (writes == 1).all()
    assert all(steps <= 8 for _, steps in searches)


@pytest.mark.parametrize("threads,items", [(RUN_THREADS, RUN_ITEMS), (32, 1), (64, 3)])
@pytest.mark.parametrize("n", [1, 5, 127, 1000, 4099])
def test_run_counts_model_ragged(threads, items, n):
    """Ragged lengths and other tile shapes, runs of 1-600 lanes ending
    with and without sentinel padding."""
    rng = np.random.default_rng(n + threads)
    keys = np.sort(rng.integers(0, max(n // 50, 1) + 1, n)).astype(np.int64)
    keys[n - n // 3:] = 0xFFFFFFFF
    counts, writes, _ = run_counts_model(keys, False, threads, items)
    want = tk.run_counts_plain(torch.from_numpy(keys), False)
    np.testing.assert_array_equal(counts, want[2].numpy())
    assert (writes == 1).all()


@pytest.mark.parametrize("run", [1, 31, 32, 33, 1023, 1024, 1025, 40_000])
def test_run_end_model_finds_the_end(run):
    """The search from inside a run of ``run`` lanes, at every start."""
    keys = np.array([5] * 3 + [9] * run + [12, 12], np.int64)
    for lo in {3, 3 + run // 2, 3 + run - 1}:
        end, steps = run_end_model(keys, keys.size, lo, 9)
        assert end == 3 + run
        assert steps <= 2 * max(1, int(np.ceil(np.log(run + 1) / np.log(32)))) + 1
    end, _ = run_end_model(keys[:3 + run], 3 + run, 3, 9)
    assert end == 3 + run  # the run ends the stream


# ---------------------------------------------------------------------------
# chip_smoke.py's device profile table
# ---------------------------------------------------------------------------


def _chip_smoke():
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_profile", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_device_time_by_name_keeps_names_with_one_prefix():
    """Two kernels whose names share their first 80 characters stay two
    entries; the triples of one name add up."""
    by_name = _chip_smoke().device_time_by_name
    prefix = "void at::native::(anonymous namespace)::radixSortKVInPlace<" + "x" * 40
    a, b = prefix + "<int, 1>", prefix + "<long, 2>"
    assert a[:80] == b[:80]
    got = by_name([(a, 1500.0, 3), (b, 2500.0, 1), (a, 500.0, 2),
                   ("copy", 0.0, 4)])
    assert got == {b: [2.5, 1], a: [2.0, 5]}
    assert list(got) == [b, a]  # largest first
