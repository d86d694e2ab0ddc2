"""The arithmetic of the two CUDA kernels of the port that run only on the
card, modelled in numpy and held against the references.

``csrc/hash_keys.cu`` builds every k-mer window from 32-bit words of a
row's bit stream (base j at bits 2j, its validity at bit j): a warp stages
a 128-lane segment plus the halo of four rows as ten code words and five
validity words each, and each thread makes four lanes of a row from three
code words and two validity words by funnel shifts, a complement (the
reverse complement) and a reversal of the 2-bit groups (the forward
window).  ``csrc/block_sort.cu`` sorts 8,192-lane
tiles by a bitonic network whose strides run in registers, warp shuffles
or a padded shared-memory layout, then merges larger spans pass by pass,
each output chunk finding its inputs by a merge-path co-rank.

The models below follow the kernels' index and bit arithmetic step for
step, written once here; the tests hold them against the port's plain
versions, JAX's ``canonical_key_planes_packed`` (its CPU route, as
``tests/test_torch_kernels.py`` runs it) and ``np.sort``.  The kernels
themselves are held against the plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).  All integer:
tolerance 0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from needletail_tpu.device import pallas_kernels as jpk
from needletail_tpu_torch.device import kernels as tk
from needletail_tpu_torch.utils.synth import packed_rows, random_reads

KS = [1, 16, 17, 21, 31]

# ---------------------------------------------------------------------------
# hash_keys.cu: the window extractor
# ---------------------------------------------------------------------------

SEG = 128  # lanes a warp makes: 32 threads x 4
STAGED = SEG + 32  # 160 staged bases: the segment and a 31-base halo
CODE_WORDS = STAGED // 16  # 32-bit words
VALID_WORDS = STAGED // 32
U32, U64 = np.uint32, np.uint64
PAIR_LOW = U32(0x55555555)
_REV8 = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint8)


def _brev(x):
    """``__brev``: the 32 bits of each word in reverse order."""
    b = np.ascontiguousarray(x).view(np.uint8).reshape(x.shape + (4,))
    return _REV8[b[..., ::-1]].view(U32).reshape(x.shape)


def _pair_reverse(x):
    y = _brev(x)
    return ((y >> U32(1)) & PAIR_LOW) | ((y & PAIR_LOW) << U32(1))


def _funnel(lo, hi, sh):
    """``__funnelshift_r``: the 32 bits of the stream (lo, hi) from bit
    ``sh`` < 32."""
    both = (hi.astype(U64) << U64(32)) | lo.astype(U64)
    return ((both >> U64(sh)) & U64(0xFFFFFFFF)).astype(U32)


def _spread16(x):
    """Bit i of the low 16 bits to bit 2i."""
    v = x.astype(U32) & U32(0xFFFF)
    for s, m in ((8, 0x00FF00FF), (4, 0x0F0F0F0F), (2, 0x33333333),
                 (1, 0x55555555)):
        v = (v | (v << U32(s))) & U32(m)
    return v


def _segment_bytes(plane, start_step, width):
    """``[B, S, width]``: segment ``seg``'s ``width`` bytes of each row of
    ``plane`` from byte ``start_step * seg``, zero past the row."""
    b, n = plane.shape
    segs = -(-max(n, 1) // start_step)
    pad = np.zeros((b, segs * start_step + width), np.uint8)
    pad[:, :n] = plane
    idx = np.arange(segs)[:, None] * start_step + np.arange(width)[None, :]
    return pad[:, idx]


def _stage_packed(codes, vbits, L):
    """Code and validity words of every segment of packed rows, as the
    kernel stages them: bytes from base s0, zero past the row; without a
    validity plane every byte of the row's bases is 0xFF."""
    segs = -(-L // SEG)
    code = _segment_bytes(codes, SEG // 4, STAGED // 4)[:, :segs]
    if vbits is None:
        vbits = np.full((codes.shape[0], -(-L // 8)), 0xFF, np.uint8)
    valid = _segment_bytes(vbits, SEG // 8, STAGED // 8)[:, :segs]
    return (np.ascontiguousarray(code).view(U32),
            np.ascontiguousarray(valid).view(U32))


def _encode(b, normalized):
    """The kernel's 256-entry code table: 0-3, 4 for anything else."""
    up = b & 0xDF
    c = np.full(b.shape, 4, np.uint32)
    c[up == ord("A")] = 0
    c[up == ord("C")] = 1
    c[up == ord("G")] = 2
    c[(up == ord("T")) | (normalized & (up == ord("U")))] = 3
    return c


def _stage_ascii(seqs, L, normalized):
    """The ASCII staging: 32 bases a warp load (byte 0 past L), each
    through the code table, packed by three ballots into the same words as
    packed input: code word j from the ballots of load j // 2."""
    segs = -(-L // SEG)
    raw = _segment_bytes(seqs, SEG, STAGED)[:, :segs]
    pos = np.arange(segs)[:, None] * SEG + np.arange(STAGED)
    c = _encode(np.where(pos < L, raw, 0), normalized)
    c = c.reshape(c.shape[:2] + (VALID_WORDS, 32))
    lane = np.arange(32, dtype=np.uint32)

    def ballot(bit):
        return (bit.astype(np.uint32) << lane).sum(-1, dtype=np.uint64).astype(U32)

    b0, b1, ok = ballot(c & 1), ballot((c >> 1) & 1), ballot(c < 4)
    j = np.arange(CODE_WORDS)
    half = U32(16) * (j & 1).astype(U32)
    code = _spread16(b0[..., j >> 1] >> half) | (
        _spread16(b1[..., j >> 1] >> half) << U32(1))
    return code, ok


def _extract(code, valid, lengths, L, k):
    """``(canonical, ok, use_rc)`` ``[B, L]`` from the staged words: thread
    ``lane`` makes lanes ``4 * lane + i`` of each segment, k <= 16 from one
    word of the field and k > 16 from two."""
    q = np.arange(SEG)
    lane, i = q >> 2, q & 3
    cw, c_sh = lane >> 2, 8 * (lane & 3) + 2 * i
    vw, v_sh = lane >> 3, (4 * lane) % 32 + i
    w0, w1, w2 = code[..., cw], code[..., cw + 1], code[..., cw + 2]
    e_lo = _funnel(w0, w1, c_sh)
    v = _funnel(valid[..., vw], valid[..., vw + 1], v_sh)
    fmask = (1 << (2 * k)) - 1
    lo_mask, hi_mask = U32(fmask & 0xFFFFFFFF), U32(fmask >> 32)
    vmask = U32((1 << k) - 1)
    r_lo = ~e_lo & lo_mask
    if k > 16:
        shift = 64 - 2 * k
        e_hi = _funnel(w1, w2, c_sh)
        r_hi = ~e_hi & hi_mask
        n_hi = _pair_reverse(e_lo)
        f_lo = _funnel(_pair_reverse(e_hi), n_hi, shift)
        f_hi = n_hi >> U32(shift)
    else:
        f_lo = _pair_reverse(e_lo) >> U32(32 - 2 * k)
        f_hi = r_hi = np.zeros_like(f_lo)
    fwd = (f_hi.astype(U64) << U64(32)) | f_lo
    rc = (r_hi.astype(U64) << U64(32)) | r_lo
    b, segs = code.shape[:2]
    p = np.arange(segs)[:, None] * SEG + q
    lim = np.minimum(lengths.astype(np.int64), L)[:, None, None]
    ok = ((v & vmask) == vmask) & (p + k <= lim)
    use_rc = fwd > rc
    canon = np.where(use_rc, rc, fwd)
    cut = lambda a: a.reshape(b, segs * SEG)[:, :L]  # noqa: E731
    return cut(canon), cut(ok), cut(use_rc)


def _outputs(canon, ok, use_rc, table_bits=16):
    """Keys, planes and tally planes of the kernel's three modes, plus the
    two tallies, as int32 / int64 numpy arrays."""
    hi = (canon >> U64(32)).astype(np.uint32)
    lo = (canon & U64(0xFFFFFFFF)).astype(np.uint32)
    h = ((lo * np.uint32(tk.HASH_C1)) ^ (hi * np.uint32(tk.HASH_C2))) & np.uint32(
        (1 << table_bits) - 1
    )
    h = h.view(np.int32)
    return {
        "keys": np.where(ok, h, -1).astype(np.int32),
        "hi": np.where(ok, hi.view(np.int32), -1).astype(np.int32),
        "lo": np.where(ok, lo.view(np.int32), -1).astype(np.int32),
        "idx": np.where(ok, h, 0).astype(np.int32),
        "weight": ok.astype(np.int32),
        "total": int(ok.sum()),
        "fwd": int((ok & ~use_rc).sum()),
    }


def _assert_mode(got, model, parts):
    for g, part in zip(got, parts):
        want = model[part]
        if isinstance(want, int):
            assert int(g) == want, part
        else:
            np.testing.assert_array_equal(np.asarray(g), want, err_msg=part)


@pytest.mark.parametrize("k", KS)
def test_window_words_packed_match_plain(k):
    """Row pitches of 1, 2, 38, 39 and 74 bytes (not multiples of 8),
    widths below k, rows shorter than k, and rows of three segments."""
    rng = np.random.default_rng(500 + k)
    cases = [(40, 4, False), (40, 8, True), (60, 152, True), (60, 156, False),
             (20, 296, True), (20, 296, False)]
    short = False
    for rows, width, has_vbits in cases:
        codes, vbits, lengths = packed_rows(rng, rows, width, float(has_vbits))
        short |= bool((lengths < k).any())
        model = _outputs(*_extract(*_stage_packed(codes, vbits, width),
                                   lengths, width, k))
        args = (torch.from_numpy(codes),
                None if vbits is None else torch.from_numpy(vbits),
                torch.from_numpy(lengths))
        _assert_mode(tk.canonical_key_planes_packed_plain(*args, k), model,
                     ("hi", "lo", "total", "fwd"))
        _assert_mode(tk.canonical_hash_keys_packed_plain(*args, k, 16), model,
                     ("keys", "total", "fwd"))
    assert short or k == 1


def test_window_words_packed_match_jax():
    """The same model against the Pallas planes kernel on JAX's CPU route,
    at every k, over a 38-byte pitch with a validity plane."""
    rng = np.random.default_rng(77)
    codes, vbits, lengths = packed_rows(rng, 8, 152, 1.0)
    code, valid = _stage_packed(codes, vbits, 152)
    for k in KS:
        model = _outputs(*_extract(code, valid, lengths, 152, k))
        got = jpk.canonical_key_planes_packed(
            jnp.asarray(codes), jnp.asarray(vbits), jnp.asarray(lengths), k
        )
        got = [np.asarray(g).view(np.int32) if g.ndim else g for g in got]
        _assert_mode(got, model, ("hi", "lo", "total", "fwd"))


@pytest.mark.parametrize("normalized", [True, False])
def test_window_words_ascii_match_plain(normalized):
    """ASCII staging (case fold, U only when normalized, byte 0 past L) in
    all three modes, at pitches of 150 and 156 bytes, below k and across
    three segments."""
    rng = np.random.default_rng(600 + normalized)
    for rows, width in ((40, 10), (40, 150), (40, 156), (12, 300)):
        seqs, lengths = random_reads(rng, rows, width, dirty_frac=0.5)
        s, ln = torch.from_numpy(seqs), torch.from_numpy(lengths)
        code, valid = _stage_ascii(seqs, width, normalized)
        for k in KS:
            model = _outputs(*_extract(code, valid, lengths, width, k))
            _assert_mode(tk.canonical_hash_keys_plain(s, ln, k, 16, normalized),
                         model, ("keys", "total", "fwd"))
            _assert_mode(tk.canonical_key_planes_plain(s, ln, k, normalized),
                         model, ("hi", "lo", "total", "fwd"))
            _assert_mode(tk.canonical_hash_tally_plain(s, ln, k, 16, normalized),
                         model, ("idx", "weight", "total", "fwd"))


# ---------------------------------------------------------------------------
# block_sort.cu: tile network and merge passes
# ---------------------------------------------------------------------------

R, LOG_R = 16, 4
THREADS = 512
TILE, LOG_TILE = R * THREADS, 13
LOG_WARP_SPAN = LOG_R + 5
CHUNK, PER = 4096, 16  # a merge CTA's outputs, and a merge thread's


def _pad(i):
    return i + (i >> 5)


def _tile_sort(keys, log_b):
    """``tile_kernel``'s network over ``[tiles, 8192]`` uint32: x[t, r] is
    thread t's register r (element 16 t + r); strides below 16 compare
    registers, strides to 256 partner lane ``t ^ m`` (same register), the
    rest go through shared memory as the kernel pairs them there."""
    x = keys.reshape(-1, THREADS, R).copy()
    t = np.arange(THREADS)[:, None]
    r = np.arange(R)[None, :]
    bmask = (1 << log_b) - 1
    for lk in range(1, min(log_b, LOG_TILE) + 1):
        kb = (1 << lk) & bmask
        if lk - 1 >= LOG_WARP_SPAN:
            s = x.reshape(-1, TILE)
            p = np.arange(TILE // 2)  # q * 512 + t over q < 8, t < 512
            for lj in range(lk - 1, LOG_WARP_SPAN - 1, -1):
                j = 1 << lj
                i = ((p & ~(j - 1)) << 1) | (p & (j - 1))
                a, b = s[:, i], s[:, i + j]
                asc = (i & kb) == 0
                s[:, i] = np.where(asc, np.minimum(a, b), np.maximum(a, b))
                s[:, i + j] = np.where(asc, np.maximum(a, b), np.minimum(a, b))
            x = s.reshape(-1, THREADS, R)
        asc = ((t * R) & kb) == 0
        lane = t & 31
        for lj in range(min(lk - 1, LOG_WARP_SPAN - 1), LOG_R - 1, -1):
            m = 1 << (lj - LOG_R)
            partner = np.arange(THREADS) ^ m
            assert (partner >> 5 == np.arange(THREADS) >> 5).all()
            other = x[:, partner, :]
            keep_min = asc == ((lane & m) == 0)
            x = np.where(keep_min, np.minimum(x, other), np.maximum(x, other))
        for lj in range(min(lk - 1, LOG_R - 1), -1, -1):
            j = 1 << lj
            for rr in range(R):
                if rr & j:
                    continue
                up = ((((t * R) | rr) & kb) == 0)[:, 0]
                a, b = x[:, :, rr].copy(), x[:, :, rr | j].copy()
                x[:, :, rr] = np.where(up, np.minimum(a, b), np.maximum(a, b))
                x[:, :, rr | j] = np.where(up, np.maximum(a, b), np.minimum(a, b))
    return x.reshape(-1)


def _co_rank(src, a0, na, b0, nb, d):
    """Vectorized ``co_rank``: outputs of ``d`` taken from run a, ties to
    a, with run a at ``src[a0:a0 + na]`` and run b at ``src[b0:b0 + nb]``."""
    lo = np.maximum(d - nb, 0)
    hi = np.minimum(d, na)
    while (lo < hi).any():
        act = lo < hi
        mid = (lo + hi) >> 1
        ia = np.where(act, a0 + mid, 0)
        ib = np.where(act, b0 + d - 1 - mid, 0)
        take = src[ia] <= src[ib]
        lo = np.where(act & take, mid + 1, lo)
        hi = np.where(act & ~take, mid, hi)
    return lo


def _merge_pass(src, run):
    """``split_kernel`` then ``merge_kernel``: every pair of sorted runs of
    ``run`` lanes into one, chunk by chunk, thread by thread."""
    n = src.size
    chunks = n // CHUNK
    g = np.arange(chunks) * CHUNK
    pair = g & ~(2 * run - 1)
    split = _co_rank(src, pair, run, pair + run, run, g - pair)
    d0 = g - pair
    i1 = np.where(d0 + CHUNK == 2 * run, run, np.append(split[1:], 0))
    na = i1 - split
    dst = np.empty_like(src)
    for c in range(chunks):
        a = src[pair[c] + split[c]: pair[c] + i1[c]]
        b = src[pair[c] + run + d0[c] - split[c]:][: CHUNK - na[c]]
        s = np.concatenate([a, b])
        d = np.arange(CHUNK // PER) * PER
        ai = _co_rank(s, 0, na[c], na[c], CHUNK - na[c], d)
        bi = d - ai
        out = np.empty((d.size, PER), src.dtype)
        for m in range(PER):
            av = s[np.where(ai < na[c], ai, 0)]
            bv = s[np.where(bi < CHUNK - na[c], na[c] + bi, 0)]
            take_a = (ai < na[c]) & ((bi >= CHUNK - na[c]) | (av <= bv))
            out[:, m] = np.where(take_a, av, bv)
            ai = ai + take_a
            bi = bi + ~take_a
        dst[g[c]: g[c] + CHUNK] = out.reshape(-1)
    return dst


def _keys(case, n, rng):
    rand = rng.integers(0, 1 << 32, n, dtype=np.uint32)
    return {
        "random": rand,
        "top bit": rand | np.uint32(1 << 31),
        "all equal": np.full(n, 0x9E3779B1, np.uint32),
        "few distinct": (rand % np.uint32(5)) * np.uint32(0x7FFFFFFF),
        "sorted": np.sort(rand),
        "reversed": np.sort(rand)[::-1].copy(),
    }[case]


CASES = ["random", "top bit", "all equal", "few distinct", "sorted", "reversed"]


@pytest.mark.parametrize("case", CASES)
def test_merge_pass_matches_np_sort(case):
    """Two sorted runs of 8,192 (the first merge pass) and of 16,384 lanes
    merged by co-rank splits and per-thread merges equal ``np.sort``."""
    rng = np.random.default_rng(CASES.index(case))
    for run in (TILE, 2 * TILE):
        src = _keys(case, 4 * run, rng).reshape(-1, run)
        src = np.sort(src, axis=1).reshape(-1)
        got = _merge_pass(src, run)
        want = np.sort(src.reshape(-1, 2 * run), axis=1).reshape(-1)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("block", [128, 1024, TILE, 1 << 15])
def test_tile_sort_and_merges_match_np_sort(block):
    """The whole kernel: tiles (a short one padded with all-ones keys),
    then log2(block / 8192) merge passes."""
    rng = np.random.default_rng(block)
    n = max(block, 1 << 15) * 2
    log_b = block.bit_length() - 1
    for case in ("random", "few distinct", "reversed"):
        x = _keys(case, n, rng)
        tiles = -(-n // TILE)
        pad = np.full(tiles * TILE, 0xFFFFFFFF, np.uint32)
        pad[:n] = x
        out = _tile_sort(pad.reshape(tiles, TILE), log_b)[:n]
        run = TILE
        while run < block:
            out = _merge_pass(out, run)
            run *= 2
        want = np.sort(x.reshape(-1, block), axis=1).reshape(-1)
        np.testing.assert_array_equal(out, want, err_msg=case)
    # a tile padded past the input's end: spans of 128 in 1,024 lanes
    if block == 128:
        x = _keys("random", 1024, rng)
        pad = np.full(TILE, 0xFFFFFFFF, np.uint32)
        pad[:1024] = x
        np.testing.assert_array_equal(
            _tile_sort(pad[None], log_b)[:1024],
            np.sort(x.reshape(-1, 128), axis=1).reshape(-1),
        )


def test_padded_layout_has_no_bank_conflict():
    """One word of padding per 32: a warp's register loads (thread t
    reads 16 t + r) and its pairs of a shared-memory stage each hit 32
    distinct banks."""
    t = np.arange(32)
    for warp in range(THREADS // 32):
        tt = warp * 32 + t
        for r in range(R):
            assert np.unique(_pad(tt * R + r) % 32).size == 32
    for lj in range(LOG_WARP_SPAN, LOG_TILE):
        j = 1 << lj
        for q in range(R // 2):
            for warp in range(THREADS // 32):
                p = q * THREADS + warp * 32 + t
                i = ((p & ~(j - 1)) << 1) | (p & (j - 1))
                assert np.unique(_pad(i) % 32).size == 32
                assert np.unique(_pad(i + j) % 32).size == 32
