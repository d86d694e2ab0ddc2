"""The port's transport ops (``needletail_tpu_torch.device.ops``) against the
JAX package's, on real ``wire_frame`` output.

Every input is made with numpy (seeded) or framed from the test corpus and
handed to both packages; the ops are integer, so results must be equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from needletail_tpu.batch import VROW_PAD_INDEX
from needletail_tpu.device import ops as jops
from needletail_tpu.io.fast_batch import fast_read_batches
from needletail_tpu_torch.device import ops as tops
from needletail_tpu_torch.utils.synth import packed_batch, random_reads

FQ = "tests/data/PRJNA271013_head.fq"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in parallel worker processes; torch's intra-op pool
    in each of them would oversubscribe the cores, so these tests run the
    port's CPU path on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same(t, j):
    """Torch tensor (or None) equals the JAX array (or None)."""
    if j is None:
        assert t is None
        return
    assert t is not None
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def _corpus_lean():
    (b,) = fast_read_batches(FQ, batch_size=2000, max_len=128, packed=True)
    return b, 2048


def _all_n(tmp_path):
    f = tmp_path / "alln.fq"
    f.write_bytes(b"@r\nNNNNNNNN\n+\nIIIIIIII\n" * 32)
    (b,) = fast_read_batches(str(f), packed=True)
    return b, 40


def _synthetic(vmode, width, rows=24, seed=7):
    rng = np.random.default_rng(seed + vmode + width)
    dirty = {0: 0.0, 1: 1.0, 2: 0.1}[vmode]
    seqs, lengths = random_reads(rng, rows, width, dirty_frac=dirty)
    return packed_batch(seqs, lengths, vmode), rows + 5


CASES = {
    "corpus-lean-u8": lambda tmp: _corpus_lean(),
    "all-n-dense-u8": _all_n,
    "clean-u8": lambda tmp: _synthetic(0, 64),
    "dense-u8": lambda tmp: _synthetic(1, 64),
    "lean-u8": lambda tmp: _synthetic(2, 64),
    "clean-u16": lambda tmp: _synthetic(0, 264),
    "dense-u16": lambda tmp: _synthetic(1, 264),
    "lean-u16": lambda tmp: _synthetic(2, 264),
}
VMODES = {
    "corpus-lean-u8": 2, "all-n-dense-u8": 1,
    "clean-u8": 0, "dense-u8": 1, "lean-u8": 2,
    "clean-u16": 0, "dense-u16": 1, "lean-u16": 2,
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_unwire_matches_jax(case, tmp_path):
    batch, batch_size = CASES[case](tmp_path)
    buf, layout = batch.wire_frame(batch_size)
    assert layout.vmode == VMODES[case]
    assert layout.len_size == (2 if case.endswith("u16") else 1)
    got = tops.unwire(torch.from_numpy(buf), layout)
    want = jops.unwire(jnp.asarray(buf), layout)
    for t, j in zip(got, want):
        _same(t, j)
    codes, lengths, vbits, vrow_idx, vrows = got
    assert lengths.dtype == torch.int32
    if layout.vmode == 2 and layout.vcap > batch.vrow_idx.shape[0]:
        assert (vrow_idx == int(VROW_PAD_INDEX)).any()


@pytest.mark.parametrize("case", sorted(CASES))
def test_resolve_and_unpack_match_jax(case, tmp_path):
    batch, batch_size = CASES[case](tmp_path)
    buf, layout = batch.wire_frame(batch_size)
    codes, _, vbits, vrow_idx, vrows = tops.unwire(torch.from_numpy(buf), layout)
    jcodes, _, jvbits, jidx, jrows = jops.unwire(jnp.asarray(buf), layout)
    vb = tops.resolve_vbits(vbits, vrow_idx, vrows, batch_size)
    jvb = jops.resolve_vbits(jvbits, jidx, jrows, batch_size)
    _same(vb, jvb)
    out = tops.unpack_codes(codes, vb)
    assert out.dtype == torch.uint8
    _same(out, jops.unpack_codes(jcodes, jvb))


def test_expand_vrows_drops_pad_and_wraps_negative_like_jax():
    rng = np.random.default_rng(3)
    rows = rng.integers(0, 256, (6, 4), dtype=np.uint8)
    idx = np.array([0, 5, -1, 2, int(VROW_PAD_INDEX), 9], dtype=np.int32)
    got = tops.expand_vrows(torch.from_numpy(idx), torch.from_numpy(rows), 7)
    want = jops.expand_vrows(jnp.asarray(idx), jnp.asarray(rows), 7)
    assert got.shape == (7, 4)
    _same(got, want)


@pytest.mark.parametrize("normalized", [True, False])
def test_encode_2bit_matches_jax_on_every_byte(normalized):
    seqs = np.arange(256, dtype=np.uint8).reshape(4, 64)
    got = tops.encode_2bit(torch.from_numpy(seqs), normalized)
    want = jops.encode_2bit(jnp.asarray(seqs), normalized)
    assert got.dtype == torch.uint8
    _same(got, want)


def test_compose_le_int32_lengths():
    """Four-byte lengths (reads longer than 65,535 bases) compose as JAX
    composes them."""
    lens = np.array([0, 1, 70_000, 1 << 24, 123_456_789], dtype="<i4")
    plane = lens.view(np.uint8).reshape(-1, 4)
    got = tops._compose_le(torch.from_numpy(plane.copy()))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jops._compose_le(jnp.asarray(plane)))
    )
    np.testing.assert_array_equal(got.numpy(), lens)
