"""The port's kernels (``needletail_tpu_torch.device.kernels``) against the
JAX package's Pallas kernels.

On the CPU a wrapper runs its kernel's plain PyTorch version; JAX runs its
Pallas kernels in interpret mode, as its own tests do.  Inputs come from a
seeded numpy generator and go to both.  The path is all integer, so the
tolerance is 0: keys, tallies and histograms must be equal.  The CUDA
kernels themselves are held against the plain versions on a GPU
(``tests/test_torch_cuda.py`` and ``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from needletail_tpu.device import pallas_kernels as jk
from needletail_tpu_torch.device import kernels as tk
from needletail_tpu_torch.device.ops import resolve_vbits, unwire
from needletail_tpu_torch.utils.synth import packed_batch, random_reads

KS = [1, 5, 16, 17, 21, 31]
ROWS, WIDTH = 12, 72


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in parallel worker processes; torch's intra-op pool
    in each of them would oversubscribe the cores, so these tests run the
    port's CPU path on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _assert_keys_equal(got, want):
    keys, total, fwd = got
    jkeys, jtotal, jfwd = want
    assert keys.dtype == torch.int32
    np.testing.assert_array_equal(keys.numpy(), np.asarray(jkeys))
    assert int(total) == int(jtotal)
    assert int(fwd) == int(jfwd)


@pytest.mark.parametrize("normalized", [True, False])
@pytest.mark.parametrize("k", KS)
def test_hash_keys_ascii_matches_jax(k, normalized):
    rng = np.random.default_rng(100 + k)
    seqs, lengths = random_reads(rng, ROWS, WIDTH, dirty_frac=0.5)
    table_bits = 16 if k % 2 else 20
    got = tk.canonical_hash_keys(
        torch.from_numpy(seqs), torch.from_numpy(lengths), k,
        table_bits=table_bits, normalized=normalized,
    )
    want = jk.canonical_hash_keys(
        jnp.asarray(seqs), jnp.asarray(lengths), k,
        table_bits=table_bits, normalized=normalized,
    )
    _assert_keys_equal(got, want)
    assert int(got[1]) > 0


@pytest.mark.parametrize("vmode", [0, 1, 2])
@pytest.mark.parametrize("k", KS)
def test_hash_keys_packed_matches_jax(k, vmode):
    rng = np.random.default_rng(200 + 3 * k + vmode)
    dirty = {0: 0.0, 1: 1.0, 2: 0.2}[vmode]
    seqs, lengths = random_reads(rng, ROWS, WIDTH, dirty_frac=dirty)
    batch = packed_batch(seqs, lengths, vmode)
    buf, layout = batch.wire_frame(ROWS)
    codes, ln, vbits, vrow_idx, vrows = unwire(torch.from_numpy(buf), layout)
    vb = resolve_vbits(vbits, vrow_idx, vrows, ROWS)
    got = tk.canonical_hash_keys_packed(codes, vb, ln, k, table_bits=16)
    dense = batch.dense_vbits()
    want = jk.canonical_hash_keys_packed(
        jnp.asarray(batch.codes),
        None if dense is None else jnp.asarray(dense),
        jnp.asarray(lengths), k, table_bits=16,
    )
    _assert_keys_equal(got, want)
    # the packed transport equals the ASCII path under the pack's mode
    ascii_keys = tk.canonical_hash_keys(
        torch.from_numpy(seqs), torch.from_numpy(lengths), k, table_bits=16
    )
    for a, b in zip(got, ascii_keys):
        assert torch.equal(a, b)


def test_hash_keys_zero_length_and_short_rows():
    seqs = np.zeros((3, 8), np.uint8)
    seqs[1, :3] = np.frombuffer(b"ACG", np.uint8)
    lengths = np.array([0, 3, 0], np.int32)
    keys, total, fwd = tk.canonical_hash_keys(
        torch.from_numpy(seqs), torch.from_numpy(lengths), 5
    )
    assert (keys == -1).all() and int(total) == 0 and int(fwd) == 0


@pytest.mark.parametrize("k", [0, 32])
def test_k_out_of_range_raises(k):
    seqs = torch.zeros((2, 8), dtype=torch.uint8)
    lengths = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="k must be"):
        tk.canonical_hash_keys(seqs, lengths, k)
    with pytest.raises(ValueError, match="k must be"):
        tk.canonical_hash_keys_packed(seqs[:, :2], None, lengths, k)
    with pytest.raises(ValueError, match="k must be"):
        jk.canonical_hash_keys(jnp.asarray(seqs.numpy()), jnp.zeros(2, jnp.int32), k)


def test_hash_count_file_table_bits_over_16_raises():
    from needletail_tpu_torch.device.pipeline import hash_count_file

    with pytest.raises(ValueError, match="table_bits"):
        hash_count_file("tests/data/PRJNA271013_head.fq", 21, table_bits=17,
                        device="cpu")


def test_wrapper_rejects_wrong_dtype_and_shape():
    seqs = torch.zeros((2, 8), dtype=torch.uint8)
    with pytest.raises(TypeError, match="lengths"):
        tk.canonical_hash_keys(seqs, torch.zeros(2, dtype=torch.int64), 5)
    with pytest.raises(ValueError, match="lengths"):
        tk.canonical_hash_keys(seqs, torch.zeros(3, dtype=torch.int32), 5)
    with pytest.raises(ValueError, match="vbits"):
        tk.canonical_hash_keys_packed(
            seqs[:, :2], torch.zeros((2, 2), dtype=torch.uint8),
            torch.zeros(2, dtype=torch.int32), 5,
        )


def _hist_inputs():
    rng = np.random.default_rng(11)
    uniform = rng.integers(0, 1 << 16, (8, 1024), dtype=np.int32)
    return {
        "uniform": uniform,
        "skewed": np.full((8, 1024), 4242, np.int32),
        "mostly-invalid": np.where(
            rng.random((8, 1024)) < 0.9, -1, uniform
        ).astype(np.int32),
        "all-invalid": np.full((8, 1024), -1, np.int32),
        "ragged": uniform[:5, :333].copy(),
    }


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("case", sorted(_hist_inputs()))
def test_histogram_matches_jax(case, weighted):
    keys = _hist_inputs()[case]
    weight = None
    if weighted:
        weight = np.random.default_rng(5).integers(
            -1, 2, keys.shape, dtype=np.int32
        )
    got = tk.mxu_histogram16(
        torch.from_numpy(keys),
        None if weight is None else torch.from_numpy(weight),
    )
    want = jk.mxu_histogram16(
        jnp.asarray(keys), None if weight is None else jnp.asarray(weight),
        chunk=4096, sub=1024,
    )
    assert got.dtype == torch.int32 and got.shape == (1 << 16,)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_histogram_of_hash_keys_matches_jax():
    """The two kernels chained, as one hash-count step runs them."""
    rng = np.random.default_rng(21)
    seqs, lengths = random_reads(rng, ROWS, WIDTH, dirty_frac=0.3)
    keys, _, _ = tk.canonical_hash_keys(
        torch.from_numpy(seqs), torch.from_numpy(lengths), 21, table_bits=16
    )
    jkeys, _, _ = jk.canonical_hash_keys(
        jnp.asarray(seqs), jnp.asarray(lengths), 21, table_bits=16
    )
    np.testing.assert_array_equal(
        tk.mxu_histogram16(keys).numpy(),
        np.asarray(jk.mxu_histogram16(jkeys, None, chunk=4096, sub=1024)),
    )


def test_histogram_rejects_non_int32():
    with pytest.raises(TypeError, match="int32"):
        tk.mxu_histogram16(torch.zeros(4, dtype=torch.int64))

