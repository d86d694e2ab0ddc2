"""The port's last two kernels' functions against the JAX package's.

``canonical_hash_tally`` (the tally mode of ``csrc/hash_keys.cu``) against
JAX's Pallas ``canonical_hash_tally`` in interpret mode, and
``bitonic_block_sort`` (``csrc/block_sort.cu``) against the experiment's
Pallas ``bitonic_block_sort`` in TPU interpret mode, on the same seeded
inputs.  On the CPU the port runs the plain versions; the CUDA kernels are
held against those on the card (``tests/test_torch_cuda.py``).  All
integer, so the tolerance is 0.
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from needletail_tpu.device.pallas_kernels import canonical_hash_tally as jtally
from needletail_tpu_torch.device import kernels as tk

REPO = Path(__file__).resolve().parent.parent


def _random_batch(b, l, seed, alphabet=b"ACGTNacgtu"):
    rng = np.random.default_rng(seed)
    seqs = rng.choice(list(alphabet), size=(b, l)).astype(np.uint8)
    lengths = rng.integers(0, l + 1, size=b).astype(np.int32)
    return seqs, lengths


@pytest.mark.parametrize("k,normalized", [
    (2, True), (16, True), (21, True), (31, True), (21, False),
])
def test_hash_tally_matches_jax(k, normalized):
    seqs, lengths = _random_batch(64, 128, seed=k)
    want = jtally(jnp.asarray(seqs), jnp.asarray(lengths), k, table_bits=16,
                  normalized=normalized)
    got = tk.canonical_hash_tally(torch.from_numpy(seqs),
                                  torch.from_numpy(lengths), k, 16, normalized)
    for name, a, b in zip(("idx", "weight"), got, want):
        assert a.dtype == torch.int32, name
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    assert (int(got[2]), int(got[3])) == (int(want[2]), int(want[3]))
    # lanes from L-k+1 on start no window: weight 0 and idx 0
    assert not got[1][:, 128 - k + 1:].any() and not got[0][:, 128 - k + 1:].any()


def test_hash_tally_block_rows():
    seqs, lengths = _random_batch(100, 128, seed=0)
    s, ln = torch.from_numpy(seqs), torch.from_numpy(lengths)
    for bad in (256, 3, 0):
        with pytest.raises(ValueError):
            tk.canonical_hash_tally(s, ln, 8, block_rows=bad)
    want = tk.canonical_hash_tally(s, ln, 8)
    for a, b in zip(tk.canonical_hash_tally(s, ln, 8, block_rows=25), want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("k", [4, 21])
def test_weighted_histogram_equals_keys_route(k):
    """``mxu_histogram16(idx, weight)`` of the tally planes is the table
    the -1-masked keys give, as ``tests/test_pallas.py`` holds for JAX."""
    seqs, lengths = _random_batch(64, 128, seed=100 + k)
    s, ln = torch.from_numpy(seqs), torch.from_numpy(lengths)
    idx, w, total, fwd = tk.canonical_hash_tally(s, ln, k, 16)
    keys, total2, fwd2 = tk.canonical_hash_keys(s, ln, k, 16)
    assert (int(total), int(fwd)) == (int(total2), int(fwd2))
    assert torch.equal(keys[w > 0], idx[w > 0]) and (keys[w == 0] == -1).all()
    h = tk.mxu_histogram16(idx, w)
    assert torch.equal(h, tk.mxu_histogram16(keys))
    assert int(h.sum()) == int(total)


@pytest.fixture(scope="module")
def jax_block_sort():
    """The experiment's Pallas ``bitonic_block_sort``, loaded by path."""
    path = REPO / "benchmarks" / "exp_mosaic_sort.py"
    spec = importlib.util.spec_from_file_location("exp_mosaic_sort", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.bitonic_block_sort


@pytest.mark.parametrize("block", [128, 1024])
def test_block_sort_matches_jax(jax_block_sort, block):
    from jax.experimental.pallas import tpu as pltpu

    rng = np.random.default_rng(block)
    keys = rng.integers(0, 1 << 32, 4096, dtype=np.uint32)
    keys[::3] |= np.uint32(1 << 31)  # top bit set: unsigned order
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_block_sort(jnp.asarray(keys), block))
    got = tk.bitonic_block_sort(torch.from_numpy(keys.view(np.int32)), block)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    np.testing.assert_array_equal(
        want, np.sort(keys.reshape(-1, block), axis=1).reshape(-1)
    )


def test_block_sort_rejects_bad_shapes():
    x = torch.zeros(4096, dtype=torch.int32)
    for block in (64, 100, 3 << 8, 8192):
        with pytest.raises(ValueError):
            tk.bitonic_block_sort(x, block)
    with pytest.raises(ValueError):
        tk.bitonic_block_sort(torch.zeros(1000, dtype=torch.int32), 128)
    with pytest.raises(TypeError):
        tk.bitonic_block_sort(torch.zeros(4096, dtype=torch.int64), 128)
    with pytest.raises(TypeError):
        tk.bitonic_block_sort(torch.zeros((32, 128), dtype=torch.int32), 128)


def test_block_sort_edge_keys():
    """All-equal, sorted and reversed keys, and the empty stream."""
    keys = np.random.default_rng(3).integers(0, 1 << 32, 2048, dtype=np.uint32)
    for plane in (np.full(2048, 0xFFFFFFFF, np.uint32), np.sort(keys),
                  np.sort(keys)[::-1].copy()):
        got = tk.bitonic_block_sort(torch.from_numpy(plane.view(np.int32)), 256)
        np.testing.assert_array_equal(
            got.numpy().view(np.uint32),
            np.sort(plane.reshape(-1, 256), axis=1).reshape(-1),
        )
    assert tk.bitonic_block_sort(torch.zeros(0, dtype=torch.int32), 128).numel() == 0
