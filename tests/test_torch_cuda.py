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
from needletail_tpu_torch.utils.synth import packed_batch, random_reads

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
