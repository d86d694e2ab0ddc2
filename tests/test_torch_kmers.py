"""The port's k-mer windows (``device/kmers.py``) against the JAX package's.

Both take the same seeded reads (dirty bases, ragged lengths, U and IUPAC
codes); the valid mask and ``was_rc`` must be equal everywhere, and the
(hi, lo) planes wherever a window is valid (JAX leaves ladder residue in
invalid lanes).  Integer code: tolerance 0.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from needletail_tpu.device import kmers as jk
from needletail_tpu.device import ops as jops
from needletail_tpu_torch.device import kmers as tkm
from needletail_tpu_torch.device import ops as tops
from needletail_tpu_torch.utils.synth import random_reads

KS = [1, 4, 15, 16, 17, 21, 31]


@pytest.fixture(scope="module")
def reads():
    rng = np.random.default_rng(2026)
    return random_reads(rng, 24, 72, dirty_frac=0.5)


def _assert_windows_equal(got, want):
    valid = np.asarray(want.valid)
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    np.testing.assert_array_equal(got.was_rc.numpy(), np.asarray(want.was_rc))
    for name in ("hi", "lo"):
        w = np.asarray(getattr(want, name)).view(np.int32)
        g = getattr(got, name)
        assert g.dtype == torch.int32 and g.shape == w.shape
        np.testing.assert_array_equal(g.numpy()[valid], w[valid], err_msg=name)


@pytest.mark.parametrize("normalized", [True, False])
@pytest.mark.parametrize("fn", ["pack_kmers", "canonical_kmers"])
@pytest.mark.parametrize("k", KS)
def test_windows_match_jax(reads, fn, k, normalized):
    seqs, lengths = reads
    got = getattr(tkm, fn)(
        torch.from_numpy(seqs), torch.from_numpy(lengths), k,
        normalized=normalized,
    )
    want = getattr(jk, fn)(
        jnp.asarray(seqs), jnp.asarray(lengths), k, normalized=normalized
    )
    _assert_windows_equal(got, want)
    if k <= 16:
        assert not got.hi[got.valid].any()


@pytest.mark.parametrize("fn", ["pack_kmers", "canonical_kmers"])
@pytest.mark.parametrize("k", [4, 16, 17, 31])
def test_precoded_windows_match_jax(reads, fn, k):
    """``precoded=True`` over per-base codes (255 invalid), as the packed
    wire unpacks them."""
    seqs, lengths = reads
    tcodes = tops.encode_2bit(torch.from_numpy(seqs), True)
    jcodes = jops.encode_2bit(jnp.asarray(seqs), normalized=True)
    np.testing.assert_array_equal(tcodes.numpy(), np.asarray(jcodes))
    got = getattr(tkm, fn)(tcodes, torch.from_numpy(lengths), k, precoded=True)
    want = getattr(jk, fn)(jcodes, jnp.asarray(lengths), k, precoded=True)
    _assert_windows_equal(got, want)


@pytest.mark.parametrize("k", [1, 15, 31])
def test_window_validity_matches_jax(reads, k):
    seqs, lengths = reads
    codes = tops.encode_2bit(torch.from_numpy(seqs), True)
    got = tkm.window_validity(codes, torch.from_numpy(lengths), k)
    want = jk.window_validity(
        jnp.asarray(codes.numpy()).astype(jnp.uint32), jnp.asarray(lengths), k
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_canonical_is_min_of_strands():
    """A tie keeps forward: a reverse-complement palindrome is not rc."""
    seqs = np.frombuffer(b"ACGT" + b"AAAA" + b"TTTT", np.uint8).reshape(3, 4).copy()
    lengths = np.full(3, 4, np.int32)
    w = tkm.canonical_kmers(torch.from_numpy(seqs), torch.from_numpy(lengths), 4)
    # ACGT is its own reverse complement; TTTT canonicalizes to AAAA
    assert w.lo[:, 0].tolist() == [0b00011011, 0, 0]
    assert w.was_rc[:, 0].tolist() == [False, False, True]


def test_bad_k_raises(reads):
    seqs, lengths = reads
    for k in (0, 32, 73):
        with pytest.raises(ValueError):
            tkm.pack_kmers(torch.from_numpy(seqs), torch.from_numpy(lengths), k)
