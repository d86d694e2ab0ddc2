"""The port's quality path against the JAX package's.

The byte ops of ``device/ops.py`` on all 256 byte values, quality masking
at thresholds outside the uint8 range (JAX compares in int32, where a bare
PyTorch compare would wrap the threshold into uint8), ``device/quality.py``
(mean qualities exactly, in float32, empty reads included), the card's
route modelled on the CPU (the key-plane kernel's plain version over the
masked bytes), and the drivers end to end: ``count_file`` and
``multi_k_count_file`` under ``quality_cutoff`` and ``quality_filter_file``
byte for byte.  Integer code and float32 means: tolerance 0.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from needletail_tpu.device import count as jcount
from needletail_tpu.device import ops as jops
from needletail_tpu.device import pipeline as jpipe
from needletail_tpu.device import quality as jq
from needletail_tpu_torch.device import ops as tops
from needletail_tpu_torch.device import pipeline as tpipe
from needletail_tpu_torch.device import quality as tq
from needletail_tpu_torch.utils.synth import random_reads

FQ = "tests/data/PRJNA271013_head.fq"
RUN = dict(batch_size=512, host_workers=1, max_len=128)
THRESHOLDS = [-7, 0, 53, 300]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in parallel worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def all_bytes():
    """Every byte value in every column position: a [256, 256] plane."""
    return np.stack([np.roll(np.arange(256, dtype=np.uint8), r)
                     for r in range(256)])


@pytest.fixture(scope="module")
def reads_quals():
    """Reads with dirty bases, ragged and empty rows, and quality bytes
    spread over '!'..'J' (Phred 0..41 at offset 33)."""
    rng = np.random.default_rng(71)
    seqs, lengths = random_reads(rng, 40, 96, dirty_frac=0.3)
    lengths[3] = 0
    seqs[3] = 0
    quals = rng.integers(33, 75, seqs.shape).astype(np.uint8)
    quals[np.arange(96)[None, :] >= lengths[:, None]] = 0
    return seqs, lengths, quals


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("iupac", [False, True])
def test_normalize_matches_jax(all_bytes, iupac):
    got, keep = tops.normalize(_t(all_bytes), iupac=iupac)
    want, wkeep = jops.normalize(jnp.asarray(all_bytes), iupac=iupac)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(wkeep))


def test_complement_matches_jax(all_bytes):
    got = tops.complement(_t(all_bytes))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jops.complement(jnp.asarray(all_bytes)))
    )


def test_reverse_complement_matches_jax(all_bytes):
    # every length from 0 to the full width
    lengths = np.arange(256, dtype=np.int32)
    lengths[-1] = 256
    got = tops.reverse_complement(_t(all_bytes), _t(lengths))
    want = jops.reverse_complement(jnp.asarray(all_bytes), jnp.asarray(lengths))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("score", THRESHOLDS)
def test_quality_mask_matches_jax(all_bytes, score):
    seqs = np.full_like(all_bytes, ord("A"))
    got = tops.quality_mask(_t(seqs), _t(all_bytes), score)
    want = jops.quality_mask(
        jnp.asarray(seqs), jnp.asarray(all_bytes), jnp.int32(score)
    )
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    masked = int((got.numpy() == ord("N")).sum())
    assert masked == 256 * min(max(score, 0), 256)


@pytest.mark.parametrize("offset", [33, 64])
def test_decode_phred_matches_jax(all_bytes, offset):
    got, ok = tops.decode_phred(_t(all_bytes), offset)
    want, wok = jops.decode_phred(jnp.asarray(all_bytes), offset)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(wok))


@pytest.mark.parametrize("score", THRESHOLDS)
def test_quality_mask_batch_matches_jax(reads_quals, score):
    seqs, lengths, quals = reads_quals
    got = tq.quality_mask_batch(_t(seqs), _t(quals), _t(lengths), score)
    want = jq.quality_mask_batch(
        jnp.asarray(seqs), jnp.asarray(quals), jnp.asarray(lengths),
        jnp.int32(score),
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("canonical,normalized", [
    (True, True), (False, True), (True, False),
])
@pytest.mark.parametrize("k", [5, 21, 31])
def test_masked_canonical_kmers_match_jax(reads_quals, k, canonical,
                                          normalized):
    seqs, lengths, quals = reads_quals
    got = tq.masked_canonical_kmers(
        _t(seqs), _t(quals), _t(lengths), 53, k, canonical, normalized
    )
    want = jq.masked_canonical_kmers(
        jnp.asarray(seqs), jnp.asarray(quals), jnp.asarray(lengths),
        jnp.int32(53), k, canonical, normalized,
    )
    valid = np.asarray(want.valid)
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    np.testing.assert_array_equal(got.was_rc.numpy(), np.asarray(want.was_rc))
    for name in ("hi", "lo"):
        w = np.asarray(getattr(want, name)).view(np.int32)
        np.testing.assert_array_equal(getattr(got, name).numpy()[valid],
                                      w[valid], err_msg=name)


@pytest.mark.parametrize("offset", [33, 64])
def test_mean_quality_matches_jax_exactly(reads_quals, offset):
    _, lengths, quals = reads_quals
    # quality bytes up to 255 and reads of every length, the empty one too
    rng = np.random.default_rng(offset)
    quals = quals.copy()
    quals[:8] = rng.integers(0, 256, (8, quals.shape[1]), dtype=np.uint8)
    got = tq.mean_quality(_t(quals), _t(lengths), offset)
    want = np.asarray(jq.mean_quality(
        jnp.asarray(quals), jnp.asarray(lengths), jnp.int32(offset)
    ))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))
    assert got[3] == 0.0  # the empty read


@pytest.mark.parametrize("normalized", [True, False])
@pytest.mark.parametrize("k", [21, 31])
def test_card_route_masked_planes_match_jax(reads_quals, k, normalized):
    """The card's route: the key-plane kernel (its plain version here)
    over the quality-masked bytes gives JAX's masked keys."""
    seqs, lengths, quals = reads_quals
    masked = tops.quality_mask(_t(seqs), _t(quals), 53)
    got = tpipe._planes_keys(k, masked, _t(lengths), None, False, normalized)
    want = jcount.mask_keys(jq.masked_canonical_kmers(
        jnp.asarray(seqs), jnp.asarray(quals), jnp.asarray(lengths),
        jnp.int32(53), k, True, normalized,
    ))
    assert got[0] is not None
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w).view(np.int32))


def _equal(got, want):
    assert got[0] == want[0]
    a, b = got[1], want[1]
    if isinstance(b, dict):
        assert a.keys() == b.keys()
        for k in b:
            _equal((0, a[k]), (0, b[k]))
    elif isinstance(b, tuple):
        for x, y in zip(a, b):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
    else:
        assert a.dtype == b.dtype == np.int64
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("k", [9, 21])
def test_count_file_quality_matches_jax(k):
    kw = dict(quality_cutoff=20, sparse_format="arrays", **RUN)
    got = tpipe.count_file(FQ, k, device="cpu", **kw)
    want = jpipe.count_file(FQ, k, **kw)
    _equal(got, want)
    plain = tpipe.count_file(FQ, k, device="cpu", sparse_format="arrays",
                             **RUN)
    counts = lambda r: r[1][1] if isinstance(r[1], tuple) else r[1]  # noqa
    # Q20 masks 7.2% of the bases: fewer windows than the plain count
    assert got[0] == plain[0] and counts(got).sum() < counts(plain).sum()


def test_multi_k_quality_matches_jax():
    kw = dict(quality_cutoff=20, **RUN)
    got = tpipe.multi_k_count_file(FQ, (4, 21), device="cpu", **kw)
    _equal(got, jpipe.multi_k_count_file(FQ, (4, 21), **kw))
    single = tpipe.count_file(FQ, 21, device="cpu", sparse_format="arrays",
                              **kw)
    _equal((got[0], got[1][21]), single)


# 36.84 is the highest mean (195 reads): the float32 compare at its edge
@pytest.mark.parametrize("cutoff", [20, 30, 36.84])
def test_quality_filter_file_matches_jax(tmp_path, cutoff):
    got_path, want_path = tmp_path / "port.fq", tmp_path / "jax.fq"
    got = tpipe.quality_filter_file(FQ, str(got_path), cutoff,
                                    batch_size=700, device="cpu")
    want = jpipe.quality_filter_file(FQ, str(want_path), cutoff,
                                     batch_size=700)
    assert got == want and got[0] == 2000 and 0 < got[1] < got[0]
    assert got_path.read_bytes() == want_path.read_bytes()


def test_quality_refusals(tmp_path):
    fa = tmp_path / "reads.fa"
    fa.write_bytes(b">a\nACGTACGTACGTACGTACGTACGTACGT\n" * 8)
    with pytest.raises(ValueError, match="quality_cutoff needs FASTQ"):
        tpipe.count_file(str(fa), 21, quality_cutoff=20, device="cpu", **RUN)
    with pytest.raises(ValueError, match="quality_cutoff needs FASTQ"):
        tpipe.multi_k_count_file(str(fa), (4, 21), quality_cutoff=20,
                                 device="cpu", **RUN)
    with pytest.raises(ValueError, match="packed transport"):
        tpipe.count_file(FQ, 21, quality_cutoff=20, packed=True,
                         device="cpu", **RUN)
    with pytest.raises(ValueError, match="packed transport"):
        tpipe.multi_k_count_file(FQ, (4, 21), quality_cutoff=20, packed=True,
                                 device="cpu", **RUN)
    with pytest.raises(ValueError, match="needs FASTQ"):
        tpipe.quality_filter_file(str(fa), str(tmp_path / "out.fq"), 20,
                                  device="cpu")


def test_filter_and_quality_count_cli_match_jax(capsys, tmp_path):
    from needletail_tpu import cli as jcli
    from needletail_tpu_torch import cli as tcli

    outs = {}
    for name, main, extra in (("torch", tcli.main, ["--device", "cpu"]),
                              ("jax", jcli.main, [])):
        kept = tmp_path / f"{name}.fq"
        assert main(["filter", FQ, str(kept), "--min-quality", "30"]
                    + extra) == 0
        filtered = capsys.readouterr()
        assert main(["count", FQ, "-k", "21", "--quality-cutoff", "20",
                     "--host-workers", "1", "--top", "3"] + extra) == 0
        counted = capsys.readouterr()
        outs[name] = (filtered.out, filtered.err, kept.read_bytes(),
                      counted.out, counted.err)
    assert outs["torch"] == outs["jax"]
    assert outs["torch"][0] == '{"reads_in": 2000, "reads_kept": 1732}\n'
    assert outs["torch"][4] == (
        "# 250000 bases, 146651 canonical 21-mers, 116744 distinct\n")
