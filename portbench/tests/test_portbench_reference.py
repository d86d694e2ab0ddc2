"""The plain reference against a brute-force count of every window."""

import numpy as np
import pytest

import _tiny  # noqa: F401  (the import path)
from portbench.reference import spectrum as ref

COMP = {ord("A"): "T", ord("C"): "G", ord("G"): "C", ord("T"): "A"}


def brute(seqs, k, canonical=True):
    counts = {}
    for s in seqs:
        for row in np.atleast_2d(s):
            text = bytes(row).upper()
            for i in range(len(text) - k + 1):
                w = text[i:i + k]
                if any(c not in b"ACGT" for c in w):
                    continue
                fwd = int("".join("ACGT".index(chr(c)).__str__() for c in w), 4)
                rc = int("".join(
                    "ACGT".index(COMP[c]).__str__() for c in reversed(w)), 4)
                key = min(fwd, rc) if canonical else fwd
                counts[key] = counts.get(key, 0) + 1
    keys = sorted(counts)
    return np.array(keys, np.uint64), np.array([counts[x] for x in keys], np.int64)


@pytest.fixture(params=[37, 1 << 18])
def block(request, monkeypatch):
    # a block shorter than the inputs makes windows cross block seams
    monkeypatch.setattr(ref, "_BLOCK", request.param)
    return request.param


@pytest.mark.parametrize("k", [1, 4, 15, 16, 17, 21, 31])
@pytest.mark.parametrize("canonical", [True, False])
def test_spectrum_matches_brute_force(k, canonical, block):
    rng = np.random.default_rng(k)
    alphabet = np.frombuffer(b"ACGTNacgtn", np.uint8)
    seqs = [alphabet[rng.integers(0, 10 if j % 2 else 4, 150)] for j in range(4)]
    seqs.append(np.frombuffer(b"ACGTN", np.uint8)[rng.integers(0, 5, (6, 40))])
    got = ref.spectrum(seqs, k, canonical)
    want = brute(seqs, k, canonical)
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1], want[1])


def test_both_strands_give_one_key():
    seq = np.frombuffer(b"ACGGTACCATTGACCAGTAGGCATTAGCCATGG", np.uint8)
    rc = np.frombuffer(bytes(COMP[c].encode()[0] for c in seq[::-1]), np.uint8)
    assert np.array_equal(ref.spectrum([seq], 21)[0], ref.spectrum([rc], 21)[0])
    assert not np.array_equal(
        ref.spectrum([seq], 21, False)[0], ref.spectrum([rc], 21, False)[0])


def test_n_and_row_ends_break_windows():
    rows = np.frombuffer(b"ACGTNACGTA" * 2, np.uint8).reshape(2, 10)
    # per row: ACGT (1 window of 4) and ACGTA (2 windows); none spans rows
    assert ref.valid_windows(rows, 4) == 6
    assert ref.window_keys(rows, 4).size == 6
    assert ref.valid_windows(np.frombuffer(b"ACG\nTAC", np.uint8), 3) == 2


def test_diff_count():
    k = np.array([1, 5, 9], np.uint64)
    c = np.array([2, 1, 4], np.int64)
    assert ref.diff_count(k, c, k, c) == 0
    assert ref.diff_count(k, c + np.array([0, 1, 0]), k, c) == 1
    assert ref.diff_count(k[:2], c[:2], k, c) == 1
    assert ref.diff_count(np.array([1, 5, 7], np.uint64), c, k, c) == 2
    assert ref.diff_count(np.zeros(0, np.uint64), np.zeros(0, np.int64), k, c) == 3
