"""The port's needletail-compatible host surface against the JAX package.

Every function of the port's ``errors``, ``quality``, ``kmer``,
``bitkmer``, ``seq_wrapper``, ``parser`` (records, writers, dispatch),
``api``, ``batch.read_batches``, the host packers of ``encoding``,
``io.native.extract_ids``, ``io.bgzf.write_bgzf_stream``, ``io``'s
exports, ``device.count.merge_spectra`` and ``utils.profiling.trace`` is
called beside its JAX twin on the same inputs (the fixtures of
``tests/data`` and ``tests/specimen`` and seeded numpy sequences: IUPAC,
lowercase, N runs, palindromes), at tolerance 0: equal bytes, tuples and
arrays (dtypes included), and equal exception kinds and messages.  The two
packages' exception classes are different classes, so an error is held by
its class name and ``str``.  The public names of every JAX module have a
counterpart in the port but for the few ``ROADMAP.md`` records, and the
port's typed stubs match its runtime.
"""

import ast
import enum
import importlib
import inspect
import io
import pkgutil
import sys
import types
from pathlib import Path

import numpy as np
import pytest

import needletail_tpu as J
import needletail_tpu_torch as T
from needletail_tpu import batch as jbatch
from needletail_tpu import encoding as jenc
from needletail_tpu_torch import batch as tbatch
from needletail_tpu_torch import encoding as tenc

REPO = Path(__file__).resolve().parent.parent
DATA = REPO / "tests" / "data"
SPECIMEN = sorted((REPO / "tests" / "specimen").rglob("*.fast*"))
FIXTURES = sorted(p for p in DATA.iterdir() if p.is_file()) + SPECIMEN

KS = (1, 2, 4, 5, 21, 31, 32)


def _sequences():
    rng = np.random.default_rng(20261017)

    def pick(alphabet: bytes, n: int) -> bytes:
        table = np.frombuffer(alphabet, np.uint8)
        return table[rng.integers(0, len(table), n)].tobytes()

    nruns = bytearray(pick(b"ACGT", 400))
    for start in rng.integers(0, 380, 6):
        width = int(rng.integers(1, 20))
        nruns[start:start + width] = b"N" * len(nruns[start:start + width])
    return {
        "acgt": pick(b"ACGT", 400),
        "lowercase": pick(b"acgtACGT", 400),
        "iupac": pick(b"ACGTURYSWKMBDHVNacgturyswkmbdhvn-.", 400),
        "n_runs": bytes(nruns),
        # reverse-complement palindromes: every even window ties with its rc
        "palindromes": b"GAATTC" * 12 + b"ACGT" + b"AATT" * 6 + b"gaattc",
        "one": b"A",
        "empty": b"",
        "28S": (DATA / "28S.fasta").read_bytes().split(b"\n", 1)[1]
        .replace(b"\n", b"")[:3000],
    }


SEQS = _sequences()


# -- comparing the two packages' outcomes ------------------------------------

def _norm(x):
    """A value both packages' results reduce to when they agree."""
    if isinstance(x, np.ndarray):
        return ("ndarray", x.dtype.str, x.shape, x.tobytes())
    if isinstance(x, enum.Enum):
        return ("enum", type(x).__name__, x.name, x.value)
    if isinstance(x, bytes):
        return (type(x).__name__, bytes(x))
    if isinstance(x, (tuple, list)):
        return (type(x).__name__, [_norm(v) for v in x])
    if isinstance(x, dict):
        return ("dict", sorted((_norm(k), _norm(v)) for k, v in x.items()))
    if isinstance(x, types.GeneratorType):
        return ("generator", [_norm(v) for v in x])
    if type(x).__name__ == "Record":
        return ("Record", x.id, x.seq, x.qual, repr(x), str(x))
    if type(x).__name__ == "SequenceRecord":
        return ("SequenceRecord", repr(x), x.all())
    if isinstance(x, (int, float, str, bool, type(None))):
        return x
    raise TypeError(f"no comparison for {type(x).__name__}")


def _outcome(fn, *args, **kw):
    try:
        return ("value", _norm(fn(*args, **kw)))
    except Exception as exc:  # the two packages' classes differ: name + text
        return ("raised", type(exc).__name__, str(exc))


def twin(jfn, tfn, *args, **kw):
    """``jfn`` and ``tfn`` on the same arguments agree; returns the outcome."""
    want = _outcome(jfn, *args, **kw)
    got = _outcome(tfn, *args, **kw)
    assert got == want
    return want


# -- errors and quality ------------------------------------------------------

def test_error_types_and_messages():
    for name in ("PhredOffsetError", "NeedletailError", "ParseError",
                 "ParseErrorKind"):
        jcls, tcls = getattr(J.errors, name), getattr(T.errors, name)
        assert jcls.__name__ == tcls.__name__
        assert [c.__name__ for c in jcls.__mro__] == [
            c.__name__ for c in tcls.__mro__]
    for q, off in ((32, 33), (63, 64), (0, 33)):
        assert str(T.errors.PhredOffsetError(q=q, offset=off)) == str(
            J.errors.PhredOffsetError(q=q, offset=off))
    assert [(m.name, m.value) for m in T.errors.ParseErrorKind] == [
        (m.name, m.value) for m in J.errors.ParseErrorKind]


QUALS = [b"", b"IIII", b"!\"#$%", b"@ABCh", b"~~~~", b"I I", b"5?@A",
         "IIIé", bytearray(b"JJ"), memoryview(b"((((")]


@pytest.mark.parametrize("encoding", ["PHRED33", "PHRED64", "Phred33",
                                      "Phred64"])
def test_decode_phred(encoding):
    jdec, tdec = J.quality.decode_phred, T.quality.decode_phred
    jenc = getattr(J.quality.PhredEncoding, encoding)
    tenc = getattr(T.quality.PhredEncoding, encoding)
    assert (jenc.name, jenc.value) == (tenc.name, tenc.value)
    outcomes = [twin(lambda q: jdec(q, jenc), lambda q: tdec(q, tenc), q)
                for q in QUALS]
    # the first character below the offset is the one reported
    first = "' '" if jenc.value == 33 else "'!'"
    assert ("raised", "PhredOffsetError",
            f"character {first} cannot be decoded with offset "
            f"'{jenc.value}'") in outcomes


def test_phred_encoding_members():
    for cls in (J.quality.PhredEncoding, T.quality.PhredEncoding):
        assert cls.Phred33 is cls.PHRED33 and cls.Phred64 is cls.PHRED64
    assert [(m.name, m.value) for m in T.quality.PhredEncoding] == [
        (m.name, m.value) for m in J.quality.PhredEncoding]


# -- kmer and bitkmer ----------------------------------------------------------

@pytest.mark.parametrize("name", sorted(SEQS))
def test_kmer_iterators(name):
    seq = SEQS[name]
    rc = J.sequence.reverse_complement(seq)
    for k in KS + (0, 3000):
        twin(J.kmer.kmers, T.kmer.kmers, seq, k)
        twin(J.kmer.valid_kmer_positions, T.kmer.valid_kmer_positions, seq, k)
        twin(J.kmer.canonical_kmers, T.kmer.canonical_kmers, seq, rc, k)
        # the aliases and the other byte-like inputs
        twin(J.kmer.CanonicalKmers, T.kmer.CanonicalKmers,
             np.frombuffer(seq, np.uint8), memoryview(rc), k)
        twin(J.kmer.Kmers, T.kmer.Kmers, bytearray(seq), k)


@pytest.mark.parametrize("name", sorted(SEQS))
def test_bit_kmers(name):
    seq = SEQS[name]
    for k in KS + (0,):
        twin(J.bitkmer.pack_kmers, T.bitkmer.pack_kmers, seq, k)
        for canonical in (False, True):
            twin(J.bitkmer.bit_kmers, T.bitkmer.bit_kmers, seq, k, canonical)
        twin(J.bitkmer.BitNuclKmer, T.bitkmer.BitNuclKmer,
             np.frombuffer(seq, np.uint8), k, True)


def test_bit_kmers_k32_raises():
    got = twin(J.bitkmer.pack_kmers, T.bitkmer.pack_kmers, b"A" * 40, 32)
    assert got == ("raised", "ValueError", "k must be in [1, 31], got 32")


def test_palindrome_ties_pick_opposite_strands():
    """On a tie ``canonical_kmers`` yields the rc slice with ``was_rc=True``
    and ``bit_kmers`` keeps the forward value with ``was_rc=False``, in both
    packages."""
    seq = b"ACGTAATTGAATTC"
    rc = T.sequence.reverse_complement(seq)
    for mod in (J, T):
        windows = {p: r for p, _, r in mod.kmer.canonical_kmers(seq, rc, 4)}
        assert windows[0] is True  # ACGT == rc(ACGT)
        assert windows[4] is True  # AATT
        bits = {p: r for p, _, r in mod.bitkmer.bit_kmers(seq, 4, True)}
        assert bits[0] is False and bits[4] is False
        six = {p: r for p, _, r in mod.bitkmer.bit_kmers(seq, 6, True)}
        assert six[8] is False  # GAATTC


def test_bitkmer_scalar_functions():
    rng = np.random.default_rng(31)
    cases = [(0, 1), (3, 1), (0b11011000, 4), (27, 3)]
    for k in (1, 5, 11, 16, 21, 31):
        for v in rng.integers(0, 1 << (2 * k), 8, dtype=np.uint64):
            cases.append((int(v), k))
    for kmer in cases:
        twin(J.bitkmer.reverse_complement, T.bitkmer.reverse_complement, kmer)
        twin(J.bitkmer.canonical, T.bitkmer.canonical, kmer)
        twin(J.bitkmer.bitmer_to_bytes, T.bitkmer.bitmer_to_bytes, kmer)
        for m in {1, max(1, kmer[1] // 2), kmer[1]}:
            twin(J.bitkmer.minimizer, T.bitkmer.minimizer, kmer, m)
    for text in (b"ACGT", b"acgtN", b"T" * 31, b"", b"GATTACA"):
        twin(J.bitkmer.bytes_to_bitmer, T.bitkmer.bytes_to_bitmer, text)
    np.testing.assert_array_equal(T.bitkmer.NUC2BIT_LUT, J.bitkmer.NUC2BIT_LUT)
    assert T.bitkmer.NUC2BIT_LUT.dtype == J.bitkmer.NUC2BIT_LUT.dtype


def test_minimizer_keeps_the_reference_rc_quirk():
    """The rc of each candidate is taken as a k-mer: ``AAAA``'s 2-mer
    minimizer is ``(0, 4)`` and ``TTTT``'s is the rc of ``TT`` as a 4-mer."""
    for mod in (J, T):
        assert mod.bitkmer.minimizer((0, 4), 2) == (0, 4)
        tt_rc = mod.bitkmer.reverse_complement((0b1111, 4))[0]
        assert mod.bitkmer.minimizer((0xFF, 4), 2) == (min(0b1111, tt_rc), 4)


# -- Sequence ----------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(SEQS))
def test_sequence_wrapper(name):
    raw = SEQS[name] + b"\r\nAC\n"
    js, ts = J.Sequence(raw), T.Sequence(raw)
    rc = J.sequence.reverse_complement(raw)
    qual = bytes((33 + (i * 7) % 42) for i in range(len(raw)))
    calls = [
        ("sequence", ()), ("strip_returns", ()), ("reverse_complement", ()),
        ("normalize", ()), ("normalize", (True,)), ("canonical", ()),
        ("minimizer", (1,)), ("minimizer", (3,)), ("minimizer", (len(raw),)),
        ("quality_mask", (qual, 20)), ("quality_mask", (qual, 0)),
    ]
    for k in (1, 4, 21, 31, 32):
        calls += [("kmers", (k,)), ("canonical_kmers", (k, rc)),
                  ("bit_kmers", (k,)), ("bit_kmers", (k, True))]
    for method, args in calls:
        twin(getattr(js, method), getattr(ts, method), *args)
    # chained calls stay Sequences
    assert type(ts.normalize().reverse_complement()).__name__ == "Sequence"
    assert bytes(ts.strip_returns().canonical()) == bytes(
        js.strip_returns().canonical())


# -- parser: dispatch, records and writers -----------------------------------

def _records(mod, path):
    """Every record of ``path`` through ``mod.parser.parse_fastx_file``, or
    the error that stopped it."""
    out = []
    try:
        reader = mod.parser.parse_fastx_file(path)
        while (rec := reader.next()) is not None:
            out.append(rec)
    except Exception as exc:
        return out, (type(exc).__name__, str(exc))
    return out, None


def _record_views(mod, rec):
    """What ``mod``'s ``SequenceRecord`` methods give, in one list."""
    out = [repr(rec), rec.id(), rec.seq(), rec.raw_seq(), rec.qual(),
           rec.all(), rec.num_bases(), rec.start_line_number(),
           rec.line_ending().name, rec.format().name, rec.sequence(),
           rec.strip_returns(), rec.normalize(), rec.normalize(True),
           rec.reverse_complement()]
    for enc in mod.quality.PhredEncoding:
        out.append(_outcome(rec.decode_phred, enc))
    rc = rec.reverse_complement()
    for k in (4, 31) if rec.num_bases() <= 4096 else ():
        out += [_norm(rec.kmers(k)), _outcome(rec.canonical_kmers, k, rc),
                _outcome(rec.bit_kmers, k, True)]
    for forced in (None, mod.parser.LineEnding.UNIX,
                   mod.parser.LineEnding.WINDOWS):
        buf = io.BytesIO()
        rec.write(buf, forced)
        out.append(buf.getvalue())
    return out


@pytest.mark.parametrize("path", FIXTURES, ids=lambda p: p.name)
def test_parser_records(path):
    want, jerr = _records(J, path)
    got, terr = _records(T, path)
    assert terr == jerr
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        if i < 40:  # every view of the first records
            assert _record_views(T, g) == _record_views(J, w)
        else:
            assert (repr(g), g.all()) == (repr(w), w.all())


def test_parse_fastx_reader_inputs(monkeypatch):
    text = (DATA / "PRJNA271013_head.fq").read_bytes()[:5000]
    gz = (DATA / "test.fa.gz").read_bytes()
    for data in (text, gz, text.decode(), bytearray(text), b"", b">",
                 b"x\ny\n", b">a\nACGT\n>b\n", b"@a\nAC\n+\nII\n@b\nA"):
        for wrap in (lambda d: d, lambda d: io.BytesIO(
                d.encode() if isinstance(d, str) else bytes(d))):
            twin(lambda d: _drain(J.parser.parse_fastx_reader(wrap(d))),
                 lambda d: _drain(T.parser.parse_fastx_reader(wrap(d))),
                 data)
    for data in (text, gz, b""):
        outcomes = []
        for mod in (J, T):
            monkeypatch.setattr(sys, "stdin", io.TextIOWrapper(io.BytesIO(data)))
            outcomes.append(
                _outcome(lambda: _drain(mod.parser.parse_fastx_stdin())))
        assert outcomes[0] == outcomes[1]
    twin(lambda p: _drain(J.parser.parse_fastx_file(p)),
         lambda p: _drain(T.parser.parse_fastx_file(p)),
         str(DATA / "no_such_file.fa"))
    twin(lambda p: _drain(J.parser.parse_fastx_file(p)),
         lambda p: _drain(T.parser.parse_fastx_file(p)), str(DATA))


def _drain(reader):
    out = []
    while (rec := reader.next()) is not None:
        out.append((rec.id(), rec.seq(), rec.qual(), rec.line_ending().name))
    return out


def test_header_masks_and_writers():
    for header in (b"id", b"id\twith\ttabs", b"caf\xc3\xa9", b"bad\xff\xfe",
                   b"", b"\t"):
        twin(J.parser.mask_header_tabs, T.parser.mask_header_tabs, header)
        twin(J.parser.mask_header_utf8, T.parser.mask_header_utf8, header)
    for ending in ("UNIX", "WINDOWS"):
        jle = getattr(J.parser.LineEnding, ending)
        tle = getattr(T.parser.LineEnding, ending)
        assert jle.to_bytes() == tle.to_bytes()
        for args in ((b"r1", b"ACGT"), (b"r2 desc", b"")):
            jbuf, tbuf = io.BytesIO(), io.BytesIO()
            J.parser.write_fasta(*args, jbuf, jle)
            T.parser.write_fasta(*args, tbuf, tle)
            assert tbuf.getvalue() == jbuf.getvalue()
            for qual in (None, b"I" * len(args[1])):
                jbuf, tbuf = io.BytesIO(), io.BytesIO()
                J.parser.write_fastq(*args, qual, jbuf, jle)
                T.parser.write_fastq(*args, qual, tbuf, tle)
                assert tbuf.getvalue() == jbuf.getvalue()
    jbuf, tbuf = io.BytesIO(), io.BytesIO()
    J.parser.write_fastq(b"x", b"AC", None, jbuf)
    T.parser.write_fastq(b"x", b"AC", None, tbuf)
    assert tbuf.getvalue() == jbuf.getvalue() == b"@x\nAC\n+\nII\n"


# -- api ---------------------------------------------------------------------

def _api_records(mod, path):
    recs = []
    try:
        reader = mod.parse_fastx_file(path)
        assert repr(reader) == "<FastxReader>"
        for rec in reader:
            recs.append(rec)
    except Exception as exc:
        return recs, (type(exc).__name__, str(exc))
    return recs, None


def _api_views(rec):
    out = [rec.id, rec.seq, rec.qual, rec.name, rec.description, repr(rec),
           str(rec), len(rec), hash(rec), rec.is_fasta(), rec.is_fastq()]
    for iupac in (False, True):
        copy = type(rec)(rec.id, rec.seq, rec.qual)
        copy.normalize(iupac)
        out.append(copy.seq)
    return out


@pytest.mark.parametrize("path", FIXTURES, ids=lambda p: p.name)
def test_api_parse_fastx_file(path):
    want, jerr = _api_records(J, path)
    got, terr = _api_records(T, path)
    assert terr == jerr
    assert [_api_views(r) for r in got] == [_api_views(r) for r in want]


def test_api_functions():
    strings = [s.decode("latin-1") for s in SEQS.values()] + [
        "ACGTé", "acgtu\r\n", "RYKM", ""]
    for s in strings:
        for iupac in (False, True):
            twin(J.normalize_seq, T.normalize_seq, s, iupac)
        twin(J.reverse_complement, T.reverse_complement, s)
    for q in ["IIII", "!!", " ", "@Ah", "", "é", "~"]:
        for base_64 in (False, True):
            twin(J.decode_phred, T.decode_phred, q, base_64)
    for content in ((DATA / "test.fa").read_text(), ">a\nAC\n", "", "x",
                    "@a\nACGT\n+\nII\n", "@r\nA\n+\n"):
        twin(lambda c: [_api_views(r) for r in J.parse_fastx_string(c)],
             lambda c: [_api_views(r) for r in T.parse_fastx_string(c)],
             content)
    twin(lambda: J.Record("a", "AC", "I"), lambda: T.Record("a", "AC", "I"))
    jrec = J.Record("name desc", "A" * 40, "I" * 40)
    trec = T.Record("name desc", "A" * 40, "I" * 40)
    assert repr(trec) == repr(jrec) == (
        "Record(id=name…, seq=AAAAAAAAAAAAAAAA…AAA, qual=IIIIIIIIIIIIIIII…III)")
    assert (trec == T.Record("name desc", "A" * 40, "I" * 40)) is True
    assert trec.__eq__(jrec) is NotImplemented  # another package's Record
    twin(lambda: list(J.parse_fastx_file(DATA / "bad_test.fa")),
         lambda: list(T.parse_fastx_file(DATA / "bad_test.fa")))


def test_api_errors_are_needletail_errors():
    for mod in (J, T):
        with pytest.raises(mod.NeedletailError):
            mod.parse_fastx_file("tests/data/no_such_file.fq")
        with pytest.raises(mod.NeedletailError):
            list(mod.parse_fastx_string("x"))
        with pytest.raises(ValueError, match="Invalid Phred quality"):
            mod.decode_phred(" ")


# -- batches, packers, ids, BGZF, io exports, spectra, trace ---------------

def _batch_fields(batch):
    out = {}
    for name, value in vars(batch).items():
        if name.startswith("_"):
            continue
        out[name] = _norm(list(value) if name == "ids" else value)
    return out


@pytest.mark.parametrize("path", [p for p in FIXTURES if p.parent == DATA],
                         ids=lambda p: p.name)
def test_read_batches(path):
    for kw in (dict(batch_size=300), dict(batch_size=7, max_len=64,
                                          pad_len_to=8)):
        twin(lambda: [_batch_fields(b) for b in jbatch.read_batches(path, **kw)],
             lambda: [_batch_fields(b) for b in tbatch.read_batches(path, **kw)])


@pytest.mark.parametrize("normalized", [True, False])
def test_host_pack_and_unpack(normalized):
    from needletail_tpu_torch.utils.synth import random_reads

    rng = np.random.default_rng(11)
    for dirty in (0.0, 0.3):
        seqs, lengths = random_reads(rng, 48, 96, dirty_frac=dirty)
        want = twin(jenc.pack_codes_host, tenc.pack_codes_host,
                    seqs, lengths, normalized)
        codes, vbits = jenc.pack_codes_host(seqs, lengths, normalized)
        assert (vbits is None) == (dirty == 0.0)
        twin(jenc.unpack_codes_host, tenc.unpack_codes_host,
             codes, vbits)
        assert want[0] == "value"
    twin(jenc.pack_codes_host, tenc.pack_codes_host,
         np.zeros((2, 12), np.uint8), np.zeros(2, np.int32))
    from needletail_tpu.io import fast_batch as jfb
    from needletail_tpu_torch.io import fast_batch as tfb

    path = str(DATA / "PRJNA271013_head.fq")
    kw = dict(batch_size=300, max_len=128, packed=True, normalized=normalized)
    got = [b.unpack_host() for b in tfb.fast_read_batches(path, **kw)]
    want = [b.unpack_host() for b in jfb.fast_read_batches(path, **kw)]
    assert _norm(got) == _norm(want)


@pytest.mark.parametrize("fixture", ["PRJNA271013_head.fq", "test.fa",
                                     "28S.fasta"])
def test_extract_ids(fixture):
    from needletail_tpu.io import native as jnat
    from needletail_tpu_torch.io import native as tnat

    buf = np.frombuffer((DATA / fixture).read_bytes(), np.uint8)
    fastq = fixture.endswith(".fq")
    scan = tnat.scan_fastq if fastq else tnat.scan_fasta
    recs = scan(buf, 100_000)[0]
    ids = twin(jnat.extract_ids, tnat.extract_ids, buf, recs, fastq)
    assert len(ids[1][1]) == len(recs) > 0
    twin(jnat.extract_ids, tnat.extract_ids, buf, recs[:0], fastq)


def test_write_bgzf_stream(tmp_path):
    from needletail_tpu.io import bgzf as jb
    from needletail_tpu_torch.io import bgzf as tb

    data = (DATA / "PRJNA271013_head.fq").read_bytes()
    for block_size in (1000, 65280, 0, 70000):
        outs = []
        for mod in (jb, tb):
            out = tmp_path / f"{mod.__name__}.{block_size}.bgz"
            outs.append(_outcome(lambda: (mod.write_bgzf_stream(
                io.BytesIO(data), out, block_size=block_size),
                out.read_bytes())))
        assert outs[0] == outs[1]
    out = tmp_path / "needletail_tpu_torch.io.bgzf.1000.bgz"
    assert tb.is_bgzf(out) and tb.BGZFReader(out).read() == data


def test_io_exports():
    import needletail_tpu.io as jio
    import needletail_tpu_torch.io as tio

    assert tio.__all__ == jio.__all__
    for name in jio.__all__:
        jv, tv = getattr(jio, name), getattr(tio, name)
        if isinstance(jv, (bytes, tuple)):
            assert tv == jv, name
        else:
            assert tv.__name__ == jv.__name__, name
    with pytest.raises(AttributeError):
        getattr(tio, "no_such_name")


def test_merge_spectra():
    from needletail_tpu.device import count as jc
    from needletail_tpu_torch.device import count as tc

    rng = np.random.default_rng(5)
    dicts = [{int(k): int(c) for k, c in zip(
        rng.integers(0, 50, 40), rng.integers(1, 9, 40))} for _ in range(5)]
    twin(jc.merge_spectra, tc.merge_spectra, dicts)
    twin(jc.merge_spectra, tc.merge_spectra, [])
    assert "merge_spectra" in tc.__all__


def test_trace(tmp_path):
    """``trace(None)`` does nothing in either package; the port's
    ``trace(dir)`` writes one ``torch.profiler`` trace there."""
    import torch

    from needletail_tpu.utils.profiling import trace as jtrace
    from needletail_tpu_torch.utils.profiling import trace as ttrace

    for trace in (jtrace, ttrace):
        with trace(None):
            pass
    with ttrace(str(tmp_path)):
        torch.arange(64).sum()
    traces = list(tmp_path.glob("*.pt.trace.json"))
    assert len(traces) == 1 and b"aten::sum" in traces[0].read_bytes()


# -- every public name has a counterpart -------------------------------------

# JAX modules with no port module, and the port module that stands in
NO_MODULE = {
    "needletail_tpu.device.pallas_kernels": "needletail_tpu_torch.device.kernels",
    "needletail_tpu.device._ladder": "needletail_tpu_torch.device.kmers",
    "needletail_tpu.io.parallel_host": "needletail_tpu_torch.io.framing",
    "needletail_tpu.parallel._resolve": "needletail_tpu_torch.device.count",
}
# names ROADMAP.md records as having no counterpart, with their reasons
NO_COUNTERPART = {
    "needletail_tpu.batch": {"pad_vrow_planes"},
    "needletail_tpu.utils.limbs": {"acc64", "limbs_to_int"},
}


def test_every_public_name_has_a_counterpart():
    missing = []
    for info in pkgutil.walk_packages(J.__path__, "needletail_tpu."):
        jmod = importlib.import_module(info.name)
        if info.name in NO_MODULE:
            if info.name == "needletail_tpu.io.parallel_host":
                tmod = importlib.import_module(NO_MODULE[info.name])
                missing += [f"{info.name}.{n}" for n in jmod.__all__
                            if not hasattr(tmod, n)]
            continue
        tmod = importlib.import_module(
            info.name.replace("needletail_tpu", "needletail_tpu_torch", 1))
        names = getattr(jmod, "__all__", None)
        if names is None:  # the public functions and classes it defines
            names = [n for n, v in vars(jmod).items() if not n.startswith("_")
                     and getattr(v, "__module__", None) == info.name]
        skip = NO_COUNTERPART.get(info.name, set())
        missing += [f"{info.name}.{n}" for n in names
                    if n not in skip and not hasattr(tmod, n)]
        if hasattr(jmod, "__all__") and info.name not in NO_COUNTERPART:
            assert set(jmod.__all__) <= set(getattr(tmod, "__all__", ())), (
                info.name)
    assert not missing, missing
    for skipped in NO_COUNTERPART.values():
        assert skipped  # each exception names something
    assert T.__all__ == J.__all__
    assert T.parser.__all__ == J.parser.__all__


# -- the port's typed stubs ---------------------------------------------------

def _stub(name):
    return ast.parse((REPO / "needletail_tpu_torch" / name).read_text())


@pytest.mark.parametrize("stub", ["__init__.pyi", "api.pyi"])
def test_stub_classes_and_functions_match_runtime(stub):
    tree = _stub(stub)
    runtime = T if stub == "__init__.pyi" else T.api
    for node in tree.body:
        if isinstance(node, ast.ClassDef):
            cls = getattr(runtime, node.name)
            for item in node.body:
                if isinstance(item, ast.FunctionDef):
                    assert hasattr(cls, item.name), (node.name, item.name)
        if isinstance(node, ast.FunctionDef):
            fn = getattr(runtime, node.name)
            stub_params = [a.arg for a in node.args.args]
            assert stub_params == list(inspect.signature(fn).parameters), (
                node.name)


def test_root_stub_exports_match_runtime_all():
    tree = _stub("__init__.pyi")
    names = set()
    stub_all = None
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        if isinstance(node, ast.ImportFrom):
            names.update(a.asname or a.name for a in node.names)
    for node in tree.body:
        if isinstance(node, ast.Assign) and getattr(
                node.targets[0], "id", "") == "__all__":
            stub_all = {ast.literal_eval(e) for e in node.value.elts}
    assert stub_all == set(T.__all__)
    assert not [n for n in T.__all__ if n not in names]
    assert (REPO / "needletail_tpu_torch" / "py.typed").exists()
    # the port's stubs mirror the JAX package's, declaration for declaration
    for stub in ("__init__.pyi", "api.pyi"):
        jtree = ast.parse((REPO / "needletail_tpu" / stub).read_text())
        assert ast.dump(_stub(stub)) == ast.dump(jtree)
