// needletail_tpu_torch native framer: SIMD-speed FASTA/FASTQ record scanning and
// padded-batch filling for the TPU ingest path.
//
// Semantics mirror the reference framers exactly (needletail
// src/parser/fastq.rs, src/parser/fasta.rs): strict 4-line FASTQ records
// ('@' start, '+' separator, seq/qual length equality with trailing-\r trim,
// quality *characters* deliberately unvalidated), FASTA records delimited by
// lines starting with '>'.  Incomplete tails and EOF edge cases are left to
// the Python layer; this module only frames complete records — the hot 99%.
//
// Exposed via a plain C ABI for ctypes (no pybind11 in this environment).

#include <cstdint>
#include <cstring>

// x86 SIMD is compiled as a target("avx2") clone behind a RUNTIME cpu
// check (never a compile-time -march gate): the checked-in/wheel binary
// must run on any x86-64 host and still use AVX2 where present.
#if defined(__x86_64__) && (defined(__GNUC__) || defined(__clang__))
#define NT_X86_SIMD 1
#include <immintrin.h>
#else
#define NT_X86_SIMD 0
#endif

namespace {

inline const uint8_t* find_nl(const uint8_t* p, const uint8_t* end) {
    return static_cast<const uint8_t*>(
        memchr(p, '\n', static_cast<size_t>(end - p)));
}

// Length of [b, e) after removing one trailing '\r' (trim_cr, ref
// utils.rs:12-18).
inline int64_t trimmed_len(const uint8_t* b, const uint8_t* e) {
    int64_t n = e - b;
    if (n > 0 && e[-1] == '\r') --n;
    return n;
}

#if NT_X86_SIMD
static bool detect_avx2() {
    __builtin_cpu_init();
    return __builtin_cpu_supports("avx2");
}
// runtime dispatch flag: the AVX2 clones exist in every build of this
// file; whether they ever execute is decided here, per host
static const bool nt_has_avx2 = detect_avx2();

// In-order newline stream: one 32-byte vector compare per 32 input bytes
// plus a tzcnt per newline, instead of a memchr call per (short) line.
// FASTX framing consumes newlines strictly left to right, so a forward
// stream replaces every per-line find.  ~4x the scan rate on 60-120 byte
// lines (memchr's per-call startup dominates at those lengths).
struct NlStream {
    const uint8_t* cur;  // next unscanned byte
    const uint8_t* end;
    const uint8_t* block;  // start of the 32B block `mask` describes
    uint32_t mask;         // unconsumed newline bits in `block`
};

__attribute__((target("avx2"))) static inline const uint8_t* nl_next_avx2(
    NlStream* s) {
    for (;;) {
        if (s->mask) {
            unsigned b = static_cast<unsigned>(__builtin_ctz(s->mask));
            s->mask &= s->mask - 1;
            return s->block + b;
        }
        if (s->end - s->cur >= 32) {
            __m256i v = _mm256_loadu_si256(
                reinterpret_cast<const __m256i*>(s->cur));
            s->mask = static_cast<uint32_t>(_mm256_movemask_epi8(
                _mm256_cmpeq_epi8(v, _mm256_set1_epi8('\n'))));
            s->block = s->cur;
            s->cur += 32;
        } else {
            const uint8_t* nl = find_nl(s->cur, s->end);
            s->cur = s->end;
            if (nl) {
                s->block = nl;
                s->mask = 0;
                s->cur = nl + 1;
                return nl;
            }
            return nullptr;
        }
    }
}
#endif

}  // namespace

extern "C" {

// Error kinds (match needletail_tpu_torch.errors.ParseErrorKind ordering)
enum NtError : int32_t {
    NT_OK = 0,
    NT_INVALID_START = 1,
    NT_INVALID_SEPARATOR = 2,
    NT_UNEQUAL_LENGTHS = 3,
};

// Scan complete FASTQ records.
//
//   buf/len   : window anchored at a record start
//   recs      : int64[cap*5] out — (start, seq, sep, qual, end) per record,
//               offsets relative to buf; `end` is the index of the record's
//               final newline (all() == buf[start:end])
//   cap       : max records to emit
//   consumed  : out, byte offset one past the last emitted record
//   err       : out, NtError; framing stops at the offending record
//   err_rec   : out, (start<<32)|stage data packed? -- kept simple: start
//               offset of the record that failed validation
//
// Returns number of complete, valid records framed.
//
// The record loop is shared between the scalar (memchr) and AVX2
// (NlStream) newline sources via this macro: framing consumes newlines
// strictly left to right, so both sources see the identical sequence.
#define NT_SCAN_FASTQ_BODY(NEXT_NL)                                         \
    const uint8_t* base = buf;                                              \
    const uint8_t* end = buf + len;                                         \
    (void)end; /* the newline stream carries its own end */                 \
    const uint8_t* p = buf;                                                 \
    int64_t n = 0;                                                          \
    *err = NT_OK;                                                           \
    *err_rec = -1;                                                          \
    while (n < cap) {                                                       \
        const uint8_t* n1 = NEXT_NL;                                        \
        if (!n1) break;                                                     \
        const uint8_t* n2 = NEXT_NL;                                        \
        if (!n2) break;                                                     \
        const uint8_t* n3 = NEXT_NL;                                        \
        if (!n3) break;                                                     \
        const uint8_t* n4 = NEXT_NL;                                        \
        if (!n4) break;                                                     \
        /* validate (ref fastq.rs:240-285) */                               \
        if (*p != '@') {                                                    \
            *err = NT_INVALID_START;                                        \
            *err_rec = p - base;                                            \
            break;                                                          \
        }                                                                   \
        if (n2[1] != '+') { /* separator starts past the 2nd newline */     \
            *err = NT_INVALID_SEPARATOR;                                    \
            *err_rec = p - base;                                            \
            break;                                                          \
        }                                                                   \
        int64_t seq_len = trimmed_len(n1 + 1, n2);                          \
        int64_t qual_len = trimmed_len(n3 + 1, n4);                         \
        if (seq_len != qual_len) {                                          \
            *err = NT_UNEQUAL_LENGTHS;                                      \
            *err_rec = p - base;                                            \
            break;                                                          \
        }                                                                   \
        int64_t* r = recs + n * 5;                                          \
        r[0] = p - base;         /* start ('@') */                          \
        r[1] = (n1 + 1) - base;  /* seq line start */                       \
        r[2] = (n2 + 1) - base;  /* separator line start */                 \
        r[3] = (n3 + 1) - base;  /* quality line start */                   \
        r[4] = n4 - base;        /* final newline index */                  \
        ++n;                                                                \
        p = n4 + 1;                                                         \
    }                                                                       \
    *consumed = p - base;                                                   \
    return n;

static int64_t scan_fastq_scalar(const uint8_t* buf, int64_t len,
                                 int64_t* recs, int64_t cap,
                                 int64_t* consumed, int32_t* err,
                                 int64_t* err_rec) {
    struct {
        const uint8_t* cur;
        const uint8_t* end;
    } s{buf, buf + len};
    auto next_nl = [&]() -> const uint8_t* {
        const uint8_t* nl = find_nl(s.cur, s.end);
        s.cur = nl ? nl + 1 : s.end;
        return nl;
    };
    NT_SCAN_FASTQ_BODY(next_nl())
}

#if NT_X86_SIMD
__attribute__((target("avx2"))) static int64_t scan_fastq_avx2(
    const uint8_t* buf, int64_t len, int64_t* recs, int64_t cap,
    int64_t* consumed, int32_t* err, int64_t* err_rec) {
    NlStream s{buf, buf + len, buf, 0};
    NT_SCAN_FASTQ_BODY(nl_next_avx2(&s))
}
#endif

int64_t nt_scan_fastq(const uint8_t* buf, int64_t len, int64_t* recs,
                      int64_t cap, int64_t* consumed, int32_t* err,
                      int64_t* err_rec) {
#if NT_X86_SIMD
    if (nt_has_avx2)
        return scan_fastq_avx2(buf, len, recs, cap, consumed, err, err_rec);
#endif
    return scan_fastq_scalar(buf, len, recs, cap, consumed, err, err_rec);
}

// Scan complete FASTA records (record ends when the next line starts '>').
//
//   recs : int64[cap*3] out — (start, first_nl, end) per record where
//          `first_nl` is the header-terminating newline offset and `end` is
//          the offset of the newline before the next '>' (all() ==
//          buf[start:end]); first_nl == end means a header-only record.
// Newlines are consumed strictly left to right across records (record i+1
// starts scanning right after record i's terminating newline), so the same
// forward-stream macro trick as FASTQ applies.
#define NT_SCAN_FASTA_BODY(NEXT_NL)                                         \
    const uint8_t* base = buf;                                              \
    const uint8_t* end = buf + len;                                         \
    const uint8_t* p = buf;                                                 \
    int64_t n = 0;                                                          \
    while (n < cap) {                                                       \
        /* find the record terminator: "\n>" with the '>' in-bounds */      \
        const uint8_t* first_nl = nullptr;                                  \
        const uint8_t* term = nullptr;                                      \
        while (true) {                                                      \
            const uint8_t* nl = NEXT_NL;                                    \
            if (!nl || nl + 1 >= end) {                                     \
                term = nullptr;                                             \
                break;                                                      \
            }                                                               \
            if (!first_nl) first_nl = nl;                                   \
            if (nl[1] == '>') {                                             \
                term = nl;                                                  \
                break;                                                      \
            }                                                               \
        }                                                                   \
        if (!term) break;                                                   \
        if (!first_nl) break; /* cannot happen if term found, defensive */  \
        int64_t* r = recs + n * 3;                                          \
        r[0] = p - base;                                                    \
        r[1] = first_nl - base;                                             \
        r[2] = term - base;                                                 \
        ++n;                                                                \
        p = term + 1;                                                       \
    }                                                                       \
    *consumed = p - base;                                                   \
    return n;

static int64_t scan_fasta_scalar(const uint8_t* buf, int64_t len,
                                 int64_t* recs, int64_t cap,
                                 int64_t* consumed) {
    struct {
        const uint8_t* cur;
        const uint8_t* end;
    } s{buf, buf + len};
    auto next_nl = [&]() -> const uint8_t* {
        const uint8_t* nl = find_nl(s.cur, s.end);
        s.cur = nl ? nl + 1 : s.end;
        return nl;
    };
    NT_SCAN_FASTA_BODY(next_nl())
}

#if NT_X86_SIMD
__attribute__((target("avx2"))) static int64_t scan_fasta_avx2(
    const uint8_t* buf, int64_t len, int64_t* recs, int64_t cap,
    int64_t* consumed) {
    NlStream s{buf, buf + len, buf, 0};
    NT_SCAN_FASTA_BODY(nl_next_avx2(&s))
}
#endif

int64_t nt_scan_fasta(const uint8_t* buf, int64_t len, int64_t* recs,
                      int64_t cap, int64_t* consumed) {
#if NT_X86_SIMD
    if (nt_has_avx2)
        return scan_fasta_avx2(buf, len, recs, cap, consumed);
#endif
    return scan_fasta_scalar(buf, len, recs, cap, consumed);
}

// Fill a padded batch from scanned FASTQ records: copy sequence and quality
// lines (with trailing-\r trimmed) into [cap_rows, max_len] row-major
// buffers and write lengths.  Rows beyond `n` are left untouched (caller
// zero-initializes).  Returns the number of rows whose sequence exceeded
// max_len (0 means all fit; offending rows are truncated NOT copied).
int64_t nt_fill_fastq_batch(const uint8_t* buf, const int64_t* recs,
                            int64_t n, uint8_t* seq_out, uint8_t* qual_out,
                            int32_t* lengths, int64_t max_len) {
    int64_t overflow = 0;
    for (int64_t i = 0; i < n; ++i) {
        const int64_t* r = recs + i * 5;
        const uint8_t* sb = buf + r[1];
        // sequence line spans [r[1], r[2]-1) — r[2]-1 is its '\n'
        int64_t slen = trimmed_len(sb, buf + r[2] - 1);
        if (slen > max_len) {
            ++overflow;
            lengths[i] = 0;
            continue;
        }
        memcpy(seq_out + i * max_len, sb, static_cast<size_t>(slen));
        if (qual_out) {
            const uint8_t* qb = buf + r[3];
            memcpy(qual_out + i * max_len, qb, static_cast<size_t>(slen));
        }
        lengths[i] = static_cast<int32_t>(slen);
    }
    return overflow;
}

// Fill a padded batch from scanned FASTA records: copy each record's
// sequence span (between the header newline and the record end) into
// [cap_rows, max_len] rows, skipping '\n' and '\r' bytes (the batched form
// of the newline-stripping seq() accessor, ref fasta.rs:66-99).
// Returns the number of rows whose stripped sequence exceeded max_len
// (those rows get length 0 and are not copied).
int64_t nt_fill_fasta_batch(const uint8_t* buf, const int64_t* recs,
                            int64_t n, uint8_t* seq_out, int32_t* lengths,
                            int64_t max_len) {
    int64_t overflow = 0;
    for (int64_t i = 0; i < n; ++i) {
        const int64_t* r = recs + i * 3;
        const uint8_t* p = buf + r[1] + 1;  // first byte after header newline
        const uint8_t* end = buf + r[2];    // record-terminating newline
        uint8_t* out = seq_out + i * max_len;
        int64_t len = 0;
        bool bad = false;
        while (p < end && !bad) {
            const uint8_t* nl = static_cast<const uint8_t*>(
                memchr(p, '\n', static_cast<size_t>(end - p)));
            const uint8_t* line_end = nl ? nl : end;
            // strip every '\r' in the line too, like the memchr2-based
            // seq() (ref fasta.rs:76-98); almost always zero hits
            while (p < line_end) {
                const uint8_t* cr = static_cast<const uint8_t*>(
                    memchr(p, '\r', static_cast<size_t>(line_end - p)));
                const uint8_t* stop = cr ? cr : line_end;
                int64_t seg = stop - p;
                if (len + seg > max_len) {
                    ++overflow;
                    bad = true;
                    break;
                }
                memcpy(out + len, p, static_cast<size_t>(seg));
                len += seg;
                p = stop + 1;
            }
            p = line_end + 1;
        }
        lengths[i] = bad ? 0 : static_cast<int32_t>(len);
    }
    return overflow;
}

// Fill a padded id plane from scanned records: id bytes are the header
// line minus its leading marker byte ('@'/'>') with a trailing '\r'
// trimmed.  Works for both layouts: FASTQ recs (stride 5, header newline
// at r[1]-1 => end_adjust 1) and FASTA recs (stride 3, header newline at
// r[1] => end_adjust 0).  The caller sizes id_max to the chunk's longest
// id, so truncation cannot occur; the return value counts truncated rows
// defensively.
int64_t nt_fill_ids(const uint8_t* buf, const int64_t* recs, int64_t n,
                    int64_t stride, int64_t end_adjust, uint8_t* id_out,
                    int32_t* id_lens, int64_t id_max) {
    int64_t overflow = 0;
    for (int64_t i = 0; i < n; ++i) {
        const int64_t* r = recs + i * stride;
        const uint8_t* b = buf + r[0] + 1;
        const uint8_t* e = buf + r[1] - end_adjust;
        int64_t len = trimmed_len(b, e);
        if (len > id_max) {
            ++overflow;
            len = id_max;
        }
        if (len > 0) memcpy(id_out + i * id_max, b, static_cast<size_t>(len));
        id_lens[i] = static_cast<int32_t>(len);
    }
    return overflow;
}

// Pack record ids '\n'-separated into one contiguous buffer (ids cannot
// contain '\n'), so Python materializes the whole id list with a single
// bytes.split — no per-record interpreter work.  Returns bytes written
// (every id followed by one '\n'); the caller must size `out` to at least
// sum(header line lengths) + n.
int64_t nt_pack_ids(const uint8_t* buf, const int64_t* recs, int64_t n,
                    int64_t stride, int64_t end_adjust, uint8_t* out) {
    uint8_t* w = out;
    for (int64_t i = 0; i < n; ++i) {
        const int64_t* r = recs + i * stride;
        const uint8_t* b = buf + r[0] + 1;
        const uint8_t* e = buf + r[1] - end_adjust;
        int64_t len = trimmed_len(b, e);
        if (len > 0) memcpy(w, b, static_cast<size_t>(len));
        w += len;
        *w++ = '\n';
    }
    return w - out;
}

// Longest newline/CR-stripped sequence length across scanned FASTA
// records — sizes batch rows to true sequence length instead of the raw
// span (which over-pads wrapped FASTA by the newline fraction).
int64_t nt_fasta_max_len(const uint8_t* buf, const int64_t* recs, int64_t n) {
    int64_t best = 0;
    for (int64_t i = 0; i < n; ++i) {
        const int64_t* r = recs + i * 3;
        const uint8_t* p = buf + r[1] + 1;
        const uint8_t* end = buf + r[2];
        if (p > end) continue;
        int64_t len = end - p;
        const uint8_t* q = p;
        while ((q = find_nl(q, end)) != nullptr) {
            --len;
            ++q;
        }
        q = p;
        while ((q = static_cast<const uint8_t*>(
                    memchr(q, '\r', static_cast<size_t>(end - q)))) != nullptr) {
            --len;
            ++q;
        }
        if (len > best) best = len;
    }
    return best;
}

// ---------------------------------------------------------------------------
// Packed 2-bit transport: fill [rows, max_len/4] code planes
// (4 bases per byte, base j in byte j>>2 at bits 2*(j&3)) plus a
// [rows, max_len/8] validity bitplane (bit j&7 of byte j>>3; 1 = the byte
// mapped to a real base under `lut`).  `lut` is the caller's 256-entry
// byte -> 2-bit-code table (0xFF = invalid), shared with the device kernels
// so host packing and on-device encoding agree bit-for-bit.
//
// Cuts host->device bytes 4x vs raw ASCII (codes alone) — the validity
// plane ships only when a batch contains at least one invalid base, so the
// common clean-read case stays at 0.25 B/base.  Returns via out-params the
// number of rows that exceeded max_len (skipped, length 0) and the number
// of invalid bases seen.

namespace {

// Pair tables: one 16-bit (little-endian byte pair) lookup packs TWO
// bases' codes (4 bits) and validity (2 bits) — halves the per-base loads
// vs a byte LUT and keeps the inner loop branchless.  Rebuilt (64K cheap
// iterations) only when the caller's 256-entry LUT changes; thread_local
// so framing workers never contend.
thread_local uint8_t tl_pc[65536];
thread_local uint8_t tl_pv[65536];
thread_local uint8_t tl_lut[256];
thread_local bool tl_init = false;
// 0 = generic LUT (pair tables only); 1 = the normalized encode LUT
// (ACGTU + lowercase); 2 = the raw LUT (ACGT + lowercase) — these two admit
// the compare-based SIMD kernel below, verified equal to the LUT entrywise.
thread_local int tl_simd_mode = 0;

inline int detect_simd_mode(const uint8_t* lut) {
    int mode_norm = 1, mode_raw = 1;
    for (int b = 0; b < 256; ++b) {
        int up = b & 0xDF;
        uint8_t n = 255, r = 255;
        if (up == 0x41) n = r = 0;
        else if (up == 0x43) n = r = 1;
        else if (up == 0x47) n = r = 2;
        else if (up == 0x54) n = r = 3;
        else if (up == 0x55) n = 3;
        if (lut[b] != n) mode_norm = 0;
        if (lut[b] != r) mode_raw = 0;
    }
    return mode_norm ? 1 : (mode_raw ? 2 : 0);
}

inline void ensure_pair_tables(const uint8_t* lut) {
    if (tl_init && memcmp(tl_lut, lut, 256) == 0) return;
    uint8_t lc[256], lv[256];
    for (int i = 0; i < 256; ++i) {
        lc[i] = (lut[i] <= 3) ? lut[i] : 0;
        lv[i] = (lut[i] <= 3) ? 1 : 0;
    }
    for (int b = 0; b < 256; ++b) {
        for (int a = 0; a < 256; ++a) {
            tl_pc[(b << 8) | a] = static_cast<uint8_t>(lc[a] | (lc[b] << 2));
            tl_pv[(b << 8) | a] = static_cast<uint8_t>(lv[a] | (lv[b] << 1));
        }
    }
    tl_simd_mode = detect_simd_mode(lut);
    memcpy(tl_lut, lut, 256);
    tl_init = true;
}

#if NT_X86_SIMD
// Pack 32 bases at `p` (pos must be 32-aligned in the row): 8 code bytes +
// one 32-bit validity mask via byte compares — the SIMD twin of the encode
// LUT (valid iff the compare model matches; ensure tl_simd_mode != 0).
// ~6x the pair-LUT loop; the movemask bit order IS the vbits layout.
__attribute__((target("avx2"))) static int64_t pack32_avx2(
    const uint8_t* p, bool u_valid, uint8_t* code_out, uint8_t* valid_out) {
    __m256i x = _mm256_loadu_si256(reinterpret_cast<const __m256i*>(p));
    __m256i up = _mm256_and_si256(x, _mm256_set1_epi8(static_cast<char>(0xDF)));
    __m256i eqC = _mm256_cmpeq_epi8(up, _mm256_set1_epi8(0x43));
    __m256i eqG = _mm256_cmpeq_epi8(up, _mm256_set1_epi8(0x47));
    __m256i eqT = _mm256_cmpeq_epi8(up, _mm256_set1_epi8(0x54));
    if (u_valid)
        eqT = _mm256_or_si256(
            eqT, _mm256_cmpeq_epi8(up, _mm256_set1_epi8(0x55)));
    __m256i eqA = _mm256_cmpeq_epi8(up, _mm256_set1_epi8(0x41));
    __m256i valid = _mm256_or_si256(_mm256_or_si256(eqA, eqC),
                                    _mm256_or_si256(eqG, eqT));
    __m256i code = _mm256_or_si256(
        _mm256_and_si256(eqC, _mm256_set1_epi8(1)),
        _mm256_or_si256(_mm256_and_si256(eqG, _mm256_set1_epi8(2)),
                        _mm256_and_si256(eqT, _mm256_set1_epi8(3))));
    // horizontal 2-bit pack: byte pair -> c0 + 4*c1, pair pair -> + 16*...
    __m256i pair = _mm256_maddubs_epi16(code, _mm256_set1_epi16(0x0401));
    __m256i quad = _mm256_madd_epi16(pair, _mm256_set1_epi32(0x00100001));
    // low byte of each 32-bit lane holds 4 packed bases; gather 4 per half
    const __m256i gather = _mm256_setr_epi8(
        0, 4, 8, 12, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1,
        0, 4, 8, 12, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1);
    __m256i packed = _mm256_shuffle_epi8(quad, gather);
    uint32_t lo = static_cast<uint32_t>(
        _mm256_extract_epi32(packed, 0));
    uint32_t hi = static_cast<uint32_t>(
        _mm256_extract_epi32(packed, 4));
    memcpy(code_out, &lo, 4);
    memcpy(code_out + 4, &hi, 4);
    uint32_t vmask = static_cast<uint32_t>(_mm256_movemask_epi8(valid));
    memcpy(valid_out, &vmask, 4);
    return 32 - __builtin_popcount(vmask);
}

// One call per span (not per 32 bases) so the dispatch/call overhead is
// amortized; advances *pp/*ppos past every full 32-base chunk.
__attribute__((target("avx2"))) static int64_t pack_bulk_avx2(
    const uint8_t** pp, const uint8_t* e, bool u_valid, uint8_t* code_row,
    uint8_t* valid_row, int64_t* ppos) {
    const uint8_t* p = *pp;
    int64_t pos = *ppos;
    int64_t n_invalid = 0;
    while (e - p >= 32) {
        n_invalid += pack32_avx2(p, u_valid, code_row + (pos >> 2),
                                 valid_row + (pos >> 3));
        p += 32;
        pos += 32;
    }
    *pp = p;
    *ppos = pos;
    return n_invalid;
}

#endif

inline uint16_t load_u16(const uint8_t* p) {
    uint16_t w;
    memcpy(&w, p, 2);
    return w;
}

// Pack [b, e) (already newline-free) into code/validity planes at row
// bit-offset `pos`.  Assumes the planes are zero-initialized and
// ensure_pair_tables(lut) has run.
inline int64_t pack_span(const uint8_t* b, const uint8_t* e,
                         const uint8_t* lut, uint8_t* code_row,
                         uint8_t* valid_row, int64_t pos) {
    int64_t n_invalid = 0;
    const uint8_t* p = b;
    // scalar head until pos hits a validity-byte boundary
    while (p < e && (pos & 7)) {
        uint8_t c = lut[*p];
        if (c > 3) {
            ++n_invalid;
        } else {
            code_row[pos >> 2] |= static_cast<uint8_t>(c << ((pos & 3) * 2));
            valid_row[pos >> 3] |= static_cast<uint8_t>(1u << (pos & 7));
        }
        ++p;
        ++pos;
    }
#if NT_X86_SIMD
    // SIMD bulk: 32 bases/iter when the host has AVX2, the LUT admits the
    // compare kernel, and pos is 32-aligned (always true for FASTQ rows;
    // FASTA wrapped lines fall through to the pair loop after their first
    // line)
    if (nt_has_avx2 && tl_simd_mode != 0 && (pos & 31) == 0) {
        n_invalid += pack_bulk_avx2(&p, e, tl_simd_mode == 1, code_row,
                                    valid_row, &pos);
    }
#endif
    // hot loop: 8 bases -> 4 pair lookups -> 2 code bytes + 1 valid byte
    while (e - p >= 8) {
        uint8_t c0 = tl_pc[load_u16(p)];
        uint8_t c1 = tl_pc[load_u16(p + 2)];
        uint8_t c2 = tl_pc[load_u16(p + 4)];
        uint8_t c3 = tl_pc[load_u16(p + 6)];
        uint8_t v = static_cast<uint8_t>(
            tl_pv[load_u16(p)] | (tl_pv[load_u16(p + 2)] << 2) |
            (tl_pv[load_u16(p + 4)] << 4) | (tl_pv[load_u16(p + 6)] << 6));
        code_row[pos >> 2] = static_cast<uint8_t>(c0 | (c1 << 4));
        code_row[(pos >> 2) + 1] = static_cast<uint8_t>(c2 | (c3 << 4));
        valid_row[pos >> 3] = v;
        n_invalid += 8 - __builtin_popcount(v);
        p += 8;
        pos += 8;
    }
    while (p < e) {
        uint8_t c = lut[*p];
        if (c > 3) {
            ++n_invalid;
        } else {
            code_row[pos >> 2] |= static_cast<uint8_t>(c << ((pos & 3) * 2));
            valid_row[pos >> 3] |= static_cast<uint8_t>(1u << (pos & 7));
        }
        ++p;
        ++pos;
    }
    return n_invalid;
}

}  // namespace

// Packed twin of nt_fill_fastq_batch.  max_len must be a multiple of 8.
// code_out: uint8 [n, max_len/4]; valid_out: uint8 [n, max_len/8]; both
// zero-initialized by the caller.
int64_t nt_fill_fastq_batch_packed(const uint8_t* buf, const int64_t* recs,
                                   int64_t n, const uint8_t* lut,
                                   uint8_t* code_out, uint8_t* valid_out,
                                   int32_t* lengths, int64_t max_len,
                                   int64_t* n_invalid) {
    ensure_pair_tables(lut);
    const int64_t code_stride = max_len >> 2;
    const int64_t valid_stride = max_len >> 3;
    int64_t overflow = 0;
    int64_t invalid = 0;
    for (int64_t i = 0; i < n; ++i) {
        const int64_t* r = recs + i * 5;
        const uint8_t* sb = buf + r[1];
        int64_t slen = trimmed_len(sb, buf + r[2] - 1);
        if (slen > max_len) {
            ++overflow;
            lengths[i] = 0;
            continue;
        }
        invalid += pack_span(sb, sb + slen, lut, code_out + i * code_stride,
                             valid_out + i * valid_stride, 0);
        lengths[i] = static_cast<int32_t>(slen);
    }
    *n_invalid = invalid;
    return overflow;
}

// Packed twin of nt_fill_fasta_batch (newline/CR-stripping fill).
int64_t nt_fill_fasta_batch_packed(const uint8_t* buf, const int64_t* recs,
                                   int64_t n, const uint8_t* lut,
                                   uint8_t* code_out, uint8_t* valid_out,
                                   int32_t* lengths, int64_t max_len,
                                   int64_t* n_invalid) {
    ensure_pair_tables(lut);
    const int64_t code_stride = max_len >> 2;
    const int64_t valid_stride = max_len >> 3;
    int64_t overflow = 0;
    int64_t invalid = 0;
    for (int64_t i = 0; i < n; ++i) {
        const int64_t* r = recs + i * 3;
        const uint8_t* p = buf + r[1] + 1;
        const uint8_t* end = buf + r[2];
        uint8_t* code_row = code_out + i * code_stride;
        uint8_t* valid_row = valid_out + i * valid_stride;
        int64_t len = 0;
        bool bad = false;
        while (p < end && !bad) {
            const uint8_t* nl = static_cast<const uint8_t*>(
                memchr(p, '\n', static_cast<size_t>(end - p)));
            const uint8_t* line_end = nl ? nl : end;
            while (p < line_end) {
                const uint8_t* cr = static_cast<const uint8_t*>(
                    memchr(p, '\r', static_cast<size_t>(line_end - p)));
                const uint8_t* stop = cr ? cr : line_end;
                int64_t seg = stop - p;
                if (len + seg > max_len) {
                    ++overflow;
                    bad = true;
                    break;
                }
                invalid += pack_span(p, stop, lut, code_row, valid_row, len);
                len += seg;
                p = stop + 1;
            }
            p = line_end + 1;
        }
        if (bad) {
            // zero the partially-packed row so skipped rows stay inert
            memset(code_row, 0, static_cast<size_t>(code_stride));
            memset(valid_row, 0, static_cast<size_t>(valid_stride));
            lengths[i] = 0;
        } else {
            lengths[i] = static_cast<int32_t>(len);
        }
    }
    *n_invalid = invalid;
    return overflow;
}

// Row-resolved packed fills (lean transport): identical to the *_packed
// fills above but additionally write each row's invalid-base count into
// row_invalid (int32[n], caller-zeroed).  The Python layer uses the per-row
// counts to ship validity as a ragged dirty-rows plane (only rows that
// actually contain an ambiguous base) instead of the dense [n, max_len/8]
// bitplane — the lean host->device transport.
int64_t nt_fill_fastq_batch_packed_rows(
    const uint8_t* buf, const int64_t* recs, int64_t n, const uint8_t* lut,
    uint8_t* code_out, uint8_t* valid_out, int32_t* lengths, int64_t max_len,
    int64_t* n_invalid, int32_t* row_invalid) {
    ensure_pair_tables(lut);
    const int64_t code_stride = max_len >> 2;
    const int64_t valid_stride = max_len >> 3;
    int64_t overflow = 0;
    int64_t invalid = 0;
    for (int64_t i = 0; i < n; ++i) {
        const int64_t* r = recs + i * 5;
        const uint8_t* sb = buf + r[1];
        int64_t slen = trimmed_len(sb, buf + r[2] - 1);
        if (slen > max_len) {
            ++overflow;
            lengths[i] = 0;
            continue;
        }
        int64_t row = pack_span(sb, sb + slen, lut, code_out + i * code_stride,
                                valid_out + i * valid_stride, 0);
        invalid += row;
        row_invalid[i] = static_cast<int32_t>(row);
        lengths[i] = static_cast<int32_t>(slen);
    }
    *n_invalid = invalid;
    return overflow;
}

int64_t nt_fill_fasta_batch_packed_rows(
    const uint8_t* buf, const int64_t* recs, int64_t n, const uint8_t* lut,
    uint8_t* code_out, uint8_t* valid_out, int32_t* lengths, int64_t max_len,
    int64_t* n_invalid, int32_t* row_invalid) {
    ensure_pair_tables(lut);
    const int64_t code_stride = max_len >> 2;
    const int64_t valid_stride = max_len >> 3;
    int64_t overflow = 0;
    int64_t invalid = 0;
    for (int64_t i = 0; i < n; ++i) {
        const int64_t* r = recs + i * 3;
        const uint8_t* p = buf + r[1] + 1;
        const uint8_t* end = buf + r[2];
        uint8_t* code_row = code_out + i * code_stride;
        uint8_t* valid_row = valid_out + i * valid_stride;
        int64_t len = 0;
        int64_t row = 0;
        bool bad = false;
        while (p < end && !bad) {
            const uint8_t* nl = static_cast<const uint8_t*>(
                memchr(p, '\n', static_cast<size_t>(end - p)));
            const uint8_t* line_end = nl ? nl : end;
            while (p < line_end) {
                const uint8_t* cr = static_cast<const uint8_t*>(
                    memchr(p, '\r', static_cast<size_t>(line_end - p)));
                const uint8_t* stop = cr ? cr : line_end;
                int64_t seg = stop - p;
                if (len + seg > max_len) {
                    ++overflow;
                    bad = true;
                    break;
                }
                row += pack_span(p, stop, lut, code_row, valid_row, len);
                len += seg;
                p = stop + 1;
            }
            p = line_end + 1;
        }
        if (bad) {
            memset(code_row, 0, static_cast<size_t>(code_stride));
            memset(valid_row, 0, static_cast<size_t>(valid_stride));
            lengths[i] = 0;
        } else {
            invalid += row;
            row_invalid[i] = static_cast<int32_t>(row);
            lengths[i] = static_cast<int32_t>(len);
        }
    }
    *n_invalid = invalid;
    return overflow;
}

// Pack an ASCII row that is already contiguous (tail records framed by the
// Python layer).  Same layout/LUT semantics as the batch fills.
int64_t nt_pack_row(const uint8_t* seq, int64_t len, const uint8_t* lut,
                    uint8_t* code_row, uint8_t* valid_row) {
    ensure_pair_tables(lut);
    return pack_span(seq, seq + len, lut, code_row, valid_row, 0);
}

// Count newlines in [buf, buf+len) — utility for line accounting.
int64_t nt_count_newlines(const uint8_t* buf, int64_t len) {
    int64_t count = 0;
    const uint8_t* p = buf;
    const uint8_t* end = buf + len;
    while ((p = find_nl(p, end)) != nullptr) {
        ++count;
        ++p;
    }
    return count;
}

}  // extern "C"
