// Fused canonical k-mer window kernel of the hash-count and exact paths.
//
// Replaces needletail_tpu/device/pallas_kernels.py:canonical_hash_keys
// (ASCII bytes in) and canonical_hash_keys_packed (2-bit codes plus an
// optional validity bitplane in), and in its planes mode
// canonical_key_planes / canonical_key_planes_packed, and in its tally
// mode canonical_hash_tally (pallas_kernels.py:275, body _kernel :175).
// For every lane p of a [rows, L] read plane it computes:
//
//   code      A0 C1 G2 T3 (ASCII: case-folded with & 0xDF, U counts as T
//             only when `normalized`); anything else is invalid
//   valid     all k codes are bases and p + k <= min(length[row], L)
//   canonical integer min of the forward window (first base most
//             significant) and its reverse complement; a tie keeps forward
//   hi, lo    canonical >> 32 and its low 32 bits (for k <= 16, hi = 0)
//
// and writes, by mode, one of
//
//   keys      ((lo * 0x9E3779B1) ^ (hi * 0x85EBCA77)) mod 2^32 & mask,
//             -1 where invalid                          (hash keys)
//   hi, lo    two int32 planes of the uint32 bit patterns, both
//             0xFFFFFFFF (-1) where invalid             (key planes)
//   idx, w    the hash key as above but 0 where invalid, and an int32
//             weight plane, 1 where valid and 0 where not   (tally)
//
// plus the tallies total (valid windows) and fwd (valid windows taken
// from the forward strand), added to two 64-bit counters.  The planes
// are what the Pallas planes kernel writes before its bitcast to uint32.
//
// What held the first design back: it found each lane's row with two
// 64-bit divisions (g / L) and rebuilt the whole window with a k-step
// loop of shared-memory reads and 64-bit shift-ors, some 300 integer
// instructions a lane.  A 131072 x 128 packed batch at k=21 took 0.356 ms
// and the planes at k=31 0.451 ms, against a byte time of 0.022-0.045 ms
// (H100 80GB HBM3, 700.00 W, chip_smoke.py): the kernel was bound by the
// SMs' integer issue rate, not by memory.
//
// What bounds this one: the bytes it writes (4 or 8 a lane), and then the
// latency of staging each row, with 57-64 registers a thread holding 32
// warps an SM.  The same batch takes 0.0434 ms (packed keys, 2.0x its
// byte time), 0.0588 ms (planes, k=21 and k=31), ASCII keys 0.0659 ms and
// tally 0.0690 ms, against the first design's 0.3531, 0.3539 / 0.4466,
// 0.3555 and 0.3578 ms in the same run (H100 80GB HBM3, 700.00 W,
// bench/redesign_times.py).  It rests on one identity.  Read a row's
// codes as a little-endian bit stream, base j at bits 2j, and its
// validity as a stream with base j at bit j.  For the 2k-bit field e that
// starts at bit 2p:
//
//   rc    = ~e & (2^2k - 1)
//   fwd   = e with its 2-bit groups reversed: the bits reversed, the two
//           bits of each pair swapped back, shifted right by 64 - 2k
//   valid = the k validity bits from bit p are all ones, and the length
//           test above
//
// so every window costs two funnel shifts of 32-bit words, two bit
// reversals and a few masks, whatever k is.  A warp owns one 128-lane
// segment of four rows at a time (row groups on gridDim.x, segments on
// gridDim.y, both in grid-stride loops, so no lane divides anything and
// any L works).  It issues the loads of all four rows before it waits on
// any (the rows' lengths too), so four times the bytes are in flight per
// warp, and stages each row's 160 bases (the 31-base halo included) as
// ten 32-bit code words and five validity words in shared memory: packed
// input as bytes (no alignment is assumed: rows are L/4 bytes apart and
// the validity plane is a view at any offset), ASCII input through a
// 256-entry code table and three ballots per 32 bases into the same words.
// Each thread then makes 4 consecutive lanes of each row from three code
// words and two validity words, and writes them with one 16-byte store
// where the row pitch allows (scalar stores where it does not).  Bases
// past L stage as zeros; their windows fail the length test.  Tallies are
// reduced per warp in registers and issued as one atomic pair per block.
// k <= 16 and k > 16 are separate instances: the short windows fit one
// word and skip the high half.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kLanesPerThread = 4;
constexpr int kSeg = 32 * kLanesPerThread;  // lanes a warp makes per row
constexpr int kRowsPerWarp = 4;             // rows a warp stages at once
constexpr int kMaxK = 31;
// bases staged per row and segment: kSeg plus the halo, in whole words
constexpr int kStaged = kSeg + 32;             // 160
constexpr int kCodeWords = kStaged / 16;       // 10 x 32 bits
constexpr int kValidWords = kStaged / 32;      // 5 x 32 bits
constexpr int kCodeBytes = kStaged / 4;        // 40
constexpr int kValidBytes = kStaged / 8;       // 20
constexpr uint32_t kInvalid = 4;
constexpr uint32_t kPairLow = 0x55555555u;

struct Planes {
  const uint8_t* data;   // ASCII [rows, stride] or 2-bit codes [rows, stride]
  const uint8_t* vbits;  // validity bits [rows, vstride] or nullptr
  long long stride;
  long long vstride;
  int normalized;
};

// the words a launch masks and shifts by, fixed by k
struct Window {
  int k;
  uint32_t lo_mask;  // low and high words of 2^2k - 1
  uint32_t hi_mask;
  uint32_t vmask;    // 2^k - 1
  int shift;         // 64 - 2k (k > 16) or 32 - 2k (k <= 16)
};

struct Staged {
  uint32_t code[kCodeWords];
  uint32_t valid[kValidWords];
};

__device__ __forceinline__ uint32_t encode_ascii(uint32_t b, int normalized) {
  const uint32_t up = b & 0xDF;
  if (up == 'A') return 0;
  if (up == 'C') return 1;
  if (up == 'G') return 2;
  if (up == 'T' || (normalized && up == 'U')) return 3;
  return kInvalid;
}

// bit i of the low 16 bits of x to bit 2i
__device__ __forceinline__ uint32_t spread16(uint32_t x) {
  x &= 0xFFFF;
  x = (x | (x << 8)) & 0x00FF00FFu;
  x = (x | (x << 4)) & 0x0F0F0F0Fu;
  x = (x | (x << 2)) & 0x33333333u;
  x = (x | (x << 1)) & kPairLow;
  return x;
}

// the 2-bit groups of x in reverse order
__device__ __forceinline__ uint32_t pair_reverse(uint32_t x) {
  const uint32_t y = __brev(x);
  return ((y >> 1) & kPairLow) | ((y & kPairLow) << 1);
}

// Stages bases [s0, s0 + kStaged) of rows row0 .. row0 + kRowsPerWarp - 1
// (those below `rows`) into `st`, and returns each row's length limit in
// lim.  Every load is issued before the first store.  Bases at or past L
// stage as code 0, invalid.
__device__ __forceinline__ void stage_packed(const Planes& in,
                                             const int32_t* lengths, int row0,
                                             int rows, int s0, int L, int lane,
                                             Staged* st, int* lim) {
  const int c_left = (L - s0) >> 2;  // code bytes of the row from s0
  // a row of L = 4 (mod 8) bases has no validity plane; its last
  // validity byte then stages whole
  const int v_left = (L - s0 + 7) >> 3;
  uint32_t c0[kRowsPerWarp], c1[kRowsPerWarp], vb[kRowsPerWarp];
#pragma unroll
  for (int g = 0; g < kRowsPerWarp; ++g) {
    const int row = row0 + g;
    c0[g] = c1[g] = vb[g] = 0;
    lim[g] = 0;
    if (row < rows) {
      const uint8_t* crow = in.data + (long long)row * in.stride + (s0 >> 2);
      if (lane < c_left) c0[g] = crow[lane];
      if (lane + 32 < kCodeBytes && lane + 32 < c_left) c1[g] = crow[lane + 32];
      if (lane < kValidBytes && lane < v_left) {
        vb[g] = in.vbits == nullptr
                    ? 0xFFu
                    : in.vbits[(long long)row * in.vstride + (s0 >> 3) + lane];
      }
      lim[g] = min(lengths[row], L);
    }
  }
#pragma unroll
  for (int g = 0; g < kRowsPerWarp; ++g) {
    uint8_t* cb = reinterpret_cast<uint8_t*>(st[g].code);
    cb[lane] = (uint8_t)c0[g];
    if (lane + 32 < kCodeBytes) cb[lane + 32] = (uint8_t)c1[g];
    if (lane < kValidBytes) {
      reinterpret_cast<uint8_t*>(st[g].valid)[lane] = (uint8_t)vb[g];
    }
  }
}

__device__ __forceinline__ void stage_ascii(const Planes& in,
                                            const int32_t* lengths,
                                            const uint8_t* lut, int row0,
                                            int rows, int s0, int L, int lane,
                                            Staged* st, int* lim) {
  constexpr int kLoads = kStaged / 32;  // 5 bases a lane per row
  uint32_t raw[kRowsPerWarp][kLoads];
#pragma unroll
  for (int g = 0; g < kRowsPerWarp; ++g) {
    const int row = row0 + g;
    lim[g] = 0;
    const uint8_t* arow = in.data + (long long)row * in.stride + s0;
#pragma unroll
    for (int m = 0; m < kLoads; ++m) {
      const int i = 32 * m + lane;
      // any byte that is not a base encodes as invalid; 0 is one
      raw[g][m] = row < rows && s0 + i < L ? arow[i] : 0;
    }
    if (row < rows) lim[g] = min(lengths[row], L);
  }
#pragma unroll
  for (int g = 0; g < kRowsPerWarp; ++g) {
    // lane j < 10 builds code word j, lane m < 5 stores validity word m
    uint32_t my_b0 = 0, my_b1 = 0;
#pragma unroll
    for (int m = 0; m < kLoads; ++m) {
      const uint32_t c = lut[raw[g][m]];
      const uint32_t b0 = __ballot_sync(0xFFFFFFFFu, c & 1);
      const uint32_t b1 = __ballot_sync(0xFFFFFFFFu, (c >> 1) & 1);
      const uint32_t ok = __ballot_sync(0xFFFFFFFFu, c < 4);
      if ((lane >> 1) == m) {
        const int half = 16 * (lane & 1);
        my_b0 = b0 >> half;
        my_b1 = b1 >> half;
      }
      if (lane == m) st[g].valid[m] = ok;
    }
    if (lane < kCodeWords) {
      st[g].code[lane] = spread16(my_b0) | (spread16(my_b1) << 1);
    }
  }
}

// what a launch writes to keys (and keys2)
enum Mode : int {
  kKeys = 0,    // hash keys, -1 where invalid
  kPlanes = 1,  // canonical hi to keys, lo to keys2, -1 where invalid
  kTally = 2,   // hash keys, 0 where invalid, to keys; the 0/1 weight to keys2
};

template <int kMode, bool kPacked, bool kWide>
__global__ void __launch_bounds__(kThreads)
    window_kernel(Planes in, const int32_t* __restrict__ lengths,
                  int32_t* __restrict__ keys, int32_t* __restrict__ keys2,
                  unsigned long long* __restrict__ tallies, int rows, int L,
                  int segs, Window w, uint32_t mask) {
  __shared__ Staged s_rows[kWarps][kRowsPerWarp];
  __shared__ uint8_t s_lut[256];
  __shared__ unsigned s_tally[2][kWarps];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (!kPacked) {
    s_lut[threadIdx.x] = (uint8_t)encode_ascii(threadIdx.x, in.normalized);
    __syncthreads();
  }
  const bool vec = (L & 3) == 0;
  // this thread's lanes start at bit 8 * lane of the segment's code
  // stream (word lane / 4) and bit 4 * lane of its validity stream (word
  // lane / 8); the windows reach into the next two and the next word
  const int cw = lane >> 2;
  const int c_sh = 8 * (lane & 3);
  const int vw = lane >> 3;
  const int v_sh = (4 * lane) & 31;
  Staged* st = s_rows[warp];
  unsigned total = 0;
  unsigned fwd_total = 0;
  const int groups = rows / kRowsPerWarp + (rows % kRowsPerWarp != 0);

  for (int grp = blockIdx.x * kWarps + warp; grp < groups;
       grp += gridDim.x * kWarps) {
    const int row0 = grp * kRowsPerWarp;
    for (int seg = blockIdx.y; seg < segs; seg += gridDim.y) {
      const int s0 = seg * kSeg;
      int lim[kRowsPerWarp];
      if (kPacked) {
        stage_packed(in, lengths, row0, rows, s0, L, lane, st, lim);
      } else {
        stage_ascii(in, lengths, s_lut, row0, rows, s0, L, lane, st, lim);
      }
      __syncwarp();
      const int p0 = s0 + kLanesPerThread * lane;
#pragma unroll
      for (int g = 0; g < kRowsPerWarp; ++g) {
        const int row = row0 + g;
        if (row >= rows) break;
        const uint32_t w0 = st[g].code[cw];
        const uint32_t w1 = st[g].code[cw + 1];
        const uint32_t w2 = st[g].code[cw + 2];
        const uint32_t u0 = st[g].valid[vw];
        const uint32_t u1 = st[g].valid[vw + 1];
        int32_t first[kLanesPerThread];
        int32_t second[kLanesPerThread];
#pragma unroll
        for (int i = 0; i < kLanesPerThread; ++i) {
          const uint32_t e_lo = __funnelshift_r(w0, w1, c_sh + 2 * i);
          const uint32_t v = __funnelshift_r(u0, u1, v_sh + i);
          const bool ok = (v & w.vmask) == w.vmask && p0 + i + w.k <= lim[g];
          uint32_t f_hi = 0, f_lo, r_hi = 0;
          const uint32_t r_lo = ~e_lo & w.lo_mask;
          if (kWide) {
            const uint32_t e_hi = __funnelshift_r(w1, w2, c_sh + 2 * i);
            r_hi = ~e_hi & w.hi_mask;
            // the reversed 64-bit field: high word from e_lo, low from e_hi
            const uint32_t n_hi = pair_reverse(e_lo);
            f_lo = __funnelshift_r(pair_reverse(e_hi), n_hi, w.shift);
            f_hi = n_hi >> w.shift;
          } else {
            f_lo = pair_reverse(e_lo) >> w.shift;
          }
          const uint64_t fwd = ((uint64_t)f_hi << 32) | f_lo;
          const uint64_t rc = ((uint64_t)r_hi << 32) | r_lo;
          const bool use_rc = fwd > rc;
          const uint32_t hi = use_rc ? r_hi : f_hi;
          const uint32_t lo = use_rc ? r_lo : f_lo;
          total += ok;
          fwd_total += ok && !use_rc;
          if (kMode == kPlanes) {
            first[i] = ok ? (int32_t)hi : -1;
            second[i] = ok ? (int32_t)lo : -1;
          } else {
            const uint32_t h = ((lo * 0x9E3779B1u) ^ (hi * 0x85EBCA77u)) & mask;
            if (kMode == kTally) {
              first[i] = ok ? (int32_t)h : 0;
              second[i] = ok ? 1 : 0;
            } else {
              first[i] = ok ? (int32_t)h : -1;
            }
          }
        }
        const long long at = (long long)row * L + p0;
        if (vec && p0 + kLanesPerThread <= L) {
          *reinterpret_cast<int4*>(keys + at) =
              make_int4(first[0], first[1], first[2], first[3]);
          if (kMode != kKeys) {
            *reinterpret_cast<int4*>(keys2 + at) =
                make_int4(second[0], second[1], second[2], second[3]);
          }
        } else {
#pragma unroll
          for (int i = 0; i < kLanesPerThread; ++i) {
            if (p0 + i < L) {
              keys[at + i] = first[i];
              if (kMode != kKeys) keys2[at + i] = second[i];
            }
          }
        }
      }
      __syncwarp();  // the next staging overwrites the words
    }
  }
  total = __reduce_add_sync(0xFFFFFFFFu, total);
  fwd_total = __reduce_add_sync(0xFFFFFFFFu, fwd_total);
  if (lane == 0) {
    s_tally[0][warp] = total;
    s_tally[1][warp] = fwd_total;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long t = 0;
    unsigned long long f = 0;
    for (int i = 0; i < kWarps; ++i) {
      t += s_tally[0][i];
      f += s_tally[1][i];
    }
    if (t != 0) {
      atomicAdd(&tallies[0], t);
      atomicAdd(&tallies[1], f);
    }
  }
}

template <int kMode, bool kPacked, bool kWide>
void launch_one(dim3 grid, cudaStream_t stream, const Planes& in,
                const int32_t* lengths, int32_t* keys, int32_t* keys2,
                unsigned long long* tallies, int rows, int L, int segs,
                const Window& w, uint32_t mask) {
  window_kernel<kMode, kPacked, kWide><<<grid, kThreads, 0, stream>>>(
      in, lengths, keys, keys2, tallies, rows, L, segs, w, mask);
}

template <int kMode>
int launch(const void* data, const void* vbits, const void* lengths,
           void* keys, void* keys2, void* tallies, long long rows,
           long long L, long long stride, long long vstride, int k,
           unsigned int mask, int packed, int normalized, void* stream) {
  // rows and L are 32-bit in the kernel; L stays clear of 2^31 with a
  // segment to spare, so no segment start overflows
  if (k < 1 || k > kMaxK || rows <= 0 || L <= 0 || rows > 0x7FFFFFFFLL ||
      L > 0x7FFFFFFFLL - kSeg) {
    return (int)cudaErrorInvalidValue;
  }
  const int n_rows = (int)rows;
  const int width = (int)L;
  int device = 0;
  int sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int segs = (width + kSeg - 1) / kSeg;
  const int gy = segs < 65535 ? segs : 65535;
  // about 16 blocks an SM in all; the grid-stride loops take the rest,
  // and each block issues one atomic pair
  int gx = (sms > 0 ? sms : 1) * 16 / gy;
  const int groups = n_rows / kRowsPerWarp + (n_rows % kRowsPerWarp != 0);
  const int group_blocks = (groups + kWarps - 1) / kWarps;
  if (gx > group_blocks) gx = group_blocks;
  if (gx < 1) gx = 1;
  const uint64_t fmask = (1ull << (2 * k)) - 1;
  const bool wide = k > 16;
  const Window w{k, (uint32_t)fmask, (uint32_t)(fmask >> 32),
                 (1u << k) - 1, (wide ? 64 : 32) - 2 * k};
  const Planes in{static_cast<const uint8_t*>(data),
                  static_cast<const uint8_t*>(vbits), stride, vstride,
                  normalized};
  const dim3 grid((unsigned)gx, (unsigned)gy);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int32_t* len = static_cast<const int32_t*>(lengths);
  int32_t* k1 = static_cast<int32_t*>(keys);
  int32_t* k2 = static_cast<int32_t*>(keys2);
  unsigned long long* t = static_cast<unsigned long long*>(tallies);
  if (packed && wide) {
    launch_one<kMode, true, true>(grid, st, in, len, k1, k2, t, n_rows, width,
                                  segs, w, mask);
  } else if (packed) {
    launch_one<kMode, true, false>(grid, st, in, len, k1, k2, t, n_rows,
                                   width, segs, w, mask);
  } else if (wide) {
    launch_one<kMode, false, true>(grid, st, in, len, k1, k2, t, n_rows,
                                   width, segs, w, mask);
  } else {
    launch_one<kMode, false, false>(grid, st, in, len, k1, k2, t, n_rows,
                                    width, segs, w, mask);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// keys [rows, L] int32 and tallies [2] (zeroed by the caller) are written
// on `stream`.  Returns cudaGetLastError() after the launch.
extern "C" int nt_hash_keys(const void* data, const void* vbits,
                            const void* lengths, void* keys, void* tallies,
                            long long rows, long long L, long long stride,
                            long long vstride, int k, unsigned int mask,
                            int packed, int normalized, void* stream) {
  return launch<kKeys>(data, vbits, lengths, keys, nullptr, tallies, rows, L,
                       stride, vstride, k, mask, packed, normalized, stream);
}

// The tally mode: idx and weight [rows, L] int32 and tallies [2] (zeroed
// by the caller) are written on `stream`.
extern "C" int nt_hash_tally(const void* data, const void* vbits,
                             const void* lengths, void* idx, void* weight,
                             void* tallies, long long rows, long long L,
                             long long stride, long long vstride, int k,
                             unsigned int mask, int packed, int normalized,
                             void* stream) {
  return launch<kTally>(data, vbits, lengths, idx, weight, tallies, rows, L,
                        stride, vstride, k, mask, packed, normalized, stream);
}

// The planes mode: hi and lo [rows, L] int32 and tallies [2] (zeroed by
// the caller) are written on `stream`.
extern "C" int nt_key_planes(const void* data, const void* vbits,
                             const void* lengths, void* hi, void* lo,
                             void* tallies, long long rows, long long L,
                             long long stride, long long vstride, int k,
                             int packed, int normalized, void* stream) {
  return launch<kPlanes>(data, vbits, lengths, hi, lo, tallies, rows, L,
                         stride, vstride, k, 0u, packed, normalized, stream);
}
