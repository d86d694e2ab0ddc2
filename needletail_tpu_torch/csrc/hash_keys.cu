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
//   valid     all k codes are bases and p + k <= length[row]
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
// What bounds it on Hopper: the planes it writes (4 or 8 bytes a lane)
// and the per-lane window build (k shared-memory reads and shifts); the
// tally mode writes 8 bytes a lane, twice the keys mode, for the same
// information, as the TPU kernel's scatter-add interface asked.  The TPU
// kernel built windows with doubling ladders of rolled planes because a
// TPU lane has no 64-bit integers; here one thread holds a whole k <= 31
// window in a uint64_t.  Each block stages one tile of codes (plus the
// k - 1 lanes that the tile's last windows reach into) in shared memory,
// decoding ASCII or unpacking the 2-bit transport on that load, so the
// unpack that XLA ran as a separate pass on the TPU is fused here.  Lanes
// are numbered across the flattened [rows, L] plane, so a short read
// length wastes no threads; a window that crosses a row end always fails
// the length test.  Blocks walk tiles in a grid-stride loop and keep
// their tallies in registers, so each block issues two global atomics in
// all.  No limit on L: the TPU's VMEM budget does not apply.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxK = 31;
constexpr uint8_t kInvalid = 255;

struct Planes {
  const uint8_t* data;   // ASCII [rows, stride] or 2-bit codes [rows, stride]
  const uint8_t* vbits;  // validity bits [rows, vstride] or nullptr
  long long stride;
  long long vstride;
  int packed;
  int normalized;
};

__device__ __forceinline__ uint8_t encode_ascii(uint8_t b, int normalized) {
  const uint8_t up = b & 0xDF;
  if (up == 'A') return 0;
  if (up == 'C') return 1;
  if (up == 'G') return 2;
  if (up == 'T' || (normalized && up == 'U')) return 3;
  return kInvalid;
}

__device__ __forceinline__ uint8_t load_code(const Planes& in, long long row,
                                             long long p) {
  if (!in.packed) {
    return encode_ascii(in.data[row * in.stride + p], in.normalized);
  }
  // base p sits at bits 2*(p&3) of byte p>>2; its validity at bit p&7 of
  // byte p>>3
  const uint8_t c = (in.data[row * in.stride + (p >> 2)] >> (2 * (p & 3))) & 3;
  if (in.vbits != nullptr &&
      !((in.vbits[row * in.vstride + (p >> 3)] >> (p & 7)) & 1)) {
    return kInvalid;
  }
  return c;
}

// what a launch writes to keys (and keys2)
enum Mode : int {
  kKeys = 0,    // hash keys, -1 where invalid
  kPlanes = 1,  // canonical hi to keys, lo to keys2, -1 where invalid
  kTally = 2,   // hash keys, 0 where invalid, to keys; the 0/1 weight to keys2
};

template <int kMode>
__global__ void __launch_bounds__(kThreads)
    hash_keys_kernel(Planes in, const int32_t* __restrict__ lengths,
                     int32_t* __restrict__ keys,
                     int32_t* __restrict__ keys2,
                     unsigned long long* __restrict__ tallies, long long rows,
                     long long L, int k, uint32_t mask) {
  __shared__ uint8_t tile[kThreads + kMaxK];
  const long long n = rows * L;
  const long long n_tiles = (n + kThreads - 1) / kThreads;
  unsigned int total = 0;
  unsigned int fwd_total = 0;

  for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const long long g0 = t * kThreads;
    for (int i = threadIdx.x; i < kThreads + k - 1; i += kThreads) {
      const long long g = g0 + i;
      uint8_t c = kInvalid;
      if (g < n) {
        const long long row = g / L;
        c = load_code(in, row, g - row * L);
      }
      tile[i] = c;
    }
    __syncthreads();

    const long long g = g0 + threadIdx.x;
    bool valid = false;
    bool use_rc = false;
    if (g < n) {
      const long long row = g / L;
      const long long end = (g - row * L) + k;
      valid = end <= (long long)lengths[row] && end <= L;
      uint64_t fwd = 0;
      uint64_t rc = 0;
      for (int j = 0; j < k; ++j) {
        const uint32_t c = tile[threadIdx.x + j];
        valid = valid && c < 4;
        fwd = (fwd << 2) | (c & 3);
        rc |= (uint64_t)(3 - (c & 3)) << (2 * j);
      }
      use_rc = fwd > rc;
      const uint64_t canon = use_rc ? rc : fwd;
      const uint32_t hi = (uint32_t)(canon >> 32);
      const uint32_t lo = (uint32_t)canon;
      if (kMode == kPlanes) {
        keys[g] = valid ? (int32_t)hi : -1;
        keys2[g] = valid ? (int32_t)lo : -1;
      } else {
        const uint32_t h = ((lo * 0x9E3779B1u) ^ (hi * 0x85EBCA77u)) & mask;
        if (kMode == kTally) {
          keys[g] = valid ? (int32_t)h : 0;
          keys2[g] = valid ? 1 : 0;
        } else {
          keys[g] = valid ? (int32_t)h : -1;
        }
      }
    }
    // both counts come back to every thread; the barrier also keeps the
    // next tile's staging from overwriting codes still being read
    total += __syncthreads_count(valid);
    fwd_total += __syncthreads_count(valid && !use_rc);
  }
  if (threadIdx.x == 0 && total != 0) {
    atomicAdd(&tallies[0], (unsigned long long)total);
    atomicAdd(&tallies[1], (unsigned long long)fwd_total);
  }
}

template <int kMode>
int launch(const void* data, const void* vbits, const void* lengths,
           void* keys, void* keys2, void* tallies, long long rows,
           long long L, long long stride, long long vstride, int k,
           unsigned int mask, int packed, int normalized, void* stream) {
  if (k < 1 || k > kMaxK || rows <= 0 || L <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  int device = 0;
  int sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const long long n_tiles = (rows * L + kThreads - 1) / kThreads;
  const long long cap = (long long)(sms > 0 ? sms : 1) * 16;
  const unsigned int blocks = (unsigned int)(n_tiles < cap ? n_tiles : cap);
  Planes in{static_cast<const uint8_t*>(data),
            static_cast<const uint8_t*>(vbits), stride, vstride, packed,
            normalized};
  hash_keys_kernel<kMode>
      <<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          in, static_cast<const int32_t*>(lengths),
          static_cast<int32_t*>(keys), static_cast<int32_t*>(keys2),
          static_cast<unsigned long long*>(tallies), rows, L, k, mask);
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
