// Per-chunk slot compaction of a sorted run stream (the exact path's
// cascade step).
//
// Replaces needletail_tpu/device/pallas_kernels.py:mxu_compact_slots.  The
// input is the (hi, lo, counts) output of count.unique_counts: key planes
// (int32 uint32 bit patterns; hi absent for narrow k <= 15 keys) and run
// counts, nonzero only at the head of each distinct key's run.  The stream
// is cut into chunks of `chunk` lanes, and rounded up to a whole number of
// 8-chunk groups as the Pallas kernel pads it (lanes past n count as
// zero).  In every chunk the flagged entries (count > 0) move, in their
// input order, to the chunk's first `slots` output slots; the rest of its
// slots hold hi = lo = count = 0.  A chunk with more than `slots` flags
// keeps its first `slots` and raises the overflow word, which the caller
// reads as ok = false.
//
// What bounds it on Hopper: the 4-byte count it reads at every lane, hi/lo
// read only at the flagged lanes, and the 12 bytes a slot it writes (8
// narrow), one slot per 8 lanes at the defaults.
// The TPU kernel selected entries with one-hot matmuls on the MXU, since a
// TPU core has no cheap scatter; here one block compacts one chunk with a
// stream compaction written out by hand: each warp's flags come from
// __ballot_sync, a thread's rank among its warp's flags from __popc of the
// lanes below it, warp totals are scanned in shared memory by one warp
// with shuffles, and every flagged thread writes its entry straight to its
// slot.  A chunk longer than the block is walked in block-sized tiles that
// carry the running flag count, so order is kept across tiles.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kGroup = 8;  // chunks per padding unit, as the Pallas grid

template <bool kWide>
__global__ void __launch_bounds__(kMaxThreads)
    compact_slots_kernel(const int32_t* __restrict__ hi,
                         const int32_t* __restrict__ lo,
                         const int32_t* __restrict__ counts, long long n,
                         int chunk, int slots, int32_t* __restrict__ out_hi,
                         int32_t* __restrict__ out_lo,
                         int32_t* __restrict__ out_counts,
                         int* __restrict__ overflow) {
  __shared__ int warp_incl[kMaxThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const long long first = (long long)blockIdx.x * chunk;
  const long long slot0 = (long long)blockIdx.x * slots;
  int seen = 0;  // flags in earlier tiles of this chunk (same in every thread)

  for (int tile = 0; tile < chunk; tile += blockDim.x) {
    const int i = tile + threadIdx.x;
    const long long g = first + i;
    int32_t c = 0;
    if (i < chunk && g < n) {
      c = counts[g];
    }
    const bool flag = c > 0;
    const unsigned int ballot = __ballot_sync(0xFFFFFFFFu, flag);
    const int rank = __popc(ballot & ((1u << lane) - 1u));
    if (lane == 0) {
      warp_incl[warp] = __popc(ballot);
    }
    __syncthreads();
    if (warp == 0) {
      // inclusive scan of the warp totals
      int v = lane < n_warps ? warp_incl[lane] : 0;
      for (int d = 1; d < 32; d <<= 1) {
        const int up = __shfl_up_sync(0xFFFFFFFFu, v, d);
        if (lane >= d) v += up;
      }
      if (lane < n_warps) warp_incl[lane] = v;
    }
    __syncthreads();
    const int j = seen + (warp == 0 ? 0 : warp_incl[warp - 1]) + rank;
    if (flag && j < slots) {
      if (kWide) out_hi[slot0 + j] = hi[g];
      out_lo[slot0 + j] = lo[g];
      out_counts[slot0 + j] = c;
    }
    seen += warp_incl[n_warps - 1];
    // the next tile rewrites warp_incl
    __syncthreads();
  }
  for (int j = seen + threadIdx.x; j < slots; j += blockDim.x) {
    if (kWide) out_hi[slot0 + j] = 0;
    out_lo[slot0 + j] = 0;
    out_counts[slot0 + j] = 0;
  }
  if (threadIdx.x == 0 && seen > slots) {
    *overflow = 1;
  }
}

}  // namespace

// Compacts n lanes of (hi | nullptr, lo, counts) into
// ceil(n / (8 * chunk)) * 8 * slots output slots on `stream`; *overflow
// (zeroed by the caller) becomes 1 if a chunk holds more than `slots`
// flags.  chunk must be a positive multiple of 32.  Returns
// cudaGetLastError() after the launch.
extern "C" int nt_compact_slots(const void* hi, const void* lo,
                                const void* counts, long long n, int chunk,
                                int slots, void* out_hi, void* out_lo,
                                void* out_counts, void* overflow,
                                void* stream) {
  if (n <= 0 || chunk <= 0 || chunk % 32 != 0 || slots <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const long long group = (long long)kGroup * chunk;
  const long long blocks = (n + group - 1) / group * kGroup;
  const int threads = chunk < kMaxThreads ? chunk : kMaxThreads;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* h = static_cast<const int32_t*>(hi);
  const int32_t* l = static_cast<const int32_t*>(lo);
  const int32_t* c = static_cast<const int32_t*>(counts);
  int32_t* oh = static_cast<int32_t*>(out_hi);
  int32_t* ol = static_cast<int32_t*>(out_lo);
  int32_t* oc = static_cast<int32_t*>(out_counts);
  int* ovf = static_cast<int*>(overflow);
  if (hi != nullptr) {
    compact_slots_kernel<true><<<(unsigned int)blocks, threads, 0, s>>>(
        h, l, c, n, chunk, slots, oh, ol, oc, ovf);
  } else {
    compact_slots_kernel<false><<<(unsigned int)blocks, threads, 0, s>>>(
        h, l, c, n, chunk, slots, oh, ol, oc, ovf);
  }
  return (int)cudaGetLastError();
}
