// Sort of every block_lanes span of a uint32 stream, ascending.
//
// Replaces benchmarks/exp_mosaic_sort.py:bitonic_block_sort (body
// _bitonic_kernel), an experiment that measured a VMEM-resident bitonic
// network against XLA's sort on the TPU.  The result is the same: each
// span sorted ascending as uint32, out of place, for any power-of-two
// span >= 128 that divides N.
//
// What held the first design back: one CTA ran every stage of a
// 2^15-lane tile in shared memory, one thread per pair and a barrier per
// stage (up to 120), with 2-way bank conflicts at strides below 32 and
// 64-bit index math; spans past the tile ran each larger stride as a
// bitonic pass over device memory and then re-ran a tile pass.  At 2^23
// lanes it took 0.49 / 0.69 / 0.81 ms for 2^14 / 2^16 / 2^17-lane spans,
// slower than torch.sort over rows of 2^17 (0.72 ms; H100 80GB HBM3,
// 700 W, chip_smoke.py), against a byte bound of 0.020 ms.
//
// What bounds this one: the SMs' issue rate for the compare-exchanges of
// the in-CTA network (shuffles and min/max, no barrier below stride 512),
// then device-memory bytes, one read and one write a merge pass.  The
// tile is 8,192 lanes, not the 2^15 of one CTA's shared memory: 16 keys a
// thread at 512 threads keeps the network in registers (103 a thread, no
// spill), and a merge pass costs about 0.03 ms at 2^23 lanes.  At 2^23
// lanes it takes 0.2113 / 0.3112 / 0.3605 ms for 2^14 / 2^16 / 2^17-lane
// spans, against the first design's 0.4924 / 0.6853 / 0.8144 ms in the
// same run (H100 80GB HBM3, 700.00 W, bench/redesign_times.py), and is
// faster than torch.sort over rows of each span and than a flat sort of
// all the keys (chip_smoke.py).  A cluster of CTAs holding a span
// in distributed shared memory, the other way past one CTA, was not
// tried.  The design:
//
//   tile sort  one CTA of 512 threads sorts an 8,192-lane tile; each
//              thread holds 16 keys in registers.  Strides below 16 run
//              in registers, strides up to 256 (32 threads x 16) by
//              __shfl_xor_sync inside a warp with no barrier, and only
//              the 10 stages of stride >= 512 go through shared memory,
//              one barrier each, in a layout padded by one word per 32
//              (i + i/32), so neither those stages nor the moves between
//              registers and shared memory meet a bank conflict.  A span
//              shorter than the tile sorts as its own network inside it.
//   merges     a span larger than the tile doubles its sorted runs by one
//              merge pass over device memory each: 1 pass at 2^14, 3 at
//              2^16, 4 at 2^17.  A small kernel finds, for every 4,096-lane
//              output chunk, its split of the two input runs by a co-rank
//              (merge-path) binary search; the merge kernel stages the
//              chunk's inputs in shared memory, each thread finds its own
//              16 outputs by the same search there and merges them
//              sequentially.  Ties take the left run first, in every
//              search, so equal keys split consistently.
//
// The passes ping-pong between `out` and a scratch buffer chosen so the
// last one lands in `out`; `in` is only read, and no pass writes where it
// reads.  All index math is 32-bit (N <= 2^31).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kR = 16;              // keys a thread holds
constexpr int kLogR = 4;
constexpr int kTileThreads = 512;
constexpr int kTile = kR * kTileThreads;  // 8,192 lanes
constexpr int kLogTile = 13;
constexpr int kLogWarpSpan = kLogR + 5;   // strides below 512 stay in a warp
constexpr int kMergeThreads = 256;
constexpr int kMergePer = 16;             // outputs a merge thread makes
constexpr int kChunk = kMergeThreads * kMergePer;  // 4,096 lanes

__device__ __forceinline__ unsigned pad(unsigned i) { return i + (i >> 5); }

__device__ __forceinline__ void order(uint32_t& a, uint32_t& b, bool asc) {
  const uint32_t lo = min(a, b);
  const uint32_t hi = max(a, b);
  a = asc ? lo : hi;
  b = asc ? hi : lo;
}

// Sorts tile blockIdx.x of `in` into `out`: spans of min(2^log_b, kTile)
// lanes ascending.  bmask is 2^log_b - 1.  A last tile shorter than
// kTile is padded with all-ones keys, which sort among themselves in
// their own spans and are not written back.
__global__ void __launch_bounds__(kTileThreads)
    tile_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
                unsigned n, unsigned bmask, int log_b) {
  __shared__ uint32_t s[kTile + kTile / 32];
  const unsigned base = blockIdx.x * kTile;
  const unsigned count = min((unsigned)kTile, n - base);
  const unsigned t = threadIdx.x;
  for (unsigned i = t; i < kTile; i += kTileThreads) {
    s[pad(i)] = i < count ? in[base + i] : 0xFFFFFFFFu;
  }
  __syncthreads();
  uint32_t x[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) x[r] = s[pad(t * kR + r)];
  const int levels = min(log_b, kLogTile);
  const unsigned lane = t & 31;

#pragma unroll
  for (int lk = 1; lk <= kLogTile; ++lk) {
    if (lk > levels) break;
    const unsigned k = 1u << lk;
    const unsigned kb = k & bmask;  // 0 at the span's last level: all ascend
    if (lk - 1 >= kLogWarpSpan) {
      // strides that cross warps, through shared memory
      __syncthreads();  // every thread has read the last level's keys
#pragma unroll
      for (int r = 0; r < kR; ++r) s[pad(t * kR + r)] = x[r];
      __syncthreads();
#pragma unroll
      for (int lj = lk - 1; lj >= kLogWarpSpan; --lj) {
        const unsigned j = 1u << lj;
#pragma unroll
        for (int q = 0; q < kR / 2; ++q) {
          const unsigned p = q * kTileThreads + t;
          const unsigned i = ((p & ~(j - 1)) << 1) | (p & (j - 1));
          uint32_t a = s[pad(i)];
          uint32_t b = s[pad(i + j)];
          order(a, b, (i & kb) == 0);
          s[pad(i)] = a;
          s[pad(i + j)] = b;
        }
        __syncthreads();
      }
#pragma unroll
      for (int r = 0; r < kR; ++r) x[r] = s[pad(t * kR + r)];
    }
    // strides inside a warp: the partner holds the same register
    const bool asc = ((t * kR) & kb) == 0;
#pragma unroll
    for (int lj = (lk - 1 < kLogWarpSpan - 1 ? lk - 1 : kLogWarpSpan - 1);
         lj >= kLogR; --lj) {
      const unsigned m = 1u << (lj - kLogR);
      const bool keep_min = asc == ((lane & m) == 0);
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const uint32_t b = __shfl_xor_sync(0xFFFFFFFFu, x[r], m);
        x[r] = keep_min ? min(x[r], b) : max(x[r], b);
      }
    }
    // strides inside a thread
#pragma unroll
    for (int lj = (lk - 1 < kLogR - 1 ? lk - 1 : kLogR - 1); lj >= 0; --lj) {
      const int j = 1 << lj;
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        if ((r & j) == 0) {
          order(x[r], x[r | j], (((t * kR) | r) & kb) == 0);
        }
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kR; ++r) s[pad(t * kR + r)] = x[r];
  __syncthreads();
  for (unsigned i = t; i < count; i += kTileThreads) out[base + i] = s[pad(i)];
}

// The co-rank of output position d in the merge of a[0, na) and
// b[0, nb): how many of the first d outputs come from a.  Ties take a
// first.
__device__ __forceinline__ unsigned co_rank(const uint32_t* a, unsigned na,
                                            const uint32_t* b, unsigned nb,
                                            unsigned d) {
  unsigned lo = d > nb ? d - nb : 0;
  unsigned hi = d < na ? d : na;
  while (lo < hi) {
    const unsigned mid = (lo + hi) >> 1;
    if (a[mid] <= b[d - 1 - mid]) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// split[c]: the co-rank of output chunk c's first lane in its pair of
// sorted runs of `run` lanes (run a power of two >= kChunk).
__global__ void split_kernel(const uint32_t* __restrict__ src,
                             unsigned* __restrict__ split, unsigned chunks,
                             unsigned run) {
  const unsigned c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= chunks) return;
  const unsigned g = c * kChunk;
  const unsigned pair = g & ~(2 * run - 1);
  const uint32_t* a = src + pair;
  split[c] = co_rank(a, run, a + run, run, g - pair);
}

// One merge pass: every pair of sorted `run`-lane runs of src into one
// sorted 2 * run-lane run of dst, one kChunk-lane output chunk a CTA.
__global__ void __launch_bounds__(kMergeThreads)
    merge_kernel(const uint32_t* __restrict__ src, uint32_t* __restrict__ dst,
                 const unsigned* __restrict__ split, unsigned run) {
  __shared__ uint32_t s[kChunk];
  const unsigned g = blockIdx.x * kChunk;
  const unsigned pair = g & ~(2 * run - 1);
  const unsigned d0 = g - pair;
  const unsigned d1 = d0 + kChunk;
  const unsigned i0 = split[blockIdx.x];
  const unsigned i1 = d1 == 2 * run ? run : split[blockIdx.x + 1];
  const unsigned na = i1 - i0;
  const unsigned nb = kChunk - na;
  const uint32_t* a = src + pair + i0;
  const uint32_t* b = src + pair + run + (d0 - i0);
  for (unsigned i = threadIdx.x; i < kChunk; i += kMergeThreads) {
    s[i] = i < na ? a[i] : b[i - na];
  }
  __syncthreads();
  const unsigned d = threadIdx.x * kMergePer;
  unsigned ai = co_rank(s, na, s + na, nb, d);
  unsigned bi = d - ai;
  uint32_t o[kMergePer];
#pragma unroll
  for (int m = 0; m < kMergePer; ++m) {
    // a run that is used up reads lane 0 instead (s[na] may lie past s)
    const uint32_t av = s[ai < na ? ai : 0];
    const uint32_t bv = s[bi < nb ? na + bi : 0];
    const bool take_a = ai < na && (bi >= nb || av <= bv);
    o[m] = take_a ? av : bv;
    ai += take_a;
    bi += !take_a;
  }
  uint4* out = reinterpret_cast<uint4*>(dst + g + d);
#pragma unroll
  for (int q = 0; q < kMergePer / 4; ++q) {
    out[q] = make_uint4(o[4 * q], o[4 * q + 1], o[4 * q + 2], o[4 * q + 3]);
  }
}

bool valid_args(long long n, long long block) {
  return n > 0 && n <= (1LL << 31) && block >= 2 &&
         (block & (block - 1)) == 0 && n % block == 0;
}

// merge passes a span of `block` lanes takes
int passes(long long block) {
  int p = 0;
  for (long long run = kTile; run < block; run <<= 1) ++p;
  return p;
}

}  // namespace

// Lanes of int32 scratch nt_block_sort needs for n lanes in spans of
// `block`: 0 when a span fits one tile, else n for the ping-pong buffer
// plus one split per output chunk.  -1 for arguments nt_block_sort
// refuses.
extern "C" long long nt_block_sort_scratch(long long n, long long block) {
  if (!valid_args(n, block)) return -1;
  return passes(block) == 0 ? 0 : n + n / kChunk;
}

// out [n] gets in [n] with every `block` span sorted ascending as uint32,
// on `stream`.  block is a power of two >= 2 dividing n, n <= 2^31;
// scratch holds nt_block_sort_scratch(n, block) lanes (none: nullptr).
// `in` is not written.  Returns cudaGetLastError() after the last launch,
// or the first error.
extern "C" int nt_block_sort(const void* in, void* out, void* scratch,
                             long long n, long long block, void* stream) {
  if (!valid_args(n, block)) return (int)cudaErrorInvalidValue;
  const int n_pass = passes(block);
  if (n_pass > 0 && scratch == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned un = (unsigned)n;
  uint32_t* bufs[2] = {static_cast<uint32_t*>(out),
                       static_cast<uint32_t*>(scratch)};
  // the tile sort writes where an even number of passes later lands in out
  int cur = n_pass % 2;
  int log_b = 0;
  while ((1LL << log_b) < block) ++log_b;
  const unsigned tiles = (unsigned)((n + kTile - 1) / kTile);
  tile_kernel<<<tiles, kTileThreads, 0, st>>>(
      static_cast<const uint32_t*>(in), bufs[cur], un,
      (unsigned)(block - 1), log_b);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (n_pass == 0) return 0;
  unsigned* split = reinterpret_cast<unsigned*>(bufs[1] + n);
  const unsigned chunks = un / kChunk;
  for (long long run = kTile; run < block; run <<= 1) {
    split_kernel<<<(chunks + 255) / 256, 256, 0, st>>>(bufs[cur], split,
                                                        chunks, (unsigned)run);
    merge_kernel<<<chunks, kMergeThreads, 0, st>>>(bufs[cur], bufs[1 - cur],
                                                   split, (unsigned)run);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    cur = 1 - cur;
  }
  return 0;
}
