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
// narrow), one slot per 8 lanes at the defaults.  The TPU kernel selected
// entries with one-hot matmuls on the MXU, since a TPU core has no cheap
// scatter.  Here one warp compacts one chunk, and the warps of a CTA walk
// chunks of their own: no shared memory and no block barrier.  The lanes
// of a chunk go in segments of 32 V lanes, thread t holding lanes [V t, V t
// + V) of a segment, so that a warp's loads coalesce: V = 4 (one 16-byte
// load of counts a thread) when chunk is a multiple of 128 and counts is
// 16-byte aligned, else V = 1 (scalar loads).  A warp issues the loads of
// kSegs segments before it uses any.  Per segment, each thread makes a
// V-bit mask of its flags; V ballots, one per position in the thread's
// lanes, give each thread the count of flags in the lanes before its own
// (the warp's exclusive scan) and the segment's total, which carries to
// the next segment and tile.  A flagged lane reads its hi/lo and writes
// its slot straight away; the warp then writes the chunk's zero tail with
// 16-byte stores where the slots are aligned.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // warps a CTA
constexpr int kThreads = 32 * kWarps;
constexpr int kSegs = 4;   // segments a warp loads before it uses any
// CTAs an SM keeps resident: registers capped at 64 a thread, so 32 warps
// an SM each keep a chunk's loads in flight
constexpr int kMinBlocks = 4;
constexpr int kGroup = 8;  // chunks per padding unit, as the Pallas grid
constexpr unsigned kFull = 0xFFFFFFFFu;

// counts at lanes [i, i + V) of the chunk that starts at lane `first` (0
// past the chunk or past n)
template <int V>
__device__ __forceinline__ void load_lanes(const int32_t* __restrict__ counts,
                                           long long first, int i, int chunk,
                                           long long n, int32_t (&c)[V]) {
  const long long g = first + i;
  if constexpr (V == 4) {
    if (i < chunk && g + 3 < n) {
      const int4 v = __ldg(reinterpret_cast<const int4*>(counts + g));
      c[0] = v.x;
      c[1] = v.y;
      c[2] = v.z;
      c[3] = v.w;
      return;
    }
  }
#pragma unroll
  for (int j = 0; j < V; ++j) {
    c[j] = (i + j < chunk && g + j < n) ? __ldg(counts + g + j) : 0;
  }
}

// p[from, to) = 0 by one warp, 16-byte stores where p + j is aligned
__device__ __forceinline__ void zero_slots(int32_t* __restrict__ p,
                                           long long from, long long to,
                                           int lane) {
  long long a = to;
  long long b = to;
  if ((reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    a = (from + 3) & ~3LL;
    if (a > to) a = to;
    b = to & ~3LL;
    if (b < a) b = a;
  }
  for (long long j = from + lane; j < a; j += 32) p[j] = 0;
  int4* q = reinterpret_cast<int4*>(p);
  for (long long j = a / 4 + lane; j < b / 4; j += 32) q[j] = make_int4(0, 0, 0, 0);
  for (long long j = b + lane; j < to; j += 32) p[j] = 0;
}

template <bool kWide, int V>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    compact_slots_kernel(const int32_t* __restrict__ hi,
                         const int32_t* __restrict__ lo,
                         const int32_t* __restrict__ counts, long long n,
                         long long n_chunks, int chunk, int slots,
                         int32_t* __restrict__ out_hi,
                         int32_t* __restrict__ out_lo,
                         int32_t* __restrict__ out_counts,
                         int* __restrict__ overflow) {
  constexpr int kSeg = 32 * V;
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const long long warps = (long long)gridDim.x * kWarps;
  for (long long w = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
       w < n_chunks; w += warps) {
    const long long first = w * chunk;
    const long long slot0 = w * slots;
    int seen = 0;  // flags in the chunk's earlier segments (warp-uniform)
    for (int tile = 0; tile < chunk; tile += kSegs * kSeg) {
      int32_t c[kSegs][V];
#pragma unroll
      for (int s = 0; s < kSegs; ++s) {
        load_lanes<V>(counts, first, tile + s * kSeg + lane * V, chunk, n, c[s]);
      }
#pragma unroll
      for (int s = 0; s < kSegs; ++s) {
        unsigned mask = 0;
#pragma unroll
        for (int j = 0; j < V; ++j) mask |= (c[s][j] > 0 ? 1u : 0u) << j;
        int before = 0;
        int total = 0;
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const unsigned ballot = __ballot_sync(kFull, (mask >> j) & 1u);
          before += __popc(ballot & below);
          total += __popc(ballot);
        }
        int slot = seen + before;
#pragma unroll
        for (int j = 0; j < V; ++j) {
          if ((mask >> j) & 1u) {
            if (slot < slots) {
              const long long g = first + tile + s * kSeg + lane * V + j;
              if (kWide) out_hi[slot0 + slot] = hi[g];
              out_lo[slot0 + slot] = lo[g];
              out_counts[slot0 + slot] = c[s][j];
            }
            ++slot;
          }
        }
        seen += total;
      }
    }
    const long long used = slot0 + (seen < slots ? seen : slots);
    if (kWide) zero_slots(out_hi, used, slot0 + slots, lane);
    zero_slots(out_lo, used, slot0 + slots, lane);
    zero_slots(out_counts, used, slot0 + slots, lane);
    if (lane == 0 && seen > slots) *overflow = 1;
  }
}

template <bool kWide, int V>
cudaError_t launch(const int32_t* h, const int32_t* l, const int32_t* c,
                   long long n, long long n_chunks, int chunk, int slots,
                   int32_t* oh, int32_t* ol, int32_t* oc, int* ovf,
                   cudaStream_t s) {
  int device = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, compact_slots_kernel<kWide, V>, kThreads, 0);
  if (err != cudaSuccess) return err;
  // one wave of resident CTAs, each warp walking every (grid)th chunk
  long long blocks = (n_chunks + kWarps - 1) / kWarps;
  const long long resident = (long long)(sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
  if (blocks > resident) blocks = resident;
  compact_slots_kernel<kWide, V><<<(unsigned)blocks, kThreads, 0, s>>>(
      h, l, c, n, n_chunks, chunk, slots, oh, ol, oc, ovf);
  return cudaGetLastError();
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
  const long long n_chunks = (n + group - 1) / group * kGroup;
  const bool vector =
      chunk % 128 == 0 && (reinterpret_cast<uintptr_t>(counts) & 15) == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* h = static_cast<const int32_t*>(hi);
  const int32_t* l = static_cast<const int32_t*>(lo);
  const int32_t* c = static_cast<const int32_t*>(counts);
  int32_t* oh = static_cast<int32_t*>(out_hi);
  int32_t* ol = static_cast<int32_t*>(out_lo);
  int32_t* oc = static_cast<int32_t*>(out_counts);
  int* ovf = static_cast<int*>(overflow);
  cudaError_t err;
  if (hi != nullptr) {
    err = vector ? launch<true, 4>(h, l, c, n, n_chunks, chunk, slots, oh, ol, oc, ovf, s)
                 : launch<true, 1>(h, l, c, n, n_chunks, chunk, slots, oh, ol, oc, ovf, s);
  } else {
    err = vector ? launch<false, 4>(h, l, c, n, n_chunks, chunk, slots, oh, ol, oc, ovf, s)
                 : launch<false, 1>(h, l, c, n, n_chunks, chunk, slots, oh, ol, oc, ovf, s);
  }
  return (int)err;
}
