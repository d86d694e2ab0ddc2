// Run lengths of a sorted key stream: the exact count of every distinct key
// in one flush (count.unique_counts after its sort).
//
// Replaces no Pallas kernel.  The JAX package takes the run lengths from an
// XLA suffix cummin over the run heads' positions
// (needletail_tpu/device/count.py:154); the port took them from PyTorch's
// scatter_reduce_ "amin" of every lane's position into its run's slot and a
// gather, whose atomics on one slot serialise a long run (a flush's
// sentinel padding is one run of up to half its lanes).
//
// Input: n int64 keys ascending under a signed compare, as count._pack
// packs them: wide (k > 15) keys with the sign bit flipped, the sentinel
// INT64_MAX; narrow keys their uint32 value, the sentinel 0xFFFFFFFF.  The
// sentinel sorts last.  Output, int32 a lane: lo, the key's low 32 bits; hi
// (wide only), its high 32 bits with the sign flip undone; counts, the run's
// length at each run's first lane and 0 at every other lane and on the
// sentinel's run.
//
// What bounds it on Hopper: device memory.  A lane reads its 8-byte key
// and writes 4 bytes of count, plus 8 bytes of unpacked planes (4 narrow).
// One launch, no atomics, no host sync; each output lane has one writer:
//   * a CTA takes a tile of kTile lanes, kItems consecutive lanes a thread,
//     loaded as 16-byte vectors; the key before a thread's first comes from
//     its neighbour by a shuffle (a warp's first lane loads it), so each
//     lane knows whether it heads its run;
//   * a head's length is the distance to the next head.  The next head
//     inside the thread's lanes is in its registers; past them, a ballot
//     finds it in the warp and a table of each warp's first head, in
//     shared memory, in a later warp of the tile.  Position n counts as a
//     head, so the last run ends there;
//   * only the tile's last run can cross the tile's end.  Its head's warp
//     searches device memory for the run's end together: 32 probes a step
//     at strides growing 32-fold, then 32-fold narrowing, so a run that
//     goes r lanes past the tile costs about 2 log32(r) warp loads;
//   * a sentinel head writes 0 and never searches, and a lane inside a run
//     writes 0: the padding run costs one read and one write a lane, like
//     any other lane.
// The outputs are stored as 16-byte vectors, a warp's stores contiguous.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 4;  // consecutive lanes a thread
constexpr int kTile = kThreads * kItems;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr long long kNone = 0x7FFFFFFFFFFFFFFFLL;  // no head found

// The first position p > lo with p == n or keys[p] != key, where keys[lo]
// is key: the calling warp's lanes probe together.
__device__ long long run_end(const long long* __restrict__ keys, long long n,
                             long long lo, long long key) {
  const int lane = threadIdx.x & 31;
  long long stride = 1;
  long long hi;
  for (;;) {
    const long long p = lo + (lane + 1) * stride;
    const unsigned ends =
        __ballot_sync(kFull, p >= n || __ldg(keys + p) != key);
    if (ends) {
      const int f = __ffs(ends) - 1;
      hi = lo + (f + 1) * stride;
      lo += f * stride;
      break;
    }
    lo += 32 * stride;
    stride *= 32;
  }
  if (hi > n) hi = n;
  // keys[lo] is key; hi is n or keys[hi] is not
  while (hi - lo > 1) {
    const long long s = (hi - lo + 31) / 32;
    long long p = lo + (lane + 1) * s;
    if (p > hi) p = hi;
    const unsigned ends =
        __ballot_sync(kFull, p >= n || __ldg(keys + p) != key);
    const int f = __ffs(ends) - 1;  // lane 31 probes hi, so ends != 0
    const long long next_hi = lo + (f + 1) * s;
    lo += f * s;
    if (next_hi < hi) hi = next_hi;
  }
  return hi;
}

template <bool kWide>
__global__ void __launch_bounds__(kThreads)
    run_counts_kernel(const long long* __restrict__ keys, long long n,
                      long long sentinel, bool aligned, int* __restrict__ hi_out,
                      int* __restrict__ lo_out, int* __restrict__ counts_out) {
  __shared__ long long warp_first[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long tile_end = ((long long)blockIdx.x + 1) * kTile;
  const long long base = tile_end - kTile + threadIdx.x * kItems;
  const bool vector = aligned && base + kItems <= n;

  long long key[kItems];
  if (vector) {
    const longlong2* v = reinterpret_cast<const longlong2*>(keys + base);
    const longlong2 a = __ldg(v);
    const longlong2 b = __ldg(v + 1);
    key[0] = a.x;
    key[1] = a.y;
    key[2] = b.x;
    key[3] = b.y;
  } else {
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      key[i] = base + i < n ? __ldg(keys + base + i) : sentinel;
    }
  }
  long long before = __shfl_up_sync(kFull, key[kItems - 1], 1);
  if (lane == 0 && base > 0 && base <= n) before = __ldg(keys + base - 1);

  // bit i: lane base + i heads a run, or is position n
  unsigned heads = 0;
  long long last_key = 0;  // the key of the thread's last head below n
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const long long p = base + i;
    const long long prev = i ? key[i - 1] : before;
    const bool head = p < n ? p == 0 || key[i] != prev : p == n;
    heads |= (unsigned)head << i;
    if (head && p < n) last_key = key[i];
  }

  // the first head past the thread's lanes: in its warp, by ballot ...
  const long long first = heads ? base + __ffs(heads) - 1 : kNone;
  const unsigned with_heads = __ballot_sync(kFull, heads != 0);
  const unsigned later = with_heads & ~((2u << lane) - 1u);
  long long next = __shfl_sync(kFull, first, later ? __ffs(later) - 1 : lane);
  if (!later) next = kNone;
  const long long warp_head =
      __shfl_sync(kFull, first, with_heads ? __ffs(with_heads) - 1 : 0);
  if (lane == 0) warp_first[warp] = with_heads ? warp_head : kNone;
  __syncthreads();
  // ... in a later warp of the tile ...
  if (heads && next == kNone) {
    for (int w = warp + 1; w < kWarps; ++w) {
      if (warp_first[w] != kNone) {
        next = warp_first[w];
        break;
      }
    }
  }
  // ... or, for the tile's last run, past the tile's end
  const int last = heads ? 31 - __clz(heads) : 0;
  const bool crosses = heads && next == kNone && base + last < n &&
                       last_key != sentinel;
  const unsigned searching = __ballot_sync(kFull, crosses);
  if (searching) {
    const int who = __ffs(searching) - 1;
    const long long end =
        run_end(keys, n, tile_end - 1, __shfl_sync(kFull, last_key, who));
    if (lane == who) next = end;
  }

  int count[kItems];
  long long after = next;  // the next head past lane i
#pragma unroll
  for (int i = kItems - 1; i >= 0; --i) {
    const long long p = base + i;
    const bool head = (heads >> i) & 1u;
    count[i] = head && p < n && key[i] != sentinel ? (int)(after - p) : 0;
    if (head) after = p;
  }

  int lo[kItems];
  int hi[kItems];
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const unsigned long long bits = (unsigned long long)key[i];
    lo[i] = (int)(unsigned)bits;
    hi[i] = (int)((unsigned)(bits >> 32) ^ 0x80000000u);
  }
  if (vector) {
    *reinterpret_cast<int4*>(counts_out + base) =
        make_int4(count[0], count[1], count[2], count[3]);
    *reinterpret_cast<int4*>(lo_out + base) = make_int4(lo[0], lo[1], lo[2], lo[3]);
    if (kWide) {
      *reinterpret_cast<int4*>(hi_out + base) =
          make_int4(hi[0], hi[1], hi[2], hi[3]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      if (base + i < n) {
        counts_out[base + i] = count[i];
        lo_out[base + i] = lo[i];
        if (kWide) hi_out[base + i] = hi[i];
      }
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// Writes the unpacked planes and run counts of the n sorted int64 keys
// `keys` (count._pack's packing; `wide` nonzero for wide keys, whose
// sentinel is INT64_MAX, else 0xFFFFFFFF) into the int32 arrays hi (wide
// only; may be null otherwise), lo and counts of n lanes each, on `stream`.
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for a
// bad size).
extern "C" int nt_run_counts(const void* keys, long long n, int wide, void* hi,
                             void* lo, void* counts, void* stream) {
  if (n <= 0 || (wide && hi == nullptr)) return (int)cudaErrorInvalidValue;
  const long long tiles = (n + kTile - 1) / kTile;
  if (tiles > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long* k = static_cast<const long long*>(keys);
  const bool aligned = aligned16(keys) && aligned16(lo) && aligned16(counts) &&
                       (!wide || aligned16(hi));
  if (wide) {
    run_counts_kernel<true><<<(unsigned)tiles, kThreads, 0, s>>>(
        k, n, 0x7FFFFFFFFFFFFFFFLL, aligned, static_cast<int*>(hi),
        static_cast<int*>(lo), static_cast<int*>(counts));
  } else {
    run_counts_kernel<false><<<(unsigned)tiles, kThreads, 0, s>>>(
        k, n, 0xFFFFFFFFLL, aligned, nullptr, static_cast<int*>(lo),
        static_cast<int*>(counts));
  }
  return (int)cudaGetLastError();
}
