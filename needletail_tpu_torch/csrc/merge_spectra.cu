// Merge of two key-sorted spectra on the device, summing the counts of
// equal keys (the streaming exact count's merge of each flush into the
// spectrum it keeps on the card).
//
// Replaces no TPU kernel: the JAX package merges its flushes on the host
// (needletail_tpu/device/count.py:merge_sorted_spectra, a stable argsort of
// the two arrays concatenated).  The port keeps a stream's spectrum on the
// card once the stream outgrows one flush, and merges each later flush into
// it here, so nothing crosses to the host until the stream ends.
//
// Input: A and B, each n int64 keys ascending under a signed compare and
// distinct within their side (count.py's packed keys: the sign bit flipped
// on wide keys, so the signed order is the unsigned one), with int64
// counts.  Output: the distinct keys of both, ascending, each with the sum
// of its counts, and their number n_out, which stays on the device.  Since
// each side is distinct, a key appears at most twice in the merge, A's copy
// right before B's.
//
// What bounds it on Hopper: device memory.  The least traffic is each
// input read once and each output written once, 16 bytes a key in and 16
// a key out; this design reads the keys twice and the counts once, 24
// bytes a key in.  It is a merge path in four launches:
//   1. partition: one thread per tile boundary binary-searches the
//      diagonal d = t * kTile of the merge grid, so tile t takes
//      A[i_t, i_{t+1}) and B[d_t - i_t, d_{t+1} - i_{t+1}), ties A first;
//   2. heads: a CTA loads its tile's keys into shared memory (coalesced,
//      with the key before each side's range), each thread finds its own
//      diagonal in shared memory, merges kItems keys in registers and
//      flags the run heads (a key unlike the one before it, the tile's
//      first key against the key before the tile); the CTA's head count
//      goes to device memory;
//   3. scan: one CTA turns the head counts into each tile's first output
//      slot and writes n_out;
//   4. write: the tile is merged again with its counts; a head's count is
//      its own plus that of B's next key when the two are equal (it may
//      lie past the thread's items or past the tile: each side's key after
//      the range is loaded too).  The heads are staged in shared memory at
//      their ranks in the tile, then stored coalesced.
// The write pass's tile of keys and counts takes 32 KB of shared memory
// and its threads 64 registers each: four CTAs an SM.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;  // merged keys a thread
constexpr int kTile = kThreads * kItems;
constexpr int kWarps = kThreads / 32;
constexpr int kScanThreads = 1024;
constexpr unsigned kFull = 0xFFFFFFFFu;

// number of A's keys among the first d of the merge, ties A first
__device__ __forceinline__ long long merge_path(const long long* __restrict__ a,
                                                long long na,
                                                const long long* __restrict__ b,
                                                long long nb, long long d) {
  long long lo = d - nb > 0 ? d - nb : 0;
  long long hi = d < na ? d : na;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (__ldg(a + mid) <= __ldg(b + d - 1 - mid)) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__global__ void partition_kernel(const long long* __restrict__ a, long long na,
                                 const long long* __restrict__ b, long long nb,
                                 long long tiles, long long* __restrict__ splits) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t > tiles) return;
  const long long total = na + nb;
  const long long d = t * kTile < total ? t * kTile : total;
  splits[t] = merge_path(a, na, b, nb, d);
}

// inclusive scan over the CTA's threads; *total gets the CTA's sum
template <typename T, int kBlock>
__device__ __forceinline__ T block_scan(T v, T* warp_sums, T* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const T y = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += y;
  }
  if (lane == 31) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    T w = lane < kBlock / 32 ? warp_sums[lane] : T(0);
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const T y = __shfl_up_sync(kFull, w, o);
      if (lane >= o) w += y;
    }
    if (lane < kBlock / 32) warp_sums[lane] = w;
  }
  __syncthreads();
  const T out = v + (warp > 0 ? warp_sums[warp - 1] : T(0));
  *total = warp_sums[kBlock / 32 - 1];
  __syncthreads();  // warp_sums may be reused right after
  return out;
}

// one tile of the merge grid in shared memory: s[0] = A[i0 - 1],
// s[1, 1 + la) = A[i0, i1), s[1 + la] = A[i1], s[2 + la] = B[j0 - 1],
// s[3 + la, 3 + la + lb) = B[j0, j1), s[3 + la + lb] = B[j1]; the keys
// beside a range are loaded where they exist
struct TileRange {
  long long i0, j0;
  int la, lb;
};

template <bool kCounts>
__device__ __forceinline__ TileRange load_tile(
    const long long* __restrict__ ak, const long long* __restrict__ ac,
    long long na, const long long* __restrict__ bk,
    const long long* __restrict__ bc, long long nb,
    const long long* __restrict__ splits, long long* sk, long long* sc) {
  const long long t = blockIdx.x;
  const long long total = na + nb;
  const long long d0 = t * kTile;
  const long long d1 = d0 + kTile < total ? d0 + kTile : total;
  TileRange r;
  r.i0 = splits[t];
  r.j0 = d0 - r.i0;
  const long long i1 = splits[t + 1];
  const long long j1 = d1 - i1;
  r.la = (int)(i1 - r.i0);
  r.lb = (int)(j1 - r.j0);
  const int la = r.la;
  const int len = la + r.lb;
  for (int x = threadIdx.x; x < len; x += kThreads) {
    if (x < la) {
      sk[1 + x] = __ldg(ak + r.i0 + x);
      if (kCounts) sc[1 + x] = __ldg(ac + r.i0 + x);
    } else {
      sk[3 + x] = __ldg(bk + r.j0 + x - la);
      if (kCounts) sc[3 + x] = __ldg(bc + r.j0 + x - la);
    }
  }
  if (threadIdx.x == 0 && r.i0 > 0) sk[0] = __ldg(ak + r.i0 - 1);
  if (threadIdx.x == 1 && i1 < na) {
    sk[1 + la] = __ldg(ak + i1);
    if (kCounts) sc[1 + la] = __ldg(ac + i1);
  }
  if (threadIdx.x == 2 && r.j0 > 0) sk[2 + la] = __ldg(bk + r.j0 - 1);
  if (threadIdx.x == 3 && j1 < nb) {
    sk[3 + len] = __ldg(bk + j1);
    if (kCounts) sc[3 + len] = __ldg(bc + j1);
  }
  __syncthreads();
  return r;
}

// the thread's kItems merged keys of the tile: each key, whether it heads
// its run, and (kCounts) its count with B's equal key's added; past the
// tile's end no key heads a run
template <bool kCounts>
__device__ __forceinline__ void merge_items(const TileRange& r, long long nb,
                                            const long long* sk,
                                            const long long* sc,
                                            long long (&key)[kItems],
                                            long long (&cnt)[kItems],
                                            bool (&head)[kItems]) {
  const int la = r.la;
  const int lb = r.lb;
  const long long* sa = sk + 1;
  const long long* sb = sk + 3 + la;
  const int diag0 = threadIdx.x * kItems;
  const int diag = diag0 < la + lb ? diag0 : la + lb;
  int lo = diag - lb > 0 ? diag - lb : 0;
  int hi = diag < la ? diag : la;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (sa[mid] <= sb[diag - 1 - mid]) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  int ai = lo;
  int bi = diag - lo;
  // the key before the thread's first: the larger of each side's last
  // key taken (sa[-1] and sb[-1] are the keys before the tile's ranges)
  bool has_prev = false;
  long long prev = 0;
  if (r.i0 + ai > 0) {
    prev = sa[ai - 1];
    has_prev = true;
  }
  if (r.j0 + bi > 0) {
    const long long p = sb[bi - 1];
    if (!has_prev || p > prev) prev = p;
    has_prev = true;
  }
  const int n = la + lb - diag < kItems ? la + lb - diag : kItems;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    if (k < n) {
      const bool take_a = bi >= lb || (ai < la && sa[ai] <= sb[bi]);
      long long c = 0;
      if (take_a) {
        key[k] = sa[ai];
        if (kCounts) {
          c = sc[1 + ai];
          // B's next key (in the tile, or the one after its range)
          if (r.j0 + bi < nb && sb[bi] == key[k]) c += sc[3 + la + bi];
        }
        ++ai;
      } else {
        key[k] = sb[bi];
        if (kCounts) c = sc[3 + la + bi];
        ++bi;
      }
      head[k] = !has_prev || key[k] != prev;
      cnt[k] = c;
      prev = key[k];
      has_prev = true;
    } else {
      head[k] = false;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    heads_kernel(const long long* __restrict__ ak, long long na,
                 const long long* __restrict__ bk, long long nb,
                 const long long* __restrict__ splits,
                 long long* __restrict__ tile_heads) {
  __shared__ long long sk[kTile + 4];
  __shared__ int warp_sums[kWarps];
  const TileRange r =
      load_tile<false>(ak, nullptr, na, bk, nullptr, nb, splits, sk, nullptr);
  long long key[kItems];
  long long cnt[kItems];
  bool head[kItems];
  merge_items<false>(r, nb, sk, nullptr, key, cnt, head);
  int mine = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) mine += head[k] ? 1 : 0;
  int total;
  block_scan<int, kThreads>(mine, warp_sums, &total);
  if (threadIdx.x == 0) tile_heads[blockIdx.x] = total;
}

// exclusive scan of the tiles' head counts in place (one CTA); *n_out is
// the sum
__global__ void __launch_bounds__(kScanThreads)
    scan_kernel(long long* __restrict__ tile_heads, long long tiles,
                long long* __restrict__ n_out) {
  __shared__ long long warp_sums[kScanThreads / 32];
  long long carry = 0;
  for (long long base = 0; base < tiles; base += kScanThreads) {
    const long long t = base + threadIdx.x;
    const long long v = t < tiles ? tile_heads[t] : 0;
    long long total;
    const long long incl =
        block_scan<long long, kScanThreads>(v, warp_sums, &total);
    if (t < tiles) tile_heads[t] = carry + incl - v;
    carry += total;
  }
  if (threadIdx.x == 0) *n_out = carry;
}

__global__ void __launch_bounds__(kThreads)
    write_kernel(const long long* __restrict__ ak,
                 const long long* __restrict__ ac, long long na,
                 const long long* __restrict__ bk,
                 const long long* __restrict__ bc, long long nb,
                 const long long* __restrict__ splits,
                 const long long* __restrict__ tile_first,
                 long long* __restrict__ out_k, long long* __restrict__ out_c) {
  __shared__ long long sk[kTile + 4];
  __shared__ long long sc[kTile + 4];
  __shared__ int warp_sums[kWarps];
  const TileRange r = load_tile<true>(ak, ac, na, bk, bc, nb, splits, sk, sc);
  long long key[kItems];
  long long cnt[kItems];
  bool head[kItems];
  merge_items<true>(r, nb, sk, sc, key, cnt, head);
  int mine = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) mine += head[k] ? 1 : 0;
  int heads;
  int rank = block_scan<int, kThreads>(mine, warp_sums, &heads) - mine;
  // every thread has read the tile (block_scan ends on a barrier): the
  // shared arrays now stage the heads at their ranks
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    if (head[k]) {
      sk[rank] = key[k];
      sc[rank] = cnt[k];
      ++rank;
    }
  }
  __syncthreads();
  const long long first = tile_first[blockIdx.x];
  for (int x = threadIdx.x; x < heads; x += kThreads) {
    out_k[first + x] = sk[x];
    out_c[first + x] = sc[x];
  }
}

long long tile_count(long long n) { return (n + kTile - 1) / kTile; }

}  // namespace

// Scratch the merge of n keys in all needs: int64 words (the tile
// boundaries' splits and the tiles' head counts).
extern "C" long long nt_merge_spectra_scratch(long long n) {
  return n > 0 ? 2 * tile_count(n) + 1 : 0;
}

// Merges (ak, ac)[0, na) and (bk, bc)[0, nb) into out_k / out_c (room for
// na + nb entries each) on `stream`, n_out[0] the number of distinct keys
// written.  Every pointer is int64 on the device; scratch holds
// nt_merge_spectra_scratch(na + nb) words.  Returns cudaGetLastError()
// after the last launch (cudaErrorInvalidValue for a bad size).
extern "C" int nt_merge_spectra(const void* ak, const void* ac, long long na,
                                const void* bk, const void* bc, long long nb,
                                void* out_k, void* out_c, void* n_out,
                                void* scratch, void* stream) {
  if (na < 0 || nb < 0 || na + nb <= 0) return (int)cudaErrorInvalidValue;
  const long long tiles = tile_count(na + nb);
  if (tiles > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long* a = static_cast<const long long*>(ak);
  const long long* a_c = static_cast<const long long*>(ac);
  const long long* b = static_cast<const long long*>(bk);
  const long long* b_c = static_cast<const long long*>(bc);
  long long* splits = static_cast<long long*>(scratch);
  long long* tile_heads = splits + tiles + 1;
  const long long part_blocks = (tiles + 1 + kThreads - 1) / kThreads;
  partition_kernel<<<(unsigned)part_blocks, kThreads, 0, s>>>(a, na, b, nb,
                                                              tiles, splits);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  heads_kernel<<<(unsigned)tiles, kThreads, 0, s>>>(a, na, b, nb, splits,
                                                    tile_heads);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  scan_kernel<<<1, kScanThreads, 0, s>>>(tile_heads, tiles,
                                         static_cast<long long*>(n_out));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  write_kernel<<<(unsigned)tiles, kThreads, 0, s>>>(
      a, a_c, na, b, b_c, nb, splits, tile_heads,
      static_cast<long long*>(out_k), static_cast<long long*>(out_c));
  return (int)cudaGetLastError();
}
