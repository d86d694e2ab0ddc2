// The (w, k) minimizer sketch over canonical key planes: for every run of
// w consecutive k-mer windows of a row, the smallest canonical key.
//
// Replaces no TPU kernel: the JAX package computes the sketch in XLA
// (needletail_tpu/device/minimizers.py:window_minimizers, a doubling
// ladder of jnp.minimum over (hi, lo) pairs), with no Pallas kernel.  The
// port's plain version is that ladder in PyTorch
// (minimizers.window_minimizers_from_planes, then count.mask_keys); on the
// card it made some 25 launches a batch, each with [rows, L] int64 or bool
// temporaries in device memory (about 1 GB apiece at a HiFi batch of 4096
// rows of 30 kbp), for work that needs one read of the planes and one
// write of the sketch.
//
// Input: the key-plane kernel's int32 planes hi, lo [rows, L] (uint32 bit
// patterns, -1 in both where the window is invalid; a valid hi is below
// 2^30).  Only the width = L - k + 1 lanes where a window can start are
// read.  Output: the flat [rows * P] int32 planes that the streaming count
// buffers, P = width - w + 1 sketch positions a row.  Position p covers
// windows p .. p+w-1; it is valid when all w are, and then holds the
// smallest of their keys in unsigned (hi, lo) order, else -1 in both
// planes.  out_hi may be null (k <= 15: the keys fit lo).
//
// What bounds it on Hopper: device memory, 8 bytes read a lane and 8
// written a position.  One pass: a CTA owns kTile positions of one row and
// stages the kTile + w - 1 lanes they cover (the w - 1 lanes of halo are
// read twice, under 1% at w = 19) into shared memory as 64-bit values,
// key + 1 where the window is valid and 0 where not.  Then the minimum of a
// position is 0 exactly when one of its windows is invalid, so one
// minimum gives both the key and the validity.  The minima come from van
// Herk and Gil-Werman's blocks: cut the staged lanes into blocks of w from
// the tile's first lane; a thread scans each of its blocks forward
// (prefix minima, into a second array) and backward (suffix minima, in
// place), and the window of position p is then min(suffix[p], prefix[p +
// w - 1]), since p .. p+w-1 is the end of one block and the start of the
// next.  That is three shared-memory accesses a lane and two a position,
// whatever w is, where a direct minimum would make w.  The stores to
// device memory are coalesced.  The staging takes 16 bytes a lane, 33 KB
// a CTA at w = 19 (six CTAs an SM).
//
// Past kMaxW a tile and its halo would not fit 48 KB of shared memory, so
// the same blocks, now cut from each row's first lane, keep their minima
// in device memory: a warp a block walks it 32 lanes a step, a shuffle
// scan with a running minimum, forward into prefix and backward into
// suffix (the caller's scratch, 16 bytes a lane), and a second kernel
// takes each position's min(suffix[p], prefix[p + w - 1]).  That is 56
// bytes a lane where the tile takes 16, for any w.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = kThreads * 8;  // sketch positions a CTA
constexpr int kMaxW = 1024;          // 16 * (kTile + kMaxW - 1) B < 48 KB
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ unsigned long long umin(unsigned long long a,
                                                   unsigned long long b) {
  return a < b ? a : b;
}

// Lane i of a row's planes as one value: key + 1, or 0 where the window
// is invalid.
__device__ __forceinline__ unsigned long long staged_key(
    const int* __restrict__ hrow, const int* __restrict__ lrow, long long i) {
  const int h = __ldg(hrow + i);
  const unsigned l = (unsigned)__ldg(lrow + i);
  return h == -1 ? 0ull : ((unsigned long long)(unsigned)h << 32 | l) + 1ull;
}

// Position `at` of the output from its minimum m of staged values.
__device__ __forceinline__ void store_position(int* __restrict__ out_hi,
                                               int* __restrict__ out_lo,
                                               long long at,
                                               unsigned long long m) {
  const unsigned long long key = m - 1ull;
  if (out_hi != nullptr) out_hi[at] = m == 0ull ? -1 : (int)(key >> 32);
  out_lo[at] = m == 0ull ? -1 : (int)(unsigned)key;
}

__global__ void __launch_bounds__(kThreads)
minimizer_sketch_kernel(const int* __restrict__ khi,
                        const int* __restrict__ klo, long long lanes,
                        long long positions, long long tiles, int w,
                        int* __restrict__ out_hi, int* __restrict__ out_lo) {
  extern __shared__ unsigned long long staged[];
  const long long row = blockIdx.x / tiles;
  const long long p0 = (blockIdx.x - row * tiles) * kTile;
  const long long left = positions - p0;
  const int n = left < kTile ? (int)left : kTile;  // this tile's positions
  // lanes p0 .. p0 + span - 1, all below width = positions + w - 1
  const int span = n + w - 1;
  unsigned long long* suffix = staged;
  unsigned long long* prefix = staged + span;

  const int* hrow = khi + row * lanes + p0;
  const int* lrow = klo + row * lanes + p0;
  for (int e = threadIdx.x; e < span; e += kThreads) {
    suffix[e] = staged_key(hrow, lrow, e);
  }
  __syncthreads();

  for (int start = threadIdx.x * w; start < span; start += kThreads * w) {
    const int end = start + w < span ? start + w : span;
    unsigned long long run = ~0ull;
    for (int i = start; i < end; ++i) {
      run = umin(run, suffix[i]);
      prefix[i] = run;
    }
    run = ~0ull;
    for (int i = end - 1; i >= start; --i) {
      run = umin(run, suffix[i]);
      suffix[i] = run;
    }
  }
  __syncthreads();

  const long long out = row * positions + p0;
  for (int p = threadIdx.x; p < n; p += kThreads) {
    store_position(out_hi, out_lo, out + p, umin(suffix[p], prefix[p + w - 1]));
  }
}

// Past kMaxW: warp g owns block g % blocks (lanes from (g % blocks) * w)
// of row g / blocks, and writes its prefix and suffix minima of staged
// values into the [rows, width] arrays.
__global__ void __launch_bounds__(kThreads)
sketch_block_minima_kernel(const int* __restrict__ khi,
                           const int* __restrict__ klo, long long lanes,
                           long long width, long long blocks,
                           long long warps, int w,
                           unsigned long long* __restrict__ prefix,
                           unsigned long long* __restrict__ suffix) {
  const long long g = ((long long)blockIdx.x * kThreads + threadIdx.x) >> 5;
  if (g >= warps) return;  // whole warps: kThreads is a multiple of 32
  const int lane = threadIdx.x & 31;
  const long long row = g / blocks;
  const long long start = (g - row * blocks) * w;
  const long long end = start + w < width ? start + w : width;
  const int* hrow = khi + row * lanes;
  const int* lrow = klo + row * lanes;
  unsigned long long* prow = prefix + row * width;
  unsigned long long* srow = suffix + row * width;

  unsigned long long run = ~0ull;
  for (long long base = start; base < end; base += 32) {
    const long long i = base + lane;
    unsigned long long v = i < end ? staged_key(hrow, lrow, i) : ~0ull;
    for (int d = 1; d < 32; d <<= 1) {
      const unsigned long long t = __shfl_up_sync(kFull, v, d);
      if (lane >= d) v = umin(v, t);
    }
    v = umin(v, run);
    if (i < end) prow[i] = v;
    run = __shfl_sync(kFull, v, 31);
  }
  run = ~0ull;
  for (long long base = start + ((end - start - 1) & ~31LL); base >= start;
       base -= 32) {
    const long long i = base + lane;
    unsigned long long v = i < end ? staged_key(hrow, lrow, i) : ~0ull;
    for (int d = 1; d < 32; d <<= 1) {
      const unsigned long long t = __shfl_down_sync(kFull, v, d);
      if (lane + d < 32) v = umin(v, t);
    }
    v = umin(v, run);
    if (i < end) srow[i] = v;
    run = __shfl_sync(kFull, v, 0);
  }
}

__global__ void __launch_bounds__(kThreads)
sketch_from_block_minima_kernel(const unsigned long long* __restrict__ prefix,
                                const unsigned long long* __restrict__ suffix,
                                long long width, long long positions,
                                long long total, int w,
                                int* __restrict__ out_hi,
                                int* __restrict__ out_lo) {
  for (long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
       e < total; e += (long long)gridDim.x * kThreads) {
    const long long row = e / positions;
    const long long at = row * width + (e - row * positions);
    store_position(out_hi, out_lo, e,
                   umin(__ldg(suffix + at), __ldg(prefix + at + w - 1)));
  }
}

}  // namespace

// 64-bit values of scratch nt_minimizer_sketch needs for [rows, lanes]
// planes at k and w: none where a tile and its halo fit shared memory,
// else the prefix and suffix minima of every window start.
extern "C" long long nt_minimizer_sketch_scratch(long long rows,
                                                 long long lanes, int k,
                                                 int w) {
  return w <= kMaxW ? 0 : 2 * rows * (lanes - k + 1);
}

// Sketches the [rows, lanes] int32 planes khi, klo (contiguous, on the
// device) at k and w into out_hi (or null) and out_lo, rows * (lanes - k -
// w + 2) int32 each, on `stream`; scratch holds
// nt_minimizer_sketch_scratch(rows, lanes, k, w) 64-bit values (none:
// nullptr).  Returns cudaGetLastError() after the launches
// (cudaErrorInvalidValue for a bad size).
extern "C" int nt_minimizer_sketch(const void* khi, const void* klo,
                                   long long rows, long long lanes, int k,
                                   int w, void* out_hi, void* out_lo,
                                   void* scratch, void* stream) {
  const long long width = lanes - k + 1;
  const long long positions = width - w + 1;
  if (rows <= 0 || k < 1 || k > 31 || w < 1 || positions < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const auto s = static_cast<cudaStream_t>(stream);
  const int* hi = static_cast<const int*>(khi);
  const int* lo = static_cast<const int*>(klo);
  int* ohi = static_cast<int*>(out_hi);
  int* olo = static_cast<int*>(out_lo);
  if (w <= kMaxW) {
    const long long tiles = (positions + kTile - 1) / kTile;
    if (rows > 0x7FFFFFFFLL / tiles) return (int)cudaErrorInvalidValue;
    const long long widest = positions < kTile ? positions : kTile;
    const size_t smem =
        2 * (size_t)(widest + w - 1) * sizeof(unsigned long long);
    minimizer_sketch_kernel<<<(unsigned)(rows * tiles), kThreads, smem, s>>>(
        hi, lo, lanes, positions, tiles, w, ohi, olo);
    return (int)cudaGetLastError();
  }
  if (scratch == nullptr) return (int)cudaErrorInvalidValue;
  const long long blocks = (width + w - 1) / w;
  if (rows > 0x7FFFFFFFLL / blocks) return (int)cudaErrorInvalidValue;
  const long long warps = rows * blocks;
  const long long per_cta = kThreads / 32;
  auto* prefix = static_cast<unsigned long long*>(scratch);
  auto* suffix = prefix + rows * width;
  sketch_block_minima_kernel<<<(unsigned)((warps + per_cta - 1) / per_cta),
                               kThreads, 0, s>>>(
      hi, lo, lanes, width, blocks, warps, w, prefix, suffix);
  const long long total = rows * positions;
  const long long ctas = (total + kThreads - 1) / kThreads;
  sketch_from_block_minima_kernel<<<(unsigned)(ctas < 65536 ? ctas : 65536),
                                    kThreads, 0, s>>>(
      prefix, suffix, width, positions, total, w, ohi, olo);
  return (int)cudaGetLastError();
}
