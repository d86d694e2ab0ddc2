// Exact 65,536-bin histogram of int32 keys: the count step of the
// hash-count path.
//
// Replaces needletail_tpu/device/pallas_kernels.py:mxu_histogram16, which
// on the TPU turned the histogram into int4 outer products on the matrix
// unit.  Here it is integer atomics into shared memory: counts[key &
// 0xFFFF] += 1 for every key >= 0 (keys < 0 mark invalid windows and are
// dropped).  Integer adds commute, so the result is exact and the same
// whatever order the adds land in.
//
// What bounds it on Hopper: the one read of the keys (16.7M keys are 64
// MiB, about 20 us of HBM).  The full table is 256 KiB of int32, more
// than the 227 KB one CTA may hold, so a thread-block cluster of two CTAs
// holds it: rank r keeps bins [32768 r, 32768 r + 32768) in 128 KiB of
// dynamic shared memory.  Each key is read once, by whichever CTA of the
// cluster loads it, and counted by the CTA that owns its half, (key >> 15)
// & 1, with a shared-memory atomic of its own.  A CTA does not add into
// its peer's bins: in a trial an atomic on distributed shared memory cost
// about as much per warp instruction whatever the number of lanes it
// carried, and the remote adds took longer than all the rest of the
// kernel.  It sends the peer's keys instead, each as its 15-bit offset in
// the peer's half, two to a word, with one 16-byte store to distributed
// shared memory for every eight keys, into an inbox of the peer's.  Warp
// w of one CTA trades only with warp w of the other: after its stores,
// each lane arrives on the peer warp's mbarrier (release, cluster scope);
// the warp adds its own keys, waits on its own mbarrier (acquire) for the
// peer warp's keys, and adds them.  The inbox is double-buffered, so a
// warp cannot write a buffer that its peer warp still reads: it sends
// step i + 2 only after it has seen step i + 1 of the peer warp, which
// the peer sent after it had read step i.  (A cluster-wide barrier in
// place of these handshakes held every warp of both CTAs in step, and was
// slower in a trial.)  Equal keys need no merging: shared-memory atomics
// on one address ran as fast as on distinct ones.
//
// Loads are 16 bytes (int4) from the first 16-byte boundary, kUnroll of
// them a thread and the next step's issued before this step's adds; a
// head short of that boundary and a tail short of four keys are read as
// scalars.  The flush has no global atomics: each cluster stores its
// 65,536 bins with plain coalesced stores as one row of a scratch table
// partials[clusters, 65536], and a second small kernel sums its columns
// into counts, each column by four threads over a quarter of the rows.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kCluster = 2;
constexpr int kBins = 65536;
constexpr int kHalfBins = kBins / kCluster;
constexpr int kUnroll = 4;  // int4 loads a thread per step (even)
// a sent key is its 15-bit offset in the peer's half, 0xFFFF for none, two
// to a word: one thread's step fills kUnroll / 2 16-byte inbox slots
constexpr int kInbox = kUnroll / 2 * kThreads;  // uint4 slots of a buffer
constexpr uint32_t kNone = 0xFFFFu;
constexpr size_t kSmemBytes =
    kHalfBins * sizeof(uint32_t) + 2 * kInbox * sizeof(uint4);  // 192 KiB
constexpr int kWarps = kThreads / 32;
constexpr int kReduceCols = 64;  // int4 columns a block of the column sum
constexpr int kReduceSplit = 4;  // threads that share a column's rows
// a wait longer than this many polls of an mbarrier traps instead of
// hanging the card (the protocol never needs one)
constexpr long long kMaxPolls = 1LL << 26;

__device__ __forceinline__ uint32_t owner(int32_t key) {
  return (uint32_t)(key >> 15) & 1u;
}

// bins[off] += 1 in this CTA's shared memory (`bins` a shared address)
__device__ __forceinline__ void add_local(uint32_t bins, uint32_t off) {
  asm volatile("red.shared::cta.add.u32 [%0], %1;" ::"r"(bins + 4u * off),
               "r"(1u)
               : "memory");
}

// the same in the shared memory of cluster rank owner(key), for the few
// head and tail keys (`bins_of` shared::cluster addresses)
__device__ __forceinline__ void add_remote(const uint32_t (&bins_of)[kCluster],
                                           int32_t key) {
  asm volatile("red.shared::cluster.add.u32 [%0], %1;" ::"r"(
                   bins_of[owner(key)] + 4u * (uint32_t)(key & (kHalfBins - 1))),
               "r"(1u)
               : "memory");
}

__device__ __forceinline__ bool for_rank(int32_t key, uint32_t rank) {
  return key >= 0 && owner(key) == rank;
}

// two keys for the peer, each its offset or kNone
__device__ __forceinline__ uint32_t pack(int32_t a, int32_t b, uint32_t peer) {
  const uint32_t lo = for_rank(a, peer) ? (uint32_t)a & (kHalfBins - 1) : kNone;
  const uint32_t hi = for_rank(b, peer) ? (uint32_t)b & (kHalfBins - 1) : kNone;
  return lo | hi << 16;
}

__device__ __forceinline__ void add_pair(uint32_t bins, uint32_t word) {
  if ((word & 0xFFFFu) != kNone) add_local(bins, word & 0xFFFFu);
  if ((word >> 16) != kNone) add_local(bins, word >> 16);
}

// returns once phase `parity` of the mbarrier at shared address `bar` has
// completed, with acquire semantics at cluster scope
__device__ __forceinline__ void wait_phase(uint32_t bar, uint32_t parity) {
  for (long long polls = 0;; ++polls) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (polls > kMaxPolls) __trap();
  }
}

__device__ __forceinline__ void load_step(const int4* __restrict__ body,
                                          long long s, long long stride,
                                          long long first, long long n4,
                                          int4 (&v)[kUnroll]) {
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long i = s + u * stride + first;
    v[u] = i < n4 ? __ldg(body + i) : make_int4(-1, -1, -1, -1);
  }
}

// keys[0, head) and keys[head + 4 n4, n) are scalars, keys[head, head + 4
// n4) 16-byte aligned int4s.  The step loop runs the same number of times
// in every thread of the grid, so the two warps of a pair meet at each
// step.
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 1)
    histogram16_kernel(const int32_t* __restrict__ keys, long long head,
                       long long n4, long long tail,
                       int32_t* __restrict__ partials) {
  extern __shared__ __align__(16) uint32_t smem[];
  uint4* bins = reinterpret_cast<uint4*>(smem);
  uint4* inbox = reinterpret_cast<uint4*>(smem + kHalfBins);  // [2][kInbox]
  // full[b][w]: warp w's inbox buffer b holds the peer warp's keys (32
  // arrivals, one a lane of the peer warp, complete a phase)
  __shared__ __align__(8) uint64_t full[2][kWarps];
  cg::cluster_group cluster = cg::this_cluster();
  const uint32_t rank = cluster.block_rank();
  const uint32_t peer = rank ^ 1u;
  const int warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < kHalfBins / 4; i += kThreads) {
    bins[i] = make_uint4(0, 0, 0, 0);
  }
  uint32_t own_full[2], peer_full[2];
  for (int b = 0; b < 2; ++b) {
    own_full[b] = (uint32_t)__cvta_generic_to_shared(&full[b][warp]);
    if ((threadIdx.x & 31) == 0) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(own_full[b]),
                   "r"(32)
                   : "memory");
    }
  }
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  // both CTAs run, have zeroed their bins and made their mbarriers before
  // either sends
  cluster.sync();
  for (int b = 0; b < 2; ++b) {
    asm("mapa.shared::cluster.u32 %0, %1, %2;"
        : "=r"(peer_full[b]) : "r"(own_full[b]), "r"(peer));
  }
  const uint32_t own_bins = (uint32_t)__cvta_generic_to_shared(smem);
  uint32_t bins_of[kCluster];
  for (uint32_t r = 0; r < kCluster; ++r) {
    asm("mapa.shared::cluster.u32 %0, %1, %2;"
        : "=r"(bins_of[r]) : "r"(own_bins), "r"(r));
  }
  uint32_t peer_inbox;
  asm("mapa.shared::cluster.u32 %0, %1, %2;"
      : "=r"(peer_inbox)
      : "r"((uint32_t)__cvta_generic_to_shared(inbox)), "r"(peer));

  const int4* body = reinterpret_cast<const int4*>(keys + head);
  const long long stride = (long long)gridDim.x * kThreads;
  const long long first = (long long)blockIdx.x * kThreads + threadIdx.x;
  int4 v[kUnroll];
  load_step(body, 0, stride, first, n4, v);
  uint32_t step = 0;  // buffer step & 1, used for the (step >> 1)-th time
  for (long long s = 0; s < n4; s += stride * kUnroll, ++step) {
    const uint32_t buf = step & 1u;
    int4 next[kUnroll];
    load_step(body, s + stride * kUnroll, stride, first, n4, next);
    // the peer's keys to its inbox
#pragma unroll
    for (int u = 0; u < kUnroll; u += 2) {
      const uint32_t slot =
          peer_inbox +
          16u * (uint32_t)(buf * kInbox + u / 2 * kThreads + threadIdx.x);
      asm volatile(
          "st.shared::cluster.v4.u32 [%0], {%1, %2, %3, %4};" ::"r"(slot),
          "r"(pack(v[u].x, v[u].y, peer)), "r"(pack(v[u].z, v[u].w, peer)),
          "r"(pack(v[u + 1].x, v[u + 1].y, peer)),
          "r"(pack(v[u + 1].z, v[u + 1].w, peer))
          : "memory");
    }
    asm volatile(
        "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];" ::"r"(
            peer_full[buf])
        : "memory");
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int32_t k[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (for_rank(k[j], rank)) add_local(own_bins, k[j] & (kHalfBins - 1));
      }
    }
    wait_phase(own_full[buf], (step >> 1) & 1u);
#pragma unroll
    for (int u = 0; u < kUnroll / 2; ++u) {
      const uint4 got = inbox[buf * kInbox + u * kThreads + threadIdx.x];
      add_pair(own_bins, got.x);
      add_pair(own_bins, got.y);
      add_pair(own_bins, got.z);
      add_pair(own_bins, got.w);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = next[u];
  }
  // CTA 0 adds the head (< 4 keys) and the tail (< 4) where they belong
  if (blockIdx.x == 0 && threadIdx.x < 4) {
    const int t = threadIdx.x;
    if (t < head && keys[t] >= 0) add_remote(bins_of, keys[t]);
    if (t < tail && keys[head + 4 * n4 + t] >= 0) {
      add_remote(bins_of, keys[head + 4 * n4 + t]);
    }
  }
  // every add of both CTAs has landed; after this barrier no CTA touches
  // its peer's shared memory, so none needs another one before it exits
  cluster.sync();

  int4* out = reinterpret_cast<int4*>(
      partials + (long long)(blockIdx.x / kCluster) * kBins +
      (long long)rank * kHalfBins);
  for (int i = threadIdx.x; i < kHalfBins / 4; i += kThreads) {
    const uint4 c = bins[i];
    out[i] = make_int4((int)c.x, (int)c.y, (int)c.z, (int)c.w);
  }
}

// counts[4 col .. 4 col + 3] = the sum over clusters of partials' int4
// column col: kReduceSplit threads each sum every kReduceSplit-th row,
// and the first adds the others' sums from shared memory
__global__ void __launch_bounds__(kReduceCols * kReduceSplit)
    sum_partials_kernel(const int4* __restrict__ partials, int clusters,
                        int4* __restrict__ counts) {
  __shared__ uint4 part[kReduceSplit][kReduceCols];
  const int c = threadIdx.x % kReduceCols;
  const int g = threadIdx.x / kReduceCols;
  const int col = blockIdx.x * kReduceCols + c;
  uint4 acc = make_uint4(0, 0, 0, 0);
#pragma unroll 4
  for (int r = g; r < clusters; r += kReduceSplit) {
    const int4 v = __ldg(partials + (long long)r * (kBins / 4) + col);
    acc.x += (uint32_t)v.x;
    acc.y += (uint32_t)v.y;
    acc.z += (uint32_t)v.z;
    acc.w += (uint32_t)v.w;
  }
  part[g][c] = acc;
  __syncthreads();
  if (g == 0) {
    for (int h = 1; h < kReduceSplit; ++h) {
      acc.x += part[h][c].x;
      acc.y += part[h][c].y;
      acc.z += part[h][c].z;
      acc.w += part[h][c].w;
    }
    counts[col] = make_int4((int)acc.x, (int)acc.y, (int)acc.z, (int)acc.w);
  }
}

constexpr int kMaxDevices = 64;

// clusters of the kernel that fit on the current device at once, asked
// once per device (after raising the kernel's shared-memory limit)
cudaError_t max_active_clusters(int* out) {
  static int cached[kMaxDevices];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < kMaxDevices && cached[device] > 0) {
    *out = cached[device];
    return cudaSuccess;
  }
  // the 192 KiB of shared memory exceed the 48 KB default
  err = cudaFuncSetAttribute(histogram16_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kSmemBytes);
  if (err != cudaSuccess) return err;
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((unsigned)(kCluster * (sms > 0 ? sms : 1)), 1, 1);
  config.blockDim = dim3(kThreads, 1, 1);
  config.dynamicSmemBytes = kSmemBytes;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kCluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  config.attrs = &attr;
  config.numAttrs = 1;
  err = cudaOccupancyMaxActiveClusters(out, (void*)histogram16_kernel, &config);
  if (err == cudaSuccess && *out <= 0) err = cudaErrorInvalidConfiguration;
  if (err == cudaSuccess && device < kMaxDevices) cached[device] = *out;
  return err;
}

}  // namespace

// Clusters that nt_histogram16 runs over n keys on the current device: the
// scratch table it takes holds clusters x 65,536 int32.  Negative (a CUDA
// error code, negated) on failure.
extern "C" long long nt_histogram16_clusters(long long n) {
  if (n <= 0) return -(long long)cudaErrorInvalidValue;
  int max_clusters = 0;
  const cudaError_t err = max_active_clusters(&max_clusters);
  if (err != cudaSuccess) return -(long long)err;
  // a cluster's first step reads 2 x 1024 threads x kUnroll int4s
  const long long step = (long long)kCluster * kThreads * 4 * kUnroll;
  const long long needed = (n + step - 1) / step;
  return needed < max_clusters ? needed : max_clusters;
}

// counts [65536] int32 is written (not accumulated) on `stream`, through
// partials [clusters, 65536] int32 of scratch.  keys must be 4-byte
// aligned, counts and partials 16-byte aligned.  Returns
// cudaGetLastError() after the launches.
extern "C" int nt_histogram16(const void* keys, long long n, void* counts,
                              void* partials, long long clusters,
                              void* stream) {
  if (n <= 0 || clusters <= 0 || (reinterpret_cast<uintptr_t>(keys) & 3) ||
      (reinterpret_cast<uintptr_t>(partials) & 15) ||
      (reinterpret_cast<uintptr_t>(counts) & 15)) {
    return (int)cudaErrorInvalidValue;
  }
  int max_clusters = 0;
  cudaError_t err = max_active_clusters(&max_clusters);
  if (err != cudaSuccess) return (int)err;
  const int32_t* k = static_cast<const int32_t*>(keys);
  const long long misalign = (long long)(reinterpret_cast<uintptr_t>(k) & 15) / 4;
  long long head = (4 - misalign) & 3;
  if (head > n) head = n;
  const long long n4 = (n - head) / 4;
  const long long tail = n - head - 4 * n4;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  histogram16_kernel<<<(unsigned)(clusters * kCluster), kThreads, kSmemBytes,
                       s>>>(k, head, n4, tail, static_cast<int32_t*>(partials));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sum_partials_kernel<<<kBins / 4 / kReduceCols, kReduceCols * kReduceSplit,
                        0, s>>>(
      static_cast<const int4*>(partials), (int)clusters,
      static_cast<int4*>(counts));
  return (int)cudaGetLastError();
}
