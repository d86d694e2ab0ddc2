// Bitonic sort of every block_lanes span of a uint32 stream, ascending.
//
// Replaces benchmarks/exp_mosaic_sort.py:bitonic_block_sort (body
// _bitonic_kernel), an experiment that measured a VMEM-resident bitonic
// network against XLA's sort on the TPU.  The TPU kernel kept a whole
// block in VMEM and built every butterfly partner with two rolls and a
// select, because a TPU vector unit has no gather; it biased the keys to
// int32 since Mosaic had no unsigned vector min.  Here the keys stay
// uint32 and compare unsigned, and a thread reads its pair straight from
// shared memory.
//
// The network: for k = 2, 4, ..., B and j = k/2, ..., 1, lane i (with
// bit j clear) compare-exchanges with lane i + j, ascending where bit k
// of i's index inside its block is clear.  At k = B every lane ascends,
// so each block ends sorted; blocks never exchange.
//
// What bounds it on Hopper: shared-memory traffic and barriers, not
// device memory.  A block of B lanes takes log2(B)(log2(B)+1)/2 stages;
// kept in shared memory, the data crosses device memory once each way.
// One CTA holds a tile of T = min(B, 2^15) lanes (128 KiB of dynamic
// shared memory at most, opted in past the 48 KiB default) and runs every
// stage whose stride is below T there, one thread per pair and a barrier
// per stage.  A block larger than a tile (the experiment's 2^16 and 2^17)
// runs each stage of stride j >= T as a pass over device memory, one
// launch per stage, and then finishes that k level's strides below T in
// shared memory.  Clusters with distributed shared memory could hold a
// 2^17 block across CTAs; that is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr long long kMaxTile = 1LL << 15;  // uint32 lanes in one CTA
constexpr int kTileThreads = 1024;
constexpr int kStepThreads = 256;

__device__ __forceinline__ void exchange(uint32_t& a, uint32_t& b, bool asc) {
  if (asc ? a > b : a < b) {
    const uint32_t t = a;
    a = b;
    b = t;
  }
}

// Loads tile blockIdx.x of `in`, runs levels k_lo..k_hi with strides below
// the tile, and stores it to `out` (which may be `in`: each CTA reads its
// whole tile before it writes).  block_mask is B - 1.
__global__ void __launch_bounds__(kTileThreads)
    tile_kernel(const uint32_t* in, uint32_t* out, int tile,
                long long block_mask, long long k_lo, long long k_hi) {
  extern __shared__ uint32_t s[];
  const long long base = (long long)blockIdx.x * tile;
  for (int i = threadIdx.x; i < tile; i += blockDim.x) s[i] = in[base + i];
  __syncthreads();
  const int half = tile / 2;
  for (long long k = k_lo; k <= k_hi; k <<= 1) {
    for (int j = (int)(k / 2 < half ? k / 2 : half); j > 0; j >>= 1) {
      for (int p = threadIdx.x; p < half; p += blockDim.x) {
        const int i = ((p & ~(j - 1)) << 1) | (p & (j - 1));
        const bool asc = (((base + i) & block_mask) & k) == 0;
        uint32_t a = s[i];
        uint32_t b = s[i + j];
        exchange(a, b, asc);
        s[i] = a;
        s[i + j] = b;
      }
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < tile; i += blockDim.x) out[base + i] = s[i];
}

// One stage of stride j at level k over device memory, one pair a thread.
__global__ void __launch_bounds__(kStepThreads)
    step_kernel(uint32_t* __restrict__ data, long long pairs,
                long long block_mask, long long k, long long j) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       p < pairs; p += stride) {
    const long long i = ((p & ~(j - 1)) << 1) | (p & (j - 1));
    const bool asc = ((i & block_mask) & k) == 0;
    uint32_t a = data[i];
    uint32_t b = data[i + j];
    exchange(a, b, asc);
    data[i] = a;
    data[i + j] = b;
  }
}

}  // namespace

// out [n] gets in [n] with every `block` span sorted ascending as uint32,
// on `stream`.  block is a power of two >= 2 dividing n.  Returns
// cudaGetLastError() after the last launch, or the first error.
extern "C" int nt_block_sort(const void* in, void* out, long long n,
                             long long block, void* stream) {
  if (n <= 0 || block < 2 || (block & (block - 1)) != 0 || n % block != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const long long tile = block < kMaxTile ? block : kMaxTile;
  const long long tiles = n / tile;
  if (tiles > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)tile * sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(
      tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = (int)(tile / 2 < kTileThreads ? tile / 2 : kTileThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  uint32_t* data = static_cast<uint32_t*>(out);

  tile_kernel<<<(unsigned int)tiles, threads, smem, st>>>(
      static_cast<const uint32_t*>(in), data, (int)tile, block - 1, 2, tile);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  int device = 0;
  int sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const long long pairs = n / 2;
  const long long cap = (long long)(sms > 0 ? sms : 1) * 16;
  long long step_blocks = (pairs + kStepThreads - 1) / kStepThreads;
  if (step_blocks > cap) step_blocks = cap;
  for (long long k = 2 * tile; k <= block; k <<= 1) {
    for (long long j = k / 2; j >= tile; j >>= 1) {
      step_kernel<<<(unsigned int)step_blocks, kStepThreads, 0, st>>>(
          data, pairs, block - 1, k, j);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
    tile_kernel<<<(unsigned int)tiles, threads, smem, st>>>(
        data, data, (int)tile, block - 1, k, k);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
