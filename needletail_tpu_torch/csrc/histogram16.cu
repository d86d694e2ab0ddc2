// Exact 65,536-bin histogram of int32 keys: the count step of the
// hash-count path.
//
// Replaces needletail_tpu/device/pallas_kernels.py:mxu_histogram16, which
// on the TPU turned the histogram into int4 outer products on the matrix
// unit.  Here it is integer atomics: counts[key & 0xFFFF] += 1 for every
// key >= 0 (keys < 0 mark invalid windows and are dropped).  Integer adds
// commute, so the result is exact whatever order the atomics land in.
//
// What bounds it on Hopper: atomic throughput, not bytes (16.7M keys are
// 64 MiB, a few tens of microseconds of HBM reads).  Global atomics on
// 65,536 addresses would contend in L2, and badly on skewed input (every
// key in one bin).  So each block privatizes bins in shared memory.  The
// full table is 256 KiB of int32, more than the 227 KB one block may
// hold, so the bin range is split in two: grid.y picks a 32,768-bin half
// (128 KiB of dynamic shared memory), and every block reads its share of
// the keys and counts only those that fall in its half.  Reading the keys
// twice costs less than any narrowing of the counters, which could wrap.
// A block then adds its nonzero bins to the global table (zeroed by the
// caller) with one atomic each.  This is the simplest layout that is
// exact for any key distribution.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kHalfBins = 32768;
constexpr size_t kSmemBytes = kHalfBins * sizeof(uint32_t);

__global__ void __launch_bounds__(kThreads)
    histogram16_kernel(const int32_t* __restrict__ keys, long long n,
                       int32_t* __restrict__ counts) {
  extern __shared__ uint32_t bins[];
  const int32_t half = (int32_t)blockIdx.y;
  for (int i = threadIdx.x; i < kHalfBins; i += kThreads) bins[i] = 0;
  __syncthreads();

  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += stride) {
    const int32_t key = keys[i];
    if (key >= 0 && ((key >> 15) & 1) == half) {
      atomicAdd(&bins[key & (kHalfBins - 1)], 1u);
    }
  }
  __syncthreads();

  int32_t* out = counts + (long long)half * kHalfBins;
  for (int i = threadIdx.x; i < kHalfBins; i += kThreads) {
    const uint32_t c = bins[i];
    if (c != 0) atomicAdd(&out[i], (int32_t)c);
  }
}

}  // namespace

// counts [65536] int32, zeroed by the caller, is accumulated on `stream`.
// Returns cudaGetLastError() after the launch.
extern "C" int nt_histogram16(const void* keys, long long n, void* counts,
                              void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      histogram16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  int device = 0;
  int sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  // one block fits an SM (128 KiB of shared memory each), and the two
  // halves share the SMs: sms / 2 blocks per half fill the card in one wave
  long long per_half = sms / 2 > 0 ? sms / 2 : 1;
  const long long needed = (n + kThreads - 1) / kThreads;
  if (needed < per_half) per_half = needed;
  const dim3 grid((unsigned int)per_half, 2);
  histogram16_kernel<<<grid, kThreads, kSmemBytes,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(keys), n, static_cast<int32_t*>(counts));
  return (int)cudaGetLastError();
}
