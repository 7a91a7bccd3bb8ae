// Privatised bins in shared memory, shared by hist.cu and scatter.cu.
//
// A block keeps `words` bins of type U in dynamic shared memory. The first
// `strided` of them are kept in `copies` interleaved copies: copy c of bin w
// is bins[w * copies + c], and lane l of a warp adds into copy l % copies.
// With 32 copies every lane of a warp owns a bank, so lanes that hold the
// same bin never serialise on one shared-memory word (a run of equal
// labels, or the hottest cohorts of a power law); fewer copies leave room
// for more bins where collisions are rarer. The other bins follow in one
// copy each, at bins[strided * copies + (w - strided)]. At the end
// fold_copies sums each strided bin's copies into its first copy, and flush
// adds every non-zero total into device memory with one atomic.
//
// Kernels run a persistent grid: one 1024-thread block on each SM, so each
// block zeroes and flushes its bins once for thousands of inputs. Thread
// block clusters that summed their blocks' bins through distributed shared
// memory before the flush measured slower on an H100 at the legs' sizes: a
// cluster launch cost more than the atomics it saved. (scatter.cu's cluster
// route is another use of a cluster: one copy of an output too large for a
// block, spread over the blocks' shared memory, not a sum of copies.)

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <utility>

namespace tc_bins {

constexpr int kThreads = 1024;
constexpr int kMaxCopies = 32;

// A 16-byte load of data read once: evict-first in L1 and L2.
__device__ __forceinline__ int4 load_once(const int4* p) { return __ldcs(p); }

template <typename U>
__device__ __forceinline__ void zero(U* bins, int64_t count) {
  // 16-byte stores: dynamic shared memory starts 16-byte aligned
  int4* wide = reinterpret_cast<int4*>(bins);
  const int64_t n16 = count * static_cast<int64_t>(sizeof(U)) / 16;
  for (int64_t i = threadIdx.x; i < n16; i += blockDim.x) wide[i] = make_int4(0, 0, 0, 0);
  for (int64_t i = n16 * 16 / static_cast<int64_t>(sizeof(U)) + threadIdx.x; i < count;
       i += blockDim.x) {
    bins[i] = U(0);
  }
}

// Sum the copies of each bin into its first copy. One thread a bin; copy
// (c + w * copies / 32) % copies first, so the 32 threads of a warp read 32
// distinct banks at each step.
template <typename U>
__device__ __forceinline__ void fold_copies(U* bins, int words, int copies) {
  if (copies == 1) return;
  for (int w = threadIdx.x; w < words; w += blockDim.x) {
    U* p = bins + static_cast<int64_t>(w) * copies;
    const int skew = (w * copies) >> 5;
    U sum = U(0);
    for (int c = 0; c < copies; ++c) sum += p[(c + skew) & (copies - 1)];
    p[0] = sum;
  }
}

// Add the block's total of every bin into out[0, words): call with every
// thread of the block, after fold_copies and a __syncthreads.
template <typename U>
__device__ __forceinline__ void flush(const U* bins, int words, int strided, int copies,
                                      U* __restrict__ out) {
  for (int w = threadIdx.x; w < words; w += blockDim.x) {
    const U sum = bins[w < strided ? w * copies : strided * (copies - 1) + w];
    if (sum != U(0)) atomicAdd(out + w, sum);  // NaN != 0: NaN is carried
  }
}

// Launch shape of a kernel on the current device: one block on each SM,
// with the kernel's dynamic shared memory opted in to the device's maximum.
struct Plan {
  int blocks = 0;
  int smem_max = 0;
  cudaError_t err = cudaSuccess;
};

template <typename K>
Plan plan_for(K kernel) {
  // kernels of one signature share this instantiation: key by the kernel
  static std::mutex mu;
  static std::map<std::pair<int, const void*>, Plan> cache;
  int device = 0;
  Plan p;
  p.err = cudaGetDevice(&device);
  if (p.err != cudaSuccess) return p;
  const auto key = std::make_pair(device, reinterpret_cast<const void*>(kernel));
  std::lock_guard<std::mutex> lock(mu);
  const auto hit = cache.find(key);
  if (hit != cache.end()) return hit->second;
  cudaDeviceGetAttribute(&p.blocks, cudaDevAttrMultiProcessorCount, device);
  cudaDeviceGetAttribute(&p.smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  p.err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               p.smem_max);
  if (p.err == cudaSuccess) cache[key] = p;
  return p;
}

// Blocks for `work` items at `per_block` items a block: at least one, at
// most one on each SM.
inline int grid_blocks(const Plan& plan, int64_t work, int64_t per_block) {
  const int64_t want = (work + per_block - 1) / per_block;
  if (want < 1) return 1;
  return static_cast<int>(want < plan.blocks ? want : plan.blocks);
}

}  // namespace tc_bins
