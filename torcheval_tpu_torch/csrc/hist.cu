// Class histogram: out[c] = number of labels equal to c, for c in [0, C).
// Labels outside [0, C) (negative or >= C) are dropped.
//
// Replaces the TPU kernel torcheval_tpu/ops/pallas_hist.py::_hist_kernel
// (driven by pallas_class_counts). The TPU kernel compares each label block
// against a class iota and sums a float32 one-hot in VMEM, exact to 2^24
// per class. Here every count is an integer atomic, so the result is exact
// to 2^31 per class and the same on every run.
//
// Bound on an H100 SXM: device-memory bytes. The kernel reads each label
// once, N * sizeof(label) bytes, and writes C * 4 bytes: 2^22 int64 labels
// at C = 1000 are 33.6 MB, 10 us at 3.35 TB/s. What the design does about
// it (privatised_bins.cuh):
// - a persistent grid, one 1024-thread block on each SM, reads the labels
//   in 16-byte vector loads (2 int64 or 4 int32 labels), four in flight per
//   thread, evict-first, with a scalar head and tail where the view is not
//   16-byte aligned; int32 and int64 labels are both read natively;
// - each block counts into a privatised histogram of one class tile in
//   dynamic shared memory, up to the device's opt-in maximum (58,112 bins
//   on an H100), so C = 20000 reads the stream once. Where the tile fits
//   kCopyBytes twice or more, lane l counts into copy l % copies (32 copies
//   up to C = 128, 4 at C = 1000), so lanes that share a bin use distinct
//   banks and a run of equal labels does not serialise on one word; a large
//   C takes one copy, where lanes rarely share a bin. No warp match: it
//   cost more than it saved at C = 1000. Each thread's first loads go out
//   before the bins are zeroed, so a small stream (one trip a thread) does
//   not wait on the zeroing and its barrier;
// - each block adds its non-zero bins into `out` once: 132 atomics a bin
//   on an H100, where the earlier design's 1056 blocks of 256 threads sent
//   1.05 million atomics onto the 1000 words of the macro leg.
// Past the opt-in maximum the classes are tiled over blockIdx.y, and each
// tile reads the stream again. What remains is the read itself: a PyTorch
// reduction over the same labels takes as long (PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

#include "privatised_bins.cuh"

namespace {

using tc_bins::kThreads;

// shared memory for the interleaved copies of a tile's bins
constexpr int64_t kCopyBytes = 16 * 1024;
// 16-byte loads in flight per thread
constexpr int kUnroll = 4;

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
hist_kernel(const T* __restrict__ labels, int64_t n, int64_t num_classes,
            int tile, int copies, int64_t vec_lo, int64_t vec_hi,
            int32_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned* bins = reinterpret_cast<unsigned*>(smem);
  const int64_t c0 = static_cast<int64_t>(blockIdx.y) * tile;
  const int width = static_cast<int>(
      num_classes - c0 < tile ? num_classes - c0 : tile);
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t threads = static_cast<int64_t>(gridDim.x) * blockDim.x;

  constexpr int kPer = 16 / sizeof(T);
  const int4* body = reinterpret_cast<const int4*>(labels + vec_lo);
  const int64_t words = (vec_hi - vec_lo) / kPer;
  int4 v[kUnroll];
  auto load = [&](int64_t w) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t x = w + u * threads;
      // past the end: -1 labels, which are dropped
      v[u] = x < words ? tc_bins::load_once(body + x) : make_int4(-1, -1, -1, -1);
    }
  };
  load(tid);  // in flight while the bins are zeroed
  tc_bins::zero(bins, static_cast<int64_t>(width) * copies);
  __syncthreads();

  unsigned* mine = bins + (threadIdx.x & (copies - 1));
  auto count = [&](T label) {
    const uint64_t b = static_cast<uint64_t>(static_cast<int64_t>(label) - c0);
    if (b < static_cast<uint64_t>(width)) atomicAdd(mine + static_cast<int>(b) * copies, 1u);
  };
  for (int64_t w = tid; w < words; w += kUnroll * threads) {
    if (w != tid) load(w);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const T* l = reinterpret_cast<const T*>(&v[u]);
#pragma unroll
      for (int j = 0; j < kPer; ++j) count(l[j]);
    }
  }
  // scalar head and tail around the 16-byte aligned body
  for (int64_t i = tid; i < vec_lo; i += threads) count(labels[i]);
  for (int64_t i = vec_hi + tid; i < n; i += threads) count(labels[i]);
  __syncthreads();
  tc_bins::fold_copies(bins, width, copies);
  __syncthreads();
  tc_bins::flush(bins, width, width, copies, reinterpret_cast<unsigned*>(out + c0));
}

template <typename T>
int launch_hist(const T* labels, int64_t n, int64_t num_classes, int32_t* out,
                void* stream) {
  if (n <= 0 || num_classes <= 0) return static_cast<int>(cudaGetLastError());
  auto kernel = hist_kernel<T>;
  const tc_bins::Plan plan = tc_bins::plan_for(kernel);
  if (plan.err != cudaSuccess) return static_cast<int>(plan.err);
  const int64_t max_bins = plan.smem_max / static_cast<int64_t>(sizeof(unsigned));
  const int tile = static_cast<int>(num_classes < max_bins ? num_classes : max_bins);
  const int tiles = static_cast<int>((num_classes + tile - 1) / tile);
  int copies = 1;
  while (copies < tc_bins::kMaxCopies && 2 * copies * static_cast<int64_t>(tile) * 4 <= kCopyBytes) {
    copies *= 2;
  }
  // the first label at a 16-byte boundary (labels are element-aligned)
  constexpr int64_t kPer = 16 / sizeof(T);
  const int64_t mis = static_cast<int64_t>(reinterpret_cast<uintptr_t>(labels) % 16);
  int64_t vec_lo = mis == 0 ? 0 : (16 - mis) / static_cast<int64_t>(sizeof(T));
  if (vec_lo > n) vec_lo = n;
  const int64_t vec_hi = vec_lo + (n - vec_lo) / kPer * kPer;
  const int blocks = tc_bins::grid_blocks(plan, n, kThreads * kPer * kUnroll);
  const size_t smem = static_cast<size_t>(tile) * copies * sizeof(unsigned);
  kernel<<<dim3(static_cast<unsigned>(blocks), static_cast<unsigned>(tiles)), kThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(labels, n, num_classes, tile, copies, vec_lo,
                                                vec_hi, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// `out` must hold num_classes zeroed int32 counts; the kernel adds into it.
int tc_hist_i32(const int32_t* labels, int64_t n, int64_t num_classes,
                int32_t* out, void* stream) {
  return launch_hist<int32_t>(labels, n, num_classes, out, stream);
}

int tc_hist_i64(const int64_t* labels, int64_t n, int64_t num_classes,
                int32_t* out, void* stream) {
  return launch_hist<int64_t>(labels, n, num_classes, out, stream);
}

const char* tc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
