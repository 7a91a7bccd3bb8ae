// Segment sum: out[rows[i], d] += vals[i, d] for every sample i and lane d,
// with out (S, D) zeroed by the caller. Rows outside [0, S) are dropped.
//
// Replaces the TPU kernel torcheval_tpu/ops/scatter.py::_scatter_kernel
// (driven by pallas_segment_sum). The TPU kernel contracts a one-hot of each
// sample block's rows against the values on the MXU, with a float32
// accumulator resident in VMEM: exact for integers only to 2^24 a segment,
// and O(N * S) work, so the JAX package engages it only for S <= 65,536 a
// shard. Here every add is an atomic in the values' own type: int32 and
// int64 sums are exact and wrap like XLA's scatter-add, float32 and float64
// add in no fixed order (the bound is stated in ops/scatter.py), and the
// work is O(N * D) for any S.
//
// Bound on an H100 SXM: device-memory bytes. The kernel reads each value and
// each row id once and writes S * D outputs: at N = 2^20, D = 2 int32 into
// S = 10^6 segments, 20.4 MB, about 6 us at 3.35 TB/s. What stands between
// the kernel and that bound is contention: cohort ids follow a power law,
// and one segment can take a quarter of a batch. What the design does about
// it:
// - each thread takes one (sample, lane) element, so values are read in
//   coalesced warp-wide loads for any D;
// - lanes of a warp that hold the same (row, lane) key elect one leader with
//   __match_any_sync; the leader adds its peers' values (read from a per-warp
//   scratch, in lane order) and issues one atomic for the group;
// - the first rows of the output (as many as fit kHeadBytes of shared
//   memory) are privatised per block: their atomics go to shared memory and
//   each block adds its non-zero bins to device memory once at the end. The
//   sliced collection interns cohorts in first-seen order, so the busiest
//   cohorts tend to hold the lowest rows; when S * D fits, the whole output
//   is privatised, as in hist.cu.
// Rows are read as int32 or int64 without a cast pass.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;
// head of privatised bins: with the 2 KB warp scratch, under the 48 KB of
// shared memory a block may take without an opt-in; small enough that the
// zeroing and the flush of the head cost no more than a block's share of
// the samples at the main path's sizes
constexpr int64_t kHeadBytes = 16 * 1024;

// Values are added in an unsigned type for integers (wrap-around is defined
// there and equals two's complement wrap) and in their own type for floats;
// atomicAdd has an overload for each of the four.
template <typename T>
struct Acc;
template <>
struct Acc<int32_t> {
  using U = unsigned int;
};
template <>
struct Acc<int64_t> {
  using U = unsigned long long;
};
template <>
struct Acc<float> {
  using U = float;
};
template <>
struct Acc<double> {
  using U = double;
};

template <typename U, typename R>
__global__ void __launch_bounds__(kThreads)
segment_sum_kernel(const U* __restrict__ vals, const R* __restrict__ rows,
                   int64_t n, int64_t d, int64_t s, int64_t head_len,
                   U* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  U* head = reinterpret_cast<U*>(smem);
  __shared__ U scratch[kThreads];
  for (int64_t b = threadIdx.x; b < head_len; b += blockDim.x) head[b] = U(0);
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp0 = threadIdx.x & ~31;
  const int64_t total = n * d;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  // `base` is the same for every thread of the block, so all lanes of a warp
  // take the same number of trips and the warp-wide match below is legal.
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * blockDim.x;
       base < total; base += stride) {
    const int64_t e = base + threadIdx.x;
    long long key = -1;  // -1: no element, or a row outside [0, s)
    U v = U(0);
    if (e < total) {
      const int64_t i = e / d;
      const int64_t r = static_cast<int64_t>(rows[i]);
      if (r >= 0 && r < s) {
        key = r * d + (e - i * d);
        v = vals[e];
      }
    }
    const unsigned peers =
        __match_any_sync(0xffffffffu, static_cast<unsigned long long>(key));
    scratch[threadIdx.x] = v;
    __syncwarp();
    if (key >= 0 && lane == __ffs(peers) - 1) {
      U sum = v;
      for (unsigned rest = peers & (peers - 1); rest; rest &= rest - 1) {
        sum += scratch[warp0 + __ffs(rest) - 1];
      }
      if (key < head_len) {
        atomicAdd(&head[key], sum);
      } else {
        atomicAdd(&out[key], sum);
      }
    }
    __syncwarp();
  }
  __syncthreads();
  for (int64_t b = threadIdx.x; b < head_len; b += blockDim.x) {
    const U v = head[b];
    if (v != U(0)) atomicAdd(&out[b], v);  // NaN != 0: NaN is carried over
  }
}

template <typename T, typename R>
int launch(const void* vals, const void* rows, int64_t n, int64_t d,
           int64_t s, void* out, void* stream) {
  using U = typename Acc<T>::U;
  if (n <= 0 || d <= 0 || s <= 0) return static_cast<int>(cudaGetLastError());
  const int64_t total = n * d;
  const int64_t head_cap = kHeadBytes / static_cast<int64_t>(sizeof(U));
  const int64_t head_len = s * d < head_cap ? s * d : head_cap;
  int device = 0;
  int sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  int64_t blocks = (total + kThreads - 1) / kThreads;
  const int64_t cap = static_cast<int64_t>(sms) * kBlocksPerSm;
  if (blocks > cap) blocks = cap;
  const size_t smem = static_cast<size_t>(head_len) * sizeof(U);
  segment_sum_kernel<U, R>
      <<<static_cast<unsigned>(blocks), kThreads, smem,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const U*>(vals), static_cast<const R*>(rows), n, d, s,
          head_len, static_cast<U*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_rows(int row_dtype, const void* vals, const void* rows, int64_t n,
                int64_t d, int64_t s, void* out, void* stream) {
  switch (row_dtype) {
    case 0:
      return launch<T, int32_t>(vals, rows, n, d, s, out, stream);
    case 1:
      return launch<T, int64_t>(vals, rows, n, d, s, out, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// val_dtype: 0 int32, 1 int64, 2 float32, 3 float64; row_dtype: 0 int32,
// 1 int64. `vals` is (n, d) row-major, `rows` (n,), and `out` (s, d) holds
// zeros of the values' type; the kernel adds into it.
int tc_segment_sum(int val_dtype, int row_dtype, const void* vals,
                   const void* rows, int64_t n, int64_t d, int64_t s,
                   void* out, void* stream) {
  switch (val_dtype) {
    case 0:
      return launch_rows<int32_t>(row_dtype, vals, rows, n, d, s, out, stream);
    case 1:
      return launch_rows<int64_t>(row_dtype, vals, rows, n, d, s, out, stream);
    case 2:
      return launch_rows<float>(row_dtype, vals, rows, n, d, s, out, stream);
    case 3:
      return launch_rows<double>(row_dtype, vals, rows, n, d, s, out, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
