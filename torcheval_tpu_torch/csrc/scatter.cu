// Segment sum: out[rows[i], d] += vals[i, d] for every sample i and lane d,
// with out (S, D) zeroed by the caller. Rows outside [0, S) are dropped.
//
// Replaces the TPU kernel torcheval_tpu/ops/scatter.py::_scatter_kernel
// (driven by pallas_segment_sum). The TPU kernel contracts a one-hot of each
// sample block's rows against the values on the MXU, with a float32
// accumulator resident in VMEM: exact for integers only to 2^24 a segment,
// and O(N * S) work, so the JAX package engages it only for S <= 65,536 a
// shard. Here every add is in the values' own type: int32 and int64 sums
// are exact and wrap like XLA's scatter-add, float32 and float64 add in no
// fixed order (the bound is stated in ops/scatter.py), and the work is
// O(N * D) for any S.
//
// Bound on an H100 SXM: device-memory bytes. The kernel reads each value and
// each row id once and writes S * D outputs: at N = 2^20, D = 2 int32 or
// float32 with int32 rows into S = 10^6 segments, 20.6 MB, 6 us at 3.35
// TB/s. What stands between the kernel and that bound is contention: cohort
// ids follow a power law, the sliced collection interns them in first-seen
// order, and row 0 takes a quarter of a batch. Device-memory atomics on one
// word serialise, so the design keeps every row that a batch hits more
// than a few times in shared memory (privatised_bins.cuh):
// - a persistent grid, one 1024-thread block on each SM, so a block sees
//   thousands of samples for each head it zeroes and flushes;
// - for D = 1, 2 and 4 one thread takes four samples at a time: one read
//   of each row id, rows and values in 16-byte vector loads (two groups in
//   flight where a sample is at most 8 bytes), with a scalar head and tail
//   where a view is not 16-byte aligned (all scalar where the values and
//   the rows reach no common 16-byte boundary). Other D take one
//   (sample, lane) element a thread, the sample index stepped without a
//   division;
// - the head of the output is privatised per block in kHeadBytes of
//   dynamic shared memory: its first kHotRows rows in 32 lane copies
//   (fewer where they do not fit kHotBytes), so that the lanes of a warp
//   that add into the same hot row use distinct banks, then as many single
//   rows as fit (2112 rows at D = 2 of 4 bytes). Each block adds its
//   non-zero head words into `out` once;
// - rows past the head go straight to device memory as atomics whose
//   result is unused (RED); at the leg's sizes each takes about a dozen
//   samples a batch or fewer, so there is no warp match.
// What remains is the read of the rows and values and the caller's zeroing
// of `out` (PERF.md has the measured split).

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "privatised_bins.cuh"

namespace {

using tc_bins::kThreads;

// shared memory for the privatised head of the output
constexpr int64_t kHeadBytes = 32 * 1024;
// its first rows, kept in up to 32 lane copies within kHotBytes
constexpr int64_t kHotRows = 64;
constexpr int64_t kHotBytes = 16 * 1024;

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

// kCount elements from 16-byte aligned `p` in 16-byte loads
template <typename T, int kCount>
__device__ __forceinline__ void load16(const T* p, T (&out)[kCount]) {
  static_assert(kCount * sizeof(T) % 16 == 0, "whole 16-byte words");
  const int4* q = reinterpret_cast<const int4*>(p);
#pragma unroll
  for (int k = 0; k < static_cast<int>(kCount * sizeof(T) / 16); ++k) {
    const int4 x = tc_bins::load_once(q + k);
    memcpy(&out[k * 16 / sizeof(T)], &x, 16);
  }
}

// kD > 0: D is kD, samples in groups of four; kD == 0: D is d_rt, one
// element a thread.
template <typename U, typename R, int kD>
__global__ void __launch_bounds__(kThreads, 1)
segment_sum_kernel(const U* __restrict__ vals, const R* __restrict__ rows,
                   int64_t n, int d_rt, int64_t s, int hot_rows, int copies,
                   int head_rows, int64_t vec_lo, int64_t vec_hi,
                   U* __restrict__ out) {
  const int d = kD > 0 ? kD : d_rt;
  extern __shared__ __align__(16) unsigned char smem[];
  U* head = reinterpret_cast<U*>(smem);
  const int hot_words = hot_rows * d;
  const int head_words = head_rows * d;
  tc_bins::zero(head, static_cast<int64_t>(hot_words) * copies + head_words - hot_words);
  __syncthreads();

  U* mine = head + (threadIdx.x & (copies - 1));
  U* warm = head + hot_words * (copies - 1);  // warm[w] is head word w >= hot_words
  // r in [0, s)
  auto add = [&](int64_t r, int j, U v) {
    if (r < hot_rows) {
      atomicAdd(mine + (static_cast<int>(r) * d + j) * copies, v);
    } else if (r < head_rows) {
      atomicAdd(warm + static_cast<int>(r) * d + j, v);
    } else {
      atomicAdd(out + r * d + j, v);
    }
  };
  auto in_range = [&](R r) {
    return static_cast<uint64_t>(static_cast<int64_t>(r)) < static_cast<uint64_t>(s);
  };
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t threads = static_cast<int64_t>(gridDim.x) * blockDim.x;

  if constexpr (kD > 0) {
    // scalar head and tail around the 16-byte aligned body
    auto sample = [&](int64_t i) {
      const R r = rows[i];
      if (!in_range(r)) return;
#pragma unroll
      for (int j = 0; j < kD; ++j) add(r, j, vals[i * kD + j]);
    };
    for (int64_t i = tid; i < vec_lo; i += threads) sample(i);
    for (int64_t i = vec_hi + tid; i < n; i += threads) sample(i);

    constexpr int kGroups = kD * sizeof(U) <= 8 ? 2 : 1;
    const R* rows4 = rows + vec_lo;
    const U* vals4 = vals + vec_lo * kD;
    const int64_t groups = (vec_hi - vec_lo) / 4;
    for (int64_t g = tid; g < groups; g += kGroups * threads) {
      R r[kGroups][4];
      U v[kGroups][4 * kD];
#pragma unroll
      for (int k = 0; k < kGroups; ++k) {
        const int64_t x = g + k * threads;
        if (x < groups) {
          load16(rows4 + x * 4, r[k]);
          load16(vals4 + x * 4 * kD, v[k]);
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i) r[k][i] = R(-1);
        }
      }
#pragma unroll
      for (int k = 0; k < kGroups; ++k) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (!in_range(r[k][i])) continue;
#pragma unroll
          for (int j = 0; j < kD; ++j) add(r[k][i], j, v[k][i * kD + j]);
        }
      }
    }
  } else {
    const int64_t total = n * d;
    int64_t i = tid / d;
    int j = static_cast<int>(tid - i * d);
    const int64_t step_i = threads / d;
    const int step_j = static_cast<int>(threads - step_i * d);
    for (int64_t e = tid; e < total; e += threads) {
      const R r = rows[i];
      if (in_range(r)) add(r, j, vals[e]);
      i += step_i;
      j += step_j;
      if (j >= d) {
        j -= d;
        ++i;
      }
    }
  }
  __syncthreads();
  tc_bins::fold_copies(head, hot_words, copies);
  __syncthreads();
  tc_bins::flush(head, head_words, hot_words, copies, out);
}

template <typename U, typename R, int kD>
int launch_d(const U* vals, const R* rows, int64_t n, int64_t d, int64_t s,
             U* out, void* stream) {
  const tc_bins::Plan plan = tc_bins::plan_for(segment_sum_kernel<U, R, kD>);
  if (plan.err != cudaSuccess) return static_cast<int>(plan.err);
  // the head: kHotRows rows in as many copies as fit kHotBytes (fewer rows
  // where one copy does not fit), then single rows up to kHeadBytes
  const int64_t row_bytes = d * static_cast<int64_t>(sizeof(U));
  int64_t hot_rows = s < kHotRows ? s : kHotRows;
  int copies = tc_bins::kMaxCopies;
  while (copies > 1 && hot_rows * row_bytes * copies > kHotBytes) copies /= 2;
  if (hot_rows * row_bytes > kHotBytes) hot_rows = kHotBytes / row_bytes;
  int64_t head_rows = hot_rows + (kHeadBytes - hot_rows * row_bytes * copies) / row_bytes;
  if (head_rows > s) head_rows = s;
  // the first sample whose row id and values both sit on 16-byte
  // boundaries; none (n, all scalar) where the two views disagree
  int64_t vec_lo = n;
  if (kD > 0) {
    const uintptr_t r0 = reinterpret_cast<uintptr_t>(rows);
    const uintptr_t v0 = reinterpret_cast<uintptr_t>(vals);
    for (int64_t h = 0; h < 16 && h < n; ++h) {
      if ((r0 + h * sizeof(R)) % 16 == 0 && (v0 + h * kD * sizeof(U)) % 16 == 0) {
        vec_lo = h;
        break;
      }
    }
  }
  const int64_t vec_hi = vec_lo + (n - vec_lo) / 4 * 4;
  const int64_t per_block = kD > 0 ? kThreads * 4 : kThreads;
  const int blocks = tc_bins::grid_blocks(plan, kD > 0 ? n : n * d, per_block);
  const size_t smem = static_cast<size_t>((hot_rows * copies + head_rows - hot_rows) * d) *
                     sizeof(U);
  segment_sum_kernel<U, R, kD><<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      vals, rows, n, static_cast<int>(d), s, static_cast<int>(hot_rows), copies,
      static_cast<int>(head_rows), vec_lo, vec_hi, out);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename R>
int launch(const void* vals, const void* rows, int64_t n, int64_t d, int64_t s,
           void* out, void* stream) {
  using U = typename Acc<T>::U;
  if (n <= 0 || d <= 0 || s <= 0) return static_cast<int>(cudaGetLastError());
  if (d > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const U* v = static_cast<const U*>(vals);
  const R* r = static_cast<const R*>(rows);
  U* o = static_cast<U*>(out);
  switch (d) {
    case 1:
      return launch_d<U, R, 1>(v, r, n, d, s, o, stream);
    case 2:
      return launch_d<U, R, 2>(v, r, n, d, s, o, stream);
    case 4:
      return launch_d<U, R, 4>(v, r, n, d, s, o, stream);
    default:
      return launch_d<U, R, 0>(v, r, n, d, s, o, stream);
  }
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
