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
//
// Three routes, chosen by the wrapper (ops/scatter.py::segment_sum_route)
// from the output's size S x D x sizeof(U) alone and passed in as the
// cluster size. They differ only in where the adds past the head land:
// - local (cluster 1; at most kHeadBytes - kHotBytes): the head holds
//   every row;
// - head (cluster 1; more than a cluster holds): device memory (RED);
// - cluster (2, 4 or 8 blocks; at most 128 KiB a block, 1 MiB in all):
//   the output does not fit a head but fits the shared memory of a thread
//   block cluster. A score sketch is such an output (2^16 buckets x 2
//   int32 lanes, 512 KiB), and its hot buckets lie where the scores are,
//   far past any head: a float-prefix sketch of CTR logits fills some
//   2,800 buckets around id 16,300, whose device-memory atomics serialised
//   on those words (33 ms for 89M rows on an H100). Here each block of a
//   cluster also owns a slice of the output in its dynamic shared memory,
//   beside its head: row r lives in block r % cluster's slice at local row
//   r / cluster (interleaved, so that a band of neighbouring hot buckets
//   loads every block alike, not the one block whose contiguous slice
//   would hold the band). Every add past the head goes to the owner's
//   slice through distributed shared memory (cluster.map_shared_rank),
//   none to device memory during the stream; after a cluster barrier
//   each block adds its head's and its slice's non-zero words into `out`
//   once. The head stays: interned cohorts' hot rows are its first rows,
//   and without its lane copies a power-law window into 4,096 or 65,536
//   cohorts ran 2-4x slower than on the head route. An integer lane of
//   value 0 skips its add to a slice (an integer add of 0 changes
//   nothing, and it halves a sketch's [t, 1 - t] adds); a float lane adds
//   every value, signed zeros included. The grid is at most as many
//   clusters as the card holds at once (cudaOccupancyMaxActiveClusters).
// The reads are the same code in every route.
//
// Two row sources, one kernel body (segment_sum_kernel's Src). RowSource
// reads (rows[i], vals[i, j]): the segment sum above. ScoreSource is the
// binary score sketch's fold (sketch/histogram.py::score_hist_fold) fused
// into the kernel: it reads each float32 score and float32 or int32 target
// once, in 16-byte loads, and makes in registers what the plain version
// makes in some 18 elementwise passes over the rows (bucket keys widened to
// int64, the stacked [t, 1 - t] lanes, the NaN mask): the bucket id, the
// lanes and the NaN test. Its adds go where the segment sum's go, on the
// route of the (2^bits, 2) int32 output; its NaN count is summed in the
// block and added with one atomic a block. The fold's least traffic is then
// the kernel's: 8 bytes a row (at 89M rows 0.21 ms at 3.35 TB/s), where the
// plain version moved some 210.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>
#include <string.h>

#include <map>
#include <mutex>
#include <tuple>
#include <type_traits>

#include "privatised_bins.cuh"

namespace {

using tc_bins::kThreads;

// shared memory for the privatised head of the output
constexpr int64_t kHeadBytes = 32 * 1024;
// its first rows, kept in up to 32 lane copies within kHotBytes
constexpr int64_t kHotRows = 64;
constexpr int64_t kHotBytes = 16 * 1024;
// the most blocks of a cluster in the cluster route (the portable size)
constexpr int kMaxCluster = 8;

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

// Where a block keeps its sums: the first hot_rows rows in `copies` lane
// copies, then single rows up to head_rows (the head). In the cluster form
// also a slice of the output at word slice_at: row r in the slice of the
// cluster's block r & (2^shift - 1), at local row r >> shift.
struct Layout {
  int hot_rows;
  int copies;
  int head_rows;
  int shift;
  int slice_at;
};

// Every in-range (row, lane, value) of the stream, handed to add(r, j, v)
// by the calling thread. kD > 0: D is kD, samples in groups of four;
// kD == 0: D is d_rt, one element a thread.
template <typename U, typename R, int kD, typename Add>
__device__ __forceinline__ void for_each_add(const U* __restrict__ vals,
                                             const R* __restrict__ rows, int64_t n,
                                             int d_rt, int64_t s, int64_t vec_lo,
                                             int64_t vec_hi, Add add) {
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
    const int d = d_rt;
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
}

// A row source: the kernel's two input streams, a (`A`) and b (`B`), and
// how each sample's adds come from them. for_each hands every in-range
// (row, lane, value) to add and returns what the thread counted beside
// (0 here); finish has nothing to write. kVector: the stream is read in
// groups of four samples from the first sample where a and b both sit on
// 16-byte boundaries, kBytesA and kBytesB bytes a sample.
//
// The segment sum's own source: a = vals (N, D), b = rows (N,).
template <typename U, typename R, int kD>
struct RowSource {
  using A = U;
  using B = R;
  struct Param {};
  static constexpr bool kVector = kD > 0;
  static constexpr int64_t kBytesA = kD * static_cast<int64_t>(sizeof(U));
  static constexpr int64_t kBytesB = sizeof(R);

  template <typename Add>
  static __device__ __forceinline__ int for_each(const U* __restrict__ vals,
                                                 const R* __restrict__ rows, int64_t n,
                                                 int d_rt, int64_t s, int64_t vec_lo,
                                                 int64_t vec_hi, Param, Add add) {
    for_each_add<U, R, kD>(vals, rows, n, d_rt, s, vec_lo, vec_hi, add);
    return 0;
  }
  static __device__ __forceinline__ void finish(int, Param, unsigned char*) {}
};

// The binary score sketch's fold (sketch/histogram.py::score_hist_fold):
// a = float32 scores (N,), b = targets (N,), float32 or int32. A row's
// bucket is the top (32 - shift) bits of its score's order key, built in
// registers as sketch/buckets.py::ascending_key builds it; its lanes are
// (t, 1 - t) with t the target cast to int32 as Tensor.to(torch.int32)
// casts it on the card (a float truncates toward zero: cvt.rzi); a NaN
// score adds nothing and counts one NaN, which finish sums over the block
// and adds to *nan with one atomic. A lane of 0 is no add.
struct ScoreParam {
  int shift;
  unsigned* nan;
};

__device__ __forceinline__ int64_t score_bucket(float x, int shift) {
  if (fabsf(x) < FLT_MIN) x = 0.0f;  // subnormals and -0.0 to +0.0
  const unsigned bits = __float_as_uint(x);
  const unsigned key = (bits & 0x80000000u) ? ~bits : (bits | 0x80000000u);
  return static_cast<int64_t>(key >> shift);
}

template <typename T>
struct ScoreSource {
  using A = float;
  using B = T;
  using Param = ScoreParam;
  static constexpr bool kVector = true;
  static constexpr int64_t kBytesA = sizeof(float);
  static constexpr int64_t kBytesB = sizeof(T);

  template <typename Add>
  static __device__ __forceinline__ int for_each(const float* __restrict__ scores,
                                                 const T* __restrict__ targets, int64_t n,
                                                 int, int64_t, int64_t vec_lo, int64_t vec_hi,
                                                 Param p, Add add) {
    int nans = 0;
    auto sample = [&](float x, T t) {
      if (isnan(x)) {
        ++nans;
        return;
      }
      const unsigned lane = static_cast<unsigned>(static_cast<int32_t>(t));
      const int64_t r = score_bucket(x, p.shift);
      if (lane != 0u) add(r, 0, lane);
      if (lane != 1u) add(r, 1, 1u - lane);
    };
    const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    const int64_t threads = static_cast<int64_t>(gridDim.x) * blockDim.x;
    for (int64_t i = tid; i < vec_lo; i += threads) sample(scores[i], targets[i]);
    for (int64_t i = vec_hi + tid; i < n; i += threads) sample(scores[i], targets[i]);

    // two groups of four rows in flight, as the row source's 8-byte samples
    constexpr int kGroups = 2;
    const float* scores4 = scores + vec_lo;
    const T* targets4 = targets + vec_lo;
    const int64_t groups = (vec_hi - vec_lo) / 4;
    for (int64_t g = tid; g < groups; g += kGroups * threads) {
      float x[kGroups][4];
      T t[kGroups][4];
#pragma unroll
      for (int k = 0; k < kGroups; ++k) {
        const int64_t q = g + k * threads;
        if (q < groups) {
          load16(scores4 + q * 4, x[k]);
          load16(targets4 + q * 4, t[k]);
        }
      }
#pragma unroll
      for (int k = 0; k < kGroups; ++k) {
        if (g + k * threads >= groups) continue;
#pragma unroll
        for (int i = 0; i < 4; ++i) sample(x[k][i], t[k][i]);
      }
    }
    return nans;
  }

  // The block's NaN count into *p.nan: one warp sum each into `scratch`
  // (shared memory no thread reads any more), one atomic a block.
  static __device__ __forceinline__ void finish(int nans, Param p, unsigned char* scratch) {
    unsigned* warps = reinterpret_cast<unsigned*>(scratch);
    __syncthreads();
    const unsigned mine = __reduce_add_sync(0xffffffffu, static_cast<unsigned>(nans));
    if ((threadIdx.x & 31) == 0) warps[threadIdx.x >> 5] = mine;
    __syncthreads();
    if (threadIdx.x < 32) {
      const unsigned w = threadIdx.x < (blockDim.x >> 5) ? warps[threadIdx.x] : 0u;
      const unsigned block = __reduce_add_sync(0xffffffffu, w);
      if (threadIdx.x == 0 && block != 0u) atomicAdd(p.nan, block);
    }
  }
};

// Src: the row source; kD: D as for_each_add (Src::for_each takes it);
// kCluster: the cluster form, launched in clusters of 2^lay.shift blocks,
// where rows past the head go to the cluster's slices; else the head form,
// where they go to device memory.
template <typename U, int kD, bool kCluster, typename Src>
__global__ void __launch_bounds__(kThreads, 1)
segment_sum_kernel(const typename Src::A* __restrict__ a, const typename Src::B* __restrict__ b,
                   int64_t n, int d_rt, int64_t s, Layout lay, int64_t vec_lo,
                   int64_t vec_hi, typename Src::Param param, U* __restrict__ out) {
  namespace cg = cooperative_groups;
  const int d = kD > 0 ? kD : d_rt;
  extern __shared__ __align__(16) unsigned char smem[];
  U* head = reinterpret_cast<U*>(smem);
  const int hot_rows = lay.hot_rows;
  const int head_rows = lay.head_rows;
  const int copies = lay.copies;
  const int hot_words = hot_rows * d;
  const int head_words = head_rows * d;
  const int shift = lay.shift;
  const unsigned owner_mask = (1u << shift) - 1;
  U* slice = head + lay.slice_at;
  // the cluster form's slice: rows r with r & owner_mask == this block's
  // rank (words of rows in the head or past S stay 0 and are never flushed)
  const int slice_words = kCluster ? static_cast<int>(((s + owner_mask) >> shift) * d) : 0;
  tc_bins::zero(head, kCluster ? static_cast<int64_t>(lay.slice_at) + slice_words
                               : static_cast<int64_t>(hot_words) * copies + head_words - hot_words);
  // every slice of the cluster zeroed (and every block of it running)
  // before any add lands in it
  if constexpr (kCluster) {
    cg::this_cluster().sync();
  } else {
    __syncthreads();
  }

  U* mine = head + (threadIdx.x & (copies - 1));
  U* warm = head + hot_words * (copies - 1);  // warm[w] is head word w >= hot_words
  // r in [0, s)
  auto add = [&](int64_t r, int j, U v) {
    if (r < hot_rows) {
      atomicAdd(mine + (static_cast<int>(r) * d + j) * copies, v);
    } else if (r < head_rows) {
      atomicAdd(warm + static_cast<int>(r) * d + j, v);
    } else if constexpr (kCluster) {
      if constexpr (!std::is_floating_point<U>::value) {
        if (v == U(0)) return;
      }
      U* owner = cg::this_cluster().map_shared_rank(slice, static_cast<unsigned>(r) & owner_mask);
      atomicAdd(owner + static_cast<int>(r >> shift) * d + j, v);
    } else {
      atomicAdd(out + r * d + j, v);
    }
  };
  const int counted = Src::for_each(a, b, n, d_rt, s, vec_lo, vec_hi, param, add);
  // the cluster form: every add of the cluster landed before a block reads
  // its slice, and no block leaves while another may still add into it
  if constexpr (kCluster) {
    cg::this_cluster().sync();
  } else {
    __syncthreads();
  }
  tc_bins::fold_copies(head, hot_words, copies);
  __syncthreads();
  tc_bins::flush(head, head_words, hot_words, copies, out);
  if constexpr (kCluster) {
    const int64_t rank = static_cast<int64_t>(cg::this_cluster().block_rank());
    for (int w = threadIdx.x; w < slice_words; w += blockDim.x) {
      const U sum = slice[w];
      if (sum != U(0)) {  // NaN != 0: NaN is carried
        const int q = w / d;
        atomicAdd(out + ((static_cast<int64_t>(q) << shift) + rank) * d + (w - q * d), sum);
      }
    }
  }
  Src::finish(counted, param, smem);
}

// The head for S rows of row_bytes: kHotRows rows in as many copies as fit
// kHotBytes (fewer rows where one copy does not fit), then single rows up
// to kHeadBytes; slice_at is its word count rounded up to 16 bytes.
Layout head_layout(int64_t s, int64_t row_bytes, int64_t word_bytes) {
  int64_t hot_rows = s < kHotRows ? s : kHotRows;
  int copies = tc_bins::kMaxCopies;
  while (copies > 1 && hot_rows * row_bytes * copies > kHotBytes) copies /= 2;
  if (hot_rows * row_bytes > kHotBytes) hot_rows = kHotBytes / row_bytes;
  int64_t head_rows = hot_rows + (kHeadBytes - hot_rows * row_bytes * copies) / row_bytes;
  if (head_rows > s) head_rows = s;
  const int64_t bytes = (hot_rows * copies + head_rows - hot_rows) * row_bytes;
  return Layout{static_cast<int>(hot_rows), copies, static_cast<int>(head_rows), 0,
                static_cast<int>((bytes + 15) / 16 * 16 / word_bytes)};
}

// the first sample whose a and b both sit on 16-byte boundaries; none (n,
// all scalar) where the two views disagree or the source reads no vectors
template <typename Src>
int64_t first_vector_sample(const typename Src::A* a, const typename Src::B* b, int64_t n) {
  if (!Src::kVector) return n;
  const uintptr_t b0 = reinterpret_cast<uintptr_t>(b);
  const uintptr_t a0 = reinterpret_cast<uintptr_t>(a);
  for (int64_t h = 0; h < 16 && h < n; ++h) {
    if ((b0 + h * Src::kBytesB) % 16 == 0 && (a0 + h * Src::kBytesA) % 16 == 0) return h;
  }
  return n;
}

// Clusters of `cluster` blocks with `smem` bytes each that the current
// device holds at once (0 where none fits), cached by kernel and shape.
template <typename K>
cudaError_t max_clusters(K kernel, int cluster, size_t smem, int* clusters) {
  static std::mutex mu;
  static std::map<std::tuple<int, const void*, int, size_t>, int> cache;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const auto key = std::make_tuple(device, reinterpret_cast<const void*>(kernel), cluster, smem);
  std::lock_guard<std::mutex> lock(mu);
  const auto hit = cache.find(key);
  if (hit != cache.end()) {
    *clusters = hit->second;
    return cudaSuccess;
  }
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
  if (err == cudaSuccess) cache[key] = *clusters;
  return err;
}

template <typename U, int kD, typename Src>
int launch_cluster(const typename Src::A* a, const typename Src::B* b, int64_t n, int64_t d,
                   int64_t s, int cluster, typename Src::Param param, U* out,
                   cudaStream_t stream) {
  if (cluster < 2 || cluster > kMaxCluster || (cluster & (cluster - 1)) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto kernel = segment_sum_kernel<U, kD, true, Src>;
  const tc_bins::Plan plan = tc_bins::plan_for(kernel);
  if (plan.err != cudaSuccess) return static_cast<int>(plan.err);
  const int64_t word = static_cast<int64_t>(sizeof(U));
  Layout lay = head_layout(s, d * word, word);
  while ((1 << lay.shift) < cluster) ++lay.shift;
  const int64_t slice_rows = (s + cluster - 1) >> lay.shift;
  const int64_t smem = (lay.slice_at + slice_rows * d) * word;
  if (smem > plan.smem_max) return static_cast<int>(cudaErrorInvalidValue);
  int clusters = 0;
  const cudaError_t err = max_clusters(kernel, cluster, static_cast<size_t>(smem), &clusters);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (clusters < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int64_t vec_lo = first_vector_sample<Src>(a, b, n);
  const int64_t vec_hi = vec_lo + (n - vec_lo) / 4 * 4;
  // persistent: at most the clusters the card holds at once
  const int64_t per_cluster = (kD > 0 ? kThreads * 4 : kThreads) * static_cast<int64_t>(cluster);
  const int64_t work = kD > 0 ? n : n * d;
  int64_t grid = (work + per_cluster - 1) / per_cluster;
  if (grid < 1) grid = 1;
  if (grid > clusters) grid = clusters;

  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(static_cast<unsigned>(grid * cluster));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t launched = cudaLaunchKernelEx(&cfg, kernel, a, b, n, static_cast<int>(d), s,
                                                  lay, vec_lo, vec_hi, param, out);
  if (launched != cudaSuccess) return static_cast<int>(launched);
  return static_cast<int>(cudaGetLastError());
}

template <typename U, int kD, typename Src>
int launch_head(const typename Src::A* a, const typename Src::B* b, int64_t n, int64_t d,
                int64_t s, typename Src::Param param, U* out, cudaStream_t stream) {
  const tc_bins::Plan plan = tc_bins::plan_for(segment_sum_kernel<U, kD, false, Src>);
  if (plan.err != cudaSuccess) return static_cast<int>(plan.err);
  const int64_t word = static_cast<int64_t>(sizeof(U));
  const Layout lay = head_layout(s, d * word, word);
  const int64_t vec_lo = first_vector_sample<Src>(a, b, n);
  const int64_t vec_hi = vec_lo + (n - vec_lo) / 4 * 4;
  const int64_t per_block = kD > 0 ? kThreads * 4 : kThreads;
  const int blocks = tc_bins::grid_blocks(plan, kD > 0 ? n : n * d, per_block);
  const size_t smem =
      static_cast<size_t>((lay.hot_rows * lay.copies + lay.head_rows - lay.hot_rows) * d) * word;
  segment_sum_kernel<U, kD, false, Src><<<blocks, kThreads, smem, stream>>>(
      a, b, n, static_cast<int>(d), s, lay, vec_lo, vec_hi, param, out);
  return static_cast<int>(cudaGetLastError());
}

template <typename U, int kD, typename Src>
int launch_d(const typename Src::A* a, const typename Src::B* b, int64_t n, int64_t d, int64_t s,
             int cluster, typename Src::Param param, U* out, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cluster == 1) return launch_head<U, kD, Src>(a, b, n, d, s, param, out, st);
  return launch_cluster<U, kD, Src>(a, b, n, d, s, cluster, param, out, st);
}

template <typename T, typename R>
int launch(const void* vals, const void* rows, int64_t n, int64_t d, int64_t s, int cluster,
           void* out, void* stream) {
  using U = typename Acc<T>::U;
  if (n <= 0 || d <= 0 || s <= 0) return static_cast<int>(cudaGetLastError());
  if (d > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const U* v = static_cast<const U*>(vals);
  const R* r = static_cast<const R*>(rows);
  U* o = static_cast<U*>(out);
  switch (d) {
    case 1:
      return launch_d<U, 1, RowSource<U, R, 1>>(v, r, n, d, s, cluster, {}, o, stream);
    case 2:
      return launch_d<U, 2, RowSource<U, R, 2>>(v, r, n, d, s, cluster, {}, o, stream);
    case 4:
      return launch_d<U, 4, RowSource<U, R, 4>>(v, r, n, d, s, cluster, {}, o, stream);
    default:
      return launch_d<U, 0, RowSource<U, R, 0>>(v, r, n, d, s, cluster, {}, o, stream);
  }
}

template <typename T>
int launch_rows(int row_dtype, const void* vals, const void* rows, int64_t n,
                int64_t d, int64_t s, int cluster, void* out, void* stream) {
  switch (row_dtype) {
    case 0:
      return launch<T, int32_t>(vals, rows, n, d, s, cluster, out, stream);
    case 1:
      return launch<T, int64_t>(vals, rows, n, d, s, cluster, out, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The score source's launch: (2^bits, 2) unsigned counts, D = 2.
template <typename T>
int launch_scores(const void* scores, const void* targets, int64_t n, int bits, int cluster,
                  void* out, void* nan, void* stream) {
  if (bits < 1 || bits > 31) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const ScoreParam param{32 - bits, static_cast<unsigned*>(nan)};
  return launch_d<unsigned, 2, ScoreSource<T>>(
      static_cast<const float*>(scores), static_cast<const T*>(targets), n, 2,
      int64_t(1) << bits, cluster, param, static_cast<unsigned*>(out), stream);
}

}  // namespace

extern "C" {

// val_dtype: 0 int32, 1 int64, 2 float32, 3 float64; row_dtype: 0 int32,
// 1 int64. `vals` is (n, d) row-major, `rows` (n,), and `out` (s, d) holds
// zeros of the values' type; the kernel adds into it. `cluster` is the
// route the caller chose: 1 for the head form (local or head), 2, 4 or 8
// for the cluster form with that many blocks a cluster.
int tc_segment_sum(int val_dtype, int row_dtype, const void* vals,
                   const void* rows, int64_t n, int64_t d, int64_t s,
                   int cluster, void* out, void* stream) {
  switch (val_dtype) {
    case 0:
      return launch_rows<int32_t>(row_dtype, vals, rows, n, d, s, cluster, out, stream);
    case 1:
      return launch_rows<int64_t>(row_dtype, vals, rows, n, d, s, cluster, out, stream);
    case 2:
      return launch_rows<float>(row_dtype, vals, rows, n, d, s, cluster, out, stream);
    case 3:
      return launch_rows<double>(row_dtype, vals, rows, n, d, s, cluster, out, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The binary score sketch's fold in one launch: `scores` (n,) float32,
// `targets` (n,) of target_dtype (0 int32, 2 float32, tc_segment_sum's
// codes); `out` (2^bucket_bits, 2) int32 and `nan` one int32, both zeros,
// take the (t, 1 - t) counts by bucket and the NaN scores' count.
// `cluster` as tc_segment_sum's, the route of the (2^bits, 2) int32 output.
int tc_score_segment_sum(int target_dtype, const void* scores, const void* targets, int64_t n,
                         int bucket_bits, int cluster, void* out, void* nan, void* stream) {
  switch (target_dtype) {
    case 0:
      return launch_scores<int32_t>(scores, targets, n, bucket_bits, cluster, out, nan, stream);
    case 2:
      return launch_scores<float>(scores, targets, n, bucket_bits, cluster, out, nan, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
