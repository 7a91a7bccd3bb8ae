// Stable stream compaction: move the rows where mask != 0 to the front of
// up to 7 columns of raw 32-bit words, in input order, and write the number
// of such rows (n_live) to device memory. Output rows past n_live get the
// caller's per-column pad word, or are left as allocated when none is given.
//
// Replaces the TPU kernel torcheval_tpu/ops/stream_compact.py::_compact_kernel
// (driven by stream_compact and compact_summary_rows). The TPU grid runs in
// order on one core, so that kernel carries its fill level from one grid step
// to the next and compacts each 128-lane tile with a permutation matmul on the
// MXU, which forced it to split f32 scores into 16-bit halves and to require
// finite payloads. Here blocks run in parallel and in no order, so the
// compaction takes three simple launches:
//   1. count:   each block counts the live rows of its tile of kTile rows;
//   2. scan:    one block turns the per-tile counts into exclusive offsets and
//               writes their total as n_live;
//   3. scatter: each block walks its tile again in rounds of kThreads rows,
//               ranks live rows inside each warp with __ballot_sync + __popc,
//               offsets the warps through shared memory, and writes every
//               column of each live row to its slot; rows of its tile at or
//               past n_live (known from launch 2) get the pad words.
// Rows move as raw 32-bit words, so NaN, +-inf and -0.0 scores and int32
// counts travel bit for bit with no splitting.
//
// Bound on an H100 SXM: device-memory bytes. The work reads the mask once
// (1 byte a row) and each column once (4 bytes a row each), and writes each
// output column once: 25 bytes a row for the three summary columns, about
// 0.75 ms for the 6 * 2^24 rows of the first AUROC fold at 3.35 TB/s. This
// kernel writes each output word once (live rows or padding) but reads the
// mask twice (count and scatter), 26 bytes a row. A single pass with
// decoupled look-back would read it once; that is later work. The column
// loops run over a fixed kMaxCols with a guard, so the pointer struct stays
// in parameter space instead of a local-memory copy.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRounds = 8;
constexpr int64_t kTile = static_cast<int64_t>(kThreads) * kRounds;
constexpr int kMaxCols = 7;
constexpr int kScanThreads = 1024;

struct Columns {
  const uint32_t* src[kMaxCols];
  uint32_t* dst[kMaxCols];
  uint32_t pad[kMaxCols];
  int has_pad;
};

__global__ void __launch_bounds__(kThreads)
count_kernel(const uint8_t* __restrict__ mask, int64_t n,
             int32_t* __restrict__ tile_counts) {
  __shared__ int32_t warp_sums[kWarps];
  const int64_t start = static_cast<int64_t>(blockIdx.x) * kTile;
  int32_t c = 0;
  for (int r = 0; r < kRounds; ++r) {
    const int64_t i = start + static_cast<int64_t>(r) * kThreads + threadIdx.x;
    c += (i < n && mask[i] != 0) ? 1 : 0;
  }
  for (int d = 16; d > 0; d >>= 1) c += __shfl_down_sync(0xffffffffu, c, d);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = c;
  __syncthreads();
  if (threadIdx.x == 0) {
    int32_t total = 0;
    for (int w = 0; w < kWarps; ++w) total += warp_sums[w];
    tile_counts[blockIdx.x] = total;
  }
}

__global__ void __launch_bounds__(kScanThreads)
scan_kernel(const int32_t* __restrict__ tile_counts, int64_t num_tiles,
            int64_t* __restrict__ tile_offsets, int32_t* __restrict__ n_live) {
  __shared__ int64_t warp_totals[kScanThreads / 32];
  __shared__ int64_t carry;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (int64_t base = 0; base < num_tiles; base += kScanThreads) {
    const int64_t i = base + threadIdx.x;
    const int64_t v = i < num_tiles ? tile_counts[i] : 0;
    int64_t x = v;  // inclusive scan inside the warp
    for (int d = 1; d < 32; d <<= 1) {
      const int64_t y = __shfl_up_sync(0xffffffffu, x, d);
      if (lane >= d) x += y;
    }
    if (lane == 31) warp_totals[warp] = x;
    __syncthreads();
    if (warp == 0) {  // inclusive scan of the warp totals
      int64_t w = warp_totals[lane];
      for (int d = 1; d < 32; d <<= 1) {
        const int64_t y = __shfl_up_sync(0xffffffffu, w, d);
        if (lane >= d) w += y;
      }
      warp_totals[lane] = w;
    }
    __syncthreads();
    const int64_t before = carry + (warp > 0 ? warp_totals[warp - 1] : 0);
    if (i < num_tiles) tile_offsets[i] = before + x - v;
    __syncthreads();
    if (threadIdx.x == kScanThreads - 1) carry = before + x;
    __syncthreads();
  }
  if (threadIdx.x == 0) *n_live = static_cast<int32_t>(carry);
}

__global__ void __launch_bounds__(kThreads)
scatter_kernel(const uint8_t* __restrict__ mask, int64_t n,
               const int64_t* __restrict__ tile_offsets,
               const int32_t* __restrict__ n_live, Columns cols, int n_cols) {
  __shared__ int32_t warp_base[kWarps];
  __shared__ int32_t round_total;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  const int64_t start = static_cast<int64_t>(blockIdx.x) * kTile;
  int64_t out = tile_offsets[blockIdx.x];
  const int64_t live_total = *n_live;
  for (int r = 0; r < kRounds; ++r) {
    const int64_t i = start + static_cast<int64_t>(r) * kThreads + threadIdx.x;
    const bool live = i < n && mask[i] != 0;
    const unsigned ballot = __ballot_sync(0xffffffffu, live);
    if (lane == 0) warp_base[warp] = __popc(ballot);
    __syncthreads();
    if (threadIdx.x == 0) {  // exclusive scan of the 8 warp counts
      int32_t acc = 0;
      for (int w = 0; w < kWarps; ++w) {
        const int32_t c = warp_base[w];
        warp_base[w] = acc;
        acc += c;
      }
      round_total = acc;
    }
    __syncthreads();
    if (live) {
      const int64_t dst = out + warp_base[warp] + __popc(ballot & below);
#pragma unroll
      for (int c = 0; c < kMaxCols; ++c) {
        if (c < n_cols) cols.dst[c][dst] = cols.src[c][i];
      }
    }
    // rows [n_live, n) receive no live row, so their pad writes never race
    if (cols.has_pad && i < n && i >= live_total) {
#pragma unroll
      for (int c = 0; c < kMaxCols; ++c) {
        if (c < n_cols) cols.dst[c][i] = cols.pad[c];
      }
    }
    out += round_total;
    __syncthreads();  // warp_base and round_total are rewritten next round
  }
}

}  // namespace

extern "C" {

// Number of tiles (and so of scratch entries) for n rows.
int64_t tc_stream_compact_tiles(int64_t n) { return (n + kTile - 1) / kTile; }

// mask: n bytes. src/dst: host arrays of n_cols device pointers to n 32-bit
// words each. tile_counts (int32) and tile_offsets (int64) hold
// tc_stream_compact_tiles(n) entries of scratch. n_live: one int32. pad: a
// host array of n_cols words written past n_live, or null to leave those
// rows as they are.
int tc_stream_compact(const uint8_t* mask, int64_t n, const void* const* src,
                      void* const* dst, const uint32_t* pad, int n_cols,
                      int32_t* tile_counts,
                      int64_t* tile_offsets, int32_t* n_live, void* stream) {
  if (n_cols < 0 || n_cols > kMaxCols) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0) {
    cudaMemsetAsync(n_live, 0, sizeof(int32_t), s);
    return static_cast<int>(cudaGetLastError());
  }
  Columns cols = {};
  for (int c = 0; c < n_cols; ++c) {
    cols.src[c] = static_cast<const uint32_t*>(src[c]);
    cols.dst[c] = static_cast<uint32_t*>(dst[c]);
    cols.pad[c] = pad != nullptr ? pad[c] : 0u;
  }
  cols.has_pad = pad != nullptr;
  const int64_t tiles = tc_stream_compact_tiles(n);
  count_kernel<<<static_cast<unsigned>(tiles), kThreads, 0, s>>>(mask, n, tile_counts);
  scan_kernel<<<1, kScanThreads, 0, s>>>(tile_counts, tiles, tile_offsets, n_live);
  scatter_kernel<<<static_cast<unsigned>(tiles), kThreads, 0, s>>>(
      mask, n, tile_offsets, n_live, cols, n_cols);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
