// Per-row top-k of float32 scores, in the order of jax.lax.top_k: values
// descending over float32's total order (+NaN > +inf > ... > +0.0 > -0.0 >
// ... > -inf > -NaN), ties broken by the lowest index, values returned bit
// for bit from the input. x is (n, l) row-major; values (n, k) float32 and
// indices (n, k) int64 are written row-major; 1 <= k <= min(l, 128).
//
// Replaces the TPU kernel torcheval_tpu/ops/topk.py::_topk_kernel (driven by
// pallas_topk). That kernel walks the label tiles of a row block in order,
// keeping a 128-lane carry of running maxima in VMEM, and runs k unrolled
// max / min-index passes over carry and tile, with placeholder indices for
// empty carry lanes. None of that carries over: blocks here run in parallel
// and in no order, and a max over (value, index) pairs is one integer max
// once both live in one word. Each element becomes a 64-bit key:
//   high half: the float's bits, mapped so that unsigned order is the total
//              order (flip every bit of a negative float, the sign bit of a
//              positive one);
//   low half:  0xFFFFFFFF - index, so that the lower index wins a tie.
// Keys are unique, 0 is below every real key (the low half is > 0 for any
// index < 2^32 - 1) and marks an empty slot, and the largest key is the
// element lax.top_k puts first.
//
// Selection runs in passes of one launch each. In a pass, each block takes
// one tile of at most kTile keys of one row (a balanced cut of the row) and
// selects its k largest in k rounds. Each thread holds kPerThread keys in
// registers and its own maximum; each warp's maximum sits in shared memory.
// A round takes the block's maximum from the warp maxima (one warp-wide
// reduction), writes it out, and only the thread that held it rescans its
// registers for the largest key below it, and only its warp reduces again.
// A pass over a row of len keys leaves ceil(len / kTile) * k candidates per
// row in a workspace; passes repeat until one tile holds the row, and the
// last pass decodes its k keys into values and indices. At (8192, 10000),
// k = 5 that is two passes (3 tiles, then 15 candidates); at (64, 10^6),
// k = 100 three (245 tiles, then 6, then 1), so the first pass has 15,680
// blocks and fills the card even with 64 rows.
//
// Bound on an H100 SXM: device-memory bytes. The work reads each score once
// (4 bytes) and writes 12 bytes per selected element: (8192 * 10000 * 4 +
// 8192 * 5 * 12) bytes are about 98 us at 3.35 TB/s. The first pass reads
// each score once, in coalesced loads, and never writes a key to memory;
// later passes touch only k keys per tile. The k rounds of a block are
// latency-bound (two barriers each), which costs at large k; per-warp
// register heaps or a radix-select threshold would cut the rounds, later.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long Key;

constexpr int kThreads = 256;
constexpr int kSmallThreads = 32;
constexpr int kPerThread = 16;
constexpr int64_t kTile = static_cast<int64_t>(kThreads) * kPerThread;
constexpr int64_t kSmallTile = static_cast<int64_t>(kSmallThreads) * kPerThread;
constexpr int64_t kMaxBlocks = 0x7FFFFFFF;

__device__ __forceinline__ Key score_key(float v, int64_t i) {
  const uint32_t b = __float_as_uint(v);
  const uint32_t u = b ^ ((b >> 31) ? 0xFFFFFFFFu : 0x80000000u);
  return (static_cast<Key>(u) << 32) |
         static_cast<Key>(0xFFFFFFFFu - static_cast<uint32_t>(i));
}

__device__ __forceinline__ Key warp_max(Key v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const Key w = __shfl_xor_sync(0xffffffffu, v, o);
    v = w > v ? w : v;
  }
  return v;
}

// One block: the k largest keys of tile t of row `row`, in descending order.
// FROM_SCORES: the tile is float scores (first pass), else keys of an earlier
// pass. FINAL: the row is one tile, and the keys decode into values and
// indices; else they go to keys_out as (row, tile, k).
template <int THREADS, bool FROM_SCORES, bool FINAL>
__global__ void __launch_bounds__(THREADS)
select_kernel(const float* __restrict__ scores, const Key* __restrict__ keys_in,
              int64_t row_len, int64_t tile, int64_t tiles, int k,
              Key* __restrict__ keys_out, float* __restrict__ values,
              int64_t* __restrict__ indices) {
  constexpr int kWarps = THREADS / 32;
  __shared__ Key warp_top[kWarps];
  __shared__ Key winner;
  const int64_t row = static_cast<int64_t>(blockIdx.x) / tiles;
  const int64_t t = static_cast<int64_t>(blockIdx.x) - row * tiles;
  const int64_t start = t * tile;
  const int64_t end = start + tile < row_len ? start + tile : row_len;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  Key key[kPerThread];
  Key mine = 0;
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int64_t i = start + static_cast<int64_t>(j) * THREADS + threadIdx.x;
    Key v = 0;
    if (i < end) {
      if constexpr (FROM_SCORES) {
        v = score_key(scores[row * row_len + i], i);
      } else {
        v = keys_in[row * row_len + i];
      }
    }
    key[j] = v;
    mine = v > mine ? v : mine;
  }
  // `top` is the same on every lane of a warp, so the branch on it below is
  // warp-uniform and its shuffles are legal.
  Key top = warp_max(mine);
  if (lane == 0) warp_top[warp] = top;
  __syncthreads();

  for (int r = 0; r < k; ++r) {
    if (warp == 0) {
      const Key v = warp_max(lane < kWarps ? warp_top[lane] : 0);
      if (lane == 0) {
        winner = v;
        if constexpr (FINAL) {
          const uint32_t u = static_cast<uint32_t>(v >> 32);
          const uint32_t b = u ^ ((u >> 31) ? 0x80000000u : 0xFFFFFFFFu);
          values[row * k + r] = __uint_as_float(b);
          indices[row * k + r] =
              static_cast<int64_t>(0xFFFFFFFFu - static_cast<uint32_t>(v));
        } else {
          keys_out[(row * tiles + t) * k + r] = v;
        }
      }
    }
    __syncthreads();
    const Key win = winner;
    if (top == win) {
      if (mine == win) {
        Key m = 0;
#pragma unroll
        for (int j = 0; j < kPerThread; ++j) {
          m = (key[j] < win && key[j] > m) ? key[j] : m;
        }
        mine = m;
      }
      top = warp_max(mine);
      if (lane == 0) warp_top[warp] = top;
    }
    __syncthreads();
  }
}

int64_t tiles_of(int64_t len) { return (len + kTile - 1) / kTile; }

// Workspace words of the two buffers that the passes write in turn.
void workspace_split(int64_t n, int64_t l, int k, int64_t* even, int64_t* odd) {
  *even = 0;
  *odd = 0;
  int64_t len = l;
  for (int pass = 0; len > kTile; ++pass) {
    const int64_t t = tiles_of(len);
    int64_t* side = (pass & 1) ? odd : even;
    if (n * t * k > *side) *side = n * t * k;
    len = t * k;
  }
}

template <bool FROM_SCORES, bool FINAL>
void launch_pass(int threads, int64_t blocks, cudaStream_t stream,
                 const float* scores, const Key* keys_in, int64_t row_len,
                 int64_t tile, int64_t tiles, int k, Key* keys_out,
                 float* values, int64_t* indices) {
  const unsigned grid = static_cast<unsigned>(blocks);
  if (threads == kSmallThreads) {
    select_kernel<kSmallThreads, FROM_SCORES, FINAL><<<grid, kSmallThreads, 0, stream>>>(
        scores, keys_in, row_len, tile, tiles, k, keys_out, values, indices);
  } else {
    select_kernel<kThreads, FROM_SCORES, FINAL><<<grid, kThreads, 0, stream>>>(
        scores, keys_in, row_len, tile, tiles, k, keys_out, values, indices);
  }
}

}  // namespace

extern "C" {

// Words (8 bytes each) of workspace that tc_topk needs for (n, l, k).
int64_t tc_topk_workspace(int64_t n, int64_t l, int k) {
  int64_t even = 0;
  int64_t odd = 0;
  workspace_split(n, l, k, &even, &odd);
  return even + odd;
}

int tc_topk(const float* x, int64_t n, int64_t l, int k, Key* workspace,
            float* values, int64_t* indices, void* stream_ptr) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  if (k < 1 || k > 128 || k > l || l >= 0x7FFFFFFF || n > kMaxBlocks) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  int64_t even = 0;
  int64_t odd = 0;
  workspace_split(n, l, k, &even, &odd);
  Key* buffers[2] = {workspace, workspace + even};
  const Key* keys = nullptr;
  int64_t len = l;
  int pass = 0;
  for (; len > kTile; ++pass) {
    const int64_t tiles = tiles_of(len);
    const int64_t tile = (len + tiles - 1) / tiles;
    if (n * tiles > kMaxBlocks) return static_cast<int>(cudaErrorInvalidValue);
    Key* out = buffers[pass & 1];
    if (pass == 0) {
      launch_pass<true, false>(kThreads, n * tiles, stream, x, nullptr, len,
                               tile, tiles, k, out, nullptr, nullptr);
    } else {
      launch_pass<false, false>(kThreads, n * tiles, stream, nullptr, keys, len,
                                tile, tiles, k, out, nullptr, nullptr);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    keys = out;
    len = tiles * k;
  }
  const int threads = len <= kSmallTile ? kSmallThreads : kThreads;
  if (pass == 0) {
    launch_pass<true, true>(threads, n, stream, x, nullptr, len, len, 1, k,
                            nullptr, values, indices);
  } else {
    launch_pass<false, true>(threads, n, stream, nullptr, keys, len, len, 1, k,
                             nullptr, values, indices);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
