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
// finite payloads. Rows move here as raw 32-bit words, so NaN, +-inf and -0.0
// scores and int32 counts travel bit for bit with no splitting.
//
// Design: one launch of a single-pass scan with decoupled look-back
// (Merrill and Garland, 2016), after a memset of its status words.
//   * Tiles of kTile = 256 threads x 8 rows take their ids from an atomic
//     ticket, so every tile's predecessors are already running and the
//     look-back always makes progress.
//   * Each thread reads its 8 mask bytes as one 8-byte load; live counts
//     are scanned across the block with warp shuffles.
//   * Each tile publishes a 64-bit status word (flag in the top two bits,
//     count below): its own count first, then its inclusive prefix once its
//     first warp has looked back over the predecessors' words.
//   * Columns are read in coalesced 16-byte loads, all columns at once while
//     the first warp looks back, and each live word goes to its slot in a
//     shared-memory stage (one per column), so each warp then writes
//     contiguous runs of the output.
//   * Padding needs no n_live: tile b's dead rows fill the output range
//     [n - dead_incl(b), n - dead_excl(b)), dead_excl(b) = start(b) -
//     offset(b). These ranges are disjoint and cover [n_live, n) exactly.
//   * The last tile writes n_live.
//
// Bound on an H100 SXM: device-memory bytes. Each mask byte and column word
// is read once and each output word written once: 25 bytes a row for the
// three summary columns, 0.7512 ms for the 6 * 2^24 rows of the first AUROC
// fold at 3.35 TB/s. This kernel moves exactly those bytes, plus 8 bytes of
// status per 2048 rows. The kernel is instantiated per column count, so the
// column loops unroll and the pointer struct stays in parameter space.
// Registers (ptxas -v, sm_90a, CUDA 12.8): 32 for three columns, 30 to 64
// over 0 to 7 columns, no spills.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPerThread = 8;
constexpr int kTile = kThreads * kPerThread;
constexpr int kMaxCols = 7;
constexpr unsigned kFull = 0xffffffffu;
typedef unsigned long long Status;
constexpr Status kAggregate = Status{1} << 62;  // the tile's own count
constexpr Status kPrefix = Status{2} << 62;     // the count of tiles 0..b
constexpr Status kValue = (Status{1} << 62) - 1;

struct Columns {
  const uint32_t* src[kMaxCols];
  uint32_t* dst[kMaxCols];
  uint32_t pad[kMaxCols];
  int has_pad;
  int vec;  // every source column is 16-byte aligned
};

__device__ __forceinline__ Status load_status(const Status* p) {
  return *reinterpret_cast<const volatile Status*>(p);
}

__device__ __forceinline__ void store_status(Status* p, Status v) {
  *reinterpret_cast<volatile Status*>(p) = v;
}

// The sum of the counts of the tiles before `tile`, by warp 0 of the block.
__device__ int64_t look_back(const Status* status, int64_t tile) {
  const int lane = threadIdx.x & 31;
  int64_t excl = 0;
  for (int64_t end = tile - 1;; end -= 32) {
    const int64_t j = end - lane;
    Status w = j >= 0 ? load_status(status + j) : kPrefix;
    while (__any_sync(kFull, (w >> 62) == 0)) {
      if ((w >> 62) == 0) w = load_status(status + j);
    }
    const unsigned prefixes = __ballot_sync(kFull, (w >> 62) == 2);
    const int stop = prefixes ? __ffs(prefixes) - 1 : 31;
    int64_t v = lane <= stop ? static_cast<int64_t>(w & kValue) : 0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
    excl += v;
    if (prefixes) return excl;
  }
}

// One tile per block. NCOLS columns are staged at once in dynamic shared
// memory (NCOLS * kTile words), so every column's loads are in flight
// together, while the first warp looks back.
template <int NCOLS>
__global__ void __launch_bounds__(kThreads)
compact_kernel(const uint8_t* __restrict__ mask, int64_t n, int64_t tiles, Columns cols,
               Status* __restrict__ status, unsigned* __restrict__ ticket,
               int32_t* __restrict__ n_live) {
  extern __shared__ uint32_t stage[];
  __shared__ __align__(16) int16_t slot[kTile];  // a row's place among the tile's live rows, or -1
  __shared__ int warp_sum[kWarps];
  __shared__ int64_t tile_id;
  __shared__ int64_t offset;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  if (t == 0) tile_id = atomicAdd(ticket, 1u);
  __syncthreads();
  const int64_t tile = tile_id;
  const int64_t start = tile * kTile;
  const int rows = n - start < kTile ? static_cast<int>(n - start) : kTile;

  // this thread's 8 mask bytes: rows start + 8t .. start + 8t + 7
  const int r0 = t * kPerThread;
  unsigned bits = 0;
  if (rows == kTile && (reinterpret_cast<uintptr_t>(mask + start) & 7) == 0) {
    const uint2 m = *reinterpret_cast<const uint2*>(mask + start + r0);
    const uint32_t words[2] = {m.x, m.y};
#pragma unroll
    for (int q = 0; q < kPerThread; ++q) {
      bits |= ((words[q >> 2] >> (8 * (q & 3))) & 0xFFu) ? 1u << q : 0u;
    }
  } else {
    for (int q = 0; q < kPerThread; ++q) {
      if (r0 + q < rows && mask[start + r0 + q] != 0) bits |= 1u << q;
    }
  }
  const int c = __popc(bits);
  int incl = c;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  int total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int s = warp_sum[w];
    if (w < warp) incl += s;
    total += s;
  }
  if (t == 0) {
    store_status(status + tile, (tile == 0 ? kPrefix : kAggregate) | static_cast<Status>(total));
  }
  const int excl = incl - c;
  uint32_t packed[kPerThread / 2];  // two 16-bit slots a word, stored as 16 bytes
#pragma unroll
  for (int q = 0; q < kPerThread; q += 2) {
    const uint32_t lo = (bits >> q) & 1u ? excl + __popc(bits & ((1u << q) - 1u)) : 0xFFFFu;
    const uint32_t hi = (bits >> (q + 1)) & 1u ? excl + __popc(bits & ((2u << q) - 1u)) : 0xFFFFu;
    packed[q / 2] = lo | (hi << 16);
  }
  *reinterpret_cast<uint4*>(slot + r0) = make_uint4(packed[0], packed[1], packed[2], packed[3]);
  __syncthreads();

  if (warp == 0) {
    const int64_t before = tile == 0 ? 0 : look_back(status, tile);
    if (lane == 0) {
      if (tile > 0) store_status(status + tile, kPrefix | static_cast<Status>(before + total));
      offset = before;
    }
  }
  if (cols.vec && rows == kTile) {
#pragma unroll
    for (int j = 0; j < kTile / (4 * kThreads); ++j) {
      const int r = 4 * (t + j * kThreads);
      uint4 v[NCOLS > 0 ? NCOLS : 1];
#pragma unroll
      for (int col = 0; col < NCOLS; ++col) {
        v[col] = *reinterpret_cast<const uint4*>(cols.src[col] + start + r);
      }
      const int16_t s0 = slot[r], s1 = slot[r + 1], s2 = slot[r + 2], s3 = slot[r + 3];
#pragma unroll
      for (int col = 0; col < NCOLS; ++col) {
        uint32_t* st = stage + col * kTile;
        if (s0 >= 0) st[s0] = v[col].x;
        if (s1 >= 0) st[s1] = v[col].y;
        if (s2 >= 0) st[s2] = v[col].z;
        if (s3 >= 0) st[s3] = v[col].w;
      }
    }
  } else {
    for (int r = t; r < rows; r += kThreads) {
      const int16_t s = slot[r];
      if (s < 0) continue;
#pragma unroll
      for (int col = 0; col < NCOLS; ++col) stage[col * kTile + s] = cols.src[col][start + r];
    }
  }
  __syncthreads();
  const int64_t out = offset;
  const int64_t dead_excl = start - out;
  const int dead = rows - total;
  if (tile == tiles - 1 && t == 0) *n_live = static_cast<int32_t>(out + total);
#pragma unroll
  for (int col = 0; col < NCOLS; ++col) {
    uint32_t* dst = cols.dst[col];
    const uint32_t* st = stage + col * kTile;
    for (int i = t; i < total; i += kThreads) dst[out + i] = st[i];
    if (cols.has_pad) {
      const uint32_t pad = cols.pad[col];
      uint32_t* tail = dst + (n - dead_excl - dead);
      for (int i = t; i < dead; i += kThreads) tail[i] = pad;
    }
  }
}

template <int NCOLS>
cudaError_t launch(const uint8_t* mask, int64_t n, int64_t tiles, const Columns& cols,
                   Status* status, int32_t* n_live, cudaStream_t s) {
  const int smem = NCOLS * kTile * static_cast<int>(sizeof(uint32_t));
  static bool smem_set[64];  // per device, once
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= 64) return cudaErrorInvalidDevice;
  if (!smem_set[device]) {
    err = cudaFuncSetAttribute(compact_kernel<NCOLS>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    smem_set[device] = true;
  }
  compact_kernel<NCOLS><<<static_cast<unsigned>(tiles), kThreads, smem, s>>>(
      mask, n, tiles, cols, status, reinterpret_cast<unsigned*>(status + tiles), n_live);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Words (8 bytes each) of scratch for n rows: one status word per tile of
// kTile rows, then the tile ticket.
int64_t tc_stream_compact_scratch(int64_t n) { return (n + kTile - 1) / kTile + 1; }

// mask: n bytes. src/dst: host arrays of n_cols device pointers to n 32-bit
// words each. scratch: tc_stream_compact_scratch(n) words, zeroed here on
// the stream. n_live: one int32. pad: a host array of n_cols words written
// past n_live, or null to leave those rows as they are.
int tc_stream_compact(const uint8_t* mask, int64_t n, const void* const* src,
                      void* const* dst, const uint32_t* pad, int n_cols,
                      unsigned long long* scratch, int32_t* n_live, void* stream) {
  if (n_cols < 0 || n_cols > kMaxCols) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0) {
    cudaMemsetAsync(n_live, 0, sizeof(int32_t), s);
    return static_cast<int>(cudaGetLastError());
  }
  const int64_t tiles = tc_stream_compact_scratch(n) - 1;
  if (tiles > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  Columns cols = {};
  int vec = 1;
  for (int c = 0; c < n_cols; ++c) {
    cols.src[c] = static_cast<const uint32_t*>(src[c]);
    cols.dst[c] = static_cast<uint32_t*>(dst[c]);
    cols.pad[c] = pad != nullptr ? pad[c] : 0u;
    vec &= (reinterpret_cast<uintptr_t>(src[c]) & 15) == 0;
  }
  cols.has_pad = pad != nullptr;
  cols.vec = vec;
  const cudaError_t err = cudaMemsetAsync(scratch, 0, (tiles + 1) * sizeof(Status), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  switch (n_cols) {
    case 0: return static_cast<int>(launch<0>(mask, n, tiles, cols, scratch, n_live, s));
    case 1: return static_cast<int>(launch<1>(mask, n, tiles, cols, scratch, n_live, s));
    case 2: return static_cast<int>(launch<2>(mask, n, tiles, cols, scratch, n_live, s));
    case 3: return static_cast<int>(launch<3>(mask, n, tiles, cols, scratch, n_live, s));
    case 4: return static_cast<int>(launch<4>(mask, n, tiles, cols, scratch, n_live, s));
    case 5: return static_cast<int>(launch<5>(mask, n, tiles, cols, scratch, n_live, s));
    case 6: return static_cast<int>(launch<6>(mask, n, tiles, cols, scratch, n_live, s));
    default: return static_cast<int>(launch<7>(mask, n, tiles, cols, scratch, n_live, s));
  }
}

}  // extern "C"
