// The exact binary AUROC over a sorted (key, label) stream, in two parts
// around the stable sort of csrc/roc_sort.cu (wrapper: ops/roc_stream.py):
//
// * The key pass reads each raw-cache tensor where it lies and writes, at its
//   offset in the stream, a uint32 order key and a one-byte label. The key
//   orders the scores descending with NaN last: the bits of -score, flipped
//   so that unsigned order is float order, -0.0 and +0.0 one key, and every
//   NaN the key 0xFFFFFFFF. The label is the target's int32 cast; a target
//   whose cast is not 0 or 1 sets a device flag, and the wrapper then takes
//   the composition (ops/curves.py), whose value it does not equal.
// * The integration adds, at each tie-group end e (the last row, a row whose
//   next key differs, or a NaN row), (FP_e - FP_p) * (TP_e + TP_p) to an
//   int64 doubled area, with p the previous group end (or (0, 0)), TP
//   inclusive counts of positives and FP_e = e + 1 - TP_e. The AUROC is
//   area / (2 P N) in double, returned as float32, and 0.5 when P N is 0.
//   This is the trapezoid of the JAX package's binary_auroc_kernel
//   (torcheval_tpu/ops/curves.py), exact in integers.
//
// Replaces no TPU kernel: the JAX package (and the port's composition)
// gathers the labels by the sort's index and carries each row's counts to
// the end of its tie group with reverse cummin scans (the port: a scatter
// and a gather by group id, twice): about 20 of its 22 device ms at
// 89,137,319 rows on an H100. Here rows inside a tie group only count. A group may run
// across any number of 4096-row tiles, so each tile takes from the tiles
// before it a carry: the running TP, and the position and TP of the last
// group end before it, a (tp, end, end_tp) run whose join is associative
// (the later run's end wins): a reduce-then-scan. Pass 1 makes each tile's
// run from its labels and the few keys at its end (a tie group's end lies
// near the tile's end unless one group covers it); one block scans the
// runs into carries; pass 2 reads the stream once and integrates.
//
// Bound on an H100 SXM: device-memory bytes. The key pass reads 8 bytes a
// row (a float32 score and a 4-byte target) and writes 5; the integration
// reads the labels twice and the keys once, 6 bytes a row. At 89,137,319
// rows: 0.35 ms and 0.16 ms at 3.35 TB/s.

#include <cub/block/block_reduce.cuh>
#include <cub/block/block_scan.cuh>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kNanKey = 0xFFFFFFFFu;
constexpr int kKeyThreads = 256;
constexpr int kKeyBlocksPerSm = 8;
constexpr int kKeyUnroll = 4;
constexpr int kThreads = 256;
constexpr int kItems = 16;
constexpr int kTile = kThreads * kItems;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kCarryThreads = 512;
constexpr int kCarryItems = 8;

// The order key of a score: ascending keys are descending scores, NaN last.
__device__ __forceinline__ uint32_t order_key(float x) {
  uint32_t b = __float_as_uint(x);
  if ((b & 0x7FFFFFFFu) > 0x7F800000u) return kNanKey;
  b ^= 0x80000000u;                   // -x
  if ((b & 0x7FFFFFFFu) == 0) b = 0;  // -0.0 and +0.0 tie
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// A target's int32 cast as its label; false when that cast is not 0 or 1.
__device__ __forceinline__ bool to_label(int32_t t, uint8_t& label) {
  label = static_cast<uint8_t>(t);
  return static_cast<uint32_t>(t) <= 1u;
}

__device__ __forceinline__ bool to_label(uint8_t t, uint8_t& label) {
  label = t;
  return t <= 1u;
}

__device__ __forceinline__ bool to_label(float t, uint8_t& label) {
  label = t >= 1.0f;
  return t > -1.0f && t < 2.0f;  // the cast truncates: 0 on (-1, 1), 1 on [1, 2)
}

template <typename T>
__global__ void __launch_bounds__(kKeyThreads)
roc_key_kernel(const float* __restrict__ scores, const T* __restrict__ targets, int64_t n,
               uint32_t* __restrict__ keys, uint8_t* __restrict__ labels,
               int32_t* __restrict__ flag) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  bool other = false;
  for (; i + (kKeyUnroll - 1) * stride < n; i += kKeyUnroll * stride) {
    float s[kKeyUnroll];
    T t[kKeyUnroll];
#pragma unroll
    for (int j = 0; j < kKeyUnroll; ++j) {
      s[j] = scores[i + j * stride];
      t[j] = targets[i + j * stride];
    }
#pragma unroll
    for (int j = 0; j < kKeyUnroll; ++j) {
      uint8_t label;
      other |= !to_label(t[j], label);
      keys[i + j * stride] = order_key(s[j]);
      labels[i + j * stride] = label;
    }
  }
  for (; i < n; i += stride) {
    uint8_t label;
    other |= !to_label(targets[i], label);
    keys[i] = order_key(scores[i]);
    labels[i] = label;
  }
  if (__syncthreads_or(other) && threadIdx.x == 0) *flag = 1;
}

// A run of rows: its positives, its last tie-group end (an absolute row, or
// -1) and the positives from the run's start through that end. Rows number
// fewer than 2^31.
struct Run {
  int tp;
  int end;
  int end_tp;
};

struct Join {
  __device__ __forceinline__ Run operator()(const Run& a, const Run& b) const {
    const bool ends = b.end >= 0;
    return {a.tp + b.tp, ends ? b.end : a.end, ends ? a.tp + b.end_tp : a.end_tp};
  }
};

__device__ __forceinline__ Run no_rows() { return {0, -1, 0}; }

__device__ __forceinline__ int rows_of(int64_t n, int64_t start) {
  return n - start < kTile ? static_cast<int>(n - start) : kTile;
}

// Bit q of the result: row r0 + q's label (16 rows a thread, or fewer at
// the stream's end).
__device__ __forceinline__ uint32_t label_bits(const uint8_t* __restrict__ labels, int64_t start,
                                               int r0, int count) {
  uint32_t lb = 0;
  if (count == kItems && (reinterpret_cast<uintptr_t>(labels + start) & 15) == 0) {
    const uint4 v = *reinterpret_cast<const uint4*>(labels + start + r0);
    const uint32_t words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int q = 0; q < kItems; ++q) lb |= ((words[q >> 2] >> (8 * (q & 3))) & 0xFFu) ? 1u << q : 0u;
  } else {
    for (int q = 0; q < count; ++q) lb |= labels[start + r0 + q] ? 1u << q : 0u;
  }
  return lb;
}

// Pass 1: each tile's run, from its labels (one 16-byte load a thread) and
// its last tie-group end, searched back from the tile's end in steps of 256
// rows (one step unless a tie group covers them).
__global__ void __launch_bounds__(kThreads)
roc_tile_kernel(const uint32_t* __restrict__ keys, const uint8_t* __restrict__ labels, int64_t n,
                Run* __restrict__ runs) {
  __shared__ int found;
  __shared__ int sums[kThreads / 32][2];
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int64_t start = static_cast<int64_t>(blockIdx.x) * kTile;
  const int rows = rows_of(n, start);
  const int r0 = t * kItems;
  const int count = rows - r0 < 0 ? 0 : (rows - r0 < kItems ? rows - r0 : kItems);
  const uint32_t lb = label_bits(labels, start, r0, count);
  if (t == 0) found = kThreads;
  __syncthreads();
  int last = -1;  // the tile's last group end, tile-relative
  for (int hi = rows; hi > 0; hi -= kThreads) {
    const int r = hi - 1 - t;
    if (r >= 0) {
      const uint32_t k = keys[start + r];
      if (start + r == n - 1 || k == kNanKey || k != keys[start + r + 1]) {
        atomicMin(&found, t);  // the lowest thread holds the latest row
      }
    }
    __syncthreads();
    const int first = found;
    __syncthreads();
    if (first < kThreads) {
      last = hi - 1 - first;
      break;
    }
  }
  // the tile's positives, and those of its rows past `last`
  const int past = last - r0;  // this thread's rows q > past lie past `last`
  const uint32_t tail_mask =
      past >= kItems - 1 ? 0u : (past < 0 ? 0xFFFFu : (0xFFFFu << (past + 1)) & 0xFFFFu);
  int tp = __popc(lb), tail = __popc(lb & tail_mask);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    tp += __shfl_xor_sync(kFull, tp, o);
    tail += __shfl_xor_sync(kFull, tail, o);
  }
  if (lane == 0) {
    sums[warp][0] = tp;
    sums[warp][1] = tail;
  }
  __syncthreads();
  if (t == 0) {
    tp = tail = 0;
    for (int w = 0; w < kThreads / 32; ++w) {
      tp += sums[w][0];
      tail += sums[w][1];
    }
    runs[blockIdx.x] = {tp, last >= 0 ? static_cast<int>(start + last) : -1,
                        last >= 0 ? tp - tail : 0};
  }
}

// The tiles' carries, one block: each tile's carry is the run of every row
// before it, an exclusive scan of the tiles' runs, kCarryItems tiles a
// thread a round. Writes the positives.
__global__ void __launch_bounds__(kCarryThreads)
roc_carry_kernel(const Run* __restrict__ runs, int64_t tiles, Run* __restrict__ carries,
                 long long* __restrict__ totals) {
  typedef cub::BlockScan<Run, kCarryThreads> Scan;
  __shared__ typename Scan::TempStorage temp;
  const Join join;
  Run running = no_rows();
  for (int64_t base = 0; base < tiles; base += kCarryThreads * kCarryItems) {
    const int64_t first = base + static_cast<int64_t>(threadIdx.x) * kCarryItems;
    Run in[kCarryItems], out[kCarryItems], round;
#pragma unroll
    for (int i = 0; i < kCarryItems; ++i) in[i] = first + i < tiles ? runs[first + i] : no_rows();
    Scan(temp).ExclusiveScan(in, out, no_rows(), join, round);
#pragma unroll
    for (int i = 0; i < kCarryItems; ++i) {
      if (first + i < tiles) carries[first + i] = join(running, out[i]);
    }
    running = join(running, round);
    __syncthreads();  // the next round reuses the scan's storage
  }
  if (threadIdx.x == 0) totals[1] = running.tp;
}

typedef cub::BlockScan<Run, kThreads> TileScan;

// A tile's keys staged for the transpose from coalesced loads to 16
// consecutive rows a thread: one pad word every 32 keeps both sides free of
// bank conflicts.
union TileStorage {
  uint32_t keys[kTile + kTile / 32];
  typename TileScan::TempStorage scan;
};

__device__ __forceinline__ int padded(int r) { return r + (r >> 5); }

// Pass 2: each group end's trapezoid, doubled, summed into totals[0]. Each
// thread takes 16 consecutive rows; a block scan of their runs, seeded with
// the tile's carry, gives each thread the running TP and the previous
// group end.
__global__ void __launch_bounds__(kThreads)
roc_integrate_kernel(const uint32_t* __restrict__ keys, const uint8_t* __restrict__ labels,
                     int64_t n, const Run* __restrict__ carries,
                     unsigned long long* __restrict__ area) {
  typedef cub::BlockReduce<unsigned long long, kThreads> Sum;
  __shared__ TileStorage smem;
  __shared__ typename Sum::TempStorage sum_temp;
  __shared__ uint32_t next_key;
  const int t = threadIdx.x;
  const int64_t start = static_cast<int64_t>(blockIdx.x) * kTile;
  const int rows = rows_of(n, start);
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int r = j * kThreads + t;
    if (r < rows) smem.keys[padded(r)] = keys[start + r];
  }
  if (t == 0) next_key = rows == kTile && start + kTile < n ? keys[start + kTile] : kNanKey;
  const int r0 = t * kItems;
  const int count = rows - r0 < 0 ? 0 : (rows - r0 < kItems ? rows - r0 : kItems);
  const uint32_t lb = label_bits(labels, start, r0, count);
  __syncthreads();
  uint32_t eb = 0;  // bit q: row r0 + q ends a tie group
#pragma unroll
  for (int q = 0; q < kItems; ++q) {
    if (q < count) {
      const int r = r0 + q;
      const uint32_t k = smem.keys[padded(r)];
      const uint32_t next = r + 1 < rows ? smem.keys[padded(r + 1)] : next_key;
      if (start + r == n - 1 || k != next || k == kNanKey) eb |= 1u << q;
    }
  }
  const int row0 = static_cast<int>(start) + r0;
  Run mine = no_rows();
  for (int q = 0; q < count; ++q) {
    mine.tp += (lb >> q) & 1u;
    if ((eb >> q) & 1u) {
      mine.end = row0 + q;
      mine.end_tp = mine.tp;
    }
  }
  __syncthreads();  // the stage becomes the scan's storage
  Run before;
  TileScan(smem.scan).ExclusiveScan(mine, before, carries[blockIdx.x], Join());
  int tp = before.tp;
  int prev = before.end;       // the previous group end, or -1
  int prev_tp = before.end_tp;  // TP there, or 0
  unsigned long long sum = 0;
  for (int q = 0; q < count; ++q) {
    tp += (lb >> q) & 1u;
    if ((eb >> q) & 1u) {
      const int row = row0 + q;
      // FP_e - FP_p < 2^31 and TP_e + TP_p < 2^32: one widening multiply
      const uint32_t dfp = static_cast<uint32_t>((row - tp) - (prev - prev_tp));
      const uint32_t tps = static_cast<uint32_t>(tp) + static_cast<uint32_t>(prev_tp);
      sum += static_cast<unsigned long long>(dfp) * tps;
      prev = row;
      prev_tp = tp;
    }
  }
  const unsigned long long block = Sum(sum_temp).Sum(sum);
  if (t == 0 && block) atomicAdd(area, block);
}

__global__ void roc_value_kernel(const long long* __restrict__ totals, int64_t n,
                                 float* __restrict__ out) {
  const long long p = totals[1];
  const long long q = n - p;
  out[0] = p == 0 || q == 0
               ? 0.5f
               : static_cast<float>(static_cast<double>(static_cast<unsigned long long>(totals[0])) /
                                    (2.0 * static_cast<double>(p) * static_cast<double>(q)));
}

template <typename T>
cudaError_t launch_keys(const float* scores, const void* targets, int64_t n, uint32_t* keys,
                        uint8_t* labels, int32_t* flag, cudaStream_t s) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int64_t want = (n + kKeyThreads - 1) / kKeyThreads;
  const int64_t most = static_cast<int64_t>(sms) * kKeyBlocksPerSm;
  const unsigned blocks = static_cast<unsigned>(want < most ? want : most);
  roc_key_kernel<T><<<blocks, kKeyThreads, 0, s>>>(scores, static_cast<const T*>(targets), n,
                                                   keys, labels, flag);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// One raw-cache tensor's n rows: the order keys and labels at keys/labels
// (the tensor's offset in the stream already added). target_code: 0 int32,
// 1 one byte (bool, uint8), 2 float32. *flag becomes 1 when a target's
// int32 cast is not 0 or 1; it is never cleared here.
int tc_roc_keys(int target_code, const float* scores, const void* targets, int64_t n,
                uint32_t* keys, uint8_t* labels, int32_t* flag, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (target_code) {
    case 0: return static_cast<int>(launch_keys<int32_t>(scores, targets, n, keys, labels, flag, s));
    case 1: return static_cast<int>(launch_keys<uint8_t>(scores, targets, n, keys, labels, flag, s));
    case 2: return static_cast<int>(launch_keys<float>(scores, targets, n, keys, labels, flag, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Bytes of scratch the integration of n rows needs: two runs a tile.
int64_t tc_roc_integrate_scratch(int64_t n) {
  return 2 * ((n + kTile - 1) / kTile) * static_cast<int64_t>(sizeof(Run));
}

// The AUROC of n sorted (key, label) rows, labels 0 or 1, into *out;
// totals (two words) gets the doubled area and the positives.
int tc_roc_integrate(const uint32_t* keys, const uint8_t* labels, int64_t n, void* scratch,
                     long long* totals, float* out, void* stream) {
  if (n <= 0 || n > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t tiles = (n + kTile - 1) / kTile;
  Run* runs = static_cast<Run*>(scratch);
  Run* carries = runs + tiles;
  const unsigned grid = static_cast<unsigned>(tiles);
  cudaError_t err = cudaMemsetAsync(totals, 0, sizeof(long long), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  roc_tile_kernel<<<grid, kThreads, 0, s>>>(keys, labels, n, runs);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  roc_carry_kernel<<<1, kCarryThreads, 0, s>>>(runs, tiles, carries, totals);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  roc_integrate_kernel<<<grid, kThreads, 0, s>>>(keys, labels, n, carries,
                                                 reinterpret_cast<unsigned long long*>(totals));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  roc_value_kernel<<<1, 1, 0, s>>>(totals, n, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
