// Per-row top-k of float32 scores, in the order of jax.lax.top_k: values
// descending over float32's total order (+NaN > +inf > ... > +0.0 > -0.0 >
// ... > -inf > -NaN), ties broken by the lowest index, values returned bit
// for bit from the input. x is (n, l) row-major; values (n, k) float32 and
// indices (n, k) int64 are written row-major; 1 <= k <= min(l, 128) and
// l < 2^31 - 1.
//
// Replaces the TPU kernel torcheval_tpu/ops/topk.py::_topk_kernel (driven by
// pallas_topk), which walks a row's label tiles in order with a 128-lane
// carry of running maxima in VMEM and k unrolled max passes. Blocks here run
// in parallel and in no order, so nothing of that carries over. Each element
// becomes a unique 64-bit key:
//   high half: the float's bits, mapped so that unsigned order is the total
//              order (flip every bit of a negative float, the sign bit of a
//              positive one);
//   low half:  0xFFFFFFFF - index, so that the lower index wins a tie.
// The k largest keys are the answer, and the largest is lax.top_k's first.
//
// Design: radix select on the key, most significant digit first, in digits
// of 11, 11, 10 (the value) and 11, 11, 10 bits (the inverted index). A
// digit step histograms the digit over the keys that match the prefix chosen
// so far (2048 bins in shared memory), picks the bin where the count from the
// top reaches k, and adds the keys of the bins above it to `above`. Once the
// keys at or above the prefix are few enough, they are listed and the steps
// go on over the list; a step whose bin holds exactly the keys still needed
// ends the selection, and the k keys at or above the prefix are ranked by
// counting. Because the low half is the inverted index, ties at the kth
// value resolve by the lowest index without a special case. Where every
// index is below 2^21, the first index digit is 0x7FF for every key and is
// taken without a read.
//   * Rows of at most kRowMax keys (the top-k leg: (8192, 10000)) run in one
//     block, one launch, one read of the scores: cp.async copies the row to
//     dynamic shared memory. The least of the maxima of k interleaved groups
//     of 16 keys is at most the kth key, so only keys at or above it are
//     listed; at most kThreads of them are ranked at once (uniform scores,
//     k = 5: tens of keys). Heavy ties at that bound list more than kRowCand
//     keys; then the digit steps run over the row.
//   * Longer rows (the retrieval leg: (64, 10^6)) run in one cooperative
//     launch whose steps are apart by grid-wide barriers; every block is
//     resident, and the blocks walk (row, chunk) items, a chunk being at
//     least kMinChunk keys read with 16-byte loads. A sample of kSample keys
//     (one block a row) gives a value threshold that about kCapacity / 4
//     keys of the row should meet; the next step gathers those keys into a
//     per-row candidate buffer, and the row's last block (an atomic ticket)
//     keeps them when they number k to kCapacity: they then hold the top k.
//     Only where the sample misses for some row (heavy ties) do exact digit
//     passes run: each block histograms one digit of its chunk and adds its
//     bins to the row's histogram in device memory, the last block picks the
//     bin; once the keys at or above the prefix fit kCapacity, a gather lists
//     them. A block per row then selects the k largest of the list in shared
//     memory.
// Reads of the row: the one-block path reads it once. A long row is read
// once when the sample's threshold holds (uniform scores; the ideal ranking,
// where ties at 0.0 move the threshold above it), plus the sample's 1/122
// at 10^6 columns. Otherwise it is read once by the threshold's gather, once
// per digit pass and once by the gather: all keys equal in value take the
// three value digits and two index digits, seven reads (eight past 2^21
// columns). One launch whatever the data; the host never waits.
//
// Bound on an H100 SXM: device-memory bytes, N*L*4 read plus N*k*12 written:
// 0.0980 ms at (8192, 10000), k = 5 and 0.0764 ms at (64, 10^6), k = 100
// at 3.35 TB/s. Both paths read each score once in the common case, so the
// time over the bound is the blocks' work between reads. Registers (ptxas
// -v, sm_90a, CUDA 12.8): row_kernel 40, no spills; long_kernel 64, held
// there for 4 blocks an SM (16 bytes of spill stores, 44 of loads), which
// ran faster than 80 registers at 3 blocks an SM.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

typedef unsigned long long Key;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBins = 2048;
constexpr int kBinsPerThread = kBins / kThreads;
constexpr int kMaxK = 128;
constexpr int64_t kRowMax = 16384;    // one-block path: the row's keys in shared memory
constexpr int kCapacity = 4096;       // candidate keys per long row
constexpr int kSample = 8192;         // sampled keys per long row: 8 in a row, evenly spaced
constexpr int kRowCand = 2048;        // candidate positions per one-block row
constexpr int64_t kMinChunk = 4096;   // least keys per block on a long row
constexpr int kLongBlocksPerSm = 4;   // the long-row kernel: 64 registers, 4 blocks an SM
constexpr int64_t kNarrowIndex = int64_t{1} << 21;
constexpr unsigned kFull = 0xffffffffu;

// Per long row, in device memory; set by the sample step.
struct RowState {
  Key prefix;    // the resolved top bits of the kth key, right-aligned
  int resolved;  // number of resolved bits, 0..64
  int above;     // keys whose resolved bits exceed the prefix
  int done;      // the keys at or above the prefix fit kCapacity
  int ticket;    // blocks of the row that finished the current pass
  int count;     // candidates written by the gather
  uint32_t bar;    // the sample's threshold, as order bits
  int spec;        // the sample found a threshold: gather the keys at or above `bar`
  int spec_count;  // keys at or above `bar`
  int spec_ok;     // k <= spec_count <= kCapacity: those keys are the candidates
};
constexpr int64_t kStateWords = sizeof(RowState) / 8;
constexpr int64_t kHistWords = kBins * sizeof(int) / 8;

struct Pick {
  int bin;
  int above;  // keys in the bins above `bin`
  int count;  // keys in `bin`
};

struct SelectShared {
  int hist[kBins];
  unsigned hits[kRowMax / 32];  // block_compact's ballots
  int warp_sum[kWarps];
  Pick pick;
  Key top[kMaxK];
};

__device__ __forceinline__ uint32_t order_bits(float v) {
  const uint32_t b = __float_as_uint(v);
  return b ^ ((b >> 31) ? 0xFFFFFFFFu : 0x80000000u);
}

__device__ __forceinline__ Key make_key(uint32_t u, int64_t i) {
  return (static_cast<Key>(u) << 32) |
         static_cast<Key>(0xFFFFFFFFu - static_cast<uint32_t>(i));
}

__host__ __device__ __forceinline__ int digit_width(int resolved) {
  return (resolved == 22 || resolved == 54) ? 10 : 11;
}

// The digit below `resolved` bits of a key that matches the prefix, else -1.
__device__ __forceinline__ int digit_of(Key key, int resolved, Key prefix) {
  const int w = digit_width(resolved);
  if (resolved > 0 && (key >> (64 - resolved)) != prefix) return -1;
  return static_cast<int>((key >> (64 - resolved - w)) & ((1u << w) - 1));
}

// Called by every lane of a warp together; bin < 0 adds nothing. A warp whose
// lanes all hit one bin (ties, zeros) adds once.
__device__ __forceinline__ void hist_add(int* hist, int bin) {
  const int b0 = __shfl_sync(kFull, bin, 0);
  if (__all_sync(kFull, bin == b0)) {
    if ((threadIdx.x & 31) == 0 && b0 >= 0) atomicAdd(&hist[b0], 32);
  } else if (bin >= 0) {
    atomicAdd(&hist[bin], 1);
  }
}

// Calls f(value, i, valid) for every i in [i0, i1) of one row, with 16-byte
// loads between the 16-byte boundaries, kUnroll of them in flight per
// thread. Every lane of a warp calls f together, so f may use warp-wide
// intrinsics.
template <class F>
__device__ __forceinline__ void for_range(const float* __restrict__ row, int i0, int i1,
                                          F f) {
  constexpr int kUnroll = 4;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int mis = static_cast<int>((reinterpret_cast<uintptr_t>(row + i0) >> 2) & 3);
  int v0 = mis ? i0 + (4 - mis) : i0;
  if (v0 > i1) v0 = i1;
  if (v0 > i0 && warp == 0) {
    const int i = i0 + lane;
    const bool ok = i < v0;
    f(ok ? row[i] : 0.f, i, ok);
  }
  const int nv = (i1 - v0) >> 2;
  const float4* xv = reinterpret_cast<const float4*>(row + v0);
  for (int base = warp * 32; base < nv; base += kUnroll * kThreads) {
    float4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int a = base + lane + u * kThreads;
      v[u] = a < nv ? __ldg(xv + a) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int a = base + lane + u * kThreads;
      const int i = v0 + 4 * a;
      f(v[u].x, i, a < nv);
      f(v[u].y, i + 1, a < nv);
      f(v[u].z, i + 2, a < nv);
      f(v[u].w, i + 3, a < nv);
    }
  }
  const int t0 = v0 + 4 * nv;
  if (t0 < i1 && warp == kWarps - 1) {
    const int i = t0 + lane;
    const bool ok = i < i1;
    f(ok ? row[i] : 0.f, i, ok);
  }
}

// A prefix of `resolved` bits split into the key's two 32-bit halves, so
// that the passes over a row test and cut keys in 32-bit arithmetic.
struct Split {
  uint32_t value;  // the value half's resolved bits (all 32 once resolved >= 32)
  uint32_t index;  // the index half's resolved bits (resolved > 32)
  int resolved;
};

__device__ __forceinline__ Split split(Key prefix, int resolved) {
  if (resolved <= 32) return Split{static_cast<uint32_t>(prefix), 0u, resolved};
  return Split{static_cast<uint32_t>(prefix >> (resolved - 32)),
               static_cast<uint32_t>(prefix & ((Key{1} << (resolved - 32)) - 1)), resolved};
}

// The next digit of the key (u, inv = 0xFFFFFFFF - index) if it matches the
// prefix, else -1; INDEX: the digit lies in the index half (resolved >= 32).
// shift and mask place the digit within its half.
template <bool INDEX>
__device__ __forceinline__ int digit32(uint32_t u, uint32_t inv, const Split& s, int shift,
                                       uint32_t mask) {
  if (!INDEX) {
    if (s.resolved > 0 && (u >> (32 - s.resolved)) != s.value) return -1;
    return static_cast<int>((u >> shift) & mask);
  }
  if (u != s.value) return -1;
  if (s.resolved > 32 && (inv >> (64 - s.resolved)) != s.index) return -1;
  return static_cast<int>((inv >> shift) & mask);
}

// Whether the key (u, inv) is at or above the prefix (1 <= resolved <= 64);
// INDEX: resolved > 32.
template <bool INDEX>
__device__ __forceinline__ bool at_or_above(uint32_t u, uint32_t inv, const Split& s) {
  if (!INDEX) return (u >> (32 - s.resolved)) >= s.value;
  return u > s.value || (u == s.value && (inv >> (64 - s.resolved)) >= s.index);
}

// Every lane of a warp calls it together: the lanes with `hit` take
// consecutive slots from *counter (shared or device memory), one atomic per
// warp. Returns this lane's slot (meaningless where !hit).
__device__ __forceinline__ int warp_append(int* counter, bool hit) {
  const unsigned ballot = __ballot_sync(kFull, hit);
  const int lane = threadIdx.x & 31;
  int at = 0;
  if (ballot != 0 && lane == 0) at = atomicAdd(counter, __popc(ballot));
  at = __shfl_sync(kFull, at, 0);
  return at + __popc(ballot & ((1u << lane) - 1u));
}

template <class Put>
__device__ int block_compact_place(int m, Put put, int cap, SelectShared& sh);

// Calls put(i, slot) for every i in [0, m) with hit(i), m <= kRowMax, slots
// 0, 1, ... in the order of i, unless they number more than cap; returns
// their number. One pass stores a ballot per 32 elements, a scan over those
// words places them: no atomics, and hit() runs once per element. Every
// thread of the block calls it.
template <class Hit, class Put>
__device__ int block_compact(int m, Hit hit, Put put, int cap, SelectShared& sh) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll 4
  for (int base = warp * 32; base < m; base += kThreads) {
    const int i = base + lane;
    const unsigned ballot = __ballot_sync(kFull, i < m && hit(i));
    if (lane == 0) sh.hits[base >> 5] = ballot;
  }
  return block_compact_place(m, put, cap, sh);
}

// block_compact's second half: the hits are in sh.hits, one word per 32
// elements; place them.
template <class Put>
__device__ int block_compact_place(int m, Put put, int cap, SelectShared& sh) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  __syncthreads();
  // thread t owns words 2t and 2t + 1
  const int words = (m + 31) >> 5;
  const int w0 = 2 * threadIdx.x;
  const unsigned a = w0 < words ? sh.hits[w0] : 0u;
  const unsigned b = w0 + 1 < words ? sh.hits[w0 + 1] : 0u;
  const int c = __popc(a) + __popc(b);
  int incl = c;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) sh.warp_sum[warp] = incl;
  __syncthreads();
  int total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int v = sh.warp_sum[w];
    incl += w < warp ? v : 0;
    total += v;
  }
  if (total <= cap) {
    int at = incl - c;
    for (unsigned bits = a; bits; bits &= bits - 1) put(32 * w0 + __ffs(bits) - 1, at++);
    for (unsigned bits = b; bits; bits &= bits - 1) put(32 * (w0 + 1) + __ffs(bits) - 1, at++);
  }
  __syncthreads();
  return total;
}

// The bin where the count from the top reaches `need` (the largest b with
// sum(hist[b:]) >= need, given sum(hist) >= need >= 1), into *out. Every
// thread of the block calls it; *out is readable when it returns.
__device__ void pick_bin(const int* hist, int need, int* warp_sum, Pick* out) {
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int hi = kBins - kBinsPerThread * t;  // this thread's bins [hi - 8, hi)
  int c = 0;
#pragma unroll
  for (int j = 0; j < kBinsPerThread; ++j) c += hist[hi - 1 - j];
  int incl = c;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  for (int w = 0; w < warp; ++w) incl += warp_sum[w];
  const int excl = incl - c;
  if (excl < need && incl >= need) {
    int acc = excl;
    for (int j = 0; j < kBinsPerThread; ++j) {
      const int b = hi - 1 - j;
      const int h = hist[b];
      if (acc + h >= need) {
        *out = Pick{b, acc, h};
        break;
      }
      acc += h;
    }
  }
  __syncthreads();
}

__device__ void zero_hist(int* hist) {
  for (int b = threadIdx.x; b < kBins; b += kThreads) hist[b] = 0;
  __syncthreads();
}

// Where a selection stands: the kth key's top `resolved` bits are `prefix`;
// `above` keys exceed them and `count` share them.
struct Cut {
  Key prefix;
  int resolved;
  int above;
  int count;
};

// Digit steps over m keys get(0 .. m-1), from `cut`, until the keys at or
// above the prefix number at most `cap` (cap = k: exactly the top k). With
// hist_ready, sh.hist holds the next digit's histogram on entry. narrow:
// every index is below 2^21, so the first index digit is 0x7FF for all.
template <class Get>
__device__ Cut narrow_down(Get get, int m, int k, int cap, bool narrow, Cut cut,
                           bool hist_ready, SelectShared& sh) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (;;) {
    if (!hist_ready) {
      zero_hist(sh.hist);
#pragma unroll 4
      for (int base = warp * 32; base < m; base += kThreads) {
        const int i = base + lane;
        hist_add(sh.hist, i < m ? digit_of(get(i), cut.resolved, cut.prefix) : -1);
      }
      __syncthreads();
    }
    hist_ready = false;
    pick_bin(sh.hist, k - cut.above, sh.warp_sum, &sh.pick);
    const Pick p = sh.pick;
    const int w = digit_width(cut.resolved);
    cut.prefix = (cut.prefix << w) | static_cast<Key>(p.bin);
    cut.resolved += w;
    cut.above += p.above;
    cut.count = p.count;
    if (cut.above + cut.count <= cap) return cut;
    if (cut.resolved == 32 && narrow) {
      cut.prefix = (cut.prefix << 11) | 0x7FFu;
      cut.resolved = 43;
    }
  }
}

// The k largest of m <= kThreads keys get(0 .. m-1), ranked by counting,
// decoded into one row's outputs. The keys pass through sh.hist.
template <class Get>
__device__ void rank_top(Get get, int m, int k, SelectShared& sh, float* __restrict__ values,
                         int64_t* __restrict__ indices) {
  Key* keys = reinterpret_cast<Key*>(sh.hist);
  const int t = threadIdx.x;
  const Key mine = t < m ? get(t) : 0;
  if (t < m) keys[t] = mine;
  __syncthreads();
  if (t < m) {
    int rank = 0;
    for (int j = 0; j < m; ++j) rank += keys[j] > mine;
    if (rank < k) {
      const uint32_t u = static_cast<uint32_t>(mine >> 32);
      values[rank] = __uint_as_float(u ^ ((u >> 31) ? 0x80000000u : 0xFFFFFFFFu));
      indices[rank] = static_cast<int64_t>(0xFFFFFFFFu - static_cast<uint32_t>(mine));
    }
  }
}

// The k keys of get(0 .. m-1) at or above the cut's prefix (cut.above +
// cut.count == k), in descending order, decoded into one row's outputs.
template <class Get>
__device__ void emit_top(Get get, int m, int k, const Cut& cut, SelectShared& sh,
                         float* __restrict__ values, int64_t* __restrict__ indices) {
  const int shift = 64 - cut.resolved;
  block_compact(
      m, [&](int i) { return cut.resolved == 0 || (get(i) >> shift) >= cut.prefix; },
      [&](int i, int slot) { sh.top[slot] = get(i); }, kMaxK, sh);
  rank_top([&](int i) { return sh.top[i]; }, k, k, sh, values, indices);
}

// Bits l of x (8 bits) to bits 4l.
__device__ __forceinline__ unsigned spread4(unsigned x) {
  x = (x | (x << 12)) & 0x000F000Fu;
  x = (x | (x << 6)) & 0x03030303u;
  return (x | (x << 3)) & 0x11111111u;
}

// The positions of the row's keys with order bits at or above bar into
// cand (as block_compact, 4 keys per lane and step), unless more than cap.
__device__ int row_compact(const uint32_t* row_bits, int m, uint32_t bar, uint16_t* cand,
                           int cap, SelectShared& sh) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const uint4* quads = reinterpret_cast<const uint4*>(row_bits);
#pragma unroll 2
  for (int b = warp * 32; b < (m + 3) / 4; b += kThreads) {
    const int j = b + lane;
    uint4 q = make_uint4(0u, 0u, 0u, 0u);
    if (j < (m + 3) / 4) q = quads[j];
    const int i = 4 * j;
    // lane L's ballot bit stands for key 4L + c of the warp's 128 keys
    const unsigned b0 = __ballot_sync(kFull, i < m && q.x >= bar);
    const unsigned b1 = __ballot_sync(kFull, i + 1 < m && q.y >= bar);
    const unsigned b2 = __ballot_sync(kFull, i + 2 < m && q.z >= bar);
    const unsigned b3 = __ballot_sync(kFull, i + 3 < m && q.w >= bar);
    if (lane < 4 && 4 * b + 32 * lane < m) {
      const int sh8 = 8 * lane;
      sh.hits[(4 * b >> 5) + lane] = spread4((b0 >> sh8) & 0xFFu) | spread4((b1 >> sh8) & 0xFFu) << 1 |
                                     spread4((b2 >> sh8) & 0xFFu) << 2 | spread4((b3 >> sh8) & 0xFFu) << 3;
    }
  }
  return block_compact_place(m, [&](int i, int slot) { cand[slot] = static_cast<uint16_t>(i); },
                             cap, sh);
}

// One block per row of at most kRowMax keys, held in dynamic shared memory.
// The least of k interleaved group maxima bounds the kth key from below, so
// only keys at or above it can be in the top k. Where at most kThreads keys
// are, they are ranked at once; up to kRowCand, the digits walk their
// positions; else (heavy ties at the bound) the digits walk the whole row
// until the keys at or above the prefix fit the list.
__global__ void __launch_bounds__(kThreads)
row_kernel(const float* __restrict__ x, int64_t l, int k, float* __restrict__ values,
           int64_t* __restrict__ indices) {
  extern __shared__ __align__(16) uint32_t row_bits[];
  __shared__ SelectShared sh;
  __shared__ __align__(16) uint16_t cand[kRowCand];
  const int64_t row = blockIdx.x;
  const int m = static_cast<int>(l);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float* xr = x + row * l;
  float* v_out = values + row * k;
  int64_t* i_out = indices + row * k;
  if ((reinterpret_cast<uintptr_t>(xr) & 15) == 0) {
    // every 16-byte piece of the row in flight at once, straight to shared memory
    const unsigned base = static_cast<unsigned>(__cvta_generic_to_shared(row_bits));
    for (int j = threadIdx.x; j < m / 4; j += kThreads) {
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(base + 16 * j),
                   "l"(xr + 4 * j));
    }
    asm volatile("cp.async.commit_group;\n" ::);
    const int i = (m & ~3) + static_cast<int>(threadIdx.x);
    if (i < m) row_bits[i] = __float_as_uint(xr[i]);
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  } else {
    for_range(xr, 0, m, [&](float v, int i, bool ok) {
      if (ok) row_bits[i] = __float_as_uint(v);
    });
  }
  for (int g = threadIdx.x; g < k; g += kThreads) reinterpret_cast<uint32_t*>(sh.top)[g] = 0u;
  __syncthreads();
  // the order bits in place, 4 keys a step; 4 lanes hold 16 consecutive
  // keys, whose maximum goes to the maximum of its interleaved group g % k
  uint32_t* group_max = reinterpret_cast<uint32_t*>(sh.top);
  const int groups = (m + 15) >> 4;
  uint4* quads = reinterpret_cast<uint4*>(row_bits);
  // this lane's group is (b + lane) / 4, which steps by kThreads / 4 a step:
  // its residue mod k steps alike, without a division in the loop
  const int step = (kThreads / 4) % k;
  int residue = ((warp * 32 + lane) >> 2) % k;
#pragma unroll 2
  for (int b = warp * 32; b < (m + 3) / 4; b += kThreads) {
    const int j = b + lane;
    uint32_t top = 0;
    if (j < m / 4) {
      uint4 q = quads[j];
      q = make_uint4(order_bits(__uint_as_float(q.x)), order_bits(__uint_as_float(q.y)),
                     order_bits(__uint_as_float(q.z)), order_bits(__uint_as_float(q.w)));
      quads[j] = q;
      top = max(max(q.x, q.y), max(q.z, q.w));
    } else if (4 * j < m) {  // the last, partial quad
      for (int i = 4 * j; i < m; ++i) {
        const uint32_t u = order_bits(__uint_as_float(row_bits[i]));
        row_bits[i] = u;
        top = max(top, u);
      }
    }
    top = max(top, __shfl_xor_sync(kFull, top, 1));
    top = max(top, __shfl_xor_sync(kFull, top, 2));
    if ((lane & 3) == 0 && (j >> 2) < groups) atomicMax(&group_max[residue], top);
    residue += step;
    residue -= residue >= k ? k : 0;
  }
  __syncthreads();
  // Each interleaved group's maximum is a key of the row, so the least of
  // the k maxima is at most the kth largest key: no key below it is in the
  // top k. (With fewer than k groups of 16, every key stays.)
  __shared__ uint32_t bar_shared;
  if (warp == 0) {
    uint32_t least = 0xFFFFFFFFu;
    for (int g = lane; g < k; g += 32) least = min(least, group_max[g]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) least = min(least, __shfl_xor_sync(kFull, least, o));
    if (lane == 0) bar_shared = groups >= k ? least : 0u;
  }
  __syncthreads();
  const uint32_t bar = bar_shared;
  auto from_row = [&](int i) { return make_key(row_bits[i], i); };
  auto from_cand = [&](int i) { return from_row(cand[i]); };
  auto put_cand = [&](int i, int slot) { cand[slot] = static_cast<uint16_t>(i); };
  int mc = row_compact(row_bits, m, bar, cand, kRowCand, sh);
  if (mc <= kThreads) {
    rank_top(from_cand, mc, k, sh, v_out, i_out);
    return;
  }
  Cut cut{0, 0, 0, 0};
  if (mc > kRowCand) {
    cut = narrow_down(from_row, m, k, kRowCand, true, cut, false, sh);
    if (cut.above + cut.count == k) {
      emit_top(from_row, m, k, cut, sh, v_out, i_out);
      return;
    }
    const Split sp = split(cut.prefix, cut.resolved);
    mc = block_compact(
        m,
        [&](int i) {
          return cut.resolved <= 32 ? at_or_above<false>(row_bits[i], 0u, sp)
                                    : at_or_above<true>(row_bits[i], 0xFFFFFFFFu - i, sp);
        },
        put_cand, kRowCand, sh);
  }
  cut = narrow_down(from_cand, mc, k, k, true, cut, false, sh);
  emit_top(from_cand, mc, k, cut, sh, v_out, i_out);
}

// What one launch over long rows is given.
struct LongRows {
  const float* x;
  int64_t l;
  int64_t chunk;  // keys per block and row
  int parts;      // blocks per row
  int n;
  int k;
  RowState* states;
  int* row_hist;  // kBins per row
  Key* cand;      // kCapacity per row
  int* pending;   // a row the sample's threshold missed
  float* values;
  int64_t* indices;
};

// From kSample keys spread evenly over the row, a threshold `bar` on the
// value such that about kCapacity / 4 keys of the row should be at or above
// it. Heavy ties at the sample's threshold move it up by one value; where
// neither fits, the row goes to the digit passes. Also zeroes the row's
// state and histogram.
__device__ void sample_row(const LongRows& a, int64_t row, SelectShared& sh,
                           uint32_t* sample) {
  __shared__ int counts[2];
  const float* xr = a.x + row * a.l;
  for (int b = threadIdx.x; b < kBins; b += kThreads) a.row_hist[row * kBins + b] = 0;
  const int64_t stride = a.l / (kSample / 8);  // >= 16 past kRowMax keys
  for (int j = threadIdx.x; j < kSample / 8; j += kThreads) {
    const float* p = xr + j * stride;
#pragma unroll
    for (int q = 0; q < 8; ++q) sample[8 * j + q] = order_bits(__ldg(p + q));
  }
  if (threadIdx.x == 0) counts[0] = counts[1] = 0;
  __syncthreads();
  // r sampled keys stand for about kCapacity / 4 keys of the row; stop once
  // at most 2r sampled keys are at or above the prefix
  int r = static_cast<int>(int64_t{kCapacity} * kSample / (4 * a.l));
  r = r < 1 ? 1 : r;
  const Cut cut = narrow_down([&](int i) { return make_key(sample[i], i); }, kSample, r,
                              2 * r, true, Cut{0, 0, 0, 0}, false, sh);
  const uint32_t t = cut.resolved >= 32
                         ? static_cast<uint32_t>(cut.prefix >> (cut.resolved - 32))
                         : static_cast<uint32_t>(cut.prefix << (32 - cut.resolved));
  int ge = 0;
  int gt = 0;
  for (int i = threadIdx.x; i < kSample; i += kThreads) {
    ge += sample[i] >= t;
    gt += sample[i] > t;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    ge += __shfl_xor_sync(kFull, ge, o);
    gt += __shfl_xor_sync(kFull, gt, o);
  }
  if ((threadIdx.x & 31) == 0) {
    atomicAdd(&counts[0], ge);
    atomicAdd(&counts[1], gt);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const double scale = static_cast<double>(a.l) / kSample;
    RowState st{};
    if (counts[0] * scale <= kCapacity / 2) {
      st.bar = t;
      st.spec = 1;
    } else if (t != 0xFFFFFFFFu && counts[1] * scale >= 2.0 * a.k) {
      st.bar = t + 1;
      st.spec = 1;
    }
    a.states[row] = st;
  }
  __syncthreads();  // counts and the sample are reused
}

// One block's chunk of one row: the keys whose value is at or above the
// sample's threshold, into the row's candidate buffer. The row's last block
// keeps them when they number k to kCapacity (they then hold the top k, and
// the row is done); else it marks the row for the digit passes.
__device__ void spec_part(const LongRows& a, int64_t row, int64_t part) {
  RowState* st = a.states + row;
  if (!st->spec) {
    if (part == 0 && threadIdx.x == 0) atomicExch(a.pending, 1);
    return;
  }
  const uint32_t bar = st->bar;
  const float* xr = a.x + row * a.l;
  const int start = static_cast<int>(part * a.chunk);
  const int end = static_cast<int>(start + a.chunk < a.l ? start + a.chunk : a.l);
  Key* out = a.cand + row * kCapacity;
  for_range(xr, start, end, [&](float v, int i, bool ok) {
    const uint32_t u = order_bits(v);
    const bool hit = ok && u >= bar;
    const int at = warp_append(&st->spec_count, hit);
    if (hit && at < kCapacity) out[at] = make_key(u, i);
  });
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0 && atomicAdd(&st->ticket, 1) == a.parts - 1) {
    __threadfence();
    const int c = atomicAdd(&st->spec_count, 0);
    st->ticket = 0;
    if (c >= a.k && c <= kCapacity) {
      st->spec_ok = 1;
      st->done = 1;
    } else {
      atomicExch(a.pending, 1);
    }
  }
  __syncthreads();
}

// One digit of one block's chunk of a row that is not done; the row's last
// block picks the bin and updates the row's state.
__device__ void pass_part(const LongRows& a, int64_t row, int64_t part, SelectShared& sh) {
  __shared__ int last;
  RowState* st = a.states + row;
  if (st->done) return;
  const int resolved = st->resolved;
  const Key prefix = st->prefix;
  const float* xr = a.x + row * a.l;
  const int start = static_cast<int>(part * a.chunk);
  const int end = static_cast<int>(start + a.chunk < a.l ? start + a.chunk : a.l);
  const Split sp = split(prefix, resolved);
  const int w = digit_width(resolved);
  const uint32_t mask = (1u << w) - 1u;
  zero_hist(sh.hist);
  if (resolved < 32) {
    const int shift = 32 - resolved - w;
    for_range(xr, start, end, [&](float v, int i, bool ok) {
      hist_add(sh.hist, ok ? digit32<false>(order_bits(v), 0u, sp, shift, mask) : -1);
    });
  } else {
    const int shift = 64 - resolved - w;
    for_range(xr, start, end, [&](float v, int i, bool ok) {
      hist_add(sh.hist,
               ok ? digit32<true>(order_bits(v), 0xFFFFFFFFu - i, sp, shift, mask) : -1);
    });
  }
  __syncthreads();
  int* gh = a.row_hist + row * kBins;
  for (int b = threadIdx.x; b < kBins; b += kThreads) {
    if (sh.hist[b]) atomicAdd(&gh[b], sh.hist[b]);
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(&st->ticket, 1) == a.parts - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int b = threadIdx.x; b < kBins; b += kThreads) {
    sh.hist[b] = __ldcg(&gh[b]);
    gh[b] = 0;  // ready for the next pass
  }
  __syncthreads();
  const int above = st->above;
  pick_bin(sh.hist, a.k - above, sh.warp_sum, &sh.pick);
  if (threadIdx.x == 0) {
    const Pick p = sh.pick;
    Key pre = (prefix << w) | static_cast<Key>(p.bin);
    int res = resolved + w;
    const int new_above = above + p.above;
    const int done = new_above + p.count <= kCapacity;
    if (!done && res == 32 && a.l <= kNarrowIndex) {
      pre = (pre << 11) | 0x7FFu;
      res = 43;
    }
    st->prefix = pre;
    st->resolved = res;
    st->above = new_above;
    st->done = done;
    st->ticket = 0;
  }
  __syncthreads();
}

// Every key at or above its row's prefix, into the row's candidate buffer.
__device__ void gather_part(const LongRows& a, int64_t row, int64_t part) {
  RowState* st = a.states + row;
  if (st->spec_ok) return;
  const Split sp = split(st->prefix, st->resolved);
  const float* xr = a.x + row * a.l;
  const int start = static_cast<int>(part * a.chunk);
  const int end = static_cast<int>(start + a.chunk < a.l ? start + a.chunk : a.l);
  Key* out = a.cand + row * kCapacity;
  if (sp.resolved <= 32) {
    for_range(xr, start, end, [&](float v, int i, bool ok) {
      const uint32_t u = order_bits(v);
      const bool hit = ok && at_or_above<false>(u, 0u, sp);
      const int at = warp_append(&st->count, hit);
      if (hit) out[at] = make_key(u, i);
    });
  } else {
    for_range(xr, start, end, [&](float v, int i, bool ok) {
      const uint32_t u = order_bits(v);
      const bool hit = ok && at_or_above<true>(u, 0xFFFFFFFFu - i, sp);
      const int at = warp_append(&st->count, hit);
      if (hit) out[at] = make_key(u, i);
    });
  }
}

// The k largest of a row's candidates: from scratch for the sample's
// threshold, else from where the digit passes left the selection.
__device__ void final_row(const LongRows& a, int64_t row, SelectShared& sh, Key* keys) {
  const RowState& st = a.states[row];
  const int m = st.spec_ok ? st.spec_count : st.count;
  for (int i = threadIdx.x; i < m; i += kThreads) keys[i] = __ldcg(a.cand + row * kCapacity + i);
  __syncthreads();
  auto from_keys = [&](int i) { return keys[i]; };
  Cut cut = st.spec_ok ? Cut{0, 0, 0, m} : Cut{st.prefix, st.resolved, st.above, m - st.above};
  if (cut.above + cut.count != a.k) {
    cut = narrow_down(from_keys, m, a.k, a.k, a.l <= kNarrowIndex, cut, false, sh);
  }
  emit_top(from_keys, m, a.k, cut, sh, a.values + row * a.k, a.indices + row * a.k);
  __syncthreads();  // keys and sh are reused for the block's next row
}

// Every step over long rows in one cooperative launch, the steps apart by
// grid-wide barriers (all blocks are resident): the sample, the threshold's
// gather and, where a row needs them, the digit passes and the gather; then
// the final selection. Blocks walk the (row, part) items in strides of the
// grid.
__global__ void __launch_bounds__(kThreads, kLongBlocksPerSm) long_kernel(LongRows a) {
  __shared__ SelectShared sh;
  __shared__ Key pool[kCapacity];  // the sample, then the candidates
  cg::grid_group grid = cg::this_grid();
  const int64_t items = static_cast<int64_t>(a.n) * a.parts;
  if (blockIdx.x == 0 && threadIdx.x == 0) *a.pending = 0;
  for (int64_t row = blockIdx.x; row < a.n; row += gridDim.x) {
    sample_row(a, row, sh, reinterpret_cast<uint32_t*>(pool));
  }
  grid.sync();
  for (int64_t it = blockIdx.x; it < items; it += gridDim.x) spec_part(a, it / a.parts, it % a.parts);
  grid.sync();
  if (*reinterpret_cast<volatile int*>(a.pending)) {
    const int passes = a.l <= kNarrowIndex ? 5 : 6;
    for (int p = 0; p < passes; ++p) {
      for (int64_t it = blockIdx.x; it < items; it += gridDim.x) {
        pass_part(a, it / a.parts, it % a.parts, sh);
      }
      grid.sync();
    }
    for (int64_t it = blockIdx.x; it < items; it += gridDim.x) {
      gather_part(a, it / a.parts, it % a.parts);
    }
    grid.sync();
  }
  for (int64_t row = blockIdx.x; row < a.n; row += gridDim.x) final_row(a, row, sh, pool);
}

bool one_block(int64_t l) { return l <= kRowMax; }

}  // namespace

extern "C" {

// Words (8 bytes each) of workspace that tc_topk needs for (n, l, k).
int64_t tc_topk_workspace(int64_t n, int64_t l, int k) {
  (void)k;
  if (one_block(l)) return 0;
  return n * (kStateWords + kHistWords + kCapacity) + 1;  // + the pending flag
}

int tc_topk(const float* x, int64_t n, int64_t l, int k, Key* workspace,
            float* values, int64_t* indices, void* stream_ptr) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  if (k < 1 || k > kMaxK || k > l || l >= 0x7FFFFFFF || n > 0x7FFFFFFF) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  // per device, once: the one-block kernel's shared-memory limit, the SM
  // count and the long-row kernel's residency
  static int sms_of[64];
  static int per_sm_of[64];
  static bool row_smem_set[64];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (one_block(l)) {
    if (!row_smem_set[device]) {
      err = cudaFuncSetAttribute(row_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(kRowMax * sizeof(uint32_t)));
      if (err != cudaSuccess) return static_cast<int>(err);
      row_smem_set[device] = true;
    }
    const size_t smem = static_cast<size_t>((l + 3) / 4) * 16;  // whole 16-byte quads
    row_kernel<<<static_cast<unsigned>(n), kThreads, smem, stream>>>(x, l, k, values, indices);
    return static_cast<int>(cudaGetLastError());
  }
  if (per_sm_of[device] == 0) {
    err = cudaDeviceGetAttribute(&sms_of[device], cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm_of[device], long_kernel,
                                                          kThreads, 0);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // one wave of resident blocks (a cooperative launch needs them all), and
  // no block with fewer than kMinChunk keys of a row
  const int64_t resident = static_cast<int64_t>(sms_of[device]) * per_sm_of[device];
  const int64_t most = (l + kMinChunk - 1) / kMinChunk;
  int64_t parts = resident / n;
  parts = parts < 1 ? 1 : (parts > most ? most : parts);
  const int64_t chunk = ((l + parts - 1) / parts + 3) / 4 * 4;
  parts = (l + chunk - 1) / chunk;
  const int64_t items = n * parts;
  const unsigned grid = static_cast<unsigned>(items < resident ? items : resident);
  LongRows a{x,
             l,
             chunk,
             static_cast<int>(parts),
             static_cast<int>(n),
             k,
             reinterpret_cast<RowState*>(workspace),
             reinterpret_cast<int*>(workspace + n * kStateWords),
             workspace + n * (kStateWords + kHistWords),
             reinterpret_cast<int*>(workspace + n * (kStateWords + kHistWords + kCapacity)),
             values,
             indices};
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(long_kernel), grid, kThreads,
                                    args, 0, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
