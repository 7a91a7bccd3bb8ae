// Class histogram: out[c] = number of labels equal to c, for c in [0, C).
// Labels outside [0, C) (negative or >= C) are dropped.
//
// Replaces the TPU kernel torcheval_tpu/ops/pallas_hist.py::_hist_kernel
// (driven by pallas_class_counts). The TPU kernel compares each label block
// against a class iota and sums a float32 one-hot in VMEM, exact to 2^24
// per class. Here each block keeps a privatised int32 histogram of one class
// tile in shared memory and adds into it with integer atomics. The block then
// adds its non-zero bins into the global int32 output. Integer atomics make
// the result exact to 2^31 per class and the same on every run.
//
// Bound on an H100 SXM: device-memory bytes. The kernel reads each label
// once, N * sizeof(label) bytes, and writes C * 4 bytes: 2^24 int64 labels
// are 134 MB, about 40 us at 3.35 TB/s. What it does about that: labels are
// read once, in coalesced warp-wide loads, and never cast in a separate pass
// (int32 and int64 are both read natively). Lanes of a warp that hold the
// same bin elect one leader with __match_any_sync, which adds the group's
// size, so a small C does not serialise every lane on one shared-memory
// address. When C * 4 bytes exceeds the shared memory a block is given, the
// classes are tiled over blockIdx.y, as the TPU kernel tiles them over lanes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// 48 KB of int32 bins: the static shared-memory limit, so no opt-in is needed.
constexpr int64_t kMaxTile = 12288;
constexpr int kBlocksPerSm = 8;

template <typename T>
__global__ void __launch_bounds__(kThreads)
hist_kernel(const T* __restrict__ labels, int64_t n, int64_t num_classes,
            int64_t c_tile, int32_t* __restrict__ out) {
  extern __shared__ int32_t bins[];
  const int64_t c0 = static_cast<int64_t>(blockIdx.y) * c_tile;
  const int width = static_cast<int>(
      num_classes - c0 < c_tile ? num_classes - c0 : c_tile);
  for (int b = threadIdx.x; b < width; b += blockDim.x) bins[b] = 0;
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  // `base` is the same for every thread of the block, so all lanes of a warp
  // take the same number of trips and the warp-wide match below is legal.
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * blockDim.x; base < n;
       base += stride) {
    const int64_t i = base + threadIdx.x;
    int bin = -1;
    if (i < n) {
      const int64_t l = static_cast<int64_t>(labels[i]);
      if (l >= c0 && l < c0 + width) bin = static_cast<int>(l - c0);
    }
    const unsigned peers = __match_any_sync(0xffffffffu, bin);
    if (bin >= 0 && lane == __ffs(peers) - 1) {
      atomicAdd(&bins[bin], __popc(peers));
    }
  }
  __syncthreads();
  for (int b = threadIdx.x; b < width; b += blockDim.x) {
    const int32_t v = bins[b];
    if (v != 0) atomicAdd(&out[c0 + b], v);
  }
}

template <typename T>
int launch_hist(const T* labels, int64_t n, int64_t num_classes, int32_t* out,
                void* stream) {
  if (n <= 0 || num_classes <= 0) return static_cast<int>(cudaGetLastError());
  const int64_t c_tile = num_classes < kMaxTile ? num_classes : kMaxTile;
  const int64_t tiles = (num_classes + c_tile - 1) / c_tile;
  int device = 0;
  int sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  int64_t blocks = (n + kThreads - 1) / kThreads;
  const int64_t cap = static_cast<int64_t>(sms) * kBlocksPerSm;
  if (blocks > cap) blocks = cap;
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(tiles));
  const size_t smem = static_cast<size_t>(c_tile) * sizeof(int32_t);
  hist_kernel<T><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      labels, n, num_classes, c_tile, out);
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
