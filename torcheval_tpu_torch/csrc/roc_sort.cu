// The stable radix sort of the exact binary AUROC's stream route
// (ops/roc_stream.py): (uint32 order key, uint8 label) pairs, bits 0-32,
// through a double buffer, with the library's onesweep radix sort
// (cub::DeviceRadixSort::SortPairs), the sort torch.sort runs too.
//
// Replaces no TPU kernel. The JAX package sorts the scores with an int32
// index payload and gathers the labels by it (torcheval_tpu/ops/curves.py,
// _group_end_cumsums); here the label itself rides the sort, one byte a row,
// so no index is written and no gather follows. Stable: rows of one key keep
// their input order, which is what gives every NaN row (one key for all of
// them) its place.
//
// Bound on an H100 SXM: device-memory bytes. Four 8-bit digit passes, each
// reading and writing 5 bytes a row, plus the first pass's digit histograms
// over the keys: about 44 bytes a row, 1.17 ms for 89,137,319 rows at
// 3.35 TB/s.
//
// Alone in its source: the one instantiation of the library's sort takes
// nvcc longest of any kernel here, and the build compiles each source in
// its own process, so the other sources do not wait on it.

#include <cub/device/device_radix_sort.cuh>
#include <cuda_runtime.h>
#include <stdint.h>

extern "C" {

// Bytes of scratch the sort of n pairs needs, or -1 when the library
// refuses the size.
int64_t tc_roc_sort_scratch(int64_t n) {
  size_t bytes = 0;
  cub::DoubleBuffer<uint32_t> keys(nullptr, nullptr);
  cub::DoubleBuffer<uint8_t> labels(nullptr, nullptr);
  const cudaError_t err = cub::DeviceRadixSort::SortPairs(nullptr, bytes, keys, labels, n, 0, 32);
  return err == cudaSuccess ? static_cast<int64_t>(bytes) : -1;
}

// Sort n (key, label) pairs by key, stably. keys/labels hold the input;
// keys_alt/labels_alt are buffers of the same sizes. *selector gets 0 when
// the sorted pairs ended in keys/labels, 1 when in keys_alt/labels_alt (the
// library swaps both buffers alike, and decides on the host, so the value is
// known when this returns).
int tc_roc_sort(uint32_t* keys, uint32_t* keys_alt, uint8_t* labels, uint8_t* labels_alt,
                int64_t n, void* scratch, int64_t scratch_bytes, int* selector, void* stream) {
  cub::DoubleBuffer<uint32_t> k(keys, keys_alt);
  cub::DoubleBuffer<uint8_t> v(labels, labels_alt);
  size_t bytes = static_cast<size_t>(scratch_bytes);
  cudaError_t err = cub::DeviceRadixSort::SortPairs(scratch, bytes, k, v, n, 0, 32,
                                                    static_cast<cudaStream_t>(stream));
  *selector = k.selector;
  if (err == cudaSuccess && k.selector != v.selector) err = cudaErrorUnknown;
  if (err == cudaSuccess) err = cudaGetLastError();
  return static_cast<int>(err);
}

}  // extern "C"
