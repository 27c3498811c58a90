// Row gather with the reference's fills, for Hopper (sm_90a).
//
// Replaces tools/micro/micro_pallas_gather.py::pallas_gather (the Pallas
// TPU kernel: one DMA per row, 16 semaphores, 1024-row chunks) and, on
// the port's feature path, the XLA take of euler_tpu/ops/feature_ops.py::
// _take_rows with the zeroing after it (feature_ops.py:28-30 and
// euler_tpu/models/encoders.py:66-67). For each output row i:
//
//   out[i, col_offset : col_offset + D] = table[ids[i]]   0 <= ids[i] < N
//                                       = 0               ids[i] < 0
//                                       = NaN             ids[i] >= N
//
// The NaN row is what jnp.take's default fill gives an out-of-range id.
// The output's row stride W may exceed D, so several tables can be
// gathered side by side into one concatenated output.
//
// The kernel copies bits: the table's elements are moved as 2-, 4- or
// 16-byte words, never converted, so it is bit-exact against the plain
// PyTorch version (euler_tpu_torch/ops/gather_rows.py). The NaNs it
// writes are the canonical quiet NaNs 0x7fc00000 (f32) and 0x7fc0 (bf16)
// that both JAX and PyTorch produce.
//
// Bound: device-memory bytes. The gather must read each distinct row it
// selects once (rows * D * elt), write M * D * elt and read 4 * M bytes
// of ids; it does no arithmetic. The TPU kernel issues one DMA per row
// from scalar memory; here one warp copies one row, each lane moving
// 16 bytes at a time (a 128-wide f32 row is one 512-byte transaction of
// the warp), and the warps stride over the rows. Byte offsets are int64:
// row * D * elt passes 2^31 on a papers100M-sized table. This first
// version keeps one row in flight per warp; several rows per warp, to
// hide more latency, is the known next step.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / 32;
constexpr int kBlocksPerSm = 2048 / kThreads;  // full occupancy

// V is the word moved per lane and step: uint4 (16 bytes) on the aligned
// path, else the element itself (uint32_t for f32, uint16_t for bf16).
// row_words is D in words; out_stride is W in words; out already points
// at column col_offset.
template <typename V>
__global__ void gather_rows_kernel(const V* __restrict__ table,
                                   int64_t n_rows, int64_t row_words,
                                   const int32_t* __restrict__ ids,
                                   int64_t m, V* __restrict__ out,
                                   int64_t out_stride, V zero, V nan) {
  const int lane = threadIdx.x & 31;
  const int64_t warp =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int64_t n_warps =
      (static_cast<int64_t>(gridDim.x) * blockDim.x) >> 5;
  for (int64_t i = warp; i < m; i += n_warps) {
    const int32_t id = __ldg(ids + i);
    V* dst = out + i * out_stride;
    if (id >= 0 && id < n_rows) {
      const V* src = table + static_cast<int64_t>(id) * row_words;
      for (int64_t j = lane; j < row_words; j += 32) dst[j] = __ldg(src + j);
    } else {
      const V fill = id < 0 ? zero : nan;
      for (int64_t j = lane; j < row_words; j += 32) dst[j] = fill;
    }
  }
}

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess || sms <= 0) {
    return 132;  // H100 SXM; only sizes the grid
  }
  return sms;
}

template <typename V>
void launch(const void* table, int64_t n_rows, int64_t row_words,
            const int32_t* ids, int64_t m, void* out, int64_t out_stride,
            V zero, V nan, cudaStream_t stream) {
  const int64_t want = (m + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const int64_t cap = static_cast<int64_t>(sm_count()) * kBlocksPerSm;
  const unsigned blocks = static_cast<unsigned>(want < cap ? want : cap);
  gather_rows_kernel<V><<<blocks, kThreads, 0, stream>>>(
      static_cast<const V*>(table), n_rows, row_words, ids, m,
      static_cast<V*>(out), out_stride, zero, nan);
}

}  // namespace

// table [n_rows, d] of elt_size-byte elements (4: f32, 2: bf16), ids
// int32 [m], out rows of out_stride elements, written from column
// col_offset. Launches on `stream` and returns cudaGetLastError()
// (0 = launched); an elt_size other than 2 or 4 returns
// cudaErrorInvalidValue.
extern "C" int etpu_gather_rows(const void* table, int64_t n_rows,
                                int64_t d, int elt_size, const void* ids,
                                int64_t m, void* out, int64_t out_stride,
                                int64_t col_offset, void* stream) {
  if (elt_size != 2 && elt_size != 4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (m == 0 || d == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* idx = static_cast<const int32_t*>(ids);
  char* dst = static_cast<char*>(out) + col_offset * elt_size;
  const int64_t row_bytes = d * elt_size;
  const int64_t stride_bytes = out_stride * elt_size;
  const bool aligned = reinterpret_cast<uintptr_t>(table) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(dst) % 16 == 0 &&
                       row_bytes % 16 == 0 && stride_bytes % 16 == 0;
  if (aligned) {
    const uint32_t w = elt_size == 4 ? 0x7fc00000u : 0x7fc07fc0u;
    launch<uint4>(table, n_rows, row_bytes / 16, idx, m, dst,
                  stride_bytes / 16, make_uint4(0, 0, 0, 0),
                  make_uint4(w, w, w, w), s);
  } else if (elt_size == 4) {
    launch<uint32_t>(table, n_rows, d, idx, m, dst, out_stride, 0u,
                     0x7fc00000u, s);
  } else {
    launch<uint16_t>(table, n_rows, d, idx, m, dst, out_stride,
                     static_cast<uint16_t>(0),
                     static_cast<uint16_t>(0x7fc0), s);
  }
  return static_cast<int>(cudaGetLastError());
}
