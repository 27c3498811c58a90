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
// of ids; it does no arithmetic. Random rows of 256-512 bytes are
// latency-bound unless many are in flight: the first version kept one row
// per warp in flight behind a dependent id load and reached 61% (f32) and
// 49% (bf16) of the bound. Here each warp takes the ids 32 at a time
// (lane k loads ids[base + k], one coalesced load, spread with
// __shfl_sync) and loads the next tile's ids while the current tile's
// rows are in flight. A row is moved by a power-of-two group of lanes (a
// 512-byte f32 row by the warp, a 256-byte bf16 row by a half-warp, a
// 64-byte label row by four lanes), in 16-byte words where the table,
// the output and their strides allow it and else element by element, and
// each lane holds kUnroll independent loads before its first store.
//
// A second path that moved aligned rows with Hopper's bulk copies
// (cp.async.bulk into an mbarrier ring of shared-memory stages) took the
// same time to within 1% on an H100 and was not kept (PERF.md).
//
// Byte offsets are int64: row * D * elt passes 2^31 on a
// papers100M-sized table.
#include <cstdint>

#include <cuda_runtime.h>

#include "resident_blocks.cuh"

namespace {

constexpr int kTile = 32;       // ids per tile
constexpr int kUnroll = 8;      // loads in flight per lane
constexpr int kThreads = 256;   // threads per block
constexpr unsigned kAll = 0xffffffffu;

// V is the word one lane moves: uint4 (16 bytes) on the aligned path,
// else the element itself (uint32_t for f32, uint16_t for bf16).
// row_words is D in words; out_stride is W in words; out already points
// at column col_offset. A row is moved by 2^lpr_log2 lanes.
template <typename V>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const V* __restrict__ table, int64_t n_rows,
                   int row_words, const int32_t* __restrict__ ids,
                   int64_t m, V* __restrict__ out, int64_t out_stride,
                   V zero, V nan, int lpr_log2) {
  const int lane = threadIdx.x & 31;
  const int64_t warp =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int64_t n_warps =
      (static_cast<int64_t>(gridDim.x) * blockDim.x) >> 5;
  const int64_t n_tiles = (m + kTile - 1) / kTile;
  const int lanes_per_row = 1 << lpr_log2;
  const int rows_per_step = kTile >> lpr_log2;
  const int sub = lane >> lpr_log2;             // row within a step
  const int word0 = lane & (lanes_per_row - 1);

  int64_t tile = warp;
  int32_t id = -1;
  if (tile < n_tiles && tile * kTile + lane < m) {
    id = __ldg(ids + tile * kTile + lane);
  }
  for (; tile < n_tiles; tile += n_warps) {
    const int64_t next = tile + n_warps;         // its ids load meanwhile
    int32_t next_id = -1;
    if (next < n_tiles && next * kTile + lane < m) {
      next_id = __ldg(ids + next * kTile + lane);
    }
    const int64_t base = tile * kTile;
    const int rows =
        static_cast<int>(min(static_cast<int64_t>(kTile), m - base));
    const int steps = (rows + rows_per_step - 1) / rows_per_step;
    for (int s0 = 0; s0 < steps; s0 += kUnroll) {
      int r[kUnroll];
      int32_t rid[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        r[u] = (s0 + u) * rows_per_step + sub;
        const int32_t got = __shfl_sync(kAll, id, r[u] & (kTile - 1));
        rid[u] = r[u] < rows ? got : -1;
      }
      for (int j = word0; j < row_words; j += lanes_per_row) {
        V v[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          v[u] = rid[u] < 0 ? zero : nan;
          if (rid[u] >= 0 && rid[u] < n_rows) {
            v[u] = __ldg(table + static_cast<int64_t>(rid[u]) * row_words
                         + j);
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (r[u] < rows) out[(base + r[u]) * out_stride + j] = v[u];
        }
      }
    }
    id = next_id;
  }
}

// A grid for `tiles` tiles of kThreads / 32 warps a block: as many blocks
// as there are tiles for a warp each, up to what the device runs at once,
// and then as many as give every block the same number of rounds.
template <typename V>
unsigned balanced_blocks(int64_t tiles) {
  constexpr int64_t per_block = kThreads / 32;
  const int64_t want = (tiles + per_block - 1) / per_block;
  const int64_t cap =
      etpu::resident_blocks<gather_rows_kernel<V>, kThreads>();
  if (want <= cap) return static_cast<unsigned>(want);
  const int64_t rounds = (want + cap - 1) / cap;
  return static_cast<unsigned>((want + rounds - 1) / rounds);
}

template <typename V>
int launch(const void* table, int64_t n_rows, int row_words,
           const int32_t* ids, int64_t m, void* out, int64_t out_stride,
           V zero, V nan, cudaStream_t stream) {
  int lpr_log2 = 0;
  while ((1 << lpr_log2) < row_words && lpr_log2 < 5) ++lpr_log2;
  const unsigned blocks = balanced_blocks<V>((m + kTile - 1) / kTile);
  gather_rows_kernel<V><<<blocks, kThreads, 0, stream>>>(
      static_cast<const V*>(table), n_rows, row_words, ids, m,
      static_cast<V*>(out), out_stride, zero, nan, lpr_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// table [n_rows, d] of elt_size-byte elements (4: f32, 2: bf16), ids int32
// [m], out rows of out_stride elements, written from column col_offset.
// Launches on `stream` and returns cudaGetLastError() (0 = launched); an
// elt_size other than 2 or 4 returns cudaErrorInvalidValue.
extern "C" int etpu_gather_rows(const void* table, int64_t n_rows, int64_t d,
                                int elt_size, const void* ids, int64_t m,
                                void* out, int64_t out_stride,
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
    return launch<uint4>(table, n_rows, static_cast<int>(row_bytes / 16),
                         idx, m, dst, stride_bytes / 16,
                         make_uint4(0, 0, 0, 0), make_uint4(w, w, w, w), s);
  }
  if (elt_size == 4) {
    return launch<uint32_t>(table, n_rows, static_cast<int>(d), idx, m, dst,
                            out_stride, 0u, 0x7fc00000u, s);
  }
  return launch<uint16_t>(table, n_rows, static_cast<int>(d), idx, m, dst,
                          out_stride, static_cast<uint16_t>(0),
                          static_cast<uint16_t>(0x7fc0), s);
}
