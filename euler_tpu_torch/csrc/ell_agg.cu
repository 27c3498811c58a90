// Whole-graph ELL aggregate and its transpose, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: euler_tpu/dataflow/block.py::_ell_agg
// (:397-443) is jnp code left to XLA. It was added because the plain
// PyTorch version (euler_tpu_torch/ops/ell_agg.py::ell_agg_plain) took
// 73% of a whole-graph GCN step on an H100 (ogbn-arxiv's sizes, PERF.md):
// it wrote the padded [N, C, D] row tensor x[nbr] and read it again in a
// batched gemv, 3.1 GB a call at D = 256 for 38% live cells. For each
// row t of the output:
//
//   out[t] = sum over c of x[idx(t, c)] * w(t, c)  +  x[t] * w_l[t]
//
// forward:   idx = nbr[t, c], w = w_s[t, c]; a pad is nbr < 0
// transpose: p = tpos[t, c], idx = p / C, w = w_s.flat[p]; a pad is
//            p < 0 (the x-gradient of the forward, with the cotangent g
//            as x: grad_x[u] = sum of g[p / C] * w_s[p] + g[u] * w_l[u])
//
// Each weight is first rounded to x's type, as the plain version and the
// JAX reference do (w_s.astype(x.dtype)); products and sums are f32 in
// registers, in a fixed order, with one rounding at the store. Pads add
// exactly 0. Ids past the table are clamped to its last row (the
// transpose's p to the last cell of w_s), as the plain transpose does.
//
// Bound: device-memory bytes. The work needs each live cell's neighbour
// row once (from L2 where the table fits its 50 MB, else from HBM), the
// index and weight rows once, and the table and the output once; it does
// 2 flops a byte, so tensor cores do not apply, and the rows are random
// reads of 256-512 bytes, so it is bound by how many are in flight. One
// warp takes a row t: it loads the row's ids and weights 32 cells at a
// time (lane k loads cell c0 + k, one coalesced load), keeps only the
// live cells (ballot and popc), and hands each one out by __shfl_sync,
// so no load is spent on a pad. A neighbour row is read by W lanes in
// 16-byte words where x and out are aligned (a 512-byte bf16 row by the
// whole warp, a 256-byte one by a half-warp), else element by element;
// the 32 / W lane groups of the warp take different live cells, and each
// lane holds kUnroll independent row loads before its first add. The
// groups' sums meet by shuffles at the end, in a fixed order, so the
// result does not depend on the schedule. A row wider than 32 words is
// taken in passes of 32 words.
//
// What bounds it on an H100 is the chain of dependent trips a row makes
// (its ids, then its rows a batch at a time), so the card needs many rows
// in flight: 4 loads a lane and at most 64 registers, so that an SM holds
// 32 warps, took the gcn step's five calls from 2.24 to 1.78 ms against
// 8 loads at 88 registers (16 warps); 2 or 3 loads at 40-48 registers
// were within 1.5% of it, and loading the next chunk's ids while the
// rows are in flight was slower, for the registers it took (PERF.md).
//
// Byte offsets are int64.
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "bf16_words.cuh"
#include "resident_blocks.cuh"

namespace {

using etpu::rounded;
using etpu::Word;

constexpr int kCells = 32;       // cells a chunk: one a lane
constexpr int kUnroll = 4;       // row loads in flight per lane
constexpr int kThreads = 256;    // threads per block
constexpr int kMinBlocks = 4;    // blocks an SM holds: 64 registers a thread
constexpr unsigned kAll = 0xffffffffu;

// x [n, row_words] and out [n, row_words] in words V; index [n, width];
// w_s [n, c] f32 (forward: width == c); w_l [n] f32. A row is read by
// 2^col_log2 lanes; the warp's 32 >> col_log2 groups take different cells.
template <typename V, bool kBf16>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
ell_agg_kernel(const V* __restrict__ x, int64_t n, int row_words,
               const int32_t* __restrict__ index, int width,
               const float* __restrict__ w_s, int c,
               const float* __restrict__ w_l, V* __restrict__ out,
               bool transpose, int col_log2) {
  using W = Word<V, kBf16>;
  const int lane = threadIdx.x & 31;
  const int64_t warp =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int64_t n_warps =
      (static_cast<int64_t>(gridDim.x) * blockDim.x) >> 5;
  const int lanes_per_col = 1 << col_log2;
  const int groups_log2 = 5 - col_log2;
  const int groups = 1 << groups_log2;
  const int group = lane >> col_log2;
  const int col = lane & (lanes_per_col - 1);
  const int64_t last_cell = n * c - 1;
  const unsigned below = (1u << lane) - 1;

  for (int64_t t = warp; t < n; t += n_warps) {
    const int32_t* irow = index + t * width;
    const float wl = rounded<kBf16>(__ldg(w_l + t));
    for (int j0 = 0; j0 < row_words; j0 += lanes_per_col) {
      const int j = j0 + col;
      const bool col_ok = j < row_words;
      float acc[W::kElts];
#pragma unroll
      for (int e = 0; e < W::kElts; ++e) acc[e] = 0.0f;
      for (int c0 = 0; c0 < width; c0 += kCells) {
        int32_t id = -1;
        float w = 0.0f;
        if (c0 + lane < width) {
          const int32_t v = __ldg(irow + c0 + lane);
          if (v >= 0 && c > 0) {
            int64_t cell;
            if (transpose) {
              cell = v < last_cell ? v : last_cell;
              id = static_cast<int32_t>(cell / c);
            } else {
              cell = t * c + c0 + lane;
              id = v < n ? v : static_cast<int32_t>(n - 1);
            }
            w = rounded<kBf16>(__ldg(w_s + cell));
          }
        }
        const unsigned live = __ballot_sync(kAll, id >= 0);
        // this group's cells: the live ones of rank = group mod groups
        unsigned mine = live;
        if (groups > 1) {
          const int rank = __popc(live & below);
          for (int g = 0; g < groups; ++g) {
            const unsigned b = __ballot_sync(
                kAll, id >= 0 && (rank & (groups - 1)) == g);
            if (g == group) mine = b;
          }
        }
        const int steps = (__popc(live) + groups - 1) >> groups_log2;
        for (int s0 = 0; s0 < steps; s0 += kUnroll) {
          int32_t rid[kUnroll];
          float rw[kUnroll];
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            const int src = mine ? __ffs(mine) - 1 : 0;
            const int32_t got = __shfl_sync(kAll, id, src);
            rw[u] = __shfl_sync(kAll, w, src);
            rid[u] = mine ? got : -1;
            mine &= mine - 1;
          }
          if (col_ok) {
            V v[kUnroll];
#pragma unroll
            for (int u = 0; u < kUnroll; ++u) {
              if (rid[u] >= 0) {
                v[u] = __ldg(x + static_cast<int64_t>(rid[u]) * row_words
                             + j);
              }
            }
#pragma unroll
            for (int u = 0; u < kUnroll; ++u) {
              if (rid[u] >= 0) W::add(acc, v[u], rw[u]);
            }
          }
        }
      }
      for (int off = lanes_per_col; off < 32; off <<= 1) {
#pragma unroll
        for (int e = 0; e < W::kElts; ++e) {
          acc[e] += __shfl_xor_sync(kAll, acc[e], off);
        }
      }
      if (group == 0 && col_ok) {
        W::add(acc, __ldg(x + t * row_words + j), wl);
        out[t * row_words + j] = W::pack(acc);
      }
    }
  }
}

template <typename V, bool kBf16>
int launch(const void* x, int64_t n, int row_words, const int32_t* index,
           int width, const float* w_s, int c, const float* w_l, void* out,
           bool transpose, cudaStream_t stream) {
  int col_log2 = 0;
  while ((1 << col_log2) < row_words && col_log2 < 5) ++col_log2;
  // a warp a row, as many blocks as the device holds at once at most
  constexpr int64_t per_block = kThreads / 32;
  const int64_t want = (n + per_block - 1) / per_block;
  const int64_t cap =
      etpu::resident_blocks<ell_agg_kernel<V, kBf16>, kThreads>();
  const unsigned blocks = static_cast<unsigned>(want < cap ? want : cap);
  ell_agg_kernel<V, kBf16><<<blocks, kThreads, 0, stream>>>(
      static_cast<const V*>(x), n, row_words, index, width, w_s, c, w_l,
      static_cast<V*>(out), transpose, col_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x and out [n, d] of elt_size-byte elements (4: f32, 2: bf16), index
// int32 [n, width], w_s f32 [n, c], w_l f32 [n]; transpose 0 reads index
// as nbr (width == c), 1 as tpos. Launches on `stream` and returns
// cudaGetLastError() (0 = launched); an elt_size other than 2 or 4
// returns cudaErrorInvalidValue.
extern "C" int etpu_ell_agg(const void* x, int64_t n, int64_t d,
                            int elt_size, const void* index, int64_t width,
                            const void* w_s, int64_t c, const void* w_l,
                            void* out, int transpose, void* stream) {
  if (elt_size != 2 && elt_size != 4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0 || d == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* idx = static_cast<const int32_t*>(index);
  const float* ws = static_cast<const float*>(w_s);
  const float* wl = static_cast<const float*>(w_l);
  const int64_t row_bytes = d * elt_size;
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
                       row_bytes % 16 == 0;
  const int w = static_cast<int>(width), cc = static_cast<int>(c);
  const bool tr = transpose != 0;
  if (aligned) {
    const int words = static_cast<int>(row_bytes / 16);
    return elt_size == 4
        ? launch<uint4, false>(x, n, words, idx, w, ws, cc, wl, out, tr, s)
        : launch<uint4, true>(x, n, words, idx, w, ws, cc, wl, out, tr, s);
  }
  return elt_size == 4
      ? launch<uint32_t, false>(x, n, static_cast<int>(d), idx, w, ws, cc,
                                wl, out, tr, s)
      : launch<uint16_t, true>(x, n, static_cast<int>(d), idx, w, ws, cc,
                               wl, out, tr, s);
}
