// Typed mean aggregate over a CSR grouped by (node, relation), and its
// transpose, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package's RelationConv is jnp code
// left to XLA, and it takes Euler's mean over all of a node's relations.
// This pair runs R-GCN's per-relation mean (Schlichtkrull et al., eq. 2)
// over the whole graph. For each node t:
//
//   forward:   out[t] = root[t] + sum over relations r of
//                       1 / c(t, r) * sum over the cells e of segment
//                       (t, r) of rows_r[cells[e]]
//   transpose: d_r[u] = sum over the cells e of segment (u, r) of the
//                       transposed CSR of w[e] * g[cells[e]]
//
// The forward's segment (t, r) is seg_ptr[t * R + r] .. seg_ptr[t * R + r
// + 1] of the graph's CSR (edges sorted by (source, type, destination)),
// c(t, r) its length and its cells the neighbours' ids; rows_r is relation
// r's message table, one row a neighbour id in [rel_lo[r], rel_hi[r]), at
// any row stride (a column block of a wider GEMM output), and root[t] the
// f32 row of t's node type (none where root_base is 0). The transpose's
// segment (u, r) lists the nodes t whose segment (t, r) reads u, with the
// weight 1 / c(t, r); it writes relation r's gradient rows d_r (f32, at
// rel_base, any row stride) for every u in [rel_lo[r], rel_hi[r]), zero
// where the segment is empty or r is masked off.
//
// Sums are f32 in registers in a fixed order and nothing is atomic, so a
// call gives the same bits every time. One warp takes a node: its lanes
// load the node's R + 1 segment pointers at once, then its ids 32 cells
// at a time (the forward across its relations at once, the transpose a
// relation at a time, as each relation has its own output row); the
// warp's 32 / W lane groups (W lanes read a row in 16-byte words) take
// the cells in turn, each lane holding kUnroll row loads in flight, and
// the groups' sums meet by shuffles in a fixed order.
// A segment longer than `hub` cells (a field of study read by 90,000
// papers) would hold one warp for the whole kernel, so the host splits it
// into chunks of at most `hub` cells (the pack's chunk list); a first
// kernel sums each chunk into a row of `partial` (a warp a chunk), and the
// node's warp adds its chunks' rows in order.
//
// Rows are read as 16-byte words: every row base and row stride is a
// multiple of 16 bytes (the wrapper checks). Byte offsets are int64.
#include <cstdint>

#include <cuda_runtime.h>

#include "bf16_words.cuh"
#include "resident_blocks.cuh"

namespace {

using etpu::Word;

constexpr int kMaxRel = 32;      // relations (the R + 1 pointers: one a lane)
constexpr int kMaxTypes = 16;    // node types
constexpr int kUnroll = 4;       // row loads in flight per lane
constexpr int kThreads = 256;    // threads per block
constexpr int kMinBlocks = 4;    // blocks an SM holds: 64 registers a thread
constexpr unsigned kAll = 0xffffffffu;

// Where each relation's rows and each node type's root rows lie; passed by
// value (ops/rel_agg.py builds it with ctypes, field for field).
struct Layout {
  int64_t rel_base[kMaxRel];     // byte address of the row of id rel_lo[r]
  int64_t rel_stride[kMaxRel];   // bytes from one row to the next
  int32_t rel_lo[kMaxRel];       // relation r's rows: ids [lo, hi)
  int32_t rel_hi[kMaxRel];
  int64_t root_base[kMaxTypes];  // byte address of type t's first root row
  int64_t root_stride[kMaxTypes];
  int32_t type_lo[kMaxTypes + 1];  // type t: nodes [type_lo[t], type_lo[t+1])
  int32_t n_rel;
  int32_t n_types;
  uint32_t mask;                 // bit r: relation r is taken
  int32_t hub;                   // longest segment summed by its node's warp
};

// A warp's lanes: 2^col_log2 lanes read a row's words, the warp's groups
// take different cells.
struct Lanes {
  int lane, col, group, groups_log2, per_col;
  __device__ explicit Lanes(int words) {
    int col_log2 = 0;
    while ((1 << col_log2) < words && col_log2 < 5) ++col_log2;
    lane = threadIdx.x & 31;
    per_col = 1 << col_log2;
    groups_log2 = 5 - col_log2;
    group = lane >> col_log2;
    col = lane & (per_col - 1);
  }
};

__device__ __forceinline__ int64_t warp_id() {
  return (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
}
__device__ __forceinline__ int64_t warp_count() {
  return (static_cast<int64_t>(gridDim.x) * blockDim.x) >> 5;
}

// acc += the rows of cells [lo, hi) (times weights[e] where weights is
// not null), this lane's elements of word j; the groups take the cells
// in turn (cell k of a 32-cell chunk by group k mod groups).
template <bool kBf16, typename RowOf>
__device__ __forceinline__ void sum_cells(
    float* acc, const int32_t* __restrict__ cells,
    const float* __restrict__ weights, int64_t lo, int64_t hi, int j,
    bool col_ok, const Lanes& ln, RowOf row_of) {
  using W = Word<uint4, kBf16>;
  for (int64_t c0 = lo; c0 < hi; c0 += 32) {
    const int count = hi - c0 < 32 ? static_cast<int>(hi - c0) : 32;
    int32_t id = 0;
    float w = 1.0f;
    if (ln.lane < count) {
      id = __ldg(cells + c0 + ln.lane);
      if (weights != nullptr) w = __ldg(weights + c0 + ln.lane);
    }
    const int steps = (count + (1 << ln.groups_log2) - 1) >> ln.groups_log2;
    for (int s0 = 0; s0 < steps; s0 += kUnroll) {
      int32_t rid[kUnroll];
      float rw[kUnroll];
      bool ok[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int cell = ((s0 + u) << ln.groups_log2) + ln.group;
        rid[u] = __shfl_sync(kAll, id, cell & 31);
        rw[u] = __shfl_sync(kAll, w, cell & 31);
        ok[u] = cell < count;
      }
      if (col_ok) {
        uint4 v[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (ok[u]) v[u] = __ldg(row_of(rid[u]) + j);
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (ok[u]) W::add(acc, v[u], rw[u]);
        }
      }
    }
  }
}

// acc summed over the warp's groups (xor shuffles, a fixed order).
template <int kE>
__device__ __forceinline__ void reduce_groups(float* acc, const Lanes& ln) {
  for (int off = ln.per_col; off < 32; off <<= 1) {
#pragma unroll
    for (int e = 0; e < kE; ++e) acc[e] += __shfl_xor_sync(kAll, acc[e], off);
  }
}

// acc += scale times the partial rows of segment seg's chunks, in order
// (hub_seg is sorted; chunks hub_ptr[h] .. hub_ptr[h + 1] are segment
// hub_seg[h]'s).
template <int kE>
__device__ __forceinline__ void add_chunks(
    float* acc, int64_t seg, const int32_t* __restrict__ hub_seg,
    const int32_t* __restrict__ hub_ptr, int n_hub,
    const float* __restrict__ partial, int64_t row_floats, int j,
    float scale) {
  int a = 0, b = n_hub;
  while (a < b) {
    const int m = (a + b) >> 1;
    if (__ldg(hub_seg + m) < seg) a = m + 1; else b = m;
  }
  if (a >= n_hub || __ldg(hub_seg + a) != seg) return;
  for (int k = __ldg(hub_ptr + a); k < __ldg(hub_ptr + a + 1); ++k) {
    const float* p = partial + k * row_floats + j * kE;
#pragma unroll
    for (int e = 0; e < kE; ++e) acc[e] = fmaf(__ldg(p + e), scale, acc[e]);
  }
}

template <int kE>
__device__ __forceinline__ void store_f32(float* dst, const float* acc) {
#pragma unroll
  for (int e = 0; e < kE; e += 4) {
    *reinterpret_cast<float4*>(dst + e) =
        make_float4(acc[e], acc[e + 1], acc[e + 2], acc[e + 3]);
  }
}

__device__ __forceinline__ const uint4* rel_row(const Layout& L, int r,
                                                int32_t id) {
  const int32_t lo = L.rel_lo[r], top = L.rel_hi[r] - 1;
  id = id < lo ? lo : (id > top ? top : id);
  return reinterpret_cast<const uint4*>(
      L.rel_base[r] + static_cast<int64_t>(id - lo) * L.rel_stride[r]);
}

// One chunk a warp: its cells' rows summed into partial[k]. chunks [K, 3]:
// (segment, first cell, end cell). kTranspose: rows g[id] times the
// weights, else relation (segment mod R)'s rows.
template <bool kBf16, bool kTranspose>
__device__ __forceinline__ void hub_chunks(
    const Layout& L, const int32_t* __restrict__ chunks, int64_t n_chunks,
    const int32_t* __restrict__ cells, const float* __restrict__ weights,
    const uint4* __restrict__ g, int64_t n, int words,
    float* __restrict__ partial) {
  constexpr int kE = Word<uint4, kBf16>::kElts;
  const Lanes ln(words);
  const int64_t row_floats = static_cast<int64_t>(words) * kE;
  for (int64_t k = warp_id(); k < n_chunks; k += warp_count()) {
    const int64_t seg = __ldg(chunks + 3 * k);
    const int64_t lo = __ldg(chunks + 3 * k + 1);
    const int64_t hi = __ldg(chunks + 3 * k + 2);
    const int r = static_cast<int>(seg % L.n_rel);
    for (int j0 = 0; j0 < words; j0 += ln.per_col) {
      const int j = j0 + ln.col;
      const bool col_ok = j < words;
      float acc[kE];
#pragma unroll
      for (int e = 0; e < kE; ++e) acc[e] = 0.0f;
      if constexpr (kTranspose) {
        sum_cells<kBf16>(acc, cells, weights, lo, hi, j, col_ok, ln,
                         [&](int32_t id) {
          id = id < 0 ? 0 : (id >= n ? static_cast<int32_t>(n - 1) : id);
          return g + static_cast<int64_t>(id) * words;
        });
      } else {
        sum_cells<kBf16>(acc, cells, nullptr, lo, hi, j, col_ok, ln,
                         [&](int32_t id) { return rel_row(L, r, id); });
      }
      reduce_groups<kE>(acc, ln);
      if (ln.group == 0 && col_ok) {
        store_f32<kE>(partial + k * row_floats + j * kE, acc);
      }
    }
  }
}

template <bool kBf16>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
rel_mean_hub_kernel(const __grid_constant__ Layout L,
                    const int32_t* __restrict__ chunks, int64_t n_chunks,
                    const int32_t* __restrict__ cells, int words,
                    float* __restrict__ partial) {
  hub_chunks<kBf16, false>(L, chunks, n_chunks, cells, nullptr, nullptr, 0,
                           words, partial);
}

template <bool kBf16>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
rel_mean_tr_hub_kernel(const __grid_constant__ Layout L,
                       const int32_t* __restrict__ chunks, int64_t n_chunks,
                       const int32_t* __restrict__ cells,
                       const float* __restrict__ weights,
                       const uint4* __restrict__ g, int64_t n, int words,
                       float* __restrict__ partial) {
  hub_chunks<kBf16, true>(L, chunks, n_chunks, cells, weights, g, n, words,
                          partial);
}

// The forward, one node a warp: out [n, F] f32. A node's cells of every
// relation are one run of the CSR (sorted by (source, type, destination)),
// so the warp takes them 32 at a time across relations: each lane finds
// its cell's relation r among the node's segment pointers and weighs its
// row by 1 / c(t, r), and one round of row loads serves every relation. A
// cell of a masked relation or of a segment longer than `hub` adds nothing
// there; the long segments' chunk rows are added after, scaled alike.
template <bool kBf16>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
rel_mean_kernel(const __grid_constant__ Layout L,
                const int32_t* __restrict__ seg_ptr,
                const int32_t* __restrict__ cells, int64_t n, int words,
                const int32_t* __restrict__ hub_seg,
                const int32_t* __restrict__ hub_ptr, int n_hub,
                const float* __restrict__ partial, float* __restrict__ out) {
  using W = Word<uint4, kBf16>;
  constexpr int kE = W::kElts;
  const Lanes ln(words);
  const int R = L.n_rel;
  const int64_t row_floats = static_cast<int64_t>(words) * kE;
  for (int64_t t = warp_id(); t < n; t += warp_count()) {
    const int32_t sp = ln.lane <= R ? __ldg(seg_ptr + t * R + ln.lane) : 0;
    const int32_t beg = __shfl_sync(kAll, sp, 0);
    const int32_t end = __shfl_sync(kAll, sp, R);
    int ty = 0;
    while (ty + 1 < L.n_types && t >= L.type_lo[ty + 1]) ++ty;
    for (int j0 = 0; j0 < words; j0 += ln.per_col) {
      const int j = j0 + ln.col;
      const bool col_ok = j < words;
      float acc[kE];
#pragma unroll
      for (int e = 0; e < kE; ++e) acc[e] = 0.0f;
      for (int32_t c0 = beg; c0 < end; c0 += 32) {
        const int count = end - c0 < 32 ? end - c0 : 32;
        const int32_t cell = c0 + ln.lane;
        int r = 0;
        for (int q = 1; q < R; ++q) {
          if (cell >= __shfl_sync(kAll, sp, q)) r = q;
        }
        const int32_t c = __shfl_sync(kAll, sp, r + 1) -
                          __shfl_sync(kAll, sp, r);
        int32_t id = -1;
        float w = 0.0f;
        if (ln.lane < count && c <= L.hub && ((L.mask >> r) & 1u)) {
          id = __ldg(cells + cell);
          w = 1.0f / static_cast<float>(c);
        }
        const int steps =
            (count + (1 << ln.groups_log2) - 1) >> ln.groups_log2;
        for (int s0 = 0; s0 < steps; s0 += kUnroll) {
          int32_t rid[kUnroll], rr[kUnroll];
          float rw[kUnroll];
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            const int k = ((s0 + u) << ln.groups_log2) + ln.group;
            rid[u] = __shfl_sync(kAll, id, k & 31);
            rw[u] = __shfl_sync(kAll, w, k & 31);
            rr[u] = __shfl_sync(kAll, r, k & 31);
            if (k >= count) rid[u] = -1;
          }
          if (col_ok) {
            uint4 v[kUnroll];
#pragma unroll
            for (int u = 0; u < kUnroll; ++u) {
              if (rid[u] >= 0) v[u] = __ldg(rel_row(L, rr[u], rid[u]) + j);
            }
#pragma unroll
            for (int u = 0; u < kUnroll; ++u) {
              if (rid[u] >= 0) W::add(acc, v[u], rw[u]);
            }
          }
        }
      }
      if (end - beg > L.hub) {
        for (int r = 0; r < R; ++r) {
          const int32_t lo = __shfl_sync(kAll, sp, r);
          const int32_t hi = __shfl_sync(kAll, sp, r + 1);
          if (hi - lo > L.hub && ((L.mask >> r) & 1u) && ln.group == 0 &&
              col_ok) {
            add_chunks<kE>(acc, t * R + r, hub_seg, hub_ptr, n_hub, partial,
                           row_floats, j, 1.0f / static_cast<float>(hi - lo));
          }
        }
      }
      reduce_groups<kE>(acc, ln);
      if (ln.group == 0 && col_ok) {
        if (L.root_base[ty] != 0) {
          const float* rt = reinterpret_cast<const float*>(
              L.root_base[ty] + (t - L.type_lo[ty]) * L.root_stride[ty]) +
              j * kE;
#pragma unroll
          for (int e = 0; e < kE; ++e) acc[e] += __ldg(rt + e);
        }
        store_f32<kE>(out + t * row_floats + j * kE, acc);
      }
    }
  }
}

// The transpose, one node u a warp: each relation r whose rows hold u
// gets its f32 row d_r[u] (at rel_base, rel_stride).
template <bool kBf16>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
rel_mean_tr_kernel(const __grid_constant__ Layout L,
                   const int32_t* __restrict__ tptr,
                   const int32_t* __restrict__ tsrc,
                   const float* __restrict__ tw,
                   const uint4* __restrict__ g, int64_t n, int words,
                   const int32_t* __restrict__ hub_seg,
                   const int32_t* __restrict__ hub_ptr, int n_hub,
                   const float* __restrict__ partial) {
  constexpr int kE = Word<uint4, kBf16>::kElts;
  const Lanes ln(words);
  const int R = L.n_rel;
  const int64_t row_floats = static_cast<int64_t>(words) * kE;
  for (int64_t u = warp_id(); u < n; u += warp_count()) {
    const int32_t sp = ln.lane <= R ? __ldg(tptr + u * R + ln.lane) : 0;
    for (int j0 = 0; j0 < words; j0 += ln.per_col) {
      const int j = j0 + ln.col;
      const bool col_ok = j < words;
      for (int r = 0; r < R; ++r) {
        const int32_t lo = __shfl_sync(kAll, sp, r);
        const int32_t hi = __shfl_sync(kAll, sp, r + 1);
        if (u < L.rel_lo[r] || u >= L.rel_hi[r]) continue;
        float acc[kE];
#pragma unroll
        for (int e = 0; e < kE; ++e) acc[e] = 0.0f;
        if (hi > lo && ((L.mask >> r) & 1u)) {
          if (hi - lo > L.hub) {
            if (ln.group == 0 && col_ok) {
              add_chunks<kE>(acc, u * R + r, hub_seg, hub_ptr, n_hub,
                             partial, row_floats, j, 1.0f);
            }
          } else {
            sum_cells<kBf16>(acc, tsrc, tw, lo, hi, j, col_ok, ln,
                             [&](int32_t id) {
              id = id < 0 ? 0
                   : (id >= n ? static_cast<int32_t>(n - 1) : id);
              return g + static_cast<int64_t>(id) * words;
            });
          }
          reduce_groups<kE>(acc, ln);
        }
        if (ln.group == 0 && col_ok) {
          float* dst = reinterpret_cast<float*>(
              L.rel_base[r] + (u - L.rel_lo[r]) * L.rel_stride[r]);
          store_f32<kE>(dst + j * kE, acc);
        }
      }
    }
  }
}

// Blocks of a warp-per-item kernel over `items`: as many as the device
// holds at once at most.
template <auto Kernel>
unsigned grid_for(int64_t items) {
  constexpr int64_t per_block = kThreads / 32;
  const int64_t want = (items + per_block - 1) / per_block;
  const int64_t cap = etpu::resident_blocks<Kernel, kThreads>();
  return static_cast<unsigned>(want < cap ? want : cap);
}

template <bool kBf16>
int forward(const Layout& L, const int32_t* seg_ptr, const int32_t* cells,
            int64_t n, int words, const int32_t* chunks, int64_t n_chunks,
            const int32_t* hub_seg, const int32_t* hub_ptr, int n_hub,
            float* partial, float* out, cudaStream_t s) {
  if (n_chunks > 0) {
    rel_mean_hub_kernel<kBf16>
        <<<grid_for<rel_mean_hub_kernel<kBf16>>(n_chunks), kThreads, 0, s>>>(
            L, chunks, n_chunks, cells, words, partial);
  }
  rel_mean_kernel<kBf16><<<grid_for<rel_mean_kernel<kBf16>>(n), kThreads, 0,
                           s>>>(L, seg_ptr, cells, n, words, hub_seg,
                                hub_ptr, n_hub, partial, out);
  return static_cast<int>(cudaGetLastError());
}

template <bool kBf16>
int transpose(const Layout& L, const int32_t* tptr, const int32_t* tsrc,
              const float* tw, const uint4* g, int64_t n, int words,
              const int32_t* chunks, int64_t n_chunks,
              const int32_t* hub_seg, const int32_t* hub_ptr, int n_hub,
              float* partial, cudaStream_t s) {
  if (n_chunks > 0) {
    rel_mean_tr_hub_kernel<kBf16>
        <<<grid_for<rel_mean_tr_hub_kernel<kBf16>>(n_chunks), kThreads, 0,
           s>>>(L, chunks, n_chunks, tsrc, tw, g, n, words, partial);
  }
  rel_mean_tr_kernel<kBf16><<<grid_for<rel_mean_tr_kernel<kBf16>>(n),
                              kThreads, 0, s>>>(
      L, tptr, tsrc, tw, g, n, words, hub_seg, hub_ptr, n_hub, partial);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The forward: layout (host) as struct Layout; seg_ptr int32 [n * R + 1],
// cells int32 [E]; the message rows row_bytes long, of elt_size-byte
// elements (4: f32, 2: bf16); chunks int32 [n_chunks, 3], hub_seg and
// hub_ptr int32 [n_hub] and [n_hub + 1], partial f32 [n_chunks, F]; out
// f32 [n, F], F = row_bytes / elt_size. Launches on `stream` (the chunk
// kernel first where there are chunks) and returns cudaGetLastError() (0
// = launched); an elt_size other than 2 or 4, or a row not a whole number
// of 16-byte words, returns cudaErrorInvalidValue.
extern "C" int etpu_rel_mean(const void* layout, const void* seg_ptr,
                             const void* cells, int64_t n, int64_t row_bytes,
                             int elt_size, const void* chunks,
                             int64_t n_chunks, const void* hub_seg,
                             const void* hub_ptr, int64_t n_hub,
                             void* partial, void* out, void* stream) {
  if ((elt_size != 2 && elt_size != 4) || row_bytes % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0 || row_bytes == 0) return 0;
  const Layout& L = *static_cast<const Layout*>(layout);
  const int words = static_cast<int>(row_bytes / 16);
  const auto* sp = static_cast<const int32_t*>(seg_ptr);
  const auto* c = static_cast<const int32_t*>(cells);
  const auto* ch = static_cast<const int32_t*>(chunks);
  const auto* hs = static_cast<const int32_t*>(hub_seg);
  const auto* hp = static_cast<const int32_t*>(hub_ptr);
  const int nh = static_cast<int>(n_hub);
  auto* p = static_cast<float*>(partial);
  auto* o = static_cast<float*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return elt_size == 2
      ? forward<true>(L, sp, c, n, words, ch, n_chunks, hs, hp, nh, p, o, s)
      : forward<false>(L, sp, c, n, words, ch, n_chunks, hs, hp, nh, p, o, s);
}

// The transpose: tptr int32 [n * R + 1], tsrc int32 [E] and tw f32 [E]
// the transposed CSR; g [n, F] the cotangent rows (row_bytes long, of
// elt_size-byte elements); the gradient rows are written where layout's
// rel_base and rel_stride say (f32); chunks, hub_seg, hub_ptr and partial
// as the forward's, over the transposed segments. Returns as
// etpu_rel_mean.
extern "C" int etpu_rel_mean_tr(const void* layout, const void* tptr,
                                const void* tsrc, const void* tw,
                                const void* g, int64_t n, int64_t row_bytes,
                                int elt_size, const void* chunks,
                                int64_t n_chunks, const void* hub_seg,
                                const void* hub_ptr, int64_t n_hub,
                                void* partial, void* stream) {
  if ((elt_size != 2 && elt_size != 4) || row_bytes % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0 || row_bytes == 0) return 0;
  const Layout& L = *static_cast<const Layout*>(layout);
  const int words = static_cast<int>(row_bytes / 16);
  const auto* tp = static_cast<const int32_t*>(tptr);
  const auto* ts = static_cast<const int32_t*>(tsrc);
  const auto* w = static_cast<const float*>(tw);
  const auto* gr = static_cast<const uint4*>(g);
  const auto* ch = static_cast<const int32_t*>(chunks);
  const auto* hs = static_cast<const int32_t*>(hub_seg);
  const auto* hp = static_cast<const int32_t*>(hub_ptr);
  const int nh = static_cast<int>(n_hub);
  auto* p = static_cast<float*>(partial);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return elt_size == 2
      ? transpose<true>(L, tp, ts, w, gr, n, words, ch, n_chunks, hs, hp,
                        nh, p, s)
      : transpose<false>(L, tp, ts, w, gr, n, words, ch, n_chunks, hs, hp,
                         nh, p, s);
}
