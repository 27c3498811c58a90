// Multi-head whole-graph ELL attention, for Hopper (sm_90a): GAT's
// attention over each row's cells and its self loop, its backward, and
// the per-edge dot products of a weighted aggregate's weight gradient (an
// SDDMM).
//
// Replaces no Pallas kernel: the JAX package's GAT is single-head and its
// ELL aggregate (euler_tpu/dataflow/block.py::_ell_agg, :397-443) is jnp
// code left to XLA. Added for multi-head GAT over the whole graph
// (models/convs.py GATConv(heads=H), ogbn-arxiv's sizes in PERF.md),
// whose plain versions (ops/ell_attn.py) write the padded [N, C, D] row
// tensor: 18 GB a call at D = 750 in f32.
//
// The row layout is "padded heads": x [n, H, Fp], each head's F values
// padded with zeros to Fp, so that a head is a whole number wph of 16-byte
// words and every 16-byte word belongs to one head (wph a power of two up
// to 32, or a multiple of 32; ops/ell_attn.py::head_words). A warp takes a
// row t; its lanes take words of the row, 32 at a time or, for rows of
// fewer words, in groups that take different cells, as ell_agg.cu does.
//
// The kernels take GAT's per-head score terms el and er [n, H] (f32) and
// compute the attention weights from them, GAT's softmax over each row's
// live cells and its self loop of s = leaky_relu_0.2(el[t, h] + er[nbr[t,
// c], h]) (el[t, h] + er[t, h] for the self loop):
//
//   ell_attn_fwd_kernel: lse[t, h] = log of the sum of exp(s) over the row
//       (a max shift first), then out[t, h] = sum over c of x[nbr[t, c], h]
//       p[t, c, h] + x[t, h] p_self[t, h] with p = exp(s - lse); writes
//       lse [n, H]
//   ell_sddmm_kernel: gw_s[t, c, h] = g[t, h] . x[nbr[t, c], h] and gw_l[t,
//       h] = g[t, h] . x[t, h] (ell_sddmm's weighted mode: the weight
//       gradient of ops.ell_agg's one-head aggregate); in GAT's mode
//       (kGat) then in place the scores' gradients de = p (dp - sum of p
//       dp over the row) leaky_relu'(.) ([n, C, H], the self loop's [n,
//       H]) and d_el, their row sums
//   ell_attn_tr_kernel: the aggregate's gradient to the rows, over p =
//       tpos[t, c] (live cells only), idx = p / C, with the weights p
//       recomputed, plus d_el[u, h] a_l[h] + d_er[u, h] a_r[h], in f32, [n,
//       H * F]; writes d_er, the sum of de over u's transpose cells and its
//       self loop
//
// so that no [n, C, H] score, probability or mask is built, and the
// gradients of el and er reach the rows' gradient here and not through
// an [n, D] product of their own. A row's sums over its cells run over
// lanes and end in shuffles, in a fixed order.
//
// A pad (index < 0) adds 0 and gets a gradient of 0. Ids past the table
// are clamped to its last row (the transpose's p to the last cell), as in
// ell_agg.cu. The weights stay f32 (they are not rounded to x's type);
// products and sums are f32 in registers in a fixed order, so replays equal
// eager steps bit for bit; the forward rounds once, at the store, to x's
// type and writes out unpadded, [n, H * F] (f < F only); the transpose
// writes f32 [n, H * F].
//
// Bound: device-memory bytes, as ell_agg.cu: each live cell's neighbour
// row once, the index and score terms once, the table and the output once,
// at 2 flops a byte. The rows are random 1-2 kB reads; each lane holds
// kUnroll of them in flight. The per-cell weights of a chunk of 32 cells
// go through shared memory, since lanes of one warp read different heads.
// The SDDMM keeps its lane's word of g[t] in registers, multiplies it with
// each live neighbour's word and sums each head's words by shuffles within
// the head's lanes.
//
// Byte offsets are int64.
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "resident_blocks.cuh"

namespace {

constexpr int kCells = 32;       // cells a chunk: one a lane
constexpr int kUnroll = 4;       // row loads in flight per lane
constexpr int kThreads = 256;    // threads per block
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = 4;    // blocks an SM holds: 64 registers a thread
constexpr unsigned kAll = 0xffffffffu;

// floats of shared memory a warp in GAT's modes: a chunk's weights (sw),
// each lane's partial sums a head (sp) and the row's terms (rs)
__host__ __device__ constexpr int warp_floats(int heads) {
  return (2 * kCells + 2) * heads;
}

__device__ __forceinline__ float lo_bf16(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float hi_bf16(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ uint32_t bf16_bits(float f) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(f));
}

// One 16-byte word: 4 f32 or 8 bf16. add() accumulates w times the word's
// elements into acc, dot() sums the word's products with another word in
// a fixed order.
template <bool kBf16> struct Word;

template <> struct Word<false> {
  static constexpr int kElts = 4;
  static __device__ __forceinline__ void add(float* acc, uint4 v, float w) {
    acc[0] = fmaf(__uint_as_float(v.x), w, acc[0]);
    acc[1] = fmaf(__uint_as_float(v.y), w, acc[1]);
    acc[2] = fmaf(__uint_as_float(v.z), w, acc[2]);
    acc[3] = fmaf(__uint_as_float(v.w), w, acc[3]);
  }
  static __device__ __forceinline__ float dot(uint4 a, uint4 b) {
    float s = __uint_as_float(a.x) * __uint_as_float(b.x);
    s = fmaf(__uint_as_float(a.y), __uint_as_float(b.y), s);
    s = fmaf(__uint_as_float(a.z), __uint_as_float(b.z), s);
    return fmaf(__uint_as_float(a.w), __uint_as_float(b.w), s);
  }
};

template <> struct Word<true> {
  static constexpr int kElts = 8;
  static __device__ __forceinline__ void add(float* acc, uint4 v, float w) {
    const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      acc[2 * i] = fmaf(lo_bf16(u[i]), w, acc[2 * i]);
      acc[2 * i + 1] = fmaf(hi_bf16(u[i]), w, acc[2 * i + 1]);
    }
  }
  static __device__ __forceinline__ float dot(uint4 a, uint4 b) {
    const uint32_t p[4] = {a.x, a.y, a.z, a.w};
    const uint32_t q[4] = {b.x, b.y, b.z, b.w};
    float s = 0.0f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      s = fmaf(lo_bf16(p[i]), lo_bf16(q[i]), s);
      s = fmaf(hi_bf16(p[i]), hi_bf16(q[i]), s);
    }
    return s;
  }
};

// Stores elements f0 .. f0 + kElts - 1 of acc that lie below f_real, at
// out + base (element offsets), in x's type: bf16 two at a time where the
// row, the head, f_real and the address allow (``pairs``), else one at a
// time.
template <bool kBf16>
__device__ __forceinline__ void store_elements(void* out, int64_t base,
                                               int f0, int f_real,
                                               bool pairs, const float* acc) {
  constexpr int kElts = Word<kBf16>::kElts;
  if (kBf16) {
    if (pairs) {
      uint32_t* o = reinterpret_cast<uint32_t*>(
          static_cast<uint16_t*>(out) + base);
#pragma unroll
      for (int i = 0; i < kElts / 2; ++i) {
        if (f0 + 2 * i < f_real) {
          o[i] = bf16_bits(acc[2 * i]) | (bf16_bits(acc[2 * i + 1]) << 16);
        }
      }
    } else {
      uint16_t* o = static_cast<uint16_t*>(out) + base;
#pragma unroll
      for (int e = 0; e < kElts; ++e) {
        if (f0 + e < f_real) o[e] = static_cast<uint16_t>(bf16_bits(acc[e]));
      }
    }
  } else {
    float* o = static_cast<float*>(out) + base;
#pragma unroll
    for (int e = 0; e < kElts; ++e) {
      if (f0 + e < f_real) o[e] = acc[e];
    }
  }
}

// The lane layout of a row of row_words words (ell_agg.cu's): a row is
// read by 2^col_log2 lanes; the warp's 32 >> col_log2 groups take
// different cells.
struct Lanes {
  int lane, lanes_per_col, groups_log2, groups, group, col;
  unsigned below;
  __device__ __forceinline__ explicit Lanes(int col_log2) {
    lane = threadIdx.x & 31;
    lanes_per_col = 1 << col_log2;
    groups_log2 = 5 - col_log2;
    groups = 1 << groups_log2;
    group = lane >> col_log2;
    col = lane & (lanes_per_col - 1);
    below = (1u << lane) - 1;
  }
  // the live cells (ballot ``live``) that this lane's group takes: those
  // whose rank among the live ones is the group's number modulo groups
  __device__ __forceinline__ unsigned mine(unsigned live, bool is_live)
      const {
    if (groups == 1) return live;
    const int rank = __popc(live & below);
    unsigned out = live;
    for (int g = 0; g < groups; ++g) {
      const unsigned b =
          __ballot_sync(kAll, is_live && (rank & (groups - 1)) == g);
      if (g == group) out = b;
    }
    return out;
  }
};

// GAT's per-head terms and results (the header's kernels); null in the
// SDDMM's weighted mode.
struct Gat {
  const float* el;       // [n, heads]
  const float* er;       // [n, heads]
  float* lse;            // [n, heads]: the forward writes, the others read
  const float* de;       // [n, c, heads]: the SDDMM's gw_s, for the transpose
  const float* de_self;  // [n, heads]: the SDDMM's gw_l, for the transpose
  float* d_el;           // [n, heads]: the SDDMM writes, the transpose reads
  float* d_er;           // [n, heads]: the transpose writes
  const float* a_l;      // [heads, f_real]
  const float* a_r;      // [heads, f_real]
};

// leaky_relu with GAT's slope 0.2, and its derivative as torch takes it
// (the slope at 0)
__device__ __forceinline__ float lrelu(float v) {
  return v > 0.0f ? v : 0.2f * v;
}
__device__ __forceinline__ float lrelu_grad(float v) {
  return v > 0.0f ? 1.0f : 0.2f;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kAll, v, off);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(kAll, v, off));
  }
  return v;
}

// the neighbour id of cell i of a forward row (clamped into the table), or
// -1 for a pad or past the row
__device__ __forceinline__ int32_t live_id(const int32_t* irow, int i, int c,
                                           int64_t n) {
  if (i >= c) return -1;
  const int32_t v = __ldg(irow + i);
  if (v < 0) return -1;
  return v < n ? v : static_cast<int32_t>(n - 1);
}


// The forward's terms of row t, into this warp's rs: rs[k] = el[t, k] and
// rs[heads + k] = lse[t, k] (also written to gat.lse), the log of the sum
// of exp(s) over the row's live cells and its self loop, shifted by their
// max (reset to 0 for a row of no score; the sum at least 1e-16).
__device__ __forceinline__ void gat_fwd_row(const Gat& gat, int64_t t,
                                            int64_t n, int heads,
                                            const int32_t* irow, int c,
                                            int lane, float* rs) {
  __syncwarp();   // every lane has read the previous row's rs
  for (int k = 0; k < heads; ++k) {
    const float el = __ldg(gat.el + t * heads + k);
    const float self = lrelu(el + __ldg(gat.er + t * heads + k));
    float m = self;
    for (int c0 = 0; c0 < c; c0 += kCells) {
      const int32_t id = live_id(irow, c0 + lane, c, n);
      if (id >= 0) {
        m = fmaxf(m, lrelu(el + __ldg(gat.er +
                                      static_cast<int64_t>(id) * heads + k)));
      }
    }
    m = warp_max(m);
    if (!(m > -1e30f)) m = 0.0f;
    float den = 0.0f;
    for (int c0 = 0; c0 < c; c0 += kCells) {
      const int32_t id = live_id(irow, c0 + lane, c, n);
      if (id >= 0) {
        den += expf(lrelu(el + __ldg(gat.er +
                                     static_cast<int64_t>(id) * heads + k))
                    - m);
      }
    }
    den = warp_sum(den) + expf(self - m);
    if (lane == 0) {
      const float lse = m + logf(fmaxf(den, 1e-16f));
      rs[k] = el;
      rs[heads + k] = lse;
      gat.lse[t * heads + k] = lse;
    }
  }
  __syncwarp();
}

// The transpose's terms of row u, into this warp's rs: rs[k] = er[u, k]
// and rs[heads + k] = d_er[u, k] (also written to gat.d_er), de_self[u, k]
// and the sum of de over u's transpose cells: each lane sums its cells a
// head in sp, then the warp once a head. Kept out of the row loop, whose
// registers it would spill.
__device__ __forceinline__ void gat_tr_row(const Gat& gat, int64_t u,
                                           int heads, const int32_t* irow,
                                           int width, int c,
                                           int64_t last_cell, int lane,
                                           float* sp, float* rs) {
  float* mine = sp + lane * heads;
  __syncwarp();   // every lane has read the previous row's rs
  for (int k = 0; k < heads; ++k) mine[k] = 0.0f;
  for (int c0 = 0; c0 < width; c0 += kCells) {
    if (c0 + lane < width && c > 0) {
      const int32_t v = __ldg(irow + c0 + lane);
      if (v >= 0) {
        const float* d = gat.de + (v < last_cell ? v : last_cell) * heads;
#pragma unroll 4
        for (int k = 0; k < heads; ++k) mine[k] += __ldg(d + k);
      }
    }
  }
  for (int k = 0; k < heads; ++k) {
    const float d =
        warp_sum(mine[k]) + __ldg(gat.de_self + u * heads + k);
    if (lane == 0) {
      rs[k] = __ldg(gat.er + u * heads + k);
      rs[heads + k] = d;
      gat.d_er[u * heads + k] = d;
    }
  }
  __syncwarp();
}

// x [n, heads * wph] words; index [n, width]: nbr (the forward, width ==
// c) or the tpos of live cells (the transpose). out, element (t, h, f) at
// (t * heads + h) * f_real + f for f < f_real: the forward's in x's type
// (bf16 two at a time where ``pairs``), the transpose's in f32 with el's
// and er's terms. sw: this warp's warp_floats of shared memory.
template <bool kBf16, bool kTranspose>
__device__ __forceinline__ void attn_agg(
    const uint4* __restrict__ x, int64_t n, int heads, int wph,
    const int32_t* __restrict__ index, int width, int c,
    void* __restrict__ out, int f_real, bool pairs, int col_log2, float* sw,
    const Gat& gat) {
  using W = Word<kBf16>;
  const Lanes L(col_log2);
  const int row_words = heads * wph;
  const int64_t warp =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int64_t n_warps =
      (static_cast<int64_t>(gridDim.x) * blockDim.x) >> 5;
  const int64_t last_cell = n * c - 1;
  const int64_t out_ld = static_cast<int64_t>(heads) * f_real;
  const int64_t out_hs = f_real;
  float* sp = sw + kCells * heads;
  float* rs = sp + kCells * heads;

  for (int64_t t = warp; t < n; t += n_warps) {
    const int32_t* irow = index + t * width;
    if (kTranspose) {
      gat_tr_row(gat, t, heads, irow, width, c, last_cell, L.lane, sp, rs);
    } else {
      gat_fwd_row(gat, t, n, heads, irow, c, L.lane, rs);
    }
    for (int j0 = 0; j0 < row_words; j0 += L.lanes_per_col) {
      const int j = j0 + L.col;
      const bool col_ok = j < row_words;
      const int h = col_ok ? j / wph : 0;
      // the heads whose words this pass reads
      const int k_lo = j0 / wph;
      const int k_hi = min(heads - 1, (j0 + L.lanes_per_col - 1) / wph);
      float acc[W::kElts];
#pragma unroll
      for (int e = 0; e < W::kElts; ++e) acc[e] = 0.0f;
      for (int c0 = 0; c0 < width; c0 += kCells) {
        int32_t id = -1;
        if (c0 + L.lane < width && c > 0) {
          const int32_t v = __ldg(irow + c0 + L.lane);
          if (v >= 0) {
            if (kTranspose) {
              const int64_t cell = v < last_cell ? v : last_cell;
              id = static_cast<int32_t>(cell / c);
            } else {
              id = v < n ? v : static_cast<int32_t>(n - 1);
            }
          }
        }
        if (id >= 0) {
          for (int k = k_lo; k <= k_hi; ++k) {
            const int64_t at = static_cast<int64_t>(id) * heads + k;
            // p of the cell: the transpose's is cell (id, .) of el[id] and
            // er[t], the forward's of el[t] and er[id]
            sw[L.lane * heads + k] =
                kTranspose ? expf(lrelu(__ldg(gat.el + at) + rs[k]) -
                                  __ldg(gat.lse + at))
                           : expf(lrelu(rs[k] + __ldg(gat.er + at)) -
                                  rs[heads + k]);
          }
        }
        __syncwarp();
        const unsigned live = __ballot_sync(kAll, id >= 0);
        unsigned mine = L.mine(live, id >= 0);
        const int steps = (__popc(live) + L.groups - 1) >> L.groups_log2;
        for (int s0 = 0; s0 < steps; s0 += kUnroll) {
          int32_t rid[kUnroll];
          float rw[kUnroll];
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            const int src = mine ? __ffs(mine) - 1 : 0;
            const int32_t got = __shfl_sync(kAll, id, src);
            rid[u] = mine ? got : -1;
            rw[u] = mine ? sw[src * heads + h] : 0.0f;
            mine &= mine - 1;
          }
          if (col_ok) {
            uint4 v[kUnroll];
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
        __syncwarp();   // every lane has read sw before the next chunk
      }
      for (int off = L.lanes_per_col; off < 32; off <<= 1) {
#pragma unroll
        for (int e = 0; e < W::kElts; ++e) {
          acc[e] += __shfl_xor_sync(kAll, acc[e], off);
        }
      }
      if (L.group == 0 && col_ok) {
        const int64_t th = t * heads + h;
        // the self loop's p of row t
        const float wl =
            kTranspose ? expf(lrelu(__ldg(gat.el + th) + rs[h]) -
                              __ldg(gat.lse + th))
                       : expf(lrelu(rs[h] + __ldg(gat.er + th)) -
                              rs[heads + h]);
        W::add(acc, __ldg(x + t * row_words + j), wl);
        const int f0 = (j - h * wph) * W::kElts;
        const int64_t base = t * out_ld + h * out_hs;
        if (kTranspose) {
          // the rows' gradient in f32, with el's and er's terms
          const float dl = __ldg(gat.d_el + th), dr = rs[heads + h];
          float* o = static_cast<float*>(out) + base;
          const float* al = gat.a_l + static_cast<int64_t>(h) * f_real;
          const float* ar = gat.a_r + static_cast<int64_t>(h) * f_real;
#pragma unroll
          for (int e = 0; e < W::kElts; ++e) {
            const int f = f0 + e;
            if (f < f_real) {
              o[f] = acc[e] + dl * __ldg(al + f) + dr * __ldg(ar + f);
            }
          }
        } else {
          store_elements<kBf16>(out, base + f0, f0, f_real, pairs, acc);
        }
      }
    }
    if (kTranspose) {
      __syncwarp();
      for (int k = L.lane; k < heads; k += 32) {
        gat.d_er[t * heads + k] = rs[heads + k];
      }
    }
  }
}

template <bool kBf16>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
ell_attn_fwd_kernel(const uint4* __restrict__ x, int64_t n, int heads,
                    int wph, const int32_t* __restrict__ index, int width,
                    int c, void* __restrict__ out, int f_real, bool pairs,
                    int col_log2, Gat gat) {
  extern __shared__ float smem[];
  attn_agg<kBf16, false>(x, n, heads, wph, index, width, c, out, f_real,
                         pairs, col_log2,
                         smem + (threadIdx.x >> 5) * warp_floats(heads), gat);
}

template <bool kBf16>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
ell_attn_tr_kernel(const uint4* __restrict__ x, int64_t n, int heads,
                   int wph, const int32_t* __restrict__ index, int width,
                   int c, void* __restrict__ out, int f_real, bool pairs,
                   int col_log2, Gat gat) {
  extern __shared__ float smem[];
  attn_agg<kBf16, true>(x, n, heads, wph, index, width, c, out, f_real,
                        pairs, col_log2,
                        smem + (threadIdx.x >> 5) * warp_floats(heads), gat);
}

// GAT's SDDMM epilogue of row t, once gw_s and gw_l hold its dot products
// dp: in place, de = p (dp - D) leaky_relu'(el + er) with p = exp(s - lse)
// and D the sum of p dp over the row's live cells and its self loop; and
// d_el[t] the sum of de over them. Each lane sums its cells a head in sp
// ([kCells, heads] of this warp's shared memory) and the warp once a head;
// rs holds D a head.
__device__ __forceinline__ void gat_sddmm_row(const Gat& gat, int64_t t,
                                              int64_t n, int heads,
                                              const int32_t* irow, int c,
                                              int lane, float* gw_s,
                                              float* gw_l, float* sp,
                                              float* rs) {
  const float* el = gat.el + t * heads;
  const float* er = gat.er + t * heads;
  const float* lse = gat.lse + t * heads;
  float* mine = sp + lane * heads;
  __syncwarp();   // every lane's dot products are in memory, rs is free
  for (int k = 0; k < heads; ++k) mine[k] = 0.0f;
  for (int c0 = 0; c0 < c; c0 += kCells) {
    const int32_t id = live_id(irow, c0 + lane, c, n);
    if (id >= 0) {
      const float* o = gw_s + (t * c + c0 + lane) * heads;
      const float* er_id = gat.er + static_cast<int64_t>(id) * heads;
      for (int k = 0; k < heads; ++k) {
        const float pre = __ldg(el + k) + __ldg(er_id + k);
        mine[k] += expf(lrelu(pre) - __ldg(lse + k)) * o[k];
      }
    }
  }
  for (int k = 0; k < heads; ++k) {
    const float p_self =
        expf(lrelu(__ldg(el + k) + __ldg(er + k)) - __ldg(lse + k));
    const float D = warp_sum(mine[k]) + p_self * gw_l[t * heads + k];
    if (lane == 0) rs[k] = D;
    mine[k] = 0.0f;
  }
  __syncwarp();   // rs holds D
  for (int c0 = 0; c0 < c; c0 += kCells) {
    const int32_t id = live_id(irow, c0 + lane, c, n);
    if (id >= 0) {
      float* o = gw_s + (t * c + c0 + lane) * heads;
      const float* er_id = gat.er + static_cast<int64_t>(id) * heads;
      for (int k = 0; k < heads; ++k) {
        const float pre = __ldg(el + k) + __ldg(er_id + k);
        const float de = expf(lrelu(pre) - __ldg(lse + k)) * (o[k] - rs[k])
                         * lrelu_grad(pre);
        o[k] = de;
        mine[k] += de;
      }
    }
  }
  for (int k = 0; k < heads; ++k) {
    const float pre_self = __ldg(el + k) + __ldg(er + k);
    const float p_self = expf(lrelu(pre_self) - __ldg(lse + k));
    const float de_self =
        p_self * (gw_l[t * heads + k] - rs[k]) * lrelu_grad(pre_self);
    const float esum = warp_sum(mine[k]) + de_self;
    __syncwarp();   // every lane has read gw_l[t, k]
    if (lane == 0) {
      gw_l[t * heads + k] = de_self;
      gat.d_el[t * heads + k] = esum;
    }
  }
}

// g and x [n, heads * wph] words, pads zero; nbr [n, c]; gw_s [n, c, heads]
// f32; gw_l [n, heads] f32 or null (never in GAT's mode). A head's words
// are summed by shuffles over seg = min(wph, lanes a column) lanes; a head
// wider than 32 words adds its passes of 32 in order, written by the
// pass's lane 0. GAT's mode then turns the row's dot products into the
// scores' gradients (gat_sddmm_row).
template <bool kBf16, bool kGat>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
ell_sddmm_kernel(const uint4* __restrict__ g, const uint4* __restrict__ x,
                 int64_t n, int heads, int wph,
                 const int32_t* __restrict__ nbr, int c,
                 float* __restrict__ gw_s, float* __restrict__ gw_l,
                 int col_log2, Gat gat) {
  extern __shared__ float smem[];
  using W = Word<kBf16>;
  const Lanes L(col_log2);
  const int row_words = heads * wph;
  const int seg = wph < L.lanes_per_col ? wph : L.lanes_per_col;
  const int64_t warp =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int64_t n_warps =
      (static_cast<int64_t>(gridDim.x) * blockDim.x) >> 5;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  for (int64_t t = warp; t < n; t += n_warps) {
    const int32_t* irow = nbr + t * c;
    for (int j0 = 0; j0 < row_words; j0 += L.lanes_per_col) {
      const int j = j0 + L.col;
      const bool col_ok = j < row_words;
      const int h = col_ok ? j / wph : 0;
      // the first pass over head h's words writes, a later one adds
      const bool first = (j0 % wph) == 0 || wph < L.lanes_per_col;
      const bool writer = col_ok && (L.col & (seg - 1)) == 0;
      const uint4 gw = col_ok ? __ldg(g + t * row_words + j) : zero;
      if (gw_l != nullptr) {
        float p = col_ok ? W::dot(gw, __ldg(x + t * row_words + j)) : 0.0f;
        for (int off = 1; off < seg; off <<= 1) {
          p += __shfl_xor_sync(kAll, p, off);
        }
        if (writer && L.group == 0) {
          float* o = gw_l + t * heads + h;
          *o = first ? p : *o + p;
        }
      }
      for (int c0 = 0; c0 < c; c0 += kCells) {
        int32_t id = -1;
        const bool in_row = c0 + L.lane < c;
        if (in_row) {
          const int32_t v = __ldg(irow + c0 + L.lane);
          if (v >= 0) id = v < n ? v : static_cast<int32_t>(n - 1);
        }
        if (j0 == 0 && in_row && id < 0) {   // pads: a gradient of 0
          for (int k = 0; k < heads; ++k) {
            gw_s[(t * c + c0 + L.lane) * heads + k] = 0.0f;
          }
        }
        const unsigned live = __ballot_sync(kAll, id >= 0);
        unsigned mine = L.mine(live, id >= 0);
        const int steps = (__popc(live) + L.groups - 1) >> L.groups_log2;
        for (int s0 = 0; s0 < steps; s0 += kUnroll) {
          int32_t rid[kUnroll], rcell[kUnroll];
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            const int src = mine ? __ffs(mine) - 1 : 0;
            const int32_t got = __shfl_sync(kAll, id, src);
            rid[u] = mine ? got : -1;
            rcell[u] = c0 + src;
            mine &= mine - 1;
          }
          uint4 v[kUnroll];
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            v[u] = (col_ok && rid[u] >= 0)
                ? __ldg(x + static_cast<int64_t>(rid[u]) * row_words + j)
                : zero;
          }
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            float p = W::dot(gw, v[u]);
            for (int off = 1; off < seg; off <<= 1) {
              p += __shfl_xor_sync(kAll, p, off);
            }
            if (writer && rid[u] >= 0) {
              float* o = gw_s + (t * c + rcell[u]) * heads + h;
              *o = first ? p : *o + p;
            }
          }
        }
      }
    }
    if (kGat) {
      float* sp = smem + (threadIdx.x >> 5) * warp_floats(heads);
      gat_sddmm_row(gat, t, n, heads, irow, c, L.lane, gw_s, gw_l, sp,
                    sp + kCells * heads);
    }
  }
}

int col_log2_of(int row_words) {
  int col_log2 = 0;
  while ((1 << col_log2) < row_words && col_log2 < 5) ++col_log2;
  return col_log2;
}

unsigned grid_for(int64_t n, int64_t cap) {
  // a warp a row, as many blocks as the device holds at once at most
  constexpr int64_t per_block = kWarps;
  const int64_t want = (n + per_block - 1) / per_block;
  return static_cast<unsigned>(want < cap ? want : cap);
}

template <bool kBf16>
int launch_agg(const void* x, int64_t n, int heads, int wph,
               const int32_t* index, int width, int c, void* out, int f_real,
               bool pairs, bool transpose, const Gat& gat,
               cudaStream_t stream) {
  const int col_log2 = col_log2_of(heads * wph);
  const size_t smem = sizeof(float) * kWarps * warp_floats(heads);
  const uint4* xv = static_cast<const uint4*>(x);
  if (transpose) {
    const int64_t cap =
        etpu::resident_blocks<ell_attn_tr_kernel<kBf16>, kThreads>();
    ell_attn_tr_kernel<kBf16><<<grid_for(n, cap), kThreads, smem, stream>>>(
        xv, n, heads, wph, index, width, c, out, f_real, pairs, col_log2,
        gat);
  } else {
    const int64_t cap =
        etpu::resident_blocks<ell_attn_fwd_kernel<kBf16>, kThreads>();
    ell_attn_fwd_kernel<kBf16><<<grid_for(n, cap), kThreads, smem, stream>>>(
        xv, n, heads, wph, index, width, c, out, f_real, pairs, col_log2,
        gat);
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool kBf16, bool kGat>
int launch_sddmm(const void* g, const void* x, int64_t n, int heads, int wph,
                 const int32_t* nbr, int c, float* gw_s, float* gw_l,
                 const Gat& gat, cudaStream_t stream) {
  const int64_t cap =
      etpu::resident_blocks<ell_sddmm_kernel<kBf16, kGat>, kThreads>();
  const size_t smem = kGat ? sizeof(float) * kWarps * warp_floats(heads) : 0;
  ell_sddmm_kernel<kBf16, kGat><<<grid_for(n, cap), kThreads, smem,
                                  stream>>>(
      static_cast<const uint4*>(g), static_cast<const uint4*>(x), n, heads,
      wph, nbr, c, gw_s, gw_l, col_log2_of(heads * wph), gat);
  return static_cast<int>(cudaGetLastError());
}

// A head of wph words: a power of two up to 32, or a multiple of 32.
bool head_words_ok(int64_t wph) {
  return wph > 0 && ((wph <= 32 && (wph & (wph - 1)) == 0) || wph % 32 == 0);
}

bool rows_ok(const void* x, int64_t heads, int64_t wph, int elt_size) {
  return (elt_size == 2 || elt_size == 4) && head_words_ok(wph) &&
         heads > 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
}

const float* f32(const void* p) { return static_cast<const float*>(p); }
float* f32(void* p) { return static_cast<float*>(p); }
const int32_t* i32(const void* p) { return static_cast<const int32_t*>(p); }

}  // namespace

// g and x [n, heads, wph * 16 bytes] (16-byte aligned, pads zero); nbr
// int32 [n, c]; gw_s f32 [n, c, heads]; gw_l f32 [n, heads] or null (not
// computed). Launches on `stream` and returns cudaGetLastError().
extern "C" int etpu_ell_sddmm(const void* g, const void* x, int64_t n,
                              int64_t heads, int64_t wph, int elt_size,
                              const void* nbr, int64_t c, void* gw_s,
                              void* gw_l, void* stream) {
  if (!rows_ok(x, heads, wph, elt_size) ||
      reinterpret_cast<uintptr_t>(g) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int h = static_cast<int>(heads), w = static_cast<int>(wph);
  const Gat none{};
  return elt_size == 4
      ? launch_sddmm<false, false>(g, x, n, h, w, i32(nbr),
                                   static_cast<int>(c), f32(gw_s),
                                   f32(gw_l), none, s)
      : launch_sddmm<true, false>(g, x, n, h, w, i32(nbr),
                                  static_cast<int>(c), f32(gw_s), f32(gw_l),
                                  none, s);
}

// GAT's forward: x [n, heads, wph * 16 bytes] (16-byte aligned, pads zero)
// of elt_size-byte elements; nbr int32 [n, c]; el, er f32 [n, heads].
// Writes lse f32 [n, heads] and out [n, heads * f_real] in x's type.
// Launches on `stream` and returns cudaGetLastError().
extern "C" int etpu_ell_gat(const void* x, int64_t n, int64_t heads,
                            int64_t wph, int elt_size, const void* nbr,
                            int64_t c, const void* el, const void* er,
                            void* lse, void* out, int64_t f_real,
                            void* stream) {
  if (!rows_ok(x, heads, wph, elt_size)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  Gat gat{};
  gat.el = f32(el);
  gat.er = f32(er);
  gat.lse = f32(lse);
  const bool pairs = f_real % 2 == 0 &&
                     reinterpret_cast<uintptr_t>(out) % 4 == 0;
  const int h = static_cast<int>(heads), w = static_cast<int>(wph);
  const int ci = static_cast<int>(c), f = static_cast<int>(f_real);
  return elt_size == 4
      ? launch_agg<false>(x, n, h, w, i32(nbr), ci, ci, out, f, pairs, false,
                          gat, s)
      : launch_agg<true>(x, n, h, w, i32(nbr), ci, ci, out, f, pairs, false,
                         gat, s);
}

// GAT's SDDMM: g and x as etpu_ell_sddmm's; nbr int32 [n, c]; el, er and
// the forward's lse f32 [n, heads]. Writes the scores' gradients de f32
// [n, c, heads] (pads 0) and de_self f32 [n, heads], and d_el f32 [n,
// heads]. Launches on `stream` and returns cudaGetLastError().
extern "C" int etpu_ell_gat_sddmm(const void* g, const void* x, int64_t n,
                                  int64_t heads, int64_t wph, int elt_size,
                                  const void* nbr, int64_t c, const void* el,
                                  const void* er, const void* lse, void* de,
                                  void* de_self, void* d_el, void* stream) {
  if (!rows_ok(x, heads, wph, elt_size) ||
      reinterpret_cast<uintptr_t>(g) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  Gat gat{};
  gat.el = f32(el);
  gat.er = f32(er);
  gat.lse = const_cast<float*>(f32(lse));
  gat.d_el = f32(d_el);
  const int h = static_cast<int>(heads), w = static_cast<int>(wph);
  return elt_size == 4
      ? launch_sddmm<false, true>(g, x, n, h, w, i32(nbr),
                                  static_cast<int>(c), f32(de),
                                  f32(de_self), gat, s)
      : launch_sddmm<true, true>(g, x, n, h, w, i32(nbr),
                                 static_cast<int>(c), f32(de), f32(de_self),
                                 gat, s);
}

// GAT's transpose: g [n, heads, wph * 16 bytes] (16-byte aligned, pads
// zero); tpos int32 [n, width], naming live cells of the forward's [n, c]
// grid only (pads -1); el, er, lse, de_self and
// d_el f32 [n, heads]; de f32 [n, c, heads]; a_l, a_r f32 [heads, f_real].
// Writes the rows' gradient f32 [n, heads * f_real] and d_er f32 [n,
// heads]. Launches on `stream` and returns cudaGetLastError().
extern "C" int etpu_ell_gat_tr(const void* g, int64_t n, int64_t heads,
                               int64_t wph, int elt_size, const void* tpos,
                               int64_t width, int64_t c,
                               const void* el, const void* er,
                               const void* lse, const void* de,
                               const void* de_self, const void* d_el,
                               const void* a_l, const void* a_r, void* out,
                               void* d_er, int64_t f_real, void* stream) {
  if (!rows_ok(g, heads, wph, elt_size)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  Gat gat{};
  gat.el = f32(el);
  gat.er = f32(er);
  gat.lse = const_cast<float*>(f32(lse));
  gat.de = f32(de);
  gat.de_self = f32(de_self);
  gat.d_el = const_cast<float*>(f32(d_el));
  gat.d_er = f32(d_er);
  gat.a_l = f32(a_l);
  gat.a_r = f32(a_r);
  const int h = static_cast<int>(heads), w = static_cast<int>(wph);
  const int ci = static_cast<int>(c), f = static_cast<int>(f_real);
  const int wi = static_cast<int>(width);
  return elt_size == 4
      ? launch_agg<false>(g, n, h, w, i32(tpos), wi, ci, out, f, false, true,
                          gat, s)
      : launch_agg<true>(g, n, h, w, i32(tpos), wi, ci, out, f, false, true,
                         gat, s);
}
