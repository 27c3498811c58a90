// Masked mean sigmoid cross-entropy of the supervised head, and its
// gradient, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package's SuperviseModel leaves
// tf.nn.sigmoid_cross_entropy_with_logits and its gradient to XLA, which
// fuses them. The port ran them as about ten PyTorch elementwise ops each
// way over the [R, C] logits, each reading or writing a whole f32 tensor,
// with autograd keeping their inputs. Here, for logits x, labels y and a
// row weight valid[r] (1 for a root, 0 for padding):
//
//   forward:   loss = sum over r, c of valid[r] l(x[r, c], y[r, c]) / den
//              l(x, y) = max(x, 0) - x y + log1p(exp(-|x|))
//              den = max(C * sum over r of valid[r], 1)
//   backward:  d[r, c] = (-s(x) (g_r / (1 + e)) e - g_r y) + m(x) g_r
//              g_r = (upstream gradient / den) valid[r], e = exp(-|x|)
//              m(x) = 1, 1/2, 0 for x >, =, < 0 (maximum splits its tie)
//              s(x) = 1 for x >= 0, else -1 (|x|'s slope at 0 is XLA's 1)
//
// which is autograd's gradient of the plain expression term by term and
// in the order autograd adds the terms (ops/sigmoid_xent.py), ties
// included: at x = 0 it is -g_r y, not the textbook (1/2 - y) g_r. The
// products are rounded on their own (__fmul_rn, no fused multiply-add),
// as PyTorch rounds them.
//
// Bound: device-memory bytes. The forward reads x and y once (8 bytes an
// f32 element), the backward reads them again and writes d (12); the
// arithmetic (accurate expf and log1pf, one division) is a few tens of
// instructions an element, under the bytes on an H100. A thread takes 4
// consecutive elements of the row-major [R, C] order at a time (a quad):
// x as one 16-byte load, y as one 16-byte (f32) or 8-byte (bf16) load,
// where the layout allows it (the rows back to back, row stride C, or C
// and the row stride multiples of 4, so that no quad leaves its row;
// base aligned), and else element by element at its row and column. C is
// any width (odd: 349 classes), so a quad may span two rows; a thread
// steps its row and column by constants, with no division a quad.
//
// The forward's sum is f32 in a fixed order with no atomics: block b of
// B takes rows [b R / B, (b + 1) R / B), each thread its quads in order,
// then the block's threads by shuffles and shared memory in a fixed
// order, into partial[2 b] (and the valid sum of those rows into
// partial[2 b + 1]); a second kernel, one block, adds the B pairs in
// order and writes the loss and den. B depends only on the device and the
// shape, so a call gives the same bits every time. The backward writes
// each element once and sums nothing.
//
// Byte offsets are int64: R C passes 2^31 at a few million roots.
#include <cstdint>

#include <cuda_runtime.h>

#include "bf16_words.cuh"
#include "resident_blocks.cuh"

namespace {

constexpr int kThreads = 256;     // threads per block
constexpr int kMaxBlocks = 2048;  // partial pairs (sigmoid_xent.py MAX_BLOCKS)
constexpr unsigned kAll = 0xffffffffu;

struct Args {
  const float* x;      // logits, f32, unit column stride
  int64_t xs;          // x's row stride, elements
  const void* y;       // labels, f32 or bf16, unit column stride
  int64_t ys;          // y's row stride, elements
  const float* valid;  // [R]
  int64_t rows, cols;
  bool vx, vy;         // quad loads allowed for x, y
};

__device__ __forceinline__ float label(float v) { return v; }
__device__ __forceinline__ float label(uint16_t v) {
  return __uint_as_float(static_cast<uint32_t>(v) << 16);
}

// Four labels of element type Y from one load.
template <typename Y> struct Quad;
template <> struct Quad<float> {
  static __device__ __forceinline__ void load(const float* p, float* y) {
    const float4 w = *reinterpret_cast<const float4*>(p);
    y[0] = w.x; y[1] = w.y; y[2] = w.z; y[3] = w.w;
  }
};
template <> struct Quad<uint16_t> {
  static __device__ __forceinline__ void load(const uint16_t* p, float* y) {
    const uint2 w = *reinterpret_cast<const uint2*>(p);
    y[0] = etpu::lo_bf16(w.x); y[1] = etpu::hi_bf16(w.x);
    y[2] = etpu::lo_bf16(w.y); y[3] = etpu::hi_bf16(w.y);
  }
};

// The quad of flat elements i0 .. i0 + 3, i0 at row r0 and column c0:
// x, y and the row weight v of each element in [lo, hi); the others read
// 0, 0 and a weight of 0.
template <typename Y>
__device__ __forceinline__ void load_quad(const Args& a, int64_t i0,
                                          int64_t r0, int64_t c0, int64_t lo,
                                          int64_t hi, float* x, float* y,
                                          float* v) {
  const Y* yp = static_cast<const Y*>(a.y);
  int64_t rk[4], ck[4];
  int64_t r = r0, c = c0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    rk[k] = r;
    ck[k] = c;
    if (++c == a.cols) {
      c = 0;
      ++r;
    }
  }
  const bool full = i0 >= lo && i0 + 4 <= hi;
  if (full && a.vx) {
    const float4 w = *reinterpret_cast<const float4*>(a.x + r0 * a.xs + c0);
    x[0] = w.x; x[1] = w.y; x[2] = w.z; x[3] = w.w;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const bool live = i0 + k >= lo && i0 + k < hi;
      x[k] = live ? a.x[rk[k] * a.xs + ck[k]] : 0.0f;
    }
  }
  if (full && a.vy) {
    Quad<Y>::load(yp + r0 * a.ys + c0, y);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const bool live = i0 + k >= lo && i0 + k < hi;
      y[k] = live ? label(yp[rk[k] * a.ys + ck[k]]) : 0.0f;
    }
  }
  const float v0 = __ldg(a.valid + r0);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const bool live = i0 + k >= lo && i0 + k < hi;
    v[k] = !live ? 0.0f : rk[k] == r0 ? v0 : __ldg(a.valid + rk[k]);
  }
}

// l(x, y) as the plain expression takes it: (max(x, 0) - x y) + log1p(e).
__device__ __forceinline__ float xent(float x, float y) {
  return (fmaxf(x, 0.0f) - __fmul_rn(x, y)) + log1pf(expf(-fabsf(x)));
}

// d l / d x times g, the three terms' gradients added as autograd adds
// them: the log term's, the product's, then maximum's.
__device__ __forceinline__ float xent_grad(float x, float y, float g) {
  const float e = expf(-fabsf(x));
  const float t3 = __fmul_rn(g / (1.0f + e), e);
  const float t1 = x > 0.0f ? g : x == 0.0f ? 0.5f * g : 0.0f;
  return ((x >= 0.0f ? -t3 : t3) - __fmul_rn(g, y)) + t1;
}

// The block's sum of v (thread 0 holds it): shuffles within each warp,
// then the warps' sums in order.
__device__ __forceinline__ float block_sum(float v, float* warp_sums) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(kAll, v, off);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.0f;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) s += warp_sums[w];
  }
  __syncthreads();
  return s;
}

// (row, column) of flat element i0, and the constant step of a thread
// that moves `stride` quads at a time.
struct Walk {
  int64_t r, c, dr, dc;
  __device__ Walk(int64_t i0, int64_t stride, int64_t cols) {
    r = i0 / cols;
    c = i0 - r * cols;
    dr = 4 * stride / cols;
    dc = 4 * stride - dr * cols;
  }
  __device__ __forceinline__ void next(int64_t cols) {
    r += dr;
    c += dc;
    if (c >= cols) {
      c -= cols;
      ++r;
    }
  }
};

template <typename Y>
__global__ void __launch_bounds__(kThreads)
    sigmoid_xent_kernel(Args a, float* __restrict__ partial) {
  __shared__ float warp_sums[kThreads / 32];
  const int64_t B = gridDim.x, b = blockIdx.x;
  const int64_t r_lo = a.rows * b / B, r_hi = a.rows * (b + 1) / B;
  const int64_t lo = r_lo * a.cols, hi = r_hi * a.cols;
  float acc = 0.0f;
  if (hi > lo) {
    const int64_t q_hi = (hi + 3) >> 2;
    int64_t q = (lo >> 2) + threadIdx.x;
    Walk at(4 * q, kThreads, a.cols);
    for (; q < q_hi; q += kThreads, at.next(a.cols)) {
      float x[4], y[4], v[4];
      load_quad<Y>(a, 4 * q, at.r, at.c, lo, hi, x, y, v);
#pragma unroll
      for (int k = 0; k < 4; ++k) acc += xent(x[k], y[k]) * v[k];
    }
  }
  float vs = 0.0f;
  for (int64_t r = r_lo + threadIdx.x; r < r_hi; r += kThreads) {
    vs += __ldg(a.valid + r);
  }
  acc = block_sum(acc, warp_sums);
  vs = block_sum(vs, warp_sums);
  if (threadIdx.x == 0) {
    partial[2 * b] = acc;
    partial[2 * b + 1] = vs;
  }
}

// The B pairs added in order; loss = sum / den, den = max(C * valid, 1).
__global__ void __launch_bounds__(kThreads)
    xent_total_kernel(const float* __restrict__ partial, int n_blocks,
                      float cols, float* loss, float* den) {
  __shared__ float warp_sums[kThreads / 32];
  float s = 0.0f, vs = 0.0f;
  for (int b = threadIdx.x; b < n_blocks; b += kThreads) {
    s += partial[2 * b];
    vs += partial[2 * b + 1];
  }
  s = block_sum(s, warp_sums);
  vs = block_sum(vs, warp_sums);
  if (threadIdx.x == 0) {
    const float d = fmaxf(vs * cols, 1.0f);
    *den = d;
    *loss = s / d;
  }
}

template <typename Y>
__global__ void __launch_bounds__(kThreads)
    sigmoid_xent_grad_kernel(Args a, const float* __restrict__ upstream,
                             const float* __restrict__ den,
                             float* __restrict__ d, bool vd) {
  const float g = __ldg(upstream) / __ldg(den);
  const int64_t n = a.rows * a.cols, nq = (n + 3) >> 2;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  int64_t q = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  Walk at(4 * q, stride, a.cols);
  for (; q < nq; q += stride, at.next(a.cols)) {
    float x[4], y[4], v[4], out[4];
    const int64_t i0 = 4 * q;
    load_quad<Y>(a, i0, at.r, at.c, 0, n, x, y, v);
#pragma unroll
    for (int k = 0; k < 4; ++k) out[k] = xent_grad(x[k], y[k], g * v[k]);
    if (vd && i0 + 4 <= n) {
      *reinterpret_cast<float4*>(d + i0) =
          make_float4(out[0], out[1], out[2], out[3]);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (i0 + k < n) d[i0 + k] = out[k];
      }
    }
  }
}

// Blocks of `Kernel` for `quads` quads: at most as many as the device
// holds at once, as the quads fill, and `cap`.
template <auto Kernel>
unsigned grid_for(int64_t quads, int64_t cap) {
  int64_t n = (quads + kThreads - 1) / kThreads;
  const int64_t resident = etpu::resident_blocks<Kernel, kThreads>();
  if (n > resident) n = resident;
  if (n > cap) n = cap;
  return static_cast<unsigned>(n < 1 ? 1 : n);
}

// Whether a quad of a tensor of row stride `stride` at `p` may be one
// load of `bytes` bytes: its rows back to back, or no quad leaving its
// row, and the base aligned.
bool quad_loads(const void* p, int64_t stride, int64_t cols, int bytes) {
  const bool rows_ok = stride == cols || (cols % 4 == 0 && stride % 4 == 0);
  return rows_ok && reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

Args make_args(const void* x, int64_t xs, const void* y, int64_t ys,
               int y_elt, const void* valid, int64_t rows, int64_t cols) {
  Args a;
  a.x = static_cast<const float*>(x);
  a.xs = xs;
  a.y = y;
  a.ys = ys;
  a.valid = static_cast<const float*>(valid);
  a.rows = rows;
  a.cols = cols;
  a.vx = quad_loads(x, xs, cols, 16);
  a.vy = quad_loads(y, ys, cols, 4 * y_elt);
  return a;
}

template <typename Y>
int forward(const Args& a, float* partial, float* loss, float* den,
            cudaStream_t s) {
  int n_blocks = 0;
  const int64_t n = a.rows * a.cols;
  if (n > 0) {
    const unsigned B = grid_for<sigmoid_xent_kernel<Y>>(
        (n + 3) >> 2, a.rows < kMaxBlocks ? a.rows : kMaxBlocks);
    sigmoid_xent_kernel<Y><<<B, kThreads, 0, s>>>(a, partial);
    n_blocks = static_cast<int>(B);
  }
  xent_total_kernel<<<1, kThreads, 0, s>>>(partial, n_blocks,
                                           static_cast<float>(a.cols), loss,
                                           den);
  return static_cast<int>(cudaGetLastError());
}

template <typename Y>
int backward(const Args& a, const float* upstream, const float* den,
             float* d, cudaStream_t s) {
  const int64_t n = a.rows * a.cols;
  if (n == 0) return 0;
  const bool vd = reinterpret_cast<uintptr_t>(d) % 16 == 0;
  sigmoid_xent_grad_kernel<Y>
      <<<grid_for<sigmoid_xent_grad_kernel<Y>>((n + 3) >> 2, INT32_MAX),
         kThreads, 0, s>>>(a, upstream, den, d, vd);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The forward: x f32 [rows, cols] at row stride xs, y [rows, cols] of
// y_elt-byte elements (4: f32, 2: bf16) at row stride ys, both with unit
// column stride; valid f32 [rows]; partial f32 [2 * 2048] scratch; loss
// and den one f32 each. Launches the partial sums (where rows * cols > 0)
// and the total on `stream` and returns cudaGetLastError() (0 =
// launched); a y_elt other than 2 or 4 returns cudaErrorInvalidValue.
extern "C" int etpu_sigmoid_xent(const void* x, int64_t xs, const void* y,
                                 int64_t ys, int y_elt, const void* valid,
                                 int64_t rows, int64_t cols, void* partial,
                                 void* loss, void* den, void* stream) {
  if (y_elt != 2 && y_elt != 4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a = make_args(x, xs, y, ys, y_elt, valid, rows, cols);
  auto* p = static_cast<float*>(partial);
  auto* l = static_cast<float*>(loss);
  auto* d = static_cast<float*>(den);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return y_elt == 2 ? forward<uint16_t>(a, p, l, d, s)
                    : forward<float>(a, p, l, d, s);
}

// The backward: x, y, valid as the forward's; upstream the loss's
// gradient and den the forward's, one f32 each on the device; d f32
// [rows, cols] contiguous, written whole. Returns as etpu_sigmoid_xent.
extern "C" int etpu_sigmoid_xent_grad(const void* x, int64_t xs,
                                      const void* y, int64_t ys, int y_elt,
                                      const void* valid, int64_t rows,
                                      int64_t cols, const void* upstream,
                                      const void* den, void* d,
                                      void* stream) {
  if (y_elt != 2 && y_elt != 4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a = make_args(x, xs, y, ys, y_elt, valid, rows, cols);
  const auto* u = static_cast<const float*>(upstream);
  const auto* dn = static_cast<const float*>(den);
  auto* out = static_cast<float*>(d);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return y_elt == 2 ? backward<uint16_t>(a, u, dn, out, s)
                    : backward<float>(a, u, dn, out, s);
}
