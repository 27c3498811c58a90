// Weighted in-row neighbor draw over packed fan rows, for Hopper (sm_90a).
//
// Replaces euler_tpu/ops/pallas_fan.py::fan_draw (the Pallas TPU kernel)
// together with the XLA work around it in the K=1 branch of
// euler_tpu/ops/sampling.py::sample_neighbor_fast: the fan-row gather
// (row = max(node, 0) * ET + et), the alias select and the validity mask
// run in one pass.
//
// For each (b, c):
//   slot  = clamp(rz(u1[b,c] * f32(deg)), 0, max(deg - 1, 0))
//   draw  = u2[b,c] < f32bits(prob[slot]) ? kept[slot] : alias[slot]
//   valid = nodes[b] >= 0 && deg > 0 && f32bits(wsum) > 0
//   ids   = valid ? draw : default_id
// with the row layout of euler_tpu_torch/ops/alias.py (lane 0 degree,
// lane 1 weight-sum bits, then 42 prob-bit, 42 kept-id and 42 alias-id
// lanes).
//
// Two epilogues, chosen at compile time so that the plain draw keeps its
// code:
// * union rows (the "fanu" pack, the union branch of sample_neighbor_fast,
//   euler_tpu/ops/sampling.py:276-310): each kept/alias lane packs
//   (etype << 27) | dst, so ids = valid ? draw & FANU_MASK : default_id
//   and, when types are asked for, types = valid ? draw >> 27 : -1, an
//   arithmetic shift of the int32 lane as jnp's >> is. The caller passes
//   the union pack with n_et = 1 and et = 0, so the row is max(node, 0).
// * types of a one-type hop (the K=1 typed case, sampling.py:333-338):
//   types = valid ? et : -1.
//
// The arithmetic is bit-exact against the JAX path: one round-to-nearest
// f32 multiply (__fmul_rn, so no contraction into an FMA), truncation
// toward zero (__float2int_rz), bit reinterpretation of the prob lane
// (__int_as_float), and no --use_fast_math.
//
// Bound: device-memory bytes. Per call the function must move
// B*C*(4+4+4+1) + B*4 bytes (u1, u2, ids, valid, nodes), plus from each
// fan row its 8-byte head and at most C prob/id pairs; it does a handful
// of integer and f32 operations per draw, far below the compute rate.
// That bound counts 4-byte lanes, but the memory moves 32-byte sectors.
// Which costs more, the sectors or the dependent trips to memory, depends
// on the size, so there are two paths:
//
// * Row path (few rows, or many draws a row; hop 1 at B=1,024, C=25).
//   With few rows the card is not filled, so the time is the launch plus
//   the chain of dependent trips. One warp per frontier node: lane 0
//   loads the node id, then each lane loads one 16-byte word of the
//   node's fan row, so the whole 512-byte row arrives in one warp
//   transaction. The warp's uniforms load with it, since they do not
//   depend on the node. The row is staged in shared memory and the lanes
//   take the draws c = lane, lane + 32, ...: two dependent trips (node,
//   row) where a thread per draw makes four (node, head, prob lane, id
//   lane).
// * Draw path (many rows of few draws; hop 2 at B=26,624, C=10). The
//   card is full and the sectors bound it: a whole row is 16 sectors,
//   while a row's 10 draws touch only the sectors of their head, prob
//   lanes and kept-or-alias lanes. One thread per draw reads the 8-byte
//   head, then its prob lane, then the one id lane it keeps, with 32-bit
//   index arithmetic where B * C allows it.
//
// etpu_fan_draw takes the draw path where B > kRowPathMaxRows and
// C <= kDrawPathMaxCount, and the row path elsewhere. chip_smoke.py times
// both paths at B = 1,024 ... 26,624 and C = 10, 15, 20, 25 on an H100:
// the row path was faster at every C up to 4,096 rows and at C = 25
// everywhere; above 4,096 rows the draw path was faster at C = 10 and 15,
// and at C = 20 each path won at some B by 1-3% (PERF.md).
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kFanD = 42;
constexpr int kFanLanes = 128;
constexpr int kProbOff = 2;
constexpr int kKeptOff = kProbOff + kFanD;
constexpr int kAliasOff = kKeptOff + kFanD;
constexpr int kRowWarps = 4;     // warps per block of the row path
constexpr int kPre = 2;          // draws per lane whose uniforms load early
constexpr int kDrawThreads = 256;
constexpr int64_t kRowPathMaxRows = 4096;  // the row path up to this B,
constexpr int kDrawPathMaxCount = 20;      // and above it for larger C
constexpr int kFanuShift = 27;             // ops/alias.py FANU_SHIFT
constexpr int32_t kFanuMask = (int32_t{1} << kFanuShift) - 1;
constexpr unsigned kAll = 0xffffffffu;

// Where a draw's results go: ids and valid always, types when asked for.
struct Out {
  int32_t* ids;
  bool* valid;
  int32_t* types;
};

// The epilogue of draw i: kUnion decodes a union lane, kTypes writes the
// draw's edge type (the decoded one, or the hop's et).
template <bool kUnion, bool kTypes, typename I>
__device__ __forceinline__ void put(const Out& o, I i, int32_t pick,
                                    bool ok, int default_id, int et) {
  o.ids[i] = ok ? (kUnion ? (pick & kFanuMask) : pick) : default_id;
  o.valid[i] = ok;
  if (kTypes) o.types[i] = ok ? (kUnion ? (pick >> kFanuShift) : et) : -1;
}

// The in-row draw from a staged row p; returns the picked lane.
__device__ __forceinline__ int32_t draw(const int32_t* p, int32_t node,
                                        float x1, float x2, bool* ok_out) {
  const int32_t deg = p[0];
  const float wsum = __int_as_float(p[1]);
  int slot = __float2int_rz(__fmul_rn(x1, static_cast<float>(deg)));
  slot = min(max(slot, 0), max(deg - 1, 0));
  slot = min(slot, kFanD - 1);  // stay inside the row whatever lane 0 says
  const float prob = __int_as_float(p[kProbOff + slot]);
  *ok_out = node >= 0 && deg > 0 && wsum > 0.0f;
  return x2 < prob ? p[kKeptOff + slot] : p[kAliasOff + slot];
}

// an out-of-range row is clamped, as XLA clamps a gather index
__device__ __forceinline__ int64_t fan_row(int32_t node, int et, int n_et,
                                           int64_t n_rows) {
  const int64_t row = static_cast<int64_t>(max(node, 0)) * n_et + et;
  return min(row, n_rows - 1);
}

// One warp per node b; the draws of b are c = lane, lane + 32, ...
template <bool kUnion, bool kTypes>
__global__ void __launch_bounds__(kRowWarps * 32)
fan_draw_row_kernel(const int4* __restrict__ fan_pack, int64_t n_rows,
                    const int32_t* __restrict__ nodes, int64_t n_nodes,
                    int count, int et, int n_et, const float* __restrict__ u1,
                    const float* __restrict__ u2, int default_id, Out out) {
  __shared__ int4 stage[kRowWarps][kFanLanes / 4];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int64_t b = static_cast<int64_t>(blockIdx.x) * kRowWarps + w;
  if (b >= n_nodes) return;  // the whole warp leaves together
  const int64_t first = b * count;

  const int32_t node = __shfl_sync(kAll, lane == 0 ? nodes[b] : 0, 0);
  float x1[kPre], x2[kPre];
#pragma unroll
  for (int k = 0; k < kPre; ++k) {
    const int c = lane + 32 * k;
    x1[k] = c < count ? u1[first + c] : 0.0f;
    x2[k] = c < count ? u2[first + c] : 0.0f;
  }
  const int64_t row = fan_row(node, et, n_et, n_rows);
  stage[w][lane] = __ldg(fan_pack + row * (kFanLanes / 4) + lane);
  __syncwarp();

  const int32_t* p = reinterpret_cast<const int32_t*>(stage[w]);
  bool ok;
#pragma unroll
  for (int k = 0; k < kPre; ++k) {
    const int c = lane + 32 * k;
    if (c < count) {
      const int32_t pick = draw(p, node, x1[k], x2[k], &ok);
      put<kUnion, kTypes>(out, first + c, pick, ok, default_id, et);
    }
  }
  for (int c = lane + 32 * kPre; c < count; c += 32) {
    const int32_t pick = draw(p, node, u1[first + c], u2[first + c], &ok);
    put<kUnion, kTypes>(out, first + c, pick, ok, default_id, et);
  }
}

// One thread per draw i = b * count + c; I is the index type, uint32_t
// where B * C < 2^32, else int64_t.
template <typename I, bool kUnion, bool kTypes>
__global__ void __launch_bounds__(kDrawThreads)
fan_draw_each_kernel(const int32_t* __restrict__ fan_pack, int64_t n_rows,
                     const int32_t* __restrict__ nodes, I n_draws, I count,
                     int et, int n_et, const float* __restrict__ u1,
                     const float* __restrict__ u2, int default_id, Out out) {
  const I i = static_cast<I>(blockIdx.x) * kDrawThreads + threadIdx.x;
  if (i >= n_draws) return;
  const float x1 = __ldg(u1 + i);
  const float x2 = __ldg(u2 + i);
  const int32_t node = __ldg(nodes + i / count);
  const int32_t* p = fan_pack + fan_row(node, et, n_et, n_rows) * kFanLanes;
  const int32_t deg = __ldg(p);
  const float wsum = __int_as_float(__ldg(p + 1));
  int slot = __float2int_rz(__fmul_rn(x1, static_cast<float>(deg)));
  slot = min(max(slot, 0), max(deg - 1, 0));
  slot = min(slot, kFanD - 1);  // stay inside the row whatever lane 0 says
  const float prob = __int_as_float(__ldg(p + kProbOff + slot));
  const int32_t pick = __ldg(p + (x2 < prob ? kKeptOff : kAliasOff) + slot);
  const bool ok = node >= 0 && deg > 0 && wsum > 0.0f;
  put<kUnion, kTypes>(out, i, pick, ok, default_id, et);
}

// Both paths of one epilogue: path 1 = the row path, else the draw path.
template <bool kUnion, bool kTypes>
void launch(bool row_path, const void* fan_pack, int64_t n_rows,
            const void* nodes, int64_t n_nodes, int count, int et, int n_et,
            const void* u1, const void* u2, int default_id, const Out& out,
            cudaStream_t stream) {
  const auto* x1 = static_cast<const float*>(u1);
  const auto* x2 = static_cast<const float*>(u2);
  const auto* nd = static_cast<const int32_t*>(nodes);
  if (row_path) {
    const int64_t blocks = (n_nodes + kRowWarps - 1) / kRowWarps;
    fan_draw_row_kernel<kUnion, kTypes>
        <<<static_cast<unsigned>(blocks), kRowWarps * 32, 0, stream>>>(
            static_cast<const int4*>(fan_pack), n_rows, nd, n_nodes, count,
            et, n_et, x1, x2, default_id, out);
    return;
  }
  const int64_t n_draws = n_nodes * count;
  const auto* pack = static_cast<const int32_t*>(fan_pack);
  const auto blocks = static_cast<unsigned>(
      (n_draws + kDrawThreads - 1) / kDrawThreads);
  if (n_draws < (int64_t{1} << 32)) {
    fan_draw_each_kernel<uint32_t, kUnion, kTypes>
        <<<blocks, kDrawThreads, 0, stream>>>(
            pack, n_rows, nd, static_cast<uint32_t>(n_draws),
            static_cast<uint32_t>(count), et, n_et, x1, x2, default_id, out);
  } else {
    fan_draw_each_kernel<int64_t, kUnion, kTypes>
        <<<blocks, kDrawThreads, 0, stream>>>(
            pack, n_rows, nd, n_draws, int64_t{count}, et, n_et, x1, x2,
            default_id, out);
  }
}

}  // namespace

// The draw with its path named: 0 = by shape (above), 1 = the row path,
// 2 = the draw path. The row path loads 16-byte words, so path 0 takes
// the draw path for a fan_pack that is not 16-byte aligned, and path 1
// returns cudaErrorMisalignedAddress for one. `types` (int32 [B, C]) may
// be null: then no types are written. `union_rows` != 0 decodes union
// lanes (see the top of this file). Launches on `stream` and returns
// cudaGetLastError() (0 = launched).
extern "C" int etpu_fan_draw_path(const void* fan_pack, int64_t n_rows,
                                  const void* nodes, int64_t n_nodes,
                                  int count, int et, int n_et,
                                  const void* u1, const void* u2,
                                  int default_id, void* ids, void* valid,
                                  void* types, int union_rows, void* stream,
                                  int path) {
  if (path < 0 || path > 2) return static_cast<int>(cudaErrorInvalidValue);
  if (n_nodes * count == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool aligned = reinterpret_cast<uintptr_t>(fan_pack) % 16 == 0;
  if (path == 1 && !aligned) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  const bool rows_win =
      n_nodes <= kRowPathMaxRows || count > kDrawPathMaxCount;
  const bool row_path = path == 1 || (path == 0 && aligned && rows_win);
  const Out out{static_cast<int32_t*>(ids), static_cast<bool*>(valid),
                static_cast<int32_t*>(types)};
  const bool typed = types != nullptr;
  if (union_rows && typed) {
    launch<true, true>(row_path, fan_pack, n_rows, nodes, n_nodes, count, et,
                       n_et, u1, u2, default_id, out, s);
  } else if (union_rows) {
    launch<true, false>(row_path, fan_pack, n_rows, nodes, n_nodes, count,
                        et, n_et, u1, u2, default_id, out, s);
  } else if (typed) {
    launch<false, true>(row_path, fan_pack, n_rows, nodes, n_nodes, count,
                        et, n_et, u1, u2, default_id, out, s);
  } else {
    launch<false, false>(row_path, fan_pack, n_rows, nodes, n_nodes, count,
                         et, n_et, u1, u2, default_id, out, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// The draw the port runs: etpu_fan_draw_path with path 0.
extern "C" int etpu_fan_draw(const void* fan_pack, int64_t n_rows,
                             const void* nodes, int64_t n_nodes, int count,
                             int et, int n_et, const void* u1,
                             const void* u2, int default_id, void* ids,
                             void* valid, void* types, int union_rows,
                             void* stream) {
  return etpu_fan_draw_path(fan_pack, n_rows, nodes, n_nodes, count, et,
                            n_et, u1, u2, default_id, ids, valid, types,
                            union_rows, stream, 0);
}
