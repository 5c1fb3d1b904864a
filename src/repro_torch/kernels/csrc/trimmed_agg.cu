// Fused coordinate-wise sort + rank-weighted combine for Hopper (sm_90a):
//
//   out[i] = sum_{r < K} rw[r] * sort_asc(x[:, i])[r]
//
// Replaces the TPU kernel src/repro/kernels/trimmed_agg.py::
// trimmed_agg_stacked (Pallas: _make_trimmed_kernel / trimmed_agg_tiles),
// the hot path of the trimmed-mean and median robust aggregators. As there,
// the combine adds in rank order starting from 0.0, one float32 multiply
// then one float32 add per rank (__fmul_rn / __fadd_rn: no FMA), and a rank
// whose weight is exactly 0 is skipped (selected to 0), never multiplied:
// pad rows arrive as +inf and 0 * inf would be NaN. Skipping adds nothing
// else: the sum starts at +0.0 and can never become -0.0, so adding an
// exact 0 is an IEEE no-op.
//
// Order: ascending, NaN after +inf (the order of jnp.sort and torch.sort,
// which the oracle uses). The compare is written out so that a NaN is
// greater than every number; fminf / fmaxf would drop it instead.
//
// Bound: HBM bytes for small K. One launch reads K*n*4 bytes of x and 4K of
// rw and writes n*4 of out, against O(K^2) compares per element that stay
// in registers or L1. Design: one thread per coordinate; a warp reads 32
// neighbouring coordinates of each client row, so every load is coalesced.
//   * K <= 32: the K values go into registers (a compile-time bucket of 4,
//     8, 16 or 32 slots, slots past K filled with NaN so they sort last) and
//     an odd-even transposition network sorts them. Every index is a
//     compile-time constant after unrolling, so nothing spills to local
//     memory.
//   * any K: no per-thread array. The rank-ordered values are walked one
//     successor at a time: the value at rank r is the least (x_j, j) above
//     the one at rank r - 1 under the order (value, then row index), found
//     by one pass over the K rows (re-read through L1). The walk stops at
//     the last rank whose weight is not 0 (the median stops half way).
// K is a runtime argument and rw stays in device memory, so a new cohort
// width or trim needs no rebuild.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;   // 16 resident blocks per SM of an H100

// a strictly after b in ascending order, NaN greatest
__device__ __forceinline__ bool greater(float a, float b) {
  if (isnan(b)) return false;
  return isnan(a) || a > b;
}

// (a, ia) strictly before (b, ib): value order with NaN greatest, then row
__device__ __forceinline__ bool before(float a, int ia, float b, int ib) {
  const bool an = isnan(a), bn = isnan(b);
  if (an != bn) return bn;
  if (!an && a != b) return a < b;
  return ia < ib;
}

__device__ __forceinline__ float add_rank(float acc, float w, float v) {
  return w != 0.0f ? __fadd_rn(acc, __fmul_rn(w, v)) : acc;
}

template <int KB>
__global__ void __launch_bounds__(kThreads)
trimmed_agg_registers(const float* __restrict__ x,
                      const float* __restrict__ rw,
                      float* __restrict__ out, int64_t n, int K) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    float v[KB];
#pragma unroll
    for (int j = 0; j < KB; ++j)
      v[j] = j < K ? __ldg(x + static_cast<int64_t>(j) * n + i)
                   : __int_as_float(0x7fc00000);    // NaN: sorts last
    // odd-even transposition: KB passes sort KB values
#pragma unroll
    for (int p = 0; p < KB; ++p) {
#pragma unroll
      for (int j = p & 1; j + 1 < KB; j += 2) {
        const float a = v[j], b = v[j + 1];
        const bool swap = greater(a, b);
        v[j] = swap ? b : a;
        v[j + 1] = swap ? a : b;
      }
    }
    float acc = 0.0f;
#pragma unroll
    for (int r = 0; r < KB; ++r)
      if (r < K) acc = add_rank(acc, __ldg(rw + r), v[r]);
    out[i] = acc;
  }
}

__global__ void __launch_bounds__(kThreads)
trimmed_agg_any(const float* __restrict__ x, const float* __restrict__ rw,
                float* __restrict__ out, int64_t n, int K) {
  int last = -1;                       // last rank with a weight != 0
  for (int r = K - 1; r >= 0; --r)
    if (__ldg(rw + r) != 0.0f) { last = r; break; }
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    float acc = 0.0f, pv = 0.0f;
    int pj = -1;                       // (pv, pj): the value at rank r - 1
    for (int r = 0; r <= last; ++r) {
      float bv = 0.0f;
      int bj = -1;
      for (int j = 0; j < K; ++j) {
        const float v = __ldg(x + static_cast<int64_t>(j) * n + i);
        if (pj >= 0 && !before(pv, pj, v, j)) continue;
        if (bj < 0 || before(v, j, bv, bj)) { bv = v; bj = j; }
      }
      pv = bv;
      pj = bj;
      acc = add_rank(acc, __ldg(rw + r), bv);
    }
    out[i] = acc;
  }
}

int blocks_for(int64_t work) {
  const int64_t b = (work + kThreads - 1) / kThreads;
  return static_cast<int>(b < kMaxBlocks ? (b > 0 ? b : 1) : kMaxBlocks);
}

}  // namespace

// x (K, n) f32, rw (K,) f32, out (n,) f32; all on the device, contiguous,
// K >= 1. Launches on `stream` and returns cudaGetLastError().
extern "C" int trimmed_agg_stacked(const void* x, const void* rw, void* out,
                                   int64_t n, int K, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0 || K < 1) return static_cast<int>(cudaGetLastError());
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(rw);
  float* of = static_cast<float*>(out);
  const int blocks = blocks_for(n);
  if (K <= 4)
    trimmed_agg_registers<4><<<blocks, kThreads, 0, s>>>(xf, wf, of, n, K);
  else if (K <= 8)
    trimmed_agg_registers<8><<<blocks, kThreads, 0, s>>>(xf, wf, of, n, K);
  else if (K <= 16)
    trimmed_agg_registers<16><<<blocks, kThreads, 0, s>>>(xf, wf, of, n, K);
  else if (K <= 32)
    trimmed_agg_registers<32><<<blocks, kThreads, 0, s>>>(xf, wf, of, n, K);
  else
    trimmed_agg_any<<<blocks, kThreads, 0, s>>>(xf, wf, of, n, K);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* trimmed_agg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
