// Fused QuAFL dequantize + accumulate for Hopper (sm_90a), two entry points:
//
//   quant_agg_stacked:  out[i] = acc[i] + sum_{k < K} sw[k] * (float)q[k][i]
//   quant_agg:          out[i] = acc[i] + (ws[0] * ws[1]) * (float)q[i]
//
// quant_agg_stacked replaces the TPU kernel
// src/repro/kernels/quant_agg.py::quant_agg_stacked (Pallas:
// _make_stacked_kernel / quant_agg_stacked_tiles). As there, the sum runs
// over k in order starting from acc, and each term is one float32 multiply
// then one float32 add (__fmul_rn / __fadd_rn keep the compiler from
// contracting them into an FMA).
//
// quant_agg replaces src/repro/kernels/quant_agg.py::quant_agg (Pallas:
// _qagg_kernel / quant_agg_tiles), the single-model step of the streamed
// in-place aggregation: it is the stacked kernel at K = 1, with the
// weight * scale product formed once in float32 from a 2-float device
// array ws = [weight, scale], as _qagg_kernel forms it. A scale that lives
// on the device (a 0-d tensor from the quantizer) is thus never read back
// by the host.
//
// Bound: HBM bytes. Per launch the stacked kernel reads n*4 bytes of acc,
// K*n*4 of q and writes n*4 of out, (4K + 8) * n bytes, against 2K flops
// per element. Design: one vectorised pass with no dequantised copy of any
// client model. Each thread owns 4 adjacent elements read as float4 / int4
// (16-byte loads, neighbouring threads on neighbouring addresses), loops
// over the K client rows in registers, and grid-strides over n. sw stays in
// device memory and K is a runtime argument, so a new cohort width needs no
// rebuild. The TPU's (8, 256) VMEM tiling is not carried over. When n is not
// a multiple of 4 (rows of q then lose 16-byte alignment) or a pointer is
// misaligned, the scalar kernel does one element per thread instead.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;   // 16 resident blocks per SM of an H100

__device__ __forceinline__ float axpy(float a, float w, int v) {
  return __fadd_rn(a, __fmul_rn(w, static_cast<float>(v)));
}

// kPair: sw is [weight, scale] and K is 1; the one client weight is their
// float32 product. Otherwise sw holds the K per-client weights.
template <bool kPair>
__device__ __forceinline__ float client_weight(const float* sw, int k) {
  return kPair ? __fmul_rn(__ldg(sw), __ldg(sw + 1)) : __ldg(sw + k);
}

template <bool kPair>
__global__ void __launch_bounds__(kThreads)
quant_agg_vec4(const float4* __restrict__ acc, const int4* __restrict__ q,
               const float* __restrict__ sw, float4* __restrict__ out,
               int64_t n4, int K) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n4; i += stride) {
    float4 a = __ldg(acc + i);
    for (int k = 0; k < K; ++k) {
      const float w = client_weight<kPair>(sw, k);
      const int4 v = __ldg(q + static_cast<int64_t>(k) * n4 + i);
      a.x = axpy(a.x, w, v.x);
      a.y = axpy(a.y, w, v.y);
      a.z = axpy(a.z, w, v.z);
      a.w = axpy(a.w, w, v.w);
    }
    out[i] = a;
  }
}

template <bool kPair>
__global__ void __launch_bounds__(kThreads)
quant_agg_scalar(const float* __restrict__ acc, const int* __restrict__ q,
                 const float* __restrict__ sw, float* __restrict__ out,
                 int64_t n, int K) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    float a = __ldg(acc + i);
    for (int k = 0; k < K; ++k)
      a = axpy(a, client_weight<kPair>(sw, k),
               __ldg(q + static_cast<int64_t>(k) * n + i));
    out[i] = a;
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

int blocks_for(int64_t work) {
  const int64_t b = (work + kThreads - 1) / kThreads;
  return static_cast<int>(b < kMaxBlocks ? (b > 0 ? b : 1) : kMaxBlocks);
}

template <bool kPair>
int launch(const void* acc, const void* q, const void* sw, void* out,
           int64_t n, int K, cudaStream_t s) {
  if (n > 0 && n % 4 == 0 && aligned16(acc) && aligned16(q) &&
      aligned16(out)) {
    const int64_t n4 = n / 4;
    quant_agg_vec4<kPair><<<blocks_for(n4), kThreads, 0, s>>>(
        static_cast<const float4*>(acc), static_cast<const int4*>(q),
        static_cast<const float*>(sw), static_cast<float4*>(out), n4, K);
  } else if (n > 0) {
    quant_agg_scalar<kPair><<<blocks_for(n), kThreads, 0, s>>>(
        static_cast<const float*>(acc), static_cast<const int*>(q),
        static_cast<const float*>(sw), static_cast<float*>(out), n, K);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// acc (n,) f32, q (K, n) int32, sw (K,) f32, out (n,) f32; all on the device,
// contiguous. Launches on `stream` and returns cudaGetLastError().
extern "C" int quant_agg_stacked(const void* acc, const void* q,
                                 const void* sw, void* out, int64_t n, int K,
                                 void* stream) {
  return launch<false>(acc, q, sw, out, n, K,
                       static_cast<cudaStream_t>(stream));
}

// acc (n,) f32, q (n,) int32, ws (2,) f32 = [weight, scale], out (n,) f32;
// all on the device, contiguous. Launches on `stream` and returns
// cudaGetLastError().
extern "C" int quant_agg(const void* acc, const void* q, const void* ws,
                         void* out, int64_t n, void* stream) {
  return launch<true>(acc, q, ws, out, n, 1,
                      static_cast<cudaStream_t>(stream));
}

extern "C" const char* quant_agg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
