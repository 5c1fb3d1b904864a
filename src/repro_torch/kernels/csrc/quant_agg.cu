// Fused QuAFL dequantize + accumulate for Hopper (sm_90a), two entry points:
//
//   quant_agg_stacked:  out[i] = acc[i] + sum_{k < K} sw[k] * (float)q[k][i]
//   quant_agg_leaves:   out_l[i] = acc_l[i] + (weight * scale_l) * q_l[i]
//                       for every leaf l of a table (q_l as float)
//
// quant_agg_stacked replaces the TPU kernel
// src/repro/kernels/quant_agg.py::quant_agg_stacked (Pallas:
// _make_stacked_kernel / quant_agg_stacked_tiles). As there, the sum runs
// over k in order starting from acc, and each term is one float32 multiply
// then one float32 add (__fmul_rn / __fadd_rn keep the compiler from
// contracting them into an FMA).
//
// quant_agg_leaves replaces src/repro/kernels/quant_agg.py::quant_agg
// (Pallas: _qagg_kernel / quant_agg_tiles), the single-model step of the
// streamed in-place aggregation, for all leaves of one model in one launch
// (a single tensor is a table of one). weight * scale is formed in float32
// on the device, as _qagg_kernel forms it: the weight is a host float
// passed by value, a leaf's scale either a device pointer (a 0-d tensor
// from the quantizer, never read back by the host) or a host float. out
// may be acc (the in-place update).
//
// Bound: HBM bytes. Per launch the stacked kernel reads n*4 bytes of acc,
// K*n*4 of q and writes n*4 of out, (4K + 8) * n bytes, against 2K flops
// per element; a leaf of the table moves 12 bytes an element. Design: one
// vectorised pass with no dequantised copy of any client model. Each
// thread owns 4 adjacent elements read as float4 / int4 (16-byte loads,
// neighbouring threads on neighbouring addresses). The stacked kernel loops
// over the K client rows in registers and grid-strides over n; sw stays in
// device memory and K is a runtime argument, so a new cohort width needs no
// rebuild. The leaf table travels by value as a kernel parameter (at most
// kMaxLeaves leaves; the wrapper splits a longer model into several
// launches); each leaf owns a run of blocks, and a block finds its leaf in
// the table's cumulative block counts. The TPU's (8, 256) VMEM tiling is
// not carried over. When n is not a multiple of 4 (rows of q then lose
// 16-byte alignment) or a pointer is misaligned, the scalar path does one
// element per thread instead.
#include <cstdint>
#include <cuda_runtime.h>

// One leaf of quant_agg_leaves' table, as the wrapper packs it
// (repro_torch.kernels.quant_agg._LEAF packs this layout). Outside the
// unnamed namespace: the exported entry point takes it.
struct Leaf {
  const float* acc;
  const int* q;
  float* out;                // may equal acc
  const float* scale_ptr;    // device scale, or null: use `scale`
  float scale;
  int vec;                   // 1: n % 4 == 0 and acc, q, out 16-byte aligned
  int64_t n;
};

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;   // 16 resident blocks per SM of an H100
constexpr int kMaxLeaves = 32;   // leaves in one table (a 1.8 KB parameter)

__device__ __forceinline__ float axpy(float a, float w, int v) {
  return __fadd_rn(a, __fmul_rn(w, static_cast<float>(v)));
}

__global__ void __launch_bounds__(kThreads)
quant_agg_vec4(const float4* __restrict__ acc, const int4* __restrict__ q,
               const float* __restrict__ sw, float4* __restrict__ out,
               int64_t n4, int K) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n4; i += stride) {
    float4 a = __ldg(acc + i);
    for (int k = 0; k < K; ++k) {
      const float w = __ldg(sw + k);
      const int4 v = __ldg(q + static_cast<int64_t>(k) * n4 + i);
      a.x = axpy(a.x, w, v.x);
      a.y = axpy(a.y, w, v.y);
      a.z = axpy(a.z, w, v.z);
      a.w = axpy(a.w, w, v.w);
    }
    out[i] = a;
  }
}

__global__ void __launch_bounds__(kThreads)
quant_agg_scalar(const float* __restrict__ acc, const int* __restrict__ q,
                 const float* __restrict__ sw, float* __restrict__ out,
                 int64_t n, int K) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    float a = __ldg(acc + i);
    for (int k = 0; k < K; ++k)
      a = axpy(a, __ldg(sw + k), __ldg(q + static_cast<int64_t>(k) * n + i));
    out[i] = a;
  }
}

struct LeafTable {
  Leaf leaf[kMaxLeaves];
  int64_t block_end[kMaxLeaves];   // cumulative blocks up to each leaf
  float weight;
};

// acc, q and out may alias (in place), so no __restrict__ / __ldg here
__global__ void __launch_bounds__(kThreads)
quant_agg_leaves_kernel(const __grid_constant__ LeafTable T) {
  const int64_t blk = blockIdx.x;
  int li = 0;
  while (blk >= T.block_end[li]) ++li;
  const Leaf& f = T.leaf[li];
  const int64_t i = (blk - (li ? T.block_end[li - 1] : 0)) * kThreads
                    + threadIdx.x;
  // weight * scale, one float32 product, as _qagg_kernel forms it
  const float w = __fmul_rn(T.weight,
                            f.scale_ptr ? *f.scale_ptr : f.scale);
  if (f.vec) {
    if (i < f.n / 4) {
      float4 a = reinterpret_cast<const float4*>(f.acc)[i];
      const int4 v = reinterpret_cast<const int4*>(f.q)[i];
      a.x = axpy(a.x, w, v.x);
      a.y = axpy(a.y, w, v.y);
      a.z = axpy(a.z, w, v.z);
      a.w = axpy(a.w, w, v.w);
      reinterpret_cast<float4*>(f.out)[i] = a;
    }
  } else if (i < f.n) {
    f.out[i] = axpy(f.acc[i], w, f.q[i]);
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

int blocks_for(int64_t work) {
  const int64_t b = (work + kThreads - 1) / kThreads;
  return static_cast<int>(b < kMaxBlocks ? (b > 0 ? b : 1) : kMaxBlocks);
}

}  // namespace

// acc (n,) f32, q (K, n) int32, sw (K,) f32, out (n,) f32; all on the device,
// contiguous. Launches on `stream` and returns cudaGetLastError().
extern "C" int quant_agg_stacked(const void* acc, const void* q,
                                 const void* sw, void* out, int64_t n, int K,
                                 void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n > 0 && n % 4 == 0 && aligned16(acc) && aligned16(q) &&
      aligned16(out)) {
    const int64_t n4 = n / 4;
    quant_agg_vec4<<<blocks_for(n4), kThreads, 0, s>>>(
        static_cast<const float4*>(acc), static_cast<const int4*>(q),
        static_cast<const float*>(sw), static_cast<float4*>(out), n4, K);
  } else if (n > 0) {
    quant_agg_scalar<<<blocks_for(n), kThreads, 0, s>>>(
        static_cast<const float*>(acc), static_cast<const int*>(q),
        static_cast<const float*>(sw), static_cast<float*>(out), n, K);
  }
  return static_cast<int>(cudaGetLastError());
}

// leaves[0 .. count) on the device, count in [1, kMaxLeaves = 32],
// every n > 0, each leaf's acc, q (int32) and out contiguous of n elements
// (vec set only where the 16-byte path applies). One launch on `stream`
// updates them all; returns cudaGetLastError() (cudaErrorInvalidValue for a
// table it does not take).
extern "C" int quant_agg_leaves(const Leaf* leaves, int count, float weight,
                                void* stream) {
  if (count < 1 || count > kMaxLeaves)
    return static_cast<int>(cudaErrorInvalidValue);
  LeafTable T;
  T.weight = weight;
  int64_t blocks = 0;
  for (int l = 0; l < kMaxLeaves; ++l) {
    if (l < count) {
      const Leaf& f = leaves[l];
      if (f.n < 1) return static_cast<int>(cudaErrorInvalidValue);
      T.leaf[l] = f;
      const int64_t units = f.vec ? f.n / 4 : f.n;
      blocks += (units + kThreads - 1) / kThreads;
    } else {
      T.leaf[l] = Leaf{};
    }
    T.block_end[l] = blocks;
  }
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  quant_agg_leaves_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(T);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* quant_agg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
