// Fused QuAFL dequantize + accumulate for Hopper (sm_90a), two entry points,
// each over a table of leaves (a single tensor is a table of one):
//
//   quant_agg_stacked: out_l[i] = acc_l[i] + sum_{k<K} sw_l[k] * q_l[k][i]
//   quant_agg_leaves:  out_l[i] = acc_l[i] + (weight * scale_l) * q_l[i]
//
// for every leaf l of a table, q as float.
//
// quant_agg_stacked replaces the TPU kernel
// src/repro/kernels/quant_agg.py::quant_agg_stacked (Pallas:
// _make_stacked_kernel / quant_agg_stacked_tiles), for every leaf of one
// quantized cohort in one launch: K client rows of one leaf, sw_l its K
// weight*scale products, K shared by the table. As there, the sum runs
// over k in order starting from acc, and each term is one float32 multiply
// then one float32 add (__fmul_rn / __fadd_rn keep the compiler from
// contracting them into an FMA), so a table computes bitwise what one
// launch per leaf computes.
//
// quant_agg_leaves replaces src/repro/kernels/quant_agg.py::quant_agg
// (Pallas: _qagg_kernel / quant_agg_tiles), the single-model step of the
// streamed in-place aggregation, for all leaves of one model in one launch.
// weight * scale is formed in float32 on the device, as _qagg_kernel forms
// it: the weight is a host float passed by value, a leaf's scale either a
// device pointer (a 0-d tensor from the quantizer, never read back by the
// host) or a host float.
//
// Bound: HBM bytes. A stacked leaf reads n*4 bytes of acc, K*n*4 of q and
// writes n*4 of out, (4K + 8) * n bytes, against 2K flops per element; a
// leaf of quant_agg_leaves moves 12 bytes an element. Design: one
// vectorised pass with no dequantised copy of any client model. Each
// thread owns 4 adjacent elements read as float4 / int4 (16-byte loads,
// neighbouring threads on neighbouring addresses) and loops over the K
// client rows in registers; sw stays in device memory and K is a runtime
// argument, so a new cohort width needs no rebuild. A table travels by
// value as a __grid_constant__ kernel parameter (at most kMaxLeaves leaves;
// the wrapper splits a longer list into several launches); each leaf owns
// a run of blocks, and a block finds its leaf in the table's cumulative
// block counts. The per-leaf host work of a launch (checks, packing, the
// launch itself) is paid once per table. The TPU's (8, 256) VMEM tiling is
// not carried over. A leaf whose n is not a multiple of 4 (rows of q then
// lose 16-byte alignment) or whose pointers are misaligned takes the
// scalar path, one element per thread. out may equal acc (in place), so
// acc and out are read and written without __restrict__ / __ldg.
#include <cstdint>
#include <cuda_runtime.h>

// One leaf of quant_agg_stacked's table, as the wrapper packs it
// (repro_torch.kernels.quant_agg._STACKED_LEAF packs this layout).
// Outside the unnamed namespace: the exported entry point takes it.
struct StackedLeaf {
  const float* acc;
  const int* q;              // (K, n)
  const float* sw;           // (K,)
  float* out;                // may equal acc
  int64_t n;
  int vec;                   // 1: n % 4 == 0 and acc, q, out 16-byte aligned
  int pad;
};

// One leaf of quant_agg_leaves' table, as the wrapper packs it
// (repro_torch.kernels.quant_agg._LEAF packs this layout).
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
constexpr int kMaxLeaves = 32;   // leaves in one table (a 1.8 KB parameter)

__device__ __forceinline__ float axpy(float a, float w, int v) {
  return __fadd_rn(a, __fmul_rn(w, static_cast<float>(v)));
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

struct StackedTable {
  StackedLeaf leaf[kMaxLeaves];
  int64_t block_end[kMaxLeaves];   // cumulative blocks up to each leaf
  int K;
};

__global__ void __launch_bounds__(kThreads)
quant_agg_stacked_kernel(const __grid_constant__ StackedTable T) {
  const int64_t blk = blockIdx.x;
  int li = 0;
  while (blk >= T.block_end[li]) ++li;
  const StackedLeaf& f = T.leaf[li];
  const int64_t i = (blk - (li ? T.block_end[li - 1] : 0)) * kThreads
                    + threadIdx.x;
  if (f.vec) {
    const int64_t n4 = f.n / 4;
    if (i < n4) {
      float4 a = reinterpret_cast<const float4*>(f.acc)[i];
      const int4* q = reinterpret_cast<const int4*>(f.q) + i;
      for (int k = 0; k < T.K; ++k) {
        const float w = __ldg(f.sw + k);
        const int4 v = __ldg(q + static_cast<int64_t>(k) * n4);
        a.x = axpy(a.x, w, v.x);
        a.y = axpy(a.y, w, v.y);
        a.z = axpy(a.z, w, v.z);
        a.w = axpy(a.w, w, v.w);
      }
      reinterpret_cast<float4*>(f.out)[i] = a;
    }
  } else if (i < f.n) {
    float a = f.acc[i];
    for (int k = 0; k < T.K; ++k)
      a = axpy(a, __ldg(f.sw + k),
               __ldg(f.q + static_cast<int64_t>(k) * f.n + i));
    f.out[i] = a;
  }
}

}  // namespace

// leaves[0 .. count) on the device, count in [1, kMaxLeaves = 32], every
// n > 0, each leaf's acc and out contiguous of n float32, q (K, n) int32
// and sw (K,) float32 contiguous (vec set only where the 16-byte path
// applies), K >= 0 shared by the table. One launch on `stream` updates
// them all; returns cudaGetLastError() (cudaErrorInvalidValue for a table
// it does not take).
extern "C" int quant_agg_stacked(const StackedLeaf* leaves, int count, int K,
                                 void* stream) {
  if (count < 1 || count > kMaxLeaves || K < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  StackedTable T;
  T.K = K;
  int64_t blocks = 0;
  for (int l = 0; l < kMaxLeaves; ++l) {
    if (l < count) {
      const StackedLeaf& f = leaves[l];
      if (f.n < 1) return static_cast<int>(cudaErrorInvalidValue);
      T.leaf[l] = f;
      const int64_t units = f.vec ? f.n / 4 : f.n;
      blocks += (units + kThreads - 1) / kThreads;
    } else {
      T.leaf[l] = StackedLeaf{};
    }
    T.block_end[l] = blocks;
  }
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  quant_agg_stacked_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(T);
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
