// Sliding-window causal flash attention, forward only, for Hopper (sm_90a),
// float32 math on the CUDA cores. Replaces the TPU kernel
// src/repro/kernels/swa_attention.py::swa_attention (Pallas body
// _swa_fwd_kernel). For query row i and key row j of one (batch, head):
//
//   s[i, j] = (q[i] . k[j]) * hd^-0.5   where visible, else -1e30
//   visible = (!causal || j <= i) && (!window || j > i - window)
//   out[i]  = sum_j softmax_j(s[i, :]) v[j]   (online, denominator >= 1e-30)
//
// with the reference's arithmetic: running max m (from -1e30), alpha =
// exp(m_prev - m_new), p = exp(s - m_new), l = l * alpha + sum p, acc =
// acc * alpha + p v. Masking stays the finite -1e30: a key tile that is in
// the band but holds no visible key for a row adds exp(0) = 1 garbage while
// the row's max is still -1e30, and the first visible key's alpha =
// exp(-1e30 - m) = 0 wipes it (-inf would give NaN there).
//
// q (B, L, H, hd) and k, v (B, L, KH, hd) are read in the model's layout
// through their strides; head h reads kv head h / (H / KH), so neither the
// GQA repeat nor the transposes of the reference wrapper are materialised.
// Inputs are float32 or bfloat16 and are widened to float32 on load; the
// output is written in the input type.
//
// Bound: operations (2 hd multiply-adds per visible (i, j) pair for q.k and
// again for p.v; mixtral-8x22b prefill: 4.8 G pairs a call). Design: a
// block owns 64 query rows of one (batch, head) and walks only the 32-row
// key tiles of the band [i0 - window + 1, i0 + 63] (each skipped tile has
// no visible pair); 256 threads, each holding 4 rows x 2 keys of scores
// (float4 shared-memory reads along hd) and 4 rows x hd/16 output columns
// in registers; the row statistics are reduced across the 16 threads that
// share a row with warp shuffles. Q, K, V and P tiles live in shared memory
// as float32 (~74 KB at hd = 128, dynamic).
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;          // query rows per block
constexpr int kBK = 32;          // key rows per step
constexpr float kNegInf = -1e30f;
constexpr int kSmemMax = 232448;
constexpr int kMaxDevices = 64;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int L, H, KH, hd, window, causal;
  float scale;
  int64_t sq[3], sk[3], sv[3];   // strides of axes b, l, head
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f(float* dst, float v) { *dst = v; }
__device__ __forceinline__ void from_f(__nv_bfloat16* dst, float v) {
  *dst = __float2bfloat16(v);
}

__host__ __device__ inline int ld_of(int hd) { return ((hd + 3) & ~3) + 4; }

__host__ __device__ inline int64_t smem_floats(int hd) {
  const int ld = ld_of(hd);
  return static_cast<int64_t>(kBQ) * ld + static_cast<int64_t>(kBK) * ld
         + static_cast<int64_t>(kBK) * hd
         + static_cast<int64_t>(kBQ) * (kBK + 1);
}

template <typename T, int kSlots>
__global__ void __launch_bounds__(kThreads)
swa_fwd_kernel(Params P) {
  extern __shared__ __align__(16) float smem[];
  const int hd = P.hd, ld = ld_of(hd), L = P.L;
  float* Qs = smem;                       // (kBQ, ld)
  float* Ks = Qs + kBQ * ld;              // (kBK, ld)
  float* Vs = Ks + kBK * ld;              // (kBK, hd)
  float* Ps = Vs + kBK * hd;              // (kBQ, kBK + 1)
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int hh = blockIdx.y, bi = blockIdx.z;
  const int kh = hh / (P.H / P.KH);
  const int i0 = blockIdx.x * kBQ;
  const T* q = static_cast<const T*>(P.q) + bi * P.sq[0] + hh * P.sq[2];
  const T* k = static_cast<const T*>(P.k) + bi * P.sk[0] + kh * P.sk[2];
  const T* v = static_cast<const T*>(P.v) + bi * P.sv[0] + kh * P.sv[2];

  for (int e = tid; e < kBQ * ld; e += kThreads) {
    const int r = e / ld, d = e - r * ld, i = i0 + r;
    Qs[e] = (i < L && d < hd) ? to_f(q[i * P.sq[1] + d]) : 0.f;
  }
  // the band of key rows any of this block's query rows can see
  const int last = P.causal ? min(L - 1, i0 + kBQ - 1) : L - 1;
  const int first = P.window ? max(0, i0 - P.window + 1) : 0;

  float m[4], l[4], acc[4][kSlots];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int s = 0; s < kSlots; ++s) acc[r][s] = 0.f;
  }

  for (int j0 = (first / kBK) * kBK; j0 <= last; j0 += kBK) {
    __syncthreads();                      // last step is done with K, V, P
    for (int e = tid; e < kBK * ld; e += kThreads) {
      const int r = e / ld, d = e - r * ld, j = j0 + r;
      Ks[e] = (j < L && d < hd) ? to_f(k[j * P.sk[1] + d]) : 0.f;
    }
    for (int e = tid; e < kBK * hd; e += kThreads) {
      const int r = e / hd, d = e - r * hd, j = j0 + r;
      Vs[e] = (j < L) ? to_f(v[j * P.sv[1] + d]) : 0.f;
    }
    __syncthreads();

    float s[4][2];
#pragma unroll
    for (int r = 0; r < 4; ++r) s[r][0] = s[r][1] = 0.f;
    for (int d = 0; d < hd; d += 4) {
      float4 qv[4], kv[2];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        qv[r] = *reinterpret_cast<const float4*>(Qs + (ty + 16 * r) * ld + d);
#pragma unroll
      for (int c = 0; c < 2; ++c)
        kv[c] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * c) * ld + d);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          s[r][c] = fmaf(qv[r].x, kv[c].x, s[r][c]);
          s[r][c] = fmaf(qv[r].y, kv[c].y, s[r][c]);
          s[r][c] = fmaf(qv[r].z, kv[c].z, s[r][c]);
          s[r][c] = fmaf(qv[r].w, kv[c].w, s[r][c]);
        }
    }

#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = i0 + ty + 16 * r;
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int j = j0 + tx + 16 * c;
        bool vis = j < L;
        if (P.causal) vis = vis && j <= i;
        if (P.window) vis = vis && j > i - P.window;
        s[r][c] = vis ? s[r][c] * P.scale : kNegInf;
        mx = fmaxf(mx, s[r][c]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[r], mx);
      const float alpha = expf(m[r] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        // a key past the end of the sequence adds nothing, garbage or not
        const float pv = (j0 + tx + 16 * c < L) ? expf(s[r][c] - m_new) : 0.f;
        Ps[(ty + 16 * r) * (kBK + 1) + tx + 16 * c] = pv;
        rs += pv;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[r] = l[r] * alpha + rs;
      m[r] = m_new;
#pragma unroll
      for (int sl = 0; sl < kSlots; ++sl) acc[r][sl] *= alpha;
    }
    __syncthreads();
    for (int jj = 0; jj < kBK; ++jj) {
      float pv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) pv[r] = Ps[(ty + 16 * r) * (kBK + 1) + jj];
#pragma unroll
      for (int sl = 0; sl < kSlots; ++sl) {
        const int col = tx + 16 * sl;
        if (col < hd) {
          const float vv = Vs[jj * hd + col];
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[r][sl] = fmaf(pv[r], vv, acc[r][sl]);
        }
      }
    }
  }

  T* o = static_cast<T*>(P.o);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + ty + 16 * r;
    if (i >= L) continue;
    const float den = fmaxf(l[r], 1e-30f);
    T* orow = o + ((static_cast<int64_t>(bi) * L + i) * P.H + hh) * hd;
#pragma unroll
    for (int sl = 0; sl < kSlots; ++sl) {
      const int col = tx + 16 * sl;
      if (col < hd) from_f(orow + col, acc[r][sl] / den);
    }
  }
}

template <typename T, int kSlots>
int launch(const Params& P, int64_t B, cudaStream_t stream) {
  const int64_t bytes = smem_floats(P.hd) * static_cast<int64_t>(sizeof(float));
  if (bytes > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  // raise the kernel's shared-memory limit once per device and size, so
  // that a call inside CUDA-graph capture makes no attribute change
  static int64_t smem_set[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (bytes > smem_set[dev]) {
    err = cudaFuncSetAttribute(swa_fwd_kernel<T, kSlots>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set[dev] = bytes;
  }
  const dim3 grid((P.L + kBQ - 1) / kBQ, P.H, static_cast<unsigned>(B));
  swa_fwd_kernel<T, kSlots><<<grid, kThreads, bytes, stream>>>(P);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_hd(const Params& P, int64_t B, cudaStream_t stream) {
  if (P.hd <= 32) return launch<T, 2>(P, B, stream);
  if (P.hd <= 64) return launch<T, 4>(P, B, stream);
  if (P.hd <= 128) return launch<T, 8>(P, B, stream);
  return launch<T, 16>(P, B, stream);
}

}  // namespace

// dims = {B, L, H, KH, hd}; strides = 9 element strides, axes (b, l, head)
// of q, k and v in that order (the last axis of each is contiguous). q
// (B, L, H, hd), k and v (B, L, KH, hd), all of one type: dtype 0 float32,
// 1 bfloat16. out (B, L, H, hd) contiguous, of the same type. window 0 is
// no window. Launches on `stream` and returns cudaGetLastError()
// (cudaErrorInvalidValue for shapes it does not take).
extern "C" int swa_attention(const void* q, const void* k, const void* v,
                             void* out, const int64_t* dims,
                             const int64_t* strides, int window, int causal,
                             int dtype, float scale, void* stream) {
  Params P;
  P.q = q;
  P.k = k;
  P.v = v;
  P.o = out;
  const int64_t B = dims[0];
  P.L = static_cast<int>(dims[1]);
  P.H = static_cast<int>(dims[2]);
  P.KH = static_cast<int>(dims[3]);
  P.hd = static_cast<int>(dims[4]);
  P.window = window;
  P.causal = causal;
  P.scale = scale;
  for (int a = 0; a < 3; ++a) {
    P.sq[a] = strides[a];
    P.sk[a] = strides[3 + a];
    P.sv[a] = strides[6 + a];
  }
  if (B < 1 || B > 65535 || P.L < 1 || P.H < 1 || P.H > 65535 || P.KH < 1 ||
      P.H % P.KH != 0 || P.hd < 1 || P.hd > 256 || window < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_hd<float>(P, B, s);
  if (dtype == 1) return launch_hd<__nv_bfloat16>(P, B, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* swa_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
