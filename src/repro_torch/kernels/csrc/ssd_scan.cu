// Mamba-2 SSD intra-chunk kernel for Hopper (sm_90a), float32 on the CUDA
// cores. Replaces the TPU kernel src/repro/kernels/ssd_scan.py::
// ssd_chunk_pallas (Pallas body _ssd_chunk_kernel) for the shapes the
// tensor-core instance (csrc/ssd_scan_tc.cu) does not take: c > 2048, or
// p or n above 128 (repro_torch.kernels.ssd_scan.route states the rule).
// Per (batch b, chunk z, head h), with c rows i, j of the chunk:
//
//   cs[i]        = sum_{k <= i} dt[k] * A[h]
//   y_diag[i, :] = sum_{j <= i} (C[i] . B[j]) * exp(cs[i] - cs[j]) * dt[j]
//                    * x[j, :]
//   states[:, :] = sum_j x[j, :]^T (B[j, :] * (dt[j] * exp(cs[c-1] - cs[j])))
//
// B and C are read at group width: head h reads group h / (H / G), so the
// caller never materialises the head-repeated copy. Every input is addressed
// through its own strides (the last axis must be contiguous), so the
// (b, nc, c, h, .) views of the model's projections are read in place.
//
// Bound: operations. At the mamba2-1.3b prefill shape (c = 256, p = 64,
// n = 128) a (b, z, h) slice does ~17 MFLOP against ~0.26 MB of traffic.
// Design: one launch, grid (row tiles + 1, H, b * nc). Blocks 0..T-1 each
// own 64 query rows of one slice and walk the j tiles up to the diagonal:
// C.B^T for a 64 x 64 tile from shared memory (float4 reads along n), the
// causal decay and dt applied as a select (j > i is never evaluated, so
// exp(cs[i] - cs[j]) cannot overflow into an inf * 0), then the tile times
// x. The last block of each slice reduces the chunk state, 64 x 128 outputs
// at a time. Each block recomputes the chunk's cumsum (c floats) with one
// warp scan. Shared memory holds the tiles (~99 KB at the prefill shape,
// dynamic), more than the 48 KB a block gets without opting in.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;        // query rows per block, key rows per step
constexpr int kMaxPSlots = 8;    // p <= 16 * kMaxPSlots
constexpr int kStP = 64;         // state sub-tile: p rows
constexpr int kStN = 128;        // state sub-tile: n columns
constexpr int kSmemMax = 232448;  // dynamic shared memory a block may use
constexpr int kMaxDevices = 64;

struct Params {
  const float* x;
  const float* dt;
  const float* A;
  const float* B;
  const float* C;
  float* y;
  float* st;
  int nc, c, h, p, g, n;
  int64_t sx[4], sdt[4], sb[4], sc[4];   // strides of axes b, z, i, head
};

__device__ __forceinline__ int round4(int v) { return (v + 3) & ~3; }

// Shared-memory floats of the y blocks and of the state block.
__host__ __device__ inline int64_t y_floats(int c, int p, int n) {
  const int ldn = ((n + 3) & ~3) + 4;
  return 2LL * c + 2LL * kTile * ldn + static_cast<int64_t>(kTile) * (p + 1)
         + static_cast<int64_t>(kTile) * (kTile + 1);
}

__host__ __device__ inline int64_t state_floats(int c) {
  return 2LL * c + static_cast<int64_t>(kTile) * (kStP + kStN);
}

__global__ void __launch_bounds__(kThreads)
ssd_chunk_kernel(Params P) {
  extern __shared__ __align__(16) float smem[];
  const int c = P.c, p = P.p, n = P.n;
  const int n_tiles = (c + kTile - 1) / kTile;
  const int tile = blockIdx.x;
  const int hh = blockIdx.y;
  const int bi = blockIdx.z / P.nc, zi = blockIdx.z % P.nc;
  const int gi = hh / (P.h / P.g);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;

  const float* x = P.x + bi * P.sx[0] + zi * P.sx[1] + hh * P.sx[3];
  const float* dt = P.dt + bi * P.sdt[0] + zi * P.sdt[1] + hh * P.sdt[3];
  const float* Bm = P.B + bi * P.sb[0] + zi * P.sb[1] + gi * P.sb[3];
  const float* Cm = P.C + bi * P.sc[0] + zi * P.sc[1] + gi * P.sc[3];
  const int64_t sxi = P.sx[2], sdi = P.sdt[2], sbi = P.sb[2], sci = P.sc[2];
  const float a = P.A[hh];

  float* cs = smem;                       // (c,)   cumsum of dt * A
  float* dts = cs + c;                    // (c,)   dt
  for (int i = tid; i < c; i += kThreads) dts[i] = dt[i * sdi];
  __syncthreads();
  if (tid < 32) {                         // one warp: segmented scan
    const int seg = (c + 31) / 32;
    const int lo = min(c, tid * seg), hi = min(c, lo + seg);
    float run = 0.f;
    for (int i = lo; i < hi; ++i) {
      run = __fadd_rn(run, __fmul_rn(dts[i], a));
      cs[i] = run;
    }
    float incl = run;
    for (int off = 1; off < 32; off <<= 1) {
      const float v = __shfl_up_sync(0xffffffffu, incl, off);
      if (tid >= off) incl += v;
    }
    const float excl = incl - run;
    for (int i = lo; i < hi; ++i) cs[i] += excl;
  }
  __syncthreads();

  if (tile < n_tiles) {
    // ---- y_diag rows i0 .. i0 + 63 ------------------------------------
    const int ldn = round4(n) + 4;        // float4 rows, banks staggered
    const int ldp = p + 1;
    float* Cs = dts + c + ((4 - (2 * c) % 4) % 4);   // 16-byte aligned
    float* Bs = Cs + kTile * ldn;
    float* Xs = Bs + kTile * ldn;
    float* Ws = Xs + kTile * ldp;
    const int i0 = tile * kTile;
    for (int e = tid; e < kTile * ldn; e += kThreads) {
      const int r = e / ldn, k = e - r * ldn, i = i0 + r;
      Cs[e] = (i < c && k < n) ? Cm[i * sci + k] : 0.f;
    }
    float acc[4][kMaxPSlots];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int s = 0; s < kMaxPSlots; ++s) acc[r][s] = 0.f;

    for (int jt = 0; jt <= tile; ++jt) {
      const int j0 = jt * kTile;
      __syncthreads();                    // last step is done with the tiles
      for (int e = tid; e < kTile * ldn; e += kThreads) {
        const int r = e / ldn, k = e - r * ldn, j = j0 + r;
        Bs[e] = (j < c && k < n) ? Bm[j * sbi + k] : 0.f;
      }
      for (int e = tid; e < kTile * p; e += kThreads) {
        const int r = e / p, k = e - r * p, j = j0 + r;
        Xs[r * ldp + k] = (j < c) ? x[j * sxi + k] : 0.f;
      }
      __syncthreads();
      float s[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) s[r][q] = 0.f;
      for (int k = 0; k < n; k += 4) {
        float4 cv[4], bv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
          cv[r] = *reinterpret_cast<const float4*>(Cs + (ty + 16 * r) * ldn + k);
#pragma unroll
        for (int q = 0; q < 4; ++q)
          bv[q] = *reinterpret_cast<const float4*>(Bs + (tx + 16 * q) * ldn + k);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            s[r][q] = fmaf(cv[r].x, bv[q].x, s[r][q]);
            s[r][q] = fmaf(cv[r].y, bv[q].y, s[r][q]);
            s[r][q] = fmaf(cv[r].z, bv[q].z, s[r][q]);
            s[r][q] = fmaf(cv[r].w, bv[q].w, s[r][q]);
          }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int i = i0 + ty + 16 * r, j = j0 + tx + 16 * q;
          float w = 0.f;
          if (j <= i && i < c)            // j <= i < c: exp argument <= 0
            w = __fmul_rn(__fmul_rn(s[r][q], expf(cs[i] - cs[j])), dts[j]);
          Ws[(ty + 16 * r) * (kTile + 1) + tx + 16 * q] = w;
        }
      __syncthreads();
      const int jmax = min(kTile, c - j0);
      for (int jj = 0; jj < jmax; ++jj) {
        float w[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) w[r] = Ws[(ty + 16 * r) * (kTile + 1) + jj];
#pragma unroll
        for (int sl = 0; sl < kMaxPSlots; ++sl) {
          const int col = tx + 16 * sl;
          if (col < p) {
            const float xv = Xs[jj * ldp + col];
#pragma unroll
            for (int r = 0; r < 4; ++r) acc[r][sl] = fmaf(w[r], xv, acc[r][sl]);
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = i0 + ty + 16 * r;
      if (i >= c) continue;
      float* yrow = P.y + ((((int64_t)bi * P.nc + zi) * c + i) * P.h + hh) * p;
#pragma unroll
      for (int sl = 0; sl < kMaxPSlots; ++sl) {
        const int col = tx + 16 * sl;
        if (col < p) yrow[col] = acc[r][sl];
      }
    }
    return;
  }

  // ---- chunk state (p, n), one 64 x 128 sub-tile at a time --------------
  float* Xsub = dts + c;                  // (kTile, kStP)
  float* Bsub = Xsub + kTile * kStP;      // (kTile, kStN)
  const float c_last = cs[c - 1];
  float* st = P.st + (((int64_t)bi * P.nc + zi) * P.h + hh) * p * n;
  for (int p0 = 0; p0 < p; p0 += kStP) {
    for (int n0 = 0; n0 < n; n0 += kStN) {
      float acc[4][8];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int s = 0; s < 8; ++s) acc[r][s] = 0.f;
      for (int j0 = 0; j0 < c; j0 += kTile) {
        __syncthreads();
        for (int e = tid; e < kTile * kStP; e += kThreads) {
          const int r = e / kStP, k = e - r * kStP, j = j0 + r;
          Xsub[e] = (j < c && p0 + k < p) ? x[j * sxi + p0 + k] : 0.f;
        }
        for (int e = tid; e < kTile * kStN; e += kThreads) {
          const int r = e / kStN, k = e - r * kStN, j = j0 + r;
          float v = 0.f;
          if (j < c && n0 + k < n)
            v = __fmul_rn(Bm[j * sbi + n0 + k],
                          __fmul_rn(dts[j], expf(c_last - cs[j])));
          Bsub[e] = v;
        }
        __syncthreads();
        const int jmax = min(kTile, c - j0);
        for (int jj = 0; jj < jmax; ++jj) {
          float xv[4], bv[8];
#pragma unroll
          for (int r = 0; r < 4; ++r) xv[r] = Xsub[jj * kStP + ty + 16 * r];
#pragma unroll
          for (int s = 0; s < 8; ++s) bv[s] = Bsub[jj * kStN + tx + 16 * s];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int s = 0; s < 8; ++s) acc[r][s] = fmaf(xv[r], bv[s], acc[r][s]);
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int pp = p0 + ty + 16 * r;
        if (pp >= p) continue;
#pragma unroll
        for (int s = 0; s < 8; ++s) {
          const int nn = n0 + tx + 16 * s;
          if (nn < n) st[(int64_t)pp * n + nn] = acc[r][s];
        }
      }
    }
  }
}

}  // namespace

// dims = {b, nc, c, h, p, g, n}; strides = 16 element strides, axes
// (b, z, i, head-or-group) of x, dt, B and C in that order (the last axis
// of x, B and C is contiguous). x (b,nc,c,h,p), dt (b,nc,c,h), A (h,),
// B and C (b,nc,c,g,n), all float32 on the device; y (b,nc,c,h,p) and
// st (b,nc,h,p,n) float32, contiguous. Launches on `stream` and returns
// cudaGetLastError() (cudaErrorInvalidValue for shapes it does not take).
extern "C" int ssd_chunk(const void* x, const void* dt, const void* A,
                         const void* B, const void* C, void* y, void* st,
                         const int64_t* dims, const int64_t* strides,
                         void* stream) {
  Params P;
  P.x = static_cast<const float*>(x);
  P.dt = static_cast<const float*>(dt);
  P.A = static_cast<const float*>(A);
  P.B = static_cast<const float*>(B);
  P.C = static_cast<const float*>(C);
  P.y = static_cast<float*>(y);
  P.st = static_cast<float*>(st);
  const int64_t b = dims[0];
  P.nc = static_cast<int>(dims[1]);
  P.c = static_cast<int>(dims[2]);
  P.h = static_cast<int>(dims[3]);
  P.p = static_cast<int>(dims[4]);
  P.g = static_cast<int>(dims[5]);
  P.n = static_cast<int>(dims[6]);
  for (int a = 0; a < 4; ++a) {
    P.sx[a] = strides[a];
    P.sdt[a] = strides[4 + a];
    P.sb[a] = strides[8 + a];
    P.sc[a] = strides[12 + a];
  }
  const int64_t floats = y_floats(P.c, P.p, P.n) + 4 > state_floats(P.c)
                             ? y_floats(P.c, P.p, P.n) + 4
                             : state_floats(P.c);
  const int64_t bytes = floats * static_cast<int64_t>(sizeof(float));
  if (b < 1 || P.nc < 1 || P.c < 1 || P.h < 1 || P.p < 1 || P.n < 1 ||
      P.g < 1 || P.h % P.g != 0 || P.p > 16 * kMaxPSlots ||
      b * P.nc > 65535 || P.h > 65535 || bytes > kSmemMax)
    return static_cast<int>(cudaErrorInvalidValue);
  // raise the kernel's shared-memory limit once per device and size, so
  // that a call inside CUDA-graph capture makes no attribute change
  static int64_t smem_set[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (bytes > smem_set[dev]) {
    err = cudaFuncSetAttribute(ssd_chunk_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set[dev] = bytes;
  }
  const dim3 grid((P.c + kTile - 1) / kTile + 1, P.h,
                  static_cast<unsigned>(b * P.nc));
  ssd_chunk_kernel<<<grid, kThreads, bytes,
                     static_cast<cudaStream_t>(stream)>>>(P);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ssd_chunk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
