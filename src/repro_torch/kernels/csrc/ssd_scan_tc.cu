// Mamba-2 SSD intra-chunk kernel for Hopper (sm_90a) on the tensor cores,
// float32 in and out through a 3xTF32 split. Replaces the TPU kernel
// src/repro/kernels/ssd_scan.py::ssd_chunk_pallas (Pallas body
// _ssd_chunk_kernel) for p <= 128 and n <= 128 where the tiles fit one
// block's shared memory; other shapes take the CUDA-core instance
// (csrc/ssd_scan.cu), and repro_torch.kernels.ssd_scan.route states the
// rule. Per (batch b, chunk z, head h), with c rows i, j of the chunk:
//
//   cs[i]        = sum_{k <= i} dt[k] * A[h]
//   y_diag[i, :] = sum_{j <= i} (C[i] . B[j]) * exp(cs[i] - cs[j]) * dt[j]
//                    * x[j, :]
//   states[:, :] = sum_j x[j, :]^T (B[j, :] * (dt[j] * exp(cs[c-1] - cs[j])))
//
// B and C are read at group width (head h reads group h / (H / G)); every
// input is addressed through its own strides (the last axis contiguous),
// so the model's (b, nc, c, h, .) views are read in place.
//
// Bound: operations. At the mamba2-1.3b prefill shape (c = 256, p = 64,
// n = 128) a slice does ~17 MFLOP against ~0.17 MB of traffic. Single-pass
// TF32 (10-bit mantissas) misses the 2e-4 bar against float32 by about
// 100x, so every product is split: a = big + small with big =
// cvt.rna.tf32(a) and small = cvt.rna.tf32(a - big), and a.b is taken as
// small.big + big.small + big.big, three mma.sync.m16n8k8 TF32 products
// into float32 accumulators (3x the operations of the float32 work). The
// split is made in registers as each fragment is read from a float32 tile
// in shared memory, so shared memory holds one float32 copy of each tile
// and x serves as the B operand of W.x and, read transposed, as the A
// operand of x^T.B' without a second copy.
//
// Design: one block of 16 warps per (b, z, h) slice; grid (H, b * nc).
// The block computes the chunk's cumsum once (one warp scan), then walks
// the lower triangle of 64 x 64 tiles, row tile by row tile: for key tile
// j, S = C_i.B_j^T (each warp 16 rows x 16 columns), the causal decay and
// dt applied in float32 as a select (j > i is never evaluated, so exp
// cannot overflow into an inf * 0) into a 64 x 64 shared-memory stage,
// since the m16n8 accumulator of S is not laid out as the A fragment of
// W.x; then y_i += W.x_j (each warp 16 rows x a quarter of p, over the key
// rows up to the diagonal). While the last row tile walks every key tile,
// the state x_j^T.(B_j * dt * decay) accumulates in registers beside it,
// so B and x are read again only for the triangle's off-diagonal tiles.
// The tiles arrive by cp.async (16-byte copies where the rows allow, else
// 4-byte ones), double-buffered: the next step's B_j and x_j, and the next
// row tile's C_i, load during this step's products. Rows past c and
// columns past p or n are zero-filled by the copies. Shared memory: ~193
// KB at the prefill shape, one block of 512 threads per SM (16 warps hide
// the latency of the fragment reads and splits better than 8 did, at 32
// accumulator floats a thread). Padded row strides (n rounded to 8, plus
// 4; p rounded to 16, plus 8; 68 for the stage) keep the fragment reads of
// S, W.x and the transposed x free of bank conflicts. The kernel is bound
// by feeding the tensor cores (fragment reads, the splits, the W stage and
// the barriers), not by mma.sync itself, so the splits round with integer
// operations rather than cvt.rna.tf32.f32, and the S loop is unrolled.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 64;          // rows i / key rows j of one tile
constexpr int kWC = kWarps / 4;    // column groups of S and y (4 row groups)
constexpr int kLdw = kTile + 4;    // row stride of the W stage (floats)
constexpr int kMaxPN = 128;        // p <= 128, n <= 128
constexpr int kSmemMax = 232448;   // dynamic shared memory a block may use
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
  int xvec, bcvec;                       // 16-byte copies allowed
  int64_t sx[4], sdt[4], sb[4], sc[4];   // strides of axes b, z, i, head
};

__host__ __device__ inline int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}
__host__ __device__ inline int ld_k(int n) { return round_up(n, 8) + 4; }
__host__ __device__ inline int ld_x(int p) { return round_up(p, 16) + 8; }

// Shared-memory floats: cs, dt and decay over the padded chunk, two C,
// two B and two x tiles and the W stage. Every part starts on a 16-byte
// boundary.
__host__ __device__ inline int64_t smem_floats(int c, int p, int n) {
  return 3LL * round_up(c, kTile) + 4LL * kTile * ld_k(n)
         + 2LL * kTile * ld_x(p) + static_cast<int64_t>(kTile) * kLdw;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool pred) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(pred ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool pred) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(d), "l"(src), "r"(pred ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Rows r0 .. r0 + 63 of a (rows, w) matrix with row stride ld_g into a
// (64, lds) tile, columns up to w rounded to 8; rows >= c and columns >= w
// zero-filled (a copy of source size 0). A thread keeps one column (a
// 16-byte chunk where the rows allow, else one float) and steps down the
// rows, so no division runs per element.
__device__ __forceinline__ void load_tile(float* dst, int lds,
                                          const float* src, int64_t ld_g,
                                          int r0, int c, int w, bool vec) {
  const int w8 = round_up(w, 8);
  const int width = vec ? 4 : 1;         // floats a copy
  const int cols = w8 / width, rstep = kThreads / cols;
  if (static_cast<int>(threadIdx.x) >= rstep * cols) return;
  const int k = (threadIdx.x % cols) * width;
  for (int r = threadIdx.x / cols; r < kTile; r += rstep) {
    const int row = r0 + r;
    const bool ok = row < c && k < w;
    const float* from = ok ? src + row * ld_g + k : src;
    if (vec)                             // w % 4 == 0, 16-byte rows
      cp_async16(dst + r * lds + k, from, ok);
    else
      cp_async4(dst + r * lds + k, from, ok);
  }
}

// v rounded to TF32 (10 mantissa bits) to nearest, ties away from zero:
// half a unit of the 13 dropped bits added to the magnitude, then cleared.
// The same bits as cvt.rna.tf32.f32, in two integer operations instead of
// a conversion.
__device__ __forceinline__ uint32_t tf32(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

// a = big + small, both TF32
__device__ __forceinline__ void split(float a, uint32_t& big,
                                      uint32_t& small) {
  big = tf32(a);
  small = tf32(a - __uint_as_float(big));
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a.b in 3xTF32: the two small cross terms first, then big.big
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ab)[4],
                                     const uint32_t (&as)[4],
                                     const uint32_t (&bb)[2],
                                     const uint32_t (&bs)[2]) {
  mma(d, as, bb);
  mma(d, ab, bs);
  mma(d, ab, bb);
}

// The A fragment of m16n8k8 (row-major 16 x 8) at `a` with row stride ld
// and column stride cs: lane (g, t) holds (g, t), (g + 8, t), (g, t + 4),
// (g + 8, t + 4).
__device__ __forceinline__ void load_a(const float* a, int ld, int cs,
                                       uint32_t (&big)[4],
                                       uint32_t (&small)[4]) {
  split(a[0], big[0], small[0]);
  split(a[8 * ld], big[1], small[1]);
  split(a[4 * cs], big[2], small[2]);
  split(a[8 * ld + 4 * cs], big[3], small[3]);
}

// kPB: the bound on p this instance is built for (64 or 128). Warp w
// owns rows 16 (w % 4) .. + 15 of a tile; its column group w / 4 is 16
// columns of S and a quarter of p's columns of y. The state's 16-row m
// tiles of p spread over the warps, each taking a run of its n tiles.
template <int kPB>
__global__ void __launch_bounds__(kThreads, 1)
ssd_chunk_tc_kernel(const Params P) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kYN = kPB / 8 / kWC;     // y n tiles a warp
  constexpr int kSM = kPB / 16;          // state m tiles
  constexpr int kSN = 16 * kSM / kWarps; // state n tiles a warp (n <= 128)
  const int c = P.c, p = P.p, n = P.n;
  const int T = (c + kTile - 1) / kTile, ct = T * kTile;
  const int ldk = ld_k(n), ldx = ld_x(p);
  const int n8 = round_up(n, 8), p8 = round_up(p, 8);
  const int hh = blockIdx.x;
  const int bi = blockIdx.y / P.nc, zi = blockIdx.y % P.nc;
  const int gi = hh / (P.h / P.g);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;

  const float* x = P.x + bi * P.sx[0] + zi * P.sx[1] + hh * P.sx[3];
  const float* dt = P.dt + bi * P.sdt[0] + zi * P.sdt[1] + hh * P.sdt[3];
  const float* Bm = P.B + bi * P.sb[0] + zi * P.sb[1] + gi * P.sb[3];
  const float* Cm = P.C + bi * P.sc[0] + zi * P.sc[1] + gi * P.sc[3];
  const int64_t sxi = P.sx[2], sdi = P.sdt[2], sbi = P.sb[2], sci = P.sc[2];

  float* cs = smem;                      // (ct,) cumsum of dt * A, 0 past c
  float* dts = cs + ct;                  // (ct,) dt, 0 past c
  float* dec = dts + ct;                 // (ct,) dt * exp(cs[c-1] - cs)
  float* Cs = dec + ct;                  // 2 x (64, ldk) C of a row tile
  float* Bs = Cs + 2 * kTile * ldk;      // 2 x (64, ldk) B of a key tile
  float* Xs = Bs + 2 * kTile * ldk;      // 2 x (64, ldx) x of a key tile
  float* Ws = Xs + 2 * kTile * ldx;      // (64, kLdw) W of one tile pair

  // the first step's tiles are in flight during the scan
  load_tile(Cs, ldk, Cm, sci, 0, c, n, P.bcvec);
  load_tile(Bs, ldk, Bm, sbi, 0, c, n, P.bcvec);
  load_tile(Xs, ldx, x, sxi, 0, c, p, P.xvec);
  cp_async_commit();

  const float a = P.A[hh];
  for (int i = tid; i < ct; i += kThreads) dts[i] = i < c ? dt[i * sdi] : 0.f;
  __syncthreads();
  if (tid < 32) {                        // one warp: segmented scan
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
  const float c_last = cs[c - 1];
  for (int i = tid; i < ct; i += kThreads) {
    dec[i] = i < c ? __fmul_rn(dts[i], expf(c_last - cs[i])) : 0.f;
    if (i >= c) cs[i] = 0.f;
  }                                      // read after the loop's barrier

  const int wr = warp & 3, wc = warp >> 2;   // S, y: 16 rows, column group
  const int sm = warp % kSM, sn0 = (warp / kSM) * kSN;   // state tiles
  float yacc[kYN][4], sacc[kSN][4];
#pragma unroll
  for (int q = 0; q < kYN; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) yacc[q][e] = 0.f;
#pragma unroll
  for (int q = 0; q < kSN; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) sacc[q][e] = 0.f;

  const int steps = T * (T + 1) / 2;
  int it = 0, jt = 0;
  for (int s = 0; s < steps; ++s) {
    const int cur = s & 1;
    if (s + 1 < steps) {                 // the next step's tiles
      const int nj = jt < it ? jt + 1 : 0;
      if (nj == 0)                       // and the next row tile's C
        load_tile(Cs + ((it + 1) & 1) * kTile * ldk, ldk, Cm, sci,
                  (it + 1) * kTile, c, n, P.bcvec);
      load_tile(Bs + (cur ^ 1) * kTile * ldk, ldk, Bm, sbi, nj * kTile, c, n,
                P.bcvec);
      load_tile(Xs + (cur ^ 1) * kTile * ldx, ldx, x, sxi, nj * kTile, c, p,
                P.xvec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    const float* Cc = Cs + (it & 1) * kTile * ldk;
    const float* Bc = Bs + cur * kTile * ldk;
    const float* Xc = Xs + cur * kTile * ldx;
    const int i0 = it * kTile, j0 = jt * kTile;
    const bool diag = jt == it;
    const int jl = min(kTile, c - j0);   // key rows of this tile

    // S = C_i . B_j^T: the warp's rows 16 wr.., columns 16 wc..
    float sfr[2][4];
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) sfr[q][e] = 0.f;
    if (!(diag && wc > wr)) {            // not above the diagonal
#pragma unroll 4
      for (int k0 = 0; k0 < n8; k0 += 8) {
        uint32_t ab[4], as[4];
        load_a(Cc + (16 * wr + g) * ldk + k0 + t, ldk, 1, ab, as);
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const float* bp = Bc + (16 * wc + 8 * q + g) * ldk + k0 + t;
          uint32_t bb[2], bs[2];
          split(bp[0], bb[0], bs[0]);
          split(bp[4], bb[1], bs[1]);
          mma3(sfr[q], ab, as, bb, bs);
        }
      }
    }

    // the state, while the last row tile walks every key tile:
    // st[pp, nn] += sum_j x[j, pp] * (B[j, nn] * dec[j])
    if (it == T - 1 && 16 * sm < p8) {
      for (int k0 = 0; k0 < jl; k0 += 8) {
        uint32_t ab[4], as[4];
        load_a(Xc + (k0 + t) * ldx + 16 * sm + g, 1, ldx, ab, as);
        const float d0 = dec[j0 + k0 + t], d1 = dec[j0 + k0 + t + 4];
#pragma unroll
        for (int q = 0; q < kSN; ++q) {
          const int nb = (sn0 + q) * 8;
          if (nb < n8) {
            const float* bp = Bc + (k0 + t) * ldk + nb + g;
            uint32_t bb[2], bs[2];
            split(__fmul_rn(bp[0], d0), bb[0], bs[0]);
            split(__fmul_rn(bp[4 * ldk], d1), bb[1], bs[1]);
            mma3(sacc[q], ab, as, bb, bs);
          }
        }
      }
    }

    // W = S o L o dt in float32, into the stage
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rl = 16 * wr + g + (e >> 1) * 8;
        const int cl = 16 * wc + 8 * q + 2 * t + (e & 1);
        const int i = i0 + rl, j = j0 + cl;
        float w = 0.f;
        if (j <= i && i < c)              // j <= i < c: exp argument <= 0
          w = __fmul_rn(__fmul_rn(sfr[q][e], expf(cs[i] - cs[j])), dts[j]);
        Ws[rl * kLdw + cl] = w;
      }
    __syncthreads();

    // y_i += W . x_j: the warp's rows, its quarter of p, key rows up to the
    // diagonal
    {
      const int kl = diag ? min(jl, 16 * wr + 16) : jl;
      for (int k0 = 0; k0 < kl; k0 += 8) {
        uint32_t ab[4], as[4];
        load_a(Ws + (16 * wr + g) * kLdw + k0 + t, kLdw, 1, ab, as);
#pragma unroll
        for (int q = 0; q < kYN; ++q) {
          const int col0 = (wc * kYN + q) * 8;
          if (col0 < p8) {
            const float* xp = Xc + (k0 + t) * ldx + col0 + g;
            uint32_t bb[2], bs[2];
            split(xp[0], bb[0], bs[0]);
            split(xp[4 * ldx], bb[1], bs[1]);
            mma3(yacc[q], ab, as, bb, bs);
          }
        }
      }
    }
    if (diag) {                          // row tile done: store, reset
#pragma unroll
      for (int q = 0; q < kYN; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = i0 + 16 * wr + g + (e >> 1) * 8;
          const int col = (wc * kYN + q) * 8 + 2 * t + (e & 1);
          if (i < c && col < p)
            P.y[((((int64_t)bi * P.nc + zi) * c + i) * P.h + hh) * p + col] =
                yacc[q][e];
          yacc[q][e] = 0.f;
        }
    }
    __syncthreads();                     // done with Ws and buffer cur
    if (jt < it) {
      ++jt;
    } else {
      ++it;
      jt = 0;
    }
  }

  float* st = P.st + (((int64_t)bi * P.nc + zi) * P.h + hh) * p * n;
#pragma unroll
  for (int q = 0; q < kSN; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int pp = 16 * sm + g + (e >> 1) * 8;
      const int nn = (sn0 + q) * 8 + 2 * t + (e & 1);
      if (pp < p && nn < n) st[(int64_t)pp * n + nn] = sacc[q][e];
    }
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0;
}

bool strides4(const int64_t* s) {
  return s[0] % 4 == 0 && s[1] % 4 == 0 && s[2] % 4 == 0 && s[3] % 4 == 0;
}

template <int kPB>
cudaError_t launch(const Params& P, int64_t b, int64_t bytes,
                   cudaStream_t stream) {
  // raise the kernel's shared-memory limit once per device and size, so
  // that a call inside CUDA-graph capture makes no attribute change
  static int64_t smem_set[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (bytes > smem_set[dev]) {
    err = cudaFuncSetAttribute(ssd_chunk_tc_kernel<kPB>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
    smem_set[dev] = bytes;
  }
  const dim3 grid(P.h, static_cast<unsigned>(b * P.nc));
  ssd_chunk_tc_kernel<kPB><<<grid, kThreads, bytes, stream>>>(P);
  return cudaGetLastError();
}

}  // namespace

// The same contract as ssd_chunk (csrc/ssd_scan.cu): dims = {b, nc, c, h,
// p, g, n}; strides = 16 element strides, axes (b, z, i, head-or-group) of
// x, dt, B and C in that order (the last axis of x, B and C contiguous);
// x (b,nc,c,h,p), dt (b,nc,c,h), A (h,), B and C (b,nc,c,g,n), all float32
// on the device; y (b,nc,c,h,p) and st (b,nc,h,p,n) float32, contiguous.
// Takes p <= 128 and n <= 128 where the tiles fit one block's shared
// memory (smem_floats; c <= 832 at p = n = 128, c <= 3584 at the prefill's
// p = 64, n = 128). Launches on `stream` and returns
// cudaGetLastError() (cudaErrorInvalidValue for shapes it does not take).
extern "C" int ssd_chunk_tc(const void* x, const void* dt, const void* A,
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
  if (b < 1 || P.nc < 1 || P.c < 1 || P.h < 1 || P.p < 1 || P.n < 1 ||
      P.g < 1 || P.h % P.g != 0 || P.p > kMaxPN ||
      P.n > kMaxPN || b * P.nc > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  P.xvec = P.p % 4 == 0 && aligned16(x) && strides4(P.sx);
  P.bcvec = P.n % 4 == 0 && aligned16(B) && aligned16(C) && strides4(P.sb) &&
            strides4(P.sc);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t bytes = smem_floats(P.c, P.p, P.n) * 4;
  if (bytes > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = P.p <= 64 ? launch<64>(P, b, bytes, s)
                                    : launch<128>(P, b, bytes, s);
  return static_cast<int>(err);
}

extern "C" const char* ssd_chunk_tc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
