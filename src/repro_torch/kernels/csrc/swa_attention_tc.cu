// Sliding-window causal flash attention, forward only, bfloat16 on Hopper's
// tensor cores (sm_90a). The second device instance of K5 beside
// swa_attention.cu (float32 math on the CUDA cores); both replace the TPU
// kernel src/repro/kernels/swa_attention.py::swa_attention (Pallas body
// _swa_fwd_kernel) and compute, for query row i and key row j of one
// (batch, head):
//
//   s[i, j] = (q[i] . k[j]) * hd^-0.5   where visible, else -1e30
//   visible = (!causal || j <= i) && (!window || j > i - window) && j < L
//   out[i]  = sum_j softmax_j(s[i, :]) v[j]   (online, denominator >= 1e-30)
//
// with the reference's online softmax: running max m (from -1e30), alpha =
// exp(m_prev - m_new), p = exp(s - m_new), l = l * alpha + sum p, acc =
// acc * alpha + p v, taken in base 2 with hd^-0.5 * log2(e) folded into the
// scores (masked scores stay the finite -1e30: a key tile in the band with
// no visible key for a row adds exp(0) = 1 garbage while the row's max is
// still -1e30, and the first visible key's alpha = 0 wipes it; -inf would
// give NaN there). Rounding: q, k, v are bfloat16, both products sum in
// float32, p is rounded to bfloat16 for p.v (l sums the float32 p), and the
// output is rounded to bfloat16.
//
// q (B, L, H, hd) and k, v (B, L, KH, hd) are read in the model's layout
// through their strides, head h reading kv head h / (H / KH); hd is a
// multiple of 16 up to 128 (held in shared memory as 64 or 128 columns: TMA
// fills the columns past hd with zeros, which add nothing to q.k, and the
// output columns past hd are not stored).
//
// Bound: operations, 4 hd flops per visible (i, j) pair on the bfloat16
// tensor cores (mixtral-8x22b prefill: 2.47 TFLOP a call, 2.5 ms at 989
// TFLOP/s). Design (route: TMA, not cp.async):
//  * a block owns 128 query rows of one (batch, head): two consumer
//    warpgroups of 64 rows each and one producer warp (288 threads);
//  * the producer loads Q once and then 128-row K and V tiles by TMA
//    (cp.async.bulk.tensor, 128-byte swizzle, one box per 64 columns) into
//    a two-stage ring, with full (transaction-count) and empty mbarriers,
//    so the next tile arrives while the tensor cores work on this one;
//  * S = Q K^T is wgmma.m64n128k16 with both operands in shared memory
//    (K-major); O += P V is wgmma with P from registers (the S accumulator
//    fragment packed to bfloat16x2 is the A fragment of the next product)
//    and V in shared memory in its natural (keys x hd) layout through the
//    transpose flag; S and O stay in registers (64 + 64 floats a thread at
//    hd = 128);
//  * the walk visits only the key tiles of the band [i0 - window + 1,
//    i0 + 127] that hold a visible pair; mask arithmetic runs only on tiles
//    that cross the window's lower edge, the diagonal or the end of L;
//  * tensor maps are built on the host per call (cuTensorMapEncodeTiled,
//    taken from the CUDA driver library with dlopen, so the library
//    links nothing more) and passed as __grid_constant__ parameters, so
//    a call under CUDA-graph capture stays valid.
#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>

namespace {

constexpr int kBQ = 128;                 // query rows per block
constexpr int kBK = 128;                 // key rows per tile
constexpr int kStages = 2;               // K / V ring depth
constexpr int kConsumers = 256;          // two warpgroups
constexpr int kThreads = kConsumers + 32;  // + the producer warp
constexpr uint32_t kBoxRow = 128;        // bytes: 64 bfloat16 columns
constexpr uint32_t kQChunk = kBQ * kBoxRow;  // one 64-column box of Q
constexpr uint32_t kKChunk = kBK * kBoxRow;  // one 64-column box of K / V
constexpr float kNegInf = -1e30f;
constexpr int kSmemMax = 232448;
constexpr int kMaxDevices = 64;
// error codes past the runtime's: the CUDA driver's encoder is missing, or it
// refused a tensor map (the CUresult is added)
constexpr int kErrNoEncoder = 100000;
constexpr int kErrEncode = 100001;

struct Params {
  __nv_bfloat16* o;
  int L, H, KH, hd, window, causal;
  float scale_log2;                      // hd^-0.5 * log2(e)
};

template <int HDP>
__host__ __device__ constexpr uint32_t tile_bytes_q() {
  return (HDP / 64) * kQChunk;
}
template <int HDP>
__host__ __device__ constexpr uint32_t tile_bytes_kv() {
  return (HDP / 64) * kKChunk;
}
template <int HDP>
__host__ __device__ constexpr int smem_bytes() {
  // 1024 bytes of slack to align the tiles for the 128-byte swizzle, the
  // tiles, then 7 mbarriers
  return 1024 + tile_bytes_q<HDP>() + 2 * kStages * tile_bytes_kv<HDP>() + 64;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// one box {64 columns, 1 head, rows, 1 batch} of a 4-d tensor map into
// shared memory, completing `bytes` on the mbarrier
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int head,
                                         int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(head),
      "r"(row), "r"(batch) : "memory");
}

// wgmma shared-memory descriptor of a tile written by TMA with the 128-byte
// swizzle (layout type 1): start address, leading and stride byte offsets,
// all in 16-byte units. Tiles start on 1024-byte boundaries, so the base
// offset is 0; a K-major operand steps 32 bytes per 16 columns inside the
// swizzle atom, and the stride byte offset (1024) steps 8 rows.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous products
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// D (64 x 128, float32) (+)= A (64 x 16, shared) * B (16 x 128, shared),
// both operands K-major (trans-a = trans-b = 0); scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63 "
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 128, float32) += A (64 x 16 from registers: the score fragment
// packed to bfloat16x2) * B (16 x 128, shared, MN-major: trans-b = 1).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], uint32_t a0,
                                              uint32_t a1, uint32_t a2,
                                              uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63 "
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db),
        "r"(1));
}

// D (64 x 64, float32) += A (64 x 16 from registers: the score fragment
// packed to bfloat16x2) * B (16 x 64, shared, MN-major: trans-b = 1).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], uint32_t a0,
                                              uint32_t a1, uint32_t a2,
                                              uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db),
        "r"(1));
}

template <int HDP>
__device__ __forceinline__ void wgmma_pv(float (&o)[HDP / 2], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t db) {
  if constexpr (HDP == 128) {
    wgmma_rs_n128(o, a0, a1, a2, a3, db);
  } else {
    wgmma_rs_n64(o, a0, a1, a2, a3, db);
  }
}

template <int HDP>
__global__ void __launch_bounds__(kThreads, 1)
swa_tc_kernel(const __grid_constant__ CUtensorMap tq,
              const __grid_constant__ CUtensorMap tk,
              const __grid_constant__ CUtensorMap tv, const Params P) {
  constexpr int kChunks = HDP / 64;
  constexpr uint32_t kQBytes = tile_bytes_q<HDP>();
  constexpr uint32_t kKVBytes = tile_bytes_kv<HDP>();
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sK = sQ + kQBytes;                 // + stage * kKVBytes
  const uint32_t sV = sK + kStages * kKVBytes;
  const uint32_t bars = sV + kStages * kKVBytes;
  const uint32_t q_full = bars;
  auto k_full = [&](int s) { return bars + 8u * (1 + s); };
  auto v_full = [&](int s) { return bars + 8u * (1 + kStages + s); };
  auto empty = [&](int s) { return bars + 8u * (1 + 2 * kStages + s); };

  // the heaviest query blocks (late in the sequence) are scheduled first
  const int i0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (P.H / P.KH);
  const int L = P.L;
  // the band of key rows any of this block's query rows can see
  const int last = P.causal ? min(L - 1, i0 + kBQ - 1) : L - 1;
  const int first = P.window ? max(0, i0 - P.window + 1) : 0;
  const int tile0 = first / kBK;
  const int n_tiles = last / kBK - tile0 + 1;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {       // the producer warp
    if (threadIdx.x == kConsumers) {
      mbar_expect_tx(q_full, kQBytes);
      for (int c = 0; c < kChunks; ++c)
        tma_load(sQ + c * kQChunk, &tq, q_full, 64 * c, h, i0, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        const int j0 = (tile0 + t) * kBK;
        // a fresh barrier passes the wait on parity 1 at once
        mbar_wait(empty(s), ((t / kStages) & 1) ^ 1);
        mbar_expect_tx(k_full(s), kKVBytes);
        for (int c = 0; c < kChunks; ++c)
          tma_load(sK + s * kKVBytes + c * kKChunk, &tk, k_full(s), 64 * c,
                   kh, j0, b);
        mbar_expect_tx(v_full(s), kKVBytes);
        for (int c = 0; c < kChunks; ++c)
          tma_load(sV + s * kKVBytes + c * kKChunk, &tv, v_full(s), 64 * c,
                   kh, j0, b);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns query rows r0 .. r0 + 63; this thread
  // holds rows row and row + 8 of the accumulator fragments, at columns
  // 8 c + 2 t4 + {0, 1}
  const int wg = threadIdx.x / 128;
  const int w = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int r0 = i0 + 64 * wg;
  const int row = r0 + 16 * w + g;
  const float sl2 = P.scale_log2;

  float o[HDP / 2];
#pragma unroll
  for (int e = 0; e < HDP / 2; ++e) o[e] = 0.f;
  float s[kBK / 2];
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  const uint32_t q_rows = sQ + wg * 64 * kBoxRow;

  mbar_wait(q_full, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % kStages;
    const uint32_t parity = (t / kStages) & 1;
    const int j0 = (tile0 + t) * kBK;
    const uint32_t k_tile = sK + st * kKVBytes;
    const uint32_t v_tile = sV + st * kKVBytes;

    // S = Q K^T over hd in steps of 16 (columns past hd are zeros)
    mbar_wait(k_full(st), parity);
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HDP / 16; ++kk) {
      const uint32_t off = (kk / 4) * kQChunk + (kk % 4) * 32;
      const uint32_t koff = (kk / 4) * kKChunk + (kk % 4) * 32;
      wgmma_ss_n128(s, sw128_desc(q_rows + off, 16, 1024),
                    sw128_desc(k_tile + koff, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // scale into base 2; mask only tiles that cross an edge for these rows
    const bool edge = j0 + kBK > L ||
                      (P.causal && j0 + kBK - 1 > r0) ||
                      (P.window && j0 <= r0 + 63 - P.window);
    if (edge) {
#pragma unroll
      for (int e = 0; e < kBK / 2; ++e) {
        const int i = row + 8 * ((e / 2) % 2);
        const int j = j0 + 8 * (e / 4) + 2 * t4 + (e % 2);
        bool vis = j < L;
        if (P.causal) vis = vis && j <= i;
        if (P.window) vis = vis && j > i - P.window;
        s[e] = vis ? s[e] * sl2 : kNegInf;
      }
    } else {
#pragma unroll
      for (int e = 0; e < kBK / 2; ++e) s[e] *= sl2;
    }

    // online softmax: row maxima over the 4 threads that share a row
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int c = 0; c < kBK / 8; ++c) {
      mx0 = fmaxf(mx0, fmaxf(s[4 * c], s[4 * c + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * c + 2], s[4 * c + 3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float n0 = fmaxf(m0, mx0), n1 = fmaxf(m1, mx1);
    const float alpha0 = exp2f(m0 - n0), alpha1 = exp2f(m1 - n1);
    m0 = n0;
    m1 = n1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int c = 0; c < kBK / 8; ++c) {
      s[4 * c] = exp2f(s[4 * c] - n0);
      s[4 * c + 1] = exp2f(s[4 * c + 1] - n0);
      s[4 * c + 2] = exp2f(s[4 * c + 2] - n1);
      s[4 * c + 3] = exp2f(s[4 * c + 3] - n1);
      sum0 += s[4 * c] + s[4 * c + 1];
      sum1 += s[4 * c + 2] + s[4 * c + 3];
    }
    // this thread's share of l; the 4 shares of a row are summed at the end
    l0 = l0 * alpha0 + sum0;
    l1 = l1 * alpha1 + sum1;
#pragma unroll
    for (int c = 0; c < HDP / 8; ++c) {
      o[4 * c] *= alpha0;
      o[4 * c + 1] *= alpha0;
      o[4 * c + 2] *= alpha1;
      o[4 * c + 3] *= alpha1;
    }
    // P in bfloat16: the accumulator fragment of columns 16 kk .. 16 kk + 15
    // is the register A fragment of the k-step kk of P V
    uint32_t p[kBK / 4];
#pragma unroll
    for (int e = 0; e < kBK / 4; ++e) p[e] = pack_bf16(s[2 * e], s[2 * e + 1]);

    // O += P V over the tile's keys in steps of 16 (V MN-major: the
    // leading byte offset steps 64 columns of hd, the stride 8 keys)
    mbar_wait(v_full(st), parity);
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      wgmma_pv<HDP>(o, p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3],
                    sw128_desc(v_tile + kk * 16 * kBoxRow, kKChunk, 1024));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    mbar_arrive(empty(st));
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float den0 = fmaxf(l0, 1e-30f), den1 = fmaxf(l1, 1e-30f);
  const int64_t row_stride = static_cast<int64_t>(P.H) * P.hd;
  __nv_bfloat16* out0 =
      P.o + (static_cast<int64_t>(b) * L + row) * row_stride + h * P.hd;
  __nv_bfloat16* out1 = out0 + 8 * row_stride;
#pragma unroll
  for (int c = 0; c < HDP / 8; ++c) {
    const int col = 8 * c + 2 * t4;
    if (col < P.hd) {
      if (row < L)
        *reinterpret_cast<__nv_bfloat162*>(out0 + col) =
            __floats2bfloat162_rn(o[4 * c] / den0, o[4 * c + 1] / den0);
      if (row + 8 < L)
        *reinterpret_cast<__nv_bfloat162*>(out1 + col) =
            __floats2bfloat162_rn(o[4 * c + 2] / den1, o[4 * c + 3] / den1);
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    return lib == nullptr ? nullptr
                          : reinterpret_cast<EncodeTiled>(
                                dlsym(lib, "cuTensorMapEncodeTiled"));
  }();
  return fn;
}

// the tensor map of a (B, L, heads, hd) bfloat16 tensor with element
// strides st = (b, l, head) and a contiguous last axis: dimensions
// (hd, heads, L, B) innermost first, boxes of 64 columns x `rows` rows of
// one head, 128-byte swizzle, zeros outside the tensor
int encode(CUtensorMap* map, const void* ptr, int64_t B, int64_t L,
           int64_t heads, int64_t hd, const int64_t* st, uint32_t rows) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return kErrNoEncoder;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(L),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st[2]) * 2,
                                 static_cast<cuuint64_t>(st[1]) * 2,
                                 static_cast<cuuint64_t>(st[0]) * 2};
  const cuuint32_t box[4] = {64, 1, rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(ptr), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrEncode + static_cast<int>(r);
}

template <int HDP>
int launch(const CUtensorMap& mq, const CUtensorMap& mk,
           const CUtensorMap& mv, const Params& P, int64_t B,
           cudaStream_t stream) {
  constexpr int bytes = smem_bytes<HDP>();
  static_assert(bytes <= kSmemMax, "shared memory");
  // raise the kernel's shared-memory limit once per device, so that a call
  // inside CUDA-graph capture makes no attribute change
  static bool smem_set[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!smem_set[dev]) {
    err = cudaFuncSetAttribute(swa_tc_kernel<HDP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set[dev] = true;
  }
  const dim3 grid((P.L + kBQ - 1) / kBQ, P.H, static_cast<unsigned>(B));
  swa_tc_kernel<HDP><<<grid, kThreads, bytes, stream>>>(mq, mk, mv, P);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dims = {B, L, H, KH, hd}; strides = 9 element strides, axes (b, l, head)
// of q, k and v in that order. q (B, L, H, hd), k and v (B, L, KH, hd),
// bfloat16, last axis contiguous, base addresses 16-byte aligned and byte
// strides multiples of 16 (TMA's rule; the wrapper copies a tensor that
// breaks it); hd a multiple of 16 in [16, 128]. out (B, L, H, hd)
// contiguous bfloat16. window 0 is no window. Launches on `stream` and
// returns cudaGetLastError(), cudaErrorInvalidValue for shapes it does not
// take, or an error of the tensor-map encoder (see the error string).
extern "C" int swa_attention_tc(const void* q, const void* k, const void* v,
                                void* out, const int64_t* dims,
                                const int64_t* strides, int window,
                                int causal, float scale, void* stream) {
  const int64_t B = dims[0], L = dims[1], H = dims[2], KH = dims[3],
                hd = dims[4];
  if (B < 1 || B > 65535 || L < 1 || L > (int64_t{1} << 30) || H < 1 ||
      H > 65535 || KH < 1 || H % KH != 0 || hd < 16 || hd > 128 ||
      hd % 16 != 0 || window < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap mq, mk, mv;
  int err = encode(&mq, q, B, L, H, hd, strides, kBQ);
  if (err == 0) err = encode(&mk, k, B, L, KH, hd, strides + 3, kBK);
  if (err == 0) err = encode(&mv, v, B, L, KH, hd, strides + 6, kBK);
  if (err != 0) return err;
  Params P;
  P.o = static_cast<__nv_bfloat16*>(out);
  P.L = static_cast<int>(L);
  P.H = static_cast<int>(H);
  P.KH = static_cast<int>(KH);
  P.hd = static_cast<int>(hd);
  P.window = window;
  P.causal = causal;
  P.scale_log2 = scale * 1.4426950408889634f;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd <= 64) return launch<64>(mq, mk, mv, P, B, s);
  return launch<128>(mq, mk, mv, P, B, s);
}

extern "C" const char* swa_attention_tc_error_string(int code) {
  if (code == kErrNoEncoder)
    return "cuTensorMapEncodeTiled not found in libcuda.so.1";
  if (code >= kErrEncode) return "cuTensorMapEncodeTiled refused a tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
