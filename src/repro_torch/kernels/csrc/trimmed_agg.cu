// Fused coordinate-wise sort + rank-weighted combine for Hopper (sm_90a),
// over a table of leaves (a single tensor is a table of one):
//
//   out_l[i] = sum_{r < K} rw[r] * sort_asc(x_l[:, i])[r]
//
// for every leaf l of one stacked cohort, K client rows shared by the
// table, a row that the validity mask marks invalid taken as +inf.
//
// Replaces the TPU kernel src/repro/kernels/trimmed_agg.py::
// trimmed_agg_stacked (Pallas: _make_trimmed_kernel / trimmed_agg_tiles),
// the hot path of the trimmed-mean and median robust aggregators, for
// every leaf of one cohort in one launch. As there, the combine adds in
// rank order starting from +0.0, one float32 multiply then one float32 add
// per rank (__fmul_rn / __fadd_rn: no FMA), and a rank whose weight is
// exactly 0 is skipped (selected to 0), never multiplied: invalid rows sort
// as +inf and 0 * inf would be NaN. Skipping adds nothing else: the sum
// starts at +0.0 and can never become -0.0, so adding an exact 0 is an
// IEEE no-op. For the same reason the order of -0.0 and +0.0 changes no
// output.
//
// Order: ascending, invalid rows (+inf) after every number, a NaN of a
// valid row after them (the order of jnp.sort and torch.sort on
// where(valid, x, inf), which the oracle uses). Any NaN at a weighted rank
// gives NaN, whatever its sign or payload.
//
// Bound: HBM bytes. A leaf reads m*n*4 bytes of its m valid rows and
// writes n*4 of out: an invalid row is never read, its slot is set to +inf.
// Against that, K <= 32 costs a few integer instructions per value in
// registers. Design:
//   * The table: up to kMaxLeaves leaves travel by value as a
//     __grid_constant__ kernel parameter with the rank weights and the
//     K-bit validity mask (K <= kMaxRanks; above, both stay in device
//     memory), so an aggregation is one launch and no host-to-device copy.
//     A grid sized to the SMs walks the leaves' blocks in order; a block
//     finds its leaf in the table's cumulative block counts.
//   * Keys: each loaded float becomes an order-preserving int32 once (the
//     low 31 bits of a negative flipped, every NaN mapped to INT_MAX), so
//     a compare-exchange is one integer min and one max, with no NaN test.
//   * The sort (K <= 32): the K keys of one coordinate sit in registers,
//     sorted by Batcher's odd-even merge network of the bucket of 4, 8, 16
//     or 32 slots that holds K (5, 19, 63, 191 comparators; the lists are
//     in Net<> below), less every comparator that touches a slot past K:
//     such a slot would hold INT_MAX, which no comparator moves, so what
//     is left sorts the K keys (K = 5: 9 comparators, K = 10: 32). Each K
//     up to 32 has its own instance, every index a compile-time constant,
//     so the keys stay in registers.
//   * Vectors: a leaf whose n is a multiple of 4 with x and out 16-byte
//     aligned is read 4 coordinates a thread (K > 16: 2, to keep the keys
//     in registers) with 16-byte (8-byte) loads, neighbouring threads on
//     neighbouring addresses; any other leaf one coordinate a thread.
//   * Any K (above 32): no per-thread array. The rank-ordered values are
//     walked one successor at a time: the value at rank r is the least
//     (x_j, j) above the one at rank r - 1 under the order (value, then row
//     index), found by one pass over the K rows (re-read through L1). The
//     walk stops at the last rank whose weight is not 0 (the median stops
//     half way).
// Every K is compiled in, so a new cohort width or trim needs no rebuild.
#include <climits>
#include <cstdint>
#include <utility>
#include <cuda_runtime.h>

// One leaf of the table, as the wrapper packs it
// (repro_torch.kernels.trimmed_agg._LEAF packs this layout).
// Outside the unnamed namespace: the exported entry point takes it.
struct RankLeaf {
  const float* x;            // (K, n)
  float* out;                // (n,)
  int64_t n;
  int vec;                   // 1: n % 4 == 0 and x, out 16-byte aligned
  int pad;
};

constexpr int kMaxRanks = 32;  // K up to which rw and the mask go by value

// What every leaf of a table shares
// (repro_torch.kernels.trimmed_agg._PARAMS packs this layout).
struct RankParams {
  float rw[kMaxRanks];       // rank weights by value (rw_dev null)
  const float* rw_dev;       // or (K,) in device memory
  const unsigned char* valid_dev;  // K > kMaxRanks: (K,) in device memory
  uint32_t valid;            // K <= kMaxRanks: bit j set when row j is valid
  int masked;                // 0: every row valid
  int K;
  int pad;
};

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLeaves = 32;        // leaves in one table
constexpr int kInfKey = 0x7f800000;   // +inf: an invalid row
constexpr int kLastKey = INT_MAX;     // every NaN

// Batcher's odd-even merge sort of KB keys: comparator pairs (lo, hi) in
// the order they apply. tests/test_torch_trimmed_agg.py reads these
// lists from this file and checks that each, and each of its prunings to
// K < KB keys, sorts every 0/1 input.
template <int KB> struct Net;
template <> struct Net<4> {
  static constexpr int size = 5;
  static constexpr unsigned char pair[size][2] = {
      {0, 1}, {2, 3}, {0, 2}, {1, 3}, {1, 2}};
};
template <> struct Net<8> {
  static constexpr int size = 19;
  static constexpr unsigned char pair[size][2] = {
      {0, 1}, {2, 3}, {4, 5}, {6, 7}, {0, 2}, {1, 3}, {4, 6}, {5, 7},
      {1, 2}, {5, 6}, {0, 4}, {1, 5}, {2, 6}, {3, 7}, {2, 4}, {3, 5},
      {1, 2}, {3, 4}, {5, 6}};
};
template <> struct Net<16> {
  static constexpr int size = 63;
  static constexpr unsigned char pair[size][2] = {
      {0, 1}, {2, 3}, {4, 5}, {6, 7}, {8, 9}, {10, 11}, {12, 13},
      {14, 15}, {0, 2}, {1, 3}, {4, 6}, {5, 7}, {8, 10}, {9, 11},
      {12, 14}, {13, 15}, {1, 2}, {5, 6}, {9, 10}, {13, 14}, {0, 4},
      {1, 5}, {2, 6}, {3, 7}, {8, 12}, {9, 13}, {10, 14}, {11, 15},
      {2, 4}, {3, 5}, {10, 12}, {11, 13}, {1, 2}, {3, 4}, {5, 6}, {9, 10},
      {11, 12}, {13, 14}, {0, 8}, {1, 9}, {2, 10}, {3, 11}, {4, 12},
      {5, 13}, {6, 14}, {7, 15}, {4, 8}, {5, 9}, {6, 10}, {7, 11}, {2, 4},
      {3, 5}, {6, 8}, {7, 9}, {10, 12}, {11, 13}, {1, 2}, {3, 4}, {5, 6},
      {7, 8}, {9, 10}, {11, 12}, {13, 14}};
};
template <> struct Net<32> {
  static constexpr int size = 191;
  static constexpr unsigned char pair[size][2] = {
      {0, 1}, {2, 3}, {4, 5}, {6, 7}, {8, 9}, {10, 11}, {12, 13},
      {14, 15}, {16, 17}, {18, 19}, {20, 21}, {22, 23}, {24, 25},
      {26, 27}, {28, 29}, {30, 31}, {0, 2}, {1, 3}, {4, 6}, {5, 7},
      {8, 10}, {9, 11}, {12, 14}, {13, 15}, {16, 18}, {17, 19}, {20, 22},
      {21, 23}, {24, 26}, {25, 27}, {28, 30}, {29, 31}, {1, 2}, {5, 6},
      {9, 10}, {13, 14}, {17, 18}, {21, 22}, {25, 26}, {29, 30}, {0, 4},
      {1, 5}, {2, 6}, {3, 7}, {8, 12}, {9, 13}, {10, 14}, {11, 15},
      {16, 20}, {17, 21}, {18, 22}, {19, 23}, {24, 28}, {25, 29},
      {26, 30}, {27, 31}, {2, 4}, {3, 5}, {10, 12}, {11, 13}, {18, 20},
      {19, 21}, {26, 28}, {27, 29}, {1, 2}, {3, 4}, {5, 6}, {9, 10},
      {11, 12}, {13, 14}, {17, 18}, {19, 20}, {21, 22}, {25, 26},
      {27, 28}, {29, 30}, {0, 8}, {1, 9}, {2, 10}, {3, 11}, {4, 12},
      {5, 13}, {6, 14}, {7, 15}, {16, 24}, {17, 25}, {18, 26}, {19, 27},
      {20, 28}, {21, 29}, {22, 30}, {23, 31}, {4, 8}, {5, 9}, {6, 10},
      {7, 11}, {20, 24}, {21, 25}, {22, 26}, {23, 27}, {2, 4}, {3, 5},
      {6, 8}, {7, 9}, {10, 12}, {11, 13}, {18, 20}, {19, 21}, {22, 24},
      {23, 25}, {26, 28}, {27, 29}, {1, 2}, {3, 4}, {5, 6}, {7, 8},
      {9, 10}, {11, 12}, {13, 14}, {17, 18}, {19, 20}, {21, 22}, {23, 24},
      {25, 26}, {27, 28}, {29, 30}, {0, 16}, {1, 17}, {2, 18}, {3, 19},
      {4, 20}, {5, 21}, {6, 22}, {7, 23}, {8, 24}, {9, 25}, {10, 26},
      {11, 27}, {12, 28}, {13, 29}, {14, 30}, {15, 31}, {8, 16}, {9, 17},
      {10, 18}, {11, 19}, {12, 20}, {13, 21}, {14, 22}, {15, 23}, {4, 8},
      {5, 9}, {6, 10}, {7, 11}, {12, 16}, {13, 17}, {14, 18}, {15, 19},
      {20, 24}, {21, 25}, {22, 26}, {23, 27}, {2, 4}, {3, 5}, {6, 8},
      {7, 9}, {10, 12}, {11, 13}, {14, 16}, {15, 17}, {18, 20}, {19, 21},
      {22, 24}, {23, 25}, {26, 28}, {27, 29}, {1, 2}, {3, 4}, {5, 6},
      {7, 8}, {9, 10}, {11, 12}, {13, 14}, {15, 16}, {17, 18}, {19, 20},
      {21, 22}, {23, 24}, {25, 26}, {27, 28}, {29, 30}};
};

// comparator C of Net<KB> as scalar constants, usable in device code
template <int KB, size_t C> struct Cmp {
  static constexpr int lo = Net<KB>::pair[C][0];
  static constexpr int hi = Net<KB>::pair[C][1];
};

struct Table {
  RankLeaf leaf[kMaxLeaves];
  int64_t block_end[kMaxLeaves];   // cumulative blocks up to each leaf
  RankParams p;
  int count;                       // leaves in use
};

__device__ __forceinline__ int to_key(float v) {
  const int b = __float_as_int(v);
  return (b & 0x7fffffff) > 0x7f800000 ? kLastKey
                                       : b ^ ((b >> 31) & 0x7fffffff);
}

__device__ __forceinline__ float from_key(int k) {
  return __int_as_float(k ^ ((k >> 31) & 0x7fffffff));
}

__device__ __forceinline__ float weight(const RankParams& p, int r) {
  return p.rw_dev ? __ldg(p.rw_dev + r) : p.rw[r];
}

__device__ __forceinline__ bool row_valid(const RankParams& p, int j) {
  if (!p.masked) return true;
  return p.valid_dev ? p.valid_dev[j] != 0 : (p.valid >> j) & 1u;
}

__device__ __forceinline__ float add_rank(float acc, float w, float v) {
  return w != 0.0f ? __fadd_rn(acc, __fmul_rn(w, v)) : acc;
}

template <int V, int K>
__device__ __forceinline__ void compare_exchange(int (&key)[V][K], int lo,
                                                 int hi) {
#pragma unroll
  for (int c = 0; c < V; ++c) {
    const int a = key[c][lo], b = key[c][hi];
    key[c][lo] = min(a, b);
    key[c][hi] = max(a, b);
  }
}

// comparator C of the bucket's network, left out where it touches a slot
// past K
template <int K, int KB, size_t C, int V>
__device__ __forceinline__ void network_step(int (&key)[V][K]) {
  if constexpr (Cmp<KB, C>::hi < K)
    compare_exchange<V, K>(key, Cmp<KB, C>::lo, Cmp<KB, C>::hi);
}

template <int K, int KB, int V, size_t... C>
__device__ __forceinline__ void sort_keys(int (&key)[V][K],
                                          std::index_sequence<C...>) {
  (network_step<K, KB, C, V>(key), ...);
}

// V neighbouring coordinates of one row, from unit u (coordinates u*V ..)
template <int V>
__device__ __forceinline__ void load(const float* row, int64_t u,
                                     float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(row) + u);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else if constexpr (V == 2) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(row) + u);
    v[0] = t.x; v[1] = t.y;
  } else {
    v[0] = __ldg(row + u);
  }
}

template <int V>
__device__ __forceinline__ void store(float* out, int64_t u,
                                      const float (&v)[V]) {
  if constexpr (V == 4)
    reinterpret_cast<float4*>(out)[u] = make_float4(v[0], v[1], v[2], v[3]);
  else if constexpr (V == 2)
    reinterpret_cast<float2*>(out)[u] = make_float2(v[0], v[1]);
  else
    out[u] = v[0];
}

// coordinates u*V .. u*V + V - 1 of leaf f, the cohort sorted in registers
template <int K, int V>
__device__ __forceinline__ void combine_registers(const RankParams& p,
                                                  const RankLeaf& f,
                                                  int64_t u) {
  constexpr int KB = K <= 4 ? 4 : K <= 8 ? 8 : K <= 16 ? 16 : 32;
  int key[V][K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    if (!p.masked || (p.valid >> j) & 1u) {
      float v[V];
      load<V>(f.x + static_cast<int64_t>(j) * f.n, u, v);
#pragma unroll
      for (int c = 0; c < V; ++c) key[c][j] = to_key(v[c]);
    } else {
#pragma unroll
      for (int c = 0; c < V; ++c) key[c][j] = kInfKey;
    }
  }
  sort_keys<K, KB, V>(key, std::make_index_sequence<Net<KB>::size>{});
  float acc[V];
#pragma unroll
  for (int c = 0; c < V; ++c) acc[c] = 0.0f;
#pragma unroll
  for (int r = 0; r < K; ++r) {
    const float w = weight(p, r);
#pragma unroll
    for (int c = 0; c < V; ++c) acc[c] = add_rank(acc[c], w,
                                                  from_key(key[c][r]));
  }
  store<V>(f.out, u, acc);
}

template <int K, int V>
__global__ void __launch_bounds__(kThreads)
trimmed_agg_registers(const __grid_constant__ Table T) {
  const int64_t total = T.block_end[T.count - 1];
  int li = 0;
  for (int64_t blk = blockIdx.x; blk < total; blk += gridDim.x) {
    while (blk >= T.block_end[li]) ++li;
    const RankLeaf& f = T.leaf[li];
    const int64_t u = (blk - (li ? T.block_end[li - 1] : 0)) * kThreads
                      + threadIdx.x;
    if (f.vec) {
      if (u < f.n / V) combine_registers<K, V>(T.p, f, u);
    } else if (u < f.n) {
      combine_registers<K, 1>(T.p, f, u);
    }
  }
}

// (a, ia) strictly before (b, ib): value order with NaN greatest, then row
__device__ __forceinline__ bool before(float a, int ia, float b, int ib) {
  const bool an = isnan(a), bn = isnan(b);
  if (an != bn) return bn;
  if (!an && a != b) return a < b;
  return ia < ib;
}

__global__ void __launch_bounds__(kThreads)
trimmed_agg_any(const __grid_constant__ Table T) {
  const RankParams& p = T.p;
  const int K = p.K;
  int last = -1;                       // last rank with a weight != 0
  for (int r = K - 1; r >= 0; --r)
    if (weight(p, r) != 0.0f) { last = r; break; }
  const int64_t total = T.block_end[T.count - 1];
  int li = 0;
  for (int64_t blk = blockIdx.x; blk < total; blk += gridDim.x) {
    while (blk >= T.block_end[li]) ++li;
    const RankLeaf& f = T.leaf[li];
    const int64_t i = (blk - (li ? T.block_end[li - 1] : 0)) * kThreads
                      + threadIdx.x;
    if (i >= f.n) continue;
    float acc = 0.0f, pv = 0.0f;
    int pj = -1;                       // (pv, pj): the value at rank r - 1
    for (int r = 0; r <= last; ++r) {
      float bv = 0.0f;
      int bj = -1;
      for (int j = 0; j < K; ++j) {
        const float v = row_valid(p, j)
            ? __ldg(f.x + static_cast<int64_t>(j) * f.n + i)
            : __int_as_float(kInfKey);
        if (pj >= 0 && !before(pv, pj, v, j)) continue;
        if (bj < 0 || before(v, j, bv, bj)) { bv = v; bj = j; }
      }
      pv = bv;
      pj = bj;
      acc = add_rank(acc, weight(p, r), bv);
    }
    f.out[i] = acc;
  }
}

// blocks of `kernel` that fit on the card at once: the grid's cap
template <typename Kernel>
int64_t resident_blocks(Kernel kernel) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                0);
  return static_cast<int64_t>(sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
}

template <int K>
int launch_registers(Table& T, const RankLeaf* leaves, cudaStream_t s) {
  constexpr int V = K <= 16 ? 4 : 2;
  int64_t blocks = 0;
  for (int l = 0; l < kMaxLeaves; ++l) {
    if (l < T.count) {
      const RankLeaf& f = leaves[l];
      if (f.n < 1) return static_cast<int>(cudaErrorInvalidValue);
      T.leaf[l] = f;
      const int64_t units = f.vec ? f.n / V : f.n;
      blocks += (units + kThreads - 1) / kThreads;
    } else {
      T.leaf[l] = RankLeaf{};
    }
    T.block_end[l] = blocks;
  }
  static const int64_t cap = resident_blocks(trimmed_agg_registers<K, V>);
  const unsigned grid = static_cast<unsigned>(blocks < cap ? blocks : cap);
  trimmed_agg_registers<K, V><<<grid, kThreads, 0, s>>>(T);
  return static_cast<int>(cudaGetLastError());
}

// the instance of K = k + 1 for k in 0 .. kMaxRanks - 1
template <int... k>
int launch_registers_for(int K, Table& T, const RankLeaf* leaves,
                         cudaStream_t s, std::integer_sequence<int, k...>) {
  int err = static_cast<int>(cudaErrorInvalidValue);
  ((K == k + 1 ? (err = launch_registers<k + 1>(T, leaves, s)) : 0), ...);
  return err;
}

int launch_any(Table& T, const RankLeaf* leaves, cudaStream_t s) {
  int64_t blocks = 0;
  for (int l = 0; l < kMaxLeaves; ++l) {
    if (l < T.count) {
      const RankLeaf& f = leaves[l];
      if (f.n < 1) return static_cast<int>(cudaErrorInvalidValue);
      T.leaf[l] = f;
      blocks += (f.n + kThreads - 1) / kThreads;
    } else {
      T.leaf[l] = RankLeaf{};
    }
    T.block_end[l] = blocks;
  }
  static const int64_t cap = resident_blocks(trimmed_agg_any);
  const unsigned grid = static_cast<unsigned>(blocks < cap ? blocks : cap);
  trimmed_agg_any<<<grid, kThreads, 0, s>>>(T);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// leaves[0 .. count) on the device, count in [1, kMaxLeaves = 32], every
// n > 0, each leaf's x (K, n) and out (n,) float32 contiguous (vec set
// only where the 16-byte path applies); params->K >= 1 shared by the
// table, the rank weights by value or at rw_dev, and for K > kMaxRanks
// rw_dev set and, when masked, valid_dev. One launch on `stream` writes
// every leaf's out; returns cudaGetLastError() (cudaErrorInvalidValue for
// a table it does not take).
extern "C" int trimmed_agg_leaves(const RankLeaf* leaves, int count,
                                  const RankParams* params, void* stream) {
  if (count < 1 || count > kMaxLeaves || params == nullptr || params->K < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const RankParams& p = *params;
  if (p.K > kMaxRanks && (p.rw_dev == nullptr
                          || (p.masked && p.valid_dev == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  Table T;
  T.p = p;
  T.count = count;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.K <= kMaxRanks)
    return launch_registers_for(p.K, T, leaves, s,
                                std::make_integer_sequence<int, kMaxRanks>{});
  return launch_any(T, leaves, s);
}

extern "C" const char* trimmed_agg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
