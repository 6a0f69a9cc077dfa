// Grouped matrix products over contiguous row groups, for Hopper (sm_90a).
//
// Replaces tf_operator_tpu/models/moe.py::_grouped_matmul, the product the
// MoE LM's dropless dispatch runs per expert: under TPUJOB_MOE_GMM=megablox
// it reaches pl.pallas_call through megablox's gmm (forward, and dX as gmm
// on the transposed rhs) and tgmm (dW); by default it is lax.ragged_dot.
// Built by tf_operator_tpu_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// into a shared library with the plain C interface at the bottom of this
// file, loaded with ctypes by tf_operator_tpu_torch/ops/grouped_matmul.py.
//
// What it computes. The rows of x [M, K] are split into groups of
// group_sizes[e] consecutive rows, in group order (the exclusive scan of
// group_sizes gives each group's first row). Of the groups, `local` of them,
// from `first` on, have weights here (an expert-parallel rank holds its own
// experts' weights only):
//   gmm NN:  out[rows of g] = x[rows of g] . w[g]       w [local, K, N]
//   gmm NT:  out[rows of g] = x[rows of g] . w[g]^T     w [local, N, K]
//   tgmm:    dw[g] = x[rows of g]^T . dy[rows of g]     dw [local, K, N] f32
// Rows of groups without weights here, and rows past the groups' sum, are
// not written: the wrapper zero-fills out. tgmm writes every dw[g] whole,
// zeros for an empty group. Products accumulate in f32; gmm rounds its
// output to the inputs' dtype.
//
// What bounds it on the H100: at the MoE cell (M = 8 x 2048 x 2 = 32768
// rows, 8 experts, K x N = 768 x 3072 or 3072 x 768) every launch is
// 2 M K N = 154.6 GFLOP against at most 289 MB of operands and result, so
// the bound is operations (0.156 ms at 989 TF/s bf16).
//
// The design, a first simple version that is right:
//   - Tiles to groups without the host. A gmm block takes one (group, 128-row
//     tile) work item: tiles are cut per group, so a tile that straddles two
//     groups is run once for each, and each run reads and writes only its
//     group's rows (rows outside are loaded as zeros and never stored), so
//     no tile mixes two experts' weights. The grid holds ceil(M / 128) +
//     local items, the most there can be; each block finds its item by
//     scanning group_sizes itself (a few dozen integer adds), so nothing
//     syncs with the host and empty groups simply have no items. Blocks
//     past the last item return.
//   - tgmm's ragged dimension is the reduction: one block per (group,
//     128 x 128 tile of dw) loops over the group's rows in 32-row steps, the
//     last step zero-filled past the group's end.
//   - bf16 products on the tensor cores with mma.sync m16n8k16 (f32
//     accumulators): 128 x 128 x 32 block tiles, eight warps of 64 x 32,
//     operands staged through registers into two shared-memory stages
//     (padded rows, so ldmatrix reads without bank conflicts), the next
//     k-tile's global loads in flight while the tensor cores run this one.
//     Both operands are read as they lie: ldmatrix.trans gives the
//     fragments of an operand whose reduction dimension is not contiguous
//     (w in NN, x in tgmm), so the wrapper copies nothing. Every row and
//     column bound is guarded: a 16-byte load where a whole aligned chunk
//     of 8 is in bounds, element loads with zero fill elsewhere.
//   - f32 inputs run the same tiling logic on FMA units (64 x 64 tiles,
//     4 x 4 outputs a thread), at any K and N.
// TMA, wgmma and a persistent schedule are the next steps for speed.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int THREADS = 256;

// ---------------------------------------------------------------------------
// Groups
// ---------------------------------------------------------------------------

// The rows [lo, hi) of one gmm work item: local group `group`, and the
// tile of `tile_rows` rows that starts at row0.
struct Item {
  int group;
  int row0;
  int lo;
  int hi;
};

// Work item `item` of the gmm grid, or false when there is none: items are
// the (group, tile) pairs of the local groups' non-empty row ranges, in
// group then tile order. Negative sizes count as 0; rows past m are dropped.
__device__ bool find_item(const int* sizes, int first, int local, int m, int tile_rows,
                          int item, Item* out) {
  long start = 0;
  for (int g = 0; g < first; ++g) start += max(sizes[g], 0);
  for (int j = 0; j < local; ++j) {
    const long size = max(sizes[first + j], 0);
    const int s = static_cast<int>(min(start, static_cast<long>(m)));
    const int e = static_cast<int>(min(start + size, static_cast<long>(m)));
    if (e > s) {
      const int t0 = s / tile_rows;
      const int count = (e - 1) / tile_rows - t0 + 1;
      if (item < count) {
        const int row0 = (t0 + item) * tile_rows;
        *out = Item{j, row0, max(s, row0), min(e, row0 + tile_rows)};
        return true;
      }
      item -= count;
    }
    start += size;
  }
  return false;
}

// The rows [lo, hi) of local group `j`.
__device__ void group_rows(const int* sizes, int first, int j, int m, int* lo, int* hi) {
  long start = 0;
  for (int g = 0; g < first + j; ++g) start += max(sizes[g], 0);
  const long end = start + max(sizes[first + j], 0);
  *lo = static_cast<int>(min(start, static_cast<long>(m)));
  *hi = static_cast<int>(min(end, static_cast<long>(m)));
}

// ---------------------------------------------------------------------------
// bf16: mma.sync m16n8k16
// ---------------------------------------------------------------------------

constexpr int BM = 128, BN = 128, BK = 32;
constexpr int PAD = 8;  // bf16 elements of padding per shared row (16 bytes)

// Eight bf16 of row `row`, columns [col, col + 8), of a row-major matrix with
// leading dimension ld; zeros where the row is outside the tile's valid rows
// or a column is at or past col_hi.
__device__ __forceinline__ uint4 load8(const uint16_t* base, long ld, int row, int col,
                                       bool row_ok, int col_hi) {
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (!row_ok || col >= col_hi) return v;
  const uint16_t* p = base + static_cast<long>(row) * ld + col;
  if (col + 8 <= col_hi && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    return *reinterpret_cast<const uint4*>(p);
  }
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    if (col + i < col_hi) w[i / 2] |= static_cast<uint32_t>(p[i]) << (16 * (i % 2));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// A ROWS x COLS bf16 tile of a row-major global matrix, staged through
// registers into shared memory with rows COLS + PAD elements apart. Rows
// outside [row_lo, row_hi) and columns at or past col_hi read as zero.
template <int ROWS, int COLS>
struct Tile {
  static constexpr int CHUNKS = ROWS * COLS / 8 / THREADS;
  static constexpr int STRIDE = COLS + PAD;
  static_assert(CHUNKS * 8 * THREADS == ROWS * COLS, "tile must split evenly");
  uint4 regs[CHUNKS];

  __device__ __forceinline__ void load(const uint16_t* base, long ld, int row0, int row_lo,
                                       int row_hi, int col0, int col_hi) {
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c) {
      const int idx = threadIdx.x + c * THREADS;
      const int r = idx / (COLS / 8);
      const int cc = (idx % (COLS / 8)) * 8;
      const int row = row0 + r;
      regs[c] = load8(base, ld, row, col0 + cc, row >= row_lo && row < row_hi, col_hi);
    }
  }

  __device__ __forceinline__ void store(uint16_t* smem) const {
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c) {
      const int idx = threadIdx.x + c * THREADS;
      const int r = idx / (COLS / 8);
      const int cc = (idx % (COLS / 8)) * 8;
      *reinterpret_cast<uint4*>(smem + r * STRIDE + cc) = regs[c];
    }
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const uint16_t* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const uint16_t* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The shared layouts of one k-step's operands. A_T: A is stored [k][m]
// (tgmm's x, whose reduction rows are its rows), else [m][k]. B_T: B is
// stored [n][k] (NT's w[g] as it lies), else [k][n].
template <bool A_T, bool B_T>
struct Layout {
  static constexpr int A_ROWS = A_T ? BK : BM;
  static constexpr int A_COLS = A_T ? BM : BK;
  static constexpr int B_ROWS = B_T ? BN : BK;
  static constexpr int B_COLS = B_T ? BK : BN;
  static constexpr int A_ELEMS = A_ROWS * (A_COLS + PAD);
  static constexpr int B_ELEMS = B_ROWS * (B_COLS + PAD);
};

// acc += A . B over one BK-deep shared stage. Warp w computes rows
// (w / 4) * 64 + [0, 64) and columns (w % 4) * 32 + [0, 32) of the block's
// 128 x 128 tile: 4 m16 tiles x 4 n8 tiles, two k16 steps.
template <bool A_T, bool B_T>
__device__ __forceinline__ void mma_stage(float (&acc)[4][4][4], const uint16_t* sa,
                                          const uint16_t* sb) {
  using L = Layout<A_T, B_T>;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wm0 = (warp >> 2) * 64;
  const int wn0 = (warp & 3) * 32;
#pragma unroll
  for (int kk = 0; kk < BK; kk += 16) {
    uint32_t a[4][4];
    uint32_t b[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (A_T) {
        // Matrices (k 0-7, m 0-7), (k 0-7, m 8-15), (k 8-15, m 0-7),
        // (k 8-15, m 8-15), transposed: a0..a3 of the m16 x k16 fragment.
        const int k = kk + (lane & 7) + ((lane >> 4) << 3);
        const int m = wm0 + 16 * i + (((lane >> 3) & 1) << 3);
        ldsm_x4_trans(a[i], sa + k * (L::A_COLS + PAD) + m);
      } else {
        const int m = wm0 + 16 * i + (lane & 15);
        const int k = kk + ((lane >> 4) << 3);
        ldsm_x4(a[i], sa + m * (L::A_COLS + PAD) + k);
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      // Matrices (k 0-7, n 0-7), (k 8-15, n 0-7), (k 0-7, n 8-15),
      // (k 8-15, n 8-15): b0, b1 of n8 tile 2j, then of tile 2j + 1.
      uint32_t r[4];
      if (B_T) {
        const int n = wn0 + 16 * j + ((lane >> 4) << 3) + (lane & 7);
        const int k = kk + (((lane >> 3) & 1) << 3);
        ldsm_x4(r, sb + n * (L::B_COLS + PAD) + k);
      } else {
        const int k = kk + (lane & 7) + (((lane >> 3) & 1) << 3);
        const int n = wn0 + 16 * j + ((lane >> 4) << 3);
        ldsm_x4_trans(r, sb + k * (L::B_COLS + PAD) + n);
      }
      b[2 * j][0] = r[0];
      b[2 * j][1] = r[1];
      b[2 * j + 1][0] = r[2];
      b[2 * j + 1][1] = r[3];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int jn = 0; jn < 4; ++jn) mma_bf16(acc[i][jn], a[i], b[jn]);
    }
  }
}

// The operands of one block's reduction: A's and B's global matrices, each
// tile's rows as (origin, valid range) and columns as (origin, limit), the
// reduction range [red_lo, red_hi) walked in BK steps along A's and B's
// reduction dimension (A's columns, or its rows under A_T; B's rows, or its
// columns under B_T).
struct Operands {
  const uint16_t* a;
  long lda;
  int a_lo, a_hi;   // valid rows of A's non-reduction dimension (m)
  int a_m0;         // the tile's first m
  int a_mlim;       // A's m limit (tgmm: K of x)
  const uint16_t* b;
  long ldb;
  int b_n0, b_nlim;  // the tile's first n, and n's limit
  int red_lo, red_hi;
};

template <bool A_T, bool B_T>
__device__ __forceinline__ void load_stage(Tile<Layout<A_T, B_T>::A_ROWS,
                                                Layout<A_T, B_T>::A_COLS>& ta,
                                           Tile<Layout<A_T, B_T>::B_ROWS,
                                                Layout<A_T, B_T>::B_COLS>& tb,
                                           const Operands& op, int k0) {
  if (A_T) {  // rows are reduction rows, columns m
    ta.load(op.a, op.lda, k0, op.red_lo, op.red_hi, op.a_m0, op.a_mlim);
  } else {    // rows m, columns the reduction
    ta.load(op.a, op.lda, op.a_m0, op.a_lo, op.a_hi, k0, op.red_hi);
  }
  if (B_T) {  // rows n, columns the reduction
    tb.load(op.b, op.ldb, op.b_n0, 0, op.b_nlim, k0, op.red_hi);
  } else {    // rows the reduction, columns n
    tb.load(op.b, op.ldb, k0, op.red_lo, op.red_hi, op.b_n0, op.b_nlim);
  }
}

// The block's 128 x 128 f32 tile of A . B over the reduction range.
template <bool A_T, bool B_T>
__device__ __forceinline__ void block_product(float (&acc)[4][4][4], const Operands& op) {
  using L = Layout<A_T, B_T>;
  __shared__ __align__(16) uint16_t sa[2][L::A_ELEMS];
  __shared__ __align__(16) uint16_t sb[2][L::B_ELEMS];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;
  const int steps = op.red_hi > op.red_lo ? (op.red_hi - op.red_lo + BK - 1) / BK : 0;
  if (steps == 0) return;
  Tile<L::A_ROWS, L::A_COLS> ta;
  Tile<L::B_ROWS, L::B_COLS> tb;
  load_stage<A_T, B_T>(ta, tb, op, op.red_lo);
  ta.store(sa[0]);
  tb.store(sb[0]);
  __syncthreads();
  for (int s = 0; s < steps; ++s) {
    const int cur = s & 1;
    const bool next = s + 1 < steps;
    if (next) load_stage<A_T, B_T>(ta, tb, op, op.red_lo + (s + 1) * BK);
    mma_stage<A_T, B_T>(acc, sa[cur], sb[cur]);
    if (next) {
      ta.store(sa[cur ^ 1]);
      tb.store(sb[cur ^ 1]);
    }
    __syncthreads();
  }
}

// gmm: one (group, 128-row tile) item x one 128-column tile of out.
template <bool NT>
__global__ void __launch_bounds__(THREADS)
gmm_mma_kernel(const uint16_t* __restrict__ x, const uint16_t* __restrict__ w,
               const int* __restrict__ sizes, __nv_bfloat16* __restrict__ out, int m, int k,
               int n, int first, int local) {
  __shared__ Item item;
  __shared__ bool found;
  if (threadIdx.x == 0) found = find_item(sizes, first, local, m, BM, blockIdx.x, &item);
  __syncthreads();
  if (!found) return;
  const int n0 = blockIdx.y * BN;
  Operands op;
  op.a = x;
  op.lda = k;
  op.a_lo = item.lo;
  op.a_hi = item.hi;
  op.a_m0 = item.row0;
  op.a_mlim = m;
  op.b = w + static_cast<long>(item.group) * k * n;
  op.ldb = NT ? k : n;
  op.b_n0 = n0;
  op.b_nlim = n;
  op.red_lo = 0;
  op.red_hi = k;
  float acc[4][4][4];
  block_product<false, NT>(acc, op);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = item.row0 + (warp >> 2) * 64 + 16 * i + g + 8 * half;
      if (row < item.lo || row >= item.hi) continue;
#pragma unroll
      for (int jn = 0; jn < 4; ++jn) {
        const int col = n0 + (warp & 3) * 32 + 8 * jn + 2 * t;
        const float v0 = acc[i][jn][2 * half], v1 = acc[i][jn][2 * half + 1];
        __nv_bfloat16* p = out + static_cast<long>(row) * n + col;
        if (col + 1 < n && (reinterpret_cast<uintptr_t>(p) & 3) == 0) {
          *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
        } else {
          if (col < n) p[0] = __float2bfloat16_rn(v0);
          if (col + 1 < n) p[1] = __float2bfloat16_rn(v1);
        }
      }
    }
  }
}

// tgmm: one local group (blockIdx.z) x one 128 x 128 tile of dw[g] [K, N].
__global__ void __launch_bounds__(THREADS)
tgmm_mma_kernel(const uint16_t* __restrict__ x, const uint16_t* __restrict__ dy,
                const int* __restrict__ sizes, float* __restrict__ dw, int m, int k, int n,
                int first) {
  __shared__ int rows[2];
  if (threadIdx.x == 0) group_rows(sizes, first, blockIdx.z, m, &rows[0], &rows[1]);
  __syncthreads();
  const int m0 = blockIdx.y * BM;  // rows of dw: x's columns
  const int n0 = blockIdx.x * BN;
  Operands op;
  op.a = x;
  op.lda = k;
  op.a_lo = 0;
  op.a_hi = k;
  op.a_m0 = m0;
  op.a_mlim = k;
  op.b = dy;
  op.ldb = n;
  op.b_n0 = n0;
  op.b_nlim = n;
  op.red_lo = rows[0];
  op.red_hi = rows[1];
  float acc[4][4][4];
  block_product<true, false>(acc, op);

  float* out = dw + static_cast<long>(blockIdx.z) * k * n;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + (warp >> 2) * 64 + 16 * i + g + 8 * half;
      if (row >= k) continue;
#pragma unroll
      for (int jn = 0; jn < 4; ++jn) {
        const int col = n0 + (warp & 3) * 32 + 8 * jn + 2 * t;
        const float v0 = acc[i][jn][2 * half], v1 = acc[i][jn][2 * half + 1];
        float* p = out + static_cast<long>(row) * n + col;
        if (col + 1 < n && (reinterpret_cast<uintptr_t>(p) & 7) == 0) {
          *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
        } else {
          if (col < n) p[0] = v0;
          if (col + 1 < n) p[1] = v1;
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// f32: FMA units
// ---------------------------------------------------------------------------

constexpr int FM = 64, FN = 64, FK = 16;

// The block's 64 x 64 tile of A . B over [red_lo, red_hi): each thread 4 x 4
// outputs (rows ty + 16 i, columns tx + 16 j). a_at(mi, r) and b_at(r, ni)
// return the operands (0 out of bounds).
template <typename AAt, typename BAt>
__device__ __forceinline__ void fma_product(float (&acc)[4][4], int red_lo, int red_hi,
                                            AAt a_at, BAt b_at) {
  __shared__ float sa[FK][FM + 1];
  __shared__ float sb[FK][FN + 1];
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int r0 = red_lo; r0 < red_hi; r0 += FK) {
#pragma unroll
    for (int c = 0; c < FM * FK / THREADS; ++c) {
      const int idx = threadIdx.x + c * THREADS;
      const int kk = idx % FK, mi = idx / FK;
      sa[kk][mi] = r0 + kk < red_hi ? a_at(mi, r0 + kk) : 0.f;
      sb[kk][mi] = r0 + kk < red_hi ? b_at(r0 + kk, mi) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < FK; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = sa[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = sb[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
}

template <bool NT>
__global__ void __launch_bounds__(THREADS)
gmm_fma_kernel(const float* __restrict__ x, const float* __restrict__ w,
               const int* __restrict__ sizes, float* __restrict__ out, int m, int k, int n,
               int first, int local) {
  __shared__ Item item;
  __shared__ bool found;
  if (threadIdx.x == 0) found = find_item(sizes, first, local, m, FM, blockIdx.x, &item);
  __syncthreads();
  if (!found) return;
  const int n0 = blockIdx.y * FN;
  const float* wg = w + static_cast<long>(item.group) * k * n;
  const Item it = item;
  float acc[4][4];
  fma_product(
      acc, 0, k,
      [&](int mi, int r) {
        const int row = it.row0 + mi;
        return row >= it.lo && row < it.hi ? x[static_cast<long>(row) * k + r] : 0.f;
      },
      [&](int r, int ni) {
        const int col = n0 + ni;
        if (col >= n) return 0.f;
        return NT ? wg[static_cast<long>(col) * k + r] : wg[static_cast<long>(r) * n + col];
      });
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = it.row0 + ty + 16 * i;
    if (row < it.lo || row >= it.hi) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx + 16 * j;
      if (col < n) out[static_cast<long>(row) * n + col] = acc[i][j];
    }
  }
}

__global__ void __launch_bounds__(THREADS)
tgmm_fma_kernel(const float* __restrict__ x, const float* __restrict__ dy,
                const int* __restrict__ sizes, float* __restrict__ dw, int m, int k, int n,
                int first) {
  __shared__ int rows[2];
  if (threadIdx.x == 0) group_rows(sizes, first, blockIdx.z, m, &rows[0], &rows[1]);
  __syncthreads();
  const int m0 = blockIdx.y * FM, n0 = blockIdx.x * FN;
  float acc[4][4];
  fma_product(
      acc, rows[0], rows[1],
      [&](int mi, int r) { return m0 + mi < k ? x[static_cast<long>(r) * k + m0 + mi] : 0.f; },
      [&](int r, int ni) { return n0 + ni < n ? dy[static_cast<long>(r) * n + n0 + ni] : 0.f; });
  float* out = dw + static_cast<long>(blockIdx.z) * k * n;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty + 16 * i;
    if (row >= k) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx + 16 * j;
      if (col < n) out[static_cast<long>(row) * n + col] = acc[i][j];
    }
  }
}

bool bad_dims(int m, int k, int n, int first, int local) {
  return m < 0 || k < 0 || n < 0 || first < 0 || local < 0;
}

}  // namespace

extern "C" {

// out [m, n] (bf16 or f32, zero-filled by the caller) = x [m, k] . w[g]
// (nt = 0: w [local, k, n]) or . w[g]^T (nt = 1: w [local, n, k]) over the
// rows of local groups 0..local-1, which are groups first.. of sizes (int32,
// on the device). bf16 = 1: x, w, out bf16; 0: f32. Returns the launch
// error (0 on success); nothing is synchronised.
int tfo_gmm(const void* x, const void* w, const int* sizes, void* out, int m, int k, int n,
            int first, int local, int nt, int bf16, void* stream) {
  if (bad_dims(m, k, n, first, local)) return cudaErrorInvalidValue;
  if (m == 0 || n == 0 || local == 0) return cudaSuccess;
  const int tile_m = bf16 ? BM : FM, tile_n = bf16 ? BN : FN;
  const long items = (static_cast<long>(m) + tile_m - 1) / tile_m + local;
  const long ntiles = (static_cast<long>(n) + tile_n - 1) / tile_n;
  if (items > 0x7fffffffL || ntiles > 65535) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(items), static_cast<unsigned>(ntiles));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const uint16_t*>(x);
  const auto* wb = static_cast<const uint16_t*>(w);
  auto* ob = static_cast<__nv_bfloat16*>(out);
  const auto* xf = static_cast<const float*>(x);
  const auto* wf = static_cast<const float*>(w);
  auto* of = static_cast<float*>(out);
  if (bf16 && nt) {
    gmm_mma_kernel<true><<<grid, THREADS, 0, s>>>(xb, wb, sizes, ob, m, k, n, first, local);
  } else if (bf16) {
    gmm_mma_kernel<false><<<grid, THREADS, 0, s>>>(xb, wb, sizes, ob, m, k, n, first, local);
  } else if (nt) {
    gmm_fma_kernel<true><<<grid, THREADS, 0, s>>>(xf, wf, sizes, of, m, k, n, first, local);
  } else {
    gmm_fma_kernel<false><<<grid, THREADS, 0, s>>>(xf, wf, sizes, of, m, k, n, first, local);
  }
  return cudaGetLastError();
}

// dw [local, k, n] f32 = x[rows of g]^T . dy[rows of g] for local groups
// 0..local-1 (groups first.. of sizes); x [m, k], dy [m, n], both bf16
// (bf16 = 1) or f32. Every dw[g] is written whole. Returns the launch error.
int tfo_tgmm(const void* x, const void* dy, const int* sizes, float* dw, int m, int k, int n,
             int first, int local, int bf16, void* stream) {
  if (bad_dims(m, k, n, first, local)) return cudaErrorInvalidValue;
  if (k == 0 || n == 0 || local == 0) return cudaSuccess;
  const int tile_m = bf16 ? BM : FM, tile_n = bf16 ? BN : FN;
  const long ntiles = (static_cast<long>(n) + tile_n - 1) / tile_n;
  const long ktiles = (static_cast<long>(k) + tile_m - 1) / tile_m;
  if (ntiles > 0x7fffffffL || ktiles > 65535 || local > 65535) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(ntiles), static_cast<unsigned>(ktiles),
                  static_cast<unsigned>(local));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    tgmm_mma_kernel<<<grid, THREADS, 0, s>>>(static_cast<const uint16_t*>(x),
                                             static_cast<const uint16_t*>(dy), sizes, dw, m, k,
                                             n, first);
  } else {
    tgmm_fma_kernel<<<grid, THREADS, 0, s>>>(static_cast<const float*>(x),
                                             static_cast<const float*>(dy), sizes, dw, m, k, n,
                                             first);
  }
  return cudaGetLastError();
}

}  // extern "C"
