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
//   tgmm:    dw[g] = x[rows of g]^T . dy[rows of g]     dw [local, K, N]
// Rows of groups without weights here, and rows past the groups' sum, are
// zero: the local groups are consecutive, so their rows are one range
// [s, e), and the gmm kernels write zeros over [0, s) and [e, M) themselves
// (both empty at ep = 1 under dropless routing), so the caller's output may
// hold anything. tgmm writes every dw[g] whole, zeros for an empty group, in
// f32 or bf16 (one rounding of the f32 sum). Products accumulate in f32; gmm
// rounds its output to the inputs' dtype.
//
// What bounds it on the H100: at the MoE cell (M = 8 x 2048 x 2 = 32768
// rows, 8 experts, K x N = 768 x 3072 or 3072 x 768) every launch is
// 2 M K N = 154.6 GFLOP against at most 289 MB of operands and result, so
// the bound is operations (0.156 ms at 989 TF/s bf16).
//
// Three routes, chosen by the wrapper from shapes and dtype alone
// (grouped_matmul.route) and checked again here; a launch never falls back:
//   wgmma  bf16, K and N multiples of 8 (16-byte row strides) and 16-byte
//          aligned bases: what TMA can describe. The MoE's products.
//   mma    other bf16 shapes (K or N off 8, a misaligned view): mma.sync.
//   fma    f32: FMA units.
//
// The wgmma route (gmm_wgmma_kernel<NT>, tgmm_wgmma_kernel):
//   - Operands come through TMA, 128-byte swizzle, maps built on the host
//     per call (cuTensorMapEncodeTiled) and passed __grid_constant__. x is
//     a 2-D map [M, K] (K-major A); w a 3-D map, [G, K, N] for NN (MN-major
//     B) or [G, N, K] for NT (K-major B), so TMA's zero fill stops a K tail
//     at the group's own last row instead of reading the next expert's.
//   - A block is persistent: the grid is the SM count, and block b walks
//     work items b, b + grid, ... One producer warp keeps a ring of 4
//     stages of 48 KB in flight through an mbarrier pair a stage; consumer
//     warpgroups each run wgmma on their 64 rows of a tile, 64 deep a
//     stage (setmaxnreg: the producer gives its registers to the f32
//     accumulators). The producer runs ahead across tiles, so a tile's
//     epilogue overlaps the next tile's loads. Both kernels are bound by
//     the bytes that L2 feeds the SMs more than by the tensor cores, so
//     the tiles are as large as the registers allow.
//   - gmm: 128 x 256 tiles, two consumer warpgroups (m64n256k16, 128
//     accumulators a thread under 240 registers): 85 operand bytes from L2
//     per 2 x 128 x 256 FLOP a k-element, twice 128 x 128's intensity. A
//     tile wholly inside its group leaves through a 32 KB shared buffer,
//     half a tile at a time (stmatrix into the output map's swizzled
//     boxes, then TMA stores that drain while the consumers start the next
//     tile): at K = 768 a tile's products take ~7 us at the peak, and
//     blocking stores of its 64 KB from registers would cost a large share
//     of that.
//   - gmm items are (group, 128-row tile) pairs (find_item: a tile that
//     straddles two groups runs once for each and stores only its group's
//     rows, straight from the accumulators, never a whole-tile store) times
//     256-column n-tiles, n-tile fastest: consecutive blocks share one x row
//     tile and walk one group's w, so the 132 running blocks read ~11 x row
//     tiles and one or two experts' w (4.7 MB each at the cell), all of it
//     resident in the 50 MB L2 while it is used. (Walking the rows fastest
//     would share w's n-tile instead, but would stream all of x [50 MB at
//     the cell] through L2 once per n-tile.)
//   - tgmm's ragged dimension is the reduction. An item is (group, 192 x
//     192 tile of dw[g]); it walks the group's rows in 64-row k-steps from
//     the group's first row (TMA takes any row coordinate, so only the last
//     step can hold a neighbour's rows). Three consumer warpgroups
//     (m64n192k16, 96 accumulators under 160 registers): every item reads
//     its group's rows of x and dy once, so the tile sets the L2 bytes a
//     FLOP, 96 FLOP a byte here against 85 at 128 x 256; K and N of 768 and
//     3072 split evenly into 192, and the cell's 512 items fill 3.9 of 4
//     waves over 132 SMs. Both operands are MN-major 2-D maps, x [64 rows,
//     192 of K] as A transposed and dy [64 rows, 192 of N] as B, which bf16
//     wgmma reads from shared memory as they lie. The last step's rows
//     past the group are zeroed in shared memory by the consumers (a
//     swizzled row r is the whole 128 bytes at r * 128 of its box), then
//     fence.proxy.async orders those generic stores before the async
//     proxy's wgmma reads. dw is written from the accumulators, f32 or
//     bf16.
//
// The mma route (gmm_mma_kernel<NT>, tgmm_mma_kernel): one block per
// (item, 128 x 128 tile), mma.sync m16n8k16 on operands staged through
// registers into two shared-memory stages, ldmatrix(.trans) fragments,
// every row and column bound guarded (element loads where a 16-byte chunk
// is not whole). The fma route: the same tiling on FMA units, 64 x 64
// tiles, at any K and N.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

#include "hopper.cuh"

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

// The rows [lo, hi) of local groups j0 .. j1 - 1 (one range: they are
// consecutive), clipped to m.
__device__ void group_rows(const int* sizes, int first, int j0, int j1, int m, int* lo,
                           int* hi) {
  long start = 0;
  for (int g = 0; g < first + j0; ++g) start += max(sizes[g], 0);
  long end = start;
  for (int g = first + j0; g < first + j1; ++g) end += max(sizes[g], 0);
  *lo = static_cast<int>(min(start, static_cast<long>(m)));
  *hi = static_cast<int>(min(end, static_cast<long>(m)));
}

// Zeros over bytes [b0, b1) of `base` (a multiple of 2 bytes apart from
// base's alignment), shared by `count` threads of which this is `tid`:
// 16-byte stores, 2-byte ones at the unaligned edges.
__device__ void zero_bytes(uint8_t* base, long b0, long b1, long tid, long count) {
  if (b1 <= b0) return;
  const long mis = static_cast<long>(reinterpret_cast<uintptr_t>(base) & 15);
  const long h = min(((b0 + mis + 15) & ~15L) - mis, b1);  // first 16-byte-aligned byte
  const long t = max(((b1 + mis) & ~15L) - mis, h);        // end of the aligned run
  for (long i = b0 + 2 * tid; i < h; i += 2 * count) {
    *reinterpret_cast<uint16_t*>(base + i) = 0;
  }
  for (long i = h + 16 * tid; i < t; i += 16 * count) {
    *reinterpret_cast<uint4*>(base + i) = make_uint4(0u, 0u, 0u, 0u);
  }
  for (long i = t + 2 * tid; i < b1; i += 2 * count) {
    *reinterpret_cast<uint16_t*>(base + i) = 0;
  }
}

// gmm's rows outside the local groups' [s, e): zeros, written by `count`
// threads of the launch, of which this is `tid`.
__device__ void zero_other_rows(void* out, int elem_bytes, const int* sizes, int first,
                                int local, int m, int n, long tid, long count) {
  int s, e;
  group_rows(sizes, first, 0, local, m, &s, &e);
  const long row_bytes = static_cast<long>(n) * elem_bytes;
  auto* base = static_cast<uint8_t*>(out);
  zero_bytes(base, 0, s * row_bytes, tid, count);
  zero_bytes(base, e * row_bytes, m * row_bytes, tid, count);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Two neighbouring outputs (columns col, col + 1 of an f32 or bf16 row that
// starts at element `at`), each only where its column is below n.
__device__ __forceinline__ void store_pair(void* out, bool bf16, long at, int col, int n,
                                           float v0, float v1) {
  if (bf16) {
    auto* p = static_cast<__nv_bfloat16*>(out) + at + col;
    if (col + 1 < n && (reinterpret_cast<uintptr_t>(p) & 3) == 0) {
      *reinterpret_cast<uint32_t*>(p) = pack_bf16(v0, v1);
    } else {
      if (col < n) p[0] = __float2bfloat16_rn(v0);
      if (col + 1 < n) p[1] = __float2bfloat16_rn(v1);
    }
  } else {
    float* p = static_cast<float*>(out) + at + col;
    if (col + 1 < n && (reinterpret_cast<uintptr_t>(p) & 7) == 0) {
      *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
    } else {
      if (col < n) p[0] = v0;
      if (col + 1 < n) p[1] = v1;
    }
  }
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

// gmm: one (group, 128-row tile) item x one 128-column tile of out. Every
// block first takes its share of the zeros outside the local groups' rows.
template <bool NT>
__global__ void __launch_bounds__(THREADS)
gmm_mma_kernel(const uint16_t* __restrict__ x, const uint16_t* __restrict__ w,
               const int* __restrict__ sizes, __nv_bfloat16* __restrict__ out, int m, int k,
               int n, int first, int local) {
  const long flat = static_cast<long>(blockIdx.y) * gridDim.x + blockIdx.x;
  zero_other_rows(out, 2, sizes, first, local, m, n, flat * THREADS + threadIdx.x,
                  static_cast<long>(gridDim.x) * gridDim.y * THREADS);
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
        store_pair(out, true, static_cast<long>(row) * n, col, n, acc[i][jn][2 * half],
                   acc[i][jn][2 * half + 1]);
      }
    }
  }
}

// tgmm: one local group (blockIdx.z) x one 128 x 128 tile of dw[g] [K, N],
// written in f32 or (out_bf16) bf16.
__global__ void __launch_bounds__(THREADS)
tgmm_mma_kernel(const uint16_t* __restrict__ x, const uint16_t* __restrict__ dy,
                const int* __restrict__ sizes, void* __restrict__ dw, int m, int k, int n,
                int first, int out_bf16) {
  __shared__ int rows[2];
  if (threadIdx.x == 0) {
    group_rows(sizes, first, blockIdx.z, blockIdx.z + 1, m, &rows[0], &rows[1]);
  }
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

  const long base = static_cast<long>(blockIdx.z) * k * n;
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
        store_pair(dw, out_bf16, base + static_cast<long>(row) * n, col, n,
                   acc[i][jn][2 * half], acc[i][jn][2 * half + 1]);
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
  const long flat = static_cast<long>(blockIdx.y) * gridDim.x + blockIdx.x;
  zero_other_rows(out, 4, sizes, first, local, m, n, flat * THREADS + threadIdx.x,
                  static_cast<long>(gridDim.x) * gridDim.y * THREADS);
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
                const int* __restrict__ sizes, void* __restrict__ dw, int m, int k, int n,
                int first, int out_bf16) {
  __shared__ int rows[2];
  if (threadIdx.x == 0) {
    group_rows(sizes, first, blockIdx.z, blockIdx.z + 1, m, &rows[0], &rows[1]);
  }
  __syncthreads();
  const int m0 = blockIdx.y * FM, n0 = blockIdx.x * FN;
  float acc[4][4];
  fma_product(
      acc, rows[0], rows[1],
      [&](int mi, int r) { return m0 + mi < k ? x[static_cast<long>(r) * k + m0 + mi] : 0.f; },
      [&](int r, int ni) { return n0 + ni < n ? dy[static_cast<long>(r) * n + n0 + ni] : 0.f; });
  const long base = static_cast<long>(blockIdx.z) * k * n;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty + 16 * i;
    if (row >= k) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx + 16 * j;
      if (col >= n) continue;
      const long at = base + static_cast<long>(row) * n + col;
      if (out_bf16) {
        static_cast<__nv_bfloat16*>(dw)[at] = __float2bfloat16_rn(acc[i][j]);
      } else {
        static_cast<float*>(dw)[at] = acc[i][j];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 on Hopper: TMA + wgmma, warp-specialised, persistent
// ---------------------------------------------------------------------------

constexpr int WG_THREADS = 128;
// A k-step is WK deep: one 128-byte swizzle box of bf16.
constexpr int WK = 64;
constexpr uint32_t BOX_BYTES = 64 * 128;  // a 64-row box of 64 bf16 columns
constexpr int MASK_BAR = 1, EPI_BAR = 2;  // named barriers of the consumers

// A kernel's tiles, ring and warpgroups: a TM x TN output tile, each of
// CONSUMERS warpgroups 64 of its rows; a ring of STAGES stages of A (TM x
// WK of bf16) and B (WK x TN); EPI_BYTES of output staging. gmm: a[s]
// holds x's [128 rows, 64 of K] (one box; warpgroup wg reads rows 64
// wg..), b[s] w's [64 of K, 256 of N] as four [64, 64] boxes (NN) or [256
// of N, 64 of K] as one box (NT). tgmm: a[s] holds x's [64 rows, 192 of
// K] as three boxes (warpgroup wg reads box wg), b[s] dy's [64 rows, 192
// of N] as three boxes.
template <int TM, int TN, int STAGES, uint32_t EPI_BYTES, int CONSUMERS>
struct WgSmem {
  static constexpr int kM = TM, kN = TN, kStages = STAGES;
  static constexpr int kConsumers = CONSUMERS, kConsumerThreads = CONSUMERS * WG_THREADS;
  static constexpr int kThreads = (CONSUMERS + 1) * WG_THREADS;
  static constexpr uint32_t kABytes = TM * WK * 2, kBBytes = WK * TN * 2;
  static_assert(TM == 64 * CONSUMERS, "a consumer warpgroup owns 64 rows of a tile");
  alignas(1024) uint8_t a[STAGES][kABytes];
  alignas(1024) uint8_t b[STAGES][kBBytes];
  alignas(1024) uint8_t epi[EPI_BYTES];
  uint64_t full[STAGES], empty[STAGES];
};
// gmm: 128 x 256 tiles, two consumer warpgroups (m64n256k16, 128
// accumulators a thread), a ring of 4 stages of 48 KB, and a 32 KB buffer
// that stages half a tile's bf16 outputs (128 x 128) for TMA stores.
using GmmSmem = WgSmem<128, 256, 4, 128 * 128 * 2, 2>;
constexpr int GMM_N = GmmSmem::kN;
// tgmm: 192 x 192 tiles, three consumer warpgroups (m64n192k16, 96
// accumulators a thread), a ring of 4 stages of 48 KB. Each item reads its
// group's rows of x and dy once, so the L2 bytes a FLOP fall with the
// tile: 192 x 192 moves 96 FLOP a byte, where 128 x 256 moved 85 and 128
// x 192 77; K and N of 768 and 3072 split evenly, and the cell's 8 x 4 x
// 16 = 512 items fill 3.9 of 4 waves over 132 SMs.
using TgmmSmem = WgSmem<192, 192, 4, 16, 3>;
constexpr int TGMM_M = TgmmSmem::kM, TGMM_N = TgmmSmem::kN;
static_assert(sizeof(GmmSmem) + 1024 <= 232448, "gmm's ring fits a block's shared memory");
static_assert(sizeof(TgmmSmem) + 1024 <= 232448, "tgmm's ring fits a block's shared memory");

// A position in a ring of STAGES: its stage and the parity of the stage's
// phase.
template <int STAGES>
struct Ring {
  int s = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ void next() {
    if (++s == STAGES) {
      s = 0;
      phase ^= 1;
    }
  }
};

template <typename S>
__device__ __forceinline__ void init_ring(S& sm) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < S::kStages; ++s) {
      hopper::mbar_init(&sm.full[s], 1);
      hopper::mbar_init(&sm.empty[s], S::kConsumers * 4);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();
}

// One arrival a consumer warp on a stage whose products have completed.
template <typename S>
__device__ __forceinline__ void release(S& sm, int s) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) hopper::mbar_arrive(&sm.empty[s]);
}

// The products of one stage: acc (+)= A . B over its 64-deep k-step, four
// m64nNk16 products from descriptors of the warpgroup's bases at stage 0,
// k-step 0 (the first of a tile's products ignores acc's old values).
template <typename S, int kTnspA, int kTnspB>
__device__ __forceinline__ void stage_products(float (&acc)[S::kN / 2], uint64_t da,
                                               uint64_t db, int s, bool first) {
  const uint64_t a = hopper::desc_advance(da, s * S::kABytes);
  const uint64_t b = hopper::desc_advance(db, s * S::kBBytes);
  // A k-step of 16 moves 32 bytes along a K-major row, 16 rows (2048
  // bytes) down an MN-major box.
  constexpr uint32_t a_step = kTnspA ? 2048 : 32, b_step = kTnspB ? 2048 : 32;
  hopper::wg_fence();
#pragma unroll
  for (int kk = 0; kk < WK / 16; ++kk) {
    const uint64_t ak = hopper::desc_advance(a, kk * a_step);
    const uint64_t bk = hopper::desc_advance(b, kk * b_step);
    const int scale_d = first && kk == 0 ? 0 : 1;
    if constexpr (S::kN == 256) {
      hopper::wgmma_ss_m64n256<kTnspA, kTnspB>(acc, ak, bk, scale_d);
    } else {
      hopper::wgmma_ss_m64n192<kTnspA, kTnspB>(acc, ak, bk, scale_d);
    }
  }
  hopper::wg_commit();
}

// gmm's outputs of one tile, bf16, rows [lo, hi) of it only. A tile wholly
// inside its group goes out through shared memory in two halves of 128
// columns: stmatrix writes each warp's 8 x 8 blocks into the output map's
// 128-byte-swizzled boxes (64 columns x 128 rows), fence.proxy.async
// orders those stores before the async proxy's reads, and one thread
// stores the half's boxes with TMA, which runs on while the consumers go
// on to the next tile (the buffer is written again only once the previous
// stores have read it). A tile that straddles two groups (or whose rows
// start before its group's) stores its own rows straight from the
// accumulators, never a whole box.
__device__ __forceinline__ void gmm_store_tile(GmmSmem& sm, const CUtensorMap* tm_out,
                                               const float (&acc)[GMM_N / 2], const Item& it,
                                               __nv_bfloat16* out, int m, int n, int n0,
                                               int wg) {
  const int lane = threadIdx.x & 31;
  const int warp_row = 64 * wg + 16 * ((threadIdx.x % WG_THREADS) / 32);
  if (it.lo == it.row0 && (it.hi == it.row0 + GmmSmem::kM || it.hi == m)) {
    const int q = lane >> 3;                        // the matrix this lane addresses
    const int row = warp_row + (lane & 7) + 8 * (q & 1);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      if (threadIdx.x == 0) hopper::bulk_wait_read<0>();
      hopper::bar_sync(EPI_BAR, GmmSmem::kConsumerThreads);
#pragma unroll
      for (int j = 16 * half; j < 16 * half + 16; j += 2) {
        const int col = 8 * (j + (q >> 1)) - 128 * half;  // within the half
        uint8_t* dst = sm.epi + (col >> 6) * (GmmSmem::kM * 128) + row * 128 +
                       ((((col & 63) >> 3) ^ (row & 7)) << 4);
        hopper::stmatrix_x4(dst, pack_bf16(acc[4 * j], acc[4 * j + 1]),
                            pack_bf16(acc[4 * j + 2], acc[4 * j + 3]),
                            pack_bf16(acc[4 * j + 4], acc[4 * j + 5]),
                            pack_bf16(acc[4 * j + 6], acc[4 * j + 7]));
      }
      hopper::fence_proxy_async();
      hopper::bar_sync(EPI_BAR, GmmSmem::kConsumerThreads);
      if (threadIdx.x == 0) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col0 = n0 + 128 * half + 64 * c;
          if (col0 < n) {
            hopper::tma_store_2d(tm_out, sm.epi + c * (GmmSmem::kM * 128), col0, it.row0);
          }
        }
        hopper::bulk_commit();
      }
    }
    return;
  }
  const int c_in = 2 * (lane & 3);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = it.row0 + warp_row + (lane >> 2) + 8 * h;
    if (row < it.lo || row >= it.hi) continue;
    __nv_bfloat16* o = out + static_cast<long>(row) * n + n0 + c_in;
#pragma unroll
    for (int j = 0; j < GMM_N / 8; ++j) {
      if (n0 + c_in + 8 * j < n) {
        *reinterpret_cast<uint32_t*>(o + 8 * j) = pack_bf16(acc[4 * j + 2 * h],
                                                            acc[4 * j + 2 * h + 1]);
      }
    }
  }
}

// gmm on the wgmma route. Work item t is x row tile t / n_tiles (a
// find_item) times n-tile t % n_tiles.
template <bool NT>
__global__ void __launch_bounds__(GmmSmem::kThreads, 1)
gmm_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x,
                 const __grid_constant__ CUtensorMap tm_w,
                 const __grid_constant__ CUtensorMap tm_out, const int* __restrict__ sizes,
                 __nv_bfloat16* __restrict__ out, int m, int k, int n, int first, int local) {
  GmmSmem& sm = hopper::smem_as<GmmSmem>();
  const int wg = hopper::warpgroup();
  const int n_tiles = (n + GMM_N - 1) / GMM_N;
  const int k_steps = (k + WK - 1) / WK;
  init_ring(sm);

  if (wg == GmmSmem::kConsumers) {
    // Producer: one thread starts every TMA load, running ahead across tiles.
    hopper::regs_dealloc<24>();
    if (threadIdx.x != GmmSmem::kConsumerThreads) return;
    Ring<GmmSmem::kStages> r;
    Item it;
    for (int t = blockIdx.x; find_item(sizes, first, local, m, GmmSmem::kM, t / n_tiles, &it);
         t += gridDim.x) {
      const int n0 = (t % n_tiles) * GMM_N;
      for (int ks = 0; ks < k_steps; ++ks) {
        hopper::mbar_wait(&sm.empty[r.s], r.phase ^ 1);
        uint64_t* bar = &sm.full[r.s];
        hopper::mbar_arrive_expect_tx(bar, GmmSmem::kABytes + GmmSmem::kBBytes);
        hopper::tma_load_2d(sm.a[r.s], &tm_x, bar, ks * WK, it.row0);
        if (NT) {
          hopper::tma_load_3d(sm.b[r.s], &tm_w, bar, ks * WK, n0, it.group);
        } else {
#pragma unroll
          for (int c = 0; c < GMM_N / 64; ++c) {
            hopper::tma_load_3d(sm.b[r.s] + c * BOX_BYTES, &tm_w, bar, n0 + 64 * c, ks * WK,
                                it.group);
          }
        }
        r.next();
      }
    }
    return;
  }

  // Consumers: warpgroup wg owns rows 64 wg.. of each tile.
  hopper::regs_alloc<240>();
  zero_other_rows(out, 2, sizes, first, local, m, n,
                  static_cast<long>(blockIdx.x) * GmmSmem::kConsumerThreads + threadIdx.x,
                  static_cast<long>(gridDim.x) * GmmSmem::kConsumerThreads);
  const uint64_t da = hopper::desc_sw128(hopper::smem_u32(sm.a[0]) + wg * BOX_BYTES, 16, 1024);
  const uint64_t db = NT ? hopper::desc_sw128(hopper::smem_u32(sm.b[0]), 16, 1024)
                         : hopper::desc_sw128(hopper::smem_u32(sm.b[0]), BOX_BYTES, 1024);
  float acc[GMM_N / 2];
#pragma unroll
  for (int i = 0; i < GMM_N / 2; ++i) acc[i] = 0.f;
  Ring<GmmSmem::kStages> r;
  Item it;
  for (int t = blockIdx.x; find_item(sizes, first, local, m, GmmSmem::kM, t / n_tiles, &it);
       t += gridDim.x) {
    int prev = 0;
    for (int ks = 0; ks < k_steps; ++ks) {
      hopper::mbar_wait(&sm.full[r.s], r.phase);
      stage_products<GmmSmem, 0, NT ? 0 : 1>(acc, da, db, r.s, ks == 0);
      hopper::wg_wait<1>();  // the previous stage's products are done
      if (ks > 0) release(sm, prev);
      prev = r.s;
      r.next();
    }
    hopper::wg_wait<0>();
    hopper::pin(acc);
    release(sm, prev);
    gmm_store_tile(sm, &tm_out, acc, it, out, m, n, (t % n_tiles) * GMM_N, wg);
  }
  if (threadIdx.x == 0) hopper::bulk_wait_read<0>();  // shared memory outlives the stores
}

// Rows [valid, 64) of each of the stage's boxes (x's three, dy's three)
// zeroed by the consumers, and made visible to the products that read them.
__device__ __forceinline__ void mask_stage(TgmmSmem& sm, int s, int valid) {
  constexpr int boxes = TGMM_M / 64 + TGMM_N / 64;
  const int per_box = (64 - valid) * 8;  // 16-byte chunks of a box's rows
  for (int i = threadIdx.x; i < boxes * per_box; i += TgmmSmem::kConsumerThreads) {
    const int box = i / per_box;
    uint8_t* p = (box < TGMM_M / 64 ? sm.a[s] + box * BOX_BYTES
                                : sm.b[s] + (box - TGMM_M / 64) * BOX_BYTES) +
                 valid * 128 + (i % per_box) * 16;
    *reinterpret_cast<uint4*>(p) = make_uint4(0u, 0u, 0u, 0u);
  }
  hopper::fence_proxy_async();
  hopper::bar_sync(MASK_BAR, TgmmSmem::kConsumerThreads);
}

// tgmm on the wgmma route. Work item t is local group t / (m_tiles
// n_tiles), then its 192-row tile of dw[g] (x's columns), then its n-tile.
__global__ void __launch_bounds__(TgmmSmem::kThreads, 1)
tgmm_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x,
                  const __grid_constant__ CUtensorMap tm_dy, const int* __restrict__ sizes,
                  void* __restrict__ dw, int m, int k, int n, int first, int local,
                  int out_bf16) {
  TgmmSmem& sm = hopper::smem_as<TgmmSmem>();
  const int wg = hopper::warpgroup();
  const int m_tiles = (k + TGMM_M - 1) / TGMM_M, n_tiles = (n + TGMM_N - 1) / TGMM_N;
  const int items = local * m_tiles * n_tiles;
  init_ring(sm);

  if (wg == TgmmSmem::kConsumers) {
    hopper::regs_dealloc<24>();
    if (threadIdx.x != TgmmSmem::kConsumerThreads) return;
    Ring<TgmmSmem::kStages> r;
    for (int t = blockIdx.x; t < items; t += gridDim.x) {
      const int g = t / (m_tiles * n_tiles), rem = t % (m_tiles * n_tiles);
      const int m0 = (rem / n_tiles) * TGMM_M, n0 = (rem % n_tiles) * TGMM_N;
      int lo, hi;
      group_rows(sizes, first, g, g + 1, m, &lo, &hi);
      for (int row = lo; row < hi; row += WK) {
        hopper::mbar_wait(&sm.empty[r.s], r.phase ^ 1);
        uint64_t* bar = &sm.full[r.s];
        hopper::mbar_arrive_expect_tx(bar, TgmmSmem::kABytes + TgmmSmem::kBBytes);
#pragma unroll
        for (int c = 0; c < TGMM_M / 64; ++c) {
          hopper::tma_load_2d(sm.a[r.s] + c * BOX_BYTES, &tm_x, bar, m0 + 64 * c, row);
        }
#pragma unroll
        for (int c = 0; c < TGMM_N / 64; ++c) {
          hopper::tma_load_2d(sm.b[r.s] + c * BOX_BYTES, &tm_dy, bar, n0 + 64 * c, row);
        }
        r.next();
      }
    }
    return;
  }

  hopper::regs_alloc<160>();
  const int lane = threadIdx.x & 31;
  const int r_in = 64 * wg + 16 * ((threadIdx.x % WG_THREADS) / 32) + (lane >> 2);
  const int c_in = 2 * (lane & 3);
  const uint64_t da =
      hopper::desc_sw128(hopper::smem_u32(sm.a[0]) + wg * BOX_BYTES, BOX_BYTES, 1024);
  const uint64_t db = hopper::desc_sw128(hopper::smem_u32(sm.b[0]), BOX_BYTES, 1024);
  float acc[TGMM_N / 2];
#pragma unroll
  for (int i = 0; i < TGMM_N / 2; ++i) acc[i] = 0.f;
  Ring<TgmmSmem::kStages> r;
  for (int t = blockIdx.x; t < items; t += gridDim.x) {
    const int g = t / (m_tiles * n_tiles), rem = t % (m_tiles * n_tiles);
    const int m0 = (rem / n_tiles) * TGMM_M, n0 = (rem % n_tiles) * TGMM_N;
    int lo, hi;
    group_rows(sizes, first, g, g + 1, m, &lo, &hi);
    const int steps = (hi - lo + WK - 1) / WK;
    int prev = 0;
    for (int ks = 0; ks < steps; ++ks) {
      hopper::mbar_wait(&sm.full[r.s], r.phase);
      const int valid = hi - lo - ks * WK;
      if (valid < WK) mask_stage(sm, r.s, valid);
      stage_products<TgmmSmem, 1, 1>(acc, da, db, r.s, ks == 0);
      hopper::wg_wait<1>();
      if (ks > 0) release(sm, prev);
      prev = r.s;
      r.next();
    }
    hopper::wg_wait<0>();
    hopper::pin(acc);
    if (steps > 0) release(sm, prev);

    // dw[g]'s rows m0 + r_in (+ 8), zeros for an empty group.
    const long base = static_cast<long>(g) * k * n;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + r_in + 8 * h;
      if (row >= k) continue;
#pragma unroll
      for (int j = 0; j < TGMM_N / 8; ++j) {
        const int col = n0 + c_in + 8 * j;
        if (col >= n) continue;
        const float v0 = steps > 0 ? acc[4 * j + 2 * h] : 0.f;
        const float v1 = steps > 0 ? acc[4 * j + 2 * h + 1] : 0.f;
        const long at = base + static_cast<long>(row) * n + col;
        if (out_bf16) {
          *reinterpret_cast<uint32_t*>(static_cast<__nv_bfloat16*>(dw) + at) =
              pack_bf16(v0, v1);
        } else {
          *reinterpret_cast<float2*>(static_cast<float*>(dw) + at) = make_float2(v0, v1);
        }
      }
    }
  }
}

bool bad_dims(int m, int k, int n, int first, int local) {
  return m < 0 || k < 0 || n < 0 || first < 0 || local < 0;
}

// Returned when cuTensorMapEncodeTiled refuses a map: kTensorMapError + CUresult.
constexpr int kTensorMapError = 1000;

// A tensor map over a row-major bf16 tensor of `rank` (2 or 3) dimensions,
// dims innermost first, boxes of `box` elements (64 innermost: one 128-byte
// swizzle row), 128-byte swizzle; elements outside the tensor read as zero.
int encode_map(CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims,
               const cuuint32_t* box) {
  const cuuint64_t strides[2] = {dims[0] * sizeof(__nv_bfloat16),
                                 dims[0] * dims[1] * sizeof(__nv_bfloat16)};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUresult r = cuTensorMapEncodeTiled(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base), dims, strides, box,
      elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kTensorMapError + static_cast<int>(r);
}

// What TMA can describe: positive dimensions, 16-byte row strides and bases.
bool tma_ok(int m, int k, int n, int local, const void* a, const void* b) {
  return m > 0 && k > 0 && n > 0 && local > 0 && k % 8 == 0 && n % 8 == 0 &&
         (reinterpret_cast<uintptr_t>(a) & 15) == 0 && (reinterpret_cast<uintptr_t>(b) & 15) == 0;
}

// The current device's SM count: the persistent grid (0 on an error).
int sm_count() {
  int dev = 0, count = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
    return 0;
  }
  return count;
}

template <typename Kern>
cudaError_t allow_smem(Kern kern, size_t bytes) {
  // Above 48 KB a kernel must opt in to its dynamic shared memory.
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <bool NT>
int launch_gmm_wgmma(const void* x, const void* w, const int* sizes, void* out, int m, int k,
                     int n, int first, int local, cudaStream_t s) {
  CUtensorMap tm_x, tm_w, tm_out;
  const cuuint64_t x_dims[2] = {static_cast<cuuint64_t>(k), static_cast<cuuint64_t>(m)};
  const cuuint64_t out_dims[2] = {static_cast<cuuint64_t>(n), static_cast<cuuint64_t>(m)};
  const cuuint32_t row_box[2] = {64, GmmSmem::kM};
  const cuuint64_t w_dims[3] = {static_cast<cuuint64_t>(NT ? k : n),
                                static_cast<cuuint64_t>(NT ? n : k),
                                static_cast<cuuint64_t>(local)};
  const cuuint32_t w_box[3] = {64, NT ? static_cast<cuuint32_t>(GMM_N) : 64u, 1};
  int err = encode_map(&tm_x, x, 2, x_dims, row_box);
  if (err == 0) err = encode_map(&tm_w, w, 3, w_dims, w_box);
  if (err == 0) err = encode_map(&tm_out, out, 2, out_dims, row_box);
  if (err != 0) return err;
  const int sms = sm_count();
  if (sms <= 0) return cudaErrorInvalidDevice;
  const long items =
      ((static_cast<long>(m) + GmmSmem::kM - 1) / GmmSmem::kM + local) *
      ((n + GMM_N - 1) / GMM_N);
  const int grid = static_cast<int>(items < sms ? items : sms);
  const size_t smem = sizeof(GmmSmem) + 1024;  // + alignment slack
  const cudaError_t e = allow_smem(gmm_wgmma_kernel<NT>, smem);
  if (e != cudaSuccess) return e;
  gmm_wgmma_kernel<NT><<<grid, GmmSmem::kThreads, smem, s>>>(
      tm_x, tm_w, tm_out, sizes, static_cast<__nv_bfloat16*>(out), m, k, n, first, local);
  return cudaGetLastError();
}

int launch_tgmm_wgmma(const void* x, const void* dy, const int* sizes, void* dw, int m, int k,
                      int n, int first, int local, int out_bf16, cudaStream_t s) {
  CUtensorMap tm_x, tm_dy;
  const cuuint64_t x_dims[2] = {static_cast<cuuint64_t>(k), static_cast<cuuint64_t>(m)};
  const cuuint64_t dy_dims[2] = {static_cast<cuuint64_t>(n), static_cast<cuuint64_t>(m)};
  const cuuint32_t box[2] = {64, WK};
  int err = encode_map(&tm_x, x, 2, x_dims, box);
  if (err == 0) err = encode_map(&tm_dy, dy, 2, dy_dims, box);
  if (err != 0) return err;
  const int sms = sm_count();
  if (sms <= 0) return cudaErrorInvalidDevice;
  const long items =
      static_cast<long>(local) * ((k + TGMM_M - 1) / TGMM_M) * ((n + TGMM_N - 1) / TGMM_N);
  if (items > 0x7fffffffL) return cudaErrorInvalidValue;
  const int grid = static_cast<int>(items < sms ? items : sms);
  const size_t smem = sizeof(TgmmSmem) + 1024;  // + alignment slack
  const cudaError_t e = allow_smem(tgmm_wgmma_kernel, smem);
  if (e != cudaSuccess) return e;
  tgmm_wgmma_kernel<<<grid, TgmmSmem::kThreads, smem, s>>>(tm_x, tm_dy, sizes, dw, m, k, n,
                                                         first, local, out_bf16);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The routes of `kind`: 0 f32 on FMA units, 1 bf16 on mma.sync, 2 bf16 on
// wgmma + TMA (K and N multiples of 8, 16-byte aligned bases, no empty
// dimension: cudaErrorInvalidValue otherwise, never another route).

// out [m, n] (bf16, or f32 under kind 0) = x [m, k] . w[g] (nt = 0: w
// [local, k, n]) or . w[g]^T (nt = 1: w [local, n, k]) over the rows of
// local groups 0..local-1, which are groups first.. of sizes (int32, on the
// device); every other row of out is written 0. Returns the launch error
// (0 on success), or kTensorMapError + a CUresult; nothing is synchronised.
int tfo_gmm(const void* x, const void* w, const int* sizes, void* out, int m, int k, int n,
            int first, int local, int nt, int kind, void* stream) {
  if (bad_dims(m, k, n, first, local) || kind < 0 || kind > 2) return cudaErrorInvalidValue;
  if (m == 0 || n == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kind == 2) {
    if (!tma_ok(m, k, n, local, x, w)) return cudaErrorInvalidValue;
    return nt ? launch_gmm_wgmma<true>(x, w, sizes, out, m, k, n, first, local, s)
              : launch_gmm_wgmma<false>(x, w, sizes, out, m, k, n, first, local, s);
  }
  const int tile_m = kind ? BM : FM, tile_n = kind ? BN : FN;
  const long items = (static_cast<long>(m) + tile_m - 1) / tile_m + local;
  const long ntiles = (static_cast<long>(n) + tile_n - 1) / tile_n;
  if (items > 0x7fffffffL || ntiles > 65535) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(items), static_cast<unsigned>(ntiles));
  const auto* xb = static_cast<const uint16_t*>(x);
  const auto* wb = static_cast<const uint16_t*>(w);
  auto* ob = static_cast<__nv_bfloat16*>(out);
  const auto* xf = static_cast<const float*>(x);
  const auto* wf = static_cast<const float*>(w);
  auto* of = static_cast<float*>(out);
  if (kind && nt) {
    gmm_mma_kernel<true><<<grid, THREADS, 0, s>>>(xb, wb, sizes, ob, m, k, n, first, local);
  } else if (kind) {
    gmm_mma_kernel<false><<<grid, THREADS, 0, s>>>(xb, wb, sizes, ob, m, k, n, first, local);
  } else if (nt) {
    gmm_fma_kernel<true><<<grid, THREADS, 0, s>>>(xf, wf, sizes, of, m, k, n, first, local);
  } else {
    gmm_fma_kernel<false><<<grid, THREADS, 0, s>>>(xf, wf, sizes, of, m, k, n, first, local);
  }
  return cudaGetLastError();
}

// dw [local, k, n] = x[rows of g]^T . dy[rows of g] for local groups
// 0..local-1 (groups first.. of sizes); x [m, k], dy [m, n], both bf16
// (kind 1, 2) or f32 (kind 0). dw is f32, or bf16 with out_bf16 (one
// rounding of the f32 sum). Every dw[g] is written whole. Returns the
// launch error, or kTensorMapError + a CUresult.
int tfo_tgmm(const void* x, const void* dy, const int* sizes, void* dw, int m, int k, int n,
             int first, int local, int kind, int out_bf16, void* stream) {
  if (bad_dims(m, k, n, first, local) || kind < 0 || kind > 2) return cudaErrorInvalidValue;
  if (k == 0 || n == 0 || local == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kind == 2) {
    if (!tma_ok(m, k, n, local, x, dy)) return cudaErrorInvalidValue;
    return launch_tgmm_wgmma(x, dy, sizes, dw, m, k, n, first, local, out_bf16, s);
  }
  const int tile_m = kind ? BM : FM, tile_n = kind ? BN : FN;
  const long ntiles = (static_cast<long>(n) + tile_n - 1) / tile_n;
  const long ktiles = (static_cast<long>(k) + tile_m - 1) / tile_m;
  if (ntiles > 0x7fffffffL || ktiles > 65535 || local > 65535) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(ntiles), static_cast<unsigned>(ktiles),
                  static_cast<unsigned>(local));
  if (kind) {
    tgmm_mma_kernel<<<grid, THREADS, 0, s>>>(static_cast<const uint16_t*>(x),
                                             static_cast<const uint16_t*>(dy), sizes, dw, m, k,
                                             n, first, out_bf16);
  } else {
    tgmm_fma_kernel<<<grid, THREADS, 0, s>>>(static_cast<const float*>(x),
                                             static_cast<const float*>(dy), sizes, dw, m, k, n,
                                             first, out_bf16);
  }
  return cudaGetLastError();
}

}  // extern "C"
