// Fused stride-1 ResNet bottleneck forward for Hopper (sm_90a).
//
// Replaces tf_operator_tpu/ops/fused_bottleneck.py::_fwd_kernel (launched by
// _fwd). Built by tf_operator_tpu_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// into a shared library with the plain C interface at the bottom of this
// file, loaded with ctypes by tf_operator_tpu_torch/ops/fused_bottleneck.py.
//
// What it computes, per batch tile of tile_b images (R = tile_b*H*W rows):
//   t1 = x . w1 -> ghost BN1 -> relu -> round to T = n1
//   t2 = conv3x3 SAME(n1, zero-padded)  -> ghost BN2 -> relu -> round = n2
//   t3 = n2 . w3 -> ghost BN3 -> + x -> relu -> round = y
// with T = f32 or bf16, every product accumulated in f32, and the tile's raw
// moments (mean, mean of squares) of t1, t2, t3 written out as st1..st3.
// Ghost BN is (t - m) * a + b, a = scale / sqrt(max(E[t^2] - m^2, 0) + eps),
// over the tile's own rows.
//
// Why it is not one block per tile, as the TPU kernel is one grid step per
// tile: at ResNet-50's stage 1 a tile is one 56x56x256 image, 1.6 MB of x in
// bf16, against 227 KB of shared memory a block can use, and ghost BN needs
// every row of the tile before it can normalise any. So the forward is a
// chain of launches on the caller's stream, each over all tiles at once, and
// a tile's moments are per-block column sums ("part") that a stats launch
// adds in a fixed block order (no float atomics: reruns agree bit for bit).
//
// What bounds it on the H100: at stage 1 (batch 256, 56x56, Cw 256, Cn 64)
// the block is 111.8 GFLOP against 822 MB of x and y, so the bound is bytes
// (0.245 ms at 3.35 TB/s); at stage 4 (7x7, Cw 2048, Cn 512) the same FLOPs
// against 112 MB, so operations (0.113 ms at 989 TF/s bf16).
//
// bf16 (bottleneck_wgmma_kernel, below the f32 kernels): every product runs
// on the tensor cores. One GEMM template, 128 rows x BN output channels per
// output tile ("item"): two consumer warpgroups of 64 rows each issue SS
// wgmma (both operands from 128-byte-swizzled shared memory, f32
// accumulators) over a ring of min(4, K / 64) 64-deep k-tiles that a
// producer fills. Blocks are persistent (as many as fit, each walking items),
// so where the ring is deeper than one stage the producer loads the next
// item's k-tiles while the consumers run this item's epilogue. BN is 64
// while K < 256 (one to three k-tiles: the block's load and epilogue
// latencies set its time, and small blocks, three an SM where the producer is
// one TMA warp, hide each other's; a second ring stage for G at K = 64 cost
// it a block an SM and was slower), else the widest of 256, 128 and 64 that
// divides N, with setmaxnreg moving registers to the consumers. The weights are read as they lie, [K, N] with
// N contiguous, through TMA boxes of 64 k-rows x 64 columns, MN-major (the
// products' transpose-B bit), so the wrapper copies nothing. A comes from one
// of two sources, K-major:
//   plain: a [rows, K] bf16 matrix through a 3-D TMA map [tiles, R, K], so
//          rows past a tile's end are out of bounds and read zero, never the
//          next tile's rows;
//   conv:  the 3x3 window over n1 as an implicit GEMM, K = 9 Cn tap-major as
//          the HWIO weights are: a producer warpgroup gathers each k-tile
//          with 16-byte cp.async, zero-filled (src-size 0) where the tap
//          falls outside the image or the row outside the tile, into the
//          swizzled layout TMA would write. Zero fill is right because n1 is
//          already post-BN, post-relu: SAME pads n1 with zeros.
// Both read bf16 that already holds the normalised, relu'd, rounded values,
// so no register ever feeds a wgmma (no C7513 hazard). The epilogue does one
// of: store t in f32 and write the item's column sums of t and t^2 into
// part; write the sums only; or y = relu((t3 - m3) * a3 + b3 + x) in bf16,
// with the item's x tile loaded by TMA during the products and y stored by
// TMA from the same shared tile (full-line traffic both ways).
// Launches, in order:
//   A  plain,  epilogue store+sums  t1 = x . w1             (f32 t)
//   B  stats_kernel + bn_apply_kernel: st1, a1, n1 (bf16)
//   C  conv,   epilogue store+sums  t2 = conv3x3(n1)        (f32 t, reused)
//   D  stats + apply: st2, a2, n2 (bf16, into n1's buffer: C has read it)
//   E  plain,  epilogue sums only   t3 = n2 . w3, nothing stored
//   F  stats: st3, a3
//   G  plain,  epilogue residual    t3 recomputed in E's tiling and k-order,
//      so E's moments are those of these exact t3; y stored in bf16.
// So no [rows, Cw] f32 buffer exists: recomputing t3 costs 2 rows Cn Cw
// FLOPs (+24% at every stage) and saves writing and rereading 8 rows Cw
// bytes. Workspace: t [rows, Cn] f32, n [rows, Cn] bf16, part, mult.
//
// Where trouble lies. (1) A tile has R = 3136 rows at every ResNet-50 stage,
// 24.5 x 128: items are (row block of a batch tile, channel block), so none
// spans two batch tiles; the last row block is ragged, and every epilogue
// keeps rows r >= R out of the sums and the stores (the plain loads read them
// as zero, the gather skips them, the y map does not write them). (2) Column
// sums from the wgmma fragment: a thread holds two rows of each 8-row group;
// it adds its two, then shuffles over the 8 lanes that share its columns
// (xor 4, 8, 16), then the 8 consumer warps' sums meet in shared memory, in
// warp order. (Halving the values at each shuffle step, 7/8 of a shuffle a
// value instead of 3, was slower: its selects and live values spilled.)
// Per-item partials and a fixed-order stats launch keep st deterministic. (3) cp.async writes shared memory through the generic
// proxy: each consumer fences (fence.proxy.async) after the full barrier,
// before its wgmma reads the gathered tile. (4) Barrier waits carry no
// watchdog, descriptors derive from a warp-uniform warpgroup index and move
// by desc_advance (a spill or a watchdog serialises wgmma: C7512).
//
// f32 keeps the first version (gemm_kernel, stats_kernel, residual_kernel):
// f32 FMA products on the CUDA cores, 64x64 output tiles, 4x4 per thread,
// 16-deep shared stages, seven launches, t1, t2 and t3 in an f32 workspace.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kBM = 64;  // rows per block (ROWS_PER_BLOCK in the wrapper)
constexpr int kBN = 64;  // output channels per block
constexpr int kBK = 16;  // depth of one shared-memory stage
constexpr int kThreads = 256;
constexpr int kAStride = kBM + 4;  // keeps float4 reads 16-byte aligned
constexpr float kEps = 1e-5f;

// Where the A operand of a product comes from.
enum ASource {
  kInputX = 0,   // x itself
  kNorm1x1 = 1,  // the previous product (f32), normalised on load
  kNormConv = 2, // the same, read through the 3x3 window
};

// relu((t - m) * a + b): n1 / n2 as the TPU kernel feeds them to the next
// product.
__device__ __forceinline__ float bn_relu(float t, float m, float a, float b) {
  return fmaxf((t - m) * a + b, 0.f);
}

// C = A . B over the rows of one tile, 64 rows x 64 channels per block:
// grid (row blocks of a tile, ceil(N / 64), tiles). A is [rows, Ka] row-major
// (K = Ka, or 9 * Ka through the 3x3 window, tap-major as HWIO weights are),
// B is [K, N], C is [rows, N]. The block's column sums of C and C^2
// go to part[tile][block][0|1][N].
template <int SRC>
__global__ void __launch_bounds__(kThreads)
gemm_kernel(const void* __restrict__ a_src, const float* __restrict__ a_st,
            const float* __restrict__ a_mult, const float* __restrict__ a_bias,
            const float* __restrict__ bmat, float* __restrict__ c,
            float* __restrict__ part, int rows_per_tile, int K, int N, int Ka,
            int h, int w) {
  __shared__ __align__(16) float As[kBK][kAStride];
  __shared__ __align__(16) float Bs[kBK][kBN];
  __shared__ float red[2][kThreads / 16][kBN];

  const int tid = threadIdx.x;
  const int tile = blockIdx.z;
  const int r0 = blockIdx.x * kBM;  // first row of the block within the tile
  const int n0 = blockIdx.y * kBN;
  const size_t tile_row0 = static_cast<size_t>(tile) * rows_per_tile;
  const float* st_m = a_st + static_cast<size_t>(tile) * 2 * Ka;  // tile means
  const float* mult = a_mult + static_cast<size_t>(tile) * Ka;

  // A loads: thread owns depth a_k and rows a_r + 16 * l (l < 4).
  const int a_k = tid % kBK;
  const int a_r = tid / kBK;
  // Their pixel coordinates within the tile, for the 3x3 window.
  int a_img[4], a_y[4], a_x[4];
  bool a_in[4];
#pragma unroll
  for (int l = 0; l < 4; ++l) {
    const int rr = r0 + a_r + 16 * l;
    a_in[l] = rr < rows_per_tile;
    const int hw = h * w;
    a_img[l] = rr / hw;
    const int rem = rr - a_img[l] * hw;
    a_y[l] = rem / w;
    a_x[l] = rem - a_y[l] * w;
  }
  // B loads: thread owns channel b_n and depths b_k + 4 * l.
  const int b_n = tid % kBN;
  const int b_k = tid / kBN;
  // Compute: thread owns rows ty*4 + i and channels tx*4 + j.
  const int ty = tid / 16, tx = tid % 16;
  float acc[4][4] = {};

  for (int k0 = 0; k0 < K; k0 += kBK) {
    const int k = k0 + a_k;
    if (SRC == kInputX) {
      const float* a = static_cast<const float*>(a_src);
#pragma unroll
      for (int l = 0; l < 4; ++l) {
        float v = 0.f;
        if (a_in[l] && k < K) {
          v = a[(tile_row0 + r0 + a_r + 16 * l) * static_cast<size_t>(Ka) + k];
        }
        As[a_k][a_r + 16 * l] = v;
      }
    } else if (SRC == kNorm1x1) {
      const float* a = static_cast<const float*>(a_src);
      float m = 0.f, am = 0.f, bb = 0.f;
      if (k < K) m = st_m[k], am = mult[k], bb = a_bias[k];
#pragma unroll
      for (int l = 0; l < 4; ++l) {
        float v = 0.f;
        if (a_in[l] && k < K) {
          const float t = a[(tile_row0 + r0 + a_r + 16 * l) * static_cast<size_t>(Ka) + k];
          v = bn_relu(t, m, am, bb);
        }
        As[a_k][a_r + 16 * l] = v;
      }
    } else {  // kNormConv
      const float* a = static_cast<const float*>(a_src);
      const int tap = k / Ka;
      const int ch = k - tap * Ka;
      const int dy = tap / 3 - 1, dx = tap % 3 - 1;
      float m = 0.f, am = 0.f, bb = 0.f;
      if (k < K) m = st_m[ch], am = mult[ch], bb = a_bias[ch];
#pragma unroll
      for (int l = 0; l < 4; ++l) {
        float v = 0.f;
        const int yy = a_y[l] + dy, xx = a_x[l] + dx;
        if (a_in[l] && k < K && yy >= 0 && yy < h && xx >= 0 && xx < w) {
          const size_t src = tile_row0 + (static_cast<size_t>(a_img[l]) * h + yy) * w + xx;
          v = bn_relu(a[src * Ka + ch], m, am, bb);
        }
        As[a_k][a_r + 16 * l] = v;
      }
    }
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      const int kb = k0 + b_k + 4 * l;
      float v = 0.f;
      if (kb < K && n0 + b_n < N) v = bmat[static_cast<size_t>(kb) * N + n0 + b_n];
      Bs[b_k + 4 * l][b_n] = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

  // Store C and this thread's column sums over its valid rows.
  float s[4] = {}, q[4] = {};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int rr = r0 + ty * 4 + i;
    if (rr >= rows_per_tile) continue;
    float* crow = c + (tile_row0 + rr) * static_cast<size_t>(N);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < N) crow[n] = acc[i][j];
      s[j] += acc[i][j];
      q[j] += acc[i][j] * acc[i][j];
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    red[0][ty][tx * 4 + j] = s[j];
    red[1][ty][tx * 4 + j] = q[j];
  }
  __syncthreads();
  if (tid < 2 * kBN) {
    const int which = tid / kBN, col = tid % kBN;
    float sum = 0.f;
#pragma unroll
    for (int t = 0; t < kThreads / 16; ++t) sum += red[which][t][col];
    if (n0 + col < N) {
      const size_t blocks = gridDim.x;
      part[((tile * blocks + blockIdx.x) * 2 + which) * static_cast<size_t>(N) + n0 + col] = sum;
    }
  }
}

// Per (tile, channel): the block partials summed in block order -> the raw
// moments st[tile][0|1][c] and the BN multiplier mult[tile][c].
__global__ void stats_kernel(const float* __restrict__ part,
                             const float* __restrict__ scale, int tiles,
                             int blocks, int C, int rows_per_tile,
                             float* __restrict__ st, float* __restrict__ mult) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= tiles * C) return;
  const int tile = idx / C, ch = idx % C;
  float s = 0.f, q = 0.f;
  for (int b = 0; b < blocks; ++b) {
    const size_t base = (static_cast<size_t>(tile) * blocks + b) * 2 * C + ch;
    s += part[base];
    q += part[base + C];
  }
  const float m = s / rows_per_tile;
  const float m2 = q / rows_per_tile;
  const float v = fmaxf(m2 - m * m, 0.f);
  st[(static_cast<size_t>(tile) * 2) * C + ch] = m;
  st[(static_cast<size_t>(tile) * 2 + 1) * C + ch] = m2;
  mult[static_cast<size_t>(tile) * C + ch] = scale[ch] * (1.f / sqrtf(v + kEps));
}

// y = relu((t3 - m3) * a3 + b3 + x).
__global__ void residual_kernel(const float* __restrict__ t3,
                                const float* __restrict__ st3,
                                const float* __restrict__ mult3,
                                const float* __restrict__ b3,
                                const float* __restrict__ x, float* __restrict__ y,
                                size_t total, int C, int rows_per_tile) {
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       i < total; i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const size_t row = i / C;
    const int ch = static_cast<int>(i - row * C);
    const size_t tile = row / rows_per_tile;
    const float m = st3[tile * 2 * C + ch];
    const float z = (t3[i] - m) * mult3[tile * C + ch] + b3[ch];
    y[i] = fmaxf(z + x[i], 0.f);
  }
}

int launch_stats(const float* part, const float* scale, int tiles, int blocks,
                 int C, int rows_per_tile, float* st, float* mult,
                 cudaStream_t stream) {
  const int n = tiles * C;
  stats_kernel<<<(n + 255) / 256, 256, 0, stream>>>(part, scale, tiles, blocks, C,
                                                    rows_per_tile, st, mult);
  return cudaGetLastError();
}

int run(const void* x, const void* w1, const void* w2, const void* w3,
        const float* s1, const float* b1, const float* s2, const float* b2,
        const float* s3, const float* b3, void* y, float* st1, float* st2,
        float* st3, float* t1, float* t2, float* t3, float* part, float* mult,
        int batch, int h, int w, int cw, int cn, int tile_b, cudaStream_t stream) {
  const int tiles = batch / tile_b;
  const int rows_per_tile = tile_b * h * w;
  const int blocks = (rows_per_tile + kBM - 1) / kBM;
  const dim3 block(kThreads);
  int err;

  // A, B: t1 = x . w1 and its moments.
  gemm_kernel<kInputX><<<dim3(blocks, (cn + kBN - 1) / kBN, tiles), block, 0, stream>>>(
      x, nullptr, nullptr, nullptr, static_cast<const float*>(w1), t1, part,
      rows_per_tile, cw, cn, cw, h, w);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = launch_stats(part, s1, tiles, blocks, cn, rows_per_tile, st1, mult, stream)) != cudaSuccess) return err;
  // C, D: t2 = conv3x3(n1) and its moments.
  gemm_kernel<kNormConv><<<dim3(blocks, (cn + kBN - 1) / kBN, tiles), block, 0, stream>>>(
      t1, st1, mult, b1, static_cast<const float*>(w2), t2, part, rows_per_tile,
      9 * cn, cn, cn, h, w);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = launch_stats(part, s2, tiles, blocks, cn, rows_per_tile, st2, mult, stream)) != cudaSuccess) return err;
  // E, F: t3 = n2 . w3 and its moments.
  gemm_kernel<kNorm1x1><<<dim3(blocks, (cw + kBN - 1) / kBN, tiles), block, 0, stream>>>(
      t2, st2, mult, b2, static_cast<const float*>(w3), t3, part, rows_per_tile,
      cn, cw, cn, h, w);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = launch_stats(part, s3, tiles, blocks, cw, rows_per_tile, st3, mult, stream)) != cudaSuccess) return err;
  // G: the residual epilogue.
  const size_t total = static_cast<size_t>(batch) * h * w * cw;
  size_t grid = (total + 255) / 256;
  if (grid > 132 * 32) grid = 132 * 32;
  residual_kernel<<<static_cast<unsigned>(grid), 256, 0, stream>>>(
      t3, st3, mult, b3, static_cast<const float*>(x), static_cast<float*>(y), total, cw,
      rows_per_tile);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores (see the file header).
// ---------------------------------------------------------------------------
using bf16 = __nv_bfloat16;

constexpr int kWgThreads = 128;
constexpr int kWM = 128;     // rows per block, 64 per consumer warpgroup
constexpr int kWK = 64;      // depth of a k-tile: one swizzle box
constexpr int kWStages = 4;  // the deepest ring; min(4, K / 64) stages run
constexpr uint32_t kATileBytes = kWM * kWK * 2;
constexpr uint32_t kBoxBytes = kWK * 128;  // a box: 64 rows of 64 bf16

// Where A comes from, and what the epilogue does.
enum WSource { kPlainA = 0, kConvA = 1 };
enum WEpilogue { kStoreSums = 0, kSumsOnly = 1, kResidual = 2 };

// Threads of a block: two consumer warpgroups and a producer, which is one
// warp where it only issues TMA and keeps its registers (plain A at BN 64,
// so that three blocks fit an SM), else a warpgroup (the conv gather uses
// all 128 threads; setmaxnreg, at BN >= 128, takes whole warpgroups).
template <int SRC, int BN>
__host__ __device__ constexpr int w_threads() {
  return SRC == kPlainA && BN == 64 ? 2 * kWgThreads + 32 : 3 * kWgThreads;
}

// Shared memory of a block with `stages` ring stages, from a 1024-byte
// aligned base: the A tiles, the B tiles, each consumer warp's column sums
// of t and t^2 (red[8][2][BN]), the residual epilogue's x tiles (each BN /
// 64 swizzled boxes of 128 rows, where EPI is kResidual: two, so the next
// item's loads while this one's is stored, or one at BN 256), then the
// barriers (full and empty per stage, x_full and x_empty per x tile).
template <int BN, int EPI>
__host__ __device__ constexpr int w_x_bufs() {
  return EPI != kResidual ? 0 : (BN == 256 ? 1 : 2);
}
template <int BN, int EPI>
__host__ __device__ constexpr uint32_t w_x_bytes() {
  return w_x_bufs<BN, EPI>() * BN * kWM * 2;
}
// The deepest ring that fits: the residual's 64 KB x tile at BN 256 leaves
// room for three stages.
template <int BN, int EPI>
__host__ __device__ constexpr int w_max_stages() {
  return EPI == kResidual && BN == 256 ? 3 : kWStages;
}
template <int BN, int EPI>
__host__ __device__ constexpr int w_stages(int K) {
  return K / kWK < w_max_stages<BN, EPI>() ? K / kWK : w_max_stages<BN, EPI>();
}
template <int BN>
__host__ __device__ constexpr uint32_t w_b_offset(int stages) { return stages * kATileBytes; }
template <int BN>
__host__ __device__ constexpr uint32_t w_red_offset(int stages) {
  return stages * (kATileBytes + BN * kWK * 2);
}
template <int BN>
__host__ __device__ constexpr uint32_t w_x_offset(int stages) {
  return w_red_offset<BN>(stages) + 8 * 2 * BN * 4;  // a multiple of 1024
}
template <int BN, int EPI>
__host__ __device__ constexpr uint32_t w_bar_offset(int stages) {
  return w_x_offset<BN>(stages) + w_x_bytes<BN, EPI>();
}
template <int BN, int EPI>
__host__ __device__ constexpr size_t w_smem_bytes(int stages) {
  return 1024 + w_bar_offset<BN, EPI>(stages) + (2 * kWStages + 4) * sizeof(uint64_t);
}

__device__ __forceinline__ unsigned char* smem_base() {
  extern __shared__ unsigned char smem_raw[];
  return reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                          ~static_cast<uintptr_t>(1023));
}

// The k-tile kt of the weights' columns [n0, n0 + BN) into dst: BN / 64
// boxes of 64 reduction rows x 64 columns, read MN-major by the products.
template <int BN>
__device__ __forceinline__ void load_b(bf16* dst, const CUtensorMap* tm_b, uint64_t* bar,
                                       int kt, int n0) {
#pragma unroll
  for (int box = 0; box < BN / 64; ++box) {
    hopper::tma_load_3d(dst + box * kWK * 64, tm_b, bar, n0 + 64 * box, kt * kWK, 0);
  }
}

// One product: C[rows x N] = A . B with B [K, N] (MN-major), in output
// tiles ("items") of 128 rows of one batch tile x BN channels, item i =
// (row block i % RB, channel block (i / RB) % (N / BN), batch tile), RB =
// ceil(R / 128). Persistent: block b takes items b, b + gridDim.x, ..., so
// the producer loads the next item's k-tiles while the consumers run this
// item's epilogue. Plain A reads tm_a, a 3-D map [tiles, R, K]; conv A
// gathers from a_conv [rows, K / 9]. Epilogues: kStoreSums writes t_out
// [rows, N] f32 and the item's column sums of t and t^2 to
// part[tile][row block][0|1][N]; kSumsOnly the sums alone; kResidual y =
// relu((t - st_mean) * mult + bias + x) in bf16, [rows, N]: the producer
// loads the item's x tile by TMA (tm_x) into one of w_x_bufs buffers ahead
// of time, each thread turns its fragment's x into y in place, and one
// thread stores the tile by TMA (tm_y), which writes no row past R.
template <int SRC, int BN, int EPI>
__global__ void __launch_bounds__(w_threads<SRC, BN>(), BN == 64 ? (SRC == kPlainA ? 3 : 2) : 1)
bottleneck_wgmma_kernel(const __grid_constant__ CUtensorMap tm_a,
                        const __grid_constant__ CUtensorMap tm_b,
                        const __grid_constant__ CUtensorMap tm_x,
                        const __grid_constant__ CUtensorMap tm_y,
                        const bf16* __restrict__ a_conv, float* __restrict__ t_out,
                        float* __restrict__ part, const float* __restrict__ st,
                        const float* __restrict__ mult, const float* __restrict__ bias,
                        int tiles, int rows_per_tile, int K, int N, int h, int w) {
  constexpr int PN = BN < 128 ? BN : 128;  // width of one wgmma
  constexpr int NP = BN / PN;              // wgmma per k-step
  constexpr bool kSetRegs = BN > 64;
  constexpr uint32_t kBTileBytes = BN * kWK * 2;
  constexpr int kXBufs = w_x_bufs<BN, EPI>();
  unsigned char* base_ptr = smem_base();
  const int stages = w_stages<BN, EPI>(K);
  bf16* sm_a = reinterpret_cast<bf16*>(base_ptr);
  bf16* sm_b = reinterpret_cast<bf16*>(base_ptr + w_b_offset<BN>(stages));
  float(*red)[2][BN] = reinterpret_cast<float(*)[2][BN]>(base_ptr + w_red_offset<BN>(stages));
  bf16* sm_x = reinterpret_cast<bf16*>(base_ptr + w_x_offset<BN>(stages));
  uint64_t* full = reinterpret_cast<uint64_t*>(base_ptr + w_bar_offset<BN, EPI>(stages));
  uint64_t* empty = full + kWStages;
  uint64_t* x_full = empty + kWStages;
  uint64_t* x_empty = x_full + 2;
  const int nk = K / kWK;
  const int rblocks = (rows_per_tile + kWM - 1) / kWM;
  const int nblocks = N / BN;
  const int items = rblocks * nblocks * tiles;
  const int wg = hopper::warpgroup();
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      // conv: 128 cp.async arrivals + the weights' TMA arrival.
      hopper::mbar_init(&full[s], SRC == kConvA ? kWgThreads + 1 : 1);
      hopper::mbar_init(&empty[s], 8);
    }
    for (int xb = 0; xb < 2; ++xb) {
      hopper::mbar_init(&x_full[xb], 1);
      hopper::mbar_init(&x_empty[xb], 1);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {
    if constexpr (kSetRegs) hopper::regs_dealloc<56>();
    const int pt = threadIdx.x - 2 * kWgThreads;
    int s = 0, xb = 0;
    uint32_t phase = 0, xphase = 0;
    if constexpr (SRC == kPlainA) {
      if (pt != 0) return;
      for (int item = blockIdx.x; item < items; item += gridDim.x) {
        const int r0 = (item % rblocks) * kWM;
        const int n0 = (item / rblocks % nblocks) * BN;
        const int tile = item / (rblocks * nblocks);
        for (int kt = 0; kt < nk; ++kt) {
          hopper::mbar_wait(&empty[s], phase ^ 1);
          hopper::mbar_arrive_expect_tx(&full[s], kATileBytes + kBTileBytes);
          hopper::tma_load_3d(sm_a + s * kWM * kWK, &tm_a, &full[s], kt * kWK, r0, tile);
          load_b<BN>(sm_b + s * BN * kWK, &tm_b, &full[s], kt, n0);
          if (++s == stages) {
            s = 0;
            phase ^= 1;
          }
        }
        if constexpr (EPI == kResidual) {
          bf16* xs = sm_x + xb * BN * kWM;
          hopper::mbar_wait(&x_empty[xb], xphase ^ 1);
          hopper::mbar_arrive_expect_tx(&x_full[xb], BN * kWM * 2);
#pragma unroll
          for (int box = 0; box < BN / 64; ++box) {
            hopper::tma_load_3d(xs + box * kWM * 64, &tm_x, &x_full[xb], n0 + 64 * box, r0,
                                tile);
          }
          if (++xb == kXBufs) {
            xb = 0;
            xphase ^= 1;
          }
        }
      }
    } else {
      // Thread pt copies 16-byte chunk pt % 8 of rows pt / 8 + 16 i: eight
      // neighbouring threads read one pixel's 128 contiguous bytes.
      const int chunk = pt & 7;
      const int ca = K / 9;  // channels of n1
      const int cblocks = ca / kWK;
      const int hw = h * w;
      for (int item = blockIdx.x; item < items; item += gridDim.x) {
        const int r0 = (item % rblocks) * kWM;
        const int n0 = (item / rblocks % nblocks) * BN;
        const int tile = item / (rblocks * nblocks);
        int pos[8];  // (y << 16) | x of each row, -1 past the tile's end
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int rr = r0 + (pt >> 3) + 16 * i;
          const int rem = rr % hw;
          const int yy = rem / w;
          pos[i] = rr < rows_per_tile ? (yy << 16) | (rem - yy * w) : -1;
        }
        const bf16* base = a_conv + static_cast<size_t>(tile) * rows_per_tile * ca + chunk * 8;
        for (int kt = 0; kt < nk; ++kt) {
          const int tap = kt / cblocks;
          const int cb = kt - tap * cblocks;
          const int dy = tap / 3 - 1, dx = tap % 3 - 1;
          hopper::mbar_wait(&empty[s], phase ^ 1);
          if (pt == 0) {
            hopper::mbar_arrive_expect_tx(&full[s], kBTileBytes);
            load_b<BN>(sm_b + s * BN * kWK, &tm_b, &full[s], kt, n0);
          }
          bf16* dst = sm_a + s * kWM * kWK;
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int r = (pt >> 3) + 16 * i;
            const int yy = (pos[i] >> 16) + dy, xx = (pos[i] & 0xffff) + dx;
            const bool ok = pos[i] >= 0 && yy >= 0 && yy < h && xx >= 0 && xx < w;
            const bf16* src =
                ok ? base + static_cast<size_t>(r0 + r + dy * w + dx) * ca + cb * kWK : a_conv;
            hopper::cp_async_16(dst + r * kWK + ((chunk ^ (r & 7)) * 8), src, ok ? 16 : 0);
          }
          hopper::cp_async_mbar_arrive(&full[s]);
          if (++s == stages) {
            s = 0;
            phase ^= 1;
          }
        }
      }
      hopper::cp_async_wait_all();
    }
    return;
  }

  // Consumers: warpgroup wg owns rows [r0 + 64 wg, r0 + 64 wg + 64) of each
  // item; this thread holds rows rl and rl + 8, columns n0 + p PN + 8 j +
  // cq + {0, 1}.
  if constexpr (kSetRegs) hopper::regs_alloc<224>();
  const uint64_t desc_a = hopper::desc_sw128(hopper::smem_u32(sm_a) + wg * 64 * 128, 16, 1024);
  const uint64_t desc_b = hopper::desc_sw128(hopper::smem_u32(sm_b), kBoxBytes, 1024);
  const int warp = threadIdx.x / 32;  // 0..7
  const int rl = 64 * wg + 16 * (warp & 3) + (lane >> 2);
  const int cq = 2 * (lane & 3);
  int s = 0, xb = 0;
  uint32_t phase = 0, xphase = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int r0 = (item % rblocks) * kWM;
    const int n0 = (item / rblocks % nblocks) * BN;
    const int tile = item / (rblocks * nblocks);
    float acc[NP][PN / 2];
#pragma unroll
    for (int p = 0; p < NP; ++p) {
#pragma unroll
      for (int i = 0; i < PN / 2; ++i) acc[p][i] = 0.f;
    }
    int prev = 0;
    for (int kt = 0; kt < nk; ++kt) {
      hopper::mbar_wait(&full[s], phase);
      if constexpr (SRC == kConvA) hopper::fence_proxy_async();
      hopper::wg_fence();
#pragma unroll
      for (int kk = 0; kk < kWK / 16; ++kk) {
        const uint64_t da = hopper::desc_advance(desc_a, s * kATileBytes + kk * 32);
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          const uint64_t db =
              hopper::desc_advance(desc_b, s * kBTileBytes + p * (PN / 64) * kBoxBytes + kk * 2048);
          if constexpr (PN == 64) {
            hopper::wgmma_ss_m64n64<1>(acc[p], da, db);
          } else {
            hopper::wgmma_ss_m64n128<1>(acc[p], da, db);
          }
        }
      }
      hopper::wg_commit();
      // The previous k-tile's products are done: its stage goes back.
      hopper::wg_wait<1>();
      if (kt > 0) {
        __syncwarp();
        if (lane == 0) hopper::mbar_arrive(&empty[prev]);
      }
      prev = s;
      if (++s == stages) {
        s = 0;
        phase ^= 1;
      }
    }
    hopper::wg_wait<0>();
#pragma unroll
    for (int p = 0; p < NP; ++p) hopper::pin(acc[p]);
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[prev]);

    // Epilogue.
    const size_t tile_row0 = static_cast<size_t>(tile) * rows_per_tile;
    bool ok[2];
    size_t grow[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int rr = r0 + rl + 8 * hh;
      ok[hh] = rr < rows_per_tile;
      grow[hh] = tile_row0 + rr;
    }
    const float* st_m = st + static_cast<size_t>(tile) * 2 * N;
    const float* mul = mult + static_cast<size_t>(tile) * N;
    bf16* xs = sm_x + xb * BN * kWM;
    if constexpr (EPI == kResidual) hopper::mbar_wait(&x_full[xb], xphase);
#pragma unroll
    for (int p = 0; p < NP; ++p) {
#pragma unroll
      for (int j = 0; j < PN / 8; ++j) {
        const int cb = p * PN + 8 * j + cq;  // column within the item
        const int c = n0 + cb;
        if constexpr (EPI == kResidual) {
          const float2 m = *reinterpret_cast<const float2*>(st_m + c);
          const float2 a = *reinterpret_cast<const float2*>(mul + c);
          const float2 b = *reinterpret_cast<const float2*>(bias + c);
          // x (and then y) at row r, column cb of the swizzled tile: box cb /
          // 64, 16-byte chunk (cb % 64) / 8 permuted by r % 8.
          bf16* xbox = xs + (cb >> 6) * kWM * 64 + (cb & 7);
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int i = 4 * j + 2 * hh;
            const int r = rl + 8 * hh;
            __nv_bfloat162* px = reinterpret_cast<__nv_bfloat162*>(
                xbox + r * 64 + ((((cb & 63) >> 3) ^ (r & 7)) << 3));
            const __nv_bfloat162 xv = *px;
            const float z0 = (acc[p][i] - m.x) * a.x + b.x + __low2float(xv);
            const float z1 = (acc[p][i + 1] - m.y) * a.y + b.y + __high2float(xv);
            *px = __floats2bfloat162_rn(fmaxf(z0, 0.f), fmaxf(z1, 0.f));
          }
        } else {
          float s0 = 0.f, s1 = 0.f, q0 = 0.f, q1 = 0.f;
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            if (!ok[hh]) continue;
            const int i = 4 * j + 2 * hh;
            const float v0 = acc[p][i], v1 = acc[p][i + 1];
            if constexpr (EPI == kStoreSums) {
              *reinterpret_cast<float2*>(t_out + grow[hh] * N + c) = make_float2(v0, v1);
            }
            s0 += v0;
            s1 += v1;
            q0 += v0 * v0;
            q1 += v1 * v1;
          }
#pragma unroll
          for (int off = 4; off < 32; off <<= 1) {
            s0 += __shfl_xor_sync(0xffffffffu, s0, off);
            s1 += __shfl_xor_sync(0xffffffffu, s1, off);
            q0 += __shfl_xor_sync(0xffffffffu, q0, off);
            q1 += __shfl_xor_sync(0xffffffffu, q1, off);
          }
          if (lane < 4) {
            red[warp][0][cb] = s0;
            red[warp][0][cb + 1] = s1;
            red[warp][1][cb] = q0;
            red[warp][1][cb + 1] = q1;
          }
        }
      }
    }
    if constexpr (EPI == kResidual) {
      hopper::fence_proxy_async();
      hopper::bar_sync(1, 2 * kWgThreads);
      if (threadIdx.x == 0) {
#pragma unroll
        for (int box = 0; box < BN / 64; ++box) {
          hopper::tma_store_3d(&tm_y, xs + box * kWM * 64, n0 + 64 * box, r0, tile);
        }
        // The buffer goes back to the producer once the store has read it.
        hopper::tma_store_commit_and_wait();
        hopper::mbar_arrive(&x_empty[xb]);
      }
      if (++xb == kXBufs) {
        xb = 0;
        xphase ^= 1;
      }
    } else {
      hopper::bar_sync(1, 2 * kWgThreads);
      const size_t blk = static_cast<size_t>(tile) * rblocks + r0 / kWM;
      for (int idx = threadIdx.x; idx < 2 * BN; idx += 2 * kWgThreads) {
        const int which = idx / BN, col = idx - which * BN;
        float sum = 0.f;
#pragma unroll
        for (int wv = 0; wv < 8; ++wv) sum += red[wv][which][col];
        part[(blk * 2 + which) * N + n0 + col] = sum;
      }
      // red is written again by the next item.
      hopper::bar_sync(1, 2 * kWgThreads);
    }
  }
}

// n = round(relu((t - m) * a + b)) to bf16 over t [rows, C] f32, with the
// tile's mean m, multiplier a (stats_kernel) and the BN bias b; 4 channels
// a thread step (C is a multiple of 64).
__global__ void bn_apply_kernel(const float* __restrict__ t, const float* __restrict__ st,
                                const float* __restrict__ mult,
                                const float* __restrict__ bias, bf16* __restrict__ out,
                                size_t total4, int C, int rows_per_tile) {
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < total4;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const size_t row = 4 * i / C;
    const int c = static_cast<int>(4 * i - row * C);
    const size_t tile = row / rows_per_tile;
    const float4 v = reinterpret_cast<const float4*>(t)[i];
    const float4 m = *reinterpret_cast<const float4*>(st + tile * 2 * C + c);
    const float4 a = *reinterpret_cast<const float4*>(mult + tile * C + c);
    const float4 b = *reinterpret_cast<const float4*>(bias + c);
    const __nv_bfloat162 lo = __floats2bfloat162_rn(fmaxf((v.x - m.x) * a.x + b.x, 0.f),
                                                    fmaxf((v.y - m.y) * a.y + b.y, 0.f));
    const __nv_bfloat162 hi = __floats2bfloat162_rn(fmaxf((v.z - m.z) * a.z + b.z, 0.f),
                                                    fmaxf((v.w - m.w) * a.w + b.w, 0.f));
    uint2 pk;
    pk.x = *reinterpret_cast<const uint32_t*>(&lo);
    pk.y = *reinterpret_cast<const uint32_t*>(&hi);
    reinterpret_cast<uint2*>(out)[i] = pk;
  }
}

// Returned when cuTensorMapEncodeTiled refuses a map: kTensorMapError + CUresult.
constexpr int kTensorMapError = 1000;

// A 3-D tensor map (d0 innermost, d1, d2) over a row-major bf16 array:
// boxes of 64 x box1 x 1, 128-byte swizzle, out-of-range elements read zero.
int encode_map(CUtensorMap* map, const void* base, int d0, int d1, int d2, int box1) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d0), static_cast<cuuint64_t>(d1),
                              static_cast<cuuint64_t>(d2)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d0) * sizeof(bf16),
                                 static_cast<cuuint64_t>(d1) * d0 * sizeof(bf16)};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(box1), 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUresult r = cuTensorMapEncodeTiled(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides, box,
      elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kTensorMapError + static_cast<int>(r);
}

// The operands of one product launch.
struct WArgs {
  const bf16* a_conv;
  float* t_out;
  float* part;
  const float *st, *mult, *bias;
  int tiles, rows_per_tile, K, N, h, w;
};

// The tensor maps of a launch: A (plain), B, and the residual's x and y.
struct WMaps {
  const CUtensorMap *a, *b, *x, *y;
};

template <int SRC, int BN, int EPI>
int launch_product(const WMaps& m, const WArgs& g, cudaStream_t stream) {
  const size_t smem = w_smem_bytes<BN, EPI>(w_stages<BN, EPI>(g.K));
  cudaError_t err = cudaFuncSetAttribute(
      bottleneck_wgmma_kernel<SRC, BN, EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(w_smem_bytes<BN, EPI>(w_max_stages<BN, EPI>())));
  if (err != cudaSuccess) return err;
  // Persistent: as many blocks as fit on the card at once, or one per item.
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) {
    return err;
  }
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, bottleneck_wgmma_kernel<SRC, BN, EPI>, w_threads<SRC, BN>(), smem);
  if (err != cudaSuccess) return err;
  const long items = static_cast<long>((g.rows_per_tile + kWM - 1) / kWM) * (g.N / BN) * g.tiles;
  const long fit = static_cast<long>(per_sm > 0 ? per_sm : 1) * sms;
  const int grid = static_cast<int>(items < fit ? items : fit);
  bottleneck_wgmma_kernel<SRC, BN, EPI><<<grid, w_threads<SRC, BN>(), smem, stream>>>(
      *m.a, *m.b, *m.x, *m.y, g.a_conv, g.t_out, g.part, g.st, g.mult, g.bias, g.tiles,
      g.rows_per_tile, g.K, g.N, g.h, g.w);
  return cudaGetLastError();
}

// The output-tile width of a product with N channels over K: 64 while K
// is thin (under 256: one to three k-tiles, so the block's load and
// epilogue latencies, not its products, set its time, and small blocks,
// three a SM where A is plain, hide them), else the widest of 256, 128 and
// 64 that divides N.
int pick_bn(int n, int k) {
  if (k < 256) return 64;
  return n % 256 == 0 ? 256 : (n % 128 == 0 ? 128 : 64);
}

template <int SRC, int EPI>
int launch_product_any(const WMaps& m, const WArgs& g, cudaStream_t stream) {
  switch (pick_bn(g.N, g.K)) {
    case 256: return launch_product<SRC, 256, EPI>(m, g, stream);
    case 128: return launch_product<SRC, 128, EPI>(m, g, stream);
    default: return launch_product<SRC, 64, EPI>(m, g, stream);
  }
}

int launch_apply(const float* t, const float* st, const float* mult, const float* bias,
                 bf16* out, size_t rows, int C, int rows_per_tile, cudaStream_t stream) {
  const size_t total4 = rows * C / 4;
  size_t grid = (total4 + 255) / 256;
  if (grid > 132 * 32) grid = 132 * 32;
  bn_apply_kernel<<<static_cast<unsigned>(grid), 256, 0, stream>>>(t, st, mult, bias, out,
                                                                  total4, C, rows_per_tile);
  return cudaGetLastError();
}

int run_wgmma(const bf16* x, const bf16* w1, const bf16* w2, const bf16* w3,
              const float* s1, const float* b1, const float* s2, const float* b2,
              const float* s3, const float* b3, bf16* y, float* st1, float* st2, float* st3,
              float* t, bf16* n, float* part, float* mult, int batch, int h, int w, int cw,
              int cn, int tile_b, cudaStream_t stream) {
  const int tiles = batch / tile_b;
  const int rpt = tile_b * h * w;
  const int blocks = (rpt + kWM - 1) / kWM;
  const size_t rows = static_cast<size_t>(batch) * h * w;
  CUtensorMap m_x, m_y, m_n, m_w1, m_w2, m_w3;
  int err = encode_map(&m_x, x, cw, rpt, tiles, kWM);
  if (err == 0) err = encode_map(&m_y, y, cw, rpt, tiles, kWM);
  if (err == 0) err = encode_map(&m_n, n, cn, rpt, tiles, kWM);
  if (err == 0) err = encode_map(&m_w1, w1, cn, cw, 1, kWK);
  if (err == 0) err = encode_map(&m_w2, w2, cn, 9 * cn, 1, kWK);
  if (err == 0) err = encode_map(&m_w3, w3, cw, cn, 1, kWK);
  if (err != 0) return err;
  WArgs g{nullptr, t, part, nullptr, nullptr, nullptr, tiles, rpt, cw, cn, h, w};
  // Maps a launch does not read are passed as any valid map.
  // A, B: t1 = x . w1, st1, n1.
  if ((err = launch_product_any<kPlainA, kStoreSums>({&m_x, &m_w1, &m_x, &m_x}, g, stream))) {
    return err;
  }
  if ((err = launch_stats(part, s1, tiles, blocks, cn, rpt, st1, mult, stream))) return err;
  if ((err = launch_apply(t, st1, mult, b1, n, rows, cn, rpt, stream))) return err;
  // C, D: t2 = conv3x3(n1), st2, n2 (over n1).
  g.a_conv = n;
  g.K = 9 * cn;
  if ((err = launch_product_any<kConvA, kStoreSums>({&m_w2, &m_w2, &m_x, &m_x}, g, stream))) {
    return err;
  }
  if ((err = launch_stats(part, s2, tiles, blocks, cn, rpt, st2, mult, stream))) return err;
  if ((err = launch_apply(t, st2, mult, b2, n, rows, cn, rpt, stream))) return err;
  // E, F: the moments of t3 = n2 . w3.
  g.a_conv = nullptr;
  g.t_out = nullptr;
  g.K = cn;
  g.N = cw;
  if ((err = launch_product_any<kPlainA, kSumsOnly>({&m_n, &m_w3, &m_x, &m_x}, g, stream))) {
    return err;
  }
  if ((err = launch_stats(part, s3, tiles, blocks, cw, rpt, st3, mult, stream))) return err;
  // G: t3 again, and y.
  g.part = nullptr;
  g.st = st3;
  g.mult = mult;
  g.bias = b3;
  return launch_product_any<kPlainA, kResidual>({&m_n, &m_w3, &m_x, &m_y}, g, stream);
}

}  // namespace

extern "C" {

// f32: the whole forward of one bottleneck block on the FMA kernels. x [B,
// H, W, Cw] (NHWC), w1 [Cw, Cn], w2 [3, 3, Cn, Cn], w3 [Cn, Cw] f32; BN
// scale/bias f32; y like x; st1, st2 [tiles, 2, Cn] and st3
// [tiles, 2, Cw] f32. Workspace (f32): t1, t2 [B*H*W, Cn], t3 [B*H*W, Cw],
// part [tiles * blocks * 2 * max(Cn, Cw)] with blocks = ceil(tile_b*H*W /
// 64), mult [tiles * max(Cn, Cw)]. Returns the first launch error (0 on
// success); nothing is synchronised.
int tfo_fused_bottleneck_fwd(const void* x, const void* w1, const void* w2,
                             const void* w3, const float* s1, const float* b1,
                             const float* s2, const float* b2, const float* s3,
                             const float* b3, void* y, float* st1, float* st2,
                             float* st3, float* t1, float* t2, float* t3,
                             float* part, float* mult, int batch, int h, int w,
                             int cw, int cn, int tile_b, void* stream) {
  if (tile_b < 1 || batch % tile_b != 0 || batch / tile_b > 65535) {
    return cudaErrorInvalidValue;
  }
  return run(x, w1, w2, w3, s1, b1, s2, b2, s3, b3, y, st1, st2, st3, t1, t2, t3, part, mult,
             batch, h, w, cw, cn, tile_b, static_cast<cudaStream_t>(stream));
}

// bf16: the same forward on the wgmma kernels. x [B, H, W, Cw] bf16; the
// weights bf16 in the f32 entry point's layouts (w2 as [9 Cn, Cn], tap-major
// rows); Cn and Cw multiples of 64. Workspace: t [B*H*W, Cn] f32, n
// [B*H*W, Cn] bf16, part [tiles * blocks * 2 * max(Cn, Cw)] with blocks =
// ceil(tile_b*H*W / 128), mult [tiles * max(Cn, Cw)] f32. Returns the first
// launch error, or kTensorMapError + the CUresult of a refused
// cuTensorMapEncodeTiled.
int tfo_fused_bottleneck_fwd_wgmma(const void* x, const void* w1, const void* w2,
                                   const void* w3, const float* s1, const float* b1,
                                   const float* s2, const float* b2, const float* s3,
                                   const float* b3, void* y, float* st1, float* st2,
                                   float* st3, float* t, void* n, float* part,
                                   float* mult, int batch, int h, int w, int cw, int cn,
                                   int tile_b, void* stream) {
  if (tile_b < 1 || batch % tile_b != 0 || batch / tile_b > 65535 || cw % 64 != 0 ||
      cn % 64 != 0 || cn < 64 || h < 1 || w < 1 || h >= 32768 || w >= 32768) {
    return cudaErrorInvalidValue;
  }
  return run_wgmma(static_cast<const bf16*>(x), static_cast<const bf16*>(w1),
                   static_cast<const bf16*>(w2), static_cast<const bf16*>(w3), s1, b1, s2,
                   b2, s3, b3, static_cast<bf16*>(y), st1, st2, st3, t, static_cast<bf16*>(n),
                   part, mult, batch, h, w, cw, cn, tile_b, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
