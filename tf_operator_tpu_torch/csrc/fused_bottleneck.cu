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
// every row of the tile before it can normalise any. So the kernel runs as
// seven launches on the caller's stream, each over all tiles at once:
//   A  gemm<x>         t1 = x . w1 per 64-row block, with per-block column
//                      sums of t1 and t1^2 (f32) into `part`;
//   B  stats           per (tile, channel) the partials summed in a fixed
//                      order (no float atomics: reruns agree bit for bit),
//                      giving st1 and the BN multiplier a;
//   C  gemm<conv3x3>   t2 = conv(n1, w2) as an implicit GEMM over K = 9*Cn,
//                      n1 made from t1 while the A tile is loaded
//                      (normalise, relu, round to T; out-of-image taps 0);
//   D  stats           st2, a2;
//   E  gemm<1x1 norm>  t3 = n2 . w3, n2 made from t2 on load;
//   F  stats           st3, a3;
//   G  residual        y = relu((t3 - m3) * a3 + b3 + x), rounded to T.
// t1, t2, t3 live in an f32 workspace the wrapper allocates.
//
// What bounds it on the H100: at stage 1 (batch 256, 56x56, Cw 256, Cn 64)
// the block is 111.8 GFLOP against 822 MB of x and y, so the bound is bytes
// (0.245 ms at 3.35 TB/s); at stage 4 (7x7, Cw 2048, Cn 512) the same FLOPs
// against 112 MB, so operations (0.113 ms at 989 TF/s bf16). This first
// version multiplies with f32 FMA on the CUDA cores (64x64 output tiles, 4x4
// per thread, 16-deep shared-memory stages), so its ceiling is the 67 TF/s
// FMA rate, and it writes and rereads the f32 intermediates (~1.2 GB at
// stage 1), which costs more than the 822 MB the bound counts. Moving the
// products to wgmma, and keeping n1/n2 in shared memory across a tile's
// rows, is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;  // rows per block (ROWS_PER_BLOCK in the wrapper)
constexpr int kBN = 64;  // output channels per block
constexpr int kBK = 16;  // depth of one shared-memory stage
constexpr int kThreads = 256;
constexpr int kAStride = kBM + 4;  // keeps float4 reads 16-byte aligned
constexpr float kEps = 1e-5f;

template <typename T>
__device__ __forceinline__ float to_f(T x);
template <>
__device__ __forceinline__ float to_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Where the A operand of a product comes from.
enum ASource {
  kInputX = 0,   // x itself, in T
  kNorm1x1 = 1,  // the previous product (f32), normalised on load
  kNormConv = 2, // the same, read through the 3x3 window
};

// relu((t - m) * a + b) rounded to T and back: n1 / n2 as the TPU kernel
// feeds them to the next product.
template <typename T>
__device__ __forceinline__ float bn_relu_round(float t, float m, float a, float b) {
  return to_f(from_f<T>(fmaxf((t - m) * a + b, 0.f)));
}

// C = A . B over the rows of one tile, 64 rows x 64 channels per block:
// grid (row blocks of a tile, ceil(N / 64), tiles). A is [rows, Ka] row-major
// (K = Ka, or 9 * Ka through the 3x3 window, tap-major as HWIO weights are),
// B is [K, N] in T, C is [rows, N] f32. The block's column sums of C and C^2
// go to part[tile][block][0|1][N].
template <typename T, int SRC>
__global__ void __launch_bounds__(kThreads)
gemm_kernel(const void* __restrict__ a_src, const float* __restrict__ a_st,
            const float* __restrict__ a_mult, const float* __restrict__ a_bias,
            const T* __restrict__ bmat, float* __restrict__ c,
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
      const T* a = static_cast<const T*>(a_src);
#pragma unroll
      for (int l = 0; l < 4; ++l) {
        float v = 0.f;
        if (a_in[l] && k < K) {
          v = to_f(a[(tile_row0 + r0 + a_r + 16 * l) * static_cast<size_t>(Ka) + k]);
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
          v = bn_relu_round<T>(t, m, am, bb);
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
          v = bn_relu_round<T>(a[src * Ka + ch], m, am, bb);
        }
        As[a_k][a_r + 16 * l] = v;
      }
    }
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      const int kb = k0 + b_k + 4 * l;
      float v = 0.f;
      if (kb < K && n0 + b_n < N) v = to_f(bmat[static_cast<size_t>(kb) * N + n0 + b_n]);
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

// y = relu((t3 - m3) * a3 + b3 + x), rounded to T.
template <typename T>
__global__ void residual_kernel(const float* __restrict__ t3,
                                const float* __restrict__ st3,
                                const float* __restrict__ mult3,
                                const float* __restrict__ b3,
                                const T* __restrict__ x, T* __restrict__ y,
                                size_t total, int C, int rows_per_tile) {
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       i < total; i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const size_t row = i / C;
    const int ch = static_cast<int>(i - row * C);
    const size_t tile = row / rows_per_tile;
    const float m = st3[tile * 2 * C + ch];
    const float z = (t3[i] - m) * mult3[tile * C + ch] + b3[ch];
    y[i] = from_f<T>(fmaxf(z + to_f(x[i]), 0.f));
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

template <typename T>
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
  gemm_kernel<T, kInputX><<<dim3(blocks, (cn + kBN - 1) / kBN, tiles), block, 0, stream>>>(
      x, nullptr, nullptr, nullptr, static_cast<const T*>(w1), t1, part,
      rows_per_tile, cw, cn, cw, h, w);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = launch_stats(part, s1, tiles, blocks, cn, rows_per_tile, st1, mult, stream)) != cudaSuccess) return err;
  // C, D: t2 = conv3x3(n1) and its moments.
  gemm_kernel<T, kNormConv><<<dim3(blocks, (cn + kBN - 1) / kBN, tiles), block, 0, stream>>>(
      t1, st1, mult, b1, static_cast<const T*>(w2), t2, part, rows_per_tile,
      9 * cn, cn, cn, h, w);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = launch_stats(part, s2, tiles, blocks, cn, rows_per_tile, st2, mult, stream)) != cudaSuccess) return err;
  // E, F: t3 = n2 . w3 and its moments.
  gemm_kernel<T, kNorm1x1><<<dim3(blocks, (cw + kBN - 1) / kBN, tiles), block, 0, stream>>>(
      t2, st2, mult, b2, static_cast<const T*>(w3), t3, part, rows_per_tile,
      cn, cw, cn, h, w);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = launch_stats(part, s3, tiles, blocks, cw, rows_per_tile, st3, mult, stream)) != cudaSuccess) return err;
  // G: the residual epilogue.
  const size_t total = static_cast<size_t>(batch) * h * w * cw;
  size_t grid = (total + 255) / 256;
  if (grid > 132 * 32) grid = 132 * 32;
  residual_kernel<T><<<static_cast<unsigned>(grid), 256, 0, stream>>>(
      t3, st3, mult, b3, static_cast<const T*>(x), static_cast<T*>(y), total, cw,
      rows_per_tile);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The whole forward of one bottleneck block: x [B, H, W, Cw] (NHWC), w1
// [Cw, Cn], w2 [3, 3, Cn, Cn], w3 [Cn, Cw] in the element type (dtype 0 =
// f32, 1 = bf16); BN scale/bias f32; y like x; st1, st2 [tiles, 2, Cn] and
// st3 [tiles, 2, Cw] f32. Workspace (f32): t1, t2 [B*H*W, Cn], t3
// [B*H*W, Cw], part [tiles * blocks * 2 * max(Cn, Cw)] with blocks =
// ceil(tile_b*H*W / 64), mult [tiles * max(Cn, Cw)]. Returns the first
// launch error (0 on success); nothing is synchronised.
int tfo_fused_bottleneck_fwd(const void* x, const void* w1, const void* w2,
                             const void* w3, const float* s1, const float* b1,
                             const float* s2, const float* b2, const float* s3,
                             const float* b3, void* y, float* st1, float* st2,
                             float* st3, float* t1, float* t2, float* t3,
                             float* part, float* mult, int batch, int h, int w,
                             int cw, int cn, int tile_b, int dtype,
                             void* stream) {
  if (tile_b < 1 || batch % tile_b != 0 || batch / tile_b > 65535) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return run<float>(x, w1, w2, w3, s1, b1, s2, b2, s3, b3, y, st1, st2, st3,
                      t1, t2, t3, part, mult, batch, h, w, cw, cn, tile_b, s);
  }
  if (dtype == 1) {
    return run<__nv_bfloat16>(x, w1, w2, w3, s1, b1, s2, b2, s3, b3, y, st1, st2,
                              st3, t1, t2, t3, part, mult, batch, h, w, cw, cn,
                              tile_b, s);
  }
  return cudaErrorInvalidValue;
}

}  // extern "C"
