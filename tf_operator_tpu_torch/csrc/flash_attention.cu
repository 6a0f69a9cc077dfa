// Flash attention for Hopper (sm_90a): forward, dQ and dK/dV kernels.
//
// Built by tf_operator_tpu_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// into a shared library with the plain C interface at the bottom of this
// file, loaded with ctypes by tf_operator_tpu_torch/ops/flash_attention.py.
//
// Operands are [BH, T, D] row-major (batch*heads flattened), D in {64, 128,
// 256, 384, 512}, element type f32 or bf16; lse, the lse cotangent and delta
// are [BH, T] f32. Other head widths up to 512 reach these kernels zero-padded
// by the wrapper (ops/flash_attention.py): zero columns leave Q.K^T, lse and
// delta as they are, and come out of o, dQ, dK and dV as zeros, so long as
// the softmax scale is that of the unpadded width, which every entry point
// takes from the caller.
// Every sum, the softmax statistics and the accumulators are f32. Rounding
// follows the TPU kernels exactly: P is rounded to the input type before
// P.V, dS before dS.K and dS^T.Q; dV = P^T.dO takes the unrounded P (dO
// upcast). The backward kernels read delta = rowsum(dO o O) - g_lse from a
// pre-pass (bwd_delta_kernel), launched once for both.
//
// The bf16 kernels at D = 64 and 128 (fwd_wgmma_kernel, bwd_dq_wgmma_kernel
// and bwd_dkv_wgmma_kernel, after the FMA kernels) and at D = 256
// (fwd_wide_wgmma_kernel, bwd_dq_wide_wgmma_kernel and
// bwd_dkv_wide_wgmma_kernel) run their products on the tensor cores with
// wgmma, fed by TMA through shared-memory rings; see the notes above them.
// The FMA kernels (fwd_kernel, bwd_dq_kernel and bwd_dkv_kernel), the
// first versions, described below, run f32 at every width and bf16 at
// D = 384 and 512; the C interface at the end picks the kernel of each
// call from its dtype and width.
//
// Tiles are R x R (R = 64; 32 at D = 256, 16 at D = 384 and 512, see
// fma_rows) and a block has 256
// threads. Thread (ty, tx) = (tid / 16, tid % 16) owns tile rows ty + 16*i
// (i < R / 16) and columns tx + 16*j, so row reductions are shuffles within
// a 16-lane half warp. Shared-memory rows are
// padded by one 4-byte bank so the column-strided reads hit 16 distinct
// banks. Rows past the end of a sequence load as zero, never as garbage
// (0 * NaN = NaN would poison an accumulator), and are masked by position.
//
// What bounds these kernels on the H100: at the trainer's shape (T = 8192,
// D = 128, causal, bf16) each is compute-bound; the HBM traffic (~0.2 GB a
// call at batch 4) is an order of magnitude below the 989 TF/s tensor-core
// bound. The f32 versions multiply with f32 FMA on the CUDA cores, so
// their ceiling is the 67 TF/s FMA rate, and their inner loops issue one
// shared-memory load for every two FMAs. They keep the Q (or K/V) tile
// resident and stream the other operand's tiles through shared memory, so
// HBM traffic stays O(T*D) per tile row.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr float kNegInf = -1e30f;  // fully-masked sentinel (NEG_INF)
constexpr int kTile = 64;          // rows per q-tile and per k-tile (see fma_rows)
constexpr int kThreads = 256;

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

// Row stride (elements) of a shared tile with `cols` columns: one extra
// 4-byte bank per row.
template <typename T>
__host__ __device__ constexpr int padded(int cols) {
  return cols + 4 / static_cast<int>(sizeof(T));
}

// Copy rows [row0, row0 + R) of a [n_rows, D] matrix into shared memory
// with 16-byte global loads; rows at or past n_rows become zero.
template <typename T, int D, int R>
__device__ __forceinline__ void load_tile(T* dst, const T* __restrict__ src,
                                          int row0, int n_rows) {
  constexpr int LD = padded<T>(D);
  constexpr int VEC = 16 / sizeof(T);
  constexpr int PER_ROW = D / VEC;
  for (int idx = threadIdx.x; idx < R * PER_ROW; idx += kThreads) {
    const int r = idx / PER_ROW;
    const int c = (idx % PER_ROW) * VEC;
    const int gr = row0 + r;
    uint4 u = make_uint4(0u, 0u, 0u, 0u);
    if (gr < n_rows) {
      u = *reinterpret_cast<const uint4*>(src + static_cast<size_t>(gr) * D + c);
    }
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int x = 0; x < VEC; ++x) dst[r * LD + c + x] = e[x];
  }
}

// Sum over the 16 lanes that share a tile row (lanes differing in bits 0-3).
__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// lse and delta of the rows of one q-tile into shared memory; rows past tq
// get 0 (their products are masked anyway).
template <int R>
__device__ __forceinline__ void row_stats(const float* __restrict__ lseb,
                                          const float* __restrict__ deltab,
                                          int q0, int tq, float* lse_s,
                                          float* delta_s) {
  for (int r = threadIdx.x; r < R; r += kThreads) {
    const int qp = q0 + r;
    lse_s[r] = qp < tq ? lseb[qp] : 0.f;
    delta_s[r] = qp < tq ? deltab[qp] : 0.f;
  }
}

// ---------------------------------------------------------------------------
// delta pre-pass: delta[row] = rowsum(dO o O)[row] - g_lse[row] in f32, one
// warp per row with 16-byte loads. A helper of K2/K3, not the port of a TPU
// kernel: the Pallas kernels compute delta in-block from O (and K3 did so
// for every (k-tile, q-tile) pair); here it is read once, by one launch.
// Bound: bytes (O and dO read once).
// ---------------------------------------------------------------------------
constexpr int kDeltaRows = 8;  // rows (warps) per block

template <typename T, int D>
__global__ void __launch_bounds__(32 * kDeltaRows)
bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                 const float* __restrict__ glse, float* __restrict__ delta,
                 int rows) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CHUNKS = D / VEC;
  const int row = blockIdx.x * kDeltaRows + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // whole warps leave together
  float sum = 0.f;
  for (int c = lane; c < CHUNKS; c += 32) {
    const size_t off = static_cast<size_t>(row) * D + c * VEC;
    const uint4 a = *reinterpret_cast<const uint4*>(o + off);
    const uint4 b = *reinterpret_cast<const uint4*>(dout + off);
    const T* ea = reinterpret_cast<const T*>(&a);
    const T* eb = reinterpret_cast<const T*>(&b);
#pragma unroll
    for (int x = 0; x < VEC; ++x) sum += to_f(eb[x]) * to_f(ea[x]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (lane == 0) delta[row] = sum - (glse != nullptr ? glse[row] : 0.f);
}

// ---------------------------------------------------------------------------
// K1: forward, the f32 version. Replaces ops/flash_attention.py::_fwd_kernel
// (launched by _flash_fwd). One block per (bh, q-tile) walks the k-tiles
// itself, where the TPU kernel walked a sequential grid axis and carried
// (m, l, acc) in VMEM scratch between grid steps: here (m, l, acc) live in
// registers for the whole walk. Causal: k-tiles wholly above the diagonal
// (k0 > q0 + R - 1) are never visited. Bound: compute (2 units of
// B*H*T^2*D FLOP causal); see the file header.
// ---------------------------------------------------------------------------
template <typename T, int D, int R>
__global__ void __launch_bounds__(kThreads)
fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
           int tq, int tk, int causal, float scale) {
  constexpr int LD = padded<T>(D);
  constexpr int LDP = padded<T>(R);
  constexpr int CJ = D / 16;
  constexpr int RI = R / 16;  // tile rows (and k columns) a thread owns
  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* ks = qs + R * LD;
  T* vs = ks + R * LD;
  T* ps = vs + R * LD;  // [R][LDP]: P rounded to T

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * R;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const T* qb = q + static_cast<size_t>(bh) * tq * D;
  const T* kb = k + static_cast<size_t>(bh) * tk * D;
  const T* vb = v + static_cast<size_t>(bh) * tk * D;

  load_tile<T, D, R>(qs, qb, q0, tq);

  float acc[RI][CJ];
  float m[RI], l[RI];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < CJ; ++j) acc[i][j] = 0.f;
  }

  int n_kt = (tk + R - 1) / R;
  if (causal) n_kt = min(n_kt, (q0 + R - 1) / R + 1);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * R;
    __syncthreads();  // the previous step is done with ks, vs and ps
    load_tile<T, D, R>(ks, kb, k0, tk);
    load_tile<T, D, R>(vs, vb, k0, tk);
    __syncthreads();

    float s[RI][RI];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < RI; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[RI], b[RI];
#pragma unroll
      for (int i = 0; i < RI; ++i) a[i] = to_f(qs[(ty + 16 * i) * LD + d]);
#pragma unroll
      for (int j = 0; j < RI; ++j) b[j] = to_f(ks[(tx + 16 * j) * LD + d]);
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < RI; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int qp = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < RI; ++j) {
        const int kp = k0 + tx + 16 * j;
        const bool ok = kp < tk && (!causal || qp >= kp);
        s[i][j] = ok ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < RI; ++j) {
        // A fully-masked row keeps m == NEG_INF: its p is 0, not exp(0).
        const float p = m_new == kNegInf ? 0.f : expf(s[i][j] - m_new);
        rs += p;
        ps[(ty + 16 * i) * LDP + tx + 16 * j] = from_f<T>(p);
      }
      rs = half_warp_sum(rs);
      const float alpha = m[i] == kNegInf ? 0.f : expf(m[i] - m_new);
      l[i] = alpha * l[i] + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < CJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 8
    for (int c = 0; c < R; ++c) {
      float a[RI], b[CJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) a[i] = to_f(ps[(ty + 16 * i) * LDP + c]);
#pragma unroll
      for (int j = 0; j < CJ; ++j) b[j] = to_f(vs[c * LD + tx + 16 * j]);
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int qp = q0 + ty + 16 * i;
    if (qp >= tq) continue;
    const size_t row = static_cast<size_t>(bh) * tq + qp;
    if (lse != nullptr && tx == 0) {
      lse[row] = l[i] == 0.f ? kNegInf : m[i] + logf(l[i]);
    }
    const float denom = l[i] == 0.f ? 1.f : l[i];  // empty row -> o = 0
#pragma unroll
    for (int j = 0; j < CJ; ++j) o[row * D + tx + 16 * j] = from_f<T>(acc[i][j] / denom);
  }
}

// ---------------------------------------------------------------------------
// K2: dQ, the f32 version. Replaces ops/flash_attention.py::_bwd_dq_kernel
// (launched in _flash_bwd). One block per (bh, q-tile) walks the k-tiles:
//   dQ_i = scale * sum_j [P_ij o (dO_i V_j^T - delta_i)] K_j,
// P rebuilt from lse, delta from the pre-pass. dQ accumulates in registers;
// causal skip as in K1. Bound: compute (3 units: S, dP and dS.K).
// ---------------------------------------------------------------------------
template <typename T, int D, int R>
__global__ void __launch_bounds__(kThreads)
bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              T* __restrict__ dq, int tq, int tk, int causal, float scale) {
  constexpr int LD = padded<T>(D);
  constexpr int LDP = padded<T>(R);
  constexpr int CJ = D / 16;
  constexpr int RI = R / 16;  // tile rows (and k columns) a thread owns
  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* dos = qs + R * LD;
  T* ks = dos + R * LD;
  T* vs = ks + R * LD;
  T* dss = vs + R * LD;  // [R][LDP]: dS rounded to T
  float* lse_s = reinterpret_cast<float*>(dss + R * LDP);
  float* delta_s = lse_s + R;

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * R;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const size_t qoff = static_cast<size_t>(bh) * tq;
  const T* kb = k + static_cast<size_t>(bh) * tk * D;
  const T* vb = v + static_cast<size_t>(bh) * tk * D;

  load_tile<T, D, R>(qs, q + qoff * D, q0, tq);
  load_tile<T, D, R>(dos, dout + qoff * D, q0, tq);
  row_stats<R>(lse + qoff, delta + qoff, q0, tq, lse_s, delta_s);

  float acc[RI][CJ];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < CJ; ++j) acc[i][j] = 0.f;

  int n_kt = (tk + R - 1) / R;
  if (causal) n_kt = min(n_kt, (q0 + R - 1) / R + 1);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * R;
    __syncthreads();
    load_tile<T, D, R>(ks, kb, k0, tk);
    load_tile<T, D, R>(vs, vb, k0, tk);
    __syncthreads();

    float s[RI][RI], dp[RI][RI];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < RI; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[RI], g[RI], b[RI], w[RI];
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        a[i] = to_f(qs[(ty + 16 * i) * LD + d]);
        g[i] = to_f(dos[(ty + 16 * i) * LD + d]);
      }
#pragma unroll
      for (int j = 0; j < RI; ++j) {
        b[j] = to_f(ks[(tx + 16 * j) * LD + d]);
        w[j] = to_f(vs[(tx + 16 * j) * LD + d]);
      }
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < RI; ++j) {
          s[i][j] = fmaf(a[i], b[j], s[i][j]);
          dp[i][j] = fmaf(g[i], w[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int r = ty + 16 * i;
      const int qp = q0 + r;
      const float L = lse_s[r];
      const float delta = delta_s[r];
#pragma unroll
      for (int j = 0; j < RI; ++j) {
        const int kp = k0 + tx + 16 * j;
        const bool ok = qp < tq && kp < tk && (!causal || qp >= kp) && L > kNegInf;
        const float p = ok ? expf(s[i][j] * scale - L) : 0.f;
        dss[r * LDP + tx + 16 * j] = from_f<T>(p * (dp[i][j] - delta) * scale);
      }
    }
    __syncthreads();

#pragma unroll 8
    for (int c = 0; c < R; ++c) {
      float a[RI], b[CJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) a[i] = to_f(dss[(ty + 16 * i) * LDP + c]);
#pragma unroll
      for (int j = 0; j < CJ; ++j) b[j] = to_f(ks[c * LD + tx + 16 * j]);
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int qp = q0 + ty + 16 * i;
    if (qp >= tq) continue;
#pragma unroll
    for (int j = 0; j < CJ; ++j) {
      dq[(qoff + qp) * D + tx + 16 * j] = from_f<T>(acc[i][j]);
    }
  }
}

// ---------------------------------------------------------------------------
// K3: dK/dV, the f32 version. Replaces ops/flash_attention.py::_bwd_dkv_kernel
// (launched in _flash_bwd). One block per (bh, k-tile) walks the q-tiles, so each dK/dV
// row has one writer and no atomics are needed:
//   dV_j = sum_i P_ij^T dO_i,   dK_j = scale * sum_i dS_ij^T Q_i.
// Causal: q-tiles wholly before the k-tile (q0 + R - 1 < k0) are never
// visited. Padded q rows and rows with lse == NEG_INF give P = 0. Bound:
// compute (4 units: S^T, dP^T, P^T.dO and dS^T.Q).
// ---------------------------------------------------------------------------
template <typename T, int D, int R>
__global__ void __launch_bounds__(kThreads)
bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               T* __restrict__ dk, T* __restrict__ dv, int tq, int tk,
               int causal, float scale) {
  constexpr int LD = padded<T>(D);
  constexpr int LDP = padded<T>(R);
  constexpr int LDF = padded<float>(R);
  constexpr int CJ = D / 16;
  constexpr int RI = R / 16;  // tile rows (and k columns) a thread owns
  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);
  T* vs = ks + R * LD;
  T* qs = vs + R * LD;
  T* dos = qs + R * LD;
  T* dsts = dos + R * LD;  // [R][LDP]: dS^T rounded to T
  float* pts = reinterpret_cast<float*>(dsts + R * LDP);  // P^T, f32
  float* lse_s = pts + R * LDF;
  float* delta_s = lse_s + R;

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * R;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const size_t qoff = static_cast<size_t>(bh) * tq;
  const size_t koff = static_cast<size_t>(bh) * tk;

  load_tile<T, D, R>(ks, k + koff * D, k0, tk);
  load_tile<T, D, R>(vs, v + koff * D, k0, tk);

  float acc_k[RI][CJ], acc_v[RI][CJ];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < CJ; ++j) acc_k[i][j] = acc_v[i][j] = 0.f;

  const int n_qt = (tq + R - 1) / R;
  const int qt0 = causal ? k0 / R : 0;
  for (int qt = qt0; qt < n_qt; ++qt) {
    const int q0 = qt * R;
    __syncthreads();
    load_tile<T, D, R>(qs, q + qoff * D, q0, tq);
    load_tile<T, D, R>(dos, dout + qoff * D, q0, tq);
    row_stats<R>(lse + qoff, delta + qoff, q0, tq, lse_s, delta_s);
    __syncthreads();

    // Thread (ty, tx) holds k rows ty + 16*i and q columns tx + 16*j.
    float st[RI][RI], dpt[RI][RI];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < RI; ++j) st[i][j] = dpt[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[RI], w[RI], b[RI], g[RI];
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        a[i] = to_f(ks[(ty + 16 * i) * LD + d]);
        w[i] = to_f(vs[(ty + 16 * i) * LD + d]);
      }
#pragma unroll
      for (int j = 0; j < RI; ++j) {
        b[j] = to_f(qs[(tx + 16 * j) * LD + d]);
        g[j] = to_f(dos[(tx + 16 * j) * LD + d]);
      }
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < RI; ++j) {
          st[i][j] = fmaf(a[i], b[j], st[i][j]);
          dpt[i][j] = fmaf(w[i], g[j], dpt[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int r = ty + 16 * i;
      const int kp = k0 + r;
#pragma unroll
      for (int j = 0; j < RI; ++j) {
        const int c = tx + 16 * j;
        const int qp = q0 + c;
        const float L = lse_s[c];
        const bool ok = qp < tq && kp < tk && (!causal || qp >= kp) && L > kNegInf;
        const float p = ok ? expf(st[i][j] * scale - L) : 0.f;
        pts[r * LDF + c] = p;
        dsts[r * LDP + c] = from_f<T>(p * (dpt[i][j] - delta_s[c]) * scale);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < R; ++c) {
      float pa[RI], sa[RI], gb[CJ], qb[CJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        pa[i] = pts[(ty + 16 * i) * LDF + c];
        sa[i] = to_f(dsts[(ty + 16 * i) * LDP + c]);
      }
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        gb[j] = to_f(dos[c * LD + tx + 16 * j]);
        qb[j] = to_f(qs[c * LD + tx + 16 * j]);
      }
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) {
          acc_v[i][j] = fmaf(pa[i], gb[j], acc_v[i][j]);
          acc_k[i][j] = fmaf(sa[i], qb[j], acc_k[i][j]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int kp = k0 + ty + 16 * i;
    if (kp >= tk) continue;
#pragma unroll
    for (int j = 0; j < CJ; ++j) {
      const size_t idx = (koff + kp) * D + tx + 16 * j;
      dk[idx] = from_f<T>(acc_k[i][j]);
      dv[idx] = from_f<T>(acc_v[i][j]);
    }
  }
}

// ---------------------------------------------------------------------------
// K2 and K3 in bf16, on the tensor cores.
//
// Bound: at the trainer's shape both are compute-bound (S, dP and one
// gradient product for K2; S^T, dP^T, dV and dK for K3), so every product is
// a wgmma with f32 accumulation. dP = dO.V^T from bf16 operands is exact in
// f32 as the TPU kernel's upcast product is. dV takes the unrounded f32 P as
// the TPU kernel does: P = P_hi + P_lo with P_hi = bf16(P) and P_lo =
// bf16(P - P_hi), two register-A products (relative error ~2^-16), so K3
// does 5 product units against its 4-unit bound.
//
// Shape of both kernels: a block of three warpgroups, 2 consumers that each
// own 64 rows of the block's 128 resident rows, and 1 producer whose first
// warp issues every TMA load. The resident rows (K and V for K3, Q and dO
// for K2) load once; the streamed operand's 64-row tiles pass through a ring
// of kStages shared-memory stages, each guarded by a "full" mbarrier (TMA
// bytes landed) and an "empty" one (all 8 consumer warps done with it).
// setmaxnreg moves registers from the producer (24) to the consumers (240):
// K3 holds dK and dV (64 x D f32 each) plus S^T and dP^T in registers.
// Tensor maps are 3-D (D, T, BH) with 64 x 64 boxes: a ragged tail zero-fills
// inside its own head, and every row past T is also masked by position.
// Products read shared memory in place: S = Q.K^T and dP = dO.V^T take both
// operands K-major; the gradient products take A from registers (the f32
// accumulator fragment converted to bf16 pairs, which is already the A
// fragment layout) and B MN-major through the descriptor's transpose bit,
// so no tile is copied or transposed. Each output row has one writer (no
// atomics), so reruns are bit-identical. Causal: tiles wholly masked are
// never visited, and the heaviest blocks are launched first.
// ---------------------------------------------------------------------------
using bf16 = __nv_bfloat16;

constexpr int kWgThreads = 128;
constexpr int kConsumerWGs = 2;
constexpr int kWsThreads = (kConsumerWGs + 1) * kWgThreads;
constexpr int kStages = 3;
constexpr int kBlockRows = 64 * kConsumerWGs;  // resident rows per block
constexpr uint32_t kBoxBytes = 64 * 128;      // one 64-row, 64-column box
constexpr float kLog2e = 1.4426950408889634f;

// Bytes of one tile of R rows (64 unless given) and D bf16 columns (D / 64
// boxes of R rows).
template <int D, int R = 64>
__host__ __device__ constexpr uint32_t tile_bytes() { return R * D * 2; }

// Descriptor of k-step kk (16 reduction columns) of a tile read K-major, and
// of k-step kk (16 reduction rows) of a tile read MN-major; `box` is the
// bytes of one of the tile's boxes (64 columns of all its rows).
__device__ __forceinline__ uint64_t desc_k_major(const bf16* tile, int kk,
                                                 uint32_t box = kBoxBytes) {
  return hopper::desc_advance(hopper::desc_sw128(hopper::smem_u32(tile), 16, 1024),
                              (kk >> 2) * box + (kk & 3) * 32);
}
__device__ __forceinline__ uint64_t desc_mn_major(const bf16* tile, int kk,
                                                  uint32_t box = kBoxBytes) {
  return hopper::desc_advance(hopper::desc_sw128(hopper::smem_u32(tile), box, 1024),
                              kk * 2048);
}

// Rows [row0, row0 + R) of head bh into a tile, one box per 64 columns.
template <int D, int R = 64>
__device__ __forceinline__ void tma_tile(bf16* dst, const CUtensorMap* map,
                                         uint64_t* bar, int row0, int bh) {
#pragma unroll
  for (int cb = 0; cb < D / 64; ++cb) {
    hopper::tma_load_3d(dst + cb * R * 64, map, bar, cb * 64, row0, bh);
  }
}

// acc = A_tile[64 x D] . B_tile[64 x D]^T, both K-major: the [64 x 64]
// scores of one warpgroup.
template <int D>
__device__ __forceinline__ void scores(float (&acc)[32], const bf16* a, const bf16* b) {
  hopper::wgmma_ss_m64n64_zero(acc, desc_k_major(a, 0), desc_k_major(b, 0));
#pragma unroll
  for (int kk = 1; kk < D / 16; ++kk) {
    hopper::wgmma_ss_m64n64(acc, desc_k_major(a, kk), desc_k_major(b, kk));
  }
}

// acc[64 x D] += A[64 x K] . B_tile[K x D], A as K / 4 bf16 pairs in the
// fragment layout, B (K rows, 64 unless given) read MN-major: the gradient
// products, and K1's P.V.
template <int D, int K = 64>
__device__ __forceinline__ void grad_product(float (&acc)[D / 2], const uint32_t (&a)[K / 4],
                                             const bf16* b) {
#pragma unroll
  for (int k = 0; k < K / 16; ++k) {
    const uint64_t desc = desc_mn_major(b, k, K * 128);
    if constexpr (D == 64) {
      hopper::wgmma_rs_m64n64_tb(acc, a[4 * k], a[4 * k + 1], a[4 * k + 2], a[4 * k + 3],
                                 desc);
    } else {
      hopper::wgmma_rs_m64n128_tb(acc, a[4 * k], a[4 * k + 1], a[4 * k + 2], a[4 * k + 3],
                                  desc);
    }
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The rows of an accumulator fragment of N columns as bf16 into
// out[(row0 + r) * LD + c] for the warpgroup's rows r < 64 with row0 + r <
// n_rows.
template <int N, int LD = N>
__device__ __forceinline__ void store_rows(bf16* out, const float (&acc)[N / 2],
                                           int row0, int n_rows) {
  const int lane = threadIdx.x & 31;
  const int r = 16 * ((threadIdx.x % kWgThreads) / 32) + (lane >> 2);
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + r + 8 * h;
      if (row < n_rows) {
        const int i = 4 * j + 2 * h;
        *reinterpret_cast<uint32_t*>(out + static_cast<size_t>(row) * LD + 8 * j +
                                     2 * (lane & 3)) = pack_bf16(acc[i], acc[i + 1]);
      }
    }
  }
}

template <int D>
struct DkvSmem {
  alignas(1024) bf16 k[kConsumerWGs][64 * D];  // resident rows [k0, k0 + 128)
  alignas(1024) bf16 v[kConsumerWGs][64 * D];
  alignas(1024) bf16 q[kStages][64 * D];  // the ring of q-tiles
  alignas(1024) bf16 dout[kStages][64 * D];
  float lse2[kStages][64];  // lse * log2(e); +inf for a row whose P is 0
  float delta[kStages][64];
  uint64_t full[kStages], empty[kStages], kv_full;
};

template <int D>
struct DqSmem {
  alignas(1024) bf16 q[kConsumerWGs][64 * D];  // resident rows [q0, q0 + 128)
  alignas(1024) bf16 dout[kConsumerWGs][64 * D];
  alignas(1024) bf16 k[kStages][64 * D];  // the ring of k-tiles
  alignas(1024) bf16 v[kStages][64 * D];
  uint64_t full[kStages], empty[kStages], q_full;
};

__device__ __forceinline__ float pos_inf() { return __int_as_float(0x7f800000); }

// K3 (dK/dV) in bf16. Replaces ops/flash_attention.py::_bwd_dkv_kernel. One
// block per (bh, 128 k-rows) walks the q-tiles: blockIdx.x = bh, blockIdx.y
// = the k-block, so the heaviest causal blocks (small k0) launch first.
template <int D>
__global__ void __launch_bounds__(kWsThreads, 1)
bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const __grid_constant__ CUtensorMap tm_do,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     bf16* __restrict__ dk, bf16* __restrict__ dv, int tq, int tk,
                     int causal, float scale) {
  auto& sm = hopper::smem_as<DkvSmem<D>>();
  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kBlockRows;
  const int n_qt = (tq + 63) / 64;
  const int qt0 = causal ? k0 / 64 : 0;  // q-tiles wholly before k0 are all masked
  const int wg = hopper::warpgroup();
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&sm.full[s], 1);
      hopper::mbar_init(&sm.empty[s], kConsumerWGs * 4);
    }
    hopper::mbar_init(&sm.kv_full, 1);
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (wg == kConsumerWGs) {
    // Producer: its first warp fills the ring; lane 0 issues the TMA loads,
    // all 32 lanes stage each q-tile's lse and delta.
    hopper::regs_dealloc<24>();
    if (threadIdx.x / 32 != kConsumerWGs * 4) return;
    if (lane == 0) {
      hopper::mbar_arrive_expect_tx(&sm.kv_full, 2 * kConsumerWGs * tile_bytes<D>());
      for (int h = 0; h < kConsumerWGs; ++h) {
        tma_tile<D>(sm.k[h], &tm_k, &sm.kv_full, k0 + 64 * h, bh);
        tma_tile<D>(sm.v[h], &tm_v, &sm.kv_full, k0 + 64 * h, bh);
      }
    }
    const float* lse_b = lse + static_cast<size_t>(bh) * tq;
    const float* delta_b = delta + static_cast<size_t>(bh) * tq;
    int s = 0;
    uint32_t phase = 0;
    for (int qt = qt0; qt < n_qt; ++qt) {
      const int q0 = qt * 64;
      hopper::mbar_wait(&sm.empty[s], phase ^ 1);
      for (int r = lane; r < 64; r += 32) {
        const int qp = q0 + r;
        const float L = qp < tq ? lse_b[qp] : kNegInf;
        sm.lse2[s][r] = L > kNegInf ? L * kLog2e : pos_inf();
        sm.delta[s][r] = qp < tq ? delta_b[qp] : 0.f;
      }
      __syncwarp();
      if (lane == 0) {
        hopper::mbar_arrive_expect_tx(&sm.full[s], 2 * tile_bytes<D>());
        tma_tile<D>(sm.q[s], &tm_q, &sm.full[s], q0, bh);
        tma_tile<D>(sm.dout[s], &tm_do, &sm.full[s], q0, bh);
      }
      if (++s == kStages) {
        s = 0;
        phase ^= 1;
      }
    }
    return;
  }

  // Consumers: warpgroup wg owns k rows [k0 + 64 wg, k0 + 64 wg + 64); this
  // thread holds rows kp and kp + 8 of each fragment, q columns
  // 8 j + cq + {0, 1}.
  hopper::regs_alloc<240>();
  const int kp = k0 + 64 * wg + 16 * ((threadIdx.x % kWgThreads) / 32) + (lane >> 2);
  const int cq = 2 * (lane & 3);
  const float sl2 = scale * kLog2e;
  const bool k_tail = k0 + kBlockRows > tk;
  float acc_dk[D / 2], acc_dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc_dk[i] = acc_dv[i] = 0.f;
  hopper::mbar_wait(&sm.kv_full, 0);

  int s = 0;
  uint32_t phase = 0;
  for (int qt = qt0; qt < n_qt; ++qt) {
    const int q0 = qt * 64;
    hopper::mbar_wait(&sm.full[s], phase);

    // S^T = K Q^T and dP^T = V dO^T for this warpgroup's 64 k rows.
    float st[32], dpt[32];
    hopper::wg_fence();
    scores<D>(st, sm.k[wg], sm.q[s]);
    scores<D>(dpt, sm.v[wg], sm.dout[s]);
    hopper::wg_commit();
    hopper::wg_wait<0>();
    hopper::pin(st);
    hopper::pin(dpt);

    // P^T from lse (0 where lse2 is +inf: padded or fully-masked q rows)
    // and dS^T = P^T o (dP^T - delta) * scale, masked by position where a
    // k row may lie past tk or after a q column; each pair of columns is
    // packed as bf16 as soon as it is done.
    const bool mask = k_tail || (causal && q0 < k0 + kBlockRows);
    uint32_t p_hi[16], p_lo[16], ds[16];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = 8 * j + cq;
      const float2 L = *reinterpret_cast<const float2*>(&sm.lse2[s][c]);
      const float2 dl = *reinterpret_cast<const float2*>(&sm.delta[s][c]);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float p[2], d2[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * h + e;
          p[e] = exp2f(st[i] * sl2 - (e ? L.y : L.x));
          if (mask) {
            const int kr = kp + 8 * h;
            if (kr >= tk || (causal && q0 + c + e < kr)) p[e] = 0.f;
          }
          d2[e] = p[e] * (dpt[i] - (e ? dl.y : dl.x)) * scale;
        }
        const int m = 2 * j + h;  // the pair (st[2m], st[2m + 1])
        p_hi[m] = pack_bf16(p[0], p[1]);
        const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&p_hi[m]);
        p_lo[m] = pack_bf16(p[0] - __low2float(hi), p[1] - __high2float(hi));
        ds[m] = pack_bf16(d2[0], d2[1]);
      }
    }

    // dV += P_hi^T dO + P_lo^T dO and dK += bf16(dS^T) Q.
    hopper::wg_fence();
    hopper::pin(acc_dv);
    hopper::pin(acc_dk);
    grad_product<D>(acc_dv, p_hi, sm.dout[s]);
    grad_product<D>(acc_dv, p_lo, sm.dout[s]);
    grad_product<D>(acc_dk, ds, sm.q[s]);
    hopper::wg_commit();
    hopper::wg_wait<0>();
    hopper::pin(acc_dv);
    hopper::pin(acc_dk);
    hopper::pin(p_hi);
    hopper::pin(p_lo);
    hopper::pin(ds);

    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&sm.empty[s]);
    if (++s == kStages) {
      s = 0;
      phase ^= 1;
    }
  }

  const size_t koff = static_cast<size_t>(bh) * tk;
  store_rows<D>(dk + koff * D, acc_dk, k0 + 64 * wg, tk);
  store_rows<D>(dv + koff * D, acc_dv, k0 + 64 * wg, tk);
}

// K2 (dQ) in bf16. Replaces ops/flash_attention.py::_bwd_dq_kernel. One
// block per (bh, 128 q-rows) walks the k-tiles: blockIdx.x = bh, and causal
// blocks run from the last q rows (the most k-tiles) to the first.
template <int D>
__global__ void __launch_bounds__(kWsThreads, 1)
bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __grid_constant__ CUtensorMap tm_do,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    bf16* __restrict__ dq, int tq, int tk, int causal, float scale) {
  auto& sm = hopper::smem_as<DqSmem<D>>();
  const int bh = blockIdx.x;
  const int qb = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qb * kBlockRows;
  int n_kt = (tk + 63) / 64;
  if (causal) n_kt = min(n_kt, (q0 + kBlockRows - 1) / 64 + 1);
  const int wg = hopper::warpgroup();
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&sm.full[s], 1);
      hopper::mbar_init(&sm.empty[s], kConsumerWGs * 4);
    }
    hopper::mbar_init(&sm.q_full, 1);
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (wg == kConsumerWGs) {
    // Producer: one thread issues every TMA load.
    hopper::regs_dealloc<24>();
    if (threadIdx.x != kConsumerWGs * kWgThreads) return;
    hopper::mbar_arrive_expect_tx(&sm.q_full, 2 * kConsumerWGs * tile_bytes<D>());
    for (int h = 0; h < kConsumerWGs; ++h) {
      tma_tile<D>(sm.q[h], &tm_q, &sm.q_full, q0 + 64 * h, bh);
      tma_tile<D>(sm.dout[h], &tm_do, &sm.q_full, q0 + 64 * h, bh);
    }
    int s = 0;
    uint32_t phase = 0;
    for (int kt = 0; kt < n_kt; ++kt) {
      hopper::mbar_wait(&sm.empty[s], phase ^ 1);
      hopper::mbar_arrive_expect_tx(&sm.full[s], 2 * tile_bytes<D>());
      tma_tile<D>(sm.k[s], &tm_k, &sm.full[s], kt * 64, bh);
      tma_tile<D>(sm.v[s], &tm_v, &sm.full[s], kt * 64, bh);
      if (++s == kStages) {
        s = 0;
        phase ^= 1;
      }
    }
    return;
  }

  // Consumers: warpgroup wg owns q rows [q0 + 64 wg, q0 + 64 wg + 64); this
  // thread holds rows qp and qp + 8 of each fragment, k columns
  // 8 j + ck + {0, 1}.
  hopper::regs_alloc<240>();
  const int row0 = q0 + 64 * wg;
  const int qp = row0 + 16 * ((threadIdx.x % kWgThreads) / 32) + (lane >> 2);
  const int ck = 2 * (lane & 3);
  const float sl2 = scale * kLog2e;
  float L2[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = qp + 8 * h;
    const size_t row = static_cast<size_t>(bh) * tq + r;
    const float L = r < tq ? lse[row] : kNegInf;
    L2[h] = L > kNegInf ? L * kLog2e : pos_inf();  // +inf: P = 0 on the row
    dl[h] = r < tq ? delta[row] : 0.f;
  }
  float acc_dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc_dq[i] = 0.f;
  hopper::mbar_wait(&sm.q_full, 0);

  int s = 0;
  uint32_t phase = 0;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * 64;
    hopper::mbar_wait(&sm.full[s], phase);

    // S = Q K^T and dP = dO V^T for this warpgroup's 64 q rows.
    float s_acc[32], dp[32];
    hopper::wg_fence();
    scores<D>(s_acc, sm.q[wg], sm.k[s]);
    scores<D>(dp, sm.dout[wg], sm.v[s]);
    hopper::wg_commit();
    hopper::wg_wait<0>();
    hopper::pin(s_acc);
    hopper::pin(dp);

    const bool mask = k0 + 64 > tk || (causal && k0 + 63 > row0);
    uint32_t ds[16];
#pragma unroll
    for (int m = 0; m < 16; ++m) {
      float v2[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 2 * m + e;
        const int h = (i >> 1) & 1;
        float p = exp2f(s_acc[i] * sl2 - L2[h]);
        if (mask) {
          const int kc = k0 + 8 * (i >> 2) + ck + (i & 1);
          if (kc >= tk || (causal && qp + 8 * h < kc)) p = 0.f;
        }
        v2[e] = p * (dp[i] - dl[h]) * scale;
      }
      ds[m] = pack_bf16(v2[0], v2[1]);
    }

    // dQ += bf16(dS) K.
    hopper::wg_fence();
    hopper::pin(acc_dq);
    grad_product<D>(acc_dq, ds, sm.k[s]);
    hopper::wg_commit();
    hopper::wg_wait<0>();
    hopper::pin(acc_dq);
    hopper::pin(ds);

    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&sm.empty[s]);
    if (++s == kStages) {
      s = 0;
      phase ^= 1;
    }
  }

  store_rows<D>(dq + static_cast<size_t>(bh) * tq * D, acc_dq, row0, tq);
}

// ---------------------------------------------------------------------------
// K2 and K3 in bf16 at D = 256, on the tensor cores: the "wide" kernels.
// They replace ops/flash_attention.py::_bwd_dq_kernel (:222) and
// _bwd_dkv_kernel (:295) for bf16 heads of 129-256 columns (the wrapper pads
// them to 256), and compute what the D = 64/128 kernels above compute, with the same
// rounding points: P rebuilt from lse, delta from bwd_delta_kernel, dP and
// dS in f32, bf16 operands with f32 sums, dV from the unrounded P (P_hi +
// P_lo), causal keys aligned to the start, one writer a row.
//
// Bound: compute, as at D = 128 (3 product units for K2, 4 for K3, 5 with
// the P_lo product). At [1, 3, 8192, 256] causal the 64-row tiles below
// also move ~1.6 GB a kernel from L2 (every streamed tile read once by each
// block of its head), which near the L2's rate is a bound of its own.
//
// Why not the layout above: at D = 256 its 128 resident rows and three-stage
// ring need 320 KB of shared memory (the card has 227 KB), and K3's dK and
// dV, 64 x 256 f32 each a warpgroup, would take 256 registers a thread
// against setmaxnreg's 240. So:
//   - a block holds 64 resident rows (K and V for K3, Q and dO for K2) and
//     streams the other operand's 64-row tiles through a two-stage ring
//     (2 x 32 KB resident, 2 x 2 x 32 KB ring, 24 KB of exchange);
//   - the two consumer warpgroups split the head's columns, not the rows:
//     warpgroup w owns columns [128 w, 128 w + 128) of the accumulators
//     (dK and dV, 64 x 128 f32 each: 128 registers; dQ: 64);
//   - the square products are split between them: warpgroup 0 computes
//     S (K3: S^T) and warpgroup 1 dP (dP^T), each over all 256 columns
//     with m64n64 SS products. Warpgroup 0 turns S into P and hands P over
//     in f32; warpgroup 1 computes dS from it and hands bf16(dS) back. The
//     exchange is in the fragment order (element i of thread t of a
//     warpgroup at [i * 128 + t]: thread t of the other warpgroup holds the
//     same (row, column) and reads it without bank conflicts) and each
//     hand-over is a named barrier (arrive on one side, sync on the other);
//   - each warpgroup then runs its half of the gradient products as
//     m64n128 RS products: A (P_hi, P_lo, dS) from registers, B the
//     streamed tile's 128 columns MN-major.
// The exchange tiles are written and read by threads only (the products
// read P and dS from registers), so they need no proxy fence. Hazards:
// warpgroup 0 writes P for tile i + 1 only after the dS barrier of tile i,
// which warpgroup 1 reaches after reading P of tile i; warpgroup 1 writes
// dS of tile i + 1 only after the P barrier of tile i + 1, which warpgroup 0
// reaches after reading dS of tile i.
// ---------------------------------------------------------------------------
constexpr int kWideD = 256;
constexpr int kWideStages = 2;
constexpr int kWideHalf = kWideD / kConsumerWGs;  // columns a warpgroup owns
constexpr int kConsumerThreads = kConsumerWGs * kWgThreads;
constexpr int kBarP = 1, kBarDs = 2;  // named barriers of the exchange

struct WideDkvSmem {
  alignas(1024) bf16 k[64 * kWideD];  // resident rows [k0, k0 + 64)
  alignas(1024) bf16 v[64 * kWideD];
  alignas(1024) bf16 q[kWideStages][64 * kWideD];  // the ring of q-tiles
  alignas(1024) bf16 dout[kWideStages][64 * kWideD];
  float p[32 * kWgThreads];      // P^T in f32, in the fragment order
  uint32_t ds[16 * kWgThreads];  // bf16(dS^T) pairs, in the fragment order
  float lse2[kWideStages][64];   // lse * log2(e); +inf for a row whose P is 0
  float delta[kWideStages][64];
  uint64_t full[kWideStages], empty[kWideStages], kv_full;
};

struct WideDqSmem {
  alignas(1024) bf16 q[64 * kWideD];  // resident rows [q0, q0 + 64)
  alignas(1024) bf16 dout[64 * kWideD];
  alignas(1024) bf16 k[kWideStages][64 * kWideD];  // the ring of k-tiles
  alignas(1024) bf16 v[kWideStages][64 * kWideD];
  float p[32 * kWgThreads];      // P in f32, in the fragment order
  uint32_t ds[16 * kWgThreads];  // bf16(dS) pairs, in the fragment order
  uint64_t full[kWideStages], empty[kWideStages], q_full;
};
static_assert(sizeof(WideDkvSmem) + 1024 <= 232448, "K3's wide layout fits in 227 KB");
static_assert(sizeof(WideDqSmem) + 1024 <= 232448, "K2's wide layout fits in 227 KB");

// P as the two bf16 pairs of the A fragment of the dV product: P_hi =
// bf16(P) and P_lo = bf16(P - P_hi) (pair m holds elements 2 m and 2 m + 1).
__device__ __forceinline__ void split_p(const float (&p)[32], uint32_t (&hi)[16],
                                        uint32_t (&lo)[16]) {
#pragma unroll
  for (int m = 0; m < 16; ++m) {
    hi[m] = pack_bf16(p[2 * m], p[2 * m + 1]);
    const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&hi[m]);
    lo[m] = pack_bf16(p[2 * m] - __low2float(h), p[2 * m + 1] - __high2float(h));
  }
}

// K3 (dK/dV) at bf16 D = 256. One block per (bh, 64 k-rows) walks the
// q-tiles: blockIdx.x = bh, blockIdx.y = the k-block, so the heaviest
// causal blocks (small k0) launch first.
__global__ void __launch_bounds__(kWsThreads, 1)
bwd_dkv_wide_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const __grid_constant__ CUtensorMap tm_do,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          bf16* __restrict__ dk, bf16* __restrict__ dv, int tq, int tk,
                          int causal, float scale) {
  auto& sm = hopper::smem_as<WideDkvSmem>();
  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * 64;
  const int n_qt = (tq + 63) / 64;
  const int qt0 = causal ? k0 / 64 : 0;  // q-tiles wholly before k0 are all masked
  const int wg = hopper::warpgroup();
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kWideStages; ++s) {
      hopper::mbar_init(&sm.full[s], 1);
      hopper::mbar_init(&sm.empty[s], kConsumerWGs * 4);
    }
    hopper::mbar_init(&sm.kv_full, 1);
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (wg == kConsumerWGs) {
    // Producer: its first warp fills the ring; lane 0 issues the TMA loads,
    // all 32 lanes stage each q-tile's lse and delta.
    hopper::regs_dealloc<24>();
    if (threadIdx.x / 32 != kConsumerWGs * 4) return;
    if (lane == 0) {
      hopper::mbar_arrive_expect_tx(&sm.kv_full, 2 * tile_bytes<kWideD>());
      tma_tile<kWideD>(sm.k, &tm_k, &sm.kv_full, k0, bh);
      tma_tile<kWideD>(sm.v, &tm_v, &sm.kv_full, k0, bh);
    }
    const float* lse_b = lse + static_cast<size_t>(bh) * tq;
    const float* delta_b = delta + static_cast<size_t>(bh) * tq;
    int s = 0;
    uint32_t phase = 0;
    for (int qt = qt0; qt < n_qt; ++qt) {
      const int q0 = qt * 64;
      hopper::mbar_wait(&sm.empty[s], phase ^ 1);
      for (int r = lane; r < 64; r += 32) {
        const int qp = q0 + r;
        const float L = qp < tq ? lse_b[qp] : kNegInf;
        sm.lse2[s][r] = L > kNegInf ? L * kLog2e : pos_inf();
        sm.delta[s][r] = qp < tq ? delta_b[qp] : 0.f;
      }
      __syncwarp();
      if (lane == 0) {
        hopper::mbar_arrive_expect_tx(&sm.full[s], 2 * tile_bytes<kWideD>());
        tma_tile<kWideD>(sm.q[s], &tm_q, &sm.full[s], q0, bh);
        tma_tile<kWideD>(sm.dout[s], &tm_do, &sm.full[s], q0, bh);
      }
      if (++s == kWideStages) {
        s = 0;
        phase ^= 1;
      }
    }
    return;
  }

  // Consumers: both hold k rows kp and kp + 8 of each 64 x 64 fragment, q
  // columns 8 j + cq + {0, 1}; warpgroup wg owns columns [half, half + 128)
  // of dK and dV.
  hopper::regs_alloc<240>();
  const int t = threadIdx.x % kWgThreads;
  const int kp = k0 + 16 * (t / 32) + (lane >> 2);
  const int cq = 2 * (lane & 3);
  const int half = wg * kWideHalf;
  const float sl2 = scale * kLog2e;
  const bool k_tail = k0 + 64 > tk;
  const bf16* sq_a = wg == 0 ? sm.k : sm.v;  // A of this warpgroup's square product
  float acc_dk[kWideHalf / 2], acc_dv[kWideHalf / 2];
#pragma unroll
  for (int i = 0; i < kWideHalf / 2; ++i) acc_dk[i] = acc_dv[i] = 0.f;
  hopper::mbar_wait(&sm.kv_full, 0);

  int s = 0;
  uint32_t phase = 0;
  for (int qt = qt0; qt < n_qt; ++qt) {
    const int q0 = qt * 64;
    hopper::mbar_wait(&sm.full[s], phase);

    // Warpgroup 0: S^T = K Q^T; warpgroup 1: dP^T = V dO^T.
    float sq[32];
    hopper::wg_fence();
    scores<kWideD>(sq, sq_a, wg == 0 ? sm.q[s] : sm.dout[s]);
    hopper::wg_commit();
    hopper::wg_wait<0>();
    hopper::pin(sq);

    const bool mask = k_tail || (causal && q0 < k0 + 64);
    uint32_t p_hi[16], p_lo[16], ds[16];
    if (wg == 0) {
      // P^T from lse (0 where lse2 is +inf: padded or fully-masked q rows),
      // masked by position where a k row may lie past tk or after a q
      // column; handed over in f32.
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = 8 * j + cq;
        const float2 L = *reinterpret_cast<const float2*>(&sm.lse2[s][c]);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * j + 2 * h + e;
            float p = exp2f(sq[i] * sl2 - (e ? L.y : L.x));
            if (mask) {
              const int kr = kp + 8 * h;
              if (kr >= tk || (causal && q0 + c + e < kr)) p = 0.f;
            }
            sq[i] = p;
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) sm.p[i * kWgThreads + t] = sq[i];
      hopper::bar_arrive(kBarP, kConsumerThreads);
      split_p(sq, p_hi, p_lo);
      hopper::bar_sync(kBarDs, kConsumerThreads);
#pragma unroll
      for (int m = 0; m < 16; ++m) ds[m] = sm.ds[m * kWgThreads + t];
    } else {
      // dS^T = P^T o (dP^T - delta) * scale, handed back as bf16 pairs.
      hopper::bar_sync(kBarP, kConsumerThreads);
      float p[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) p[i] = sm.p[i * kWgThreads + t];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 dl = *reinterpret_cast<const float2*>(&sm.delta[s][8 * j + cq]);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = 4 * j + 2 * h;
          ds[2 * j + h] = pack_bf16(p[i] * (sq[i] - dl.x) * scale,
                                    p[i + 1] * (sq[i + 1] - dl.y) * scale);
        }
      }
#pragma unroll
      for (int m = 0; m < 16; ++m) sm.ds[m * kWgThreads + t] = ds[m];
      hopper::bar_arrive(kBarDs, kConsumerThreads);
      split_p(p, p_hi, p_lo);
    }

    // dV[:, half] += P_hi^T dO + P_lo^T dO and dK[:, half] += bf16(dS^T) Q.
    hopper::wg_fence();
    hopper::pin(acc_dv);
    hopper::pin(acc_dk);
    grad_product<kWideHalf>(acc_dv, p_hi, sm.dout[s] + half * 64);
    grad_product<kWideHalf>(acc_dv, p_lo, sm.dout[s] + half * 64);
    grad_product<kWideHalf>(acc_dk, ds, sm.q[s] + half * 64);
    hopper::wg_commit();
    hopper::wg_wait<0>();
    hopper::pin(acc_dv);
    hopper::pin(acc_dk);
    hopper::pin(p_hi);
    hopper::pin(p_lo);
    hopper::pin(ds);

    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&sm.empty[s]);
    if (++s == kWideStages) {
      s = 0;
      phase ^= 1;
    }
  }

  const size_t koff = static_cast<size_t>(bh) * tk * kWideD + half;
  store_rows<kWideHalf, kWideD>(dk + koff, acc_dk, k0, tk);
  store_rows<kWideHalf, kWideD>(dv + koff, acc_dv, k0, tk);
}

// K2 (dQ) at bf16 D = 256. One block per (bh, 64 q-rows) walks the
// k-tiles: blockIdx.x = bh, and causal blocks run from the last q rows (the
// most k-tiles) to the first.
__global__ void __launch_bounds__(kWsThreads, 1)
bwd_dq_wide_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         const __grid_constant__ CUtensorMap tm_do,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         bf16* __restrict__ dq, int tq, int tk, int causal, float scale) {
  auto& sm = hopper::smem_as<WideDqSmem>();
  const int bh = blockIdx.x;
  const int qb = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qb * 64;
  int n_kt = (tk + 63) / 64;
  if (causal) n_kt = min(n_kt, q0 / 64 + 1);
  const int wg = hopper::warpgroup();
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kWideStages; ++s) {
      hopper::mbar_init(&sm.full[s], 1);
      hopper::mbar_init(&sm.empty[s], kConsumerWGs * 4);
    }
    hopper::mbar_init(&sm.q_full, 1);
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (wg == kConsumerWGs) {
    // Producer: one thread issues every TMA load.
    hopper::regs_dealloc<24>();
    if (threadIdx.x != kConsumerWGs * kWgThreads) return;
    hopper::mbar_arrive_expect_tx(&sm.q_full, 2 * tile_bytes<kWideD>());
    tma_tile<kWideD>(sm.q, &tm_q, &sm.q_full, q0, bh);
    tma_tile<kWideD>(sm.dout, &tm_do, &sm.q_full, q0, bh);
    int s = 0;
    uint32_t phase = 0;
    for (int kt = 0; kt < n_kt; ++kt) {
      hopper::mbar_wait(&sm.empty[s], phase ^ 1);
      hopper::mbar_arrive_expect_tx(&sm.full[s], 2 * tile_bytes<kWideD>());
      tma_tile<kWideD>(sm.k[s], &tm_k, &sm.full[s], kt * 64, bh);
      tma_tile<kWideD>(sm.v[s], &tm_v, &sm.full[s], kt * 64, bh);
      if (++s == kWideStages) {
        s = 0;
        phase ^= 1;
      }
    }
    return;
  }

  // Consumers: both hold q rows qp and qp + 8 of each 64 x 64 fragment, k
  // columns 8 j + ck + {0, 1}; warpgroup wg owns columns [half, half + 128)
  // of dQ.
  hopper::regs_alloc<240>();
  const int t = threadIdx.x % kWgThreads;
  const int qp = q0 + 16 * (t / 32) + (lane >> 2);
  const int ck = 2 * (lane & 3);
  const int half = wg * kWideHalf;
  const float sl2 = scale * kLog2e;
  const bf16* sq_a = wg == 0 ? sm.q : sm.dout;  // A of this warpgroup's square product
  float L2[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = qp + 8 * h;
    const size_t row = static_cast<size_t>(bh) * tq + r;
    const float L = r < tq ? lse[row] : kNegInf;
    L2[h] = L > kNegInf ? L * kLog2e : pos_inf();  // +inf: P = 0 on the row
    dl[h] = r < tq ? delta[row] : 0.f;
  }
  float acc_dq[kWideHalf / 2];
#pragma unroll
  for (int i = 0; i < kWideHalf / 2; ++i) acc_dq[i] = 0.f;
  hopper::mbar_wait(&sm.q_full, 0);

  int s = 0;
  uint32_t phase = 0;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * 64;
    hopper::mbar_wait(&sm.full[s], phase);

    // Warpgroup 0: S = Q K^T; warpgroup 1: dP = dO V^T.
    float sq[32];
    hopper::wg_fence();
    scores<kWideD>(sq, sq_a, wg == 0 ? sm.k[s] : sm.v[s]);
    hopper::wg_commit();
    hopper::wg_wait<0>();
    hopper::pin(sq);

    uint32_t ds[16];
    if (wg == 0) {
      // P from lse, masked by position where a k column may lie past tk
      // or after a row; handed over in f32.
      const bool mask = k0 + 64 > tk || (causal && k0 + 63 > q0);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int h = (i >> 1) & 1;
        float p = exp2f(sq[i] * sl2 - L2[h]);
        if (mask) {
          const int kc = k0 + 8 * (i >> 2) + ck + (i & 1);
          if (kc >= tk || (causal && qp + 8 * h < kc)) p = 0.f;
        }
        sm.p[i * kWgThreads + t] = p;
      }
      hopper::bar_arrive(kBarP, kConsumerThreads);
      hopper::bar_sync(kBarDs, kConsumerThreads);
#pragma unroll
      for (int m = 0; m < 16; ++m) ds[m] = sm.ds[m * kWgThreads + t];
    } else {
      // dS = P o (dP - delta) * scale, handed back as bf16 pairs.
      hopper::bar_sync(kBarP, kConsumerThreads);
#pragma unroll
      for (int m = 0; m < 16; ++m) {
        float v2[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 2 * m + e;
          v2[e] = sm.p[i * kWgThreads + t] * (sq[i] - dl[(i >> 1) & 1]) * scale;
        }
        ds[m] = pack_bf16(v2[0], v2[1]);
        sm.ds[m * kWgThreads + t] = ds[m];
      }
      hopper::bar_arrive(kBarDs, kConsumerThreads);
    }

    // dQ[:, half] += bf16(dS) K[:, half].
    hopper::wg_fence();
    hopper::pin(acc_dq);
    grad_product<kWideHalf>(acc_dq, ds, sm.k[s] + half * 64);
    hopper::wg_commit();
    hopper::wg_wait<0>();
    hopper::pin(acc_dq);
    hopper::pin(ds);

    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&sm.empty[s]);
    if (++s == kWideStages) {
      s = 0;
      phase ^= 1;
    }
  }

  store_rows<kWideHalf, kWideD>(dq + static_cast<size_t>(bh) * tq * kWideD + half, acc_dq, q0,
                                tq);
}

// ---------------------------------------------------------------------------
// K1 in bf16, on the tensor cores. Replaces ops/flash_attention.py::_fwd_kernel
// (:51, launched by _flash_fwd). One block per (bh, 128 q-rows) walks the
// k-tiles: blockIdx.x = bh, and causal blocks run from the last q rows (the
// most k-tiles) to the first.
//
// Bound: compute. Two product units of B*H*T^2*D FLOP, halved by causal:
// S = Q.K^T and O += P.V. Beside them the softmax takes one exponential per
// visible score on the MUFU units (~3.9 T/s on the card against 989 TF/s of
// bf16 products), which at D = 128 is about half the product time; and the
// rest of the softmax (max, sum, rescale, rounding) runs on the CUDA cores.
//
// Design. The block and the ring are K2's, with k-tiles of kFwdN = 128 rows:
// Q (two 64-row tiles) loads once by TMA, K and V tiles stream through the
// kStages ring. Both products are wgmma with f32 accumulation: S = Q.K^T
// takes Q from registers (read once from its tile) and K K-major, so S reads
// only K from shared memory; P.V takes P from registers (the S fragment's
// exponentials rounded to bf16 pairs are already the A layout) and V
// MN-major. No tile is copied. The online softmax runs in the fragment: each
// thread holds 32 scores of each of two rows, the row max is reduced over the
// quad, l keeps the thread's partial sums of the unrounded P (reduced once, in
// the epilogue), scale * log2(e) is folded into the one FFMA before each
// exp2, and the O rescale is skipped while no row max of the warp moves.
// The wide tile halves the per-score share of the per-tile work (waits,
// shuffles, loop control). Overlap, on two levels: each warpgroup issues
// S_j and P_{j-1}.V_{j-1} back to back and runs tile j's softmax while
// P_{j-1}.V_{j-1} is on the tensor cores; and the two warpgroups take turns
// to issue (named barriers), so one's softmax runs while the other's
// products do. Masks apply only to the tiles that cross the diagonal or
// hold the ragged tail; TMA zero-fills rows past T, so V's tail rows are 0
// and never NaN.
// ---------------------------------------------------------------------------
constexpr int kFwdN = 128;            // k-tile rows of K1
constexpr int kFwdS = kFwdN / 2;      // scores a thread holds per tile
static_assert(kFwdN == kBlockRows, "both warpgroups of a block then walk the same k-tiles");

template <int D>
struct FwdSmem {
  alignas(1024) bf16 q[kConsumerWGs][64 * D];  // resident rows [q0, q0 + 128)
  alignas(1024) bf16 k[kStages][kFwdN * D];    // the ring of k-tiles
  alignas(1024) bf16 v[kStages][kFwdN * D];
  uint64_t full[kStages], empty[kStages], q_full;
};

// A 64-row tile of D columns, as written by TMA with 128-byte swizzle, read
// into registers as the A fragment of a product over its columns: pairs
// 4 kk .. 4 kk + 3 are k-step kk (columns 16 kk .. 16 kk + 15).
template <int D>
__device__ __forceinline__ void load_a_frag(uint32_t (&a)[D / 4], const bf16* tile) {
  const int lane = threadIdx.x & 31;
  const int r0 = 16 * ((threadIdx.x % kWgThreads) / 32) + (lane >> 2);
  const char* base = reinterpret_cast<const char*>(tile);
#pragma unroll
  for (int i = 0; i < D / 4; ++i) {
    const int r = r0 + 8 * (i & 1);
    const int c = 16 * (i >> 2) + 8 * ((i >> 1) & 1) + 2 * (lane & 3);  // column
    const int b = 2 * (c % 64);  // byte in the row of its box
    a[i] = *reinterpret_cast<const uint32_t*>(
        base + (c / 64) * kBoxBytes + r * 128 + (((b >> 4) ^ (r & 7)) << 4) + (b & 15));
  }
}

// acc = A[64 x D] . B_tile[kFwdN x D]^T, A from registers (load_a_frag), B
// K-major: the [64 x kFwdN] scores of one warpgroup.
template <int D>
__device__ __forceinline__ void scores_rs(float (&acc)[kFwdS], const uint32_t (&a)[D / 4],
                                          const bf16* b) {
  constexpr uint32_t box = kFwdN * 128;
  hopper::wgmma_rs_m64n128<false>(acc, a[0], a[1], a[2], a[3], desc_k_major(b, 0, box));
#pragma unroll
  for (int kk = 1; kk < D / 16; ++kk) {
    hopper::wgmma_rs_m64n128<true>(acc, a[4 * kk], a[4 * kk + 1], a[4 * kk + 2],
                                   a[4 * kk + 3], desc_k_major(b, kk, box));
  }
}

// 2^x as one MUFU.EX2 (exp2f adds a range check and two scalings around it
// to keep subnormal results; here those flush to 0, ~1e-38 beside P <= 1).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// One online-softmax step of a warpgroup over the 64 x N tile of raw
// scores s = Q.K^T at k-column k0 (N = kFwdN, or kWideFwdN in the wide
// kernel), in the fragment layout: this thread holds
// rows qp and qp + 8, columns k0 + ck + 8 j + {0, 1}. m is each row's running
// max of its visible raw scores (kNegInf while it has none), l the thread's
// partial sums of the unrounded P. Leaves in s the tile's P = exp(scale (s -
// m)) in f32, and in alpha the factor by which the accumulator's rows are to
// be rescaled. Scores are masked by position only on a tile that may hold a
// column past tk or after a row of the warpgroup (rows from row0).
template <int N = kFwdN>
__device__ __forceinline__ void online_softmax(float (&s)[N / 2], float (&m)[2], float (&l)[2],
                                               float (&alpha)[2], float sl2, int qp, int ck,
                                               int k0, int row0, int tk, int causal) {
  if (k0 + N > tk || (causal && k0 + N - 1 > row0)) {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const int c = k0 + ck + 8 * (i >> 2) + (i & 1);
      const int r = qp + 8 * ((i >> 1) & 1);
      if (c >= tk || (causal && r < c)) s[i] = kNegInf;
    }
  }
  float off[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = m[h];
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      mx = fmaxf(mx, fmaxf(s[4 * j + 2 * h], s[4 * j + 2 * h + 1]));
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    // alpha is 0 before the row's first visible key, and exactly 1 while
    // the row's max stands (the rescale is then skipped).
    alpha[h] = m[h] == kNegInf ? 0.f : (m[h] == mx ? 1.f : exp2_approx((m[h] - mx) * sl2));
    // A row with no visible key yet (mx == kNegInf) takes offset 0, so its
    // scores, all kNegInf, give exp2(kNegInf * sl2) = 0 and not exp2(0) = 1.
    off[h] = mx == kNegInf ? 0.f : mx * sl2;
    m[h] = mx;
  }
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const int h = (i >> 1) & 1;
    s[i] = exp2_approx(fmaf(s[i], sl2, -off[h]));
    rs[h] += s[i];
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) l[h] = alpha[h] * l[h] + rs[h];
}

// P rounded to bf16 pairs: the A fragment of P.V (pair j holds elements 2 j
// and 2 j + 1 of the accumulator fragment).
template <int S>
__device__ __forceinline__ void pack_p(const float (&pf)[S], uint32_t (&p)[S / 2]) {
#pragma unroll
  for (int j = 0; j < S / 2; ++j) p[j] = pack_bf16(pf[2 * j], pf[2 * j + 1]);
}

// The end of a forward warpgroup's walk, for its rows qp and qp + 8: l
// summed over the quad, lse = m scale + log l written for the rows before
// tq (NEG_INF on a row with no visible key), and inv = 1 / l, the factor
// of o's rows (0 on such a row, so o = 0 there).
__device__ __forceinline__ void finish_rows(float (&inv)[2], float (&l)[2], const float (&m)[2],
                                            float* __restrict__ lse, int bh, int qp, int tq,
                                            float scale) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    inv[h] = l[h] == 0.f ? 0.f : 1.f / l[h];
  }
  if (lse != nullptr && (threadIdx.x & 3) == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = qp + 8 * h;
      if (r < tq) {
        lse[static_cast<size_t>(bh) * tq + r] =
            l[h] == 0.f ? kNegInf : m[h] * scale + logf(l[h]);
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kWsThreads, 1)
fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v, bf16* __restrict__ o,
                 float* __restrict__ lse, int tq, int tk, int causal, float scale) {
  auto& sm = hopper::smem_as<FwdSmem<D>>();
  const int bh = blockIdx.x;
  const int qb = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qb * kBlockRows;
  int n_kt = (tk + kFwdN - 1) / kFwdN;
  if (causal) n_kt = min(n_kt, (q0 + kBlockRows - 1) / kFwdN + 1);
  const int wg = hopper::warpgroup();
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&sm.full[s], 1);
      hopper::mbar_init(&sm.empty[s], kConsumerWGs * 4);
    }
    hopper::mbar_init(&sm.q_full, 1);
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (wg == kConsumerWGs) {
    // Producer: one thread issues every TMA load.
    hopper::regs_dealloc<24>();
    if (threadIdx.x != kConsumerWGs * kWgThreads) return;
    hopper::mbar_arrive_expect_tx(&sm.q_full, kConsumerWGs * tile_bytes<D>());
    for (int h = 0; h < kConsumerWGs; ++h) {
      tma_tile<D>(sm.q[h], &tm_q, &sm.q_full, q0 + 64 * h, bh);
    }
    int s = 0;
    uint32_t phase = 0;
    for (int kt = 0; kt < n_kt; ++kt) {
      hopper::mbar_wait(&sm.empty[s], phase ^ 1);
      hopper::mbar_arrive_expect_tx(&sm.full[s], 2 * tile_bytes<D, kFwdN>());
      tma_tile<D, kFwdN>(sm.k[s], &tm_k, &sm.full[s], kt * kFwdN, bh);
      tma_tile<D, kFwdN>(sm.v[s], &tm_v, &sm.full[s], kt * kFwdN, bh);
      if (++s == kStages) {
        s = 0;
        phase ^= 1;
      }
    }
    return;
  }

  // Consumers: warpgroup wg owns q rows [row0, row0 + 64). A warpgroup
  // releases every stage but that of its last tile: no later load waits for
  // it.
  hopper::regs_alloc<240>();
  const int row0 = q0 + 64 * wg;
  const int qp = row0 + 16 * ((threadIdx.x % kWgThreads) / 32) + (lane >> 2);
  const int ck = 2 * (lane & 3);
  const float sl2 = scale * kLog2e;
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  hopper::mbar_wait(&sm.q_full, 0);
  uint32_t qf[D / 4];  // Q as the A fragment of S
  load_a_frag<D>(qf, sm.q[wg]);

  // The pipeline: iteration kt issues S_kt = Q K_kt^T and then O += P_{kt-1}
  // V_{kt-1}, waits for S_kt alone, and runs tile kt's softmax while P.V is
  // still on the tensor cores; once that product is done, its stage goes
  // back to the producer, O is rescaled by tile kt's alpha, and tile kt's P
  // is packed into the A fragment. (Packing during the product, into
  // registers that the next product reads, makes ptxas serialise every
  // wgmma of the kernel: C7513.) The softmax's results are pinned before
  // the wait, or the compiler sinks its exponentials below it, out of the
  // overlap.
  //
  // Ping-pong: the two warpgroups take turns to issue their products.
  // Before each issue a warpgroup waits at its own named barrier (1 + wg)
  // for the other's arrival, and after it arrives at the other's (2 - wg);
  // warpgroup 1 arrives once first, so that warpgroup 0 leads. Both take
  // n_kt + 1 turns, and warpgroup 1 skips its last arrival, which no turn
  // would wait for.
  const int my_bar = 1 + wg, other_bar = 2 - wg;
  constexpr int kPair = kConsumerWGs * kWgThreads;
  if (wg == 1 && n_kt > 0) hopper::bar_arrive(other_bar, kPair);
  uint32_t p[kFwdS / 2];
  int s = 0;
  uint32_t phase = 0;
  if (n_kt > 0) {
    hopper::mbar_wait(&sm.full[0], 0);
    float sc[kFwdS], alpha[2];
    hopper::bar_sync(my_bar, kPair);
    hopper::wg_fence();
    scores_rs<D>(sc, qf, sm.k[0]);
    hopper::wg_commit();
    hopper::bar_arrive(other_bar, kPair);
    hopper::wg_wait<0>();
    hopper::pin(sc);
    online_softmax(sc, m, l, alpha, sl2, qp, ck, 0, row0, tk, causal);  // O is still 0
    pack_p(sc, p);
  }
  for (int kt = 1; kt < n_kt; ++kt) {
    const int prev = s;  // the stage of tile kt - 1
    if (++s == kStages) {
      s = 0;
      phase ^= 1;
    }
    hopper::mbar_wait(&sm.full[s], phase);

    float sc[kFwdS], alpha[2];
    hopper::bar_sync(my_bar, kPair);
    hopper::wg_fence();
    scores_rs<D>(sc, qf, sm.k[s]);
    hopper::wg_commit();
    hopper::pin(acc);
    hopper::pin(p);
    hopper::wg_fence();
    grad_product<D, kFwdN>(acc, p, sm.v[prev]);
    hopper::wg_commit();
    hopper::bar_arrive(other_bar, kPair);
    hopper::wg_wait<1>();
    hopper::pin(sc);
    online_softmax(sc, m, l, alpha, sl2, qp, ck, kt * kFwdN, row0, tk, causal);
    hopper::pin(sc);
    hopper::pin(alpha);
    hopper::pin(l);
    hopper::wg_wait<0>();
    hopper::pin(acc);
    hopper::pin(p);

    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&sm.empty[prev]);
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
    }
    pack_p(sc, p);
  }
  if (n_kt > 0) {  // O += P V of the last tile
    hopper::pin(acc);
    hopper::pin(p);
    hopper::bar_sync(my_bar, kPair);
    hopper::wg_fence();
    grad_product<D, kFwdN>(acc, p, sm.v[s]);
    hopper::wg_commit();
    if (wg == 0) hopper::bar_arrive(other_bar, kPair);
    hopper::wg_wait<0>();
    hopper::pin(acc);
    hopper::pin(p);
  }

  float inv[2];
  finish_rows(inv, l, m, lse, bh, qp, tq, scale);
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] *= inv[(i >> 1) & 1];
  store_rows<D>(o + static_cast<size_t>(bh) * tq * D, acc, row0, tq);
}

// ---------------------------------------------------------------------------
// K1 in bf16 at D = 256, on the tensor cores: the wide forward. Replaces
// ops/flash_attention.py::_fwd_kernel (:51, launched by _flash_fwd) for bf16
// heads of 129-256 columns (the wrapper pads them to 256), and computes what
// fwd_wgmma_kernel computes, with its rounding points: P rounded to bf16
// against the running max, l summing the unrounded P, lse = m scale + log l,
// o = 0 and lse = NEG_INF on a row with no visible key, causal keys aligned
// to the start. One block per (bh, 128 q-rows) walks the k-tiles:
// blockIdx.x = bh, and causal blocks run from the last q rows to the first.
//
// Bound: compute, two product units as at D = 128. At [1, 3, 8192, 256]
// causal the 64-row k-tiles below are read from L2 once by each block of
// their head, ~0.8 GB a call, which near the L2's rate is ~0.16 ms of its
// own beside the products' 0.10.
//
// Why not fwd_wgmma_kernel's layout: at D = 256 its 128-row Q and a
// three-stage ring of 128-row K and V tiles need ~448 KB of shared memory
// (the card has 227 KB), and Q as register A fragments (64 registers a
// thread) beside the 64 x 256 O accumulator (128) and a 64 x 128 S tile
// (64) is more than setmaxnreg's 240. So, unlike the wide backward, the
// warpgroups split the rows, not the columns (the forward exchanges
// nothing between them, and one warpgroup's 64 x 256 f32 O is 128
// registers a thread):
//   - Q (two 64-row tiles, 64 KB) loads once by TMA; K and V stream as
//     64-row tiles (kWideFwdN) through a two-stage ring (128 KB). K and V
//     have barriers of their own: K_j's stage goes back to the producer as
//     soon as S_j is done, V_j's once P_j.V_j is, so each load is issued an
//     iteration ahead of its use although the ring has two stages only;
//   - S = Q.K^T takes both operands K-major from shared memory (16 m64n64
//     SS products); Q is not held in registers;
//   - O += P.V takes P from registers (the S fragment's exponentials
//     rounded to bf16 pairs) and V MN-major, as two m64n128 RS products a
//     k-step on V's column halves; O is two 64 x 128 halves;
//   - registers: O 128 + S 32 + P 16 + the softmax's few.
// Overlap as in fwd_wgmma_kernel, on both levels: each warpgroup issues S_j
// and P_{j-1}.V_{j-1} back to back and runs tile j's softmax while
// P_{j-1}.V_{j-1} is on the tensor cores (P is packed only after that
// product is done), and the two warpgroups take turns to issue behind
// named barriers 1 and 2. Masks apply only to the tiles that cross the
// diagonal or hold the ragged tail; TMA zero-fills rows past T, so V's
// tail rows are 0 and never NaN.
// ---------------------------------------------------------------------------
constexpr int kWideFwdN = 64;  // k-tile rows of the wide K1
static_assert(kWideStages == 2, "the wide K1's stage and parity are bits of the tile index");

struct WideFwdSmem {
  alignas(1024) bf16 q[kConsumerWGs][64 * kWideD];     // resident rows [q0, q0 + 128)
  alignas(1024) bf16 k[kWideStages][kWideFwdN * kWideD];  // the ring of k-tiles
  alignas(1024) bf16 v[kWideStages][kWideFwdN * kWideD];
  uint64_t k_full[kWideStages], k_empty[kWideStages];
  uint64_t v_full[kWideStages], v_empty[kWideStages], q_full;
};
static_assert(sizeof(WideFwdSmem) + 1024 <= 232448, "K1's wide layout fits in 227 KB");

__global__ void __launch_bounds__(kWsThreads, 1)
fwd_wide_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v, bf16* __restrict__ o,
                      float* __restrict__ lse, int tq, int tk, int causal, float scale) {
  auto& sm = hopper::smem_as<WideFwdSmem>();
  const int bh = blockIdx.x;
  const int qb = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qb * kBlockRows;
  int n_kt = (tk + kWideFwdN - 1) / kWideFwdN;
  if (causal) n_kt = min(n_kt, (q0 + kBlockRows - 1) / kWideFwdN + 1);
  const int wg = hopper::warpgroup();
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kWideStages; ++s) {
      hopper::mbar_init(&sm.k_full[s], 1);
      hopper::mbar_init(&sm.k_empty[s], kConsumerWGs * 4);
      hopper::mbar_init(&sm.v_full[s], 1);
      hopper::mbar_init(&sm.v_empty[s], kConsumerWGs * 4);
    }
    hopper::mbar_init(&sm.q_full, 1);
    hopper::mbar_init_fence();
  }
  __syncthreads();

  // Tile kt lies in stage kt & 1, in that stage's phase (kt >> 1) & 1.
  if (wg == kConsumerWGs) {
    // Producer: one thread issues every TMA load, K_kt then V_kt.
    hopper::regs_dealloc<24>();
    if (threadIdx.x != kConsumerWGs * kWgThreads) return;
    hopper::mbar_arrive_expect_tx(&sm.q_full, kConsumerWGs * tile_bytes<kWideD>());
    for (int h = 0; h < kConsumerWGs; ++h) {
      tma_tile<kWideD>(sm.q[h], &tm_q, &sm.q_full, q0 + 64 * h, bh);
    }
    for (int kt = 0; kt < n_kt; ++kt) {
      const int s = kt & 1;
      const uint32_t phase = (kt >> 1) & 1;
      hopper::mbar_wait(&sm.k_empty[s], phase ^ 1);
      hopper::mbar_arrive_expect_tx(&sm.k_full[s], tile_bytes<kWideD, kWideFwdN>());
      tma_tile<kWideD, kWideFwdN>(sm.k[s], &tm_k, &sm.k_full[s], kt * kWideFwdN, bh);
      hopper::mbar_wait(&sm.v_empty[s], phase ^ 1);
      hopper::mbar_arrive_expect_tx(&sm.v_full[s], tile_bytes<kWideD, kWideFwdN>());
      tma_tile<kWideD, kWideFwdN>(sm.v[s], &tm_v, &sm.v_full[s], kt * kWideFwdN, bh);
    }
    return;
  }

  // Consumers: warpgroup wg owns q rows [row0, row0 + 64) and all 256
  // columns of their O. A warpgroup releases each K stage after its S and
  // each V stage but its last tile's after its P.V: no later load waits
  // for that one.
  hopper::regs_alloc<240>();
  const int row0 = q0 + 64 * wg;
  const int qp = row0 + 16 * ((threadIdx.x % kWgThreads) / 32) + (lane >> 2);
  const int ck = 2 * (lane & 3);
  const float sl2 = scale * kLog2e;
  const bf16* q_tile = sm.q[wg];
  float acc0[kWideHalf / 2], acc1[kWideHalf / 2];  // O's columns [0, 128) and [128, 256)
#pragma unroll
  for (int i = 0; i < kWideHalf / 2; ++i) acc0[i] = acc1[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  hopper::mbar_wait(&sm.q_full, 0);

  // The pipeline and the ping-pong are fwd_wgmma_kernel's (see there).
  const int my_bar = 1 + wg, other_bar = 2 - wg;
  if (wg == 1 && n_kt > 0) hopper::bar_arrive(other_bar, kConsumerThreads);
  uint32_t p[kWideFwdN / 4];
  if (n_kt > 0) {
    hopper::mbar_wait(&sm.k_full[0], 0);
    float sc[kWideFwdN / 2], alpha[2];
    hopper::bar_sync(my_bar, kConsumerThreads);
    hopper::wg_fence();
    scores<kWideD>(sc, q_tile, sm.k[0]);
    hopper::wg_commit();
    hopper::bar_arrive(other_bar, kConsumerThreads);
    hopper::wg_wait<0>();
    hopper::pin(sc);
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&sm.k_empty[0]);
    online_softmax<kWideFwdN>(sc, m, l, alpha, sl2, qp, ck, 0, row0, tk, causal);  // O is 0
    pack_p(sc, p);
  }
  for (int kt = 1; kt < n_kt; ++kt) {
    const int s = kt & 1, prev = s ^ 1;  // the stages of tiles kt and kt - 1
    hopper::mbar_wait(&sm.k_full[s], (kt >> 1) & 1);
    hopper::mbar_wait(&sm.v_full[prev], ((kt - 1) >> 1) & 1);

    float sc[kWideFwdN / 2], alpha[2];
    hopper::bar_sync(my_bar, kConsumerThreads);
    hopper::wg_fence();
    scores<kWideD>(sc, q_tile, sm.k[s]);
    hopper::wg_commit();
    hopper::pin(acc0);
    hopper::pin(acc1);
    hopper::pin(p);
    hopper::wg_fence();
    grad_product<kWideHalf, kWideFwdN>(acc0, p, sm.v[prev]);
    grad_product<kWideHalf, kWideFwdN>(acc1, p, sm.v[prev] + kWideHalf * kWideFwdN);
    hopper::wg_commit();
    hopper::bar_arrive(other_bar, kConsumerThreads);
    hopper::wg_wait<1>();
    hopper::pin(sc);
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&sm.k_empty[s]);
    online_softmax<kWideFwdN>(sc, m, l, alpha, sl2, qp, ck, kt * kWideFwdN, row0, tk, causal);
    hopper::pin(sc);
    hopper::pin(alpha);
    hopper::pin(l);
    hopper::wg_wait<0>();
    hopper::pin(acc0);
    hopper::pin(acc1);
    hopper::pin(p);

    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&sm.v_empty[prev]);
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int i = 0; i < kWideHalf / 2; ++i) {
        acc0[i] *= alpha[(i >> 1) & 1];
        acc1[i] *= alpha[(i >> 1) & 1];
      }
    }
    pack_p(sc, p);
  }
  if (n_kt > 0) {  // O += P V of the last tile
    const int s = (n_kt - 1) & 1;
    hopper::mbar_wait(&sm.v_full[s], ((n_kt - 1) >> 1) & 1);
    hopper::pin(acc0);
    hopper::pin(acc1);
    hopper::pin(p);
    hopper::bar_sync(my_bar, kConsumerThreads);
    hopper::wg_fence();
    grad_product<kWideHalf, kWideFwdN>(acc0, p, sm.v[s]);
    grad_product<kWideHalf, kWideFwdN>(acc1, p, sm.v[s] + kWideHalf * kWideFwdN);
    hopper::wg_commit();
    if (wg == 0) hopper::bar_arrive(other_bar, kConsumerThreads);
    hopper::wg_wait<0>();
    hopper::pin(acc0);
    hopper::pin(acc1);
    hopper::pin(p);
  }

  float inv[2];
  finish_rows(inv, l, m, lse, bh, qp, tq, scale);
#pragma unroll
  for (int i = 0; i < kWideHalf / 2; ++i) {
    acc0[i] *= inv[(i >> 1) & 1];
    acc1[i] *= inv[(i >> 1) & 1];
  }
  bf16* ob = o + static_cast<size_t>(bh) * tq * kWideD;
  store_rows<kWideHalf, kWideD>(ob, acc0, row0, tq);
  store_rows<kWideHalf, kWideD>(ob + kWideHalf, acc1, row0, tq);
}

// Tile rows of the FMA kernels at head width D: 64; 32 at D = 256, where
// four f32 tiles of 64 rows (K2's Q, dO, K and V) would need 263 KB of
// shared memory against the 227 KB a block may have; 16 at D = 384 and 512,
// where four f32 tiles of 32 rows would need 197 KB and 263 KB. At 16 rows
// K3 in f32 takes 133,632 bytes at D = 512 and 100,864 at D = 384 (K2
// 132,544 and 99,776, K1 99,584 and 75,008); a thread owns one tile row.
template <int D>
constexpr int fma_rows() { return D > 256 ? 16 : (D > 128 ? 32 : kTile); }

// Dynamic shared memory of each kernel, in bytes.
template <typename T, int D, int R>
constexpr size_t fwd_smem() {
  return sizeof(T) * (3 * R * padded<T>(D) + R * padded<T>(R));
}
template <typename T, int D, int R>
constexpr size_t dq_smem() {
  return sizeof(T) * (4 * R * padded<T>(D) + R * padded<T>(R)) + sizeof(float) * 2 * R;
}
template <typename T, int D, int R>
constexpr size_t dkv_smem() {
  return sizeof(T) * (4 * R * padded<T>(D) + R * padded<T>(R)) +
         sizeof(float) * (R * padded<float>(R) + 2 * R);
}
static_assert(dkv_smem<float, 256, fma_rows<256>()>() <= 232448, "K3 at D = 256 fits");
static_assert(dkv_smem<float, 512, fma_rows<512>()>() <= 232448, "K3 at D = 512 fits");
static_assert(dq_smem<float, 512, fma_rows<512>()>() <= 232448, "K2 at D = 512 fits");

template <typename Kern>
cudaError_t allow_smem(Kern kern, size_t bytes) {
  // Above 48 KB a kernel must opt in to its dynamic shared memory.
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// The FMA launchers. scale is the softmax scale 1/sqrt(D) of the caller's
// head width, which is less than D when the wrapper zero-padded the columns.
template <typename T, int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o,
                       void* lse, int bh, int tq, int tk, int causal, float scale,
                       cudaStream_t stream) {
  constexpr int R = fma_rows<D>();
  const size_t smem = fwd_smem<T, D, R>();
  cudaError_t err = allow_smem(fwd_kernel<T, D, R>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((tq + R - 1) / R, bh);
  fwd_kernel<T, D, R><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      tq, tk, causal, scale);
  return cudaGetLastError();
}


template <typename T, int D>
cudaError_t launch_delta(const void* o, const void* dout, const void* glse,
                         void* delta, int rows, cudaStream_t stream) {
  const int blocks = (rows + kDeltaRows - 1) / kDeltaRows;
  bwd_delta_kernel<T, D><<<blocks, 32 * kDeltaRows, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout),
      static_cast<const float*>(glse), static_cast<float*>(delta), rows);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dq, int bh, int tq, int tk, int causal, float scale,
                      cudaStream_t stream) {
  constexpr int R = fma_rows<D>();
  const size_t smem = dq_smem<T, D, R>();
  cudaError_t err = allow_smem(bwd_dq_kernel<T, D, R>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((tq + R - 1) / R, bh);
  bwd_dq_kernel<T, D, R><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), tq, tk, causal, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, int bh, int tq, int tk, int causal,
                       float scale, cudaStream_t stream) {
  constexpr int R = fma_rows<D>();
  const size_t smem = dkv_smem<T, D, R>();
  cudaError_t err = allow_smem(bwd_dkv_kernel<T, D, R>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((tk + R - 1) / R, bh);
  bwd_dkv_kernel<T, D, R><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), tq, tk, causal, scale);
  return cudaGetLastError();
}

// Returned when cuTensorMapEncodeTiled refuses a map: kTensorMapError + CUresult.
constexpr int kTensorMapError = 1000;

// A 3-D tensor map (D, T, BH) over a [BH, T, D] bf16 tensor: boxes of 64
// columns by box_rows rows, 128-byte swizzle, rows past T read as zero. The map is built on the host
// for each call and passed to the kernel by value (__grid_constant__).
int encode_map(CUtensorMap* map, const void* base, int bh, int t, int d, int box_rows = 64) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(t),
                              static_cast<cuuint64_t>(bh)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d) * sizeof(bf16),
                                 static_cast<cuuint64_t>(t) * d * sizeof(bf16)};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUresult r = cuTensorMapEncodeTiled(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
      strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kTensorMapError + static_cast<int>(r);
}

// The four maps of a backward launch: q and dout over tq rows, k and v
// over tk rows.
int encode_maps(CUtensorMap (&m)[4], const void* q, const void* k, const void* v,
                const void* dout, int bh, int tq, int tk, int d) {
  int err = encode_map(&m[0], q, bh, tq, d);
  if (err == 0) err = encode_map(&m[1], k, bh, tk, d);
  if (err == 0) err = encode_map(&m[2], v, bh, tk, d);
  if (err == 0) err = encode_map(&m[3], dout, bh, tq, d);
  return err;
}

template <int D>
int launch_fwd_wgmma(const void* q, const void* k, const void* v, void* o, void* lse,
                     int bh, int tq, int tk, int causal, float scale, cudaStream_t stream) {
  CUtensorMap m[3];
  int map_err = encode_map(&m[0], q, bh, tq, D);
  if (map_err == 0) map_err = encode_map(&m[1], k, bh, tk, D, kFwdN);
  if (map_err == 0) map_err = encode_map(&m[2], v, bh, tk, D, kFwdN);
  if (map_err != 0) return map_err;
  const size_t smem = sizeof(FwdSmem<D>) + 1024;  // + alignment slack
  cudaError_t err = allow_smem(fwd_wgmma_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(bh, (tq + kBlockRows - 1) / kBlockRows);
  fwd_wgmma_kernel<D><<<grid, kWsThreads, smem, stream>>>(
      m[0], m[1], m[2], static_cast<bf16*>(o), static_cast<float*>(lse), tq, tk, causal,
      scale);
  return cudaGetLastError();
}

template <int D>
int launch_dq_wgmma(const void* q, const void* k, const void* v, const void* dout,
                    const void* lse, const void* delta, void* dq, int bh, int tq,
                    int tk, int causal, float scale, cudaStream_t stream) {
  CUtensorMap m[4];
  const int map_err = encode_maps(m, q, k, v, dout, bh, tq, tk, D);
  if (map_err != 0) return map_err;
  const size_t smem = sizeof(DqSmem<D>) + 1024;  // + alignment slack
  cudaError_t err = allow_smem(bwd_dq_wgmma_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(bh, (tq + kBlockRows - 1) / kBlockRows);
  bwd_dq_wgmma_kernel<D><<<grid, kWsThreads, smem, stream>>>(
      m[0], m[1], m[2], m[3], static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dq), tq, tk, causal, scale);
  return cudaGetLastError();
}

template <int D>
int launch_dkv_wgmma(const void* q, const void* k, const void* v, const void* dout,
                     const void* lse, const void* delta, void* dk, void* dv, int bh,
                     int tq, int tk, int causal, float scale, cudaStream_t stream) {
  CUtensorMap m[4];
  const int map_err = encode_maps(m, q, k, v, dout, bh, tq, tk, D);
  if (map_err != 0) return map_err;
  const size_t smem = sizeof(DkvSmem<D>) + 1024;  // + alignment slack
  cudaError_t err = allow_smem(bwd_dkv_wgmma_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(bh, (tk + kBlockRows - 1) / kBlockRows);
  bwd_dkv_wgmma_kernel<D><<<grid, kWsThreads, smem, stream>>>(
      m[0], m[1], m[2], m[3], static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), tq, tk, causal, scale);
  return cudaGetLastError();
}

int launch_dq_wide(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* delta, void* dq, int bh, int tq, int tk,
                   int causal, float scale, cudaStream_t stream) {
  CUtensorMap m[4];
  const int map_err = encode_maps(m, q, k, v, dout, bh, tq, tk, kWideD);
  if (map_err != 0) return map_err;
  const size_t smem = sizeof(WideDqSmem) + 1024;  // + alignment slack
  cudaError_t err = allow_smem(bwd_dq_wide_wgmma_kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(bh, (tq + 63) / 64);
  bwd_dq_wide_wgmma_kernel<<<grid, kWsThreads, smem, stream>>>(
      m[0], m[1], m[2], m[3], static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dq), tq, tk, causal, scale);
  return cudaGetLastError();
}

int launch_fwd_wide(const void* q, const void* k, const void* v, void* o, void* lse, int bh,
                    int tq, int tk, int causal, float scale, cudaStream_t stream) {
  CUtensorMap m[3];
  int map_err = encode_map(&m[0], q, bh, tq, kWideD);
  if (map_err == 0) map_err = encode_map(&m[1], k, bh, tk, kWideD, kWideFwdN);
  if (map_err == 0) map_err = encode_map(&m[2], v, bh, tk, kWideD, kWideFwdN);
  if (map_err != 0) return map_err;
  const size_t smem = sizeof(WideFwdSmem) + 1024;  // + alignment slack
  cudaError_t err = allow_smem(fwd_wide_wgmma_kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(bh, (tq + kBlockRows - 1) / kBlockRows);
  fwd_wide_wgmma_kernel<<<grid, kWsThreads, smem, stream>>>(
      m[0], m[1], m[2], static_cast<bf16*>(o), static_cast<float*>(lse), tq, tk, causal,
      scale);
  return cudaGetLastError();
}

int launch_dkv_wide(const void* q, const void* k, const void* v, const void* dout,
                    const void* lse, const void* delta, void* dk, void* dv, int bh, int tq,
                    int tk, int causal, float scale, cudaStream_t stream) {
  CUtensorMap m[4];
  const int map_err = encode_maps(m, q, k, v, dout, bh, tq, tk, kWideD);
  if (map_err != 0) return map_err;
  const size_t smem = sizeof(WideDkvSmem) + 1024;  // + alignment slack
  cudaError_t err = allow_smem(bwd_dkv_wide_wgmma_kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(bh, (tk + 63) / 64);
  bwd_dkv_wide_wgmma_kernel<<<grid, kWsThreads, smem, stream>>>(
      m[0], m[1], m[2], m[3], static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dk), static_cast<bf16*>(dv), tq,
      tk, causal, scale);
  return cudaGetLastError();
}

}  // namespace

// Plain C interface. dtype: 0 = f32, 1 = bf16; d, the head width, is 64,
// 128, 256, 384 or 512 (the wrapper zero-pads other widths up to one of
// them). scale is the softmax scale of the caller's unpadded width. lse
// (forward) and glse (the delta pass) may be NULL. Each returns the
// launch's cudaGetLastError(), cudaErrorInvalidValue for a shape or type
// outside the kernels' scope, or kTensorMapError + the CUresult of a refused
// cuTensorMapEncodeTiled; it never synchronises. The backward passes take
// delta from tfo_flash_bwd_delta. f32 runs the FMA kernels at every width;
// bf16 the wgmma kernels at D = 64 and 128, the wide kernels at D = 256
// (fwd_wide_wgmma_kernel, bwd_dq_wide_wgmma_kernel and
// bwd_dkv_wide_wgmma_kernel), and the FMA kernels at 384 and 512.
#define TFO_DISPATCH(DTYPE, D, CALL_F32, CALL_BF16, CALL_BF16_256, CALL_BF16_FMA)    \
  if ((DTYPE) == 0 && (D) == 64) return static_cast<int>(CALL_F32(float, 64));     \
  if ((DTYPE) == 0 && (D) == 128) return static_cast<int>(CALL_F32(float, 128));   \
  if ((DTYPE) == 0 && (D) == 256) return static_cast<int>(CALL_F32(float, 256));   \
  if ((DTYPE) == 1 && (D) == 64) return static_cast<int>(CALL_BF16(64));           \
  if ((DTYPE) == 1 && (D) == 128) return static_cast<int>(CALL_BF16(128));         \
  if ((DTYPE) == 1 && (D) == 256) return static_cast<int>(CALL_BF16_256);          \
  if ((DTYPE) == 0 && (D) == 384) return static_cast<int>(CALL_F32(float, 384));   \
  if ((DTYPE) == 0 && (D) == 512) return static_cast<int>(CALL_F32(float, 512));   \
  if ((DTYPE) == 1 && (D) == 384) return static_cast<int>(CALL_BF16_FMA(bf16, 384)); \
  if ((DTYPE) == 1 && (D) == 512) return static_cast<int>(CALL_BF16_FMA(bf16, 512)); \
  return static_cast<int>(cudaErrorInvalidValue);

extern "C" int tfo_flash_fwd(const void* q, const void* k, const void* v,
                             void* o, void* lse, int bh, int tq, int tk, int d,
                             int dtype, int causal, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FMA(T, DD) launch_fwd<T, DD>(q, k, v, o, lse, bh, tq, tk, causal, scale, s)
#define WG(DD) launch_fwd_wgmma<DD>(q, k, v, o, lse, bh, tq, tk, causal, scale, s)
#define WIDE launch_fwd_wide(q, k, v, o, lse, bh, tq, tk, causal, scale, s)
  TFO_DISPATCH(dtype, d, FMA, WG, WIDE, FMA)
#undef FMA
#undef WG
#undef WIDE
}

extern "C" int tfo_flash_bwd_delta(const void* o, const void* dout,
                                   const void* glse, void* delta, int rows,
                                   int d, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FMA(T, DD) launch_delta<T, DD>(o, dout, glse, delta, rows, s)
#define BF(DD) launch_delta<bf16, DD>(o, dout, glse, delta, rows, s)
  TFO_DISPATCH(dtype, d, FMA, BF, BF(256), FMA)
#undef FMA
#undef BF
}

extern "C" int tfo_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dq, int bh, int tq,
                                int tk, int d, int dtype, int causal, float scale,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FMA(T, DD) launch_dq<T, DD>(q, k, v, dout, lse, delta, dq, bh, tq, tk, causal, scale, s)
#define WG(DD) launch_dq_wgmma<DD>(q, k, v, dout, lse, delta, dq, bh, tq, tk, causal, scale, s)
#define WIDE launch_dq_wide(q, k, v, dout, lse, delta, dq, bh, tq, tk, causal, scale, s)
  TFO_DISPATCH(dtype, d, FMA, WG, WIDE, FMA)
#undef FMA
#undef WG
#undef WIDE
}

extern "C" int tfo_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dk, void* dv, int bh,
                                 int tq, int tk, int d, int dtype, int causal,
                                 float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FMA(T, DD) \
  launch_dkv<T, DD>(q, k, v, dout, lse, delta, dk, dv, bh, tq, tk, causal, scale, s)
#define WG(DD) \
  launch_dkv_wgmma<DD>(q, k, v, dout, lse, delta, dk, dv, bh, tq, tk, causal, scale, s)
#define WIDE launch_dkv_wide(q, k, v, dout, lse, delta, dk, dv, bh, tq, tk, causal, scale, s)
  TFO_DISPATCH(dtype, d, FMA, WG, WIDE, FMA)
#undef FMA
#undef WG
#undef WIDE
}
