// Flash attention for Hopper (sm_90a): forward, dQ and dK/dV kernels.
//
// Built by tf_operator_tpu_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// into a shared library with the plain C interface at the bottom of this
// file, loaded with ctypes by tf_operator_tpu_torch/ops/flash_attention.py.
//
// Operands are [BH, T, D] row-major (batch*heads flattened), D in {64, 128},
// element type f32 or bf16; lse and the lse cotangent are [BH, T] f32. Every
// sum, the softmax statistics and the accumulators are f32. Rounding follows
// the TPU kernels exactly: P is rounded to the input type before P.V, dS
// before dS.K and dS^T.Q; dV = P^T.dO takes the unrounded P (dO upcast).
//
// Tiles are 64x64 and a block has 256 threads. Thread (ty, tx) = (tid / 16,
// tid % 16) owns tile rows ty + 16*i (i < 4) and columns tx + 16*j, so row
// reductions are shuffles within a 16-lane half warp. Shared-memory rows are
// padded by one 4-byte bank so the column-strided reads hit 16 distinct
// banks. Rows past the end of a sequence load as zero, never as garbage
// (0 * NaN = NaN would poison an accumulator), and are masked by position.
//
// What bounds these kernels on the H100: at the trainer's shape (T = 8192,
// D = 128, causal, bf16) each is compute-bound; the HBM traffic (~0.2 GB a
// call at batch 4) is an order of magnitude below the 989 TF/s tensor-core
// bound. This first version multiplies with f32 FMA on the CUDA cores, so
// its ceiling is the 67 TF/s FMA rate, and its inner loops issue one
// shared-memory load for every two FMAs. It keeps the Q (or K/V) tile
// resident and streams the other operand's tiles through shared memory, so
// HBM traffic stays O(T*D) per tile row; moving the products to wgmma with
// TMA-fed shared-memory rings is the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // fully-masked sentinel (NEG_INF)
constexpr int kTile = 64;          // rows per q-tile and per k-tile
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

// Copy rows [row0, row0 + kTile) of a [n_rows, D] matrix into shared memory
// with 16-byte global loads; rows at or past n_rows become zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(T* dst, const T* __restrict__ src,
                                          int row0, int n_rows) {
  constexpr int LD = padded<T>(D);
  constexpr int VEC = 16 / sizeof(T);
  constexpr int PER_ROW = D / VEC;
  for (int idx = threadIdx.x; idx < kTile * PER_ROW; idx += kThreads) {
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

// delta[r] = rowsum(dO * O) - g_lse[r] and lse[r] for the rows of one q-tile,
// one warp per 8 rows. dO comes from its shared tile, O from global memory.
// Rows past tq get lse = delta = 0 (their products are masked anyway).
template <typename T, int D>
__device__ __forceinline__ void row_stats(const T* dos, const T* __restrict__ ob,
                                          const float* __restrict__ lseb,
                                          const float* __restrict__ glseb,
                                          int q0, int tq, float* lse_s,
                                          float* delta_s) {
  constexpr int LD = padded<T>(D);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int rr = 0; rr < kTile / (kThreads / 32); ++rr) {
    const int r = warp * (kTile / (kThreads / 32)) + rr;
    const int qp = q0 + r;
    float sum = 0.f;
    if (qp < tq) {
      for (int d = lane; d < D; d += 32) {
        sum += to_f(dos[r * LD + d]) * to_f(ob[static_cast<size_t>(qp) * D + d]);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) {
      const bool in = qp < tq;
      lse_s[r] = in ? lseb[qp] : 0.f;
      delta_s[r] = in ? sum - (glseb != nullptr ? glseb[qp] : 0.f) : 0.f;
    }
  }
}

// ---------------------------------------------------------------------------
// K1: forward. Replaces ops/flash_attention.py::_fwd_kernel (launched by
// _flash_fwd). One block per (bh, q-tile) walks the k-tiles itself, where the
// TPU kernel walked a sequential grid axis and carried (m, l, acc) in VMEM
// scratch between grid steps: here (m, l, acc) live in registers for the
// whole walk. Causal: k-tiles wholly above the diagonal
// (k0 > q0 + kTile - 1) are never visited. Bound: compute (2 units of
// B*H*T^2*D FLOP causal); see the file header.
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
           int tq, int tk, int causal, float scale) {
  constexpr int LD = padded<T>(D);
  constexpr int LDP = padded<T>(kTile);
  constexpr int CJ = D / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* ks = qs + kTile * LD;
  T* vs = ks + kTile * LD;
  T* ps = vs + kTile * LD;  // [kTile][LDP]: P rounded to T

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kTile;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const T* qb = q + static_cast<size_t>(bh) * tq * D;
  const T* kb = k + static_cast<size_t>(bh) * tk * D;
  const T* vb = v + static_cast<size_t>(bh) * tk * D;

  load_tile<T, D>(qs, qb, q0, tq);

  float acc[4][CJ];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < CJ; ++j) acc[i][j] = 0.f;
  }

  int n_kt = (tk + kTile - 1) / kTile;
  if (causal) n_kt = min(n_kt, (q0 + kTile - 1) / kTile + 1);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the previous step is done with ks, vs and ps
    load_tile<T, D>(ks, kb, k0, tk);
    load_tile<T, D>(vs, vb, k0, tk);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = to_f(qs[(ty + 16 * i) * LD + d]);
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = to_f(ks[(tx + 16 * j) * LD + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        const bool ok = kp < tk && (!causal || qp >= kp);
        s[i][j] = ok ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
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
    for (int c = 0; c < kTile; ++c) {
      float a[4], b[CJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = to_f(ps[(ty + 16 * i) * LDP + c]);
#pragma unroll
      for (int j = 0; j < CJ; ++j) b[j] = to_f(vs[c * LD + tx + 16 * j]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
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
// K2: dQ. Replaces ops/flash_attention.py::_bwd_dq_kernel (launched in
// _flash_bwd). One block per (bh, q-tile) walks the k-tiles:
//   dQ_i = scale * sum_j [P_ij o (dO_i V_j^T - delta_i)] K_j,
// P rebuilt from lse, delta = rowsum(dO o O) - g_lse recomputed in-block.
// dQ accumulates in registers; causal skip as in K1. Bound: compute
// (3 units: S, dP and dS.K).
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ o,
              const T* __restrict__ dout, const float* __restrict__ lse,
              const float* __restrict__ glse, T* __restrict__ dq, int tq,
              int tk, int causal, float scale) {
  constexpr int LD = padded<T>(D);
  constexpr int LDP = padded<T>(kTile);
  constexpr int CJ = D / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* dos = qs + kTile * LD;
  T* ks = dos + kTile * LD;
  T* vs = ks + kTile * LD;
  T* dss = vs + kTile * LD;  // [kTile][LDP]: dS rounded to T
  float* lse_s = reinterpret_cast<float*>(dss + kTile * LDP);
  float* delta_s = lse_s + kTile;

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kTile;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const size_t qoff = static_cast<size_t>(bh) * tq;
  const T* kb = k + static_cast<size_t>(bh) * tk * D;
  const T* vb = v + static_cast<size_t>(bh) * tk * D;

  load_tile<T, D>(qs, q + qoff * D, q0, tq);
  load_tile<T, D>(dos, dout + qoff * D, q0, tq);
  __syncthreads();
  row_stats<T, D>(dos, o + qoff * D, lse + qoff,
                  glse != nullptr ? glse + qoff : nullptr, q0, tq, lse_s, delta_s);

  float acc[4][CJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < CJ; ++j) acc[i][j] = 0.f;

  int n_kt = (tk + kTile - 1) / kTile;
  if (causal) n_kt = min(n_kt, (q0 + kTile - 1) / kTile + 1);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();
    load_tile<T, D>(ks, kb, k0, tk);
    load_tile<T, D>(vs, vb, k0, tk);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[4], g[4], b[4], w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = to_f(qs[(ty + 16 * i) * LD + d]);
        g[i] = to_f(dos[(ty + 16 * i) * LD + d]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        b[j] = to_f(ks[(tx + 16 * j) * LD + d]);
        w[j] = to_f(vs[(tx + 16 * j) * LD + d]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i], b[j], s[i][j]);
          dp[i][j] = fmaf(g[i], w[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int qp = q0 + r;
      const float L = lse_s[r];
      const float delta = delta_s[r];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        const bool ok = qp < tq && kp < tk && (!causal || qp >= kp) && L > kNegInf;
        const float p = ok ? expf(s[i][j] * scale - L) : 0.f;
        dss[r * LDP + tx + 16 * j] = from_f<T>(p * (dp[i][j] - delta) * scale);
      }
    }
    __syncthreads();

#pragma unroll 8
    for (int c = 0; c < kTile; ++c) {
      float a[4], b[CJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = to_f(dss[(ty + 16 * i) * LDP + c]);
#pragma unroll
      for (int j = 0; j < CJ; ++j) b[j] = to_f(ks[c * LD + tx + 16 * j]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty + 16 * i;
    if (qp >= tq) continue;
#pragma unroll
    for (int j = 0; j < CJ; ++j) {
      dq[(qoff + qp) * D + tx + 16 * j] = from_f<T>(acc[i][j]);
    }
  }
}

// ---------------------------------------------------------------------------
// K3: dK/dV. Replaces ops/flash_attention.py::_bwd_dkv_kernel (launched in
// _flash_bwd). One block per (bh, k-tile) walks the q-tiles, so each dK/dV
// row has one writer and no atomics are needed:
//   dV_j = sum_i P_ij^T dO_i,   dK_j = scale * sum_i dS_ij^T Q_i.
// Causal: q-tiles wholly before the k-tile (q0 + kTile - 1 < k0) are never
// visited. Padded q rows and rows with lse == NEG_INF give P = 0. Bound:
// compute (4 units: S^T, dP^T, P^T.dO and dS^T.Q).
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ o,
               const T* __restrict__ dout, const float* __restrict__ lse,
               const float* __restrict__ glse, T* __restrict__ dk,
               T* __restrict__ dv, int tq, int tk, int causal, float scale) {
  constexpr int LD = padded<T>(D);
  constexpr int LDP = padded<T>(kTile);
  constexpr int LDF = padded<float>(kTile);
  constexpr int CJ = D / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);
  T* vs = ks + kTile * LD;
  T* qs = vs + kTile * LD;
  T* dos = qs + kTile * LD;
  T* dsts = dos + kTile * LD;  // [kTile][LDP]: dS^T rounded to T
  float* pts = reinterpret_cast<float*>(dsts + kTile * LDP);  // P^T, f32
  float* lse_s = pts + kTile * LDF;
  float* delta_s = lse_s + kTile;

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * kTile;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const size_t qoff = static_cast<size_t>(bh) * tq;
  const size_t koff = static_cast<size_t>(bh) * tk;

  load_tile<T, D>(ks, k + koff * D, k0, tk);
  load_tile<T, D>(vs, v + koff * D, k0, tk);

  float acc_k[4][CJ], acc_v[4][CJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < CJ; ++j) acc_k[i][j] = acc_v[i][j] = 0.f;

  const int n_qt = (tq + kTile - 1) / kTile;
  const int qt0 = causal ? k0 / kTile : 0;
  for (int qt = qt0; qt < n_qt; ++qt) {
    const int q0 = qt * kTile;
    __syncthreads();
    load_tile<T, D>(qs, q + qoff * D, q0, tq);
    load_tile<T, D>(dos, dout + qoff * D, q0, tq);
    __syncthreads();
    row_stats<T, D>(dos, o + qoff * D, lse + qoff,
                    glse != nullptr ? glse + qoff : nullptr, q0, tq, lse_s, delta_s);
    __syncthreads();

    // Thread (ty, tx) holds k rows ty + 16*i and q columns tx + 16*j.
    float st[4][4], dpt[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) st[i][j] = dpt[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[4], w[4], b[4], g[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = to_f(ks[(ty + 16 * i) * LD + d]);
        w[i] = to_f(vs[(ty + 16 * i) * LD + d]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        b[j] = to_f(qs[(tx + 16 * j) * LD + d]);
        g[j] = to_f(dos[(tx + 16 * j) * LD + d]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          st[i][j] = fmaf(a[i], b[j], st[i][j]);
          dpt[i][j] = fmaf(w[i], g[j], dpt[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int kp = k0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
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
    for (int c = 0; c < kTile; ++c) {
      float pa[4], sa[4], gb[CJ], qb[CJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pa[i] = pts[(ty + 16 * i) * LDF + c];
        sa[i] = to_f(dsts[(ty + 16 * i) * LDP + c]);
      }
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        gb[j] = to_f(dos[c * LD + tx + 16 * j]);
        qb[j] = to_f(qs[c * LD + tx + 16 * j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) {
          acc_v[i][j] = fmaf(pa[i], gb[j], acc_v[i][j]);
          acc_k[i][j] = fmaf(sa[i], qb[j], acc_k[i][j]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
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

// Dynamic shared memory of each kernel, in bytes.
template <typename T, int D>
constexpr size_t fwd_smem() {
  return sizeof(T) * (3 * kTile * padded<T>(D) + kTile * padded<T>(kTile));
}
template <typename T, int D>
constexpr size_t dq_smem() {
  return sizeof(T) * (4 * kTile * padded<T>(D) + kTile * padded<T>(kTile)) +
         sizeof(float) * 2 * kTile;
}
template <typename T, int D>
constexpr size_t dkv_smem() {
  return sizeof(T) * (4 * kTile * padded<T>(D) + kTile * padded<T>(kTile)) +
         sizeof(float) * (kTile * padded<float>(kTile) + 2 * kTile);
}

template <typename Kern>
cudaError_t allow_smem(Kern kern, size_t bytes) {
  // Above 48 KB a kernel must opt in to its dynamic shared memory.
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T, int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o,
                       void* lse, int bh, int tq, int tk, int causal,
                       cudaStream_t stream) {
  const size_t smem = fwd_smem<T, D>();
  cudaError_t err = allow_smem(fwd_kernel<T, D>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((tq + kTile - 1) / kTile, bh);
  fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      tq, tk, causal, 1.0f / sqrtf(static_cast<float>(D)));
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* o, const void* dout, const void* lse,
                      const void* glse, void* dq, int bh, int tq, int tk,
                      int causal, cudaStream_t stream) {
  const size_t smem = dq_smem<T, D>();
  cudaError_t err = allow_smem(bwd_dq_kernel<T, D>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((tq + kTile - 1) / kTile, bh);
  bwd_dq_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(o),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(glse), static_cast<T*>(dq), tq, tk, causal,
      1.0f / sqrtf(static_cast<float>(D)));
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* o, const void* dout, const void* lse,
                       const void* glse, void* dk, void* dv, int bh, int tq,
                       int tk, int causal, cudaStream_t stream) {
  const size_t smem = dkv_smem<T, D>();
  cudaError_t err = allow_smem(bwd_dkv_kernel<T, D>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((tk + kTile - 1) / kTile, bh);
  bwd_dkv_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(o),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(glse), static_cast<T*>(dk),
      static_cast<T*>(dv), tq, tk, causal, 1.0f / sqrtf(static_cast<float>(D)));
  return cudaGetLastError();
}

}  // namespace

// Plain C interface. dtype: 0 = f32, 1 = bf16. lse (forward) and glse (both
// backward passes) may be NULL. Each returns the launch's cudaGetLastError()
// (cudaErrorInvalidValue for a shape or type outside the kernels' scope); it
// never synchronises.
#define TFO_DISPATCH(DTYPE, D, CALL_F32_64, CALL_F32_128, CALL_BF16_64, CALL_BF16_128) \
  if ((DTYPE) == 0 && (D) == 64) return static_cast<int>(CALL_F32_64);                 \
  if ((DTYPE) == 0 && (D) == 128) return static_cast<int>(CALL_F32_128);               \
  if ((DTYPE) == 1 && (D) == 64) return static_cast<int>(CALL_BF16_64);                \
  if ((DTYPE) == 1 && (D) == 128) return static_cast<int>(CALL_BF16_128);              \
  return static_cast<int>(cudaErrorInvalidValue);

extern "C" int tfo_flash_fwd(const void* q, const void* k, const void* v,
                             void* o, void* lse, int bh, int tq, int tk, int d,
                             int dtype, int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  TFO_DISPATCH(dtype, d,
               (launch_fwd<float, 64>(q, k, v, o, lse, bh, tq, tk, causal, s)),
               (launch_fwd<float, 128>(q, k, v, o, lse, bh, tq, tk, causal, s)),
               (launch_fwd<__nv_bfloat16, 64>(q, k, v, o, lse, bh, tq, tk, causal, s)),
               (launch_fwd<__nv_bfloat16, 128>(q, k, v, o, lse, bh, tq, tk, causal, s)))
}

extern "C" int tfo_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* o, const void* dout,
                                const void* lse, const void* glse, void* dq,
                                int bh, int tq, int tk, int d, int dtype,
                                int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  TFO_DISPATCH(dtype, d,
               (launch_dq<float, 64>(q, k, v, o, dout, lse, glse, dq, bh, tq, tk, causal, s)),
               (launch_dq<float, 128>(q, k, v, o, dout, lse, glse, dq, bh, tq, tk, causal, s)),
               (launch_dq<__nv_bfloat16, 64>(q, k, v, o, dout, lse, glse, dq, bh, tq, tk, causal, s)),
               (launch_dq<__nv_bfloat16, 128>(q, k, v, o, dout, lse, glse, dq, bh, tq, tk, causal, s)))
}

extern "C" int tfo_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* o, const void* dout,
                                 const void* lse, const void* glse, void* dk,
                                 void* dv, int bh, int tq, int tk, int d,
                                 int dtype, int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  TFO_DISPATCH(dtype, d,
               (launch_dkv<float, 64>(q, k, v, o, dout, lse, glse, dk, dv, bh, tq, tk, causal, s)),
               (launch_dkv<float, 128>(q, k, v, o, dout, lse, glse, dk, dv, bh, tq, tk, causal, s)),
               (launch_dkv<__nv_bfloat16, 64>(q, k, v, o, dout, lse, glse, dk, dv, bh, tq, tk, causal, s)),
               (launch_dkv<__nv_bfloat16, 128>(q, k, v, o, dout, lse, glse, dk, dv, bh, tq, tk, causal, s)))
}
