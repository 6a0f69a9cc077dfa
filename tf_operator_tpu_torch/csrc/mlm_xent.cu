// The MLM head's masked cross entropy and its gradient, in one pass over
// the bf16 logits (ops/mlm_xent.py).
//
// Replaces no TPU kernel: the JAX package leaves BERT's loss to XLA, which
// fuses the log-softmax, the gather and the masked sum. The port's plain
// route casts the [N, V] bf16 logits to f32 and runs log_softmax, gather and
// their backward as separate kernels: four f32 tensors of the logits' size
// and their casts, ~70-80 GB of traffic a step at BERT's N = 65536 and
// V = 30522. This kernel reads each bf16 row once and, when a gradient is
// wanted, overwrites it in place with that gradient in bf16.
//
// Layout: logits [N, Vp] bf16, Vp a multiple of 64 (the decoder's rows
// padded with zeros, so cuBLAS's TMA products can write and read the
// buffer); only the first V columns are the vocabulary. One block a row:
//   m = max z, s = sum exp(z - m), lse = m + log s (f32, columns < V);
//   nll = lse - z[target]; the row's mask * nll goes to partial[row];
//   with want_grad, z_j becomes bf16((exp(z_j - lse) - [j == target]) * w)
//   with w = mask * (1 / max(count, 1)), and 0 at columns >= V.
// count (the mask's sum) is read from device memory, so nothing syncs and
// the launch can be captured. The loss = sum(partial) / max(count, 1) is
// taken by the last block to finish (an integer ticket), in a fixed order:
// no float atomics, so a replay and an eager call agree bit for bit. The
// ticket is a device global, 0 at load and again after each launch, so
// launches on one device must not overlap (one stream, or ordered streams).
//
// Bound: bytes. The row is read once and written once: 2 x N x Vp x 2 bytes
// (8.0 GB at N 65536, Vp 30528: 2.39 ms at 3.35 TB/s); two exp a column.
// A row of up to 512 x 8 x 8 = 32768 columns stays in registers (16-byte
// loads, eight a thread) between the read and the write; a longer row is
// read again for its gradient.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
// 16-byte vectors a thread holds: a row of up to THREADS x NV x 8 columns
// stays in registers.
constexpr int NV = 8;
constexpr float LOG2E = 1.4426950408889634f;

// The blocks of a launch that have finished; the last one resets it.
__device__ unsigned int g_ticket = 0;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The max of a and b, NaN if either is (fmaxf drops a NaN).
__device__ __forceinline__ float fmax_nan(float a, float b) {
  float y;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(y) : "f"(a), "f"(b));
  return y;
}

__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// Round to nearest even (NaN kept a quiet NaN), as __float2bfloat16_rn.
__device__ __forceinline__ uint32_t to_bf16(float f) {
  uint32_t u = __float_as_uint(f);
  if ((u & 0x7fffffffu) > 0x7f800000u) return 0x7fc0u;
  return (u + 0x7fffu + ((u >> 16) & 1u)) >> 16;
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  return to_bf16(lo) | (to_bf16(hi) << 16);
}

__device__ __forceinline__ void unpack(const uint4& v, float z[8]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    z[2 * i] = bf16_lo(w[i]);
    z[2 * i + 1] = bf16_hi(w[i]);
  }
}

// Every thread gets the block's max (sum) of v. The xor butterfly gives
// every lane the same bits, and the order is fixed: deterministic.
template <bool MAX>
__device__ __forceinline__ float block_reduce(float v, float* smem) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float u = __shfl_xor_sync(0xffffffffu, v, o);
    v = MAX ? fmaxf(v, u) : v + u;
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();  // the previous reduction's reads of smem are done
  if (lane == 0) smem[warp] = v;
  __syncthreads();
  v = lane < WARPS ? smem[lane] : (MAX ? -INFINITY : 0.f);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float u = __shfl_xor_sync(0xffffffffu, v, o);
    v = MAX ? fmaxf(v, u) : v + u;
  }
  return v;
}

// One thread's running (max, sum of exp) over the valid columns of vectors
// it holds; returns the updated pair through m and s.
__device__ __forceinline__ void fold(const uint4 (&buf)[NV], int first_vec, int nvec,
                                     int vocab, float& m, float& s) {
  float tm = -INFINITY;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int vec = first_vec + k * THREADS;
    if (vec >= nvec) break;
    float z[8];
    unpack(buf[k], z);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      if (vec * 8 + e < vocab) tm = fmax_nan(tm, z[e]);
    }
  }
  if (tm == -INFINITY) return;  // no valid column in this tile
  const float nm = fmax_nan(m, tm);  // a NaN logit makes s, so the loss, NaN
  s = (m == -INFINITY) ? 0.f : s * ex2((m - nm) * LOG2E);
  const float off = -nm * LOG2E;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int vec = first_vec + k * THREADS;
    if (vec >= nvec) break;
    float z[8];
    unpack(buf[k], z);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      if (vec * 8 + e < vocab) s += ex2(fmaf(z[e], LOG2E, off));
    }
  }
  m = nm;
}

// Overwrite the tile's vectors with the gradient.
__device__ __forceinline__ void write_grad(uint4* row, const uint4 (&buf)[NV], int first_vec,
                                           int nvec, int vocab, long long target, float lse,
                                           float w) {
  const float off = -lse * LOG2E;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int vec = first_vec + k * THREADS;
    if (vec >= nvec) break;
    float z[8], g[8];
    unpack(buf[k], z);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int col = vec * 8 + e;
      const float p = ex2(fmaf(z[e], LOG2E, off));
      g[e] = col < vocab ? (p - (col == target ? 1.f : 0.f)) * w : 0.f;
    }
    row[vec] = make_uint4(pack(g[0], g[1]), pack(g[2], g[3]), pack(g[4], g[5]),
                          pack(g[6], g[7]));
  }
}

__device__ __forceinline__ void load(const uint4* row, uint4 (&buf)[NV], int first_vec,
                                     int nvec) {
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int vec = first_vec + k * THREADS;
    if (vec < nvec) buf[k] = row[vec];
  }
}

// RESIDENT: the whole row fits one tile of THREADS x NV vectors and stays
// in registers (idle threads past a short row); else tiles of that size,
// read twice with a gradient.
template <bool RESIDENT>
__global__ void __launch_bounds__(THREADS, 2)
mlm_xent_kernel(uint16_t* __restrict__ logits, const long long* __restrict__ targets,
                const float* __restrict__ mask, const float* __restrict__ count,
                float* __restrict__ partial, float* __restrict__ loss, int vocab, int vp, int want_grad) {
  __shared__ float smem[WARPS];
  __shared__ bool last;
  const int r = blockIdx.x;
  const int nvec = vp / 8;
  constexpr int TILE = THREADS * NV;
  uint4* row = reinterpret_cast<uint4*>(logits + static_cast<size_t>(r) * vp);
  const long long target = targets[r];
  // Read before any write of the row.
  const float zt = (target >= 0 && target < vocab)
                       ? __uint_as_float(static_cast<uint32_t>(
                             logits[static_cast<size_t>(r) * vp + target]) << 16)
                       : __int_as_float(0x7fc00000);

  uint4 buf[NV];
  float m = -INFINITY, s = 0.f;
  for (int base = 0; base < nvec; base += TILE) {
    load(row, buf, base + threadIdx.x, nvec);
    fold(buf, base + threadIdx.x, nvec, vocab, m, s);
    if (RESIDENT) break;
  }
  const float bm = block_reduce<true>(m, smem);
  const float bs = block_reduce<false>(m == -INFINITY ? 0.f : s * ex2((m - bm) * LOG2E), smem);
  const float lse = bm + logf(bs);
  const float mk = mask[r];

  if (want_grad) {
    const float w = mk * (1.f / fmaxf(count[0], 1.f));
    if (RESIDENT) {
      write_grad(row, buf, threadIdx.x, nvec, vocab, target, lse, w);
    } else {
      for (int base = 0; base < nvec; base += TILE) {
        load(row, buf, base + threadIdx.x, nvec);
        write_grad(row, buf, base + threadIdx.x, nvec, vocab, target, lse, w);
      }
    }
  }

  if (threadIdx.x == 0) {
    partial[r] = mk * (lse - zt);
    __threadfence();
    last = atomicAdd(&g_ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  float acc = 0.f;
  for (int i = threadIdx.x; i < static_cast<int>(gridDim.x); i += THREADS) {
    acc += __ldcg(partial + i);
  }
  acc = block_reduce<false>(acc, smem);
  if (threadIdx.x == 0) {
    loss[0] = acc / fmaxf(count[0], 1.f);
    g_ticket = 0u;
  }
}

template <bool RESIDENT>
cudaError_t launch(void* logits, const void* targets, const void* mask, const void* count,
                   void* partial, void* loss, int n, int vocab, int vp, int want_grad,
                   cudaStream_t stream) {
  mlm_xent_kernel<RESIDENT><<<n, THREADS, 0, stream>>>(
      static_cast<uint16_t*>(logits), static_cast<const long long*>(targets),
      static_cast<const float*>(mask), static_cast<const float*>(count),
      static_cast<float*>(partial), static_cast<float*>(loss), vocab, vp, want_grad);
  return cudaGetLastError();
}

}  // namespace

// logits [n, vp] bf16 (16-byte aligned, vp % 8 == 0, vocab <= vp), targets
// [n] int64, mask [n] f32, count one f32 (the mask's sum), partial [n] f32
// scratch, loss one f32. Returns 0, a cudaError_t of the launch, or 1000 for
// arguments the kernel does not take.
extern "C" int tfo_mlm_xent(void* logits, const void* targets, const void* mask,
                            const void* count, void* partial, void* loss, int n,
                            int vocab, int vp, int want_grad, void* stream) {
  if (n <= 0 || vocab <= 0 || vp < vocab || vp % 8 != 0 ||
      reinterpret_cast<uintptr_t>(logits) % 16 != 0) {
    return 1000;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vp / 8 <= NV * THREADS) {
    return launch<true>(logits, targets, mask, count, partial, loss, n, vocab, vp, want_grad,
                        s);
  }
  return launch<false>(logits, targets, mask, count, partial, loss, n, vocab, vp, want_grad,
                       s);
}
