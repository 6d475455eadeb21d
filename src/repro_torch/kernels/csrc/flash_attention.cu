// Causal flash attention for Hopper (sm_90a): flash_attention.
//
// Replaces repro/kernels/flash_attention.py:flash_attention, the Pallas TPU
// kernel behind kernels/ops.py:attention's "pallas" backend.
//
// What it computes, per (bh) with q (lq, d), k and v (lk, d):
//   s = (q k^T) * scale, in float32;
//   causal: s[r][c] = -1e30 where r < c (the mask is aligned top-left, as
//           the TPU kernel's rows >= cols; it agrees with a bottom-right
//           mask only when lq == lk, as in prefill);
//   out = softmax(s) v by an online softmax over key tiles (running max m,
//         denominator l, output accumulator), a denominator of 0 read as 1,
//         written in q's type.
// Key tiles wholly above the diagonal are skipped, as the TPU kernel skips
// its kv blocks there; the entries masked inside a visited tile weigh
// exp(-1e30 - m) = 0.  q, k, v and out are float32 or bfloat16.
//
// What bounds it, at the serving path's shape (BH = 128, L = 512, d = 112,
// bf16): it reads q, k, v once and writes out once, ~59 MB (~17.5 us at
// 3.35 TB/s); its causal products are ~7.5 GFLOP, ~8 us at the bf16 tensor
// peak but ~110 us on the f32 CUDA cores this kernel uses: operations.
//
// Design.  One block of 256 threads a (bh, 64-row query tile).  The query
// tile and each 64-row key and value tile are staged in shared memory as
// float32 (q and k rows padded by one float, so the warp reading a column
// hits 32 banks).  Scores: each thread a 8 x 2 register tile.  Softmax:
// four threads a row, reduced with warp shuffles; the row's max, denominator
// and correction live in shared memory.  The output accumulator stays in
// registers, 2 rows x d/8 columns a thread (d <= 128, a multiple of 8).
// The tiling differs from the TPU kernel's (256 x 512 blocks); the result
// does not depend on it beyond float32 rounding, and the wrapper keeps the
// TPU kernel's block checks.
//
// This is the simple, correct kernel.  wgmma on bf16 operands, TMA staging
// and a ring of key tiles are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kMaxD = 128;
constexpr float kNegInf = -1e30f;   // the TPU kernel's NEG_INF

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

size_t smem_bytes(int d) {
  const size_t ld = d + 1;
  return sizeof(float) *
         (kBQ * ld + kBK * ld + (size_t)kBK * d + kBQ * (kBK + 1) + 3 * kBQ);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out,
             int lq, int lk, int d, float scale, int causal) {
  extern __shared__ float smem[];
  const int ld = d + 1;
  constexpr int lsp = kBK + 1;
  float* qs = smem;               // kBQ x ld
  float* ks = qs + kBQ * ld;      // kBK x ld
  float* vs = ks + kBK * ld;      // kBK x d
  float* ss = vs + kBK * d;       // kBQ x lsp: scores, then probabilities
  float* ms = ss + kBQ * lsp;     // kBQ: running max
  float* ls = ms + kBQ;           // kBQ: running denominator
  float* cs = ls + kBQ;           // kBQ: this tile's correction

  const long long bh = blockIdx.x;
  const int q_start = blockIdx.y * kBQ;
  const int tid = threadIdx.x;
  const T* qg = q + bh * lq * d;
  const T* kg = k + bh * lk * d;
  const T* vg = v + bh * lk * d;

  for (int i = tid; i < kBQ * d; i += kThreads) {
    const int r = i / d, c = i - r * d;
    const int row = q_start + r;
    qs[r * ld + c] = row < lq ? to_f32(qg[(long long)row * d + c]) : 0.f;
  }
  if (tid < kBQ) {
    ms[tid] = kNegInf;
    ls[tid] = 0.f;
  }

  // Output tile: rows ar and ar + 32, columns oc + 8j.
  const int ar = tid / 8;
  const int oc = tid % 8;
  const int nd = d / 8;
  float acc[2][kMaxD / 8];
#pragma unroll
  for (int j = 0; j < kMaxD / 8; ++j) acc[0][j] = acc[1][j] = 0.f;

  // Score tile: rows sr + 8j (sr the warp), columns sc and sc + 32.
  const int sr = tid / 32;
  const int sc = tid % 32;
  // Softmax: row tid / 4, entries part + 4i.
  const int prow = tid / 4;
  const int part = tid % 4;

  const int n_kv = (lk + kBK - 1) / kBK;
  const int last = causal ? min(n_kv - 1, (q_start + kBQ - 1) / kBK)
                          : n_kv - 1;
  for (int kt = 0; kt <= last; ++kt) {
    const int k_start = kt * kBK;
    __syncthreads();   // the previous tile's ks, vs and ss are consumed
    for (int i = tid; i < kBK * d; i += kThreads) {
      const int r = i / d, c = i - r * d;
      const int row = k_start + r;
      const bool in = row < lk;
      ks[r * ld + c] = in ? to_f32(kg[(long long)row * d + c]) : 0.f;
      vs[r * d + c] = in ? to_f32(vg[(long long)row * d + c]) : 0.f;
    }
    __syncthreads();

    {
      float sacc[8][2];
#pragma unroll
      for (int j = 0; j < 8; ++j) sacc[j][0] = sacc[j][1] = 0.f;
      for (int kk = 0; kk < d; ++kk) {
        const float k0 = ks[sc * ld + kk];
        const float k1 = ks[(sc + 32) * ld + kk];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float qv = qs[(sr + 8 * j) * ld + kk];
          sacc[j][0] = fmaf(qv, k0, sacc[j][0]);
          sacc[j][1] = fmaf(qv, k1, sacc[j][1]);
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int row = q_start + sr + 8 * j;
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          const int col = k_start + sc + 32 * m;
          float sv = sacc[j][m] * scale;
          if (col >= lk) {
            sv = -INFINITY;            // past the keys: weighs nothing
          } else if (causal && row < col) {
            sv = kNegInf;
          }
          ss[(sr + 8 * j) * lsp + sc + 32 * m] = sv;
        }
      }
    }
    __syncthreads();

    {
      float mx = -INFINITY;
#pragma unroll
      for (int i = 0; i < kBK / 4; ++i)
        mx = fmaxf(mx, ss[prow * lsp + part + 4 * i]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_prev = ms[prow];
      const float m_new = fmaxf(m_prev, mx);
      const float corr = expf(m_prev - m_new);
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < kBK / 4; ++i) {
        const int at = prow * lsp + part + 4 * i;
        const float p = expf(ss[at] - m_new);
        ss[at] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      __syncwarp();
      if (part == 0) {
        ls[prow] = corr * ls[prow] + sum;
        ms[prow] = m_new;
        cs[prow] = corr;
      }
    }
    __syncthreads();

    {
      const float c0 = cs[ar];
      const float c1 = cs[ar + 32];
#pragma unroll
      for (int j = 0; j < kMaxD / 8; ++j) {
        acc[0][j] *= c0;
        acc[1][j] *= c1;
      }
      for (int s = 0; s < kBK; ++s) {
        const float p0 = ss[ar * lsp + s];
        const float p1 = ss[(ar + 32) * lsp + s];
#pragma unroll
        for (int j = 0; j < kMaxD / 8; ++j) {
          if (j < nd) {
            const float vv = vs[s * d + oc + 8 * j];
            acc[0][j] = fmaf(p0, vv, acc[0][j]);
            acc[1][j] = fmaf(p1, vv, acc[1][j]);
          }
        }
      }
    }
  }
  __syncthreads();

  T* og = out + bh * lq * d;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = ar + 32 * i;
    const int row = q_start + r;
    if (row >= lq) continue;
    float denom = ls[r];
    if (denom == 0.f) denom = 1.f;
#pragma unroll
    for (int j = 0; j < kMaxD / 8; ++j) {
      if (j < nd) {
        og[(long long)row * d + oc + 8 * j] = from_f32<T>(acc[i][j] / denom);
      }
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int bh,
           int lq, int lk, int d, float scale, int causal, cudaStream_t st) {
  const size_t smem = smem_bytes(d);
  cudaError_t e = cudaFuncSetAttribute(
      flash_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(bh, (lq + kBQ - 1) / kBQ);
  flash_kernel<T><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lq, lk, d, scale,
      causal);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (q, k, v and out); q (bh, lq, d), k and v
// (bh, lk, d), all contiguous.  Returns a cudaError_t, or
// cudaErrorInvalidValue for d outside 8..128 or not a multiple of 8.
extern "C" int flash_attention_launch(int dtype, const void* q, const void* k,
                                      const void* v, void* out, int bh,
                                      int lq, int lk, int d, float scale,
                                      int causal, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bh < 1 || lq < 1 || lk < 1 || d < 8 || d > kMaxD || d % 8)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float>(q, k, v, out, bh, lq, lk, d, scale, causal, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, out, bh, lq, lk, d, scale, causal,
                                 st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
