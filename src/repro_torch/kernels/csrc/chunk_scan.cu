// The SSD chunk kernels for Hopper (sm_90a): chunk_local and chunk_apply.
//
// Replace repro/kernels/chunk_scan.py:chunk_local and :chunk_apply, the
// Pallas TPU kernels of the two local phases of the Mamba2 scan's
// reduce-then-scan (kernels/ops.py:ssd_scan).  The global phase, the
// inter-chunk scan of (decay, state) summaries, runs outside the kernels.
//
// What they compute, per flattened (batch, head, chunk) index g, with
// c, b (L, dk), v (L, dv) and ca (L) the chunk's inclusive cumulative log
// decay, all in float32 arithmetic:
//   chunk_local:  att = C B^T                                   (L x L)
//                 D[t][s] = exp(ca[t] - ca[s]) for s <= t, else 0
//                 y_intra = (att . D) V          -> (L, dv) in v's type
//                 s = (B . exp(ca[L-1] - ca))^T V -> (dk, dv) float32
//   chunk_apply:  y = y_intra + (C . exp(ca)) S_prev -> (L, dv) in
//                 y_intra's type.
// The decay is only ever exponentiated below the diagonal: above it the
// deltas are positive and overflow, and the TPU kernel masks them to -1e30
// before exp for the same reason (exp(-1e30) is 0, and here the product is
// never formed).  c, b, v and y_intra are float32 or bfloat16 (one type a
// call); ca, s and s_prev are float32.  y_intra is rounded to v's type
// between the two kernels, as the TPU kernels round it.
//
// What bounds them, at the serving path's shape (G = 1792, L = 128,
// dk = dv = 64, bf16): chunk_local reads 3 x 29 MB and writes 29 MB of
// y_intra and 29 MB of s, ~148 MB (~44 us at 3.35 TB/s), and does 9.4
// GFLOP, ~140 us on the f32 CUDA cores (67 TFLOP/s): a float32 kernel is
// bound by its operations.  chunk_apply moves ~119 MB (~35 us) for 1.9
// GFLOP (~28 us): bytes.
//
// Design.  One block of 256 threads a g.  chunk_local stages C, B and V
// (converted to float32; C and B rows padded by one float so a warp reading
// a column hits 32 banks) and the decay weights in shared memory, then
// computes the state summary and y_intra in panels of 16 rows: the panel's
// masked scores (16 x L) go to shared memory and are multiplied into V.
// Each thread keeps a small register tile (8 scores, 8 outputs) so a
// shared-memory load feeds several fused multiply-adds.  chunk_apply stages
// C . exp(ca) and S_prev and computes 16-row panels the same way.  The
// build uses -fmad=false; the accumulations are explicit fmaf, the
// products the TPU kernel rounds separately (B . decay, C . exp(ca), att . D)
// are rounded separately here.
//
// This is the simple, correct kernel.  Tensor cores (wgmma on bf16
// operands), TMA staging and several chunks a block are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxL = 128;
constexpr int kMaxD = 128;
constexpr int kPanel = 16;

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

size_t local_smem_bytes(int L, int dk, int dv) {
  const size_t ldk = dk + 1;
  return sizeof(float) *
         (2 * L * ldk + (size_t)L * dv + 2 * (size_t)L + kPanel * (L + 1));
}

size_t apply_smem_bytes(int L, int dk, int dv) {
  return sizeof(float) * ((size_t)L * (dk + 1) + (size_t)dk * dv);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
chunk_local_kernel(const T* __restrict__ c, const T* __restrict__ b,
                   const T* __restrict__ v, const float* __restrict__ ca,
                   T* __restrict__ y, float* __restrict__ s,
                   int L, int dk, int dv) {
  extern __shared__ float smem[];
  const int ldk = dk + 1;
  const int lp = L + 1;
  float* cs = smem;               // L x ldk
  float* bs = cs + L * ldk;       // L x ldk
  float* vs = bs + L * ldk;       // L x dv
  float* cas = vs + L * dv;       // L
  float* w = cas + L;             // L: exp(ca[L-1] - ca[t])
  float* ps = w + L;              // kPanel x lp: masked scores of a panel

  const long long g = blockIdx.x;
  const int tid = threadIdx.x;
  const T* cg = c + g * L * dk;
  const T* bg = b + g * L * dk;
  const T* vg = v + g * L * dv;
  for (int i = tid; i < L * dk; i += kThreads) {
    const int t = i / dk, k = i - t * dk;
    cs[t * ldk + k] = to_f32(cg[i]);
    bs[t * ldk + k] = to_f32(bg[i]);
  }
  for (int i = tid; i < L * dv; i += kThreads) vs[i] = to_f32(vg[i]);
  for (int i = tid; i < L; i += kThreads) cas[i] = ca[g * L + i];
  __syncthreads();
  for (int i = tid; i < L; i += kThreads) w[i] = expf(cas[L - 1] - cas[i]);
  __syncthreads();

  // State summary s[k][col] = sum_t (B[t][k] * w[t]) V[t][col]: each thread
  // 8 rows k (a warp shares them) by up to two columns.
  {
    const int col = tid % 64;
    const int kr = tid / 64;                 // 0..3
    float* sg = s + g * dk * dv;
    for (int k0 = 0; k0 < dk; k0 += 32) {
      float acc[8][2];
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = 0.f;
      for (int t = 0; t < L; ++t) {
        const float wt = w[t];
        const float v0 = col < dv ? vs[t * dv + col] : 0.f;
        const float v1 = col + 64 < dv ? vs[t * dv + col + 64] : 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int k = min(k0 + kr + 4 * j, dk - 1);
          const float bw = bs[t * ldk + k] * wt;
          acc[j][0] = fmaf(bw, v0, acc[j][0]);
          acc[j][1] = fmaf(bw, v1, acc[j][1]);
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int k = k0 + kr + 4 * j;
        if (k < dk) {
          if (col < dv) sg[k * dv + col] = acc[j][0];
          if (col + 64 < dv) sg[k * dv + col + 64] = acc[j][1];
        }
      }
    }
  }

  // y_intra, kPanel rows at a time.
  T* yg = y + g * L * dv;
  for (int p0 = 0; p0 < L; p0 += kPanel) {
    const int smax = min(p0 + kPanel, L);    // keys a panel row can see
    {
      // Scores: thread (key si, rows p0 + r0 + 2j).
      const int si = tid % kMaxL;
      const int r0 = tid / kMaxL;            // 0..1
      if (si < smax) {
        float acc[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[j] = 0.f;
        for (int k = 0; k < dk; ++k) {
          const float bk = bs[si * ldk + k];
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int r = min(p0 + r0 + 2 * j, L - 1);
            acc[j] = fmaf(cs[r * ldk + k], bk, acc[j]);
          }
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int r = p0 + r0 + 2 * j;
          float pr = 0.f;
          if (r < L && si <= r) pr = acc[j] * expf(cas[r] - cas[si]);
          ps[(r0 + 2 * j) * lp + si] = pr;
        }
      }
    }
    __syncthreads();
    {
      // Outputs: thread (rows p0 + r0 + 4j, columns col and col + 64).
      const int col = tid % 64;
      const int r0 = tid / 64;               // 0..3
      float acc[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[j][0] = acc[j][1] = 0.f;
      for (int si = 0; si < smax; ++si) {
        const float v0 = col < dv ? vs[si * dv + col] : 0.f;
        const float v1 = col + 64 < dv ? vs[si * dv + col + 64] : 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float pr = ps[(r0 + 4 * j) * lp + si];
          acc[j][0] = fmaf(pr, v0, acc[j][0]);
          acc[j][1] = fmaf(pr, v1, acc[j][1]);
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = p0 + r0 + 4 * j;
        if (r < L) {
          if (col < dv) yg[r * dv + col] = from_f32<T>(acc[j][0]);
          if (col + 64 < dv) yg[r * dv + col + 64] = from_f32<T>(acc[j][1]);
        }
      }
    }
    __syncthreads();
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
chunk_apply_kernel(const T* __restrict__ c, const float* __restrict__ ca,
                   const T* __restrict__ yin, const float* __restrict__ sp,
                   T* __restrict__ out, int L, int dk, int dv) {
  extern __shared__ float smem[];
  const int ldk = dk + 1;
  float* cw = smem;               // L x ldk: C . exp(ca)
  float* sps = cw + L * ldk;      // dk x dv: S_prev

  const long long g = blockIdx.x;
  const int tid = threadIdx.x;
  const T* cg = c + g * L * dk;
  const float* cag = ca + g * L;
  for (int i = tid; i < L * dk; i += kThreads) {
    const int t = i / dk, k = i - t * dk;
    cw[t * ldk + k] = to_f32(cg[i]) * expf(cag[t]);
  }
  const float* spg = sp + g * dk * dv;
  for (int i = tid; i < dk * dv; i += kThreads) sps[i] = spg[i];
  __syncthreads();

  const int col = tid % 64;
  const int r0 = tid / 64;                   // 0..3
  const T* yg = yin + g * L * dv;
  T* og = out + g * L * dv;
  for (int p0 = 0; p0 < L; p0 += kPanel) {
    float acc[4][2];
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[j][0] = acc[j][1] = 0.f;
    for (int k = 0; k < dk; ++k) {
      const float s0 = col < dv ? sps[k * dv + col] : 0.f;
      const float s1 = col + 64 < dv ? sps[k * dv + col + 64] : 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = min(p0 + r0 + 4 * j, L - 1);
        const float cv = cw[r * ldk + k];
        acc[j][0] = fmaf(cv, s0, acc[j][0]);
        acc[j][1] = fmaf(cv, s1, acc[j][1]);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = p0 + r0 + 4 * j;
      if (r < L) {
        if (col < dv) {
          const int at = r * dv + col;
          og[at] = from_f32<T>(to_f32(yg[at]) + acc[j][0]);
        }
        if (col + 64 < dv) {
          const int at = r * dv + col + 64;
          og[at] = from_f32<T>(to_f32(yg[at]) + acc[j][1]);
        }
      }
    }
  }
}

bool shape_ok(int g, int L, int dk, int dv) {
  return g >= 1 && L >= 1 && L <= kMaxL && dk >= 8 && dk <= kMaxD &&
         dk % 8 == 0 && dv >= 8 && dv <= kMaxD && dv % 8 == 0;
}

template <typename K, typename... Args>
int launch_with_smem(K kernel, size_t smem, int g, cudaStream_t st,
                     Args... args) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<g, kThreads, smem, st>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (c, b, v and y); ca (g, L) and s (g, dk, dv)
// float32; all contiguous.  Returns a cudaError_t, or cudaErrorInvalidValue
// for a shape outside L <= 128, dk, dv in 8..128 and multiples of 8.
extern "C" int chunk_local_launch(int dtype, const void* c, const void* b,
                                  const void* v, const void* ca, void* y,
                                  void* s, int g, int L, int dk, int dv,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!shape_ok(g, L, dk, dv)) return (int)cudaErrorInvalidValue;
  const size_t smem = local_smem_bytes(L, dk, dv);
  const float* caf = static_cast<const float*>(ca);
  float* sf = static_cast<float*>(s);
  if (dtype == 0) {
    return launch_with_smem(
        chunk_local_kernel<float>, smem, g, st, static_cast<const float*>(c),
        static_cast<const float*>(b), static_cast<const float*>(v), caf,
        static_cast<float*>(y), sf, L, dk, dv);
  }
  if (dtype == 1) {
    using B = __nv_bfloat16;
    return launch_with_smem(
        chunk_local_kernel<B>, smem, g, st, static_cast<const B*>(c),
        static_cast<const B*>(b), static_cast<const B*>(v), caf,
        static_cast<B*>(y), sf, L, dk, dv);
  }
  return (int)cudaErrorInvalidValue;
}

// dtype: 0 float32, 1 bfloat16 (c, y_intra and out); ca (g, L) and s_prev
// (g, dk, dv) float32; all contiguous.
extern "C" int chunk_apply_launch(int dtype, const void* c, const void* ca,
                                  const void* y_intra, const void* s_prev,
                                  void* out, int g, int L, int dk, int dv,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!shape_ok(g, L, dk, dv)) return (int)cudaErrorInvalidValue;
  const size_t smem = apply_smem_bytes(L, dk, dv);
  const float* caf = static_cast<const float*>(ca);
  const float* spf = static_cast<const float*>(s_prev);
  if (dtype == 0) {
    return launch_with_smem(
        chunk_apply_kernel<float>, smem, g, st, static_cast<const float*>(c),
        caf, static_cast<const float*>(y_intra), spf,
        static_cast<float*>(out), L, dk, dv);
  }
  if (dtype == 1) {
    using B = __nv_bfloat16;
    return launch_with_smem(
        chunk_apply_kernel<B>, smem, g, st, static_cast<const B*>(c), caf,
        static_cast<const B*>(y_intra), spf, static_cast<B*>(out), L, dk,
        dv);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* chunk_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
