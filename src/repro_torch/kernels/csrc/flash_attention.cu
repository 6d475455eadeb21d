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
// exp(-1e30 - m) = 0, keys past lk weigh exp(-inf) = 0.
//
// What bounds it, at the serving path's shape (BH = 128, L = 512, d = 112,
// bf16): it reads q, k, v once and writes out once, ~59 MB (~17.5 us at
// 3.35 TB/s); its causal products are ~7.5 GFLOP, ~8 us at the bf16
// tensor-core peak: bytes, if the products run on the tensor cores; on the
// f32 CUDA cores (67 TFLOP/s) they alone take ~110 us.
//
// Two kernels, chosen by dtype:
//
// bfloat16: flash_bf16_kernel, the products on the tensor cores through
// wgmma (wgmma_sm90.cuh), float32 accumulators in registers.
//  * One block of two warpgroups (256 threads) a (bh, 128 query rows), a
//    warpgroup 64 rows; the two share each K/V tile, and the heaviest
//    causal query blocks are scheduled first.  (One warpgroup a block took
//    0.088 ms against 0.073 ms at the serving shape, H100 at 700 W.)
//  * The depth is padded to DP, the next multiple of 16 (d = 112 stays 112,
//    d = 40 becomes 48), with zero columns in shared memory, so S = Q K^T
//    is DP / 16 m64n64k16 steps with Q (operand A) and the key tile
//    (operand B) both read from shared memory, K-major as they lie in
//    device memory.
//  * The online softmax runs on S's accumulator fragments: each thread
//    holds 2 rows x 16 columns; row max and denominator by quad shuffles;
//    exp2f on scores pre-scaled by scale * log2(e).
//  * P goes to bf16 in registers, which is exactly the A operand of
//    O += P V (m64n{DP}k16 over the 64 keys); V is operand B from shared
//    memory, read transposed (N-major), so it is staged as it lies.  P is
//    split into two bf16 terms, its rounding and the rest, each multiplied
//    by V: one term alone is off by up to 2^-9 a weight, which on rows of
//    few keys (the causal mask's first rows) exceeds the plain version's
//    tolerance; the split costs half as many tensor-core operations again.
//    The denominator sums the f32 probabilities.
//  * K and V tiles come in as bf16 through a two-stage ring by cp.async
//    (16-byte copies, zero-filled past lk): tile j+1 loads while tile j
//    multiplies.  Shared memory: two Q tiles and two K/V stages,
//    6 x 64 x DP x 2 bytes (84 KB at d = 112), two blocks an SM.
//  * Layout: no swizzle.  Every 64 x DP tile is stored as 8 x 8 core
//    matrices of 128 contiguous bytes, (row / 8, col / 8) at
//    ((row / 8) * DP / 8 + col / 8) * 128 bytes: the simplest layout
//    wgmma's descriptor takes, the same one for all three operands, and
//    cp.async's 16-byte copies land on it whole.  TMA with a 128-byte
//    swizzle is the usual next step; this version does without it.
//
// float32: flash_f32_kernel, the first design, kept because wgmma on f32
// operands runs in TF32, which keeps ~3 decimal digits and would break the
// f32 path's parity with the plain version (lm_check holds ~1e-5).  One
// block of 256 threads a (bh, 64-row query tile), tiles staged as f32 in
// shared memory (q and k rows padded by one float, so a warp reading a
// column hits 32 banks), products on the CUDA cores: scores 8 x 2 a
// thread, softmax four threads a row, the output 2 rows x d/8 columns a
// thread.  It is bound by those f32 operations.
//
// Both tile 64 x 64, unlike the TPU kernel's 256 x 512 blocks; the result
// does not depend on the tiling beyond float32 rounding (and P's bf16
// rounding in the bf16 kernel), and the wrapper keeps the TPU kernel's
// block checks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "wgmma_sm90.cuh"

namespace {

constexpr int kThreads = 256;   // the f32 kernel's block
constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kMaxD = 128;
constexpr float kNegInf = -1e30f;   // the TPU kernel's NEG_INF

// ---------------------------------------------------------------------------
// bfloat16: wgmma
// ---------------------------------------------------------------------------

constexpr int kWG = 128;                 // threads of a warpgroup
constexpr int kQWG = 2;                  // warpgroups (64 query rows each) a block
constexpr int kBF16Threads = kWG * kQWG;

template <int DP>
__host__ __device__ constexpr int tile_bytes() { return kBQ * DP * 2; }

template <int DP>
__host__ __device__ constexpr int bf16_smem_bytes() {
  return (kQWG + 4) * tile_bytes<DP>();   // Q tiles, two K and two V stages
}

// Rows row0..row0+63 of a (rows, d) bf16 matrix into a core-matrix tile;
// rows past `rows` are zero-filled.  Eight neighbouring threads fill one
// 128-byte core matrix; a warp reads 8 rows x 64 contiguous bytes.
template <int DP>
__device__ __forceinline__ void load_tile(unsigned char* tile,
                                          const __nv_bfloat16* g, int row0,
                                          int rows, int d) {
  const int chunks = d / 8;
  for (int i = threadIdx.x; i < kBQ * chunks; i += kBF16Threads) {
    const int rr = i & 7;
    const int rest = i >> 3;
    const int c = rest % chunks;
    const int r = (rest / chunks) * 8 + rr;
    const bool in = row0 + r < rows;
    const __nv_bfloat16* src = g + (long long)(in ? row0 + r : 0) * d + c * 8;
    wgmma::cp_async16(tile + wgmma::cm_offset(r, c, DP), src, in);
  }
}

// The depth padding d..DP-1 of a tile, zeroed once: cp.async never
// writes it.
template <int DP>
__device__ __forceinline__ void zero_pad(unsigned char* tile, int d) {
  const int c0 = d / 8;
  const int pad = DP / 8 - c0;
  for (int i = threadIdx.x; i < kBQ * pad; i += kBF16Threads) {
    const int r = i / pad, c = c0 + i % pad;
    *reinterpret_cast<uint4*>(tile + wgmma::cm_offset(r, c, DP)) =
        make_uint4(0u, 0u, 0u, 0u);
  }
}

template <int DP>
__global__ void __launch_bounds__(kBF16Threads)
flash_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  __nv_bfloat16* __restrict__ out, int lq, int lk, int d,
                  float scale_log2, int causal) {
  extern __shared__ __align__(128) unsigned char tiles[];
  constexpr int kTile = tile_bytes<DP>();
  unsigned char* ks[2] = {tiles + kQWG * kTile, tiles + (kQWG + 1) * kTile};
  unsigned char* vs[2] = {tiles + (kQWG + 2) * kTile,
                          tiles + (kQWG + 3) * kTile};

  const long long bh = blockIdx.x;
  const int q_block = gridDim.y - 1 - blockIdx.y;   // heaviest first
  const int q_start = q_block * kBQ * kQWG;
  const __nv_bfloat16* qg = q + bh * lq * d;
  const __nv_bfloat16* kg = k + bh * lk * d;
  const __nv_bfloat16* vg = v + bh * lk * d;

  // This warpgroup's 64 query rows and their last key tile; the block loads
  // key tiles up to the last one of its last warpgroup.
  const int wg = threadIdx.x / kWG;
  unsigned char* qs = tiles + wg * kTile;
  const int wq_start = q_start + wg * kBQ;
  const int n_kv = (lk + kBK - 1) / kBK;
  const int last = causal ? min(n_kv - 1, (q_start + kQWG * kBQ - 1) / kBK)
                          : n_kv - 1;
  const int my_last = causal ? min(n_kv - 1, (wq_start + kBQ - 1) / kBK)
                             : n_kv - 1;

  if (DP != d) {
    for (int t = 0; t < kQWG + 4; ++t) zero_pad<DP>(tiles + t * kTile, d);
  }
  for (int t = 0; t < kQWG; ++t) {
    load_tile<DP>(tiles + t * kTile, qg, q_start + t * kBQ, lq, d);
  }
  load_tile<DP>(ks[0], kg, 0, lk, d);
  load_tile<DP>(vs[0], vg, 0, lk, d);
  wgmma::cp_async_commit();
  if (last >= 1) {
    load_tile<DP>(ks[1], kg, kBK, lk, d);
    load_tile<DP>(vs[1], vg, kBK, lk, d);
    wgmma::cp_async_commit();
  }

  const int warp = (threadIdx.x % kWG) >> 5;
  const int lane = threadIdx.x & 31;
  const int row0 = wq_start + 16 * warp + (lane >> 2);   // and row0 + 8
  const int col_in = 2 * (lane & 3);

  float o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf};   // running max, scaled by log2(e)
  float l[2] = {0.f, 0.f};           // this thread's share of the denominator

  for (int kt = 0; kt <= last; ++kt) {
    const int st = kt & 1;
    if (kt + 1 <= last) {
      wgmma::cp_async_wait<1>();
    } else {
      wgmma::cp_async_wait<0>();
    }
    wgmma::fence_async_smem();
    __syncthreads();

    // Key tiles past this warpgroup's diagonal are wholly masked for it.
    if (kt <= my_last) {
      // S = Q K^T over the depth, 16 at a time.
      float s[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        s[i] = 0.f;
        wgmma::fence_operand(s[i]);
      }
      wgmma::fence();
#pragma unroll
      for (int step = 0; step < DP / 16; ++step) {
        wgmma::wgmma_ss_n64(s, wgmma::desc_k_major(qs + step * 256, DP),
                            wgmma::desc_k_major(ks[st] + step * 256, DP), step);
      }
      wgmma::commit();
      wgmma::wait_all();
#pragma unroll
      for (int i = 0; i < 32; ++i) wgmma::fence_operand(s[i]);

      // Mask, scale and the online softmax on the fragments.
      const int k_start = kt * kBK;
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = row0 + (e >> 1) * 8;
          const int col = k_start + 8 * i + col_in + (e & 1);
          float sv = s[4 * i + e] * scale_log2;
          if (col >= lk) {
            sv = -INFINITY;
          } else if (causal && row < col) {
            sv = kNegInf;
          }
          s[4 * i + e] = sv;
          mx[e >> 1] = fmaxf(mx[e >> 1], sv);
        }
      }
      float corr[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float m_new = fmaxf(m[h], mx[h]);
        corr[h] = exp2f(m[h] - m_new);
        m[h] = m_new;
        l[h] *= corr[h];
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int h = (i >> 1) & 1;
        const float p = exp2f(s[i] - m[h]);
        s[i] = p;
        l[h] += p;
      }
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) o[i] *= corr[(i >> 1) & 1];

      // O += P V: P's fragments are the A operand, as two bf16 terms, P
      // rounded (hi) and what that rounding left (lo), so P V keeps ~16 bits
      // of P (one bf16 term is off by up to 2^-9 a weight, which a row of a
      // few keys does not average away).
      uint32_t hi[4][4], lo[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          wgmma::split_bf16(s[8 * j + 2 * e], s[8 * j + 2 * e + 1], hi[j][e],
                            lo[j][e]);
        }
      }
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) wgmma::fence_operand(o[i]);
      wgmma::fence();
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint64_t vd = wgmma::desc_n_major(vs[st] + j * 2 * DP * 16, DP);
        wgmma::rs<DP>(o, hi[j], vd);
        wgmma::rs<DP>(o, lo[j], vd);
      }
      wgmma::commit();
      wgmma::wait_all();
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) wgmma::fence_operand(o[i]);
    }

    __syncthreads();   // every warp is done with stage st
    if (kt + 2 <= last) {
      load_tile<DP>(ks[st], kg, (kt + 2) * kBK, lk, d);
      load_tile<DP>(vs[st], vg, (kt + 2) * kBK, lk, d);
      wgmma::cp_async_commit();
    }
  }

  __nv_bfloat16* og = out + bh * lq * d;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float den = l[h];
    den += __shfl_xor_sync(0xffffffffu, den, 1);
    den += __shfl_xor_sync(0xffffffffu, den, 2);
    if (den == 0.f) den = 1.f;
    const int row = row0 + 8 * h;
    if (row >= lq) continue;
#pragma unroll
    for (int i = 0; i < DP / 8; ++i) {
      const int col = 8 * i + col_in;
      if (col < d) {
        *reinterpret_cast<__nv_bfloat162*>(og + (long long)row * d + col) =
            __floats2bfloat162_rn(o[4 * i + 2 * h] / den,
                                  o[4 * i + 2 * h + 1] / den);
      }
    }
  }
}

template <int DP>
int launch_bf16(const void* q, const void* k, const void* v, void* out,
                int bh, int lq, int lk, int d, float scale, int causal,
                cudaStream_t st) {
  constexpr int smem = bf16_smem_bytes<DP>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_bf16_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(bh, (lq + kQWG * kBQ - 1) / (kQWG * kBQ));
  flash_bf16_kernel<DP><<<grid, kBF16Threads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<__nv_bfloat16*>(out), lq, lk, d,
      scale * 1.4426950408889634f, causal);
  return (int)cudaGetLastError();
}

int dispatch_bf16(const void* q, const void* k, const void* v, void* out,
                  int bh, int lq, int lk, int d, float scale, int causal,
                  cudaStream_t st) {
  switch ((d + 15) / 16) {
    case 1: return launch_bf16<16>(q, k, v, out, bh, lq, lk, d, scale, causal, st);
    case 2: return launch_bf16<32>(q, k, v, out, bh, lq, lk, d, scale, causal, st);
    case 3: return launch_bf16<48>(q, k, v, out, bh, lq, lk, d, scale, causal, st);
    case 4: return launch_bf16<64>(q, k, v, out, bh, lq, lk, d, scale, causal, st);
    case 5: return launch_bf16<80>(q, k, v, out, bh, lq, lk, d, scale, causal, st);
    case 6: return launch_bf16<96>(q, k, v, out, bh, lq, lk, d, scale, causal, st);
    case 7: return launch_bf16<112>(q, k, v, out, bh, lq, lk, d, scale, causal, st);
    case 8: return launch_bf16<128>(q, k, v, out, bh, lq, lk, d, scale, causal, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------


size_t f32_smem_bytes(int d) {
  const size_t ld = d + 1;
  return sizeof(float) *
         (kBQ * ld + kBK * ld + (size_t)kBK * d + kBQ * (kBK + 1) + 3 * kBQ);
}

__global__ void __launch_bounds__(kThreads)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out,
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
  const float* qg = q + bh * lq * d;
  const float* kg = k + bh * lk * d;
  const float* vg = v + bh * lk * d;

  for (int i = tid; i < kBQ * d; i += kThreads) {
    const int r = i / d, c = i - r * d;
    const int row = q_start + r;
    qs[r * ld + c] = row < lq ? (qg[(long long)row * d + c]) : 0.f;
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
      ks[r * ld + c] = in ? (kg[(long long)row * d + c]) : 0.f;
      vs[r * d + c] = in ? (vg[(long long)row * d + c]) : 0.f;
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

  float* og = out + bh * lq * d;
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
        og[(long long)row * d + oc + 8 * j] = acc[i][j] / denom;
      }
    }
  }
}

int launch_f32(const void* q, const void* k, const void* v, void* out,
               int bh, int lq, int lk, int d, float scale, int causal,
               cudaStream_t st) {
  const size_t smem = f32_smem_bytes(d);
  cudaError_t e = cudaFuncSetAttribute(
      flash_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(bh, (lq + kBQ - 1) / kBQ);
  flash_f32_kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), lq, lk, d,
      scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (q, k, v and out); q (bh, lq, d), k and v
// (bh, lk, d), all contiguous, bf16 ones 16-byte aligned.  Returns a
// cudaError_t, or cudaErrorInvalidValue for d outside 8..128 or not a
// multiple of 8.
extern "C" int flash_attention_launch(int dtype, const void* q, const void* k,
                                      const void* v, void* out, int bh,
                                      int lq, int lk, int d, float scale,
                                      int causal, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bh < 1 || lq < 1 || lk < 1 || d < 8 || d > kMaxD || d % 8)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_f32(q, k, v, out, bh, lq, lk, d, scale, causal, st);
  if (dtype == 1)
    return dispatch_bf16(q, k, v, out, bh, lq, lk, d, scale, causal, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
