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
// between the two kernels, as the TPU kernels round it.  L is 1..128, dk
// and dv multiples of 8 up to 256.
//
// Wide heads (dk or dv above 128, the kWide instantiations; the mLSTM of
// xLSTM-350M runs at dk = dv = 256, G = 64): every kernel takes dv in
// tiles of at most 128 columns (tile_width), a block one (g, dv tile), and
// recomputes C B^T for each tile; C and B are never tiled, dk being the
// depth of C B^T.  At L = 128 and d = 256 one bf16 stage of C, B and a V
// tile takes 161 KB, so chunk_local keeps one stage where two do not fit
// (local_stages), and its state summary walks dk's four 64-row wgmma tiles
// two a warpgroup; chunk_apply holds C (64 KB), the y_intra tile and
// S_prev's tile as bf16 hi and lo (128 KB), 226 KB, one block an SM.  The
// float32 kernels stage C a panel of 16 rows at a time instead of whole.
// At that shape chunk_local moves ~33.6 MB (~10 us at 3.35 TB/s) and
// chunk_apply ~29.4 MB (~8.8 us); the 128 blocks of a prefill fill one wave
// of 132 SMs.  Below 128 the kernels compile to the code of the designs
// described next (kWide false: one tile, two stages, no panels).
//
// What bounds them, at the serving path's shape (G = 1792, L = 128,
// dk = dv = 64, bf16): chunk_local reads 3 x 29 MB and writes 29 MB of
// y_intra and 29 MB of s, ~148 MB (~44 us at 3.35 TB/s), for 5.7 GFLOP of
// causal work (~6 us on the bf16 tensor cores, ~85 us on the f32 CUDA
// cores); chunk_apply moves ~119 MB (~35 us) for 1.9 GFLOP.  On the tensor
// cores both are bound by bytes: the designs below are streaming kernels.
//
// Two routes, chosen by dtype.
//
// bfloat16: the products on the tensor cores through wgmma
// (wgmma_sm90.cuh), float32 accumulators in registers.  Operands are
// staged as bf16 into no-swizzle core-matrix tiles of 64 or 128 rows whose
// depth is padded to dkp, dvp (the next multiples of 16), rows and depth
// past L and d zero, by 16-byte cp.async copies a thread; chunk_local, where
// L is a multiple of 8, by the tensor memory accelerator (TMA) instead: one
// thread issues a bulk copy a tile from a 5-D view of the operand whose box
// is the core-matrix tile (encode_rows), the padding filled as
// out-of-bounds zeros.  (Issuing cp.async copies for the next g held up
// every thread of a chunk_local block; with TMA the kernel takes 0.075 ms
// against 0.086 at the serving shape on an H100.  chunk_apply, a g a
// block, measured slower with TMA loads and a TMA store: 0.0675 against
// 0.0632.)
// Where a float32 product is an operand (att . D, B . w, C . exp(ca),
// S_prev) it goes to the tensor cores as two bf16 terms, its rounding and
// what that rounding left (wgmma::split_bf16), and each term is multiplied:
// one bf16 term is off by up to 2^-9 of the value, which the state
// summary's 1e-4 tolerance does not allow; two keep ~16 bits.
//  * chunk_local_bf16_kernel: two warpgroups (256 threads) a block.  A
//    resident grid of blocks (two an SM at dv <= 64) walks over g with a
//    two-stage ring: g + grid's C, B, V and ca load (one mbarrier a stage)
//    while g multiplies.  First the state summary: its A operand,
//    (B . w)^T with M = dk and depth t, comes from the B tile by
//    ldmatrix.trans, is scaled by w = exp(ca[L-1] - ca) (expf) in float32
//    and split; every k-step's fragments are built first and the products
//    issued in one batch; warpgroup m takes rows 64m..64m+63 of dk
//    (warpgroup 0 alone at dk <= 64, which evens the work: half 1 does
//    twice half 0's y_intra work).  Then y_intra, a warpgroup the 64 rows
//    of one half of the chunk: for each key tile of 64 at or below its half
//    (half 0 one, half 1 two) it forms S = C B^T (m64n64k16, both operands
//    K-major in shared memory), masks and decays it on the accumulator
//    fragments (exp2 on the special function unit, only where s <= t < L)
//    and splits P into bf16 hi and lo, which are the A operand of
//    O += P V (register A, V N-major).  y_intra leaves through shared
//    memory by 16-byte stores.  At the serving shape the kernel's time
//    follows its bytes, not its products: without the state summary's
//    stores it takes 0.064 of 0.075 ms, without y_intra's 0.067, without
//    the state's products and stores 0.063, without y_intra's products
//    0.072 (tools/chunk_probe.py ablate, H100).
//  * chunk_apply_bf16_kernel: a block of two warpgroups a g (four blocks an
//    SM at dv <= 64), rows split as above.  C, y_intra (as it lies, rows
//    padded by 16 bytes so the epilogue's fragment reads hit distinct
//    banks) and the float32 S_prev are loaded at once; S_prev goes to bf16
//    hi and lo tiles (N-major); C . exp(ca) is built in registers from the
//    C tile by ldmatrix and split, a k-step at a time in a ring of two
//    register sets so one step's products run while the next is built; the
//    product takes three terms, hi.hi + hi.lo + lo.hi (the fourth is below
//    2^-16 of the value).  The sum with y_intra is rounded in place in
//    shared memory and leaves by 16-byte stores.  (A register-blocked float32 outer product
//    would need ~28 us of CUDA-core issue at the serving shape, near the
//    byte bound by itself; TF32 wgmma takes only K-major operands, which
//    S_prev is not, and keeps 10 bits.)
//
// float32: chunk_local_f32_kernel and chunk_apply_f32_kernel, the first
// design, kept because wgmma on f32 operands runs in TF32, which would
// break the f32 path's parity with the plain version (lm_check holds it to
// ~1e-5; the f32 route runs only there, 6 launches).  One block of 256
// threads a g: C and B (rows padded by one float so a warp reading a
// column hits 32 banks), V and the decay weights staged as float32; the
// state summary and y_intra in panels of 16 rows (the panel's masked
// scores go to shared memory and are multiplied into V), a small register
// tile a thread so a shared-memory load feeds several fused multiply-adds;
// chunk_apply stages C . exp(ca) and S_prev the same way.  They are bound
// by shared-memory bandwidth and the f32 operations.  The build uses
// -fmad=false; the accumulations are explicit fmaf, and the products the
// TPU kernel rounds separately (B . decay, C . exp(ca), att . D) are
// rounded separately here.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma_sm90.cuh"

namespace {

constexpr int kMaxL = 128;
constexpr int kMaxD = 256;
// The widest dv tile, and the widest d the float32 kernels hold whole.
constexpr int kTileD = 128;
// Shared memory a block may use on sm_90 (227 KB).
constexpr int kMaxSmem = 232448;

using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------------------
// bfloat16: wgmma
// ---------------------------------------------------------------------------

constexpr int kWG = 128;                 // threads of a warpgroup
constexpr int kThreads = 2 * kWG;        // a bf16 block: two warpgroups
// chunk_local: 1 stages a g by TMA (four bulk copies from one thread) where
// L is a multiple of 8; 0 always by cp.async (16 bytes a thread).
constexpr int kLocalTma = 1;
// Blocks an SM each kernel's register budget allows at dv <= 64 (one above).
constexpr int kLocalBlocks = 2;
constexpr int kApplyBlocks = 4;

// exp(x) as exp2 on the special-function unit: within ~2^-22 of the value
// plus x's rounding when scaled by log2(e) (~|x| 2^-24), where P's two bf16
// terms keep ~2^-17.  Results below 2^-126 flush to zero.
__device__ __forceinline__ float fast_exp(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}

// Rows of the staged tiles: one or two halves of 64.
__host__ __device__ __forceinline__ int padded_rows(int L) {
  return L > 64 ? 128 : 64;
}
__host__ __device__ __forceinline__ int pad16(int d) { return (d + 15) & ~15; }

// One chunk_local stage: C, B (lp x dkp), V (lp x dvp) core-matrix tiles and
// ca (lp floats), byte offsets.
struct LocalStage {
  int b, v, ca, bytes;
};
__host__ __device__ __forceinline__ LocalStage local_stage(int lp, int dkp,
                                                           int dvp) {
  LocalStage st;
  st.b = lp * dkp * 2;
  st.v = 2 * st.b;
  st.ca = st.v + lp * dvp * 2;
  st.bytes = st.ca + lp * 4;
  return st;
}

// Columns 0..d-1 of rows 0..lp-1 of a bf16 matrix of L rows, `ld` elements
// apart, into a core-matrix tile of depth dp; rows past L are zero-filled.
// Eight neighbouring threads fill one 128-byte core matrix, so a warp reads
// 8 rows x 64 contiguous bytes.
__device__ __forceinline__ void load_rows(unsigned char* tile, const bf16* g,
                                          int L, int lp, int d, int ld,
                                          int dp) {
  const int chunks = d / 8;
  const bool pow2 = (chunks & (chunks - 1)) == 0;
  const int shift = __ffs(chunks) - 1;
  for (int i = threadIdx.x; i < lp * chunks; i += kThreads) {
    const int rr = i & 7;
    const int rest = i >> 3;
    const int c = pow2 ? rest & (chunks - 1) : rest % chunks;
    const int r = (pow2 ? rest >> shift : rest / chunks) * 8 + rr;
    const bool in = r < L;
    wgmma::cp_async16(tile + wgmma::cm_offset(r, c, dp),
                      g + (long long)(in ? r : 0) * ld + c * 8, in);
  }
}

// Zeroes columns d..dp-1 (the depth padding) of rows 0..rows-1 of a tile;
// cp.async never writes them.
__device__ __forceinline__ void zero_cols(unsigned char* tile, int rows,
                                          int d, int dp) {
  const int c0 = d / 8;
  const int pad = dp / 8 - c0;
  for (int i = threadIdx.x; i < rows * pad; i += kThreads) {
    const int r = i / pad, c = c0 + i % pad;
    *reinterpret_cast<uint4*>(tile + wgmma::cm_offset(r, c, dp)) =
        make_uint4(0u, 0u, 0u, 0u);
  }
}

// A stage of g's C, B, ca and the dv tile of V from column col0, wt wide.
__device__ __forceinline__ void load_local_stage(
    unsigned char* st, const LocalStage& ly, const bf16* c, const bf16* b,
    const bf16* v, const float* ca, long long g, int L, int lp, int dk,
    int dv, int dkp, int dvp, int col0, int wt) {
  load_rows(st, c + g * L * dk, L, lp, dk, dk, dkp);
  load_rows(st + ly.b, b + g * L * dk, L, lp, dk, dk, dkp);
  load_rows(st + ly.v, v + g * L * dv + col0, L, lp, wt, dv, dvp);
  // The depth padding, which cp.async never writes, anew each time: the
  // stage also passes y_intra out.
  if (dkp != dk) {
    zero_cols(st, lp, dk, dkp);
    zero_cols(st + ly.b, lp, dk, dkp);
  }
  if (dvp != wt) zero_cols(st + ly.v, lp, wt, dvp);
  const float* cag = ca + g * L;
  for (int i = threadIdx.x; i < lp; i += kThreads) {
    wgmma::cp_async4(st + ly.ca + 4 * i, cag + (i < L ? i : 0), i < L);
  }
}

// TMA maps of a g's C, B and V tiles and its ca (encode_local_maps): a 5-D
// view (8 depth values, 8 rows, d / 8 chunks, L / 8 row groups, g) whose
// box lands as the core-matrix tile, the chunks and row groups past d and
// L filled with zeros; ca as (L, g) with a box of lp.
struct LocalMaps {
  CUtensorMap c, b, v, ca;
};

// Stage g's operands with the dv tile of V from column col0, wt wide: by
// TMA (thread 0 arms the stage's barrier with the stage's bytes and issues
// four copies; the V box starts at the tile's column chunk) or by cp.async
// (every thread).
__device__ __forceinline__ void issue_local_stage(
    bool tma, uint64_t* bar, const LocalMaps& maps, unsigned char* st,
    const LocalStage& ly, const bf16* c, const bf16* b, const bf16* v,
    const float* ca, int g, int col0, int wt, int L, int lp, int dk, int dv,
    int dkp, int dvp) {
  if (!tma) {
    load_local_stage(st, ly, c, b, v, ca, g, L, lp, dk, dv, dkp, dvp, col0,
                     wt);
  } else if (threadIdx.x == 0) {
    wgmma::mbar_expect_tx(bar, ly.bytes);
    wgmma::tma_load_5d(st, &maps.c, bar, 0, 0, 0, 0, g);
    wgmma::tma_load_5d(st + ly.b, &maps.b, bar, 0, 0, 0, 0, g);
    wgmma::tma_load_5d(st + ly.v, &maps.v, bar, 0, 0, col0 / 8, 0, g);
    wgmma::tma_load_2d(st + ly.ca, &maps.ca, bar, 0, g);
  }
}

// A block walks work items with a ring of two stages.  kWide (dk or dv
// above kTileD): an item is a (g, dv tile) pair, the tile tw columns wide
// and DVP its padded width, and the ring has `stages` stages (one where
// two do not fit in shared memory); else an item is a g, dv = tw.
template <int DVP, bool kWide>
__global__ void __launch_bounds__(kThreads, DVP <= 64 ? kLocalBlocks : 1)
chunk_local_bf16_kernel(const __grid_constant__ LocalMaps maps, int tma,
                        int wide_stages, const bf16* __restrict__ c,
                        const bf16* __restrict__ b,
                        const bf16* __restrict__ v,
                        const float* __restrict__ ca, bf16* __restrict__ y,
                        float* __restrict__ s, int G, int L, int dk, int dv,
                        int tw) {
  extern __shared__ __align__(128) unsigned char tiles[];
  const int lp = padded_rows(L);
  const int dkp = pad16(dk);
  const LocalStage ly = local_stage(lp, dkp, DVP);
  const int stages = kWide ? wide_stages : 2;
  float* w = reinterpret_cast<float*>(tiles + stages * ly.bytes);  // kMaxL
  uint64_t* bars = reinterpret_cast<uint64_t*>(w + kMaxL);   // TMA, a stage

  const int tid = threadIdx.x;
  const int wg = tid / kWG;
  const int warp = (tid % kWG) >> 5;
  const int lane = tid & 31;
  const int q2 = 2 * (lane & 3);
  const int row0 = 64 * wg + 16 * warp + (lane >> 2);   // and row0 + 8

  if (tma && tid == 0) {
    wgmma::mbar_init(&bars[0], 1);
    wgmma::mbar_init(&bars[1], 1);
  }
  __syncthreads();

  const int n_tiles = kWide ? (dv + tw - 1) / tw : 1;
  const int items = G * n_tiles;
  // Work item i's g, its dv tile's first column and width.
  auto g_of = [&](int i) { return kWide ? i / n_tiles : i; };
  auto col0_of = [&](int i) { return kWide ? (i - g_of(i) * n_tiles) * tw : 0; };
  auto wt_of = [&](int col0) { return kWide ? min(tw, dv - col0) : dv; };
  int item = blockIdx.x;
  if (item < items) {
    issue_local_stage(tma, &bars[0], maps, tiles, ly, c, b, v, ca,
                      g_of(item), col0_of(item), wt_of(col0_of(item)), L, lp,
                      dk, dv, dkp, DVP);
  }
  if (!tma) wgmma::cp_async_commit();
  for (int it = 0; item < items; ++it, item += gridDim.x) {
    const int cur = stages == 2 ? it & 1 : 0;
    unsigned char* st = tiles + cur * ly.bytes;
    const int next = item + gridDim.x;
    if (stages == 2 && next < items) {
      issue_local_stage(tma, &bars[cur ^ 1], maps, tiles + (cur ^ 1) * ly.bytes,
                        ly, c, b, v, ca, g_of(next), col0_of(next),
                        wt_of(col0_of(next)), L, lp, dk, dv, dkp, DVP);
    }
    if (tma) {
      wgmma::mbar_wait(&bars[cur], kWide ? (it / stages) & 1 : (it >> 1) & 1);
    } else {
      wgmma::cp_async_commit();
      if (stages == 2) {
        wgmma::cp_async_wait<1>();
      } else {
        wgmma::cp_async_wait<0>();
      }
      wgmma::fence_async_smem();
    }
    __syncthreads();
    const int g = g_of(item);
    const int col0 = col0_of(item);
    const int wt = wt_of(col0);              // this tile's columns

    const unsigned char* ct = st;
    const unsigned char* bt = st + ly.b;
    const unsigned char* vt = st + ly.v;
    const float* cas = reinterpret_cast<const float*>(st + ly.ca);
    if (tid < kMaxL) w[tid] = tid < L ? expf(cas[L - 1] - cas[tid]) : 0.f;
    __syncthreads();

    // State summary: (B . w)^T V over t, a k-step of 16 t at a time, for
    // the 64-row tiles of dk from 64 wg, every other one (dk = 256: two a
    // warpgroup).
    for (int mt = wg; 64 * mt < dk; mt += 2) {
      float acc[DVP / 2];
#pragma unroll
      for (int i = 0; i < DVP / 2; ++i) {
        acc[i] = 0.f;
        wgmma::fence_operand(acc[i]);
      }
      const int m0 = 64 * mt + 16 * warp;       // this warp's 16 rows of dk
      const bool rows_in = m0 < dkp;
      const int blk = lane >> 3;                // ldmatrix block of this lane
      const int chunk = m0 / 8 + (blk & 1);
      const int t_in = 8 * (blk >> 1) + (lane & 7);
      const int tsteps = (L + 15) / 16;
      // A fragments of every k-step first, then the products in one batch.
      uint32_t hi[kMaxL / 16][4], lo[kMaxL / 16][4];
#pragma unroll
      for (int ks = 0; ks < kMaxL / 16; ++ks) {
        uint32_t raw[4] = {0u, 0u, 0u, 0u};
        if (rows_in && ks < tsteps) {
          wgmma::ldmatrix_x4_trans(
              raw, bt + wgmma::cm_offset(16 * ks + t_in, chunk, dkp));
        }
        // raw[0], raw[1]: t = 16 ks + q2, +1; raw[2], raw[3]: t + 8, +9.
        const float2 w0 = *reinterpret_cast<const float2*>(w + 16 * ks + q2);
        const float2 w1 =
            *reinterpret_cast<const float2*>(w + 16 * ks + 8 + q2);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 ww = e < 2 ? w0 : w1;
          wgmma::split_bf16(wgmma::bf16_lo(raw[e]) * ww.x,
                            wgmma::bf16_hi(raw[e]) * ww.y, hi[ks][e],
                            lo[ks][e]);
        }
      }
#pragma unroll
      for (int i = 0; i < DVP / 2; ++i) wgmma::fence_operand(acc[i]);
      wgmma::fence();
#pragma unroll
      for (int ks = 0; ks < kMaxL / 16; ++ks) {
        if (ks < tsteps) {
          const uint64_t vd = wgmma::desc_n_major(vt + 2 * ks * DVP * 16, DVP);
          wgmma::rs<DVP>(acc, hi[ks], vd);
          wgmma::rs<DVP>(acc, lo[ks], vd);
        }
      }
      wgmma::commit();
      wgmma::wait_all();
#pragma unroll
      for (int i = 0; i < DVP / 2; ++i) wgmma::fence_operand(acc[i]);
      float* sg = s + (long long)g * dk * dv + col0;
#pragma unroll
      for (int i = 0; i < DVP / 8; ++i) {
        const int col = 8 * i + q2;
        if (col >= wt) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int k = m0 + (lane >> 2) + 8 * h;
          if (k < dk) {
            *reinterpret_cast<float2*>(sg + (long long)k * dv + col) =
                make_float2(acc[4 * i + 2 * h], acc[4 * i + 2 * h + 1]);
          }
        }
      }
      if (!kWide) break;   // dk <= 128: one tile a warpgroup
    }

    // y_intra: this warpgroup's half against the key tiles at or below it.
    const bool y_rows = 64 * wg < L;
    float o[DVP / 2];
#pragma unroll
    for (int i = 0; i < DVP / 2; ++i) o[i] = 0.f;
    if (y_rows) {
      const float ca_r[2] = {cas[row0], cas[row0 + 8]};
      const unsigned char* ch = ct + wg * 128 * dkp;    // 64 rows of C
      for (int j = 0; j <= wg; ++j) {
        float sc[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          sc[i] = 0.f;
          wgmma::fence_operand(sc[i]);
        }
        wgmma::fence();
        const unsigned char* bj = bt + j * 128 * dkp;    // keys 64j..64j+63
        for (int step = 0; step < dkp / 16; ++step) {
          wgmma::wgmma_ss_n64(sc, wgmma::desc_k_major(ch + step * 256, dkp),
                              wgmma::desc_k_major(bj + step * 256, dkp), step);
        }
        wgmma::commit();
        wgmma::wait_all();
#pragma unroll
        for (int i = 0; i < 32; ++i) wgmma::fence_operand(sc[i]);

        // P = att . D on the fragments: rows row0 (+8), keys 64j + 8i + q2
        // (+1); zero above the diagonal and on rows past L.
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int key = 64 * j + 8 * i + q2;
          const float2 cak = *reinterpret_cast<const float2*>(cas + key);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = row0 + (e >> 1) * 8;
            const float d = ca_r[e >> 1] - ((e & 1) ? cak.y : cak.x);
            const bool in = key + (e & 1) <= row && row < L;
            sc[4 * i + e] = in ? sc[4 * i + e] * fast_exp(d) : 0.f;
          }
        }
        uint32_t hi[4][4], lo[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            wgmma::split_bf16(sc[8 * kk + 2 * e], sc[8 * kk + 2 * e + 1],
                              hi[kk][e], lo[kk][e]);
          }
        }
#pragma unroll
        for (int i = 0; i < DVP / 2; ++i) wgmma::fence_operand(o[i]);
        wgmma::fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t vd =
              wgmma::desc_n_major(vt + (8 * j + 2 * kk) * DVP * 16, DVP);
          wgmma::rs<DVP>(o, hi[kk], vd);
          wgmma::rs<DVP>(o, lo[kk], vd);
        }
        wgmma::commit();
        wgmma::wait_all();
#pragma unroll
        for (int i = 0; i < DVP / 2; ++i) wgmma::fence_operand(o[i]);
      }
    }
    // y_intra leaves through the stage's space, as it lies with rows padded
    // by 16 bytes (the fragment writes hit 32 banks), by 16-byte stores: the
    // fragments' own 4-byte stores each fill half a 32-byte sector (the
    // kernel took 0.088 ms with them, 0.076 without, on an H100).
    __syncthreads();   // every product has read this stage
    const int ypitch = wt * 2 + 16;
    if (y_rows) {
#pragma unroll
      for (int i = 0; i < DVP / 8; ++i) {
        const int col = 8 * i + q2;
        if (col >= wt) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = row0 + 8 * h;
          if (row < L) {
            *reinterpret_cast<__nv_bfloat162*>(st + row * ypitch + col * 2) =
                __floats2bfloat162_rn(o[4 * i + 2 * h], o[4 * i + 2 * h + 1]);
          }
        }
      }
    }
    __syncthreads();
    const int ychunks = wt / 8;
    bf16* yg = y + (long long)g * L * dv + col0;
    for (int i = tid; i < L * ychunks; i += kThreads) {
      const int r = i / ychunks, cc = i - r * ychunks;
      *reinterpret_cast<uint4*>(yg + (kWide ? (long long)r * dv + cc * 8
                                            : (long long)i * 8)) =
          *reinterpret_cast<const uint4*>(st + r * ypitch + cc * 16);
    }
    __syncthreads();   // this stage and w are free for the next item
    if (stages == 1 && next < items) {
      issue_local_stage(tma, &bars[0], maps, tiles, ly, c, b, v, ca,
                        g_of(next), col0_of(next), wt_of(col0_of(next)), L,
                        lp, dk, dv, dkp, DVP);
    }
  }
}

// chunk_apply's shared memory: the C tile (lp x dkp), the y_intra tile
// (tw columns) as it lies with rows padded by 16 bytes, S_prev's hi and lo
// tiles (dkp x dvp, N-major).
struct ApplySmem {
  int y, shi, slo, bytes;
};
__host__ __device__ __forceinline__ ApplySmem apply_smem(int L, int lp,
                                                         int dkp, int tw,
                                                         int dvp) {
  ApplySmem sm;
  sm.y = lp * dkp * 2;
  sm.shi = sm.y + L * (tw * 2 + 16);
  sm.slo = sm.shi + dkp * dvp * 2;
  sm.bytes = sm.slo + dkp * dvp * 2;
  return sm;
}

// A block a g; kWide: a block a (g, dv tile), blockIdx.y the tile, tw
// columns apart.
template <int DVP, bool kWide>
__global__ void __launch_bounds__(kThreads, DVP <= 64 ? kApplyBlocks : 1)
chunk_apply_bf16_kernel(const bf16* __restrict__ c,
                        const float* __restrict__ ca,
                        const bf16* __restrict__ yin,
                        const float* __restrict__ sp, bf16* __restrict__ out,
                        int L, int dk, int dv, int tw) {
  extern __shared__ __align__(128) unsigned char tiles[];
  const int lp = padded_rows(L);
  const int dkp = pad16(dk);
  const ApplySmem sm = apply_smem(L, lp, dkp, tw, DVP);
  const int col0 = kWide ? blockIdx.y * tw : 0;
  const int wt = kWide ? min(tw, dv - col0) : dv;   // this tile's columns
  const int ypitch = wt * 2 + 16;
  unsigned char* ys = tiles + sm.y;
  unsigned char* shi = tiles + sm.shi;
  unsigned char* slo = tiles + sm.slo;

  const long long g = blockIdx.x;
  const int tid = threadIdx.x;
  const int wg = tid / kWG;
  const int warp = (tid % kWG) >> 5;
  const int lane = tid & 31;
  const int q2 = 2 * (lane & 3);
  const int row0 = 64 * wg + 16 * warp + (lane >> 2);   // and row0 + 8

  load_rows(tiles, c + g * L * dk, L, lp, dk, dk, dkp);
  const int ychunks = wt / 8;
  const bf16* yg = yin + g * L * dv + col0;
  for (int i = tid; i < L * ychunks; i += kThreads) {
    const int r = i / ychunks, cc = i - r * ychunks;
    wgmma::cp_async16(ys + r * ypitch + cc * 16,
                      yg + (kWide ? (long long)r * dv + cc * 8
                                  : (long long)i * 8),
                      true);
  }
  wgmma::cp_async_commit();
  if (dkp != dk) zero_cols(tiles, lp, dk, dkp);

  // S_prev (dk x dv float32) as bf16 hi and lo tiles, rows k along the
  // product's depth: eight neighbouring threads take 8 rows k of one
  // 4-column group (a core matrix's rows), a warp 8 rows x 64 bytes.
  const float* spg = sp + g * dk * dv + col0;
  const int quads = wt / 4;
  for (int i = tid; i < dk * quads; i += kThreads) {
    const int rr = i & 7;
    const int rest = i >> 3;
    const int n = 4 * (rest % quads);
    const int k = (rest / quads) * 8 + rr;
    const float4 x = *reinterpret_cast<const float4*>(spg + k * dv + n);
    uint2 h, l;
    wgmma::split_bf16(x.x, x.y, h.x, l.x);
    wgmma::split_bf16(x.z, x.w, h.y, l.y);
    const int off = wgmma::cm_offset(k, n / 8, DVP) + (n % 8) * 2;
    *reinterpret_cast<uint2*>(shi + off) = h;
    *reinterpret_cast<uint2*>(slo + off) = l;
  }
  // Their padding: rows dk..dkp-1 and columns wt..dvp-1.
  for (int i = tid; i < dkp * (DVP / 8); i += kThreads) {
    const int k = i / (DVP / 8), cc = i % (DVP / 8);
    if (k >= dk || cc >= wt / 8) {
      const int off = wgmma::cm_offset(k, cc, DVP);
      *reinterpret_cast<uint4*>(shi + off) = make_uint4(0u, 0u, 0u, 0u);
      *reinterpret_cast<uint4*>(slo + off) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
  const float* cag = ca + g * L;
  const float e_r[2] = {row0 < L ? expf(cag[row0]) : 0.f,
                        row0 + 8 < L ? expf(cag[row0 + 8]) : 0.f};
  wgmma::cp_async_wait<0>();
  wgmma::fence_async_smem();
  __syncthreads();

  if (64 * wg < L) {
    float acc[DVP / 2];
#pragma unroll
    for (int i = 0; i < DVP / 2; ++i) {
      acc[i] = 0.f;
      wgmma::fence_operand(acc[i]);
    }
    const int blk = lane >> 3;                 // ldmatrix block of this lane
    const int r_in = 64 * wg + 16 * warp + 8 * (blk & 1) + (lane & 7);
    const int ksteps = dkp / 16;
    uint32_t hi[2][4], lo[2][4];
#pragma unroll
    for (int ks = 0; ks < (kWide ? kMaxD : kTileD) / 16; ++ks) {
      if (ks < ksteps) {
        const int set = ks & 1;
        if (ks >= 2) wgmma::wait<1>();   // step ks - 2 read this set
        uint32_t raw[4];
        wgmma::ldmatrix_x4(
            raw, tiles + wgmma::cm_offset(r_in, 2 * ks + (blk >> 1), dkp));
        // raw[0], raw[2]: row row0; raw[1], raw[3]: row row0 + 8.
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float er = e_r[e & 1];
          wgmma::split_bf16(wgmma::bf16_lo(raw[e]) * er,
                            wgmma::bf16_hi(raw[e]) * er, hi[set][e],
                            lo[set][e]);
        }
#pragma unroll
        for (int i = 0; i < DVP / 2; ++i) wgmma::fence_operand(acc[i]);
        wgmma::fence();
        const uint64_t dh = wgmma::desc_n_major(shi + 2 * ks * DVP * 16, DVP);
        const uint64_t dl = wgmma::desc_n_major(slo + 2 * ks * DVP * 16, DVP);
        wgmma::rs<DVP>(acc, hi[set], dh);
        wgmma::rs<DVP>(acc, hi[set], dl);
        wgmma::rs<DVP>(acc, lo[set], dh);
        wgmma::commit();
      }
    }
    wgmma::wait_all();
#pragma unroll
    for (int i = 0; i < DVP / 2; ++i) wgmma::fence_operand(acc[i]);
    // y = y_intra + inter, rounded once, in place in shared memory.
#pragma unroll
    for (int i = 0; i < DVP / 8; ++i) {
      const int col = 8 * i + q2;
      if (col >= wt) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + 8 * h;
        if (row < L) {
          __nv_bfloat162* at =
              reinterpret_cast<__nv_bfloat162*>(ys + row * ypitch + col * 2);
          const float2 yv = __bfloat1622float2(*at);
          *at = __floats2bfloat162_rn(yv.x + acc[4 * i + 2 * h],
                                      yv.y + acc[4 * i + 2 * h + 1]);
        }
      }
    }
  }
  __syncthreads();
  bf16* og = out + g * L * dv + col0;
  for (int i = tid; i < L * ychunks; i += kThreads) {
    const int r = i / ychunks, cc = i - r * ychunks;
    *reinterpret_cast<uint4*>(og + (kWide ? (long long)r * dv + cc * 8
                                          : (long long)i * 8)) =
        *reinterpret_cast<const uint4*>(ys + r * ypitch + cc * 16);
  }
}

// Resident blocks of `kernel` on the current device (at least one an SM).
template <typename K>
int resident_grid(K kernel, int smem, int* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  *grid = (per_sm > 0 ? per_sm : 1) * sms;
  return (int)e;
}

using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime (no -lcuda).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// A (G, L, d) bf16 operand as 5-D (8, 8, d / 8, L / 8, G): element e of
// chunk c of row 8 rg + r at ((8 rg + r) d + 8 c + e) * 2 bytes; the box
// (8, 8, dp / 8, lp / 8, 1) lands as a core-matrix tile of depth dp.
bool encode_rows(EncodeTiled enc, CUtensorMap* m, const void* base, int G,
                 int L, int d, int lp, int dp) {
  const cuuint64_t dims[5] = {8, 8, (cuuint64_t)(d / 8), (cuuint64_t)(L / 8),
                              (cuuint64_t)G};
  const cuuint64_t strides[4] = {(cuuint64_t)d * 2, 16, (cuuint64_t)d * 16,
                                 (cuuint64_t)L * d * 2};
  const cuuint32_t box[5] = {8, 8, (cuuint32_t)(dp / 8), (cuuint32_t)(lp / 8),
                             1};
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  return enc(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, const_cast<void*>(base),
             dims, strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

bool encode_local_maps(LocalMaps* maps, const void* c, const void* b,
                       const void* v, const void* ca, int G, int L, int dk,
                       int dv, int lp, int dkp, int dvp) {
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)L, (cuuint64_t)G};
  const cuuint64_t strides[1] = {(cuuint64_t)L * 4};
  const cuuint32_t box[2] = {(cuuint32_t)lp, 1};
  const cuuint32_t ones[2] = {1, 1};
  return encode_rows(enc, &maps->c, c, G, L, dk, lp, dkp) &&
         encode_rows(enc, &maps->b, b, G, L, dk, lp, dkp) &&
         encode_rows(enc, &maps->v, v, G, L, dv, lp, dvp) &&
         enc(&maps->ca, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
             const_cast<void*>(ca), dims, strides, box, ones,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_NONE,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The columns of a dv tile: dv itself up to kTileD, else dv split evenly
// into ceil(dv / kTileD) tiles, rounded up to a multiple of 8.
int tile_width(int dv) {
  const int tiles = (dv + kTileD - 1) / kTileD;
  return ((dv + tiles - 1) / tiles + 7) & ~7;
}

// chunk_local's stages: two where they fit in shared memory, else one.
int local_stages(int stage_bytes) {
  return 2 * stage_bytes + kMaxL * 4 + 2 * 8 <= kMaxSmem ? 2 : 1;
}

template <int DVP, bool kWide>
int launch_local_bf16(const void* c, const void* b, const void* v,
                      const void* ca, void* y, void* s, int G, int L, int dk,
                      int dv, int tw, cudaStream_t st) {
  auto kernel = chunk_local_bf16_kernel<DVP, kWide>;
  LocalMaps maps = {};
  const bool tma = kLocalTma && L % 8 == 0;
  if (tma && !encode_local_maps(&maps, c, b, v, ca, G, L, dk, dv,
                                padded_rows(L), pad16(dk), DVP)) {
    return (int)cudaErrorNotSupported;
  }
  const int stage = local_stage(padded_rows(L), pad16(dk), DVP).bytes;
  const int stages = kWide ? local_stages(stage) : 2;
  const int smem = stages * stage + kMaxL * 4 + 2 * 8;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  int grid = 0;
  const int err = resident_grid(kernel, smem, &grid);
  if (err) return err;
  const long long items = (long long)G * ((dv + tw - 1) / tw);
  grid = grid < items ? grid : (int)items;
  kernel<<<grid, kThreads, smem, st>>>(
      maps, tma ? 1 : 0, stages, static_cast<const bf16*>(c),
      static_cast<const bf16*>(b),
      static_cast<const bf16*>(v), static_cast<const float*>(ca),
      static_cast<bf16*>(y), static_cast<float*>(s), G, L, dk, dv, tw);
  return (int)cudaGetLastError();
}

template <int DVP, bool kWide>
int launch_apply_bf16(const void* c, const void* ca, const void* y_intra,
                      const void* s_prev, void* out, int G, int L, int dk,
                      int dv, int tw, cudaStream_t st) {
  auto kernel = chunk_apply_bf16_kernel<DVP, kWide>;
  const int smem = apply_smem(L, padded_rows(L), pad16(dk), tw, DVP).bytes;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(G, (dv + tw - 1) / tw);
  kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const bf16*>(c), static_cast<const float*>(ca),
      static_cast<const bf16*>(y_intra), static_cast<const float*>(s_prev),
      static_cast<bf16*>(out), L, dk, dv, tw);
  return (int)cudaGetLastError();
}

// The bf16 launchers by the dv tile's padding, wide or not.
#define CHUNK_SCAN_DVP_CASE(n, fn, wide, ...)                         \
  case n / 16:                                                        \
    return wide ? fn<n, true>(__VA_ARGS__) : fn<n, false>(__VA_ARGS__);
#define CHUNK_SCAN_BY_DVP(fn, wide, dvp, ...)          \
  switch ((dvp) / 16) {                                \
    CHUNK_SCAN_DVP_CASE(16, fn, wide, __VA_ARGS__)     \
    CHUNK_SCAN_DVP_CASE(32, fn, wide, __VA_ARGS__)     \
    CHUNK_SCAN_DVP_CASE(48, fn, wide, __VA_ARGS__)     \
    CHUNK_SCAN_DVP_CASE(64, fn, wide, __VA_ARGS__)     \
    CHUNK_SCAN_DVP_CASE(80, fn, wide, __VA_ARGS__)     \
    CHUNK_SCAN_DVP_CASE(96, fn, wide, __VA_ARGS__)     \
    CHUNK_SCAN_DVP_CASE(112, fn, wide, __VA_ARGS__)    \
    CHUNK_SCAN_DVP_CASE(128, fn, wide, __VA_ARGS__)    \
    default: return (int)cudaErrorInvalidValue;        \
  }

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kF32Threads = 256;
constexpr int kPanel = 16;

// Wide heads, dk or dv above kTileD: dv tiled, chunk_local's ring of
// stages sized to shared memory, the float32 kernels' C staged a panel at
// a time (the kWide kernels).
bool wide(int dk, int dv) { return dk > kTileD || dv > kTileD; }

size_t local_smem_bytes(int L, int dk, int tw, bool wide) {
  const size_t ldk = dk + 1;
  return sizeof(float) * (((wide ? kPanel : L) + L) * ldk + (size_t)L * tw +
                          2 * (size_t)L + kPanel * (L + 1));
}

size_t apply_smem_bytes(int L, int dk, int tw, bool wide) {
  return sizeof(float) *
         ((size_t)(wide ? kPanel : L) * (dk + 1) + (size_t)dk * tw);
}

// A block a (g, dv tile): blockIdx.x is g, blockIdx.y the tile, tw columns
// apart (tw = dv: one tile).
template <bool kWide>
__global__ void __launch_bounds__(kF32Threads)
chunk_local_f32_kernel(const float* __restrict__ c,
                       const float* __restrict__ b,
                       const float* __restrict__ v,
                       const float* __restrict__ ca, float* __restrict__ y,
                       float* __restrict__ s, int L, int dk, int dv, int tw) {
  extern __shared__ float smem[];
  const int ldk = dk + 1;
  const int lp = L + 1;
  const int col0 = kWide ? blockIdx.y * tw : 0;
  const int wt = kWide ? min(tw, dv - col0) : dv;   // this tile's columns
  float* cs = smem;               // L (kWide: kPanel) x ldk
  float* bs = cs + (kWide ? kPanel : L) * ldk;   // L x ldk
  float* vs = bs + L * ldk;       // L x wt
  float* cas = vs + L * wt;       // L
  float* w = cas + L;             // L: exp(ca[L-1] - ca[t])
  float* ps = w + L;              // kPanel x lp: masked scores of a panel

  const long long g = blockIdx.x;
  const int tid = threadIdx.x;
  const float* cg = c + g * L * dk;
  const float* bg = b + g * L * dk;
  const float* vg = v + g * L * dv + col0;
  for (int i = tid; i < L * dk; i += kF32Threads) {
    const int t = i / dk, k = i - t * dk;
    if (!kWide) cs[t * ldk + k] = cg[i];
    bs[t * ldk + k] = bg[i];
  }
  for (int i = tid; i < L * wt; i += kF32Threads) {
    if (kWide) {
      const int t = i / wt, j = i - t * wt;
      vs[i] = vg[(long long)t * dv + j];
    } else {
      vs[i] = vg[i];
    }
  }
  for (int i = tid; i < L; i += kF32Threads) cas[i] = ca[g * L + i];
  __syncthreads();
  for (int i = tid; i < L; i += kF32Threads) w[i] = expf(cas[L - 1] - cas[i]);
  __syncthreads();

  // State summary s[k][col] = sum_t (B[t][k] * w[t]) V[t][col]: each thread
  // 8 rows k (a warp shares them) by up to two columns.
  {
    const int col = tid % 64;
    const int kr = tid / 64;                 // 0..3
    float* sg = s + g * dk * dv + col0;
    for (int k0 = 0; k0 < dk; k0 += 32) {
      float acc[8][2];
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = 0.f;
      for (int t = 0; t < L; ++t) {
        const float wgt = w[t];
        const float v0 = col < wt ? vs[t * wt + col] : 0.f;
        const float v1 = col + 64 < wt ? vs[t * wt + col + 64] : 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int k = min(k0 + kr + 4 * j, dk - 1);
          const float bw = bs[t * ldk + k] * wgt;
          acc[j][0] = fmaf(bw, v0, acc[j][0]);
          acc[j][1] = fmaf(bw, v1, acc[j][1]);
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int k = k0 + kr + 4 * j;
        if (k < dk) {
          if (col < wt) sg[k * dv + col] = acc[j][0];
          if (col + 64 < wt) sg[k * dv + col + 64] = acc[j][1];
        }
      }
    }
  }

  // y_intra, kPanel rows at a time.
  float* yg = y + g * L * dv + col0;
  for (int p0 = 0; p0 < L; p0 += kPanel) {
    const int smax = min(p0 + kPanel, L);    // keys a panel row can see
    const int c0 = kWide ? p0 : 0;           // cs's first row
    if (kWide) {
      for (int i = tid; i < (smax - p0) * dk; i += kF32Threads) {
        const int t = i / dk, k = i - t * dk;
        cs[t * ldk + k] = cg[(long long)(p0 + t) * dk + k];
      }
      __syncthreads();
    }
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
            acc[j] = fmaf(cs[(r - c0) * ldk + k], bk, acc[j]);
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
        const float v0 = col < wt ? vs[si * wt + col] : 0.f;
        const float v1 = col + 64 < wt ? vs[si * wt + col + 64] : 0.f;
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
          if (col < wt) yg[r * dv + col] = acc[j][0];
          if (col + 64 < wt) yg[r * dv + col + 64] = acc[j][1];
        }
      }
    }
    __syncthreads();
  }
}

// A block a (g, dv tile), as chunk_local_f32_kernel.
template <bool kWide>
__global__ void __launch_bounds__(kF32Threads)
chunk_apply_f32_kernel(const float* __restrict__ c,
                       const float* __restrict__ ca,
                       const float* __restrict__ yin,
                       const float* __restrict__ sp, float* __restrict__ out,
                       int L, int dk, int dv, int tw) {
  extern __shared__ float smem[];
  const int ldk = dk + 1;
  const int col0 = kWide ? blockIdx.y * tw : 0;
  const int wt = kWide ? min(tw, dv - col0) : dv;   // this tile's columns
  float* cw = smem;               // L (kWide: kPanel) x ldk: C . exp(ca)
  float* sps = cw + (kWide ? kPanel : L) * ldk;   // dk x wt: S_prev

  const long long g = blockIdx.x;
  const int tid = threadIdx.x;
  const float* cg = c + g * L * dk;
  const float* cag = ca + g * L;
  if (!kWide) {
    for (int i = tid; i < L * dk; i += kF32Threads) {
      const int t = i / dk, k = i - t * dk;
      cw[t * ldk + k] = cg[i] * expf(cag[t]);
    }
  }
  const float* spg = sp + g * dk * dv + col0;
  for (int i = tid; i < dk * wt; i += kF32Threads) {
    if (kWide) {
      const int k = i / wt, j = i - k * wt;
      sps[i] = spg[(long long)k * dv + j];
    } else {
      sps[i] = spg[i];
    }
  }
  __syncthreads();

  const int col = tid % 64;
  const int r0 = tid / 64;                   // 0..3
  const float* yg = yin + g * L * dv + col0;
  float* og = out + g * L * dv + col0;
  for (int p0 = 0; p0 < L; p0 += kPanel) {
    const int c0 = kWide ? p0 : 0;           // cw's first row
    if (kWide) {
      const int rows = min(kPanel, L - p0);
      for (int i = tid; i < rows * dk; i += kF32Threads) {
        const int t = i / dk, k = i - t * dk;
        cw[t * ldk + k] = cg[(long long)(p0 + t) * dk + k] * expf(cag[p0 + t]);
      }
      __syncthreads();
    }
    float acc[4][2];
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[j][0] = acc[j][1] = 0.f;
    for (int k = 0; k < dk; ++k) {
      const float s0 = col < wt ? sps[k * wt + col] : 0.f;
      const float s1 = col + 64 < wt ? sps[k * wt + col + 64] : 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = min(p0 + r0 + 4 * j, L - 1);
        const float cv = cw[(r - c0) * ldk + k];
        acc[j][0] = fmaf(cv, s0, acc[j][0]);
        acc[j][1] = fmaf(cv, s1, acc[j][1]);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = p0 + r0 + 4 * j;
      if (r < L) {
        if (col < wt) {
          const int at = r * dv + col;
          og[at] = yg[at] + acc[j][0];
        }
        if (col + 64 < wt) {
          const int at = r * dv + col + 64;
          og[at] = yg[at] + acc[j][1];
        }
      }
    }
    if (kWide) __syncthreads();   // every thread has read this panel of cw
  }
}

bool shape_ok(int g, int L, int dk, int dv) {
  return g >= 1 && L >= 1 && L <= kMaxL && dk >= 8 && dk <= kMaxD &&
         dk % 8 == 0 && dv >= 8 && dv <= kMaxD && dv % 8 == 0;
}

template <typename K, typename... Args>
int launch_f32(K kernel, size_t smem, dim3 grid, cudaStream_t st,
               Args... args) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, kF32Threads, smem, st>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (c, b, v and y); ca (g, L) and s (g, dk, dv)
// float32; all contiguous, and 16-byte aligned for bfloat16.  Returns a
// cudaError_t, or cudaErrorInvalidValue for a shape outside L <= 128, dk,
// dv in 8..256 and multiples of 8.
extern "C" int chunk_local_launch(int dtype, const void* c, const void* b,
                                  const void* v, const void* ca, void* y,
                                  void* s, int g, int L, int dk, int dv,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!shape_ok(g, L, dk, dv)) return (int)cudaErrorInvalidValue;
  const int tw = tile_width(dv);
  if (dtype == 0) {
    const bool w = wide(dk, dv);
    const dim3 grid(g, (dv + tw - 1) / tw);
    const auto kernel = w ? chunk_local_f32_kernel<true>
                          : chunk_local_f32_kernel<false>;
    return launch_f32(
        kernel, local_smem_bytes(L, dk, tw, w), grid, st,
        static_cast<const float*>(c), static_cast<const float*>(b),
        static_cast<const float*>(v), static_cast<const float*>(ca),
        static_cast<float*>(y), static_cast<float*>(s), L, dk, dv, tw);
  }
  if (dtype == 1) {
    CHUNK_SCAN_BY_DVP(launch_local_bf16, wide(dk, dv), pad16(tw), c, b, v,
                      ca, y, s, g, L, dk, dv, tw, st);
  }
  return (int)cudaErrorInvalidValue;
}

// dtype: 0 float32, 1 bfloat16 (c, y_intra and out); ca (g, L) and s_prev
// (g, dk, dv) float32; all contiguous, and 16-byte aligned for bfloat16.
extern "C" int chunk_apply_launch(int dtype, const void* c, const void* ca,
                                  const void* y_intra, const void* s_prev,
                                  void* out, int g, int L, int dk, int dv,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!shape_ok(g, L, dk, dv)) return (int)cudaErrorInvalidValue;
  const int tw = tile_width(dv);
  if (dtype == 0) {
    const bool w = wide(dk, dv);
    const dim3 grid(g, (dv + tw - 1) / tw);
    const auto kernel = w ? chunk_apply_f32_kernel<true>
                          : chunk_apply_f32_kernel<false>;
    return launch_f32(
        kernel, apply_smem_bytes(L, dk, tw, w), grid, st,
        static_cast<const float*>(c), static_cast<const float*>(ca),
        static_cast<const float*>(y_intra), static_cast<const float*>(s_prev),
        static_cast<float*>(out), L, dk, dv, tw);
  }
  if (dtype == 1) {
    CHUNK_SCAN_BY_DVP(launch_apply_bf16, wide(dk, dv), pad16(tw), c, ca,
                      y_intra, s_prev, out, g, L, dk, dv, tw, st);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* chunk_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
