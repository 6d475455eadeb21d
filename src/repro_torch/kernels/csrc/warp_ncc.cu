// Fused rigid warp + NCC partial sums for Hopper (sm_90a), and the NCC fold.
//
// Replaces repro/kernels/warp_ncc.py:_warp_ncc_kernel, the Pallas TPU kernel
// behind the registration operator's guess check (fused_ncc_distance), and
// the wrapper's fold of its sums into the NCC scalar (warp_ncc.py:108-115).
//
// What it computes, per output tile of tile x tile pixels (tile 16 or 32):
//   * the template img warped by phi(x) = R(angle)(x - c) + c + shift, with
//     c the image centre, coordinates clamped to the image and sampled
//     bilinearly, written to `warped`;
//   * the tile's row of `sums` (n_tiles x 8, f32, row-major tile order):
//     [sum a, sum b, sum a^2, sum b^2, sum a*b, tile*tile, 0, 0]
//     with a the warped pixel and b the reference pixel;
// and, when asked, a second one-block kernel folds the rows into
// [ncc, 1 - ncc] on the card, so a guess check is two launches.
//
// What bounds it: it reads the template and the reference once and writes
// the warped image once, 3*H*W*4 bytes plus the sums: about 44 MB at
// 1920x1920, so roughly 13 us at 3.35 TB/s.  It does ~30 flops a pixel, far
// below the f32 rate, so it is memory-bound.  On the card the template's
// gathers cost the most: without them the kernel streams the reference in
// and the warped image out at about 2.1 TB/s with cold frames.
//
// Design.  A block of 256 threads owns a patch of tile rows x kPatchCols
// columns (several tiles of one tile row) and takes cos and sin once.  Each
// thread owns one column of the patch and walks its rows, kUnroll rows in
// flight, so each load and store of a warp covers 32 adjacent pixels of a
// row: the reference and the warped image move in whole 128-byte lines,
// and the four template gathers of a row's pixels fall on one or two lines
// each, served by L1 from the L2-resident template.  Each thread's pixels
// lie in one tile; a tile's sums fold by shuffles within the lanes of its
// row, then over the block's row groups through shared memory, in a fixed
// order and with no float atomics, so the sums are the same from run to
// run.  The register cap (kMinBlocks) keeps four blocks an SM resident.
// (Measured and not kept: four adjacent pixels a thread with 16-byte loads
// and stores, whose gathers then stride four floats across a warp; staging
// a patch's template box in shared memory by cp.async, with or without a
// two-stage ring over patches; a resident grid walking the patches;
// evict-first hints on the two streams; bulk L2 prefetches of a patch's
// rows.)  The build uses -fmad=false so each product and sum rounds as the
// plain PyTorch version's separate operations do; the one fused
// multiply-add of the rotation is explicit.  The angle and the shift are
// read from the deformation's own device tensors.  The fold is one block:
// each column summed in double in a fixed order, then the plain fold's f32
// arithmetic.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
// Columns a block's patch covers (a multiple of 32): a patch is tile rows
// x kPatchCols columns, kPatchCols / tile tiles of one tile row.  Each
// thread owns one column of the patch and walks its rows, so a warp's
// loads and stores cover 32 adjacent pixels of a row.
constexpr int kPatchCols = 64;
// The unrolling of a thread's walk down its column: the loads of that many
// rows can be in flight at once.
constexpr int kUnroll = 8;
// Resident blocks an SM the register allocation must allow (64 registers
// a thread: four blocks of 256 threads).
constexpr int kMinBlocks = 4;
// Ablation switches (tools/kernel_variants.py): 0 drops the template
// gathers, the warped store, or the block reduction.
constexpr int kGather = 1;
constexpr int kStore = 1;
constexpr int kReduce = 1;

constexpr int kFoldThreads = 1024;

template <int TILE>
struct Geometry {
  static constexpr int kRowsPerPass = kThreads / kPatchCols;
  static constexpr int kPasses = TILE / kRowsPerPass;   // rows a thread
  static constexpr int kTiles = kPatchCols / TILE;      // tiles a patch
  static_assert(kPatchCols % 32 == 0 && kThreads % kPatchCols == 0,
                "patch");
  static_assert(kPasses >= 1 && TILE % kRowsPerPass == 0, "passes");
};

struct Frame {
  float cs, sn, cy, cx, sy, sx, hmax, wmax;
  int h, w;
};

// phi(x) for the pixel at (row, col), clamped to the image: frow and fcol
// are row - cy and col - cx, the row terms cs * frow and sn * frow.
__device__ __forceinline__ void coords(const Frame& f, float cs_row,
                                       float sn_row, float fcol, float& ry,
                                       float& rx) {
  // R (x - c) as the plain version (and XLA's dot) rounds it: the
  // column term fused onto the rounded row term.
  ry = fmaf(-f.sn, fcol, cs_row) + f.cy + f.sy;
  rx = fmaf(f.cs, fcol, sn_row) + f.cx + f.sx;
  ry = fminf(fmaxf(ry, 0.0f), f.hmax);
  rx = fminf(fmaxf(rx, 0.0f), f.wmax);
}

// Bilinear sample of the template at (ry, rx), through L1 from the
// L2-resident image.
__device__ __forceinline__ float sample(const Frame& f,
                                        const float* __restrict__ img,
                                        float ry, float rx) {
  const float fy0 = floorf(ry);
  const float fx0 = floorf(rx);
  const int y0 = (int)fy0;
  const int x0 = (int)fx0;
  const int y1 = min(y0 + 1, f.h - 1);
  const int x1 = min(x0 + 1, f.w - 1);
  const float fy = ry - fy0;
  const float fx = rx - fx0;
  float v00, v01, v10, v11;
  if (kGather) {
    const float* r0 = img + y0 * f.w;
    const float* r1 = img + y1 * f.w;
    v00 = __ldg(r0 + x0);
    v01 = __ldg(r0 + x1);
    v10 = __ldg(r1 + x0);
    v11 = __ldg(r1 + x1);
  } else {
    v00 = fx; v01 = fy; v10 = (float)x1; v11 = (float)y1;
  }
  const float top = v00 * (1.0f - fx) + v01 * fx;
  const float bot = v10 * (1.0f - fx) + v11 * fx;
  return top * (1.0f - fy) + bot * fy;
}

struct Sums {
  float a, b, aa, bb, ab;
};

// This thread's column of a patch: rows g, g + kRowsPerPass, ... of column
// col.  Warp the pixels, store them, accumulate the sums.
template <int TILE>
__device__ __forceinline__ void patch_pixels(
    const Frame& f, const float* __restrict__ img,
    const float* __restrict__ ref, float* __restrict__ warped, int r0,
    int col, Sums& s) {
  using G = Geometry<TILE>;
  const float fcol = (float)col - f.cx;
#pragma unroll kUnroll
  for (int i = 0; i < G::kPasses; ++i) {
    const int row = r0 + i * G::kRowsPerPass;
    const int at = row * f.w + col;
    const float b = __ldg(ref + at);
    const float frow = (float)row - f.cy;
    float ry, rx;
    coords(f, f.cs * frow, f.sn * frow, fcol, ry, rx);
    const float a = sample(f, img, ry, rx);
    if (kStore || f.h < 0) warped[at] = a;
    s.a += a;
    s.b += b;
    s.aa += a * a;
    s.bb += b * b;
    s.ab += a * b;
  }
}

template <int TILE>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
warp_ncc_kernel(const float* __restrict__ angle,    // ()
                const float* __restrict__ shift,    // (2,) [y, x]
                const float* __restrict__ img,      // (h, w) template
                const float* __restrict__ ref,      // (h, w) reference
                float* __restrict__ warped,         // (h, w)
                float* __restrict__ sums,           // (n_tiles, 8)
                int h, int w) {
  using G = Geometry<TILE>;
  __shared__ float part[5][G::kRowsPerPass][G::kTiles];

  Frame f;
  const float ang = __ldg(angle);
  f.cs = cosf(ang);
  f.sn = sinf(ang);
  f.sy = __ldg(shift);
  f.sx = __ldg(shift + 1);
  f.cy = (h - 1) / 2.0f;
  f.cx = (w - 1) / 2.0f;
  f.hmax = h - 1.0f;
  f.wmax = w - 1.0f;
  f.h = h;
  f.w = w;

  const int tid = threadIdx.x;
  const int g = tid / kPatchCols;                // row within a pass
  const int q = tid % kPatchCols;                // column within the patch
  const int tiles_w = w / TILE;
  const int patches_w = (w + kPatchCols - 1) / kPatchCols;
  const int ti = blockIdx.x / patches_w;         // tile row
  const int pc = blockIdx.x - ti * patches_w;    // patch within it
  const int r0 = ti * TILE;
  const int c0 = pc * kPatchCols;
  const int c_end = min(c0 + kPatchCols, w);

  Sums s = {0.f, 0.f, 0.f, 0.f, 0.f};
  if (c0 + q < c_end)
    patch_pixels<TILE>(f, img, ref, warped, r0 + g, c0 + q, s);

  if (!kReduce) {
    if (h < 0) sums[tid] = s.a + s.b + s.aa + s.bb + s.ab;
    if (tid < G::kTiles * 8) {
      const int tj = pc * G::kTiles + tid / 8;
      if (tj < tiles_w) {
        sums[(ti * tiles_w + tj) * 8 + tid % 8] =
            tid % 8 == 5 ? (float)(TILE * TILE) : 0.f;
      }
    }
    return;
  }
  // A tile row's lanes (a warp, or half of one at tile 16), then the
  // row groups of the tile in order.
#pragma unroll
  for (int off = (TILE < 32 ? TILE : 32) / 2; off > 0; off >>= 1) {
    s.a += __shfl_xor_sync(0xffffffffu, s.a, off);
    s.b += __shfl_xor_sync(0xffffffffu, s.b, off);
    s.aa += __shfl_xor_sync(0xffffffffu, s.aa, off);
    s.bb += __shfl_xor_sync(0xffffffffu, s.bb, off);
    s.ab += __shfl_xor_sync(0xffffffffu, s.ab, off);
  }
  if (q % TILE == 0) {
    const int t = q / TILE;
    part[0][g][t] = s.a;
    part[1][g][t] = s.b;
    part[2][g][t] = s.aa;
    part[3][g][t] = s.bb;
    part[4][g][t] = s.ab;
  }
  __syncthreads();
  if (tid < G::kTiles * 8) {
    const int t = tid / 8;
    const int c = tid % 8;
    const int tj = pc * G::kTiles + t;
    if (tj < tiles_w) {
      float v = 0.f;
      if (c < 5) {
#pragma unroll
        for (int i = 0; i < G::kRowsPerPass; ++i) v += part[c][i][t];
      } else if (c == 5) {
        v = (float)(TILE * TILE);        // tile area, not valid-pixel count
      }
      sums[(ti * tiles_w + tj) * 8 + c] = v;
    }
  }
}

// [ncc, 1 - ncc] from the (n, 8) rows, as warp_ncc.py:fold computes it:
// each column summed in double, in a fixed order (a thread's strided rows,
// read 16 bytes at a time, then a shuffle tree in each warp and one over
// the warps), then the fold's float32 arithmetic.
__global__ void __launch_bounds__(kFoldThreads)
warp_ncc_fold_kernel(const float* __restrict__ sums, int n,
                     float* __restrict__ out) {
  __shared__ double part[6][kFoldThreads / 32];
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  double acc[6] = {0, 0, 0, 0, 0, 0};
  for (int i = tid; i < n; i += kFoldThreads) {
    const float4 lo = __ldg(reinterpret_cast<const float4*>(sums) + 2 * i);
    const float2 hi =
        __ldg(reinterpret_cast<const float2*>(sums + 8 * i + 4));
    acc[0] += (double)lo.x;
    acc[1] += (double)lo.y;
    acc[2] += (double)lo.z;
    acc[3] += (double)lo.w;
    acc[4] += (double)hi.x;
    acc[5] += (double)hi.y;
  }
#pragma unroll
  for (int c = 0; c < 6; ++c) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc[c] += __shfl_xor_sync(0xffffffffu, acc[c], off);
    if (lane == 0) part[c][warp] = acc[c];
  }
  __syncthreads();
  if (warp != 0) return;
#pragma unroll
  for (int c = 0; c < 6; ++c) {
    acc[c] = lane < kFoldThreads / 32 ? part[c][lane] : 0.0;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc[c] += __shfl_xor_sync(0xffffffffu, acc[c], off);
  }
  if (lane == 0) {
    const float sa = (float)acc[0], sb = (float)acc[1];
    const float saa = (float)acc[2], sbb = (float)acc[3];
    const float sab = (float)acc[4], cnt = (float)acc[5];
    const float cov = sab - sa * sb / cnt;
    const float va = saa - sa * sa / cnt;
    const float vb = sbb - sb * sb / cnt;
    const float ncc = cov / (sqrtf(va * vb) + 1e-6f);
    out[0] = ncc;
    out[1] = 1.0f - ncc;
  }
}

template <int TILE>
cudaError_t launch_tile(const float* angle, const float* shift,
                        const float* img, const float* ref, float* warped,
                        float* sums, int h, int w, cudaStream_t st) {
  const int patches = ((w + kPatchCols - 1) / kPatchCols) * (h / TILE);
  warp_ncc_kernel<TILE><<<patches, kThreads, 0, st>>>(
      angle, shift, img, ref, warped, sums, h, w);
  return cudaGetLastError();
}

}  // namespace

// Launches the warp kernel and, when ncc is not null, the fold after it on
// the same stream.
extern "C" int warp_ncc_launch(const void* angle, const void* shift,
                               const void* img, const void* ref, void* warped,
                               void* sums, void* ncc, int h, int w,
                               int tile, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tile != 16 && tile != 32) return (int)cudaErrorInvalidValue;
  if (h <= 0 || w <= 0 || h % tile || w % tile)
    return (int)cudaErrorInvalidValue;
  const float* a = static_cast<const float*>(angle);
  const float* sh = static_cast<const float*>(shift);
  const float* im = static_cast<const float*>(img);
  const float* rf = static_cast<const float*>(ref);
  float* wp = static_cast<float*>(warped);
  float* sm = static_cast<float*>(sums);
  cudaError_t e = tile == 32
      ? launch_tile<32>(a, sh, im, rf, wp, sm, h, w, st)
      : launch_tile<16>(a, sh, im, rf, wp, sm, h, w, st);
  if (e != cudaSuccess || ncc == nullptr) return (int)e;
  const int n_tiles = (h / tile) * (w / tile);
  warp_ncc_fold_kernel<<<1, kFoldThreads, 0, st>>>(
      sm, n_tiles, static_cast<float*>(ncc));
  return (int)cudaGetLastError();
}

extern "C" const char* warp_ncc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
