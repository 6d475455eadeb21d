// Fused rigid warp + NCC partial sums for Hopper (sm_90a).
//
// Replaces repro/kernels/warp_ncc.py:_warp_ncc_kernel, the Pallas TPU kernel
// behind the registration operator's guess check (fused_ncc_distance).
//
// What it computes, per output tile of tile x tile pixels (tile 16 or 32):
//   * the template img warped by phi(x) = R(angle)(x - c) + c + shift, with
//     c the image centre, coordinates clamped to the image and sampled
//     bilinearly, written to `warped`;
//   * the tile's row of `sums` (n_tiles x 8, f32):
//     [sum a, sum b, sum a^2, sum b^2, sum a*b, tile*tile, 0, 0]
//     with a the warped pixel and b the reference pixel.
// The host folds the rows into the NCC scalar (kernels/warp_ncc.py).
//
// What bounds it: it reads the template and the reference once and writes
// the warped image once, 3*H*W*4 bytes plus the sums: about 44 MB at
// 1920x1920, so roughly 13 us at 3.35 TB/s.  It does ~30 flops a pixel, far
// below the f32 rate, so it is memory-bound.
//
// Design.  The TPU kernel held the whole template in VMEM; an SM's 227 KB of
// shared memory cannot, so the four corner reads go to global memory and are
// served from the 50 MB L2, which holds a 14.7 MB template whole.  One block
// of 256 threads per output tile; each thread computes tile*tile/256 pixels
// of one column, so neighbouring threads touch neighbouring addresses.  The
// block reduction is warp shuffles then shared memory, in f32 and in a fixed
// order, with no atomics: the sums are the same from run to run.  cos and sin
// are taken with the accurate cosf/sinf from the device-side parameters, so
// the launch needs no host synchronisation.  The build uses -fmad=false so
// each product and sum rounds as the plain PyTorch version's separate
// operations do; the one fused multiply-add of the rotation is explicit.
//
// This first version is the simple, correct kernel; making it fast (cp.async
// or TMA staging of the reference tile, several tiles per block, a single
// pass over the template rows a tile needs) is later work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <int TILE>
__global__ void __launch_bounds__(kThreads)
warp_ncc_kernel(const float* __restrict__ params,   // [angle, shift_y, shift_x]
                const float* __restrict__ img,      // (h, w) template
                const float* __restrict__ ref,      // (h, w) reference
                float* __restrict__ warped,         // (h, w)
                float* __restrict__ sums,           // (n_tiles, 8)
                int h, int w) {
  constexpr int kRowsPerPass = kThreads / TILE;
  static_assert(TILE % kRowsPerPass == 0, "tile must divide by its passes");

  const float ang = params[0];
  const float sy = params[1];
  const float sx = params[2];
  const float cs = cosf(ang);
  const float sn = sinf(ang);
  const float cy = (h - 1) / 2.0f;
  const float cx = (w - 1) / 2.0f;
  const float hmax = h - 1.0f;
  const float wmax = w - 1.0f;

  const int tj = blockIdx.x;                 // tile column
  const int ti = blockIdx.y;                 // tile row
  const int lx = threadIdx.x % TILE;
  const int ly0 = threadIdx.x / TILE;
  const int col = tj * TILE + lx;
  const float fcol = (float)col - cx;

  float s_a = 0.f, s_b = 0.f, s_aa = 0.f, s_bb = 0.f, s_ab = 0.f;
#pragma unroll
  for (int ly = ly0; ly < TILE; ly += kRowsPerPass) {
    const int row = ti * TILE + ly;
    const float frow = (float)row - cy;
    // R (x - c) as the plain version (and XLA's dot) rounds it: the
    // column term fused onto the rounded row term.
    float ry = fmaf(-sn, fcol, cs * frow) + cy + sy;
    float rx = fmaf(cs, fcol, sn * frow) + cx + sx;
    ry = fminf(fmaxf(ry, 0.0f), hmax);
    rx = fminf(fmaxf(rx, 0.0f), wmax);
    const float fy0 = floorf(ry);
    const float fx0 = floorf(rx);
    const int y0 = (int)fy0;
    const int x0 = (int)fx0;
    const int y1 = min(y0 + 1, h - 1);
    const int x1 = min(x0 + 1, w - 1);
    const float fy = ry - fy0;
    const float fx = rx - fx0;
    const float v00 = __ldg(img + (size_t)y0 * w + x0);
    const float v01 = __ldg(img + (size_t)y0 * w + x1);
    const float v10 = __ldg(img + (size_t)y1 * w + x0);
    const float v11 = __ldg(img + (size_t)y1 * w + x1);
    const float top = v00 * (1.0f - fx) + v01 * fx;
    const float bot = v10 * (1.0f - fx) + v11 * fx;
    const float a = top * (1.0f - fy) + bot * fy;
    const size_t at = (size_t)row * w + col;
    warped[at] = a;
    const float b = __ldg(ref + at);
    s_a += a;
    s_b += b;
    s_aa += a * a;
    s_bb += b * b;
    s_ab += a * b;
  }

  // Warp-level tree reduction, then one warp folds the per-warp partials.
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s_a += __shfl_down_sync(0xffffffffu, s_a, off);
    s_b += __shfl_down_sync(0xffffffffu, s_b, off);
    s_aa += __shfl_down_sync(0xffffffffu, s_aa, off);
    s_bb += __shfl_down_sync(0xffffffffu, s_bb, off);
    s_ab += __shfl_down_sync(0xffffffffu, s_ab, off);
  }
  __shared__ float part[5][kWarps];
  const int lane = threadIdx.x % 32;
  const int wid = threadIdx.x / 32;
  if (lane == 0) {
    part[0][wid] = s_a;
    part[1][wid] = s_b;
    part[2][wid] = s_aa;
    part[3][wid] = s_bb;
    part[4][wid] = s_ab;
  }
  __syncthreads();
  if (threadIdx.x < 8) {
    float v = 0.f;
    if (threadIdx.x < 5) {
#pragma unroll
      for (int i = 0; i < kWarps; ++i) v += part[threadIdx.x][i];
    } else if (threadIdx.x == 5) {
      v = (float)(TILE * TILE);          // tile area, not valid-pixel count
    }
    const int tile_id = ti * gridDim.x + tj;
    sums[(size_t)tile_id * 8 + threadIdx.x] = v;
  }
}

}  // namespace

extern "C" int warp_ncc_launch(const void* params, const void* img,
                               const void* ref, void* warped, void* sums,
                               int h, int w, int tile, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tile != 16 && tile != 32) return (int)cudaErrorInvalidValue;
  if (h <= 0 || w <= 0 || h % tile || w % tile) return (int)cudaErrorInvalidValue;
  dim3 grid(w / tile, h / tile);
  const float* p = static_cast<const float*>(params);
  const float* im = static_cast<const float*>(img);
  const float* rf = static_cast<const float*>(ref);
  float* wp = static_cast<float*>(warped);
  float* sm = static_cast<float*>(sums);
  if (tile == 32) {
    warp_ncc_kernel<32><<<grid, kThreads, 0, st>>>(p, im, rf, wp, sm, h, w);
  } else {
    warp_ncc_kernel<16><<<grid, kThreads, 0, st>>>(p, im, rf, wp, sm, h, w);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* warp_ncc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
