// Function A's gradient step on Hopper (sm_90a): for every lane of a batch,
// the loss D = 1 - NCC(ref, tmpl o phi) and its analytic gradient in
// [angle, shift_y, shift_x] from one pass over the output pixels, then the
// descent's masked update, in two launches.
//
// Replaces no TPU kernel.  The reference differentiates its loss with
// jax.grad inside one jitted lax.while_loop (src/repro/core/registration.py
// :102), which XLA fuses.  The port's plain route, core/registration.py's
// _minimize_level on the CPU, is torch.autograd over warp -> bilinear
// sample -> ncc: on the card about a hundred full-frame elementwise,
// gather, cat and reduce kernels a step.
//
// What it computes.  A lane is a frame pair (ref, tmpl), both h x w, and a
// point [angle, shift_y, shift_x].  For each output pixel x, with a the
// reference pixel and b the template sampled at phi(x) (the coordinates
// of deformation.py:warp_coords, clamped to the frame, then
// _bilinear_sample's blend), the sums kernel takes
//   b_p = db/dp = g_r dry/dp + g_c drx/dp,
// g_r = bot - top and g_c = (v01 - v00)(1 - fy) + (v11 - v10) fy the taps'
// gradients, each zero where the clamp held its coordinate (torch.clamp
// passes its gradient inside [0, h - 1] inclusive), dry/dangle =
// -c rel_c - s rel_r, drx/dangle = -s rel_c + c rel_r, the shifts' unit
// vectors, and accumulates the 14 raw sums
//   [Sa, Sb, Saa, Sbb, Sab, Sb_p (3), Sa b_p (3), Sb b_p (3)].
// The step kernel folds them, in double, into
//   saa = Saa - Sa^2/N, sbb, sab, S = sqrt(saa sbb), den = S + 1e-6,
//   D = 1 - sab/den,
//   dD/dp = -[(Sa b_p - Sa Sb_p/N)/den - sab/den^2 saa (Sb b_p - Sb Sb_p/N)/S]
// and applies _minimize_level's masked update: an active lane moves to the
// point the sums were taken at, prev = cur, cur = D, it += 1; then
// act = it < max_iters && |prev - cur| > tol in float32, the next point
// d - lr g, and the one-word `more` flag the host reads.
//
// What bounds it: a step reads each active lane's reference and template
// once, 8 h w bytes a lane (8 x 2 x 14.25 MB at 1856 x 1920: 68 us at
// 3.35 TB/s), and does ~70 flops a pixel, under the f32 rate: bytes.  Like
// warp_ncc, the template's gathers (served by L1 from the L2-resident
// template at small angles) cost the most.
//
// Design.  The sums kernel's grid is (chunk, lane): a block of 256 threads
// takes kChunk consecutive pixels of the row-major frame, a thread every
// 256th of them, so each warp's reference loads cover 32 adjacent pixels
// and its template gathers one or two lines a tap.  A thread sums its
// pixels in float32; the block folds its threads' sums in double by
// shuffles and over its warps in a fixed order and writes one double a sum
// (no float atomics).  The step kernel, a block a lane, folds a lane's
// block sums in a fixed order.  The partition depends on (h, w) alone, so
// a lane's sums, and its whole step, are the same bits whatever batch it
// runs in and from launch to launch.  A lane frozen before the step
// (act == 0) skips both kernels: its state stays as it is, as the plain
// loop's torch.where keeps it.  The build's -fmad=false keeps each product
// and sum rounded as the plain version's separate operations; the
// rotation's one fused multiply-add is explicit (__fmaf_rn), so the
// coordinates match warp_coords' bit for bit.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// Pixels a thread (a block takes kThreads x kPerThread of them).
constexpr int kPerThread = 16;
constexpr int kChunk = kThreads * kPerThread;
constexpr int kSums = 14;
constexpr int kStepThreads = 256;
constexpr int kStepWarps = kStepThreads / 32;

// The per-lane state, float32 then int32, each a run of b values
// (shift and probe_shift 2 b, grad 3 b); kernels/ncc_grad.py lays it out
// alike.
struct State {
  float* angle;        // the accepted point
  float* shift;        // (b, 2) [y, x]
  float* probe_angle;  // the point the next sums pass evaluates
  float* probe_shift;
  float* grad;         // (b, 3) dD/d[angle, shift_y, shift_x]
  float* cur;          // D at the accepted point
  float* prev;
  int* it;
  int* act;
  int* more;           // one word: some lane is active
};

State state_of(float* f, int b) {
  State s;
  s.angle = f;
  s.shift = f + b;
  s.probe_angle = f + 3 * b;
  s.probe_shift = f + 4 * b;
  s.grad = f + 6 * b;
  s.cur = f + 9 * b;
  s.prev = f + 10 * b;
  int* i = reinterpret_cast<int*>(f + 11 * b);
  s.it = i;
  s.act = i + b;
  s.more = i + 2 * b;
  return s;
}

__global__ void __launch_bounds__(kThreads)
ncc_grad_sums_kernel(const float* __restrict__ ref,   // (b, h, w)
                     const float* __restrict__ tmpl,  // (b, h, w)
                     State st, int first,
                     double* __restrict__ partials,   // (b, 14, n_chunks)
                     int h, int w, int n_chunks) {
  const int lane = blockIdx.y;
  const int chunk = blockIdx.x;
  const int tid = threadIdx.x;
  if (chunk == 0 && lane == 0 && tid == 0) *st.more = 0;
  if (!first && st.act[lane] == 0) return;

  const float* pa = first ? st.angle : st.probe_angle;
  const float* ps = first ? st.shift : st.probe_shift;
  const float ang = pa[lane];
  const float sy = ps[2 * lane];
  const float sx = ps[2 * lane + 1];
  const float cs = cosf(ang);
  const float sn = sinf(ang);
  const float cy = (h - 1) / 2.0f;
  const float cx = (w - 1) / 2.0f;
  const float hmax = h - 1.0f;
  const float wmax = w - 1.0f;
  const int npx = h * w;
  const float* __restrict__ rf = ref + (size_t)lane * npx;
  const float* __restrict__ tp = tmpl + (size_t)lane * npx;

  float acc[kSums];
#pragma unroll
  for (int c = 0; c < kSums; ++c) acc[c] = 0.0f;

  int idx = chunk * kChunk + tid;
  int row = idx / w;
  int col = idx - row * w;
#pragma unroll 4
  for (int k = 0; k < kPerThread; ++k) {
    if (idx < npx) {
      const float a = __ldg(rf + idx);
      const float frow = (float)row - cy;
      const float fcol = (float)col - cx;
      float ry = __fmaf_rn(-sn, fcol, cs * frow) + cy + sy;
      float rx = __fmaf_rn(cs, fcol, sn * frow) + cx + sx;
      const bool in_r = ry >= 0.0f && ry <= hmax;
      const bool in_c = rx >= 0.0f && rx <= wmax;
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
      const float* r0 = tp + (size_t)y0 * w;
      const float* r1 = tp + (size_t)y1 * w;
      const float v00 = __ldg(r0 + x0);
      const float v01 = __ldg(r0 + x1);
      const float v10 = __ldg(r1 + x0);
      const float v11 = __ldg(r1 + x1);
      const float top = v00 * (1.0f - fx) + v01 * fx;
      const float bot = v10 * (1.0f - fx) + v11 * fx;
      const float b = top * (1.0f - fy) + bot * fy;
      const float g_r = in_r ? bot - top : 0.0f;
      const float g_c =
          in_c ? (v01 - v00) * (1.0f - fy) + (v11 - v10) * fy : 0.0f;
      const float b_a =
          g_r * (-cs * fcol - sn * frow) + g_c * (cs * frow - sn * fcol);
      acc[0] += a;
      acc[1] += b;
      acc[2] += a * a;
      acc[3] += b * b;
      acc[4] += a * b;
      acc[5] += b_a;
      acc[6] += g_r;
      acc[7] += g_c;
      acc[8] += a * b_a;
      acc[9] += a * g_r;
      acc[10] += a * g_c;
      acc[11] += b * b_a;
      acc[12] += b * g_r;
      acc[13] += b * g_c;
    }
    idx += kThreads;
    col += kThreads;
    while (col >= w) {
      col -= w;
      ++row;
    }
  }

  __shared__ double part[kWarps][kSums];
  const int wid = tid / 32;
#pragma unroll
  for (int c = 0; c < kSums; ++c) {
    double v = (double)acc[c];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_xor_sync(0xffffffffu, v, off);
    if (tid % 32 == 0) part[wid][c] = v;
  }
  __syncthreads();
  if (tid < kSums) {
    double s = 0.0;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) s += part[i][tid];
    partials[((size_t)lane * kSums + tid) * n_chunks + chunk] = s;
  }
}

__global__ void __launch_bounds__(kStepThreads)
ncc_grad_step_kernel(const double* __restrict__ partials, int n_chunks,
                     double n_px, State st, int first,
                     double* __restrict__ sums,   // (b, 14)
                     float lr_angle, float lr_shift, float tol,
                     int max_iters) {
  const int l = blockIdx.x;
  const int tid = threadIdx.x;
  if (!first && st.act[l] == 0) return;

  double acc[kSums];
#pragma unroll
  for (int c = 0; c < kSums; ++c) acc[c] = 0.0;
  const double* p = partials + (size_t)l * kSums * n_chunks;
  for (int j = tid; j < n_chunks; j += kStepThreads) {
#pragma unroll
    for (int c = 0; c < kSums; ++c) acc[c] += p[(size_t)c * n_chunks + j];
  }
  __shared__ double part[kStepWarps][kSums];
  const int wid = tid / 32;
#pragma unroll
  for (int c = 0; c < kSums; ++c) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc[c] += __shfl_xor_sync(0xffffffffu, acc[c], off);
    if (tid % 32 == 0) part[wid][c] = acc[c];
  }
  __syncthreads();
  if (tid != 0) return;

  double s[kSums];
#pragma unroll
  for (int c = 0; c < kSums; ++c) {
    double v = 0.0;
#pragma unroll
    for (int i = 0; i < kStepWarps; ++i) v += part[i][c];
    s[c] = v;
    sums[(size_t)l * kSums + c] = v;
  }
  const double n = n_px;
  const double saa = s[2] - s[0] * s[0] / n;
  const double sbb = s[3] - s[1] * s[1] / n;
  const double sab = s[4] - s[0] * s[1] / n;
  const double root = sqrt(saa * sbb);
  const double den = root + 1e-6;
  const float loss = (float)(1.0 - sab / den);
  float g[3];
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    const double dsab = s[8 + q] - s[0] * s[5 + q] / n;
    const double dsbb = s[11 + q] - s[1] * s[5 + q] / n;
    g[q] = (float)(-(dsab / den - sab / (den * den) * saa * dsbb / root));
  }

  float ang, sy, sx, cur, prev;
  int it;
  if (first) {
    ang = st.angle[l];
    sy = st.shift[2 * l];
    sx = st.shift[2 * l + 1];
    cur = loss;
    prev = loss + 1.0f;
    it = 0;
  } else {
    ang = st.probe_angle[l];
    sy = st.probe_shift[2 * l];
    sx = st.probe_shift[2 * l + 1];
    st.angle[l] = ang;
    st.shift[2 * l] = sy;
    st.shift[2 * l + 1] = sx;
    prev = st.cur[l];
    cur = loss;
    it = st.it[l] + 1;
  }
  st.cur[l] = cur;
  st.prev[l] = prev;
  st.it[l] = it;
#pragma unroll
  for (int q = 0; q < 3; ++q) st.grad[3 * l + q] = g[q];
  const int active = it < max_iters && fabsf(prev - cur) > tol;
  st.act[l] = active;
  st.probe_angle[l] = ang - lr_angle * g[0];
  st.probe_shift[2 * l] = sy - lr_shift * g[1];
  st.probe_shift[2 * l + 1] = sx - lr_shift * g[2];
  // Every active lane writes the same word: no atomics needed.
  if (active) *st.more = 1;
}

}  // namespace

extern "C" int ncc_grad_chunk_pixels() { return kChunk; }

// One sums pass and one fold/update on the stream: first != 0 evaluates
// the accepted point of every lane and starts the descent there (cur, prev
// = cur + 1, it = 0), else an active lane's probe point, and moves it.
// state: the float32 and int32 state (11 b floats, then 2 b + 1 ints);
// scratch: b x 14 doubles of sums, then b x 14 x n_chunks of block sums.
extern "C" int ncc_grad_launch(const void* ref, const void* tmpl, void* state,
                               void* scratch, int b, int h, int w,
                               float lr_angle, float lr_shift, float tol,
                               int max_iters, int first, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b <= 0 || b > 65535 || h <= 0 || w <= 0)
    return (int)cudaErrorInvalidValue;
  if ((long long)h * w + kChunk >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const int n_chunks = (h * w + kChunk - 1) / kChunk;
  State s = state_of(static_cast<float*>(state), b);
  double* sums = static_cast<double*>(scratch);
  double* partials = sums + (size_t)b * kSums;
  ncc_grad_sums_kernel<<<dim3(n_chunks, b), kThreads, 0, st>>>(
      static_cast<const float*>(ref), static_cast<const float*>(tmpl), s,
      first, partials, h, w, n_chunks);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ncc_grad_step_kernel<<<b, kStepThreads, 0, st>>>(
      partials, n_chunks, (double)h * (double)w, s, first, sums, lr_angle,
      lr_shift, tol, max_iters);
  return (int)cudaGetLastError();
}

extern "C" const char* ncc_grad_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
