// One round of a compiled scan plan for Hopper (sm_90a): fused_round.
//
// Replaces repro/kernels/tile_scan.py:fused_round, the Pallas TPU kernel of
// the engine's "pallas" backend in rounds mode: one launch per plan round,
// so the paper's circuits (Sklansky, Brent-Kung, Ladner-Fischer,
// dissemination, Blelloch) run as rounds on the device.
//
// What it computes: for an (n, D) float32 buffer y and the round's operand
// table src (n) of int2 (kernels/_tiling.py:round_sources),
//   out[r] = op(y[src[r].x], y[src[r].y])   where src[r].y >= 0 (combines),
//   out[r] = y[src[r].x]                    otherwise (moves; kept rows have
//                                            src[r].x == r),
// under one operator of scan_ops.cuh's table, op(earlier, later).  The TPU
// kernel did the same with one-hot matrices, y*keep + SC@op(GA@y, GB@y) +
// SM@(GM@y), because Mosaic restricts dynamic-index loads; on Hopper a
// thread loads by index, so the n x m matrices (1 GiB each at n = 2^14)
// never exist and a 0 * inf in a one-hot product cannot turn into NaN.
//
// All reads of a round happen before any write (plan.py): dissemination
// reads rows the same round rewrites, so out is a second buffer, never y.
//
// What bounds it: it reads y once (n*D*4 bytes, plus the second operands
// of the combined rows) and src once (8n bytes) and writes out once (n*D*4
// bytes): at n = 2^16, D = 1, 1.05 MB, 0.31 us at 3.35 TB/s, far under a
// launch.  A round is launch-bound at the sizes a scan plan is built for,
// and a rounds-mode scan costs about its round count in launches.
//
// Design: one thread an output row, every row written exactly once by one
// thread; src is read as one 8-byte int2 a thread (coalesced across the
// warp), the row's D lanes as D consecutive floats.  This is the simple,
// correct kernel: fusing all rounds of a plan into one launch is later work.

#include <cuda_runtime.h>

#include "scan_ops.cuh"

namespace {

using namespace scan_ops;

template <int OP, int D>
__global__ void __launch_bounds__(kThreads)
fused_round_kernel(const float* __restrict__ y,   // (n, D)
                   const int2* __restrict__ src,  // (n)
                   float* __restrict__ out,       // (n, D)
                   int n) {
  using C = Combine<OP, D, false>;
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= n) return;
  const int2 s = src[r];
  Row<D> v = load_row<D>(y + (long long)s.x * D);
  if (s.y >= 0) v = C::apply(v, load_row<D>(y + (long long)s.y * D));
  store_row<D>(out + (long long)r * D, v);
}

}  // namespace

// op, d: an entry of scan_ops.cuh's table; y and out (n, d) float32, out not
// y; src (n, 2) int32, 8-byte aligned, with 0 <= src[r][0] < n and
// src[r][1] < n.  Returns a cudaError_t, or cudaErrorInvalidValue for an
// (op, d) outside the table.
extern "C" int fused_round_launch(int op, int d, const void* y,
                                  const void* src, void* out, int n,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n < 1 || y == out) return (int)cudaErrorInvalidValue;
  return dispatch_entry(op, d, [&](auto e) {
    using E = decltype(e);
    fused_round_kernel<E::op, E::d>
        <<<(n + kThreads - 1) / kThreads, kThreads, 0, st>>>(
            static_cast<const float*>(y), static_cast<const int2*>(src),
            static_cast<float*>(out), n);
    return (int)cudaGetLastError();
  });
}

extern "C" const char* fused_round_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
