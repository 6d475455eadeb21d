// The operator table and the block-wide scan shared by the scan kernels
// (lookback_scan.cu, tile_scan.cu).
//
// A CUDA kernel cannot call the Python operator the engine scans with, so
// each scan kernel is compiled once per entry of this table and the wrapper
// maps the callable to an entry (kernels/op_table.py):
//
//   kOpAdd    a + b lane by lane, D lanes (1..4)
//   kOpRigid  rigid deformations packed [angle, shift0, shift1] (D = 3):
//             angle = a0 + b0, shift = R(b0) (a1, a2) + (b1, b2)
//
// Every combine is op(earlier, later): rigid composition does not commute,
// so the order is kept in every step of every scan.  The rigid entry uses
// the accurate cosf/sinf, and the build's -fmad=false rounds each product
// and sum on its own, as core/deformation.py:compose_batched's separate
// tensor operations do.
//
// MASKED adds one lane after the D operator lanes holding 1.0 for "this row
// is the operator identity" (kernels/_tiling.py:lift_masked): a flagged
// operand passes the other through, and the result is flagged only when
// both are.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace scan_ops {

constexpr int kOpAdd = 0;
constexpr int kOpRigid = 1;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

template <int W>
struct Row {
  float v[W];
};

template <int W>
__device__ __forceinline__ Row<W> load_row(const float* p) {
  Row<W> r;
#pragma unroll
  for (int j = 0; j < W; ++j) r.v[j] = p[j];
  return r;
}

// Load that bypasses L1: for values another block published.
template <int W>
__device__ __forceinline__ Row<W> load_row_cg(const float* p) {
  Row<W> r;
#pragma unroll
  for (int j = 0; j < W; ++j) r.v[j] = __ldcg(p + j);
  return r;
}

template <int W>
__device__ __forceinline__ void store_row(float* p, const Row<W>& r) {
#pragma unroll
  for (int j = 0; j < W; ++j) p[j] = r.v[j];
}

// The operator on lanes 0..D-1 of W-lane rows.
template <int OP, int D>
struct Op;

template <int D>
struct Op<kOpAdd, D> {
  template <int W>
  __device__ __forceinline__ static Row<W> apply(const Row<W>& a,
                                                 const Row<W>& b) {
    Row<W> r;
#pragma unroll
    for (int j = 0; j < D; ++j) r.v[j] = a.v[j] + b.v[j];
    return r;
  }
};

template <>
struct Op<kOpRigid, 3> {
  template <int W>
  __device__ __forceinline__ static Row<W> apply(const Row<W>& a,
                                                 const Row<W>& b) {
    const float c = cosf(b.v[0]);
    const float s = sinf(b.v[0]);
    const float ax = a.v[1];
    const float ay = a.v[2];
    Row<W> r;
    r.v[0] = a.v[0] + b.v[0];
    r.v[1] = (c * ax - s * ay) + b.v[1];
    r.v[2] = (s * ax + c * ay) + b.v[2];
    return r;
  }
};

// One table entry, optionally lifted over the identity-flag lane.
template <int OP, int D, bool MASKED>
struct Combine {
  static constexpr int W = D + (MASKED ? 1 : 0);
  __device__ __forceinline__ static Row<W> apply(const Row<W>& a,
                                                 const Row<W>& b) {
    Row<W> r = Op<OP, D>::template apply<W>(a, b);
    if constexpr (MASKED) {
      const float fa = a.v[D];
      const float fb = b.v[D];
#pragma unroll
      for (int j = 0; j < D; ++j) {
        r.v[j] = fa == 1.0f ? b.v[j] : (fb == 1.0f ? a.v[j] : r.v[j]);
      }
      r.v[D] = fa * fb;
    }
    return r;
  }
};

// A value that may be absent (a thread with no rows, the prefix before the
// first row): combining with an absent value passes the other through, so
// no identity element is needed.
template <class C, int W>
__device__ __forceinline__ void maybe_combine(Row<W>& acc, bool& has,
                                              const Row<W>& later,
                                              bool later_has) {
  if (!later_has) return;
  acc = has ? C::apply(acc, later) : later;
  has = true;
}

// Inclusive scan across the 32 lanes of a warp (Hillis-Steele by shuffles),
// lane i combining lane i-off's value on its left.
template <class C, int W>
__device__ __forceinline__ void warp_inclusive_scan(Row<W>& v, bool& has) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    Row<W> up{};
#pragma unroll
    for (int j = 0; j < W; ++j) up.v[j] = __shfl_up_sync(kFull, v.v[j], off);
    const bool up_has = __shfl_up_sync(kFull, (int)has, off) != 0;
    if (lane >= off && up_has) {
      v = has ? C::apply(up, v) : up;
      has = true;
    }
  }
}

// Block-wide scan of one value per thread (kThreads threads, all calling):
// returns each thread's exclusive prefix and the block total.  Warp scans by
// shuffles, then warp 0 scans the warp totals through shared memory.  Ends
// with a barrier, so it can be called again in a loop.
template <class C, int W>
__device__ __forceinline__ void block_scan(const Row<W>& mine, bool mine_has,
                                           Row<W>& excl, bool& excl_has,
                                           Row<W>& total, bool& total_has) {
  __shared__ Row<W> s_warp[kWarps];
  __shared__ int s_warp_has[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  Row<W> v = mine;
  bool has = mine_has;
  warp_inclusive_scan<C, W>(v, has);
  // This lane's exclusive prefix within the warp: lane-1's inclusive.
  Row<W> lane_excl{};
#pragma unroll
  for (int j = 0; j < W; ++j) lane_excl.v[j] = __shfl_up_sync(kFull, v.v[j], 1);
  bool lane_excl_has = __shfl_up_sync(kFull, (int)has, 1) != 0 && lane > 0;
  if (lane == 31) {
    s_warp[warp] = v;
    s_warp_has[warp] = has;
  }
  __syncthreads();
  if (warp == 0) {
    Row<W> w = s_warp[lane < kWarps ? lane : 0];
    bool w_has = lane < kWarps && s_warp_has[lane < kWarps ? lane : 0];
    warp_inclusive_scan<C, W>(w, w_has);
    if (lane < kWarps) {
      s_warp[lane] = w;
      s_warp_has[lane] = w_has;
    }
  }
  __syncthreads();
  excl_has = false;
  if (warp > 0 && s_warp_has[warp - 1]) {
    excl = s_warp[warp - 1];
    excl_has = true;
  }
  maybe_combine<C, W>(excl, excl_has, lane_excl, lane_excl_has);
  total = s_warp[kWarps - 1];
  total_has = s_warp_has[kWarps - 1] != 0;
  __syncthreads();
}

}  // namespace scan_ops
