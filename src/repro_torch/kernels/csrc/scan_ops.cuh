// The operator table and the block-wide scan shared by the scan kernels
// (lookback_scan.cu, tile_scan.cu, fused_round.cu).
//
// A CUDA kernel cannot call the Python operator the engine scans with, so
// each scan kernel is compiled once per entry of this table and the wrapper
// maps the callable to an entry (kernels/op_table.py):
//
//   kOpAdd    a + b lane by lane, D lanes (1..4)
//   kOpRigid  rigid deformations packed [angle, shift0, shift1] (D = 3):
//             angle = a0 + b0, shift = R(b0) (a1, a2) + (b1, b2)
//   kOpMax    max(a, b) lane by lane, D lanes (1..4); a NaN in either
//             operand gives NaN, as torch.maximum does (fmaxf would drop it)
//   kOpMatmul m x m matrices packed row-major (D = m * m, m = 1..4):
//             op(earlier, later) = later @ earlier, each entry a sum over
//             k in order, float32 only
//
// Storage: rows are float32, or, for add and max, bfloat16 (the op code
// carries kStorageBf16).  A bfloat16 row is read into float32 registers
// and every combine's result is rounded to bfloat16 at once, as the
// reference's Pallas kernels round each bf16 operator application
// (kernels/op_table.py says how that was found); scratch (the lookback
// board, fused_plan's shared buffers) stays float32, holding values that
// are already bfloat16-exact.
//
// dispatch_entry maps the (op, D) a wrapper passes at run time to the
// compiled entry, so each kernel's C interface lists the table once.
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

namespace scan_ops {

constexpr int kOpAdd = 0;
constexpr int kOpRigid = 1;
constexpr int kOpMax = 2;
constexpr int kOpMatmul = 3;
// Added to an op code: the rows are stored as bfloat16.
constexpr int kStorageBf16 = 16;

using bf16 = __nv_bfloat16;

template <class T>
__device__ __forceinline__ float to_f32(T v) {
  if constexpr (std::is_same_v<T, float>) {
    return v;
  } else {
    return __bfloat162float(v);
  }
}

template <class T>
__device__ __forceinline__ T from_f32(float v) {
  if constexpr (std::is_same_v<T, float>) {
    return v;
  } else {
    return __float2bfloat16_rn(v);
  }
}

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

template <int W>
struct Row {
  float v[W];
};

// A row of storage type T (float or bf16) into float32 registers, and
// back.
template <int W, class T = float>
__device__ __forceinline__ Row<W> load_row(const T* p) {
  Row<W> r;
#pragma unroll
  for (int j = 0; j < W; ++j) r.v[j] = to_f32<T>(p[j]);
  return r;
}

// Load that bypasses L1: for values another block published.
template <int W, class T = float>
__device__ __forceinline__ Row<W> load_row_cg(const T* p) {
  Row<W> r;
#pragma unroll
  for (int j = 0; j < W; ++j) {
    if constexpr (std::is_same_v<T, float>) {
      r.v[j] = __ldcg(p + j);
    } else {
      r.v[j] = to_f32<T>(__ushort_as_bfloat16(
          __ldcg(reinterpret_cast<const unsigned short*>(p) + j)));
    }
  }
  return r;
}

template <int W, class T = float>
__device__ __forceinline__ void store_row(T* p, const Row<W>& r) {
#pragma unroll
  for (int j = 0; j < W; ++j) p[j] = from_f32<T>(r.v[j]);
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

__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || a > b) ? a : b;
}

template <int D>
struct Op<kOpMax, D> {
  template <int W>
  __device__ __forceinline__ static Row<W> apply(const Row<W>& a,
                                                 const Row<W>& b) {
    Row<W> r;
#pragma unroll
    for (int j = 0; j < D; ++j) r.v[j] = max_nan(a.v[j], b.v[j]);
    return r;
  }
};

// The side of an m x m matrix packed in D = m * m lanes.
__host__ __device__ constexpr int matrix_side(int d) {
  return d == 1 ? 1 : d == 4 ? 2 : d == 9 ? 3 : 4;
}

template <int D>
struct Op<kOpMatmul, D> {
  static constexpr int M = matrix_side(D);
  static_assert(M * M == D, "matmul rows hold m x m matrices, m = 1..4");
  template <int W>
  __device__ __forceinline__ static Row<W> apply(const Row<W>& a,
                                                 const Row<W>& b) {
    Row<W> r;
#pragma unroll
    for (int i = 0; i < M; ++i) {
#pragma unroll
      for (int j = 0; j < M; ++j) {
        float s = b.v[i * M] * a.v[j];
#pragma unroll
        for (int k = 1; k < M; ++k) s = s + b.v[i * M + k] * a.v[k * M + j];
        r.v[i * M + j] = s;
      }
    }
    return r;
  }
};

// A table entry as a type: the operator code, its lanes and the rows'
// storage type.
template <int OP_, int D_, class T_ = float>
struct Entry {
  static constexpr int op = OP_;
  static constexpr int d = D_;
  using T = T_;
};

template <int OP, class T, class F>
int dispatch_lanes(int d, F& f) {
  switch (d) {
    case 1: return f(Entry<OP, 1, T>{});
    case 2: return f(Entry<OP, 2, T>{});
    case 3: return f(Entry<OP, 3, T>{});
    case 4: return f(Entry<OP, 4, T>{});
    default: return (int)cudaErrorInvalidValue;
  }
}

// Calls f(Entry<op, d, T>{}) for an (op, d) of the table and returns what
// it returns; cudaErrorInvalidValue for anything else.
template <class F>
int dispatch_entry(int op, int d, F&& f) {
  if (op == kOpAdd) return dispatch_lanes<kOpAdd, float>(d, f);
  if (op == kOpMax) return dispatch_lanes<kOpMax, float>(d, f);
  if (op == kOpRigid && d == 3) return f(Entry<kOpRigid, 3>{});
  if (op == kOpMatmul) {
    switch (d) {
      case 1: return f(Entry<kOpMatmul, 1>{});
      case 4: return f(Entry<kOpMatmul, 4>{});
      case 9: return f(Entry<kOpMatmul, 9>{});
      case 16: return f(Entry<kOpMatmul, 16>{});
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (op == kOpAdd + kStorageBf16) return dispatch_lanes<kOpAdd, bf16>(d, f);
  if (op == kOpMax + kStorageBf16) return dispatch_lanes<kOpMax, bf16>(d, f);
  return (int)cudaErrorInvalidValue;
}

// One table entry, optionally lifted over the identity-flag lane.  With
// bfloat16 storage (T) the operator's result is rounded to it at once;
// max needs no rounding (it picks one of two bf16-exact operands).
template <int OP, int D, bool MASKED, class T = float>
struct Combine {
  static constexpr int W = D + (MASKED ? 1 : 0);
  __device__ __forceinline__ static Row<W> apply(const Row<W>& a,
                                                 const Row<W>& b) {
    Row<W> r = Op<OP, D>::template apply<W>(a, b);
    if constexpr (!std::is_same_v<T, float> && OP != kOpMax) {
#pragma unroll
      for (int j = 0; j < D; ++j) r.v[j] = to_f32<T>(from_f32<T>(r.v[j]));
    }
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
