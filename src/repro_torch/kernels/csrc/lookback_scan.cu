// Single-pass decoupled-lookback inclusive scan for Hopper (sm_90a).
//
// Replaces repro/kernels/lookback_scan.py:lookback_scan, the Pallas TPU
// kernel behind the engine's "decoupled" backend (refine=False series
// composition, cheap array scans, seeded and masked array scans).
//
// What it computes: the inclusive scan y of x (t*k rows of W floats) under
// one operator of scan_ops.cuh, optionally seeded (the seed row is tile 0's
// exclusive prefix), and the published tile board: status (t) int32,
// aggs (t, W) tile aggregates, prefs (t, W) inclusive tile prefixes.
//
// What bounds it: it must read x once and write y once, n*W*4 bytes each
// way; at n = 2^24, W = 1 that is 134 MB, 0.040 ms at 3.35 TB/s.  The add
// entry does one operation a row, far below the f32 rate, so it is
// memory-bound.  At the registration path's n = 256..4096 rows of W = 3 the
// launch (a few microseconds) is all there is.
//
// Design (chained_scan.cuh:chained_scan_kernel, shared with
// tile_local_scan; here the whole array is one segment and a tile is one
// chunk).  One block of 256 threads per tile of k <= 4096 rows.
//  * Tile ids come from an atomicAdd on a counter the wrapper zeroes for
//    each launch, in the order blocks start, not from blockIdx: every
//    predecessor of a tile has then started, and it never waits on a later
//    tile, so the walk below cannot wait on a block that was never
//    scheduled.  (On the TPU the grid ran in order; on Hopper the tiles run
//    at once and the walk really accumulates AGG aggregates.)
//  * Local scan: each thread folds a contiguous run of rows in order, a
//    warp-shuffle scan combines the threads' aggregates and shared memory
//    combines the warps (scan_ops.cuh:block_scan); op(earlier, later)
//    order throughout.
//  * Publish AGG: thread 0 writes aggs[i], __threadfence(), then a release
//    store of status[i] = AGG.
//  * Walk back (lookback_resolve's walk): thread 0 reads predecessors'
//    flags with acquire loads, newest first, folds in each AGG aggregate,
//    folds in the first PREFIX and stops there.  Published values are read
//    after the acquire and past L1 (__ldcg).
//  * Publish PREFIX: prefs[i] = excl o agg, __threadfence(), release store
//    of status[i] = PREFIX.  Tile 0 publishes its PREFIX at once.
//  * Each thread then folds excl o (its exclusive prefix in the tile) over
//    its rows again and writes them: the second read of the tile is served
//    from L1/L2.
// Where a walk stops (at AGG or at PREFIX) changes how a float sum is
// grouped, so results may differ from run to run by a few ulps for
// non-integer data; integer-valued add is exact.
//
// This first version is the simple, correct kernel; keeping the tile in
// shared memory, coalesced loads, a warp-wide walk and several tiles a
// block are later work.

#include <cuda_runtime.h>

#include "chained_scan.cuh"

namespace {

using namespace scan_ops;

template <int OP, int D, bool MASKED>
int launch(const void* x, const void* seed, void* y, void* status, void* aggs,
           void* prefs, void* counter, void* steps, int t, int k,
           cudaStream_t st) {
  // The whole array is one segment; a tile is a chunk.
  chained_scan_kernel<OP, D, MASKED><<<t, kThreads, 0, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(seed),
      static_cast<float*>(y), static_cast<int*>(status),
      static_cast<float*>(aggs), static_cast<float*>(prefs), nullptr,
      static_cast<unsigned*>(counter), static_cast<int*>(steps), t * k, k, t);
  return (int)cudaGetLastError();
}

template <int OP, int D>
int launch_masked(int masked, const void* x, const void* seed, void* y,
                  void* status, void* aggs, void* prefs, void* counter,
                  void* steps, int t, int k, cudaStream_t st) {
  return masked ? launch<OP, D, true>(x, seed, y, status, aggs, prefs, counter,
                                      steps, t, k, st)
                : launch<OP, D, false>(x, seed, y, status, aggs, prefs,
                                       counter, steps, t, k, st);
}

}  // namespace

// op: kOpAdd / kOpRigid; d: operator lanes (the row holds d + masked);
// seed: null for an unseeded scan; steps: null, or (t) int32 that receives
// each tile's lookback walk length (tile 0 is left as it is).  Returns a
// cudaError_t, or cudaErrorInvalidValue for an (op, d) outside the table.
extern "C" int lookback_scan_launch(int op, int d, int masked, const void* x,
                                    const void* seed, void* y, void* status,
                                    void* aggs, void* prefs, void* counter,
                                    void* steps, int t, int k, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (t < 1 || k < 1) return (int)cudaErrorInvalidValue;
  if (op == kOpAdd) {
    switch (d) {
      case 1: return launch_masked<kOpAdd, 1>(masked, x, seed, y, status, aggs, prefs, counter, steps, t, k, st);
      case 2: return launch_masked<kOpAdd, 2>(masked, x, seed, y, status, aggs, prefs, counter, steps, t, k, st);
      case 3: return launch_masked<kOpAdd, 3>(masked, x, seed, y, status, aggs, prefs, counter, steps, t, k, st);
      case 4: return launch_masked<kOpAdd, 4>(masked, x, seed, y, status, aggs, prefs, counter, steps, t, k, st);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (op == kOpRigid && d == 3) {
    return launch_masked<kOpRigid, 3>(masked, x, seed, y, status, aggs, prefs,
                                      counter, steps, t, k, st);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* lookback_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
