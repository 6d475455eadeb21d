// Single-pass decoupled-lookback inclusive scan for Hopper (sm_90a).
//
// Replaces repro/kernels/lookback_scan.py:lookback_scan, the Pallas TPU
// kernel behind the engine's "decoupled" backend (refine=False series
// composition, cheap array scans, seeded and masked array scans).
//
// What it computes: the inclusive scan y of x (t*k rows of W float32 or,
// for add and max, bfloat16 values) under
// one operator of scan_ops.cuh, optionally seeded (the seed row is tile 0's
// exclusive prefix), and the published tile board: status (t) int32 flags,
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
// chunk).  One block of 256 threads per tile of k rows.
//  * Tile ids come from an atomicAdd on a counter the wrapper zeroes for
//    each launch, in the order blocks start, not from blockIdx: every
//    predecessor of a tile has then started, and it never waits on a later
//    tile, so the walk below cannot wait on a block that was never
//    scheduled.  (On the TPU the grid ran in order; on Hopper the tiles run
//    at once and the walk really accumulates AGG aggregates.)
//  * Read once, coalesced: the tile's k*W floats come in by 16-byte loads,
//    neighbouring threads on neighbouring words, into shared memory (up to
//    4096 rows, 84 KB at W = 5).  Each thread folds its run of 16
//    contiguous rows from there, in order; a warp-shuffle scan combines
//    the threads' aggregates and shared memory the warps
//    (scan_ops.cuh:block_scan); op(earlier, later) order throughout.
//  * Publish AGG: lane 0 writes aggs[i], then a release store of status[i]
//    = AGG.  For rows one float wide (the add and max scans of the main
//    path) the flag and the value go out together in one 8-byte word
//    (status[i] and the board's second column), as CUB packs them, so a
//    reader needs one round trip to L2 for both.
//  * Walk back, a warp at a time (CUB's decoupled lookback): warp 0 reads
//    the flags of the 32 nearest predecessors at once, a ballot finds the
//    nearest PREFIX, the warp folds the values from there to the newest by
//    shuffles, and it steps 32 tiles back while no PREFIX is in sight.
//    Wider rows read their published values after an acquire load of the
//    flag, past L1 (__ldcg).  walk_steps counts the tiles folded.  With
//    ~1,000 tiles resident at once, the PREFIX front and the walkers meet
//    half way: at 4,096 tiles walks average ~100 tiles and reach ~300,
//    and a walk never exceeds the tiles resident at its start.  Fewer
//    resident blocks shorten the walks but cost more in memory
//    parallelism than they save.
//  * Publish PREFIX: prefs[i] = excl o agg, then status[i] = PREFIX the same
//    way.  Tile 0 publishes its PREFIX at once.
//  * Each thread folds excl o (its exclusive prefix in the tile) over its
//    rows in shared memory, and the block stores the tile with 16-byte
//    stores: x is not read again.  A tile of more than 4096 rows (only a
//    tile count far below the card's default makes one) is scanned in
//    pieces and read twice.
// So the bytes are those of the bound, and a walk costs a few rounds of
// flag reads instead of one acquire load per predecessor in turn.
// Where a walk stops (at AGG or at PREFIX) changes how a float sum is
// grouped, so results may differ from run to run by a few ulps for
// non-integer data; integer-valued add and max are exact.

#include <cuda_runtime.h>

#include "chained_scan.cuh"

namespace {

using namespace scan_ops;

template <int OP, int D, bool MASKED, class T>
int launch(const void* x, const void* seed, void* y, void* status, void* aggs,
           void* prefs, void* counter, void* steps, int t, int k,
           cudaStream_t st) {
  // The whole array is one segment; a tile is a chunk.
  return launch_chained<OP, D, MASKED, T>(
      t, st, static_cast<const T*>(x), static_cast<const T*>(seed),
      static_cast<T*>(y), static_cast<int*>(status),
      static_cast<float*>(aggs), static_cast<float*>(prefs),
      static_cast<T*>(nullptr),
      static_cast<unsigned*>(counter), static_cast<int*>(steps), t * k, k, t);
}

template <int OP, int D, class T>
int launch_masked(int masked, const void* x, const void* seed, void* y,
                  void* status, void* aggs, void* prefs, void* counter,
                  void* steps, int t, int k, cudaStream_t st) {
  return masked ? launch<OP, D, true, T>(x, seed, y, status, aggs, prefs,
                                         counter, steps, t, k, st)
                : launch<OP, D, false, T>(x, seed, y, status, aggs, prefs,
                                          counter, steps, t, k, st);
}

}  // namespace

// op: an entry of scan_ops.cuh's table (x, seed and y bfloat16 where it
// carries kStorageBf16, else float32; aggs and prefs float32 always); d:
// operator lanes (the row holds
// d + masked); status: (t, 2) int32, zeroed, column 0 the tiles' flags
// when the kernel is done; seed: null for an unseeded scan; steps: null,
// or (t) int32
// that receives each tile's lookback walk length (tile 0 is left as it is).
// Returns a cudaError_t, or cudaErrorInvalidValue for an (op, d) outside the
// table.
extern "C" int lookback_scan_launch(int op, int d, int masked, const void* x,
                                    const void* seed, void* y, void* status,
                                    void* aggs, void* prefs, void* counter,
                                    void* steps, int t, int k, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (t < 1 || k < 1) return (int)cudaErrorInvalidValue;
  return dispatch_entry(op, d, [&](auto e) {
    using E = decltype(e);
    return launch_masked<E::op, E::d, typename E::T>(
        masked, x, seed, y, status, aggs, prefs, counter, steps, t, k, st);
  });
}

extern "C" const char* lookback_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
