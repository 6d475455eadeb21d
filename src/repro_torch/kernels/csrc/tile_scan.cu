// The two local phases of the local-global-local scan for Hopper (sm_90a):
// tile_local_scan and tile_apply.
//
// Replace repro/kernels/tile_scan.py:tile_local_scan and :tile_apply, the
// Pallas TPU kernels of the engine's hierarchical array path (and its
// batched device phase 1): a per-tile inclusive scan with the tile totals,
// then, after the small global scan over the totals, each tile's exclusive
// global prefix folded into its local scan (tile 0 passes through).
//
// What bounds them: each reads its input once and writes its output once,
// n*d*4 bytes each way (plus the t*d totals or seeds): at n = 2^24, d = 1,
// 134 MB, 0.040 ms at 3.35 TB/s.  One operation a row: memory-bound.
//
// Design.
//  * tile_local_scan: each tile is cut into chunks of 256 x 16 rows, one
//    block a chunk, chained within the tile by decoupled lookback
//    (chained_scan.cuh, the kernel lookback_scan uses: each chunk read
//    once by 16-byte loads into shared memory, a warp-wide walk that stops
//    at its tile's first chunk at the latest).  So a few large tiles still fill
//    the card: the engine's segment count is often 16, and one block per
//    tile would leave 116 of the 132 SMs idle.  The last chunk of a tile
//    writes the tile's total.  The chunk board (status, aggregates,
//    prefixes) is scratch the wrapper allocates.
//  * tile_apply: one thread a row over the whole (T*K) output, so it fills
//    the card whatever T is: out = op(seeds[tile], local) for tile > 0 and
//    local for tile 0.

#include <cuda_runtime.h>

#include "chained_scan.cuh"

namespace {

using namespace scan_ops;

template <int OP, int D>
__global__ void __launch_bounds__(kThreads)
tile_apply_kernel(const float* __restrict__ local,  // (t*k, D)
                  const float* __restrict__ seeds,  // (t, D)
                  float* __restrict__ out,          // (t*k, D)
                  long long rows, int k) {
  using C = Combine<OP, D, false>;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       r < rows; r += stride) {
    const long long tile = r / k;
    Row<D> v = load_row<D>(local + r * D);
    if (tile > 0) v = C::apply(load_row<D>(seeds + tile * D), v);
    store_row<D>(out + r * D, v);
  }
}

int apply_blocks(long long rows) {
  const long long want = (rows + kThreads - 1) / kThreads;
  return (int)(want < (1 << 20) ? (want > 0 ? want : 1) : (1 << 20));
}

template <int OP, int D>
int launch_local(const void* x, void* local, void* partials, void* status,
                 void* aggs, void* prefs, void* counter, int t, int k,
                 int chunk_rows, int chunks_per_tile, cudaStream_t st) {
  return launch_chained<OP, D, false>(
      t * chunks_per_tile, st, static_cast<const float*>(x), nullptr,
      static_cast<float*>(local), static_cast<int*>(status),
      static_cast<float*>(aggs), static_cast<float*>(prefs),
      static_cast<float*>(partials), static_cast<unsigned*>(counter), nullptr,
      k, chunk_rows, chunks_per_tile);
}

template <int OP, int D>
int launch_apply(const void* local, const void* seeds, void* out, int t, int k,
                 cudaStream_t st) {
  const long long rows = (long long)t * k;
  tile_apply_kernel<OP, D><<<apply_blocks(rows), kThreads, 0, st>>>(
      static_cast<const float*>(local), static_cast<const float*>(seeds),
      static_cast<float*>(out), rows, k);
  return (int)cudaGetLastError();
}

}  // namespace

// op, d: an entry of scan_ops.cuh's table.  Return a cudaError_t, or
// cudaErrorInvalidValue for an (op, d) outside the table.
//
// tile_local_scan: each of the t tiles of k rows is cut into
// chunks_per_tile chunks of chunk_rows rows (the last one shorter); status
// (t * chunks_per_tile, 2, zeroed), aggs and prefs (t * chunks_per_tile, d) and
// counter (1, zeroed) are the chunk board's scratch.
extern "C" int tile_local_scan_launch(int op, int d, const void* x,
                                      void* local, void* partials,
                                      void* status, void* aggs, void* prefs,
                                      void* counter, int t, int k,
                                      int chunk_rows, int chunks_per_tile,
                                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (t < 1 || k < 1 || chunk_rows < 1 || chunks_per_tile < 1 ||
      (long long)chunk_rows * chunks_per_tile < k ||
      (long long)chunk_rows * (chunks_per_tile - 1) >= k) {
    return (int)cudaErrorInvalidValue;
  }
  return dispatch_entry(op, d, [&](auto e) {
    using E = decltype(e);
    return launch_local<E::op, E::d>(x, local, partials, status, aggs, prefs,
                                     counter, t, k, chunk_rows,
                                     chunks_per_tile, st);
  });
}

extern "C" int tile_apply_launch(int op, int d, const void* local,
                                 const void* seeds, void* out, int t, int k,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (t < 1 || k < 1) return (int)cudaErrorInvalidValue;
  return dispatch_entry(op, d, [&](auto e) {
    using E = decltype(e);
    return launch_apply<E::op, E::d>(local, seeds, out, t, k, st);
  });
}

extern "C" const char* tile_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
