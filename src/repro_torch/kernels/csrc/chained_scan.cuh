// The decoupled-lookback chained scan shared by lookback_scan.cu (the
// whole array is one segment of tiles) and tile_scan.cu's tile_local_scan
// (each tile is a segment of 4096-row chunks, so one tile spans many
// blocks).  See lookback_scan.cu's head note for the protocol and its
// memory ordering.
//
// The rows are cut into segments of seg_rows rows, each segment into
// chunks of chunk_rows rows (the last one shorter), one block a chunk.
// Chunk ids come from an atomicAdd on a zeroed counter, in the order
// blocks start: a chunk waits only on earlier chunks of its own segment,
// which have all started, so no block waits on one never scheduled.  A
// segment's first chunk publishes its PREFIX at once (with the seed, for
// segment 0, when there is one), so every walk stops inside its segment.

#pragma once

#include <cuda_runtime.h>

#include "scan_ops.cuh"

namespace scan_ops {

constexpr int kEmpty = 0;
constexpr int kAgg = 1;
constexpr int kPrefix = 2;

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

template <int OP, int D, bool MASKED>
__global__ void __launch_bounds__(kThreads)
chained_scan_kernel(const float* __restrict__ x,     // (rows, W)
                    const float* __restrict__ seed,  // (W) or null
                    float* __restrict__ y,           // (rows, W)
                    int* status,                     // (chunks), zeroed
                    float* aggs,                     // (chunks, W)
                    float* prefs,                    // (chunks, W)
                    float* totals,                   // (segments, W) or null
                    unsigned* counter,               // (1), zeroed
                    int* walk_steps,                 // (chunks) or null
                    int seg_rows, int chunk_rows, int chunks_per_seg) {
  using C = Combine<OP, D, MASKED>;
  constexpr int W = C::W;
  __shared__ int s_chunk;
  __shared__ Row<W> s_excl;
  __shared__ int s_excl_has;

  if (threadIdx.x == 0) s_chunk = (int)atomicAdd(counter, 1u);
  __syncthreads();
  const int chunk = s_chunk;
  const int seg = chunk / chunks_per_seg;
  const int first = seg * chunks_per_seg;      // the segment's first chunk
  const int c = chunk - first;
  const int k = min(chunk_rows, seg_rows - c * chunk_rows);
  const size_t row0 = (size_t)seg * seg_rows + (size_t)c * chunk_rows;
  const float* xt = x + row0 * W;
  float* yt = y + row0 * W;
  const int per = (k + kThreads - 1) / kThreads;
  const int r0 = min((int)threadIdx.x * per, k);
  const int r1 = min(r0 + per, k);

  // Local scan: this thread's aggregate, then the block scan.
  Row<W> acc{};
  bool has = false;
  for (int r = r0; r < r1; ++r) {
    maybe_combine<C, W>(acc, has, load_row<W>(xt + (size_t)r * W), true);
  }
  Row<W> texcl{}, total{};
  bool texcl_has, total_has;
  block_scan<C, W>(acc, has, texcl, texcl_has, total, total_has);

  if (threadIdx.x == 0) {
    store_row<W>(aggs + (size_t)chunk * W, total);
    Row<W> ex{};
    bool ex_has = false;
    if (c == 0) {
      if (seed != nullptr && seg == 0) {
        ex = load_row<W>(seed);
        ex_has = true;
      }
    } else {
      __threadfence();
      store_release(status + chunk, kAgg);
      int steps = 0;
      for (int j = chunk - 1; j >= first; --j) {
        ++steps;
        int st;
        while ((st = load_acquire(status + j)) == kEmpty) __nanosleep(32);
        const float* src = (st == kPrefix ? prefs : aggs) + (size_t)j * W;
        const Row<W> v = load_row_cg<W>(src);
        if (ex_has) {
          ex = C::apply(v, ex);  // v is earlier than what ex holds
        } else {
          ex = v;
          ex_has = true;
        }
        if (st == kPrefix) break;
      }
      if (walk_steps != nullptr) walk_steps[chunk] = steps;
    }
    const Row<W> incl = ex_has ? C::apply(ex, total) : total;
    store_row<W>(prefs + (size_t)chunk * W, incl);
    __threadfence();
    store_release(status + chunk, kPrefix);
    if (totals != nullptr && c == chunks_per_seg - 1) {
      store_row<W>(totals + (size_t)seg * W, incl);
    }
    if (ex_has) s_excl = ex;
    s_excl_has = ex_has;
  }
  __syncthreads();

  Row<W> run{};
  bool run_has = s_excl_has != 0;
  if (run_has) run = s_excl;
  maybe_combine<C, W>(run, run_has, texcl, texcl_has);
  for (int r = r0; r < r1; ++r) {
    maybe_combine<C, W>(run, run_has, load_row<W>(xt + (size_t)r * W), true);
    store_row<W>(yt + (size_t)r * W, run);
  }
}

}  // namespace scan_ops
