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
//  * tile_apply: out = op(seeds[tile], local) for tile > 0 and local for
//    tile 0, streamed (16-byte words: four float32 or eight bfloat16
//    elements).  A flat 1-D grid of blocks, each one chunk of one
//    tile (one division a block, none a row; grid.y could not carry the
//    thousands of tiles of device phase 1), the tile's seed row loaded once
//    a block into registers.  For the lane-wise entries (add, max) the
//    tile's k*d contiguous floats are float4 words, kApplyLoads 16-byte
//    loads in flight a thread; float f's seed lane is f % d (every tile
//    starts on a multiple of d), and the floats before the tile's first
//    whole word and after its last are done one at a time.  rigid_compose
//    and matmul combine whole rows: a chunk of 1,024 rows (512 of 16 lanes)
//    goes through
//    shared memory by chained_scan.cuh's 16-byte loader and storer.  Tile 0
//    takes the same path without the operator.

#include <cuda_runtime.h>

#include "chained_scan.cuh"

namespace {

using namespace scan_ops;

constexpr int kApplyLoads = 4;                       // 16-byte words in flight
constexpr int kApplyQuads = kThreads * kApplyLoads;  // words a block

// Rows a block of the rows kernel takes: its chunk goes through static
// shared memory (48 KB), so rows of 16 lanes (matmul 4 x 4) take half.
template <int D>
__host__ __device__ constexpr int apply_rows() {
  return D <= 12 ? 1024 : 512;
}

// op(seed, v) on one lane of a lane-wise entry, rounded to T.
template <int OP, class T>
__device__ __forceinline__ float lane_op(float seed, float v) {
  Row<1> a, b;
  a.v[0] = seed;
  b.v[0] = v;
  return Combine<OP, 1, false, T>::apply(a, b).v[0];
}

// Element f (a global index) of a tile whose seed row is s, folded.
template <int OP, int D, class T>
__device__ __forceinline__ float fold(const float (&s)[D], long long f,
                                      float v) {
  return lane_op<OP, T>(s[(int)(f % D)], v);
}

template <int OP, int D, class T>
__global__ void __launch_bounds__(kThreads)
tile_apply_lanes_kernel(const T* __restrict__ local,  // (t*k*D), 16 B
                        const T* __restrict__ seeds,  // (t, D)
                        T* __restrict__ out,          // (t*k*D), 16 B
                        long long tile_elems, int chunks) {
  constexpr int V = 16 / (int)sizeof(T);   // elements a 16-byte word
  const int tile = blockIdx.x / chunks;
  const int c = blockIdx.x - tile * chunks;
  const bool apply = tile > 0;
  float s[D];
#pragma unroll
  for (int j = 0; j < D; ++j) {
    s[j] = apply ? to_f32<T>(seeds[tile * D + j]) : 0.f;
  }
  const long long f0 = (long long)tile * tile_elems;
  const long long f1 = f0 + tile_elems;
  // The tile's whole words [qa, qb); the elements outside them one by one.
  const long long qa = (f0 + V - 1) / V;
  const long long qb = f1 / V;
  const long long head_end = qb > qa ? V * qa : f1;
  const long long tail_start = qb > qa ? V * qb : f1;

  const uint4* src = reinterpret_cast<const uint4*>(local);
  uint4* dst = reinterpret_cast<uint4*>(out);
  const long long q0 = qa + (long long)c * kApplyQuads + threadIdx.x;
  uint4 v[kApplyLoads];
#pragma unroll
  for (int u = 0; u < kApplyLoads; ++u) {
    const long long q = q0 + u * kThreads;
    if (q < qb) v[u] = __ldg(src + q);
  }
#pragma unroll
  for (int u = 0; u < kApplyLoads; ++u) {
    const long long q = q0 + u * kThreads;
    if (q >= qb) continue;
    if (apply) {
      T e[V];
      memcpy(e, &v[u], 16);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        e[j] = from_f32<T>(fold<OP, D, T>(s, V * q + j, to_f32<T>(e[j])));
      }
      memcpy(&v[u], e, 16);
    }
    dst[q] = v[u];
  }
  // Head (< 2V elements when the tile holds no whole word) and tail (< V).
  if (c == 0 && threadIdx.x < 2 * V) {
    const long long f = f0 + threadIdx.x;
    if (f < head_end) {
      out[f] = apply ? from_f32<T>(fold<OP, D, T>(s, f, to_f32<T>(local[f])))
                     : local[f];
    }
  }
  if (c == chunks - 1 && threadIdx.x < V) {
    const long long f = tail_start + threadIdx.x;
    if (f < f1) {
      out[f] = apply ? from_f32<T>(fold<OP, D, T>(s, f, to_f32<T>(local[f])))
                     : local[f];
    }
  }
}

template <int OP, int D, class T>
__global__ void __launch_bounds__(kThreads)
tile_apply_rows_kernel(const T* __restrict__ local,  // (t*k, D)
                       const T* __restrict__ seeds,  // (t, D)
                       T* __restrict__ out,          // (t*k, D)
                       int k, int chunks) {
  using C = Combine<OP, D, false, T>;
  constexpr int R = apply_rows<D>();
  // R rows of D floats, one pad float every 32 (padi).
  __shared__ float buf[R * D + (R * D >> 5) + 1];
  const int tile = blockIdx.x / chunks;
  const int c = blockIdx.x - tile * chunks;
  const int r0 = c * R;
  const int m = min(R, k - r0);
  const size_t f0 = ((size_t)tile * k + r0) * D;
  load_floats(buf, local + f0, m * D);
  __syncthreads();
  if (tile > 0) {
    const Row<D> s = load_row<D, T>(seeds + (size_t)tile * D);
    for (int r = threadIdx.x; r < m; r += kThreads) {
      smem_store_row<D>(buf, r, C::apply(s, smem_row<D>(buf, r)));
    }
    __syncthreads();
  }
  store_floats(out + f0, buf, m * D);
}

template <int OP, int D, class T>
int launch_local(const void* x, void* local, void* partials, void* status,
                 void* aggs, void* prefs, void* counter, int t, int k,
                 int chunk_rows, int chunks_per_tile, cudaStream_t st) {
  return launch_chained<OP, D, false, T>(
      t * chunks_per_tile, st, static_cast<const T*>(x),
      static_cast<const T*>(nullptr), static_cast<T*>(local),
      static_cast<int*>(status), static_cast<float*>(aggs),
      static_cast<float*>(prefs), static_cast<T*>(partials),
      static_cast<unsigned*>(counter), nullptr, k, chunk_rows,
      chunks_per_tile);
}

template <int OP, int D, class T>
int launch_apply(const void* local, const void* seeds, void* out, int t, int k,
                 cudaStream_t st) {
  const T* l = static_cast<const T*>(local);
  const T* s = static_cast<const T*>(seeds);
  T* o = static_cast<T*>(out);
  if constexpr (OP == kOpRigid || OP == kOpMatmul) {
    constexpr int R = apply_rows<D>();
    const int chunks = (k + R - 1) / R;
    if ((long long)t * chunks > 0x7fffffffll) return (int)cudaErrorInvalidValue;
    tile_apply_rows_kernel<OP, D, T><<<t * chunks, kThreads, 0, st>>>(
        l, s, o, k, chunks);
  } else {
    constexpr int V = 16 / (int)sizeof(T);
    const long long tile_elems = (long long)k * D;
    const long long words = (tile_elems + V - 1) / V;
    const int chunks = (int)((words + kApplyQuads - 1) / kApplyQuads);
    if ((long long)t * chunks > 0x7fffffffll) return (int)cudaErrorInvalidValue;
    tile_apply_lanes_kernel<OP, D, T><<<t * chunks, kThreads, 0, st>>>(
        l, s, o, tile_elems, chunks);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// op, d: an entry of scan_ops.cuh's table; x, local, partials, seeds and
// out are bfloat16 where op carries kStorageBf16, else float32 (aggs and
// prefs float32 always).  Return a cudaError_t, or
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
    return launch_local<E::op, E::d, typename E::T>(
        x, local, partials, status, aggs, prefs, counter, t, k, chunk_rows,
        chunks_per_tile, st);
  });
}

// tile_apply: local and out (t*k, d), both 16-byte aligned; seeds (t, d).
extern "C" int tile_apply_launch(int op, int d, const void* local,
                                 const void* seeds, void* out, int t, int k,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (t < 1 || k < 1 || (reinterpret_cast<uintptr_t>(local) |
                         reinterpret_cast<uintptr_t>(out)) & 15) {
    return (int)cudaErrorInvalidValue;
  }
  return dispatch_entry(op, d, [&](auto e) {
    using E = decltype(e);
    return launch_apply<E::op, E::d, typename E::T>(local, seeds, out, t, k,
                                                    st);
  });
}

extern "C" const char* tile_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
