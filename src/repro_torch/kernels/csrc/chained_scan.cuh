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
//
// A block reads its chunk once: 16-byte loads, neighbouring threads on
// neighbouring addresses, into shared memory (one piece of up to
// kPieceRows rows, half that for rows wider than 12 lanes); each thread
// then folds its run of contiguous rows from
// there, the block scans the runs' aggregates, and after the lookback each
// thread writes its scanned rows back to shared memory, from where the
// block stores them with 16-byte stores.  A chunk longer than a piece
// (only a tile count far below the card's default gives one, or wide
// rows) is
// scanned piece by piece: its total first, then, after the lookback, each
// piece again, so such a chunk reads x twice.
//
// x, y, the seed and the segment totals are rows of the storage type T
// (float or bf16, scan_ops.cuh); shared memory and the chunk board hold
// float32.
//
// The lookback is warp-wide: warp 0 reads the flags of 32 predecessors at
// once, finds the nearest PREFIX by a ballot, folds the AGG and PREFIX
// values up to it by shuffles in op(earlier, later) order, and moves 32
// chunks back while no PREFIX is in sight.  Rows one float wide publish
// flag and value in one 8-byte word, so a step is one round trip to L2.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "scan_ops.cuh"

namespace scan_ops {

constexpr int kEmpty = 0;
constexpr int kAgg = 1;
constexpr int kPrefix = 2;
constexpr int kItems = 16;                       // rows a thread holds
constexpr int kPieceRows = kThreads * kItems;    // 4096

// Rows a piece holds: kPieceRows, or half for rows wider than 12 lanes
// (the matmul entry's 16 and 17), whose 4096 rows would not fit the
// shared memory.
template <int W>
__host__ __device__ constexpr int piece_rows() {
  return W <= 12 ? kPieceRows : kPieceRows / 2;
}

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

// A chunk's board word: status[2j] holds its flag and, when rows are one
// float wide (W = 1), status[2j + 1] the value published with it, so one
// 8-byte access publishes or reads both (CUB packs its flags the same way).
__device__ __forceinline__ unsigned long long load_word(const int* status,
                                                        int j) {
  unsigned long long w;
  asm volatile("ld.relaxed.gpu.global.b64 %0, [%1];"
               : "=l"(w) : "l"(status + 2 * j) : "memory");
  return w;
}

__device__ __forceinline__ void store_word(int* status, int j, int flag,
                                           float v) {
  const unsigned long long w =
      ((unsigned long long)__float_as_uint(v) << 32) | (unsigned)flag;
  asm volatile("st.relaxed.gpu.global.b64 [%0], %1;"
               :: "l"(status + 2 * j), "l"(w) : "memory");
}

// Publish flag for chunk j with value v (its aggregate or inclusive
// prefix, already stored in aggs or prefs): for W > 1 the release store of
// the flag orders that store before it.
template <int W>
__device__ __forceinline__ void publish(int* status, int j, int flag,
                                        const Row<W>& v) {
  if constexpr (W == 1) {
    store_word(status, j, flag, v.v[0]);
  } else {
    store_release(status + 2 * j, flag);
  }
}

// Chunk j's flag, waiting while it is EMPTY, and for W = 1 its value.
template <int W>
__device__ __forceinline__ int poll(const int* status, int j, Row<W>& v) {
  while (true) {
    int st;
    if constexpr (W == 1) {
      const unsigned long long w = load_word(status, j);
      st = (int)(unsigned)w;
      v.v[0] = __uint_as_float((unsigned)(w >> 32));
    } else {
      st = load_acquire(status + 2 * j);
    }
    if (st != kEmpty) return st;
    __nanosleep(32);
  }
}

// Shared-memory index of float i of a piece: one pad word every 32, so a
// warp whose threads read rows kItems * W floats apart spreads over banks.
__device__ __forceinline__ int padi(int i) { return i + (i >> 5); }

template <int W>
constexpr size_t piece_smem_bytes(int rows) {
  return sizeof(float) * ((size_t)rows * W + ((size_t)rows * W >> 5) + 1);
}

// Shared-memory index of float i: padded (padi) or dense.
template <bool PAD>
__device__ __forceinline__ int smem_index(int i) {
  return PAD ? padi(i) : i;
}

// Floats src[0 .. n) into buf, by 16-byte loads of the aligned words that
// cover them (a word is never read past the page of an element it holds).
// THREADS threads call it (the block); PAD picks padi's layout in buf.
template <int THREADS = kThreads, bool PAD = true>
__device__ __forceinline__ void load_floats(float* buf,
                                            const float* __restrict__ src,
                                            int n) {
  const uintptr_t a0 = reinterpret_cast<uintptr_t>(src);
  const float4* base = reinterpret_cast<const float4*>(a0 & ~(uintptr_t)15);
  const int off = (int)((a0 & 15) >> 2);
  const int nq = (off + n + 3) >> 2;
  for (int qi = threadIdx.x; qi < nq; qi += THREADS) {
    const float4 v = __ldg(base + qi);
    const float e[4] = {v.x, v.y, v.z, v.w};
    const int i0 = 4 * qi - off;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = i0 + j;
      if (i >= 0 && i < n) buf[smem_index<PAD>(i)] = e[j];
    }
  }
}

// The same for bfloat16 elements, eight a 16-byte word, widened to float.
template <int THREADS = kThreads, bool PAD = true>
__device__ __forceinline__ void load_floats(float* buf,
                                            const bf16* __restrict__ src,
                                            int n) {
  const uintptr_t a0 = reinterpret_cast<uintptr_t>(src);
  const uint4* base = reinterpret_cast<const uint4*>(a0 & ~(uintptr_t)15);
  const int off = (int)((a0 & 15) >> 1);
  const int nq = (off + n + 7) >> 3;
  for (int qi = threadIdx.x; qi < nq; qi += THREADS) {
    const uint4 w = __ldg(base + qi);
    bf16 e[8];
    memcpy(e, &w, 16);
    const int i0 = 8 * qi - off;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int i = i0 + j;
      if (i >= 0 && i < n) buf[smem_index<PAD>(i)] = __bfloat162float(e[j]);
    }
  }
}

// buf's floats [0 .. n) to dst: 16-byte stores where a word lies wholly
// inside, single floats at the two ends (the neighbours' words belong to
// other blocks).
template <int THREADS = kThreads, bool PAD = true>
__device__ __forceinline__ void store_floats(float* __restrict__ dst,
                                             const float* buf, int n) {
  const uintptr_t a0 = reinterpret_cast<uintptr_t>(dst);
  float4* base = reinterpret_cast<float4*>(a0 & ~(uintptr_t)15);
  const int off = (int)((a0 & 15) >> 2);
  const int nq = (off + n + 3) >> 2;
  for (int qi = threadIdx.x; qi < nq; qi += THREADS) {
    const int i0 = 4 * qi - off;
    if (i0 >= 0 && i0 + 3 < n) {
      base[qi] = make_float4(
          buf[smem_index<PAD>(i0)], buf[smem_index<PAD>(i0 + 1)],
          buf[smem_index<PAD>(i0 + 2)], buf[smem_index<PAD>(i0 + 3)]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int i = i0 + j;
        if (i >= 0 && i < n) dst[i] = buf[smem_index<PAD>(i)];
      }
    }
  }
}

// The same to bfloat16 elements (each float rounded to nearest even),
// eight a 16-byte word.
template <int THREADS = kThreads, bool PAD = true>
__device__ __forceinline__ void store_floats(bf16* __restrict__ dst,
                                             const float* buf, int n) {
  const uintptr_t a0 = reinterpret_cast<uintptr_t>(dst);
  uint4* base = reinterpret_cast<uint4*>(a0 & ~(uintptr_t)15);
  const int off = (int)((a0 & 15) >> 1);
  const int nq = (off + n + 7) >> 3;
  for (int qi = threadIdx.x; qi < nq; qi += THREADS) {
    const int i0 = 8 * qi - off;
    if (i0 >= 0 && i0 + 7 < n) {
      bf16 e[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        e[j] = __float2bfloat16_rn(buf[smem_index<PAD>(i0 + j)]);
      }
      uint4 w;
      memcpy(&w, e, 16);
      base[qi] = w;
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int i = i0 + j;
        if (i >= 0 && i < n) {
          dst[i] = __float2bfloat16_rn(buf[smem_index<PAD>(i)]);
        }
      }
    }
  }
}

template <int W>
__device__ __forceinline__ Row<W> smem_row(const float* buf, int r) {
  Row<W> v;
#pragma unroll
  for (int j = 0; j < W; ++j) v.v[j] = buf[padi(r * W + j)];
  return v;
}

template <int W>
__device__ __forceinline__ void smem_store_row(float* buf, int r,
                                               const Row<W>& v) {
#pragma unroll
  for (int j = 0; j < W; ++j) buf[padi(r * W + j)] = v.v[j];
}

// The rows [r0, r1) this thread owns in a piece of m rows.
__device__ __forceinline__ void thread_rows(int m, int& r0, int& r1) {
  const int per = (m + kThreads - 1) / kThreads;
  r0 = min((int)threadIdx.x * per, m);
  r1 = min(r0 + per, m);
}

// Load piece rows [0, m) of xt into buf and scan it: each thread's
// exclusive prefix within the piece and the piece's total.
template <class C, int W, class T>
__device__ __forceinline__ void scan_piece(float* buf, const T* xt, int m,
                                           Row<W>& texcl, bool& texcl_has,
                                           Row<W>& total, bool& total_has) {
  __syncthreads();   // the previous piece's stores have read buf
  load_floats(buf, xt, m * W);
  __syncthreads();
  int r0, r1;
  thread_rows(m, r0, r1);
  Row<W> acc{};
  bool has = false;
  for (int r = r0; r < r1; ++r) {
    maybe_combine<C, W>(acc, has, smem_row<W>(buf, r), true);
  }
  block_scan<C, W>(acc, has, texcl, texcl_has, total, total_has);
}

// Fold run (the rows before this thread's) over the thread's rows of the
// piece in buf, in place, then store the piece to yt.
template <class C, int W, class T>
__device__ __forceinline__ void emit_piece(float* buf, T* yt, int m,
                                           Row<W> run, bool run_has) {
  int r0, r1;
  thread_rows(m, r0, r1);
  for (int r = r0; r < r1; ++r) {
    maybe_combine<C, W>(run, run_has, smem_row<W>(buf, r), true);
    smem_store_row<W>(buf, r, run);
  }
  __syncthreads();
  store_floats(yt, buf, m * W);
}

// Warp 0's walk over chunks end, end-1, ... down to the nearest PREFIX (at
// or after `first`), 32 chunks a step: lane l reads chunk end - l.  Returns,
// in lane 0, the fold of the values read, earliest first; steps counts the
// chunks folded.
template <class C, int W>
__device__ __forceinline__ bool warp_lookback(int end, int first,
                                              const int* status,
                                              const float* aggs,
                                              const float* prefs,
                                              Row<W>& ex, int& steps) {
  const int lane = threadIdx.x & 31;
  bool ex_has = false;
  steps = 0;
  while (true) {
    const int j = end - lane;
    Row<W> val{};
    // Every chunk read has started (ticket order), so each publishes soon.
    const int st = j >= first ? poll<W>(status, j, val) : kEmpty;
    // The nearest PREFIX is the lowest lane holding one.  The segment's
    // first chunk is PREFIX, so a walk never passes it.
    const unsigned pmask = __ballot_sync(kFull, st == kPrefix);
    const int stop = pmask ? __ffs(pmask) - 1 : 31;
    bool has = lane <= stop;
    if constexpr (W > 1) {
      if (has) {
        val = load_row_cg<W>((st == kPrefix ? prefs : aggs) + (size_t)j * W);
      }
    }
    // Lane l ends with lanes l..31 folded; a higher lane is an earlier chunk.
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      Row<W> up;
#pragma unroll
      for (int q = 0; q < W; ++q) up.v[q] = __shfl_down_sync(kFull, val.v[q], off);
      const bool up_has =
          (__shfl_down_sync(kFull, (int)has, off) != 0) && lane + off < 32;
      if (up_has) {
        val = has ? C::apply(up, val) : up;
        has = true;
      }
    }
    if (lane == 0) {
      ex = ex_has ? C::apply(val, ex) : val;   // val is earlier than ex
      ex_has = true;
    }
    steps += stop + 1;
    if (pmask) return ex_has;
    end -= 32;
  }
}

template <int OP, int D, bool MASKED, class T>
__global__ void __launch_bounds__(kThreads)
chained_scan_kernel(const T* __restrict__ x,         // (rows, W)
                    const T* __restrict__ seed,      // (W) or null
                    T* __restrict__ y,               // (rows, W)
                    int* status,                     // (chunks, 2), zeroed
                    float* aggs,                     // (chunks, W)
                    float* prefs,                    // (chunks, W)
                    T* totals,                       // (segments, W) or null
                    unsigned* counter,               // (1), zeroed
                    int* walk_steps,                 // (chunks) or null
                    int seg_rows, int chunk_rows, int chunks_per_seg) {
  using C = Combine<OP, D, MASKED, T>;
  constexpr int W = C::W;
  constexpr int P = piece_rows<W>();
  extern __shared__ float buf[];
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
  const T* xt = x + row0 * W;
  T* yt = y + row0 * W;
  const int pieces = (k + P - 1) / P;

  // The chunk's total; a one-piece chunk keeps its rows in buf.
  Row<W> texcl{}, total{};
  bool texcl_has = false, total_has = false;
  for (int p = 0; p < pieces; ++p) {
    const int m = min(P, k - p * P);
    Row<W> pt{};
    bool pt_has;
    scan_piece<C, W>(buf, xt + (size_t)p * P * W, m, texcl,
                     texcl_has, pt, pt_has);
    maybe_combine<C, W>(total, total_has, pt, pt_has);
  }

  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    Row<W> ex{};
    bool ex_has = false;
    if (lane == 0) store_row<W>(aggs + (size_t)chunk * W, total);
    if (c == 0) {
      if (seed != nullptr && seg == 0) {
        ex = load_row<W, T>(seed);
        ex_has = true;
      }
    } else {
      if (lane == 0) publish<W>(status, chunk, kAgg, total);
      __syncwarp();
      int steps;
      ex_has = warp_lookback<C, W>(chunk - 1, first, status, aggs, prefs, ex,
                                   steps);
      if (lane == 0 && walk_steps != nullptr) walk_steps[chunk] = steps;
    }
    if (lane == 0) {
      const Row<W> incl = ex_has ? C::apply(ex, total) : total;
      store_row<W>(prefs + (size_t)chunk * W, incl);
      publish<W>(status, chunk, kPrefix, incl);
      if (totals != nullptr && c == chunks_per_seg - 1) {
        store_row<W, T>(totals + (size_t)seg * W, incl);
      }
      if (ex_has) s_excl = ex;
      s_excl_has = ex_has;
    }
  }
  __syncthreads();

  Row<W> carry{};
  bool carry_has = s_excl_has != 0;
  if (carry_has) carry = s_excl;
  if (pieces == 1) {
    Row<W> run = carry;
    bool run_has = carry_has;
    maybe_combine<C, W>(run, run_has, texcl, texcl_has);
    emit_piece<C, W>(buf, yt, k, run, run_has);
    return;
  }
  for (int p = 0; p < pieces; ++p) {
    const int m = min(P, k - p * P);
    Row<W> pt{};
    bool pt_has;
    scan_piece<C, W>(buf, xt + (size_t)p * P * W, m, texcl,
                     texcl_has, pt, pt_has);
    Row<W> run = carry;
    bool run_has = carry_has;
    maybe_combine<C, W>(run, run_has, texcl, texcl_has);
    emit_piece<C, W>(buf, yt + (size_t)p * P * W, m, run, run_has);
    maybe_combine<C, W>(carry, carry_has, pt, pt_has);
  }
}

// Launch chained_scan_kernel on `blocks` chunks with the shared memory one
// piece needs; returns a cudaError_t.
template <int OP, int D, bool MASKED, class T>
int launch_chained(int blocks, cudaStream_t st, const T* x, const T* seed,
                   T* y, int* status, float* aggs, float* prefs, T* totals,
                   unsigned* counter, int* walk_steps, int seg_rows,
                   int chunk_rows, int chunks_per_seg) {
  constexpr int W = Combine<OP, D, MASKED, T>::W;
  const size_t smem = piece_smem_bytes<W>(min(chunk_rows, piece_rows<W>()));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        chained_scan_kernel<OP, D, MASKED, T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  chained_scan_kernel<OP, D, MASKED, T><<<blocks, kThreads, smem, st>>>(
      x, seed, y, status, aggs, prefs, totals, counter, walk_steps, seg_rows,
      chunk_rows, chunks_per_seg);
  return (int)cudaGetLastError();
}

}  // namespace scan_ops
