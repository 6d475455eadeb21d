// A compiled scan plan for Hopper (sm_90a): fused_round, one round a
// launch, and fused_plan, every round of a plan in one launch.
//
// Replace repro/kernels/tile_scan.py:fused_round, the Pallas TPU kernel of
// the engine's "pallas" backend in rounds mode: one launch per plan round,
// so the paper's circuits (Sklansky, Brent-Kung, Ladner-Fischer,
// dissemination, Blelloch) run as rounds on the device.
//
// What a round computes, for an (n, D) float32 (or, for add and max,
// bfloat16) buffer y, under one operator of scan_ops.cuh's table,
// op(earlier, later):
//   y'[dst] = op(y[a], y[b])   for a combine,
//   y'[dst] = y[a]             for a move,
//   y'[r]   = y[r]             for every other (kept) row.
// The TPU kernel did the same with one-hot matrices, y*keep + SC@op(GA@y,
// GB@y) + SM@(GM@y), because Mosaic restricts dynamic-index loads; on
// Hopper a thread loads by index, so the n x m matrices (1 GiB each at
// n = 2^14) never exist and a 0 * inf in a one-hot product cannot turn into
// NaN.  All reads of a round happen before any write (plan.py):
// dissemination reads rows the same round rewrites.
//
// fused_round_kernel: one round, one thread an output row, reading the
// round's dense (n) int2 table (kernels/_tiling.py:round_sources; kept rows
// name themselves) and writing a second buffer.  It reads y and the table
// and writes y' once, 1.05 MB at n = 2^16, D = 1: 0.31 us at 3.35 TB/s, far
// under a launch, so a plan of R rounds costs R launches and R grid drains.
// It stays the kernel of a plan too large for one cluster.
//
// fused_plan_kernel: the whole plan in one launch, on one thread-block
// cluster of C CTAs (C <= 16, one CTA an SM) whose distributed shared
// memory holds the (n, D) buffer twice.  CTA q owns rows [q*P, (q+1)*P);
// its two slices are A and B.  The plan comes as its compact operand list
// (kernels/_tiling.py:plan_operands): one (dst, a, b) int32 triple a
// combine or move (b = -1), none for a kept row, grouped by round and then
// by the CTA that owns dst.  Round k:
//   1. copy forward: the rows round k-1 wrote into A are written into B
//      (B held the state before round k-1, so those are the only rows in
//      which it differs from A: a plan that keeps most rows copies little),
//      except those round k writes (the host marks them, kRewritten), so
//      steps 1 and 2 write different rows and need no barrier between;
//   2. each of this CTA's triples reads its operands from any CTA's A
//      (mapa + ld.shared::cluster) and writes B;
//   3. cluster barrier, a release (one thread's cluster-scope fence after
//      __syncthreads, then a relaxed arrive) and wait.acquire: this round's
//      writes to B are seen by next round's readers, and this round's
//      remote reads of A are done before next round writes A;
//   4. A and B swap.
// Where a round and the next read only rows their own CTA owns (the early
// rounds of most circuits: a CTA holds 4,096 rows at 2^16 x 1 on 16 CTAs),
// the host marks the barrier between them CTA-local and __syncthreads
// (0.16 us) stands in for the cluster barrier (~0.8 us): 15 of
// Ladner-Fischer's 23 rounds at 2^16.
// x comes in, and y goes out, by 16-byte accesses (chained_scan.cuh's
// loader and storer cover floats, not whole rows, so d = 3 slices need not
// start on 16 bytes).  The captured total (Blelloch's root before its
// zeroing) is read from A at the top of its round.  The barrier after the
// last round also keeps every CTA resident until no other CTA can read its
// shared memory.
//
// What bounds fused_plan: x read once, y written once and 12 bytes a
// triple: at Ladner-Fischer n = 2^16, D = 1, 0.52 MB + 3.01 MB, 1.06 us at
// 3.35 TB/s.  In practice the R dependent rounds do: each is a DSMEM round
// trip for the operands, two __syncthreads and a cluster barrier (~1 us
// together on the H100), and any chain of dependent global loads or
// divisions on a round's path adds its cost R times.  So each thread's
// first kPlanBatch triples of the next round, and the round after's
// bounds, are loaded between the barrier's arrive and wait; the operand
// reads of a batch are all issued before its first combine; a row's CTA
// comes from a multiply-high, not a divide; and the copy forward of a
// thread's first batch comes from the registers that wrote it.  More CTAs
// split a round's operands finer at a slightly dearer barrier: the size
// rule (kernels/_tiling.py:plan_cluster_size) picks the cluster.
//
// Launch: cudaLaunchKernelEx with a cluster dimension of C; shared memory
// above 48 KB and C > 8 (non-portable) are set on the kernel first, and
// cudaOccupancyMaxActiveClusters must find room for one cluster: anything
// refused returns its error, it never runs elsewhere.

#include <cuda_runtime.h>
#include <stdint.h>

#include "chained_scan.cuh"

namespace {

using namespace scan_ops;

template <int OP, int D, class T>
__global__ void __launch_bounds__(kThreads)
fused_round_kernel(const T* __restrict__ y,       // (n, D)
                   const int2* __restrict__ src,  // (n)
                   T* __restrict__ out,           // (n, D)
                   int n) {
  using C = Combine<OP, D, false, T>;
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= n) return;
  const int2 s = src[r];
  Row<D> v = load_row<D, T>(y + (long long)s.x * D);
  if (s.y >= 0) v = C::apply(v, load_row<D, T>(y + (long long)s.y * D));
  store_row<D, T>(out + (long long)r * D, v);
}

constexpr int kPlanThreads = 1024;   // threads a CTA of fused_plan
constexpr int kPlanBatch = 4;        // entries a thread holds (d = 1)
// Round flags of the operand list (kernels/_tiling.py: PLAN_CLUSTER_BARRIER,
// PLAN_LOCAL_READS).
constexpr int kClusterBarrier = 1;
constexpr int kLocalReads = 2;
// Set on a triple's dst when the next round writes the row too
// (kernels/_tiling.py: PLAN_REWRITTEN): the copy forward skips it.
constexpr int kRewritten = 1 << 30;

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// A round's arrive.  Its release half comes from one thread: __syncthreads
// orders every write (and every remote read) of the CTA's round before
// thread 0's cluster-scope fence, and that fence followed by the relaxed
// arrive is a release the waiters' acquire synchronizes with.  A release
// arrive by all 1,024 threads costs a fence each, more than the extra
// __syncthreads (tools/cluster_probe.py: cluster_barrier against
// fenced_barrier).
__device__ __forceinline__ void round_arrive() {
  __syncthreads();
  if (threadIdx.x == 0) asm volatile("fence.acq_rel.cluster;" ::: "memory");
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Row `local` of CTA `rank`'s slice at shared address `base` (this CTA's
// address of the same slice), read through distributed shared memory.
template <int D>
__device__ __forceinline__ Row<D> cluster_row(uint32_t base, int local,
                                              unsigned rank) {
  uint32_t addr;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(addr) : "r"(base + 4u * (uint32_t)(local * D)),
                 "r"(rank));
  Row<D> v;
#pragma unroll
  for (int j = 0; j < D; ++j) {
    asm volatile("ld.shared::cluster.f32 %0, [%1];"
                 : "=f"(v.v[j]) : "r"(addr + 4u * j) : "memory");
  }
  return v;
}

// Division by the slice length without a divide: q = hi32(a * m) with
// m = ceil(2^32 / d) is floor(a / d) or one more for 0 <= a < 2^31, and one
// correction settles it.
struct RowSplit {
  int d;
  unsigned m;
  __device__ __forceinline__ explicit RowSplit(int d_)
      : d(d_), m(0xffffffffu / (unsigned)d_ + 1u) {}
  // The CTA owning row a, and a's row within that CTA's slice.
  __device__ __forceinline__ unsigned split(int a, int& local) const {
    int q = (int)__umulhi((unsigned)a, m);
    local = a - q * d;
    if (local < 0) {
      --q;
      local += d;
    }
    return (unsigned)q;
  }
};

// Row `local` of this CTA's slice at shared address `base`.
template <int D>
__device__ __forceinline__ Row<D> shared_row(uint32_t base, int local) {
  const uint32_t addr = base + 4u * (uint32_t)(local * D);
  Row<D> v;
#pragma unroll
  for (int j = 0; j < D; ++j) {
    asm volatile("ld.shared.f32 %0, [%1];"
                 : "=f"(v.v[j]) : "r"(addr + 4u * j) : "memory");
  }
  return v;
}

__device__ __forceinline__ int3 triple(const int* ops, int e) {
  return make_int3(__ldg(ops + 3 * e), __ldg(ops + 3 * e + 1),
                   __ldg(ops + 3 * e + 2));
}

// The triples of a CTA's batch: entry lo + tid + j * kPlanThreads, or dst
// -1 past hi.
template <int U>
__device__ __forceinline__ void load_batch(int3 (&t)[U], const int* ops,
                                           int lo, int hi) {
#pragma unroll
  for (int j = 0; j < U; ++j) {
    const int e = lo + (int)threadIdx.x + j * kPlanThreads;
    t[j] = e < hi ? triple(ops, e) : make_int3(-1, 0, -1);
  }
}

template <int D>
__device__ __forceinline__ Row<D> read_row(uint32_t base, bool local, int a,
                                           const RowSplit& rs) {
  int la;
  const unsigned oa = rs.split(a, la);
  return local ? shared_row<D>(base, la) : cluster_row<D>(base, la, oa);
}

// Apply a batch of triples, reading the round's buffer (this CTA's slice at
// shared address base): its own slice by ld.shared (local: every operand
// is this CTA's) or any CTA's through DSMEM.  Every operand read is issued before the first combine.
// Returns in kd/kv each entry's local row and value for the next round's
// copy forward (kd -1 for none, or where the next round writes the row).
template <class Cb, int D, int U>
__device__ __forceinline__ void apply_batch(const int3 (&t)[U], uint32_t base,
                                            bool local, float* nxt, int row0,
                                            const RowSplit& rs, int (&kd)[U],
                                            Row<D> (&kv)[U]) {
  Row<D> va[U], vb[U];
#pragma unroll
  for (int j = 0; j < U; ++j) {
    if (t[j].x >= 0) {
      va[j] = read_row<D>(base, local, t[j].y, rs);
      if (t[j].z >= 0) vb[j] = read_row<D>(base, local, t[j].z, rs);
    }
  }
#pragma unroll
  for (int j = 0; j < U; ++j) {
    kd[j] = -1;
    if (t[j].x >= 0) {
      kv[j] = t[j].z >= 0 ? Cb::apply(va[j], vb[j]) : va[j];
      const int l = ((t[j].x & (kRewritten - 1)) - row0) * D;
      store_row<D>(nxt + l, kv[j]);
      if (!(t[j].x & kRewritten)) kd[j] = l;
    }
  }
}

template <int OP, int D, class T>
__global__ void __launch_bounds__(kPlanThreads)
fused_plan_kernel(const T* __restrict__ x,         // (n, D)
                  const int* __restrict__ ops,     // (entries, 3)
                  const int* __restrict__ offs,    // (rounds * C + 1)
                  const int* __restrict__ flags,   // (rounds)
                  T* __restrict__ y,               // (n, D)
                  T* __restrict__ total,           // (D) or null
                  int n, int rows_per, int stride, int rounds,
                  int cap_round, int cap_wire) {
  using Cb = Combine<OP, D, false, T>;
  // Entries a thread holds: fewer for wider rows (64 registers a thread).
  constexpr int U = D == 1 ? kPlanBatch : D <= 4 ? (kPlanBatch + 1) / 2 : 1;
  constexpr int kStep = U * kPlanThreads;
  extern __shared__ __align__(16) float smem[];
  const int csize = (int)gridDim.x;            // the grid is one cluster
  const unsigned rank = cluster_rank();
  const int tid = threadIdx.x;
  const int row0 = (int)rank * rows_per;
  const int rows = max(0, min(rows_per, n - row0));
  float* const buf0 = smem;
  float* const buf1 = smem + stride;
  const uint32_t base0 = smem_addr(buf0);
  const RowSplit rs(rows_per);

  if (rows > 0) {
    load_floats<kPlanThreads, false>(buf0, x + (size_t)row0 * D, rows * D);
  }
  __syncthreads();
  for (int i = tid; i < rows * D; i += kPlanThreads) buf1[i] = buf0[i];
  // Every CTA's slices are loaded (and every CTA runs) before a remote read.
  // Meanwhile: this CTA's bounds of rounds 0 and 1 and round 0's first
  // batch.  Throughout, a round's first batch and the next round's bounds
  // are fetched a round ahead, while the cluster barrier waits.
  cluster_arrive();
  int lo = 0, hi = 0, fl = 0, nlo = 0, nhi = 0, nfl = 0;
  if (rounds > 0) {
    lo = __ldg(offs + rank);
    hi = __ldg(offs + rank + 1);
    fl = __ldg(flags);
  }
  if (rounds > 1) {
    nlo = __ldg(offs + csize + rank);
    nhi = __ldg(offs + csize + rank + 1);
    nfl = __ldg(flags + 1);
  }
  int3 t[U];
  load_batch<U>(t, ops, lo, hi);
  int kd[U];          // the first batch's local rows written last round
  Row<D> kv[U];       // and their values
  int plo = 0, phi = 0;
#pragma unroll
  for (int j = 0; j < U; ++j) kd[j] = -1;
  cluster_wait();

  for (int k = 0; k < rounds; ++k) {
    float* const cur = (k & 1) ? buf1 : buf0;
    float* const nxt = (k & 1) ? buf0 : buf1;
    const uint32_t cur_base = base0 + 4u * (uint32_t)((k & 1) * stride);
    if (k == cap_round && cap_wire / rows_per == (int)rank && tid < D) {
      total[tid] = from_f32<T>(cur[(cap_wire - row0) * D + tid]);
    }
    if (k > 0) {
      // Copy forward what round k-1 wrote and round k does not write: its
      // first batch from registers, the rest (rounds larger than a batch a
      // thread) by its dst.  Round k writes other rows, so no barrier
      // parts the two.
#pragma unroll
      for (int j = 0; j < U; ++j) {
        if (kd[j] >= 0) store_row<D>(nxt + kd[j], kv[j]);
      }
      for (int e = plo + tid + kStep; e < phi; e += kPlanThreads) {
        const int dst = __ldg(ops + 3 * e);
        if (dst & kRewritten) continue;
        const int l = (dst - row0) * D;
#pragma unroll
        for (int j = 0; j < D; ++j) nxt[l + j] = cur[l + j];
      }
    }
    // A CTA-local round reads its own slice by plain ld.shared.
    const bool local = (fl & kLocalReads) != 0;
    apply_batch<Cb, D, U>(t, cur_base, local, nxt, row0, rs, kd, kv);
    for (int base = lo + kStep; base < hi; base += kStep) {
      int3 tb[U];
      int kdb[U];
      Row<D> kvb[U];
      load_batch<U>(tb, ops, base, hi);
      apply_batch<Cb, D, U>(tb, cur_base, local, nxt, row0, rs, kdb, kvb);
    }
    // Between two CTA-local rounds (no kClusterBarrier, the same flags for
    // every CTA) no CTA touches another's shared memory: __syncthreads
    // orders it all.
    const bool cluster_barrier = (fl & kClusterBarrier) != 0;
    if (cluster_barrier) round_arrive();
    plo = lo;
    phi = hi;
    lo = nlo;
    hi = nhi;
    fl = nfl;
    if (k + 1 < rounds) load_batch<U>(t, ops, lo, hi);
    if (k + 2 < rounds) {
      nlo = __ldg(offs + (k + 2) * csize + rank);
      nhi = __ldg(offs + (k + 2) * csize + rank + 1);
      nfl = __ldg(flags + k + 2);
    }
    if (cluster_barrier) {
      cluster_wait();
    } else {
      __syncthreads();
    }
  }

  const float* fin = (rounds & 1) ? buf1 : buf0;
  if (cap_round == rounds && cap_wire / rows_per == (int)rank && tid < D) {
    total[tid] = from_f32<T>(fin[(cap_wire - row0) * D + tid]);
  }
  if (rows > 0) {
    store_floats<kPlanThreads, false>(y + (size_t)row0 * D, fin, rows * D);
  }
}

// An error the runtime returned, cleared from the thread's last error so
// that a later launch does not report it again.
int fail(cudaError_t e) {
  (void)cudaGetLastError();
  return (int)e;
}

template <int OP, int D, class T>
int launch_plan(const T* x, const int* ops, const int* offs,
                const int* flags, T* y, T* total, int n, int rows_per,
                int stride, int rounds, int cap_round, int cap_wire,
                int cluster, cudaStream_t st) {
  auto kern = fused_plan_kernel<OP, D, T>;
  const size_t smem = 2 * (size_t)stride * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return fail(e);
  if (cluster > 8) {
    e = cudaFuncSetAttribute(kern,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return fail(e);
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(kPlanThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int active = 0;
  e = cudaOccupancyMaxActiveClusters(&active, kern, &cfg);
  if (e != cudaSuccess) return fail(e);
  if (active < 1) return (int)cudaErrorLaunchOutOfResources;
  e = cudaLaunchKernelEx(&cfg, kern, x, ops, offs, flags, y, total, n,
                         rows_per, stride, rounds, cap_round, cap_wire);
  if (e != cudaSuccess) return fail(e);
  return (int)cudaGetLastError();
}

}  // namespace

// op, d: an entry of scan_ops.cuh's table; y and out (n, d) float32, or
// bfloat16 where op carries kStorageBf16, out not y; src (n, 2) int32, 8-byte aligned, with 0 <= src[r][0] < n and
// src[r][1] < n.  Returns a cudaError_t, or cudaErrorInvalidValue for an
// (op, d) outside the table.
extern "C" int fused_round_launch(int op, int d, const void* y,
                                  const void* src, void* out, int n,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n < 1 || y == out) return (int)cudaErrorInvalidValue;
  return dispatch_entry(op, d, [&](auto e) {
    using E = decltype(e);
    using T = typename E::T;
    fused_round_kernel<E::op, E::d, T>
        <<<(n + kThreads - 1) / kThreads, kThreads, 0, st>>>(
            static_cast<const T*>(y), static_cast<const int2*>(src),
            static_cast<T*>(out), n);
    return (int)cudaGetLastError();
  });
}

// The whole plan on one cluster of `cluster` CTAs.  x, y and total (n, d)
// float32, or bfloat16 where op carries kStorageBf16 (the shared buffers
// hold float32 either way);
// ops (entries, 3) int32 triples (dst, a, b), b = -1 for a move, grouped by
// round and then by the CTA owning dst (dst / rows_per); offs (rounds *
// cluster + 1) int32, the triples of round k and CTA q being
// [offs[k * cluster + q], offs[k * cluster + q + 1]); flags (rounds) int32:
// kClusterBarrier where a cluster barrier must follow round k (else rounds
// k and k + 1, if any, read only rows their own CTA owns), kLocalReads
// where round k does; rows_per a multiple
// of 4; stride: floats a slice, >= rows_per * d and a multiple of 4;
// cluster * rows_per >= n.
// total (d) receives the pre-round value of row cap_wire at round cap_round
// (0 <= cap_round <= rounds; cap_round = rounds: after the last), or
// nothing when cap_round < 0.  Returns a cudaError_t: the cluster's set-up,
// its occupancy query or the launch refused (cudaErrorLaunchOutOfResources
// when no cluster of this shape fits the card), or cudaErrorInvalidValue
// for arguments or an (op, d) outside the table.
extern "C" int fused_plan_launch(int op, int d, const void* x,
                                 const void* ops, const void* offs,
                                 const void* flags, void* y, void* total,
                                 int n, int rows_per, int stride,
                                 int rounds, int cap_round, int cap_wire,
                                 int cluster, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n < 1 || rounds < 0 || cluster < 1 || rows_per < 4 || rows_per % 4 ||
      stride % 4 ||
      stride < rows_per * d || (long long)cluster * rows_per < n ||
      x == y || (cap_round >= 0 && (total == nullptr || cap_round > rounds ||
                                    cap_wire < 0 || cap_wire >= n))) {
    return (int)cudaErrorInvalidValue;
  }
  return dispatch_entry(op, d, [&](auto e) {
    using E = decltype(e);
    using T = typename E::T;
    return launch_plan<E::op, E::d, T>(
        static_cast<const T*>(x), static_cast<const int*>(ops),
        static_cast<const int*>(offs), static_cast<const int*>(flags),
        static_cast<T*>(y),
        static_cast<T*>(total), n, rows_per, stride, rounds, cap_round,
        cap_wire, cluster, st);
  });
}

extern "C" const char* fused_round_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
