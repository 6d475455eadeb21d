"""Time the Hopper primitives a cluster-resident scan round is made of.

Run from the repository root on a machine with a CUDA card::

    python tools/cluster_probe.py

It builds a small CUDA library (``build/probe/``, the port's nvcc flags)
and times, by CUDA events over launches of 1 and of ``ITERS + 1`` steps, the
cost of one step of each kind, on one cluster of C CTAs of 1,024 threads
(C = 1, 4, 8, 16):

* ``cluster_barrier``: ``barrier.cluster.arrive.release`` +
  ``wait.acquire`` (the fused_plan kernel's round barrier);
* ``syncthreads``: ``__syncthreads()``;
* ``dsmem_chain``: one thread a CTA follows a chain of indices held in the
  next CTA's shared memory (``mapa`` + ``ld.shared::cluster``): a DSMEM
  round trip;
* ``smem_chain``: the same chain in its own shared memory;
* ``l2_chain``: the same chain in global memory that L2 holds;
* ``round``: what one fused_plan round costs with one operand a thread:
  a DSMEM load, a shared store, ``__syncthreads`` and the cluster barrier;
* ``mbarrier_handshake``: the cluster barrier's ordering built from an
  mbarrier in each CTA instead: ``__syncthreads``, one thread a CTA arrives
  (release, cluster scope) on every CTA's mbarrier, thread 0 waits on its
  own (acquire, cluster scope), ``__syncthreads``;
* ``fenced_barrier``: the fused_plan kernel's round barrier:
  ``__syncthreads``, one thread's ``fence.acq_rel.cluster``, a relaxed
  arrive by all, ``wait.acquire``.

Each kind runs at 256 and 1,024 threads a CTA.  It prints one JSON line per
kind and thread count (microseconds a step, by C) and the card's name and
power limit.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (the card's name and power limit)
from repro_torch.kernels import _cuda  # noqa: E402

ITERS = 4096
THREADS = (256, 1024)
KINDS = ("cluster_barrier", "syncthreads", "dsmem_chain", "smem_chain",
         "l2_chain", "round", "mbarrier_handshake", "fenced_barrier")

SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>

constexpr int kWords = 4096;   // chain length in shared memory

__device__ __forceinline__ void cl_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}
__device__ __forceinline__ void cl_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}
__device__ __forceinline__ unsigned cl_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}
__device__ __forceinline__ int remote_ld(const int* p, unsigned rank) {
  uint32_t a = (uint32_t)__cvta_generic_to_shared(p), r;
  int v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(r) : "r"(a), "r"(rank));
  asm volatile("ld.shared::cluster.s32 %0, [%1];" : "=r"(v) : "r"(r));
  return v;
}

__device__ __forceinline__ void mbar_remote_arrive(uint64_t* bar,
                                                   unsigned rank) {
  uint32_t a = (uint32_t)__cvta_generic_to_shared(bar), r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(r) : "r"(a), "r"(rank));
  asm volatile(
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];"
      :: "r"(r) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  uint32_t a = (uint32_t)__cvta_generic_to_shared(bar);
  asm volatile(
      "{\n\t.reg .pred p;\n"
      "WAIT:\n\t"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%0], %1;\n\t"
      "@!p bra WAIT;\n}"
      :: "r"(a), "r"(parity) : "memory");
}

__global__ void probe(int kind, int iters, const int* chain, int* sink) {
  __shared__ int s[kWords];
  __shared__ float f[1024];
  __shared__ uint64_t bar;
  const unsigned rank = cl_rank();
  const unsigned csize = gridDim.x;
  for (int i = threadIdx.x; i < kWords; i += blockDim.x) {
    s[i] = (i * 97 + 1) % kWords;   // a permutation: a long dependent walk
  }
  if (threadIdx.x == 0) {
    uint32_t a = (uint32_t)__cvta_generic_to_shared(&bar);
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
                 :: "r"(a), "r"(csize) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  unsigned parity = 0;
  cl_arrive();
  cl_wait();
  int v = threadIdx.x;
  float acc = 0.f;
  for (int it = 0; it < iters; ++it) {
    if (kind == 0) {
      cl_arrive();
      cl_wait();
    } else if (kind == 1) {
      __syncthreads();
    } else if (kind == 2) {
      if (threadIdx.x == 0) v = remote_ld(s + v, (rank + 1) % csize);
    } else if (kind == 3) {
      if (threadIdx.x == 0) v = *((volatile int*)s + v);
    } else if (kind == 4) {
      if (threadIdx.x == 0) v = __ldcg(chain + v);
    } else if (kind == 5) {
      acc += __int_as_float(remote_ld(s + ((v + it) & (kWords - 1)),
                                      (rank + 1 + it) % csize));
      f[threadIdx.x] = acc;
      __syncthreads();
      cl_arrive();
      cl_wait();
    } else if (kind == 7) {
      __syncthreads();
      if (threadIdx.x == 0) {
        asm volatile("fence.acq_rel.cluster;" ::: "memory");
      }
      asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
      cl_wait();
    } else {   // kind 6
      __syncthreads();
      if (threadIdx.x < csize) mbar_remote_arrive(&bar, threadIdx.x);
      if (threadIdx.x == 0) mbar_wait(&bar, parity);
      parity ^= 1u;
      __syncthreads();
    }
  }
  if (v == -7 || acc == -7.f) sink[0] = v;   // keep the chains live
  cl_arrive();
  cl_wait();
}

extern "C" int probe_launch(int kind, int cluster, int threads, int iters,
                            const void* chain, void* sink, void* stream) {
  cudaError_t e;
  if (cluster > 8) {
    e = cudaFuncSetAttribute(probe,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(threads);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, probe, kind, iters,
                         static_cast<const int*>(chain),
                         static_cast<int*>(sink));
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}
"""


def _build():
    out_dir = os.path.join(ROOT, "build", "probe")
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(out_dir, "cluster_probe.cu")
    with open(src, "w") as f:
        f.write(SOURCE)
    lib = os.path.join(out_dir, "libcluster_probe.so")
    subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-o", lib, src],
                   check=True, capture_output=True, text=True)
    fn = ctypes.CDLL(lib).probe_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3
    return fn


def main() -> int:
    if not torch.cuda.is_available():
        print("cluster_probe: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    fn = _build()
    n = 1 << 20
    chain = ((torch.arange(n, device=device) * 1031 + 7) % n).int()
    sink = torch.zeros(1, dtype=torch.int32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream

    def run(kind, c, threads, iters):
        err = fn(kind, c, threads, iters, chain.data_ptr(), sink.data_ptr(),
                 stream)
        assert err == 0, err

    for k, name in enumerate(KINDS):
        for threads in THREADS:
            row = {}
            for c in (1, 4, 8, 16):
                t1 = chip_smoke._time_ms(lambda: run(k, c, threads, 1),
                                         reps=20)
                tn = chip_smoke._time_ms(
                    lambda: run(k, c, threads, ITERS + 1), reps=5)
                row[str(c)] = (tn - t1) / ITERS * 1e3
            print(json.dumps({"kind": name, "threads": threads,
                              "us_a_step_by_cluster": row}), flush=True)
    print(chip_smoke._smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
