"""Microbenchmark of the two costs that shape ``pg_pcg``'s cluster design
(plslam_tpu_torch/csrc/pose_graph.cu): a barrier across a thread-block
cluster in its forms, and shared-memory accesses inside a CTA against
accesses to another CTA's shared memory (distributed shared memory).

Needs an sm_90 card and nvcc; run from the repository root:

    python3 tools/cluster_microbench.py

Builds the CUDA source below with nvcc into a temporary directory, and
prints the card's name and power limit, then for each form the SM cycles
(clock64) an operation takes, with every thread of every CTA taking part,
one CTA on each SM of the cluster.
"""

import ctypes
import os
import subprocess
import sys
import tempfile

SOURCE = r"""
#include <cooperative_groups.h>
#include <cuda_runtime.h>
namespace cg = cooperative_groups;
namespace {
// one shared write, then a barrier of the form `mode`, n times
__global__ void barrier_kernel(long long* out, int mode, int n) {
  extern __shared__ float bsm[];
  cg::cluster_group cl = cg::this_cluster();
  cl.sync();
  long long t0 = clock64();
  for (int i = 0; i < n; ++i) {
    bsm[threadIdx.x] += 1.0f;
    if (mode == 0) {
      __syncthreads();
    } else if (mode == 1) {
      cl.sync();
    } else if (mode == 2) {
      asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
      asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
    } else {
      __syncthreads();
      if (threadIdx.x == 0) asm volatile("fence.acq_rel.cluster;\n" ::: "memory");
      __syncwarp();
      asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
      asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
    }
  }
  long long t1 = clock64();
  cl.sync();
  if (threadIdx.x == 0 && cl.block_rank() == 0) {
    out[0] = t1 - t0;
    out[1] = (long long)bsm[0];
  }
}
// k float2 accesses a thread into a 64 KB buffer: mode 0 its own CTA's at
// scattered addresses, 1 the next CTA's scattered, 2 stores to the next
// CTA's scattered, 3 the next CTA's at consecutive addresses across a warp
__global__ void dsmem_kernel(long long* out, int mode, int k) {
  extern __shared__ float2 buf[];
  cg::cluster_group cl = cg::this_cluster();
  const int rank = cl.block_rank(), C = cl.num_blocks();
  for (int i = threadIdx.x; i < 8192; i += blockDim.x)
    buf[i] = make_float2((float)i, 1.0f);
  cl.sync();
  float2* tgt = mode == 0 ? buf : cl.map_shared_rank(buf, (rank + 1) % C);
  float acc = 0.0f;
  const unsigned h = threadIdx.x * 2654435761u + rank;
  long long t0 = clock64();
  for (int i = 0; i < k; ++i) {
    const unsigned idx = mode == 3 ? ((threadIdx.x + i * 37) & 8191)
                                   : ((h + i * 40503u) * 2654435761u) >> 19;
    if (mode == 2) {
      tgt[idx] = make_float2(acc, (float)i);
    } else {
      const float2 v = tgt[idx];
      acc += v.x + v.y;
    }
  }
  __syncthreads();
  long long t1 = clock64();
  cl.sync();
  if (threadIdx.x == 0 && rank == 0) {
    out[0] = t1 - t0;
    out[1] = (long long)acc;
  }
}
}  // namespace

extern "C" int run(long long* out, int which, int mode, int C, int threads,
                   int n) {
  const int smem = which == 0 ? 4096 : 65536;
  void* fn = which == 0 ? (void*)barrier_kernel : (void*)dsmem_kernel;
  cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = which == 0
      ? cudaLaunchKernelEx(&cfg, barrier_kernel, out, mode, n)
      : cudaLaunchKernelEx(&cfg, dsmem_kernel, out, mode, n);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceSynchronize();
  return (int)e;
}
"""

BARRIERS = ("CTA barrier (__syncthreads)",
            "cluster barrier, cooperative_groups cluster.sync()",
            "cluster barrier, relaxed arrive and wait (no memory order)",
            "CTA barrier, thread 0's fence.acq_rel.cluster, relaxed arrive "
            "and wait (pg_pcg's)")
ACCESSES = ("own CTA, scattered loads", "next CTA, scattered loads",
            "next CTA, scattered stores", "next CTA, consecutive loads")


def main() -> int:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()
    if not smi:
        print("no card", file=sys.stderr)
        return 2
    print(smi[0])
    nvcc = "/usr/local/cuda/bin/nvcc"
    with tempfile.TemporaryDirectory() as tmp:
        src, lib = os.path.join(tmp, "mb.cu"), os.path.join(tmp, "mb.so")
        with open(src, "w") as f:
            f.write(SOURCE)
        subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                        "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                        "-shared", src, "-o", lib], check=True)
        run = ctypes.CDLL(lib).run
        run.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 5
        import torch
        out = torch.zeros(2, dtype=torch.int64, device="cuda")
        n = 2000
        for mode, name in enumerate(BARRIERS):
            for C in (1, 2, 4):
                for threads in (256, 512, 1024):
                    if mode == 0 and C > 1:
                        continue
                    rc = run(out.data_ptr(), 0, mode, C, threads, n)
                    print(f"{name}: C={C} threads={threads}: rc {rc}, "
                          f"{out[0].item() / n:.1f} cycles a barrier",
                          flush=True)
        k = 64
        for mode, name in enumerate(ACCESSES):
            for C in (2, 4):
                for threads in (128, 512, 1024):
                    rc = run(out.data_ptr(), 1, mode, C, threads, k)
                    cyc = out[0].item()
                    print(f"{name} (8 bytes each): C={C} threads={threads}: "
                          f"rc {rc}, {cyc / (k * threads):.3f} cycles an "
                          f"access an SM, {k * threads * 8 / cyc:.1f} bytes "
                          "a cycle an SM", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
