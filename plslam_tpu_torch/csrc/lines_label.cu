// Kernel F: collinear min-label propagation over the tile grid (K9).
//
// Replaces the connected-component stage of
// plslam_tpu/ops/lines.py::tile_stage (:416-468): the compatibility of
// each tile with its 8 neighbours (both gated in, angle mod pi within
// merge_ang_th, perpendicular centroid offset within merge_dist_th), then
// merge_iters synchronous sweeps of min-label propagation, each followed
// by one pointer hop label <- min(label, label[label]). The reference runs
// the hop as a one-hot MXU contraction (its gather serialises); here it is
// a read from shared memory.
//
// One thread block per image; the whole (Th, Tw) field lives in shared
// memory (7,084 tiles at 376 x 1241: two int32 label buffers and two
// compatibility bytes per tile, 71 KB). The sweep is the reference's
// SYNCHRONOUS update: every neighbour term reads the previous sweep's
// labels (buffer A -> B), and the hop reads the pre-hop labels (B -> A).
// An in-place or union-find update converges faster and would give other
// labels after a fixed number of sweeps; this gives exactly the plain
// version's (and the reference's) labels.
//
// Bound: operations and latency, not bytes: the inputs are 21 bytes per
// tile, and 9 sweeps of 8 neighbour reads plus a hop per tile run from
// shared memory in one block per image, with a barrier between phases.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__constant__ int DI[4] = {0, 1, 1, 1};
__constant__ int DJ[4] = {1, 0, 1, -1};

__global__ void label_kernel(const uint8_t* __restrict__ ok,
                             const float* __restrict__ ang,
                             const float* __restrict__ cx,
                             const float* __restrict__ cy,
                             const float* __restrict__ dx,
                             const float* __restrict__ dy,
                             int* __restrict__ labels, int Th, int Tw,
                             float ang_th, float dist_th, int iters) {
  extern __shared__ int smem[];
  const int n = Th * Tw;
  const int BIG = n + 7;
  int* A = smem;
  int* B = smem + n;
  uint8_t* fwd = reinterpret_cast<uint8_t*>(smem + 2 * n);
  uint8_t* comp = fwd + n;
  const size_t base = (size_t)blockIdx.x * n;
  const float PI = 3.14159265358979323846f;

  // forward compatibilities, bit d: tile (i, j) with (i + DI[d], j + DJ[d])
  for (int t = threadIdx.x; t < n; t += blockDim.x) {
    const int i = t / Tw, j = t % Tw;
    uint8_t m = 0;
    const bool okt = ok[base + t] != 0;
    if (okt) {
      const float a = ang[base + t], x = cx[base + t], y = cy[base + t];
      const float ux = dx[base + t], uy = dy[base + t];
      for (int d = 0; d < 4; ++d) {
        const int ni = i + DI[d], nj = j + DJ[d];
        if (ni < 0 || ni >= Th || nj < 0 || nj >= Tw) continue;
        const int nt = ni * Tw + nj;
        if (!ok[base + nt]) continue;
        float dang = fabsf(__fsub_rn(a, ang[base + nt]));
        dang = fminf(dang, __fsub_rn(PI, dang));
        const float off = fabsf(
            __fadd_rn(__fmul_rn(-uy, __fsub_rn(cx[base + nt], x)),
                      __fmul_rn(ux, __fsub_rn(cy[base + nt], y))));
        if (dang < ang_th && off < dist_th) m |= (uint8_t)(1u << d);
      }
    }
    fwd[t] = m;
    A[t] = okt ? t : BIG;
  }
  __syncthreads();
  // reverse compatibilities, bit 4 + d: the tile at -(DI[d], DJ[d]) has d
  for (int t = threadIdx.x; t < n; t += blockDim.x) {
    const int i = t / Tw, j = t % Tw;
    uint8_t m = fwd[t];
    for (int d = 0; d < 4; ++d) {
      const int pi = i - DI[d], pj = j - DJ[d];
      if (pi < 0 || pi >= Th || pj < 0 || pj >= Tw) continue;
      if ((fwd[pi * Tw + pj] >> d) & 1) m |= (uint8_t)(1u << (4 + d));
    }
    comp[t] = m;
  }
  __syncthreads();
  for (int it = 0; it < iters; ++it) {
    for (int t = threadIdx.x; t < n; t += blockDim.x) {
      int v = A[t];
      const uint8_t m = comp[t];
      if (m) {
        for (int d = 0; d < 4; ++d) {
          const int off = DI[d] * Tw + DJ[d];
          if ((m >> d) & 1) v = min(v, A[t + off]);
          if ((m >> (4 + d)) & 1) v = min(v, A[t - off]);
        }
      }
      B[t] = v;
    }
    __syncthreads();
    for (int t = threadIdx.x; t < n; t += blockDim.x) {
      const int v = B[t];
      A[t] = v < n ? min(v, B[v]) : v;
    }
    __syncthreads();
  }
  for (int t = threadIdx.x; t < n; t += blockDim.x) labels[base + t] = A[t];
}

}  // namespace

extern "C" {

// tile_ok (N, Th, Tw) u8; angle, cx, cy, dx, dy (N, Th, Tw) f32 ->
// labels (N, Th, Tw) int32, Th * Tw + 7 on gated-out tiles.
int lines_label(const uint8_t* ok, const float* ang, const float* cx,
                const float* cy, const float* dx, const float* dy,
                int* labels, int N, int Th, int Tw, float ang_th,
                float dist_th, int iters, cudaStream_t stream) {
  const int n = Th * Tw;
  const size_t smem = (size_t)n * (2 * sizeof(int) + 2);
  cudaError_t e = cudaFuncSetAttribute(
      label_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  label_kernel<<<N, 1024, smem, stream>>>(ok, ang, cx, cy, dx, dy, labels,
                                          Th, Tw, ang_th, dist_th, iters);
  return (int)cudaGetLastError();
}

}  // extern "C"
