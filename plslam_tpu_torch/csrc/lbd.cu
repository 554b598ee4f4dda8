// Kernel H: Line Band Descriptor bits (K12).
//
// Replaces plslam_tpu/ops/lbd.py::describe_lines (:51) with its sampler
// plslam_tpu/ops/image.py::bilinear_sample_mxu_multi (:177). The
// reference samples both Sobel maps on the TPU as a bf16 matmul against
// hat-weight matrices, so the samples carry bf16 rounding: the gradient
// values and the x hat weights max(1 - |x - i|, 0) are rounded to bf16,
// their products summed in f32, then weighted by the f32 y hat weights.
// This kernel reads the two taps of each row directly and rounds the same
// way (__float2bfloat16_rn), so its bits equal the reference's; without
// the rounding they differ at about 1e-3.
//
// One block per segment: its threads sample the n_samples x
// (n_bands * samples_per_band) grid (positions built from the reference's
// t and o tables, x clamped to [0, W - 1.001], y to [0, H - 1.001]) and
// rotate the gradients into the line frame; then one thread per
// statistic sums its band in a fixed order (along, then across), one
// thread the L2 norm, and the 256 pair tests f[p0] < f[p1] (pair table
// `_make_pairs(4 * n_bands)`) write one byte per bit.
//
// Bound: bytes and latency. Each sample gathers 2 x 4 taps of the
// half-resolution maps (scattered, served by L1/L2); there are 432
// samples per segment and ~40 flops each, so neither the card's memory
// rate nor its f32 rate is approached at 128 segments an image; the
// block's serial band sums are the critical path.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float bf(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__global__ void lbd_kernel(const float* __restrict__ gx,
                           const float* __restrict__ gy,
                           const float* __restrict__ sp,
                           const float* __restrict__ ep,
                           const float* __restrict__ t_tab,
                           const float* __restrict__ o_tab,
                           const int* __restrict__ pairs,
                           uint8_t* __restrict__ bits, int L, int H, int W,
                           int S, int NB, int SPB, float xmax, float ymax) {
  extern __shared__ float sm[];
  const int A = NB * SPB, NS = S * A, NF = 4 * NB;
  float* gpar = sm;
  float* gperp = sm + NS;
  float* feats = sm + 2 * NS;
  __shared__ float norm;
  const int seg = blockIdx.x;  // n * L + l
  const int n = seg / L;
  const float sx = sp[2 * seg], sy = sp[2 * seg + 1];
  const float d0 = sub(ep[2 * seg], sx), d1 = sub(ep[2 * seg + 1], sy);
  const float len = __fsqrt_rn(add(add(mul(d0, d0), mul(d1, d1)), 1e-12f));
  const float dx = __fdiv_rn(d0, len), dy = __fdiv_rn(d1, len);
  const float nx = -dy, ny = dx;
  const float* GX = gx + (size_t)n * H * W;
  const float* GY = gy + (size_t)n * H * W;
  for (int k = threadIdx.x; k < NS; k += blockDim.x) {
    const int s = k / A, a = k % A;
    const float px = add(add(sx, mul(d0, t_tab[s])), mul(nx, o_tab[a]));
    const float py = add(add(sy, mul(d1, t_tab[s])), mul(ny, o_tab[a]));
    const float x = fminf(fmaxf(px, 0.f), xmax);
    const float y = fminf(fmaxf(py, 0.f), ymax);
    const float x0 = floorf(x), y0 = floorf(y);
    const float wx0 = bf(fmaxf(sub(1.f, fabsf(sub(x, x0))), 0.f));
    const float wx1 = bf(fmaxf(sub(1.f, fabsf(sub(x, add(x0, 1.f)))), 0.f));
    const float wy0 = fmaxf(sub(1.f, fabsf(sub(y, y0))), 0.f);
    const float wy1 = fmaxf(sub(1.f, fabsf(sub(y, add(y0, 1.f)))), 0.f);
    const size_t r0 = (size_t)y0 * W + (size_t)x0, r1 = r0 + W;
    // per row: bf16 taps times bf16 x weights (exact products), f32 sum;
    // then the rows weighted by the f32 y weights
    const float cx0 = add(mul(bf(GX[r0]), wx0), mul(bf(GX[r0 + 1]), wx1));
    const float cx1 = add(mul(bf(GX[r1]), wx0), mul(bf(GX[r1 + 1]), wx1));
    const float cy0 = add(mul(bf(GY[r0]), wx0), mul(bf(GY[r0 + 1]), wx1));
    const float cy1 = add(mul(bf(GY[r1]), wx0), mul(bf(GY[r1 + 1]), wx1));
    const float gxs = add(mul(cx0, wy0), mul(cx1, wy1));
    const float gys = add(mul(cy0, wy0), mul(cy1, wy1));
    gpar[k] = add(mul(gxs, dx), mul(gys, dy));
    gperp[k] = add(mul(gxs, nx), mul(gys, ny));
  }
  __syncthreads();
  // feats = [par+, par-, perp+, perp-], n_bands each
  for (int f = threadIdx.x; f < NF; f += blockDim.x) {
    const int stat = f / NB, band = f % NB;
    const float* g = stat < 2 ? gpar : gperp;
    const bool neg = stat & 1;
    float acc = 0.f;
    for (int s = 0; s < S; ++s)
      for (int k = 0; k < SPB; ++k) {
        const float v = g[s * A + band * SPB + k];
        acc = add(acc, fmaxf(neg ? -v : v, 0.f));
      }
    feats[f] = acc;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float sq = 0.f;
    for (int f = 0; f < NF; ++f) sq = add(sq, mul(feats[f], feats[f]));
    norm = fmaxf(__fsqrt_rn(sq), 1e-9f);
  }
  __syncthreads();
  for (int f = threadIdx.x; f < NF; f += blockDim.x)
    feats[f] = __fdiv_rn(feats[f], norm);
  __syncthreads();
  for (int p = threadIdx.x; p < 256; p += blockDim.x)
    bits[(size_t)seg * 256 + p] = feats[pairs[2 * p]] < feats[pairs[2 * p + 1]];
}

}  // namespace

extern "C" {

// gx, gy (N, H, W) f32; sp, ep (N, L, 2) f32 in the maps' pixels; t_tab
// (S,), o_tab (NB * SPB,) f32 sample offsets; pairs (256, 2) int32 ->
// bits (N, L, 256) u8. xmax = W - 1.001, ymax = H - 1.001 (f32).
int lbd_describe(const float* gx, const float* gy, const float* sp,
                 const float* ep, const float* t_tab, const float* o_tab,
                 const int* pairs, uint8_t* bits, int N, int L, int H, int W,
                 int S, int NB, int SPB, float xmax, float ymax,
                 cudaStream_t stream) {
  const size_t smem = (2 * (size_t)S * NB * SPB + 4 * (size_t)NB) *
                      sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      lbd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  if (N * L > 0)
    lbd_kernel<<<N * L, 128, smem, stream>>>(gx, gy, sp, ep, t_tab, o_tab,
                                             pairs, bits, L, H, W, S, NB,
                                             SPB, xmax, ymax);
  return (int)cudaGetLastError();
}

}  // extern "C"
