// Kernel A: separable edge-replicate filter and bilinear resize (K3).
//
// Replaces plslam_tpu/ops/image.py::separable_filter2d (:71) and
// ::resize_bilinear (:86), which the reference runs as banded-matrix
// products Mr @ img @ Mc^T (_filter_matrix :35, _resize_matrix :48). Here
// they are what those matrices compute: a vertical pass, then a
// horizontal pass, batched over N images of one shape.
//
// Bound: bytes. A 7- or 15-tap pass does 2 flops per tap per pixel
// (at most 30 per pixel) against 8 bytes of traffic per pixel, far below
// the card's ~20 flop/byte balance point for f32. The design reads each
// source row through L1 (neighbouring threads share taps), writes the
// intermediate once, and keeps the kernels simple: one thread per output
// pixel, rows of 32 threads on contiguous addresses.
//
// Rounding: the taps are summed in tap order with FMA contraction, the
// reference sums the banded products in its own order, so results differ
// by a few ulps (<= 1e-6 absolute for images in [0, 1]).

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// out[n, i, j] = sum_t k[t] * in[n, clamp(i + t - r), j]
__global__ void filter_vertical(const float* __restrict__ in,
                                float* __restrict__ out,
                                const float* __restrict__ k, int H, int W,
                                int r) {
  int j = blockIdx.x * blockDim.x + threadIdx.x;
  int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= H || j >= W) return;
  const float* src = in + (size_t)blockIdx.z * H * W;
  float acc = 0.f;
  for (int t = 0; t <= 2 * r; ++t)
    acc += k[t] * src[(size_t)clampi(i + t - r, 0, H - 1) * W + j];
  out[(size_t)blockIdx.z * H * W + (size_t)i * W + j] = acc;
}

// out[n, i, j] = sum_t k[t] * in[n, i, clamp(j + t - r)]
__global__ void filter_horizontal(const float* __restrict__ in,
                                  float* __restrict__ out,
                                  const float* __restrict__ k, int H, int W,
                                  int r) {
  int j = blockIdx.x * blockDim.x + threadIdx.x;
  int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= H || j >= W) return;
  const float* src = in + (size_t)blockIdx.z * H * W + (size_t)i * W;
  float acc = 0.f;
  for (int t = 0; t <= 2 * r; ++t)
    acc += k[t] * src[clampi(j + t - r, 0, W - 1)];
  out[(size_t)blockIdx.z * H * W + (size_t)i * W + j] = acc;
}

// out[n, i, j] = w0[i] * in[n, i0[i], j] + w1[i] * in[n, i1[i], j]
__global__ void resize_vertical(const float* __restrict__ in,
                                float* __restrict__ out,
                                const int* __restrict__ i0,
                                const int* __restrict__ i1,
                                const float* __restrict__ w0,
                                const float* __restrict__ w1, int H, int W,
                                int Ho) {
  int j = blockIdx.x * blockDim.x + threadIdx.x;
  int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= Ho || j >= W) return;
  const float* src = in + (size_t)blockIdx.z * H * W;
  out[(size_t)blockIdx.z * Ho * W + (size_t)i * W + j] =
      w0[i] * src[(size_t)i0[i] * W + j] + w1[i] * src[(size_t)i1[i] * W + j];
}

// out[n, i, j] = w0[j] * in[n, i, i0[j]] + w1[j] * in[n, i, i1[j]]
__global__ void resize_horizontal(const float* __restrict__ in,
                                  float* __restrict__ out,
                                  const int* __restrict__ i0,
                                  const int* __restrict__ i1,
                                  const float* __restrict__ w0,
                                  const float* __restrict__ w1, int H, int W,
                                  int Wo) {
  int j = blockIdx.x * blockDim.x + threadIdx.x;
  int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= H || j >= Wo) return;
  const float* src = in + (size_t)blockIdx.z * H * W + (size_t)i * W;
  out[(size_t)blockIdx.z * H * Wo + (size_t)i * Wo + j] =
      w0[j] * src[i0[j]] + w1[j] * src[i1[j]];
}

dim3 grid_for(int W, int H, int N, dim3 block) {
  return dim3((W + block.x - 1) / block.x, (H + block.y - 1) / block.y, N);
}

}  // namespace

extern "C" {

// in (N, H, W) -> tmp (N, H, W) vertical pass -> out (N, H, W) horizontal.
int image_sep_filter(const float* in, float* tmp, float* out, const float* ky,
                     const float* kx, int N, int H, int W, int ry, int rx,
                     cudaStream_t stream) {
  dim3 block(32, 8);
  filter_vertical<<<grid_for(W, H, N, block), block, 0, stream>>>(
      in, tmp, ky, H, W, ry);
  filter_horizontal<<<grid_for(W, H, N, block), block, 0, stream>>>(
      tmp, out, kx, H, W, rx);
  return (int)cudaGetLastError();
}

// in (N, H, W) -> tmp (N, Ho, W) -> out (N, Ho, Wo); per output row
// (ri0, ri1, rw0, rw1) and per output column (ci0, ci1, cw0, cw1) give
// the two source indices and weights of _resize_matrix.
int image_resize(const float* in, float* tmp, float* out, const int* ri0,
                 const int* ri1, const float* rw0, const float* rw1,
                 const int* ci0, const int* ci1, const float* cw0,
                 const float* cw1, int N, int H, int W, int Ho, int Wo,
                 cudaStream_t stream) {
  dim3 block(32, 8);
  resize_vertical<<<grid_for(W, Ho, N, block), block, 0, stream>>>(
      in, tmp, ri0, ri1, rw0, rw1, H, W, Ho);
  resize_horizontal<<<grid_for(Wo, Ho, N, block), block, 0, stream>>>(
      tmp, out, ci0, ci1, cw0, cw1, Ho, W, Wo);
  return (int)cudaGetLastError();
}

}  // extern "C"
