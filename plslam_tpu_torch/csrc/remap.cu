// Kernel N: the bilinear rectification remap (K19).
//
// Replaces plslam_tpu/core/camera.py::remap_bilinear (:203), which
// StereoRectifier (:186) jit-compiles over a stereo pair: for every output
// pixel, read the (u, v) source coordinate from the map, take the floor, read
// the four taps (a tap outside [0, W) x [0, H) reads 0) and blend them.
//
// One thread per output pixel; blockIdx.z selects the image, and with
// map_per_image each image reads its own map (the pair of StereoRectifier is
// one launch), else all images share one. The map is read as one float2 per
// pixel, the source through the read-only path (__ldg); neighbouring threads
// read neighbouring map entries and, for a smooth map, nearby source rows.
//
// The arithmetic follows the reference step by step: u0 = floor(u) as int32,
// fu = u - (float)u0, taps at (v0, u0), (v0, u0+1), (v0+1, u0), (v0+1, u0+1)
// with the indices clamped before the read and the value replaced by 0 out of
// bounds, top = p00*(1-fu) + p01*fu, bot = p10*(1-fu) + p11*fu,
// out = top*(1-fv) + bot*fv. Every product and sum is an __fmul_rn /
// __fadd_rn / __fsub_rn, so nvcc cannot contract them into FMAs and the
// kernel is bit-equal to remap_bilinear_plain (separate PyTorch ops).
//
// Bound: bytes. Per image H'W' x (8 B map + 4 B out) + HW x 4 B source:
// 11.6 MB for a 752x480 pair, 14.9 MB for a 1241x376 pair. No reduction and
// no shared memory: a gather whose taps L1/L2 serve.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float tap(const float* __restrict__ img, int H,
                                     int W, int vi, int ui) {
  const bool inb = (ui >= 0) & (ui < W) & (vi >= 0) & (vi < H);
  const int uc = min(max(ui, 0), W - 1);
  const int vc = min(max(vi, 0), H - 1);
  const float val = __ldg(img + (size_t)vc * W + uc);
  return inb ? val : 0.0f;
}

__global__ void remap_kernel(const float* __restrict__ src,
                             const float2* __restrict__ map, int H, int W,
                             int Ho, int Wo, int map_per_image,
                             float* __restrict__ out) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  const int z = blockIdx.z;
  if (x >= Wo || y >= Ho) return;
  const size_t pix = (size_t)y * Wo + x;
  const size_t plane = (size_t)Ho * Wo;
  const float2 m = __ldg(map + (map_per_image ? z * plane : 0) + pix);
  const float* img = src + (size_t)z * H * W;

  const int u0 = (int)floorf(m.x);
  const int v0 = (int)floorf(m.y);
  const float fu = __fsub_rn(m.x, (float)u0);
  const float fv = __fsub_rn(m.y, (float)v0);
  const float p00 = tap(img, H, W, v0, u0);
  const float p01 = tap(img, H, W, v0, u0 + 1);
  const float p10 = tap(img, H, W, v0 + 1, u0);
  const float p11 = tap(img, H, W, v0 + 1, u0 + 1);
  const float gu = __fsub_rn(1.0f, fu);
  const float gv = __fsub_rn(1.0f, fv);
  const float top = __fadd_rn(__fmul_rn(p00, gu), __fmul_rn(p01, fu));
  const float bot = __fadd_rn(__fmul_rn(p10, gu), __fmul_rn(p11, fu));
  out[z * plane + pix] = __fadd_rn(__fmul_rn(top, gv), __fmul_rn(bot, fv));
}

}  // namespace

extern "C" {

// src (n, H, W) f32; map (Ho, Wo, 2) f32, or (n, Ho, Wo, 2) with
// map_per_image -> out (n, Ho, Wo) f32
int remap_bilinear(const float* src, const float* map, float* out, int n,
                   int H, int W, int Ho, int Wo, int map_per_image,
                   cudaStream_t stream) {
  const dim3 block(32, 8);
  const dim3 grid((Wo + 31) / 32, (Ho + 7) / 8, n);
  remap_kernel<<<grid, block, 0, stream>>>(
      src, reinterpret_cast<const float2*>(map), H, W, Ho, Wo, map_per_image,
      out);
  return (int)cudaGetLastError();
}

}  // extern "C"
