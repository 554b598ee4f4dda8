// Kernel E: Sobel gradients with the line-support planes (K4), and the
// overlapping window moments of the line detector (K8). Two launches,
// batched over N images of one shape.
//
// Replaces plslam_tpu/ops/image.py::sobel_gradients (:113), the planes of
// plslam_tpu/ops/lines.py::tile_stage (:330-342, :372-375), and
// ::tile_moment_maps (:84) / ::orientation_maps (:167). The reference runs
// the window sums as banded block-sum matmuls on the MXU; here they are
// what those matrices compute.
//
// Launch 1 (lines_sobel): one thread per pixel reads its edge-clamped 3x3
// neighbourhood from a shared tile and writes gx, gy in the reference's
// operation order (with u8_wrap, for a uint8 image held as f32 integers,
// the y difference wraps modulo 256 as the reference's uint8 subtraction
// does on a uint8 first frame); with a threshold it writes instead the planes
// w = |g| > th ? |g| : 0, d2x = (gx^2 - gy^2) / |g|, d2y = 2 gx gy / |g|.
// Launch 2 (lines_moments): one thread per s x s block sums, in
// block-LOCAL coordinates, either the two double-angle planes (the
// orientation pass) or the eight moments of the planes reweighted by
// ratio = max(align, 0)^2 (the level-line pass; align reads the tile
// orientation field through the reference's edge-padded nearest
// upsample); a second kernel adds the 2 x 2 blocks of each (2s x 2s,
// stride s) window with the exact parallel-axis shifts, as the reference.
// Local coordinates keep the moments ~s^2: absolute ones cancel
// catastrophically in f32 (lines.py:61-67).
//
// Bound: bytes. Launch 1 reads one plane and writes two or three (about
// 30 flops per pixel against 12-16 bytes); launch 2 reads three planes
// (and the small tile field) and writes 8 maps per s^2 pixels. Both read
// every pixel once through coalesced rows of 32 threads.
//
// Rounding: every per-pixel product and sum is an explicit _rn intrinsic
// (no FMA contraction), so gradients and planes equal the plain PyTorch
// version bit for bit; the window sums differ from it (and from the
// reference's matmuls) only in summation order.

#include <cuda_runtime.h>

namespace {

constexpr int BX = 32, BY = 8;

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }

__global__ void sobel_kernel(const float* __restrict__ img,
                             float* __restrict__ gx, float* __restrict__ gy,
                             float* __restrict__ w, float* __restrict__ d2x,
                             float* __restrict__ d2y, int H, int W,
                             float grad_th, int u8_wrap) {
  __shared__ float tile[BY + 2][BX + 2];
  const int x0 = blockIdx.x * BX, y0 = blockIdx.y * BY;
  const float* src = img + (size_t)blockIdx.z * H * W;
  for (int idx = threadIdx.y * BX + threadIdx.x; idx < (BY + 2) * (BX + 2);
       idx += BX * BY) {
    int ty = idx / (BX + 2), tx = idx % (BX + 2);
    tile[ty][tx] = src[(size_t)clampi(y0 + ty - 1, 0, H - 1) * W +
                       clampi(x0 + tx - 1, 0, W - 1)];
  }
  __syncthreads();
  const int x = x0 + threadIdx.x, y = y0 + threadIdx.y;
  if (x >= W || y >= H) return;
  const int tx = threadIdx.x + 1, ty = threadIdx.y + 1;
  float sy[3], dv[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float a = tile[ty - 1][tx + c - 1], b = tile[ty][tx + c - 1],
          e = tile[ty + 1][tx + c - 1];
    sy[c] = mul(add(add(a, mul(2.f, b)), e), 0.25f);  // smooth along y
    float d = sub(e, a);
    if (u8_wrap && d < 0.f) d = add(d, 256.f);        // uint8 wrap-around
    dv[c] = mul(d, 0.5f);                             // diff along y
  }
  const float g_x = mul(sub(sy[2], sy[0]), 0.5f);
  const float g_y = mul(add(add(dv[0], mul(2.f, dv[1])), dv[2]), 0.25f);
  const size_t o = (size_t)blockIdx.z * H * W + (size_t)y * W + x;
  if (gx != nullptr) {
    gx[o] = g_x;
    gy[o] = g_y;
  }
  if (w != nullptr) {
    const float gxx = mul(g_x, g_x), gyy = mul(g_y, g_y);
    const float mag = __fsqrt_rn(add(gxx, gyy));
    const float ww = mag > grad_th ? mag : 0.f;
    const float ms = fmaxf(mag, 1e-9f);
    w[o] = ww;
    d2x[o] = ww > 0.f ? __fdiv_rn(sub(gxx, gyy), ms) : 0.f;
    d2y[o] = ww > 0.f ? __fdiv_rn(mul(mul(2.f, g_x), g_y), ms) : 0.f;
  }
}

// blocks[k, n, bi, bj], bi <= Th, bj <= Tw: sums over the s x s block at
// (bi s, bj s). With w == nullptr: k = 0, 1 are the sums of d2x, d2y.
// Else k = 0..7: S, Sx, Sy, Sxx, Syy, Sxy, D2x, D2y of the reweighted
// planes, x and y local to the block.
__global__ void block_moments(const float* __restrict__ w,
                              const float* __restrict__ d2x,
                              const float* __restrict__ d2y,
                              const float* __restrict__ u2x,
                              const float* __restrict__ u2y,
                              float* __restrict__ blocks, int N, int H,
                              int W, int Th, int Tw, int s) {
  const int Hb = Th + 1, Wb = Tw + 1;
  const int bj = blockIdx.x * blockDim.x + threadIdx.x;
  const int bi = blockIdx.y * blockDim.y + threadIdx.y;
  const int n = blockIdx.z;
  if (bi >= Hb || bj >= Wb) return;
  const size_t img = (size_t)n * H * W;
  const size_t plane = (size_t)N * Hb * Wb;
  const size_t out = (size_t)n * Hb * Wb + (size_t)bi * Wb + bj;
  if (w == nullptr) {
    float ax = 0.f, ay = 0.f;
    for (int ly = 0; ly < s; ++ly) {
      const size_t row = img + (size_t)(bi * s + ly) * W + bj * s;
      for (int lx = 0; lx < s; ++lx) {
        ax = add(ax, d2x[row + lx]);
        ay = add(ay, d2y[row + lx]);
      }
    }
    blocks[out] = ax;
    blocks[plane + out] = ay;
    return;
  }
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  const size_t tiles = (size_t)n * Th * Tw;
  for (int ly = 0; ly < s; ++ly) {
    const int y = bi * s + ly;
    // the reference's up(): edge-padded nearest upsample of the tile field
    const int ti = clampi((y - s / 2 + s) / s - 1, 0, Th - 1);
    const size_t row = img + (size_t)y * W;
    const float fy = (float)ly;
    for (int lx = 0; lx < s; ++lx) {
      const int x = bj * s + lx;
      const int tj = clampi((x - s / 2 + s) / s - 1, 0, Tw - 1);
      const float U = u2x[tiles + (size_t)ti * Tw + tj];
      const float V = u2y[tiles + (size_t)ti * Tw + tj];
      const float wv = w[row + x], xv = d2x[row + x], yv = d2y[row + x];
      const float align =
          __fdiv_rn(add(mul(xv, U), mul(yv, V)), fmaxf(wv, 1e-9f));
      const float a = fmaxf(align, 0.f);
      const float ratio = mul(a, a);
      const float wr = mul(wv, ratio);
      const float fx = (float)lx;
      acc[0] = add(acc[0], wr);
      acc[1] = add(acc[1], mul(wr, fx));
      acc[2] = add(acc[2], mul(wr, fy));
      acc[3] = add(acc[3], mul(wr, fx * fx));
      acc[4] = add(acc[4], mul(wr, fy * fy));
      acc[5] = add(acc[5], mul(wr, fy * fx));
      acc[6] = add(acc[6], mul(xv, ratio));
      acc[7] = add(acc[7], mul(yv, ratio));
    }
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) blocks[k * plane + out] = acc[k];
}

// out[k, n, i, j]: the (2s x 2s, stride s) window sums from 2 x 2 blocks,
// each block's local origin shifted to the window's by (dy, dx) =
// (di s, dj s); terms added in the reference's order (0,0) (0,1) (1,0)
// (1,1).
__global__ void window_moments(const float* __restrict__ blocks,
                               float* __restrict__ out, int N, int Th,
                               int Tw, int s, int n_out) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  const int n = blockIdx.z;
  if (i >= Th || j >= Tw) return;
  const int Hb = Th + 1, Wb = Tw + 1;
  const size_t plane = (size_t)N * Hb * Wb;
  const size_t oplane = (size_t)N * Th * Tw;
  const size_t o = (size_t)n * Th * Tw + (size_t)i * Tw + j;
  auto g = [&](int k, int di, int dj) {
    return blocks[k * plane + (size_t)n * Hb * Wb + (size_t)(i + di) * Wb +
                  (j + dj)];
  };
  if (n_out == 2) {
    for (int k = 0; k < 2; ++k)
      out[k * oplane + o] =
          add(add(add(g(k, 0, 0), g(k, 0, 1)), g(k, 1, 0)), g(k, 1, 1));
    return;
  }
  float r[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int di = 0; di < 2; ++di) {
    for (int dj = 0; dj < 2; ++dj) {
      const float dy = (float)(di * s), dx = (float)(dj * s);
      const float S8 = g(0, di, dj), Sx8 = g(1, di, dj), Sy8 = g(2, di, dj);
      float t[8];
      t[0] = S8;
      t[1] = add(Sx8, mul(dx, S8));
      t[2] = add(Sy8, mul(dy, S8));
      t[3] = add(add(g(3, di, dj), mul(2.f * dx, Sx8)), mul(dx * dx, S8));
      t[4] = add(add(g(4, di, dj), mul(2.f * dy, Sy8)), mul(dy * dy, S8));
      t[5] = add(add(add(g(5, di, dj), mul(dy, Sx8)), mul(dx, Sy8)),
                 mul(dx * dy, S8));
      t[6] = g(6, di, dj);
      t[7] = g(7, di, dj);
      const bool first = di == 0 && dj == 0;
#pragma unroll
      for (int k = 0; k < 8; ++k) r[k] = first ? t[k] : add(r[k], t[k]);
    }
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) out[k * oplane + o] = r[k];
}

dim3 grid_for(int W, int H, int N, dim3 block) {
  return dim3((W + block.x - 1) / block.x, (H + block.y - 1) / block.y, N);
}

}  // namespace

extern "C" {

// img (N, H, W) -> gx, gy (N, H, W) when gx is not null, and the planes
// w, d2x, d2y (N, H, W) when w is not null.
int lines_sobel(const float* img, float* gx, float* gy, float* w, float* d2x,
                float* d2y, int N, int H, int W, float grad_th, int u8_wrap,
                cudaStream_t stream) {
  dim3 block(BX, BY);
  sobel_kernel<<<grid_for(W, H, N, block), block, 0, stream>>>(
      img, gx, gy, w, d2x, d2y, H, W, grad_th, u8_wrap);
  return (int)cudaGetLastError();
}

// Orientation pass (w null): d2x, d2y -> out (2, N, Th, Tw) = D2x, D2y.
// Reweighted pass: w, d2x, d2y (N, H, W), tile field u2x, u2y (N, Th, Tw)
// -> out (8, N, Th, Tw) = S, Sx, Sy, Sxx, Syy, Sxy, D2x, D2y.
// blocks (n_out, N, Th + 1, Tw + 1) is scratch.
int lines_moments(const float* w, const float* d2x, const float* d2y,
                  const float* u2x, const float* u2y, float* blocks,
                  float* out, int N, int H, int W, int Th, int Tw, int s,
                  cudaStream_t stream) {
  dim3 block(32, 4);
  block_moments<<<grid_for(Tw + 1, Th + 1, N, block), block, 0, stream>>>(
      w, d2x, d2y, u2x, u2y, blocks, N, H, W, Th, Tw, s);
  window_moments<<<grid_for(Tw, Th, N, block), block, 0, stream>>>(
      blocks, out, N, Th, Tw, s, w == nullptr ? 2 : 8);
  return (int)cudaGetLastError();
}

}  // extern "C"
