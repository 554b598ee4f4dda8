// Kernel B: FAST-16 corner test and score (K1), NMS and 8x8 block
// max/argmax (K2), two launches.
//
// Replaces plslam_tpu/ops/fast.py::fast_score_map2 (:70) with
// _arc9_from_bitmask (:49), and the per-pixel part of detect_fast (:200):
// nms (:110), the border mask and the block max/argmax of
// select_topk_grid (:157-167). The per-cell and global top-k stay in
// PyTorch (a stable sort, whose tie order is lax.top_k's).
//
// Bound: launch 1 by operations, launch 2 by bytes. Launch 1 reads each
// pixel once from device memory (its 3-pixel halo comes from a
// shared-memory tile), does ~300 float and integer operations per pixel
// (16 taps x 15, four arc tests of ~18) and writes two mask bytes and a
// score: 10 bytes. Launch 2 reads score and masks once (5-pixel halo in
// shared memory), does ~40 compares per pixel and writes 1/64 of that.
// The design keeps every intermediate plane (taps, bitmasks, NMS max) on
// chip, so nothing but the inputs and outputs crosses device memory.
//
// Exactness: the score adds the 16 taps in the _CIRCLE order with only
// subtract, compare and max (nothing to contract into an FMA), so it is
// bit-identical to the plain version. Block argmax keeps the first index
// in row-major order, as jnp.argmax does.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// Bresenham circle of radius 3, clockwise from 12 o'clock (fast.py _CIRCLE)
__constant__ int kDy[16] = {-3, -3, -2, -1, 0, 1, 2, 3,
                            3, 3, 2, 1, 0, -1, -2, -3};
__constant__ int kDx[16] = {0, 1, 2, 3, 3, 3, 2, 1,
                            0, -1, -2, -3, -3, -3, -2, -1};

constexpr int TX = 32, TY = 8, HALO = 3;

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// any 9 circularly contiguous bits among bits 0..15 (doubled-word trick)
__device__ __forceinline__ bool arc9(unsigned m) {
  unsigned d = m | (m << 16);
#pragma unroll
  for (int k = 0; k < 8; ++k) d &= d >> 1;
  return (d & 0xFFFFu) != 0u;
}

__global__ void fast_score_kernel(const float* __restrict__ img,
                                  uint8_t* __restrict__ corner_hi,
                                  uint8_t* __restrict__ corner_lo,
                                  float* __restrict__ score, int H, int W,
                                  float th_hi, float th_lo) {
  __shared__ float tile[TY + 2 * HALO][TX + 2 * HALO];
  const float* src = img + (size_t)blockIdx.z * H * W;
  int x0 = blockIdx.x * TX, y0 = blockIdx.y * TY;
  for (int yy = threadIdx.y; yy < TY + 2 * HALO; yy += TY)
    for (int xx = threadIdx.x; xx < TX + 2 * HALO; xx += TX)
      tile[yy][xx] = src[(size_t)clampi(y0 + yy - HALO, 0, H - 1) * W +
                         clampi(x0 + xx - HALO, 0, W - 1)];
  __syncthreads();
  int x = x0 + threadIdx.x, y = y0 + threadIdx.y;
  if (x >= W || y >= H) return;
  int cy = threadIdx.y + HALO, cx = threadIdx.x + HALO;
  float c = tile[cy][cx];
  unsigned bh_hi = 0, bd_hi = 0, bh_lo = 0, bd_lo = 0;
  float sb = 0.f, sd = 0.f;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    float diff = tile[cy + kDy[i]][cx + kDx[i]] - c;
    unsigned bit = 1u << i;
    bh_hi |= diff > th_hi ? bit : 0u;
    bd_hi |= diff < -th_hi ? bit : 0u;
    bh_lo |= diff > th_lo ? bit : 0u;
    bd_lo |= diff < -th_lo ? bit : 0u;
    sb = sb + fmaxf(diff - th_lo, 0.f);
    sd = sd + fmaxf(-diff - th_lo, 0.f);
  }
  size_t p = (size_t)blockIdx.z * H * W + (size_t)y * W + x;
  corner_hi[p] = arc9(bh_hi) || arc9(bd_hi);
  corner_lo[p] = arc9(bh_lo) || arc9(bd_lo);
  score[p] = fmaxf(sb, sd);
}

// One thread block covers a 32x32 pixel tile = 4x4 blocks of 8x8.
constexpr int NT = 32, NB = 8;

__global__ void nms_block_kernel(const float* __restrict__ score,
                                 const uint8_t* __restrict__ chi,
                                 const uint8_t* __restrict__ clo,
                                 float* __restrict__ bs_hi,
                                 int* __restrict__ bi_hi,
                                 float* __restrict__ bs_lo,
                                 int* __restrict__ bi_lo,
                                 int* __restrict__ cnt, int H, int W, int Hb,
                                 int Wb, int r, int border) {
  extern __shared__ float smem[];
  const int S = NT + 2 * r;
  float* sc = smem;             // (S, S) score with an r halo, -inf outside
  float* rm = sc + S * S;       // (S, NT) horizontal (2r+1)-max
  float* vhi = rm + S * NT;     // (NT, NT) kept score at the high threshold
  float* vlo = vhi + NT * NT;   // (NT, NT) kept score at the low threshold
  const int n = blockIdx.z;
  const int x0 = blockIdx.x * NT, y0 = blockIdx.y * NT;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthr = blockDim.x * blockDim.y;
  const float* src = score + (size_t)n * H * W;
  for (int idx = tid; idx < S * S; idx += nthr) {
    int y = y0 - r + idx / S, x = x0 - r + idx % S;
    sc[idx] = (y >= 0 && y < H && x >= 0 && x < W) ? src[(size_t)y * W + x]
                                                   : -INFINITY;
  }
  __syncthreads();
  for (int idx = tid; idx < S * NT; idx += nthr) {
    int yy = idx / NT, xx = idx % NT;
    float m = -INFINITY;
    for (int t = 0; t <= 2 * r; ++t) m = fmaxf(m, sc[yy * S + xx + t]);
    rm[idx] = m;
  }
  __syncthreads();
  for (int idx = tid; idx < NT * NT; idx += nthr) {
    int yy = idx / NT, xx = idx % NT;
    int y = y0 + yy, x = x0 + xx;
    float hi = -INFINITY, lo = -INFINITY;  // padding beyond the image
    if (y < H && x < W) {
      float m = -INFINITY;
      for (int t = 0; t <= 2 * r; ++t) m = fmaxf(m, rm[(yy + t) * NT + xx]);
      float s = sc[(yy + r) * S + xx + r];
      bool keep = s >= m && y >= border && y < H - border && x >= border &&
                  x < W - border;
      size_t p = (size_t)n * H * W + (size_t)y * W + x;
      hi = (keep && chi[p]) ? s : 0.f;
      lo = (keep && clo[p]) ? s : 0.f;
    }
    vhi[idx] = hi;
    vlo[idx] = lo;
  }
  __syncthreads();
  const int per = NT / NB;  // blocks per tile side
  if (tid < per * per) {
    int by = tid / per, bx = tid % per;
    int gby = blockIdx.y * per + by, gbx = blockIdx.x * per + bx;
    if (gby < Hb && gbx < Wb) {
      float mh = -INFINITY, ml = -INFINITY;
      int ah = 0, al = 0, c = 0;
      for (int q = 0; q < NB * NB; ++q) {
        int idx = (by * NB + q / NB) * NT + bx * NB + q % NB;
        float h = vhi[idx], l = vlo[idx];
        if (h > mh) { mh = h; ah = q; }
        if (l > ml) { ml = l; al = q; }
        c += h > 0.f;
      }
      size_t o = (size_t)n * Hb * Wb + (size_t)gby * Wb + gbx;
      bs_hi[o] = mh;
      bi_hi[o] = ah;
      bs_lo[o] = ml;
      bi_lo[o] = al;
      cnt[o] = c;
    }
  }
}

}  // namespace

extern "C" {

// img (N, H, W) -> corner_hi, corner_lo (N, H, W) u8, score (N, H, W).
int fast_score(const float* img, uint8_t* corner_hi, uint8_t* corner_lo,
               float* score, int N, int H, int W, float th_hi, float th_lo,
               cudaStream_t stream) {
  dim3 block(TX, TY);
  dim3 grid((W + TX - 1) / TX, (H + TY - 1) / TY, N);
  fast_score_kernel<<<grid, block, 0, stream>>>(img, corner_hi, corner_lo,
                                                score, H, W, th_hi, th_lo);
  return (int)cudaGetLastError();
}

// score/corner planes (N, H, W) -> per 8x8 block of the (Hb*8, Wb*8)
// -inf-padded kept-score planes: max and first argmax (0..63) at both
// thresholds, and the count of kept high-threshold corners.
int fast_nms_block(const float* score, const uint8_t* chi, const uint8_t* clo,
                   float* bs_hi, int* bi_hi, float* bs_lo, int* bi_lo,
                   int* cnt, int N, int H, int W, int Hb, int Wb, int radius,
                   int border, cudaStream_t stream) {
  int S = NT + 2 * radius;
  size_t smem = sizeof(float) * ((size_t)S * S + (size_t)S * NT + 2 * NT * NT);
  dim3 block(32, 8);
  int per = NT / NB;
  dim3 grid((Wb + per - 1) / per, (Hb + per - 1) / per, N);
  nms_block_kernel<<<grid, block, smem, stream>>>(
      score, chi, clo, bs_hi, bi_hi, bs_lo, bi_lo, cnt, H, W, Hb, Wb, radius,
      border);
  return (int)cudaGetLastError();
}

}  // extern "C"
