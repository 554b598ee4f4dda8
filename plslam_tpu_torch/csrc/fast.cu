// Kernel B: FAST-16 corner test and score (K1), NMS and 8x8 block
// max/argmax (K2), two launches.
//
// Replaces plslam_tpu/ops/fast.py::fast_score_map2 (:70) with
// _arc9_from_bitmask (:49), and the per-pixel part of detect_fast (:200):
// nms (:110), the border mask and the block max/argmax of
// select_topk_grid (:157-167). The per-cell and global top-k stay in
// PyTorch (a stable sort, whose tie order is lax.top_k's).
//
// Launch 1 (fast_score_kernel) is bound by its instructions: it reads 4
// bytes and writes 6 a pixel, but the function needs ~215 f32 and integer
// operations a pixel (16 taps x (a difference, 4 threshold tests, 4 bit
// accumulations, 2 clamps, 2 sums), 4 arc tests, the final max), and the
// card runs 128 such lane-operations a clock an SM. The design cuts the
// instructions a pixel to about that count:
//  - mask bits from sign bits. For finite f32, diff > th exactly when
//    th - diff is negative, and diff < -th exactly when diff + th is
//    (unequal finite floats never subtract to zero, with subnormals kept;
//    equal ones give +0). So each bit is one FADD and a funnel shift of
//    the sign into the mask. The low threshold's two values double as the
//    score terms: diff - th_lo == -(th_lo - diff) and -diff - th_lo ==
//    -(diff + th_lo) exactly (round-to-nearest is symmetric), and where
//    they are zero the clamp's -0 adds to a sum that starts at +0 as +0
//    does. sb and sd add the taps in the _CIRCLE order, tap 0 first, as
//    the plain version: the score keeps its bits.
//  - the 9-arc test from a table: bit m of a 65,536-bit table (8 KB,
//    built on the host from the plain version's _arc9_from_bitmask and
//    staged in each block's shared memory) says whether mask m holds 9
//    circularly contiguous bits. The funnel shift leaves tap i at bit
//    15 - i; the set is closed under that bit reversal, so one table
//    serves. A test is a shift, a load and a shift.
//  - each thread computes FS_ROWS pixels of one column (FS_NY rows
//    apart) from one shared tile of 32 x 64 pixels and their halo (a
//    warp reads 32 neighbouring columns: no bank conflicts), so the
//    halo's clamped loads and the table's staging are paid once for
//    FS_ROWS pixels; both are asynchronous copies (cp.async), all in
//    flight at once. A warp's stores are 32 neighbouring pixels of a row.
//  The tap loop compiles to 14 instructions a tap (an LDS, 7 FADD, 4 SHF,
//  2 FMNMX). On an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py): 0.205
//  ms at 40 x 376x1241 against a bound of 0.120 (the per-pixel, compare-
//  and-select kernel it replaced: 0.477).
// Launch 2 reads score and masks once (5-pixel halo in shared memory),
// does ~40 compares per pixel and writes 1/64 of that: bound by bytes.
// Nothing but the inputs and outputs crosses device memory.
//
// Block argmax keeps the first index in row-major order, as jnp.argmax.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int HALO = 3;
constexpr int FS_NX = 32, FS_NY = 8, FS_ROWS = 8;
constexpr int FS_TH = FS_NY * FS_ROWS;          // 64 rows a block
constexpr int FS_PITCH = FS_NX + 2 * HALO;      // 38 tile columns
constexpr int ARC_WORDS = (1 << 16) / 32;       // the 8 KB arc table

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// Bresenham circle of radius 3, clockwise from 12 o'clock (fast.py
// _CIRCLE): tap i's offset in a tile of pitch FS_PITCH, a compile-time
// constant once the tap loop is unrolled
__host__ __device__ constexpr int circle_off(int i) {
  constexpr int p = FS_PITCH;
  switch (i) {
    case 0: return -3 * p;      case 1: return -3 * p + 1;
    case 2: return -2 * p + 2;  case 3: return -p + 3;
    case 4: return 3;           case 5: return p + 3;
    case 6: return 2 * p + 2;   case 7: return 3 * p + 1;
    case 8: return 3 * p;       case 9: return 3 * p - 1;
    case 10: return 2 * p - 2;  case 11: return p - 3;
    case 12: return -3;         case 13: return -p - 3;
    case 14: return -2 * p - 2; default: return -3 * p - 1;
  }
}

// global -> shared copies that do not wait for their data (cp.async,
// sm_80 and later); cp_async_wait_all waits for the thread's own
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async16(uint4* dst, const uint4* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// the sign bit of x shifted in at bit 0
__device__ __forceinline__ unsigned sign_in(float x, unsigned bits) {
  return __funnelshift_l(__float_as_uint(x), bits, 1);
}

__device__ __forceinline__ unsigned arc9(const unsigned* table, unsigned m) {
  return __funnelshift_r(table[m >> 5], 0u, m) & 1u;
}

__global__ void __launch_bounds__(FS_NX * FS_NY)
    fast_score_kernel(const float* __restrict__ img,
                      uint8_t* __restrict__ corner_hi,
                      uint8_t* __restrict__ corner_lo,
                      float* __restrict__ score,
                      const uint4* __restrict__ arc_table, int H, int W,
                      float th_hi, float th_lo) {
  __shared__ float tile[(FS_TH + 2 * HALO) * FS_PITCH];
  __shared__ uint4 arc_s[ARC_WORDS / 4];
  const int tid = threadIdx.y * FS_NX + threadIdx.x;
  // asynchronous copies: a thread's loads are all in flight at once
  for (int i = tid; i < ARC_WORDS / 4; i += FS_NX * FS_NY)
    cp_async16(arc_s + i, arc_table + i);
  const float* src = img + (size_t)blockIdx.z * H * W;
  const int x0 = blockIdx.x * FS_NX - HALO, y0 = blockIdx.y * FS_TH - HALO;
  const int xa = clampi(x0 + (int)threadIdx.x, 0, W - 1);
  const int xb = clampi(x0 + (int)threadIdx.x + FS_NX, 0, W - 1);
  for (int yy = threadIdx.y; yy < FS_TH + 2 * HALO; yy += FS_NY) {
    const float* row = src + clampi(y0 + yy, 0, H - 1) * W;
    cp_async4(tile + yy * FS_PITCH + threadIdx.x, row + xa);
    if (threadIdx.x < FS_PITCH - FS_NX)
      cp_async4(tile + yy * FS_PITCH + threadIdx.x + FS_NX, row + xb);
  }
  cp_async_wait_all();
  __syncthreads();
  const unsigned* table = reinterpret_cast<const unsigned*>(arc_s);
  const int x = blockIdx.x * FS_NX + threadIdx.x;
  if (x >= W) return;
  const size_t plane = (size_t)blockIdx.z * H * W;
#pragma unroll 1
  for (int k = 0; k < FS_ROWS; ++k) {
    const int ty = threadIdx.y + k * FS_NY;
    const int y = blockIdx.y * FS_TH + ty;
    if (y >= H) break;
    const float* t = tile + (ty + HALO) * FS_PITCH + threadIdx.x + HALO;
    const float c = t[0];
    unsigned bh_hi = 0, bd_hi = 0, bh_lo = 0, bd_lo = 0;
    float sb = 0.f, sd = 0.f;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const float diff = t[circle_off(i)] - c;
      const float lo_b = th_lo - diff;     // < 0 iff diff > th_lo
      const float lo_d = diff + th_lo;     // < 0 iff diff < -th_lo
      bh_hi = sign_in(th_hi - diff, bh_hi);
      bd_hi = sign_in(diff + th_hi, bd_hi);
      bh_lo = sign_in(lo_b, bh_lo);
      bd_lo = sign_in(lo_d, bd_lo);
      sb = sb + fmaxf(-lo_b, 0.f);         // max(diff - th_lo, 0)
      sd = sd + fmaxf(-lo_d, 0.f);         // max(-diff - th_lo, 0)
    }
    const size_t p = plane + (size_t)y * W + x;
    corner_hi[p] = (uint8_t)(arc9(table, bh_hi) | arc9(table, bd_hi));
    corner_lo[p] = (uint8_t)(arc9(table, bh_lo) | arc9(table, bd_lo));
    score[p] = fmaxf(sb, sd);
  }
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

// img (N, H, W) -> corner_hi, corner_lo (N, H, W) bytes of 0 or 1 (a
// torch.bool tensor's storage), score (N, H, W); arc_table: the 2,048
// words of the arc table (16-byte aligned).
int fast_score(const float* img, uint8_t* corner_hi, uint8_t* corner_lo,
               float* score, const uint4* arc_table, int N, int H, int W,
               float th_hi, float th_lo, cudaStream_t stream) {
  const dim3 block(FS_NX, FS_NY);
  const dim3 grid((W + FS_NX - 1) / FS_NX, (H + FS_TH - 1) / FS_TH, N);
  fast_score_kernel<<<grid, block, 0, stream>>>(
      img, corner_hi, corner_lo, score, arc_table, H, W, th_hi, th_lo);
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
