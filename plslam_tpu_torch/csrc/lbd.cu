// Kernel H: Line Band Descriptor bits (K12), from the image to the bits in
// one launch.
//
// Replaces plslam_tpu/ops/lbd.py::describe_lines (:51), with the Sobel maps
// it computes itself (plslam_tpu/ops/image.py::sobel_gradients, :113) and
// its sampler plslam_tpu/ops/image.py::bilinear_sample_mxu_multi (:177).
// The reference samples both Sobel maps on the TPU as a bf16 matmul
// against hat-weight matrices, so the samples carry bf16 rounding: the
// gradient values and the x hat weights max(1 - |x - i|, 0) are rounded to
// bf16, their products summed in f32, then weighted by the f32 y hat
// weights. This kernel forms the two taps of each row and rounds the same
// way (__float2bfloat16_rn), so its bits equal the reference's; without
// the rounding they differ at about 1e-3.
//
// One warp a segment, LBD_WARPS segments a CTA, no block barrier. The
// lanes take the n_samples x (n_bands * samples_per_band) grid in turns
// (positions from the reference's t and o tables, x clamped to
// [0, W - 1.001], y to [0, H - 1.001]), 32 that lie along the image's
// rows at a time: the samples along the segment at one band offset where
// the segment spans fewer rows than the band, else the band's samples at
// one place along it. In the image mode (the path's) a sample reads the
// 4 x 4 patch around its 2 x 2 taps (rows and columns clamped to the
// image; inside it, each row at one address) and forms each tap's gx, gy
// from its clamped 3 x 3 neighbourhood with lines_sobel's arithmetic
// (csrc/lines_tile.cu, its u8_wrap rule included: the y difference of a
// uint8 image wraps modulo 256): each column's sum and difference along y
// are shared by the two taps of a row, and lines_sobel's power-of-two
// scalings are applied at once, which leaves every bit as it was while no
// value is subnormal. In the gradient mode (ops/lbd.py::describe_lines, no
// path caller) it reads the taps of both maps. The samples are rotated
// into the line frame and kept in the warp's shared memory; then lane f <
// 2 n_bands sums both signs of one band's parallel or perpendicular
// samples in the fixed order (along, then across) in registers, every
// lane the L2 norm over the statistics in order, and each lane 8 of the
// 256 pair tests f[p0] < f[p1] (pair table `_make_pairs(4 * n_bands)`),
// written as one 8-byte store: a segment's 256 bytes in one whole-warp
// store.
//
// Bound: the image's bytes read once (18.65 MB at 40 x 188 x 620) against
// ~170 operations a sample: a few microseconds either way. The time goes
// to the samples (PERF.md, tools/k12_k15_timeline.py): each is ~200
// instructions and 16 scattered loads with a long dependent chain, and a
// warp takes its segment's 432 in 14 turns; the Sobel maps that the
// parent kernel read (twice the image's bytes, written by a launch of
// their own) are gone.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LBD_WARPS = 4;  // segments a CTA, a warp each
constexpr int LBD_MAX_NF = 64;

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
// two values rounded to bf16 (to nearest even) in one conversion
__device__ __forceinline__ void bf2(float& x, float& y) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(x, y);
  x = __low2float(v);
  y = __high2float(v);
}
__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// the column of a tap row from its rows a, b, e (top to bottom): lines_sobel's
// sum along y, (a + 2 b) + e, and difference e - a (wrapped modulo 256 with
// WRAP), each before its power-of-two scaling (0.25, 0.5), which the taps
// apply at once (0.125): the same bits while no value is subnormal. 2 b is
// exact, so a + 2 b is one fused multiply-add.
template <bool WRAP>
__device__ __forceinline__ void sobel_column(float a, float b, float e,
                                             float& sum, float& dif) {
  sum = add(__fmaf_rn(b, 2.f, a), e);
  dif = sub(e, a);
  if (WRAP && dif < 0.f) dif = add(dif, 256.f);
}

// 9 CTAs a SM (56 registers, none spilled): 1,188 of the path's 1,280 CTAs
// in the first wave
template <bool FROM_IMAGE, bool WRAP>
__global__ void __launch_bounds__(32 * LBD_WARPS, 9)
    lbd_kernel(const float* __restrict__ img, const float* __restrict__ gx,
               const float* __restrict__ gy, const float* __restrict__ sp,
               const float* __restrict__ ep, const float* __restrict__ t_tab,
               const float* __restrict__ o_tab,
               const uint8_t* __restrict__ pairs, uint8_t* __restrict__ bits,
               int NL, int L, int H, int W, int S, int NB, int SPB,
               float xmax, float ymax) {
  extern __shared__ float sm[];
  const int A = NB * SPB, NS = S * A, NF = 4 * NB;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int seg = blockIdx.x * LBD_WARPS + warp;  // n * L + l
  if (seg >= NL) return;
  float* gpar = sm + warp * (2 * NS + NF);
  float* gperp = gpar + NS;
  float* feats = gperp + NS;
  const int n = seg / L;
  const float sx = sp[2 * seg], sy = sp[2 * seg + 1];
  const float d0 = sub(ep[2 * seg], sx), d1 = sub(ep[2 * seg + 1], sy);
  const float len = __fsqrt_rn(add(add(mul(d0, d0), mul(d1, d1)), 1e-12f));
  const float dx = __fdiv_rn(d0, len), dy = __fdiv_rn(d1, len);
  const float nx = -dy, ny = dx;
  const size_t plane = (size_t)n * H * W;
  // the lanes of a load take samples that lie along the image's rows: the
  // along samples of one band offset (a-major) where the segment spans
  // fewer rows than the band does across, else the across samples of one
  // position along (s-major); each sample keeps its (s, a) slot
  const float span = sub(__ldg(o_tab + A - 1), __ldg(o_tab));
  const bool amajor = fabsf(d1) * len < span * fabsf(d0);
  const int MN = amajor ? S : A;  // the minor axis' extent
  int mj = 0, mn = lane;
  while (mn >= MN) mn -= MN, ++mj;
  const float* im = FROM_IMAGE ? img + plane : nullptr;
  for (int q = lane; q < NS; q += 32) {
    const int s = amajor ? mn : mj, a = amajor ? mj : mn, k = s * A + a;
    const float tt = __ldg(t_tab + s), oo = __ldg(o_tab + a);
    const float px = add(add(sx, mul(d0, tt)), mul(nx, oo));
    const float py = add(add(sy, mul(d1, tt)), mul(ny, oo));
    const float x = fminf(fmaxf(px, 0.f), xmax);
    const float y = fminf(fmaxf(py, 0.f), ymax);
    const float x0 = floorf(x), y0 = floorf(y);
    float wx0 = fmaxf(sub(1.f, fabsf(sub(x, x0))), 0.f);
    float wx1 = fmaxf(sub(1.f, fabsf(sub(x, add(x0, 1.f)))), 0.f);
    bf2(wx0, wx1);
    const float wy0 = fmaxf(sub(1.f, fabsf(sub(y, y0))), 0.f);
    const float wy1 = fmaxf(sub(1.f, fabsf(sub(y, add(y0, 1.f)))), 0.f);
    const int ix = (int)x0, iy = (int)y0;
    float tx[2][2], ty[2][2];  // [tap row][tap column] gx, gy
    if (FROM_IMAGE) {
      float p[4][4];
      if (ix >= 1 && ix <= W - 3 && iy >= 1 && iy <= H - 3) {
        // inside: four rows of four, each row at one address
        const float* row = im + (size_t)(iy - 1) * W + (ix - 1);
#pragma unroll
        for (int i = 0; i < 4; ++i, row += W)
#pragma unroll
          for (int j = 0; j < 4; ++j) p[i][j] = __ldg(row + j);
      } else {
        int col[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) col[j] = clampi(ix - 1 + j, 0, W - 1);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float* row = im + (size_t)clampi(iy - 1 + i, 0, H - 1) * W;
#pragma unroll
          for (int j = 0; j < 4; ++j) p[i][j] = __ldg(row + col[j]);
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float sum[4], dif[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          sobel_column<WRAP>(p[r][j], p[r + 1][j], p[r + 2][j], sum[j],
                             dif[j]);
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          tx[r][c] = mul(sub(sum[c + 2], sum[c]), 0.125f);
          ty[r][c] = mul(add(__fmaf_rn(dif[c + 1], 2.f, dif[c]), dif[c + 2]),
                         0.125f);
        }
      }
    } else {
      const size_t r0 = plane + (size_t)iy * W + (size_t)ix, r1 = r0 + W;
      tx[0][0] = __ldg(gx + r0), tx[0][1] = __ldg(gx + r0 + 1);
      tx[1][0] = __ldg(gx + r1), tx[1][1] = __ldg(gx + r1 + 1);
      ty[0][0] = __ldg(gy + r0), ty[0][1] = __ldg(gy + r0 + 1);
      ty[1][0] = __ldg(gy + r1), ty[1][1] = __ldg(gy + r1 + 1);
    }
    // per row: bf16 taps times bf16 x weights (exact products, so one
    // fused multiply-add), f32 sum; then the rows weighted by the f32 y
    // weights
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      bf2(tx[r][0], tx[r][1]);
      bf2(ty[r][0], ty[r][1]);
    }
    const float cx0 = __fmaf_rn(tx[0][0], wx0, mul(tx[0][1], wx1));
    const float cx1 = __fmaf_rn(tx[1][0], wx0, mul(tx[1][1], wx1));
    const float cy0 = __fmaf_rn(ty[0][0], wx0, mul(ty[0][1], wx1));
    const float cy1 = __fmaf_rn(ty[1][0], wx0, mul(ty[1][1], wx1));
    const float gxs = add(mul(cx0, wy0), mul(cx1, wy1));
    const float gys = add(mul(cy0, wy0), mul(cy1, wy1));
    gpar[k] = add(mul(gxs, dx), mul(gys, dy));
    gperp[k] = add(mul(gxs, nx), mul(gys, ny));
    for (mn += 32; mn >= MN; mn -= MN) ++mj;
  }
  __syncwarp();
  // feats = [par+, par-, perp+, perp-], n_bands each: lane f < 2 NB sums
  // both signs of band b of the parallel (f < NB) or perpendicular samples
  // in their fixed order (along, then across), from one read a sample
  const bool sums = lane < 2 * NB;
  const int fam = lane >= NB ? 1 : 0, b = lane - fam * NB;
  const int f_pos = 2 * fam * NB + b, f_neg = f_pos + NB;
  float pos = 0.f, neg = 0.f;
  if (sums) {
    const float* g = (fam ? gperp : gpar) + b * SPB;
#pragma unroll 4
    for (int s2 = 0; s2 < S; ++s2)
      for (int kk = 0; kk < SPB; ++kk) {
        const float v = g[s2 * A + kk];
        pos = add(pos, fmaxf(v, 0.f));
        neg = add(neg, fmaxf(-v, 0.f));
      }
    feats[f_pos] = pos;
    feats[f_neg] = neg;
  }
  __syncwarp();
  // the norm over the statistics in order, on every lane
  float sq = 0.f;
  for (int f = 0; f < NF; ++f) sq = add(sq, mul(feats[f], feats[f]));
  const float norm = fmaxf(__fsqrt_rn(sq), 1e-9f);
  __syncwarp();
  if (sums) {
    feats[f_pos] = __fdiv_rn(pos, norm);
    feats[f_neg] = __fdiv_rn(neg, norm);
  }
  __syncwarp();
  // bits 8 lane .. 8 lane + 7: one 16-byte read of their pairs, one
  // 8-byte write
  const uint4 pr = __ldg(reinterpret_cast<const uint4*>(pairs) + lane);
  const uint32_t w[4] = {pr.x, pr.y, pr.z, pr.w};
  uint32_t out[2] = {0u, 0u};
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const uint32_t q = w[j >> 1] >> (16 * (j & 1));
    const uint32_t bit = feats[q & 0xff] < feats[(q >> 8) & 0xff] ? 1u : 0u;
    out[j >> 2] |= bit << (8 * (j & 3));
  }
  reinterpret_cast<uint2*>(bits + (size_t)seg * 256)[lane] =
      make_uint2(out[0], out[1]);
}

}  // namespace

extern "C" {

// img (N, H, W) f32, or with img == nullptr the Sobel maps gx, gy (N, H,
// W) f32; sp, ep (N, L, 2) f32 in the image's pixels; t_tab (S,), o_tab
// (NB * SPB,) f32 sample offsets; pairs (256, 2) uint8 -> bits (N, L, 256)
// u8. xmax = W - 1.001, ymax = H - 1.001 (f32); u8_wrap as lines_sobel.
int lbd_describe(const float* img, const float* gx, const float* gy,
                 const float* sp, const float* ep, const float* t_tab,
                 const float* o_tab, const uint8_t* pairs, uint8_t* bits,
                 int N, int L, int H, int W, int S, int NB, int SPB,
                 float xmax, float ymax, int u8_wrap, cudaStream_t stream) {
  const int NL = N * L, NF = 4 * NB;
  if (N < 0 || L < 0 || H < 2 || W < 2 || S < 1 || NB < 1 || SPB < 1 ||
      NF > LBD_MAX_NF)
    return (int)cudaErrorInvalidValue;
  const size_t smem = LBD_WARPS * (2 * (size_t)S * NB * SPB + NF) *
                      sizeof(float);
  auto kernel = img == nullptr ? lbd_kernel<false, false>
                : u8_wrap ? lbd_kernel<true, true> : lbd_kernel<true, false>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  if (NL > 0)
    kernel<<<(NL + LBD_WARPS - 1) / LBD_WARPS, 32 * LBD_WARPS, smem,
             stream>>>(img, gx, gy, sp, ep, t_tab, o_tab, pairs, bits, NL, L,
                       H, W, S, NB, SPB, xmax, ymax);
  return (int)cudaGetLastError();
}

}  // extern "C"
