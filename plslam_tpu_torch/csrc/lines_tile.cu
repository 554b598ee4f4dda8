// Kernel E: Sobel gradients with the line-support planes (K4), and the
// overlapping window moments of the line detector (K8).
//
// Replaces plslam_tpu/ops/image.py::sobel_gradients (:113), the planes of
// plslam_tpu/ops/lines.py::tile_stage (:330-375), and ::tile_moment_maps
// (:84) / ::orientation_maps (:167). The reference runs the window sums as
// banded block-sum matmuls on the MXU; here they are what those matrices
// compute.
//
// The line detector's path is one launch, lines_tile_moments
// (tile_moments_kernel): from the image to the eight reweighted window
// maps. A CTA owns By x Bx output windows of one image (at most 16 x 29,
// balanced over the grid; one CTA an SM) and holds the edge-clamped image
// tile they depend on in shared memory: the windows need the reweighted
// s x s blocks over (By+1) x (Bx+1), whose pixels read the unit
// orientation field at tiles [b0-1, b0+By], which needs the orientation
// blocks over (By+3) x (Bx+3); so (By+3)s + 2 rows by (Bx+3)s + 2
// columns, the Sobel halo included. One warp a block row, one lane a
// block column; each lane walks its block's pixels in row-major order and
// forms their Sobel taps and planes in registers from the tile (three
// rows slide down the block, each column's y smoothing and y difference
// formed once a row), so the planes never reach memory:
//   0. warp w copies the s + 2 tile rows its orientation blocks read
//      (cp.async, 4 bytes a copy: the rows are not 16-byte aligned) and
//      waits for its own copies only;
//   1. orientation blocks: the d2x, d2y sums of the block;
//   2. the orientation windows (2 x 2 blocks) and the unit field
//      u2 = D2 / (|D2| + 1e-9) of the tiles the next pass reads;
//   3. reweighted blocks: the planes again, ratio = max(align, 0)^2 with
//      align read through the reference's edge-padded nearest upsample (a
//      block's four tiles read once), and the eight block sums in
//      block-LOCAL coordinates;
//   4. the windows, with the exact parallel-axis shifts; out.
// Shared memory: the tile's columns are skewed by one float a block
// (column c at c + c / s) so a warp's blocks, s floats apart, fall on
// distinct banks at s = 8.
//
// Bound: the bytes are the image once and 32 bytes a window out, but the
// work is per pixel: the Sobel taps, a square root and two divisions for
// the planes in both passes and a third division for the alignment, and
// the halos compute ~1.3x (orientation) and ~1.1x (reweighted) the
// pixels a CTA owns. So the kernel runs at the issue rate of that
// arithmetic, not at the memory's. A pixel below the gradient threshold
// skips its divisions and terms (they are +0, which leave a sum's bits as
// they are) only when the warp's 32 pixels at that position all do.
// s = 8 is compiled with the sliding rows and u8_wrap as a constant; any
// other s with nine taps a pixel.
//
// The old path's two launches stay as public functions (no path caller):
// lines_sobel (sobel_kernel) writes gx, gy or the planes w, d2x, d2y;
// lines_moments (block_moments + window_moments) sums either the two
// double-angle planes or the eight reweighted moments from given planes
// and a given unit field, one thread a block reading global memory.
//
// Rounding: every per-pixel product and sum is an explicit _rn intrinsic
// (no FMA contraction), and every sum keeps the old kernels' order (a
// block's pixels row-major from 0, a window's blocks (0,0) (0,1) (1,0)
// (1,1)); the unit field is torch's correctly rounded mul, add, sqrt and
// div. So lines_tile_moments gives the old chain's bits (lines_sobel,
// lines_moments, torch's glue, lines_moments), and the planes equal the
// plain PyTorch version's; the window sums differ from the plain version
// (and from the reference's matmuls) only in summation order.

#include <cuda_runtime.h>

namespace {

constexpr int BX = 32, BY = 8;

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }

// One column of the 3 x 3 Sobel from its rows a, b, e (top to bottom):
// the smoothing along y and the difference along y (with u8_wrap, for a
// uint8 image held as f32 integers, the difference wraps modulo 256 as
// the reference's uint8 subtraction does on a uint8 first frame).
__device__ __forceinline__ void sobel_column(float a, float b, float e,
                                             int u8_wrap, float& sy,
                                             float& dv) {
  sy = mul(add(add(a, mul(2.f, b)), e), 0.25f);  // smooth along y
  float d = sub(e, a);
  if (u8_wrap && d < 0.f) d = add(d, 256.f);    // uint8 wrap-around
  dv = mul(d, 0.5f);                            // diff along y
}

// gx, gy of a pixel from its left, middle and right columns.
__device__ __forceinline__ float sobel_gx(float sy0, float sy2) {
  return mul(sub(sy2, sy0), 0.5f);
}
__device__ __forceinline__ float sobel_gy(float dv0, float dv1, float dv2) {
  return mul(add(add(dv0, mul(2.f, dv1)), dv2), 0.25f);
}

// The line-support planes of a pixel: w = |g| > th ? |g| : 0 and, where
// w > 0 (returned), d2x = (gx^2 - gy^2) / |g|, d2y = 2 gx gy / |g|; else
// d2x = d2y = 0 and no division is made.
__device__ __forceinline__ bool support_planes(float g_x, float g_y,
                                               float th, float& w, float& x,
                                               float& y) {
  const float gxx = mul(g_x, g_x), gyy = mul(g_y, g_y);
  const float mag = __fsqrt_rn(add(gxx, gyy));
  w = mag > th ? mag : 0.f;
  x = 0.f;
  y = 0.f;
  if (!(w > 0.f)) return false;
  const float ms = fmaxf(mag, 1e-9f);
  x = __fdiv_rn(sub(gxx, gyy), ms);
  y = __fdiv_rn(mul(mul(2.f, g_x), g_y), ms);
  return true;
}

// One pixel's terms of the reweighted pass: ratio = max(align, 0)^2,
// align = (d2x U + d2y V) / max(w, 1e-9), with (U, V) the unit
// orientation field at the pixel's tile; wr = w ratio, xr = d2x ratio,
// yr = d2y ratio. A pixel with w = 0 gives +0 terms.
__device__ __forceinline__ void reweighted_terms(float wv, float xv, float yv,
                                                 float U, float V, float& wr,
                                                 float& xr, float& yr) {
  const float align =
      __fdiv_rn(add(mul(xv, U), mul(yv, V)), fmaxf(wv, 1e-9f));
  const float a = fmaxf(align, 0.f);
  const float ratio = mul(a, a);
  wr = mul(wv, ratio);
  xr = mul(xv, ratio);
  yr = mul(yv, ratio);
}

// A pixel's reweighted terms added to the eight block sums, (fx, fy) its
// block-LOCAL position.
__device__ __forceinline__ void moments_add(float* acc, float wr, float xr,
                                            float yr, float fx, float fy) {
  acc[0] = add(acc[0], wr);
  acc[1] = add(acc[1], mul(wr, fx));
  acc[2] = add(acc[2], mul(wr, fy));
  acc[3] = add(acc[3], mul(wr, fx * fx));
  acc[4] = add(acc[4], mul(wr, fy * fy));
  acc[5] = add(acc[5], mul(wr, fy * fx));
  acc[6] = add(acc[6], xr);
  acc[7] = add(acc[7], yr);
}

// The eight (2s x 2s, stride s) window sums from 2 x 2 blocks, g(k, di,
// dj) the block sums of moment k, each block's local origin shifted to the
// window's by (dy, dx) = (di s, dj s); terms added in the reference's
// order (0,0) (0,1) (1,0) (1,1).
template <class G>
__device__ __forceinline__ void window_sums8(G g, int s, float* r) {
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
}

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
  for (int c = 0; c < 3; ++c)
    sobel_column(tile[ty - 1][tx + c - 1], tile[ty][tx + c - 1],
                 tile[ty + 1][tx + c - 1], u8_wrap, sy[c], dv[c]);
  const float g_x = sobel_gx(sy[0], sy[2]);
  const float g_y = sobel_gy(dv[0], dv[1], dv[2]);
  const size_t o = (size_t)blockIdx.z * H * W + (size_t)y * W + x;
  if (gx != nullptr) {
    gx[o] = g_x;
    gy[o] = g_y;
  }
  if (w != nullptr) {
    float ww, px, py;
    support_planes(g_x, g_y, grad_th, ww, px, py);
    w[o] = ww;
    d2x[o] = px;
    d2y[o] = py;
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
      float wr, xr, yr;
      reweighted_terms(w[row + x], d2x[row + x], d2y[row + x], U, V, wr, xr,
                       yr);
      moments_add(acc, wr, xr, yr, (float)lx, fy);
    }
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) blocks[k * plane + out] = acc[k];
}

// out[k, n, i, j]: the window sums of the blocks (window_sums8; the
// orientation pass's two: the plain sums of 2 x 2 blocks in the same order).
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
  float r[8];
  window_sums8(g, s, r);
#pragma unroll
  for (int k = 0; k < 8; ++k) out[k * oplane + o] = r[k];
}

// -- lines_tile_moments: from the image to the eight reweighted window maps

constexpr int TM_LANES = 32;                 // block columns a warp: Bx + 3
constexpr int TM_MAX_BY = 16;                // window rows a CTA
constexpr int TM_THREADS = TM_LANES * (TM_MAX_BY + 3);
constexpr size_t TM_SMEM_MAX = 227 * 1024;   // one CTA an SM

// the tile's row pitch in floats: column c lies at c + c / s
__host__ __device__ inline int tm_pitch(int C, int s) {
  return C + (C - 1) / s + 1;
}

// floats of the image tile of a By x Bx CTA (rounded up to an even count:
// the float2 arrays after it)
__host__ __device__ inline size_t tm_tile_floats(int By, int Bx, int s) {
  const size_t n = (size_t)((By + 3) * s + 2) * tm_pitch((Bx + 3) * s + 2, s);
  return (n + 1) & ~(size_t)1;
}

// shared bytes: the tile, the orientation blocks (float2, (By+3) x 32),
// the unit field (float2, (By+2) x 32), the reweighted blocks (8 x
// (By+1) x 32)
inline size_t tm_smem(int By, int Bx, int s) {
  return sizeof(float) *
         (tm_tile_floats(By, Bx, s) + (size_t)TM_LANES *
                                          (2 * (By + 3) + 2 * (By + 2) +
                                           8 * (By + 1)));
}

// A 4-byte asynchronous copy from global to shared memory: a thread puts
// all of its tile's loads in flight before it waits.
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

// Calls f(ly, lx, gx, gy) for the s x s pixels of the block whose first
// pixel sits at tile row row0 + 1, tile column bc s + 1, in row-major
// order, with sobel_kernel's gx, gy. S > 0: three tile rows slide down
// the block in registers and each of its s + 2 columns is smoothed and
// differenced once a row; S = 0: any s, nine taps a pixel.
template <int S, class F>
__device__ __forceinline__ void sobel_block(const float* __restrict__ T,
                                            int Cp, int row0, int bc,
                                            int s_rt, int u8_wrap, F&& f) {
  if constexpr (S > 0) {
    const float* base = T + (size_t)row0 * Cp + bc * (S + 1);
    float ra[S + 2], rb[S + 2];
#pragma unroll
    for (int k = 0; k < S + 2; ++k) {
      ra[k] = base[k + k / S];
      rb[k] = base[Cp + k + k / S];
    }
#pragma unroll 1
    for (int ly = 0; ly < S; ++ly) {
      const float* rc = base + (size_t)(ly + 2) * Cp;
      float sy[S + 2], dv[S + 2];
#pragma unroll
      for (int k = 0; k < S + 2; ++k) {
        const float e = rc[k + k / S];
        sobel_column(ra[k], rb[k], e, u8_wrap, sy[k], dv[k]);
        ra[k] = rb[k];
        rb[k] = e;
      }
#pragma unroll
      for (int lx = 0; lx < S; ++lx)
        f(ly, lx, sobel_gx(sy[lx], sy[lx + 2]),
          sobel_gy(dv[lx], dv[lx + 1], dv[lx + 2]));
    }
  } else {
    const int s = s_rt;
    for (int ly = 0; ly < s; ++ly) {
      const float* r = T + (size_t)(row0 + ly) * Cp;
      for (int lx = 0; lx < s; ++lx) {
        float sy[3], dv[3];
        for (int c = 0; c < 3; ++c) {
          const int col = bc * s + lx + c, o = col + col / s;
          sobel_column(r[o], r[Cp + o], r[2 * Cp + o], u8_wrap, sy[c], dv[c]);
        }
        f(ly, lx, sobel_gx(sy[0], sy[2]), sobel_gy(dv[0], dv[1], dv[2]));
      }
    }
  }
}

// One CTA: the By x Bx windows from (i0, j0) = (blockIdx.y By,
// blockIdx.x Bx) of image blockIdx.z; warps of 32 lanes, a block row a
// warp and a block column a lane in every phase.
template <int S, int U8>
__global__ void __launch_bounds__(TM_THREADS, 1)
    tile_moments_kernel(const float* __restrict__ img, float* __restrict__ out,
                        int N, int H, int W, int Th, int Tw, int s_rt, int By,
                        int Bx, float grad_th, int u8_rt) {
  const int u8_wrap = U8 >= 0 ? U8 : u8_rt;
  extern __shared__ float sm[];
  const int s = S > 0 ? S : s_rt;
  const int n = blockIdx.z;
  const int i0 = blockIdx.y * By, j0 = blockIdx.x * Bx;
  const int nby = min(By, Th - i0), nbx = min(Bx, Tw - j0);
  const int Cp = tm_pitch((Bx + 3) * s + 2, s);
  float* T = sm;
  float2* O = reinterpret_cast<float2*>(sm + tm_tile_floats(By, Bx, s));
  float2* U = O + (By + 3) * TM_LANES;
  float* B = reinterpret_cast<float*>(U + (By + 2) * TM_LANES);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // 0. the image tile: rows from (i0 - 1) s - 1, columns from
  // (j0 - 1) s - 1, edge-clamped as sobel_kernel's taps (rows and columns
  // outside the image only feed blocks that no window reads). Warp w
  // copies the s + 2 rows its orientation blocks read (neighbours copy the
  // two rows they share, the same values) and waits for its own copies
  // only, so its first pass starts while other warps' rows are in flight.
  if (warp < nby + 3) {
    const float* src = img + (size_t)n * H * W;
    const int C = (nbx + 3) * s + 2;
    const int y0 = (i0 - 1) * s - 1, x0 = (j0 - 1) * s - 1;
    for (int r = warp * s; r < warp * s + s + 2; ++r) {
      const float* row = src + (size_t)clampi(y0 + r, 0, H - 1) * W;
      float* dst = T + (size_t)r * Cp;
      for (int c = lane; c < C; c += TM_LANES)
        cp_async4(dst + c + c / s, row + clampi(x0 + c, 0, W - 1));
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  }
  __syncwarp();

  // 1. orientation blocks (i0 - 1 + warp, j0 - 1 + lane): the sums of
  // d2x, d2y over the block, row-major (block_moments' order)
  {
    const int bi = i0 - 1 + warp, bj = j0 - 1 + lane;
    if (warp < nby + 3 && lane < nbx + 3 && bi >= 0 && bi <= Th && bj >= 0 &&
        bj <= Tw) {
      float ax = 0.f, ay = 0.f;
      sobel_block<S>(T, Cp, warp * s, lane, s, u8_wrap,
                     [&](int, int, float g_x, float g_y) {
                       float wv, xv, yv;
                       if (support_planes(g_x, g_y, grad_th, wv, xv, yv)) {
                         ax = add(ax, xv);
                         ay = add(ay, yv);
                       }
                     });
      O[warp * TM_LANES + lane] = make_float2(ax, ay);
    }
  }
  __syncthreads();

  // 2. the unit orientation field at tiles (i0 - 1 + warp, j0 - 1 + lane):
  // the window sums D2 (window_moments' order), u2 = D2 / (|D2| + 1e-9)
  {
    const int ti = i0 - 1 + warp, tj = j0 - 1 + lane;
    if (warp < nby + 2 && lane < nbx + 2 && ti >= 0 && ti < Th && tj >= 0 &&
        tj < Tw) {
      const float2* o = O + warp * TM_LANES + lane;
      const float2 a = o[0], b = o[1], c = o[TM_LANES], d = o[TM_LANES + 1];
      const float Dx = add(add(add(a.x, b.x), c.x), d.x);
      const float Dy = add(add(add(a.y, b.y), c.y), d.y);
      const float nrm = add(__fsqrt_rn(add(mul(Dx, Dx), mul(Dy, Dy))), 1e-9f);
      U[warp * TM_LANES + lane] =
          make_float2(__fdiv_rn(Dx, nrm), __fdiv_rn(Dy, nrm));
    }
  }
  __syncthreads();

  // 3. reweighted blocks (i0 + warp, j0 + lane): the planes again, each
  // pixel's unit field through the reference's up() (edge-padded nearest
  // upsample: tile clamp((p - s/2) / s)), the eight block sums
  if (warp <= nby && lane <= nbx) {
    const int bi = i0 + warp, bj = j0 + lane;
    // a pixel (ly, lx) of the block reads tile clamp(bi - 1 + (ly >= s/2))
    // of the rows, clamp(bj - 1 + (lx >= s/2)) of the columns
    const int ta = clampi(bi - 1, 0, Th - 1) - i0 + 1;
    const int tb = clampi(bi, 0, Th - 1) - i0 + 1;
    const int ua = clampi(bj - 1, 0, Tw - 1) - j0 + 1;
    const int ub = clampi(bj, 0, Tw - 1) - j0 + 1;
    const float2 u00 = U[ta * TM_LANES + ua], u01 = U[ta * TM_LANES + ub];
    const float2 u10 = U[tb * TM_LANES + ua], u11 = U[tb * TM_LANES + ub];
    float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    sobel_block<S>(
        T, Cp, (warp + 1) * s, lane + 1, s, u8_wrap,
        [&](int ly, int lx, float g_x, float g_y) {
          float wv, xv, yv;
          if (!support_planes(g_x, g_y, grad_th, wv, xv, yv)) return;
          const float2 u = ly < s / 2 ? (lx < s / 2 ? u00 : u01)
                                      : (lx < s / 2 ? u10 : u11);
          float wr, xr, yr;
          reweighted_terms(wv, xv, yv, u.x, u.y, wr, xr, yr);
          moments_add(acc, wr, xr, yr, (float)lx, (float)ly);
        });
#pragma unroll
    for (int k = 0; k < 8; ++k)
      B[(k * (By + 1) + warp) * TM_LANES + lane] = acc[k];
  }
  __syncthreads();

  // 4. the windows (i0 + warp, j0 + lane) -> out (8, N, Th, Tw)
  if (warp < nby && lane < nbx) {
    auto g = [&](int k, int di, int dj) {
      return B[(k * (By + 1) + warp + di) * TM_LANES + lane + dj];
    };
    float r[8];
    window_sums8(g, s, r);
    const size_t oplane = (size_t)N * Th * Tw;
    const size_t o =
        (size_t)n * Th * Tw + (size_t)(i0 + warp) * Tw + (j0 + lane);
#pragma unroll
    for (int k = 0; k < 8; ++k) out[k * oplane + o] = r[k];
  }
}

template <int S, int U8>
int launch_tile_moments(dim3 grid, dim3 block, size_t smem,
                        cudaStream_t stream, const float* img, float* out,
                        int N, int H, int W, int Th, int Tw, int s, int By,
                        int Bx, float grad_th, int u8_wrap) {
  // the opt-in above 48 KB of shared memory, once a device
  static bool opted_in[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 64 || !opted_in[dev]) {
    e = cudaFuncSetAttribute(tile_moments_kernel<S, U8>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)TM_SMEM_MAX);
    if (e != cudaSuccess) return (int)e;
    if (dev < 64) opted_in[dev] = true;
  }
  tile_moments_kernel<S, U8><<<grid, block, smem, stream>>>(
      img, out, N, H, W, Th, Tw, s, By, Bx, grad_th, u8_wrap);
  return (int)cudaGetLastError();
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

// The line detector's tile stage in one launch: img (N, H, W) -> out
// (8, N, Th, Tw) = S, Sx, Sy, Sxx, Syy, Sxy, D2x, D2y, the reweighted
// window maps (tile 2s), bit for bit what lines_sobel, lines_moments, the
// unit field and lines_moments give. CTAs of By x Bx windows, By <= 16
// and Bx <= 29 balanced over the grid, smaller where the tile would pass
// TM_SMEM_MAX (large s); an error where no CTA fits.
int lines_tile_moments(const float* img, float* out, int N, int H, int W,
                       int Th, int Tw, int s, float grad_th, int u8_wrap,
                       cudaStream_t stream) {
  if (N < 1 || Th < 1 || Tw < 1 || s < 1 || (Th + 1) * s > H ||
      (Tw + 1) * s > W)
    return (int)cudaErrorInvalidValue;
  const int nty = (Th + TM_MAX_BY - 1) / TM_MAX_BY;
  int By = (Th + nty - 1) / nty;
  int ntx = (Tw + TM_LANES - 4) / (TM_LANES - 3);
  int Bx = (Tw + ntx - 1) / ntx;
  while (tm_smem(By, Bx, s) > TM_SMEM_MAX) {
    if (Bx > 1 && Bx >= By)
      --Bx;
    else if (By > 1)
      --By;
    else
      return (int)cudaErrorInvalidValue;
  }
  ntx = (Tw + Bx - 1) / Bx;
  Bx = (Tw + ntx - 1) / ntx;
  const dim3 grid(ntx, (Th + By - 1) / By, N);
  const dim3 block(TM_LANES * (By + 3));
  const size_t smem = tm_smem(By, Bx, s);
  if (s == 8 && u8_wrap)
    return launch_tile_moments<8, 1>(grid, block, smem, stream, img, out, N,
                                     H, W, Th, Tw, s, By, Bx, grad_th, 1);
  if (s == 8)
    return launch_tile_moments<8, 0>(grid, block, smem, stream, img, out, N,
                                     H, W, Th, Tw, s, By, Bx, grad_th, 0);
  return launch_tile_moments<0, -1>(grid, block, smem, stream, img, out, N, H,
                                    W, Th, Tw, s, By, Bx, grad_th, u8_wrap);
}

}  // extern "C"
