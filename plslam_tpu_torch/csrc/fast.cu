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
// Launch 2 (nms_block_kernel): the function is bound by bytes. It reads
// the score and the two masks once (6 bytes a pixel), writes 20 bytes an
// 8x8 block and needs ~45 operations a pixel (a (2r+1)^2 max, the keep
// test, two selects, the block max): at 40 x 376x1241 that is 0.035 ms of
// memory against ~0.02 of instructions. The kernel it replaced took 6.4x
// that: each element of the 32x32 tile and its halo staged with a division
// and a modulo, the 11-tap maxima recomputed per pixel from shared memory,
// the kept scores written to two shared planes and then walked serially,
// 64 entries by 16 of 256 threads while 240 waited. So:
//  - a block covers 64 x 64 pixels (8 x 8 blocks of 8x8); its score tile
//    and r-halo (1.34x the tile's pixels at r = 5, against 1.72x for
//    32x32) is staged in quads, 4 pixels from a 16-byte aligned address
//    of the plane where all 4 lie in the image (scalar loads at a row's
//    ends and for unaligned planes), lanes on consecutive quads, every
//    load of a thread issued before its stores, -inf outside the image,
//    never the edge;
//  - the separable (2r+1) max takes 8 outputs a thread from 8 + 2r values
//    in registers, as a suffix max, the 2r - 6 values every window shares
//    and a prefix max (~3 operations an output, not 2r): along the rows
//    (16-byte shared loads and stores) into a second shared plane, then
//    down the columns into the registers of the thread that owns the
//    column's 8 rows of a block. Both planes' pitches are 4 mod 8 floats,
//    so 8 lanes on 8 consecutive rows hit 8 different 16-byte bank groups;
//  - a lane then holds a column of an 8x8 block, so 8 lanes reduce a
//    block: the kept (value, index) pairs of the column in order, then a
//    3-step __shfl_xor_sync tree where the larger value wins and an equal
//    value keeps the lower index, the first argmax of torch.max and
//    jnp.argmax in whatever order the tree meets them; the count of kept
//    high-threshold corners is a shuffle sum of the lanes' counts; the
//    mask bytes are read there, a warp's 32 lanes a row's 32 consecutive
//    bytes (one 32-byte sector).
// What bounds it on the card is not the bytes: the staging alone runs
// near the bytes bound, the maxima and reductions alone take the larger
// part, and the two barely overlap (variants of this file without the one
// or the other). Variants with less address arithmetic, conflict-free
// staging stores, or the masks staged as words in shared memory (more
// registers, fewer blocks an SM) gained nothing or lost. Holding the mask
// bytes in registers from the start kept 56 registers and 2 blocks an SM
// (0.091 ms at level 0 on an NVIDIA H100 80GB HBM3 at 700 W,
// chip_smoke.py); reading them in the keep test, only where a pixel is
// kept, keeps 32 registers and 4 blocks an SM. So the time depends on the
// data: the flat, zero-score regions of a scene keep most of their pixels.
// Blocks wholly in the padding give -inf and index 0, all-zero blocks 0
// and index 0, as the plain version.

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

// nms_block_kernel: a block of NMS_TX x NMS_TY threads covers NMS_TW x
// NMS_TH pixels; thread (tx, ty) owns column tx of block row ty (8 rows)
constexpr int NB = 8;                                   // the 8x8 blocks
constexpr int NMS_TW = 64, NMS_TH = 64;
constexpr int NMS_TX = NMS_TW, NMS_TY = NMS_TH / NB;
constexpr int NMS_NT = NMS_TX * NMS_TY;                 // 512 threads
// Row pitches (floats) of the score tile and of the horizontal max: 4 mod
// 8, so the 16-byte accesses of 8 lanes on consecutive rows (a quarter
// warp, one shared-memory wavefront) fall in 8 different 16-byte bank
// groups
__host__ __device__ constexpr int nms_pitch(int w) {
  return (w + 3) / 8 * 8 + 4;
}
__host__ __device__ constexpr int nms_sp(int r) {
  return nms_pitch(NMS_TW + 2 * r);
}
constexpr int NMS_HP = nms_pitch(NMS_TW);

__host__ __device__ constexpr size_t nms_smem(int r) {
  return sizeof(float) * (size_t)(NMS_TH + 2 * r) * (nms_sp(r) + NMS_HP);
}

// out[j] = max(src[(j + t) * stride], t = 0 .. 2r), j = 0 .. 7. With R >= 4
// a compile-time radius: the values every window shares (indices 7 .. 2R),
// suffix maxima to their left and prefix maxima to their right.
template <int R>
__device__ __forceinline__ void window_max8(const float* src, int stride,
                                            int r, float (&out)[8]) {
  if constexpr (R >= 4) {
    float v[8 + 2 * R];
#pragma unroll
    for (int k = 0; k < 8 + 2 * R; ++k) v[k] = src[k * stride];
    float left[8];                        // left[j] = max(v[j .. 2R])
    left[7] = v[7];
#pragma unroll
    for (int k = 8; k <= 2 * R; ++k) left[7] = fmaxf(left[7], v[k]);
#pragma unroll
    for (int j = 6; j >= 0; --j) left[j] = fmaxf(v[j], left[j + 1]);
    float right = -INFINITY;              // max(v[2R + 1 .. 2R + j])
    out[0] = left[0];
#pragma unroll
    for (int j = 1; j < 8; ++j) {
      right = fmaxf(right, v[2 * R + j]);
      out[j] = fmaxf(left[j], right);
    }
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float m = -INFINITY;
      for (int t = 0; t <= 2 * r; ++t) m = fmaxf(m, src[(j + t) * stride]);
      out[j] = m;
    }
  }
}

// Staging of the score tile: item it is quad j of tile row `row`, the 4
// pixels of the plane from a 16-byte aligned address (lanes on
// consecutive quads of a row), -inf outside the image. A row of CW pixels
// touches at most (CW + 6) / 4 quads.
struct Stage {
  const float* src;  // the plane
  int pm;            // the plane's first element mod 4
  int H, W, x0, y0, r, CW, NQ, RH;
  bool aligned;

  __device__ __forceinline__ void load(int it, float (&v)[4], int& row,
                                       int& c0) const {
    row = it / NQ;
    const int j = it - row * NQ;
    const int y = y0 - r + row;
    const bool in_y = row < RH && y >= 0 && y < H;
    const int yW = in_y ? y * W : 0;
    const int a = (pm + yW + x0 - r) & 3;   // the row's first pixel mod 4
    const int xq = x0 - r - a + 4 * j;       // the quad's first column
    c0 = 4 * j - a;                          // ... in the tile
    if (in_y && aligned && xq >= 0 && xq + 3 < W) {
      const float4 f = __ldg(reinterpret_cast<const float4*>(src + yW + xq));
      v[0] = f.x;
      v[1] = f.y;
      v[2] = f.z;
      v[3] = f.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        v[e] = in_y && xq + e >= 0 && xq + e < W ? __ldg(src + yW + xq + e)
                                                 : -INFINITY;
    }
    if (row >= RH) row = -1;
  }

  __device__ __forceinline__ void store(float* sc, int SP, const float (&v)[4],
                                        int row, int c0) const {
    if (row < 0) return;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (c0 + e >= 0 && c0 + e < CW) sc[row * SP + c0 + e] = v[e];
  }
};

// window_max8 along a row of the score tile (16-byte aligned, stride 1):
// the 8 + 2R values by 16- and 8-byte loads
template <int R>
__device__ __forceinline__ void row_max8(const float* src, int r,
                                         float (&out)[8]) {
  if constexpr (R >= 4 && (8 + 2 * R) % 2 == 0) {
    float v[8 + 2 * R];
#pragma unroll
    for (int k = 0; k + 4 <= 8 + 2 * R; k += 4) {
      const float4 f = *reinterpret_cast<const float4*>(src + k);
      v[k] = f.x;
      v[k + 1] = f.y;
      v[k + 2] = f.z;
      v[k + 3] = f.w;
    }
    if constexpr ((8 + 2 * R) % 4 == 2) {
      const float2 f = *reinterpret_cast<const float2*>(src + 6 + 2 * R);
      v[6 + 2 * R] = f.x;
      v[7 + 2 * R] = f.y;
    }
    window_max8<R>(v, 1, r, out);
  } else {
    window_max8<R>(src, 1, r, out);
  }
}

// R: the NMS radius at compile time (5, the path's), or -1 for r at run time
template <int R>
__global__ void __launch_bounds__(NMS_NT, 4) nms_block_kernel(
    const float* __restrict__ score, const uint8_t* __restrict__ chi,
    const uint8_t* __restrict__ clo, float* __restrict__ bs_hi,
    int* __restrict__ bi_hi, float* __restrict__ bs_lo,
    int* __restrict__ bi_lo, int* __restrict__ cnt, int H, int W, int Hb,
    int Wb, int r_rt, int border, bool aligned) {
  extern __shared__ float smem[];
  const int r = R >= 0 ? R : r_rt;
  const int RH = NMS_TH + 2 * r, CW = NMS_TW + 2 * r, SP = nms_sp(r);
  float* sc = smem;               // (RH, SP) score with an r halo
  float* hm = sc + RH * SP;       // (RH, NMS_HP) the horizontal max
  const int tid = threadIdx.x;
  const int tx = tid % NMS_TX, ty = tid / NMS_TX;
  const int n = blockIdx.z;
  const int x0 = blockIdx.x * NMS_TW, y0 = blockIdx.y * NMS_TH;
  const size_t plane = (size_t)n * H * W;
  const int x = x0 + tx;

  // stage the score tile: with a compile-time radius every load of a
  // thread is issued before its first store
  const Stage st{score + plane, (int)(plane & 3), H, W, x0, y0, r, CW,
                 (CW + 6) / 4, RH, aligned};
  if constexpr (R >= 0) {
    constexpr int ITEMS = ((NMS_TH + 2 * R) * ((NMS_TW + 2 * R + 6) / 4) +
                           NMS_NT - 1) / NMS_NT;
    float v[ITEMS][4];
    int row[ITEMS], c0[ITEMS];
#pragma unroll
    for (int u = 0; u < ITEMS; ++u)
      st.load(tid + u * NMS_NT, v[u], row[u], c0[u]);
#pragma unroll
    for (int u = 0; u < ITEMS; ++u) st.store(sc, SP, v[u], row[u], c0[u]);
  } else {
    for (int it = tid; it < RH * st.NQ; it += NMS_NT) {
      float v[4];
      int row, c0;
      st.load(it, v, row, c0);
      st.store(sc, SP, v, row, c0);
    }
  }
  __syncthreads();

  // the horizontal max: 8 outputs a task, lanes on consecutive rows
  for (int t = tid; t < RH * (NMS_TW / 8); t += NMS_NT) {
    const int row = t % RH, seg = t / RH;
    float out[8];
    row_max8<R>(sc + row * SP + 8 * seg, r, out);
    float4* d = reinterpret_cast<float4*>(hm + row * NMS_HP + 8 * seg);
    d[0] = make_float4(out[0], out[1], out[2], out[3]);
    d[1] = make_float4(out[4], out[5], out[6], out[7]);
  }
  __syncthreads();

  // the vertical max of the column's 8 rows, the keep test, the kept
  // scores (-inf beyond the image), the column's first maxima and count
  float m[8];
  window_max8<R>(hm + ty * NB * NMS_HP + tx, NMS_HP, r, m);
  float vh = -INFINITY, vl = -INFINITY;
  int qh = tx & (NB - 1), ql = qh, c = 0;
  const bool bx = x >= border && x < W - border;
#pragma unroll
  for (int k = 0; k < NB; ++k) {
    const int y = y0 + ty * NB + k;
    float h = -INFINITY, l = -INFINITY;
    if (y < H && x < W) {
      const float s = sc[(ty * NB + k + r) * SP + tx + r];
      const bool keep = s >= m[k] && bx && y >= border && y < H - border;
      const size_t p = plane + (size_t)y * W + x;
      h = keep && __ldg(chi + p) ? s : 0.0f;
      l = keep && __ldg(clo + p) ? s : 0.0f;
    }
    const int q = k * NB + (tx & (NB - 1));
    if (h > vh) {
      vh = h;
      qh = q;
    }
    if (l > vl) {
      vl = l;
      ql = q;
    }
    c += h > 0.0f;
  }
  // across the block's 8 columns: the larger value, on a tie the lower
  // index
#pragma unroll
  for (int d = 1; d < NB; d <<= 1) {
    const float oh = __shfl_xor_sync(0xffffffffu, vh, d);
    const float ol = __shfl_xor_sync(0xffffffffu, vl, d);
    const int oqh = __shfl_xor_sync(0xffffffffu, qh, d);
    const int oql = __shfl_xor_sync(0xffffffffu, ql, d);
    c += __shfl_xor_sync(0xffffffffu, c, d);
    if (oh > vh || (oh == vh && oqh < qh)) {
      vh = oh;
      qh = oqh;
    }
    if (ol > vl || (ol == vl && oql < ql)) {
      vl = ol;
      ql = oql;
    }
  }
  const int gbx = x >> 3, gby = blockIdx.y * NMS_TY + ty;
  if ((tx & (NB - 1)) == 0 && gbx < Wb && gby < Hb) {
    const size_t o = (size_t)n * Hb * Wb + (size_t)gby * Wb + gbx;
    bs_hi[o] = vh;
    bi_hi[o] = qh;
    bs_lo[o] = vl;
    bi_lo[o] = ql;
    cnt[o] = c;
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
  if (N == 0 || Hb == 0 || Wb == 0) return 0;
  const size_t smem = nms_smem(radius);
  auto kernel = radius == 5 ? nms_block_kernel<5> : nms_block_kernel<-1>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((Wb * NB + NMS_TW - 1) / NMS_TW,
                  (Hb * NB + NMS_TH - 1) / NMS_TH, N);
  kernel<<<grid, NMS_NT, smem, stream>>>(
      score, chi, clo, bs_hi, bi_hi, bs_lo, bi_lo, cnt, H, W, Hb, Wb, radius,
      border, (reinterpret_cast<uintptr_t>(score) & 15) == 0);
  return (int)cudaGetLastError();
}

}  // extern "C"
