// Kernel K: the Schur-complement local bundle adjustment (K15), five launches
// per LM step (the dense 6W x 6W solve between them is the library's), one
// for each trial cost, and one landmark index per window LBA.
//
// Replaces plslam_tpu/backend/lba.py::_point_rj (:79), _endpoint_rj (:116),
// _robust_sigma (:142), lba_cost (:150), _bin_landmark_blocks (:182) and
// _assemble_and_solve (:199) with _cap_steps (:325). The reference bins
// per-observation normal-equation blocks onto landmark slots with one-hot
// MXU contractions and forms S with einsums.
//
// Bound: at the default window (W = 10 poses, W K = 10,240 point and
// 2 W L = 2,560 endpoint observations, P = 4,096 + Q = 1,024 landmarks) the
// step moves ~10 MB (per-observation Jacobians written and read, the
// (W, P + Q, 6, 3) camera-landmark blocks written once and read by the
// Schur pass) and does ~0.2 GFLOP (the Schur pass: W^2 (P + Q) 6x3x3 +
// 6x3x6 products): a few microseconds either way. Latency dominates:
// dependent launches, each a few microseconds of work.
//
// Design, launch by launch:
//   lba_terms   one thread per observation: transform, projection,
//               (u, v, d) or point-to-line residual, Jc = dr/dxi,
//               Jp = dr/dX, validity, the residual norm; and in the same
//               launch the exact lower median of the valid |r| (a radix
//               select, its last step in the block that finishes last),
//               the MAD scale and the robust cost with the
//               lost-observation charge in a fixed-order reduction (below,
//               at terms_kernel).
//   lba_camera  one block per pose: H_cc and g_c, fixed-order reduction.
//   lba_index   once a window LBA (the observation ids do not
//               change between LM steps): one block lists each landmark
//               slot's observations in CSR form, points first, then the
//               endpoints, each list in (pose, family, k) order. Integer
//               shared-memory atomics count, one block scan gives the
//               offsets, a fill, then an insertion sort of each short list
//               by observation id: exact and deterministic.
//   lba_bin     one warp per landmark slot walks its list: its
//               lanes split the 12 + 18 entries an observation touches
//               (H_ll, g_l; H_cl of the observation's pose, written out as
//               the walk passes each pose, zeros included), every lane in
//               the list's order with the t-Student weight of each
//               observation; then the damped block's inverse (the
//               reference's scale-normalised closed-form Cholesky). No
//               float atomics: the sums do not depend on scheduling.
//   lba_schur   one block per pose pair (w, v): S[w, v] = -sum_l
//               H_cl[w,l] H_ll^-1 H_cl[v,l]^T in a fixed order, plus on the
//               diagonal H_cc, the damping of the original H_cc diagonal
//               and the support-gated pins; block (w, w) also reduces the
//               gradient.
//   lba_backsub one thread per landmark: the step from the pose steps, the
//               support floor, the trust-region caps (block 0 caps the
//               pose steps).

#include <cuda_runtime.h>
#include <float.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "radix_select.cuh"

namespace {

struct Cam {
  float fx, fy, cx, cy, fxb;
};

__device__ __forceinline__ float safe_z(float z) {
  return fabsf(z) < 1e-7f ? 1e-7f : z;
}

__device__ __forceinline__ float tstudent(float r, float sigma) {
  const float q = __fdiv_rn(r, sigma);
  return __fdiv_rn(6.0f, __fadd_rn(5.0f, __fmul_rn(q, q)));
}

// a (3) @ [I, -skew(P)] -> 6
__device__ __forceinline__ void se3_row(const float* a, const float* P,
                                        float* out) {
  out[0] = a[0];
  out[1] = a[1];
  out[2] = a[2];
  out[3] = -a[1] * P[2] + a[2] * P[1];
  out[4] = a[0] * P[2] - a[2] * P[0];
  out[5] = -a[0] * P[1] + a[1] * P[0];
}

// -- lba_terms: the terms, the MAD scale and the robust cost, one launch --
//
// The scale is sigma = max(1.4826 med, 1e-4), med the lower median of the
// valid |r| (core/robust.py:18-30): the element of rank (n - 1) / 2 among
// the n valid ones, 0 where n = 0. Every |r| is a norm or a fabsf, and a
// non-negative float orders as its bits, so med is found exactly by a
// radix select over the 31 bits below the sign: digits of 11, 10 and 10
// bits, each a histogram and a scan that picks the bucket holding the
// rank. No sort, no sentinel, no float atomics.
//   - every block adds its valid keys' top digit into a device-wide
//     histogram (shared-memory counts first, then integer atomics: exact
//     in any order) and its lost observations into a device-wide count,
//     then takes an arrival ticket after a __threadfence();
//   - the block that arrives last picks the top digit's bucket, walks the
//     terms again from L2 for the second digit (stashing the bucket's keys
//     in shared memory where they fit, else walking them again for the
//     third), then computes the cost in the fixed order of the one-block
//     kernel it replaced (its TERMS_NT threads, each a strided walk, a
//     warp butterfly, the warps' sums in order), and zeroes the histogram,
//     counts and ticket for the next launch. The scratch therefore serves
//     one launch at a time.
// That replaced kernel, a launch of its own, sorted all |r| in one block's
// shared memory (a bitonic sort, 105 passes behind barriers at 12,800
// observations, at most 32,768) to read one order statistic. Here the
// select's work is a histogram add per value in every block and two walks
// of the values from L2 in the last one (~10 operations a value), and the
// scale needs no launch and no shared-memory limit of its own. What bounds
// the launch is one SM: its last block's walks (L2's latency, then the
// cost's two IEEE divisions a value) take as long as the terms on ~100
// SMs before them (~7 us each at the default window on an NVIDIA H100
// 80GB HBM3 at 700 W, by clock stamps).
// TERMS_NT is also the replaced kernel's block, whose threads' strided
// walks fix the cost's order of summation. A block computes the terms of
// TERMS_OBS observations only: its stores are scattered (a point's 18 Jc
// floats are 72 bytes from the next one's), so the terms spread over as
// many SMs as there are, while the last block has TERMS_NT threads.
constexpr int TERMS_NT = 1024, TERMS_OBS = 128;
using radix::SEL_D1, radix::SEL_D2, radix::SEL_D3;  // 11, 10, 10 bits
using radix::SEL_SHIFT1, radix::SEL_SHIFT2;
constexpr int SEL_STASH = 4096;
constexpr int SEL_BATCH = 8;     // loads in flight a thread in the walks

struct SelScratch {              // zero between launches
  unsigned int hist[SEL_D1];
  unsigned int valid, lost, ticket;
};

using radix::key_of;

// *count += the warp's lanes that are on, one atomic a warp. Every lane of
// the warp calls it.
__device__ __forceinline__ void warp_count(unsigned int* count, bool on) {
  const unsigned int mask = __ballot_sync(0xffffffffu, on);
  if ((threadIdx.x & 31) == 0 && mask)
    atomicAdd(count, (unsigned int)__popc(mask));
}

__global__ void __launch_bounds__(TERMS_NT) terms_kernel(
    const float* __restrict__ pose, const float* __restrict__ pt_pos,
    const float* __restrict__ ep_pos, const float* __restrict__ obs_uv,
    const float* __restrict__ obs_disp, const int* __restrict__ obs_id,
    const float* __restrict__ obs_le, const int* __restrict__ sid,
    const int* __restrict__ eid, float* r_pt, float* Jc_pt, float* Jp_pt,
    uint8_t* ok_pt, float* rn, float* r_ln, float* Jc_ln, float* Jp_ln,
    uint8_t* ok_ln, float* sigma_out, float* cost_out, SelScratch* scr,
    int W, int K, int L, Cam c) {
  __shared__ unsigned int sh[SEL_D1 + SEL_STASH];
  __shared__ unsigned int s_valid, s_lost, s_scan[TERMS_NT / 32];
  __shared__ bool s_last;
  const int tid = threadIdx.x;
  const int i = tid < TERMS_OBS ? blockIdx.x * TERMS_OBS + tid : INT_MAX;
  const int NP = W * K, NL = W * L, NT = NP + 2 * NL;
  for (int b = tid; b < SEL_D1; b += TERMS_NT) sh[b] = 0;
  if (tid == 0) s_valid = s_lost = 0;
  __syncthreads();
  bool counted = false, lost = false;  // a valid |r|; a lost observation
  unsigned int key0 = 0;
  if (i < NT) {
    const bool is_pt = i < NP;
    const int j = is_pt ? i : i - NP;          // (f,) w, k or l
    const int f = is_pt ? 0 : j / NL;
    const int wl = is_pt ? j : j % NL;
    const int w = is_pt ? j / K : wl / L;
    const int id = is_pt ? obs_id[j] : (f == 0 ? sid : eid)[wl];
    const float* X = (is_pt ? pt_pos : ep_pos) + 3 * max(id, 0);
    const float* T = pose + 16 * w;
    float Pc[3];
#pragma unroll
    for (int a = 0; a < 3; ++a)
      Pc[a] = T[a * 4] * X[0] + T[a * 4 + 1] * X[1] + T[a * 4 + 2] * X[2] +
              T[a * 4 + 3];
    const bool ok = id >= 0 && Pc[2] > 0.1f;
    const float zs = safe_z(Pc[2]);
    const float u = __fadd_rn(__fdiv_rn(__fmul_rn(c.fx, Pc[0]), zs), c.cx);
    const float v = __fadd_rn(__fdiv_rn(__fmul_rn(c.fy, Pc[1]), zs), c.cy);
    const float iz = 1.0f / zs, iz2 = iz * iz;
    const float jp[2][3] = {{c.fx * iz, 0.0f, -c.fx * Pc[0] * iz2},
                            {0.0f, c.fy * iz, -c.fy * Pc[1] * iz2}};
    float a_abs;                               // |r| of the scale
    if (is_pt) {
      const float z = fmaxf(Pc[2], 1e-6f);
      const float d_obs = obs_disp[j];
      const bool has_d = d_obs > 0.0f;
      float r[3] = {__fsub_rn(u, obs_uv[2 * j]),
                    __fsub_rn(v, obs_uv[2 * j + 1]),
                    has_d ? __fsub_rn(__fdiv_rn(c.fxb, z), d_obs) : 0.0f};
      float J3[3][3] = {{jp[0][0], jp[0][1], jp[0][2]},
                        {jp[1][0], jp[1][1], jp[1][2]},
                        {0.0f, 0.0f, has_d ? -c.fxb / (z * z) : 0.0f}};
      float s = 0.0f;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        if (!ok) r[a] = 0.0f;
        r_pt[3 * j + a] = r[a];
        s = __fadd_rn(s, __fmul_rn(r[a], r[a]));
        float row[6];
        se3_row(J3[a], Pc, row);
#pragma unroll
        for (int q = 0; q < 6; ++q)
          Jc_pt[18 * j + 6 * a + q] = ok ? row[q] : 0.0f;
#pragma unroll
        for (int b = 0; b < 3; ++b)
          Jp_pt[9 * j + 3 * a + b] =
              ok ? J3[a][0] * T[b] + J3[a][1] * T[4 + b] + J3[a][2] * T[8 + b]
                 : 0.0f;
      }
      a_abs = __fsqrt_rn(__fadd_rn(s, 1e-12f));
      rn[j] = a_abs;
      ok_pt[j] = ok;
    } else {
      const float* le = obs_le + 3 * wl;
      const float r = __fadd_rn(
          __fadd_rn(__fmul_rn(le[0], u), __fmul_rn(le[1], v)), le[2]);
      const float jpix[3] = {le[0] * jp[0][0] + le[1] * jp[1][0],
                             le[0] * jp[0][1] + le[1] * jp[1][1],
                             le[0] * jp[0][2] + le[1] * jp[1][2]};
      float row[6];
      se3_row(jpix, Pc, row);
      r_ln[j] = ok ? r : 0.0f;
#pragma unroll
      for (int q = 0; q < 6; ++q) Jc_ln[6 * j + q] = ok ? row[q] : 0.0f;
#pragma unroll
      for (int b = 0; b < 3; ++b)
        Jp_ln[3 * j + b] =
            ok ? jpix[0] * T[b] + jpix[1] * T[4 + b] + jpix[2] * T[8 + b]
               : 0.0f;
      ok_ln[j] = ok;
      a_abs = fabsf(r);
    }
    counted = ok;
    lost = !ok && id >= 0;
    key0 = key_of(a_abs);
  }
  if (counted) atomicAdd(&sh[key0 >> SEL_SHIFT1], 1u);
  warp_count(&s_valid, counted);
  warp_count(&s_lost, lost);
  __syncthreads();
  for (int b = tid; b < SEL_D1; b += TERMS_NT)
    if (sh[b]) atomicAdd(&scr->hist[b], sh[b]);
  if (tid == 0) {
    atomicAdd(&scr->valid, s_valid);
    atomicAdd(&scr->lost, s_lost);
  }
  __threadfence();  // this block's terms and counts before its ticket
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(&scr->ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();

  // the last block: the lower median of the valid |r|, digit by digit.
  // Its walks read SEL_BATCH values a thread before using any: L2's
  // latency, not its bandwidth, bounds one block's walk.
  auto load = [&](int g, float* x, bool* valid) {  // no load under a branch
    const int gc = min(g, NT - 1);
    const bool pt = gc < NP;
    const uint8_t ok = __ldcg(pt ? ok_pt + gc : ok_ln + (gc - NP));
    *x = __ldcg(pt ? rn + gc : r_ln + (gc - NP));
    *valid = (g < NT) & (ok != 0);
  };
  auto walk = [&](auto&& use) {       // use(key, valid) on every lane
    for (int g0 = 0; g0 < NT; g0 += SEL_BATCH * TERMS_NT) {
      float x[SEL_BATCH];
      bool valid[SEL_BATCH];
#pragma unroll
      for (int u = 0; u < SEL_BATCH; ++u)
        load(g0 + u * TERMS_NT + tid, &x[u], &valid[u]);
#pragma unroll
      for (int u = 0; u < SEL_BATCH; ++u) use(key_of(x[u]), valid[u]);
    }
  };
  for (int b = tid; b < SEL_D1; b += TERMS_NT) sh[b] = __ldcg(&scr->hist[b]);
  const unsigned int n = __ldcg(&scr->valid);
  __syncthreads();
  float med = 0.0f;
  if (n > 0) {
    int b1, b2, b3;
    unsigned int k = (n - 1) / 2;
    radix::select_bucket<TERMS_NT, SEL_D1>(sh, k, &b1, &k, s_scan);
    // pass 2; each warp stashes its bucket-b1 keys in a region of its own
    // (its count in a register, the same in every lane), unless one
    // overflows: then pass 3 walks the terms again
    constexpr int PER_WARP = SEL_STASH / (TERMS_NT / 32);
    __shared__ unsigned int s_count[TERMS_NT / 32];
    __shared__ bool s_overflow;
    const int lane = tid & 31, warp = tid >> 5;
    unsigned int* keys = sh + SEL_D1 + warp * PER_WARP;
    unsigned int count = 0;
    __syncthreads();
    for (int b = tid; b < SEL_D2; b += TERMS_NT) sh[b] = 0;
    if (tid == 0) s_overflow = false;
    __syncthreads();
    walk([&](unsigned int key, bool valid) {
      const bool in = valid && (int)(key >> SEL_SHIFT1) == b1;
      if (in) atomicAdd(&sh[(key >> SEL_SHIFT2) & (SEL_D2 - 1)], 1u);
      const unsigned int mask = __ballot_sync(0xffffffffu, in);
      const unsigned int at = count + __popc(mask & ((1u << lane) - 1));
      if (in && at < PER_WARP) keys[at] = key;
      count += __popc(mask);
    });
    if (lane == 0) {
      s_count[warp] = count;
      if (count > PER_WARP) s_overflow = true;
    }
    __syncthreads();
    radix::select_bucket<TERMS_NT, SEL_D2>(sh, k, &b2, &k, s_scan);
    const unsigned int prefix = ((unsigned int)b1 << (SEL_SHIFT1 - SEL_SHIFT2))
                                | (unsigned int)b2;
    for (int b = tid; b < SEL_D3; b += TERMS_NT) sh[b] = 0;
    __syncthreads();
    if (!s_overflow) {
      for (int q = tid; q < SEL_STASH; q += TERMS_NT) {
        const int w = q / PER_WARP, e = q - w * PER_WARP;
        const unsigned int key =
            e < (int)s_count[w] ? sh[SEL_D1 + q] : ~0u;
        if (key >> SEL_SHIFT2 == prefix)
          atomicAdd(&sh[key & (SEL_D3 - 1)], 1u);
      }
    } else {
      walk([&](unsigned int key, bool valid) {
        if (valid && key >> SEL_SHIFT2 == prefix)
          atomicAdd(&sh[key & (SEL_D3 - 1)], 1u);
      });
    }
    __syncthreads();
    radix::select_bucket<TERMS_NT, SEL_D3>(sh, k, &b3, &k, s_scan);
    med = __uint_as_float((prefix << SEL_SHIFT2) | (unsigned int)b3);
  }
  const float sigma = fmaxf(__fmul_rn(1.4826f, med), 1e-4f);

  // the robust cost in the replaced kernel's order: thread tid sums
  // points, start and end endpoints over i = tid, tid + TERMS_NT, ...;
  // a warp butterfly; the warps' sums in order (|r| r^2 of a line: r^2,
  // the same bits)
  __shared__ float red[TERMS_NT / 32][3];
  float acc[3] = {0.0f, 0.0f, 0.0f};
  for (int i0 = 0; i0 < NT; i0 += SEL_BATCH * TERMS_NT) {
    float x[SEL_BATCH];
    bool valid[SEL_BATCH];
#pragma unroll
    for (int u = 0; u < SEL_BATCH; ++u)
      load(i0 + u * TERMS_NT + tid, &x[u], &valid[u]);
#pragma unroll
    for (int u = 0; u < SEL_BATCH; ++u) {
      const int g = i0 + u * TERMS_NT + tid;
      const float r = x[u];
      const float t = tstudent(fabsf(r), sigma);
      if (!valid[u]) continue;
      if (g < NP) acc[0] += t * (r * r);
      else if (g - NP < NL) acc[1] += t * (r * r);
      else acc[2] += t * (r * r);
    }
  }
  const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int e = 0; e < 3; ++e) {
    float x = acc[e];
    for (int s = 16; s > 0; s >>= 1) x += __shfl_xor_sync(0xffffffffu, x, s);
    if (lane == 0) red[warp][e] = x;
  }
  __syncthreads();
  if (tid == 0) {
    float tot[3] = {0.0f, 0.0f, 0.0f};
    for (int e = 0; e < 3; ++e)
      for (int w = 0; w < TERMS_NT / 32; ++w) tot[e] += red[w][e];
    const float lost = (float)__ldcg(&scr->lost);
    *sigma_out = sigma;
    *cost_out = ((tot[0] + tot[1]) + tot[2]) + (6.0f * sigma * sigma) * lost;
    scr->valid = scr->lost = scr->ticket = 0;
  }
  for (int b = tid; b < SEL_D1; b += TERMS_NT) scr->hist[b] = 0;
}

template <int NV, int NT>
__device__ void block_sum(float* acc, float (*red)[NV], float* tot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    float x = acc[v];
    for (int s = 16; s > 0; s >>= 1) x += __shfl_xor_sync(0xffffffffu, x, s);
    if (lane == 0) red[warp][v] = x;
  }
  __syncthreads();
  if (threadIdx.x < NV) {
    float x = 0.0f;
    for (int w = 0; w < NT / 32; ++w) x += red[w][threadIdx.x];
    tot[threadIdx.x] = x;
  }
  __syncthreads();
}

constexpr int CAM_NT = 256;

__global__ void __launch_bounds__(CAM_NT)
    camera_kernel(const float* __restrict__ Jc_pt, const float* __restrict__ r_pt,
                  const float* __restrict__ rn, const uint8_t* __restrict__ ok_pt,
                  const float* __restrict__ Jc_ln, const float* __restrict__ r_ln,
                  const uint8_t* __restrict__ ok_ln, const float* sigma_p,
                  const uint8_t* __restrict__ free_, float* H_cc, float* g_c,
                  int W, int K, int L) {
  __shared__ float red[CAM_NT / 32][27];
  __shared__ float tot[27];
  const int w = blockIdx.x, tid = threadIdx.x;
  const float sigma = *sigma_p;
  const bool fr = free_[w] != 0;
  float acc[27];
#pragma unroll
  for (int v = 0; v < 27; ++v) acc[v] = 0.0f;
  if (fr) {
    for (int i = tid; i < K + 2 * L; i += CAM_NT) {
      if (i < K) {
        const int j = w * K + i;
        if (!ok_pt[j]) continue;
        const float wt = tstudent(rn[j], sigma);
        for (int a = 0; a < 3; ++a) {
          const float* J = Jc_pt + 18 * j + 6 * a;
          const float r = r_pt[3 * j + a];
          int o = 0;
          for (int p = 0; p < 6; ++p)
            for (int q = p; q < 6; ++q) acc[o++] += wt * J[p] * J[q];
          for (int p = 0; p < 6; ++p) acc[21 + p] += wt * J[p] * r;
        }
      } else {
        const int f = (i - K) / L, l = (i - K) % L;
        const int j = f * W * L + w * L + l;
        if (!ok_ln[j]) continue;
        const float r = r_ln[j];
        const float wt = tstudent(fabsf(r), sigma);
        const float* J = Jc_ln + 6 * j;
        int o = 0;
        for (int p = 0; p < 6; ++p)
          for (int q = p; q < 6; ++q) acc[o++] += wt * J[p] * J[q];
        for (int p = 0; p < 6; ++p) acc[21 + p] += wt * J[p] * r;
      }
    }
  }
  block_sum<27, CAM_NT>(acc, red, tot);
  if (tid < 36) {
    int p = tid / 6, q = tid % 6;
    if (p > q) {
      const int t = p;
      p = q;
      q = t;
    }
    // index of (p, q), p <= q, in the row-major upper triangle
    const int o = p * 6 - p * (p - 1) / 2 + (q - p);
    H_cc[36 * w + tid] = tot[o];
  }
  if (tid < 6) g_c[6 * w + tid] = tot[21 + tid];
}

// the reference's closed-form inverse of a scale-normalised SPD 3 x 3
__device__ void inv3(const float* Min, float* out) {
  float s = 0.0f;
  for (int i = 0; i < 9; ++i) s = fmaxf(s, fabsf(Min[i]));
  s = fmaxf(s, 1e-30f);
  float M[9];
  for (int i = 0; i < 9; ++i) M[i] = Min[i] / s;
  const float eps = 1e-20f;
  const float a11 = M[0], a21 = M[3], a31 = M[6], a22 = M[4], a32 = M[7],
              a33 = M[8];
  const float l11 = sqrtf(fmaxf(a11, eps));
  const float l21 = a21 / l11, l31 = a31 / l11;
  const float l22 = sqrtf(fmaxf(a22 - l21 * l21, eps));
  const float l32 = (a32 - l31 * l21) / l22;
  const float l33 = sqrtf(fmaxf(a33 - l31 * l31 - l32 * l32, eps));
  const float i11 = 1.0f / l11, i22 = 1.0f / l22, i33 = 1.0f / l33;
  const float i21 = -l21 * i11 * i22, i32 = -l32 * i22 * i33;
  const float i31 = (l21 * l32 - l31 * l22) * i11 * i22 * i33;
  const float m11 = i11 * i11 + i21 * i21 + i31 * i31;
  const float m12 = i21 * i22 + i31 * i32, m13 = i31 * i33;
  const float m22 = i22 * i22 + i32 * i32, m23 = i32 * i33, m33 = i33 * i33;
  const float m[9] = {m11, m12, m13, m12, m22, m23, m13, m23, m33};
  for (int i = 0; i < 9; ++i) out[i] = m[i] / s;
}

constexpr int BIN_NT = 256;

// -- the landmark index and the binning that reads it ----------------------

constexpr int IDX_NT = 1024;

// landmark slot of observation g (points g < W K, w-major; then endpoints
// in (w, family, k) order), or -1 where it is detached
__device__ __forceinline__ int obs_slot(int g, const int* __restrict__ obs_id,
                                        const int* __restrict__ sid,
                                        const int* __restrict__ eid, int W,
                                        int K, int L, int P, int Q) {
  const int WK = W * K;
  if (g < WK) {
    const int id = obs_id[g];
    return id >= 0 && id < P ? id : -1;
  }
  const int h = g - WK, w = h / (2 * L), r = h - w * 2 * L;
  const int f = r >= L ? 1 : 0;
  const int id = (f ? eid : sid)[w * L + r - f * L];
  return id >= 0 && id < Q ? P + id : -1;
}

__global__ void __launch_bounds__(IDX_NT)
    lba_index_kernel(const int* __restrict__ obs_id,
                     const int* __restrict__ sid, const int* __restrict__ eid,
                     int* __restrict__ off, int* __restrict__ list, int W,
                     int K, int L, int P, int Q) {
  extern __shared__ int cnt[];  // P + Q counters, then fill cursors
  __shared__ int part[IDX_NT];
  const int N = P + Q, T = W * K + 2 * W * L, tid = threadIdx.x;
  for (int n = tid; n < N; n += IDX_NT) cnt[n] = 0;
  __syncthreads();
  for (int g = tid; g < T; g += IDX_NT) {
    const int s = obs_slot(g, obs_id, sid, eid, W, K, L, P, Q);
    if (s >= 0) atomicAdd(&cnt[s], 1);
  }
  __syncthreads();
  // exclusive scan: a run of slots a thread, then the runs' sums
  const int per = (N + IDX_NT - 1) / IDX_NT;
  const int lo = min(tid * per, N), hi = min(lo + per, N);
  int sum = 0;
  for (int n = lo; n < hi; ++n) sum += cnt[n];
  part[tid] = sum;
  __syncthreads();
  for (int s = 1; s < IDX_NT; s <<= 1) {
    const int v = tid >= s ? part[tid - s] : 0;
    __syncthreads();
    part[tid] += v;
    __syncthreads();
  }
  int run = part[tid] - sum;
  for (int n = lo; n < hi; ++n) {
    const int c = cnt[n];
    off[n] = run;
    cnt[n] = run;
    run += c;
  }
  const int total = part[IDX_NT - 1];
  if (tid == 0) off[N] = total;
  __syncthreads();
  for (int g = tid; g < T; g += IDX_NT) {
    const int s = obs_slot(g, obs_id, sid, eid, W, K, L, P, Q);
    if (s >= 0) list[atomicAdd(&cnt[s], 1)] = g;
  }
  for (int g = total + tid; g < T; g += IDX_NT) list[g] = -1;
  __syncthreads();
  // each list in ascending observation id (a few entries: insertion sort)
  for (int n = tid; n < N; n += IDX_NT) {
    const int b = off[n], e = cnt[n];
    for (int a = b + 1; a < e; ++a) {
      const int v = list[a];
      int c = a - 1;
      while (c >= b && list[c] > v) {
        list[c + 1] = list[c];
        --c;
      }
      list[c + 1] = v;
    }
  }
}

__global__ void __launch_bounds__(BIN_NT)
    bin_index_kernel(const int* __restrict__ off, const int* __restrict__ list,
                     const float* __restrict__ Jc_pt,
                     const float* __restrict__ Jp_pt,
                     const float* __restrict__ r_pt,
                     const float* __restrict__ rn,
                     const uint8_t* __restrict__ ok_pt,
                     const float* __restrict__ Jc_ln,
                     const float* __restrict__ Jp_ln,
                     const float* __restrict__ r_ln,
                     const uint8_t* __restrict__ ok_ln, const float* sigma_p,
                     const uint8_t* __restrict__ free_, const float* lam_p,
                     float* H_ll, float* H_inv, float* g_l, float* H_cl, int W,
                     int K, int L, int P, int Q) {
  const int n = (blockIdx.x * BIN_NT + threadIdx.x) / 32;
  const int lane = threadIdx.x & 31;
  const int N = P + Q;
  if (n >= N) return;
  const float sigma = *sigma_p;
  // a lane's entry: 0-8 H_ll (a, b), 9-11 g_l (a), 12-29 H_cl (a, c) of
  // the current pose; 30 and 31 walk along idle
  const int ha = lane / 3, hb = lane % 3, ga = lane - 9;
  const int q = lane - 12, ca = q / 3, cc = q % 3;
  const bool cl = lane >= 12 && lane < 30;
  float acc = 0.0f;
  int wcur = 0;
  const int WK = W * K, end = off[n + 1];
  for (int t = off[n]; t < end; ++t) {
    const int g = list[t];
    const bool pt = g < WK;
    int w, j;
    if (pt) {
      w = g / K;
      j = g;
    } else {
      const int h = g - WK;
      w = h / (2 * L);
      const int r = h - w * 2 * L, f = r >= L ? 1 : 0;
      j = f * W * L + w * L + r - f * L;
    }
    if (cl)
      for (; wcur < w; ++wcur) {
        H_cl[((size_t)wcur * N + n) * 18 + q] = acc;
        acc = 0.0f;
      }
    const float fr = free_[w] ? 1.0f : 0.0f;
    if (pt) {
      if (!ok_pt[j]) continue;
      const float wt = tstudent(rn[j], sigma);
      const float* Jp = Jp_pt + 9 * j;
      const float* Jc = Jc_pt + 18 * j;
      const float* r = r_pt + 3 * j;
      if (lane < 9)
        acc += wt * (Jp[ha] * Jp[hb] + Jp[3 + ha] * Jp[3 + hb] +
                     Jp[6 + ha] * Jp[6 + hb]);
      else if (lane < 12)
        acc += wt * (Jp[ga] * r[0] + Jp[3 + ga] * r[1] + Jp[6 + ga] * r[2]);
      else if (cl)
        acc += wt * fr *
               (Jc[ca] * Jp[cc] + Jc[6 + ca] * Jp[3 + cc] +
                Jc[12 + ca] * Jp[6 + cc]);
    } else {
      if (!ok_ln[j]) continue;
      const float r = r_ln[j];
      const float wt = tstudent(fabsf(r), sigma);
      const float* Jp = Jp_ln + 3 * j;
      const float* Jc = Jc_ln + 6 * j;
      if (lane < 9)
        acc += wt * Jp[ha] * Jp[hb];
      else if (lane < 12)
        acc += wt * Jp[ga] * r;
      else if (cl)
        acc += wt * fr * Jc[ca] * Jp[cc];
    }
  }
  if (cl)
    for (; wcur < W; ++wcur) {
      H_cl[((size_t)wcur * N + n) * 18 + q] = acc;
      acc = 0.0f;
    }
  float H[9];
#pragma unroll
  for (int e = 0; e < 9; ++e) H[e] = __shfl_sync(0xffffffffu, acc, e);
  if (lane < 9) H_ll[9 * n + lane] = acc;
  else if (lane < 12) g_l[3 * n + ga] = acc;
  if (lane != 0) return;
  const float lam = *lam_p;
  float Hd[9];
  for (int i = 0; i < 9; ++i) Hd[i] = H[i];
  for (int a = 0; a < 3; ++a) Hd[4 * a] += lam * fmaxf(H[4 * a], 1e-3f);
  inv3(Hd, H_inv + 9 * n);
}

constexpr int SCHUR_NT = 256;

__global__ void __launch_bounds__(SCHUR_NT)
    schur_kernel(const float* __restrict__ H_cc, const float* __restrict__ g_c,
                 const float* __restrict__ H_cl, const float* __restrict__ H_inv,
                 const float* __restrict__ g_l, const float* lam_p,
                 const uint8_t* __restrict__ free_, float* Sm, float* gm,
                 int W, int N, float pin_weight) {
  __shared__ float red[SCHUR_NT / 32][42];
  __shared__ float tot[42];
  const int w = blockIdx.y, v = blockIdx.x, tid = threadIdx.x;
  const bool diag = w == v;
  float acc[42];
#pragma unroll
  for (int q = 0; q < 42; ++q) acc[q] = 0.0f;
  for (int n = tid; n < N; n += SCHUR_NT) {
    const float* A = H_cl + ((size_t)w * N + n) * 18;
    bool any = false;
    float a[18];
    for (int q = 0; q < 18; ++q) {
      a[q] = A[q];
      any |= a[q] != 0.0f;
    }
    if (!any) continue;
    const float* Hi = H_inv + 9 * n;
    float Bm[18];  // H_cl[w, n] @ H_inv[n], 6 x 3
    for (int r = 0; r < 6; ++r)
      for (int c = 0; c < 3; ++c)
        Bm[3 * r + c] = a[3 * r] * Hi[c] + a[3 * r + 1] * Hi[3 + c] +
                        a[3 * r + 2] * Hi[6 + c];
    const float* C = H_cl + ((size_t)v * N + n) * 18;
    for (int r = 0; r < 6; ++r)
      for (int c = 0; c < 6; ++c)
        acc[6 * r + c] += Bm[3 * r] * C[3 * c] + Bm[3 * r + 1] * C[3 * c + 1] +
                          Bm[3 * r + 2] * C[3 * c + 2];
    if (diag) {
      const float* gg = g_l + 3 * n;
      for (int r = 0; r < 6; ++r)
        acc[36 + r] += Bm[3 * r] * gg[0] + Bm[3 * r + 1] * gg[1] +
                       Bm[3 * r + 2] * gg[2];
    }
  }
  block_sum<42, SCHUR_NT>(acc, red, tot);
  const int W6 = 6 * W;
  if (tid < 36) {
    const int r = tid / 6, c = tid % 6;
    float s = -tot[tid];
    if (diag) {
      const float* Hw = H_cc + 36 * w;
      s += Hw[tid];
      if (r == c) {
        const float lam = *lam_p;
        float support = 0.0f;
        for (int q = 0; q < 6; ++q) support += Hw[7 * q];
        const float pin =
            (free_[w] != 0 && support > 1.0f) ? 0.0f : pin_weight;
        s += lam * fmaxf(Hw[7 * r], 1e-3f) + 1e-6f;
        s += pin;
      }
    }
    Sm[(size_t)(6 * w + r) * W6 + 6 * v + c] = s;
  }
  if (diag && tid < 6) gm[6 * w + tid] = g_c[6 * w + tid] - tot[36 + tid];
}

__global__ void backsub_kernel(const float* __restrict__ H_cl,
                               const float* __restrict__ H_inv,
                               const float* __restrict__ g_l,
                               const float* __restrict__ H_ll,
                               const float* __restrict__ dxi, float* d_out,
                               float* dxi_out, int W, int N, int cap) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (blockIdx.x == 0 && threadIdx.x < W) {
    const float* x = dxi + 6 * threadIdx.x;
    float s = 0.0f;
    for (int q = 0; q < 6; ++q) s += x[q] * x[q];
    const float sc = cap ? fminf(1.0f, 1.0f / fmaxf(sqrtf(s), 1e-12f)) : 1.0f;
    for (int q = 0; q < 6; ++q) dxi_out[6 * threadIdx.x + q] = x[q] * sc;
  }
  if (n >= N) return;
  float rhs[3] = {g_l[3 * n], g_l[3 * n + 1], g_l[3 * n + 2]};
  for (int w = 0; w < W; ++w) {
    const float* A = H_cl + ((size_t)w * N + n) * 18;
    const float* x = dxi + 6 * w;
    for (int b = 0; b < 3; ++b)
      for (int a = 0; a < 6; ++a) rhs[b] += A[3 * a + b] * x[a];
  }
  const float* Hi = H_inv + 9 * n;
  float d[3];
  for (int a = 0; a < 3; ++a)
    d[a] = -(Hi[3 * a] * rhs[0] + Hi[3 * a + 1] * rhs[1] + Hi[3 * a + 2] * rhs[2]);
  const float* H = H_ll + 9 * n;
  const bool moves = H[0] + H[4] + H[8] > 1e-2f;
  float sc = 1.0f;
  if (cap) {
    const float nn = sqrtf(d[0] * d[0] + d[1] * d[1] + d[2] * d[2]);
    sc = fminf(1.0f, 10.0f / fmaxf(nn, 1e-12f));
  }
  for (int a = 0; a < 3; ++a) d_out[3 * n + a] = moves ? d[a] * sc : 0.0f;
}

}  // namespace

extern "C" {

// problem (kf_pose (W, 4, 4) T_cw, pt_pos (P, 3), ep_pos (Q, 3), obs_pt_uv
// (W, K, 2), obs_pt_disp (W, K), obs_pt_id (W, K), obs_ln_le (W, L, 3),
// obs_ln_sid, obs_ln_eid (W, L)) -> r_pt (W, K, 3), Jc_pt (W, K, 3, 6),
// Jp_pt (W, K, 3, 3), ok_pt (W, K) u8, rn (W, K), r_ln (2, W, L), Jc_ln
// (2, W, L, 6), Jp_ln (2, W, L, 3), ok_ln (2, W, L) u8, and sigma (the
// robust MAD scale) and the robust cost, 0-d each. scratch: a zeroed
// SelScratch (SEL_D1 + 3 words) that the launch leaves zeroed; launches
// that share one must run one after another (one stream).
int lba_terms(const float* pose, const float* pt_pos, const float* ep_pos,
              const float* obs_uv, const float* obs_disp, const int* obs_id,
              const float* obs_le, const int* sid, const int* eid,
              float* r_pt, float* Jc_pt, float* Jp_pt, uint8_t* ok_pt,
              float* rn, float* r_ln, float* Jc_ln, float* Jp_ln,
              uint8_t* ok_ln, float* sigma, float* cost, void* scratch,
              int W, int K, int L, int P, int Q, float fx, float fy,
              float cx, float cy, float fxb, cudaStream_t stream) {
  const int n = W * K + 2 * W * L;
  if (P < 1 || Q < 1 || n < 1) return (int)cudaErrorInvalidValue;
  terms_kernel<<<(n + TERMS_OBS - 1) / TERMS_OBS, TERMS_NT, 0, stream>>>(
      pose, pt_pos, ep_pos, obs_uv, obs_disp, obs_id, obs_le, sid, eid, r_pt,
      Jc_pt, Jp_pt, ok_pt, rn, r_ln, Jc_ln, Jp_ln, ok_ln, sigma, cost,
      static_cast<SelScratch*>(scratch), W, K, L, Cam{fx, fy, cx, cy, fxb});
  return (int)cudaGetLastError();
}

// -> H_cc (W, 6, 6), g_c (W, 6)
int lba_camera(const float* Jc_pt, const float* r_pt, const float* rn,
               const uint8_t* ok_pt, const float* Jc_ln, const float* r_ln,
               const uint8_t* ok_ln, const float* sigma, const uint8_t* free_,
               float* H_cc, float* g_c, int W, int K, int L,
               cudaStream_t stream) {
  camera_kernel<<<W, CAM_NT, 0, stream>>>(Jc_pt, r_pt, rn, ok_pt, Jc_ln, r_ln,
                                          ok_ln, sigma, free_, H_cc, g_c, W, K,
                                          L);
  return (int)cudaGetLastError();
}

// obs_id (W, K), sid, eid (W, L) -> off (P + Q + 1) CSR offsets and list
// (W K + 2 W L) observation ids slot by slot (points g = w K + k, then
// endpoints W K + (w 2 + family) L + k), -1 after off[P + Q].
int lba_index(const int* obs_id, const int* sid, const int* eid, int* off,
              int* list, int W, int K, int L, int P, int Q,
              cudaStream_t stream) {
  const size_t smem = sizeof(int) * (size_t)(P + Q);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        lba_index_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  lba_index_kernel<<<1, IDX_NT, smem, stream>>>(obs_id, sid, eid, off, list,
                                                W, K, L, P, Q);
  return (int)cudaGetLastError();
}

// lba_index's lists -> H_ll (N, 3, 3), H_inv (N, 3, 3) of the damped
// blocks, g_l (N, 3), H_cl (W, N, 6, 3); N = P + Q, points first.
int lba_bin(const int* off, const int* list, const float* Jc_pt,
            const float* Jp_pt, const float* r_pt, const float* rn,
            const uint8_t* ok_pt, const float* Jc_ln, const float* Jp_ln,
            const float* r_ln, const uint8_t* ok_ln, const float* sigma,
            const uint8_t* free_, const float* lam, float* H_ll, float* H_inv,
            float* g_l, float* H_cl, int W, int K, int L, int P, int Q,
            cudaStream_t stream) {
  const int warps = P + Q, per_block = BIN_NT / 32;
  bin_index_kernel<<<(warps + per_block - 1) / per_block, BIN_NT, 0,
                     stream>>>(off, list, Jc_pt, Jp_pt, r_pt, rn, ok_pt,
                               Jc_ln, Jp_ln, r_ln, ok_ln, sigma, free_, lam,
                               H_ll, H_inv, g_l, H_cl, W, K, L, P, Q);
  return (int)cudaGetLastError();
}

// -> Sm (6W, 6W), gm (6W): the damped, pinned reduced camera system.
int lba_schur(const float* H_cc, const float* g_c, const float* H_cl,
              const float* H_inv, const float* g_l, const float* lam,
              const uint8_t* free_, float* Sm, float* gm, int W, int N,
              float pin_weight, cudaStream_t stream) {
  schur_kernel<<<dim3(W, W), SCHUR_NT, 0, stream>>>(
      H_cc, g_c, H_cl, H_inv, g_l, lam, free_, Sm, gm, W, N, pin_weight);
  return (int)cudaGetLastError();
}

// dxi (W, 6) -> landmark steps d (N, 3) and dxi (W, 6), capped if cap.
int lba_backsub(const float* H_cl, const float* H_inv, const float* g_l,
                const float* H_ll, const float* dxi, float* d, float* dxi_out,
                int W, int N, int cap, cudaStream_t stream) {
  const int threads = 256;
  backsub_kernel<<<(N + threads - 1) / threads, threads, 0, stream>>>(
      H_cl, H_inv, g_l, H_ll, dxi, d, dxi_out, W, N, cap);
  return (int)cudaGetLastError();
}

}  // extern "C"
