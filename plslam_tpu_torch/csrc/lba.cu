// Kernel K: the Schur-complement local bundle adjustment (K15), four launches
// per LM step (the last two: the Schur complement with the dense 6W x 6W
// solve, and the landmark steps), one for each trial cost, and one landmark
// index per window LBA.
//
// Replaces plslam_tpu/backend/lba.py::_point_rj (:79), _endpoint_rj (:116),
// _robust_sigma (:142), lba_cost (:150), _bin_landmark_blocks (:182) and
// _assemble_and_solve (:199) with _cap_steps (:325). The reference bins
// per-observation normal-equation blocks onto landmark slots with one-hot
// MXU contractions, forms S with einsums and solves with jnp.linalg.solve.
//
// Bound: at the default window (W = 10 poses, W K = 10,240 point and
// 2 W L = 2,560 endpoint observations, P = 4,096 + Q = 1,024 landmarks) the
// step moves ~10 MB (per-observation Jacobians written and read, the
// (W, P + Q, 6, 3) camera-landmark blocks written once and read where a
// pose observes a landmark) and does a few MFLOP: a few microseconds
// either way. Latency dominates: dependent launches, each a few
// microseconds of work, and the solve's chain of 6W pivot steps.
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
//   lba_camera  a thread-block cluster of up to 8 CTAs a pose: H_cc and
//               g_c, fixed-order reductions (below, at camera_kernel).
//   lba_index   once a window LBA (the observation ids do not
//               change between LM steps): lists each landmark slot's
//               observations in CSR form, points first, then the
//               endpoints, each list in (pose, family, k) order, built in
//               shared memory with no sort (below, at lba_index_kernel):
//               exact and deterministic.
//   lba_bin     one warp per landmark slot walks its list: its
//               lanes split the 12 + 18 entries an observation touches
//               (H_ll, g_l; H_cl of the observation's pose, written out as
//               the walk passes each pose, zeros included), every lane in
//               the list's order with the t-Student weight of each
//               observation; then the damped block's inverse (the
//               reference's scale-normalised closed-form Cholesky). No
//               float atomics: the sums do not depend on scheduling.
//   lba_solve   landmark chunks sum S = H_cc - sum H_cl H_ll^-1 H_cl^T and
//               the reduced gradient over the pose pairs that observe each
//               landmark; the last block adds the chunks' partials in
//               order, damps, pins, and solves the system by LU with
//               partial pivoting in shared memory; a second launch steps
//               the landmarks (below, at schur_solve_kernel).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <float.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "radix_select.cuh"

namespace cg = cooperative_groups;

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

// -- lba_camera: the camera blocks, a thread-block cluster a pose ----------
//
// H_cc (W, 6, 6) and g_c (W, 6) are the t-Student-weighted sums of Jc^T Jc
// and Jc^T r over a free pose's valid point rows and line endpoints; a fixed
// pose gets zero blocks. Bound: bytes, ~1 MB at the default window (0.29 us
// at 3.35 TB/s). What the launch takes is latency: the one-block-a-pose
// kernel it replaced ran W = 10 CTAs on 10 SMs, each walking the pose's
// K + 2L = 1,280 observations in 5 dependent strided passes with 72-byte
// strided Jacobian loads, then one shared-memory reduction (6.8 us on an
// NVIDIA H100 80GB HBM3 at 700 W).
// Design: a cluster of C <= 8 CTAs a pose (the portable size), W x C CTAs
// (80 at the default window). ``backend/lba.py::camera_layout`` plans C, the
// slice S and the threads T; CTA rank c takes observations [c S, (c + 1) S)
// of the pose's K + 2L (points, then the start, then the end endpoints) in
// rounds of T, one a thread (one round at the default window):
//   - the round's point Jacobians, contiguous (3, 6) rows, are copied into
//     shared memory in 16-byte cp.async pieces while each thread loads its
//     own flag, residual, norm and, for an endpoint, its 6 Jacobian floats;
//   - each thread adds its observation's 21 upper-triangle and 6 gradient
//     terms; a reduce-scatter butterfly a warp (31 shuffles), then the
//     warps' sums in order, give the CTA's 27 partials, which it writes
//     into rank 0's shared memory;
//   - after one cluster barrier rank 0 adds the C partials in rank order
//     and writes the blocks.
// The order is fixed and there are no float atomics: the bits do not
// depend on scheduling, so run_lba's graph replay equals its eager loop.
// The order of the sums differs from the replaced kernel's.
constexpr int CAM_MAX_C = 8, CAM_MAX_T = 256;

struct CamArgs {
  const float* Jc_pt;
  const float* r_pt;
  const float* rn;
  const uint8_t* ok_pt;
  const float* Jc_ln;
  const float* r_ln;
  const uint8_t* ok_ln;
  const float* sigma;
  const uint8_t* free_;
  float* H_cc;
  float* g_c;
  int W, K, L, S;
};

// acc += w [J^T J upper triangle, J^T r] of one Jacobian row J (6)
__device__ __forceinline__ void cam_add(float* acc, float wt, const float* J,
                                        float r) {
  int o = 0;
#pragma unroll
  for (int p = 0; p < 6; ++p)
#pragma unroll
    for (int q = p; q < 6; ++q) acc[o++] += wt * J[p] * J[q];
#pragma unroll
  for (int p = 0; p < 6; ++p) acc[21 + p] += wt * J[p] * r;
}

// one step of a warp's reduce-scatter butterfly over 2H values: the lanes
// with bit H keep values H..2H-1 and send 0..H-1 to their partner, the
// others the reverse; value v + H (v < H) of a lane with bit H lands in
// acc[v]. After the steps 16, 8, 4, 2, 1, lane l's acc[0] is the warp's
// sum of value l.
template <int H>
__device__ __forceinline__ void scatter_step(float* acc, int lane) {
  const bool up = (lane & H) != 0;
#pragma unroll
  for (int v = 0; v < H; ++v) {
    const float send = up ? acc[v] : acc[v + H];
    const float keep = up ? acc[v + H] : acc[v];
    acc[v] = keep + __shfl_xor_sync(0xffffffffu, send, H);
  }
}

template <bool CL>
__global__ void __launch_bounds__(CAM_MAX_T) camera_kernel(CamArgs a) {
  __shared__ __align__(16) float jst[CAM_MAX_T * 18 + 4];
  __shared__ float red[CAM_MAX_T / 32][27];
  __shared__ float part[CAM_MAX_C][27];
  const int w = blockIdx.y, c = blockIdx.x, C = gridDim.x;
  const int tid = threadIdx.x, T = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  if (CL)
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  const int K = a.K, L = a.L, N = K + 2 * L;
  const int lo = min(c * a.S, N), hi = min(lo + a.S, N);
  const bool fr = a.free_[w] != 0;
  const float sigma = *a.sigma;
  const size_t total = (size_t)a.W * K * 18;
  const bool aligned = ((uintptr_t)a.Jc_pt & 15) == 0;
  float acc[32];  // 21 upper-triangle and 6 gradient sums, then padding
#pragma unroll
  for (int v = 0; v < 32; ++v) acc[v] = 0.0f;
  for (int r0 = lo; fr && r0 < hi; r0 += T) {
    const int r1 = min(r0 + T, hi), p1 = min(r1, K);
    // the round's point rows, 18 floats each, from the 16-byte piece that
    // holds the first: ``head`` floats into the buffer
    int head = 0;
    if (r0 < p1) {
      const size_t s = ((size_t)w * K + r0) * 18;
      const size_t q0 = s / 4, q1 = (((size_t)w * K + p1) * 18 + 3) / 4;
      head = (int)(s - 4 * q0);
      for (size_t q = q0 + tid; q < q1; q += T) {
        float* dst = jst + 4 * (q - q0);
        if (aligned && 4 * q + 4 <= total) {
          const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
          asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                       "l"(a.Jc_pt + 4 * q));
        } else {
          for (int k = 0; k < 4; ++k)
            if (4 * q + k < total) dst[k] = a.Jc_pt[4 * q + k];
        }
      }
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
    // this thread's observation: its flag, residual, norm, line Jacobian,
    // all loaded at once (each is read only where the flag is set)
    const int i = r0 + tid;
    bool on = false;
    float nr = 0.0f, r[3] = {0.0f, 0.0f, 0.0f}, J[6];
    if (i < r1) {
      if (i < K) {
        const size_t j = (size_t)w * K + i;
        on = a.ok_pt[j] != 0;
        nr = a.rn[j];
        for (int k = 0; k < 3; ++k) r[k] = a.r_pt[3 * j + k];
      } else {
        const int f = (i - K) / L, l = i - K - f * L;
        const size_t j = ((size_t)f * a.W + w) * L + l;
        on = a.ok_ln[j] != 0;
        r[0] = a.r_ln[j];
        nr = fabsf(r[0]);
        for (int k = 0; k < 6; ++k) J[k] = a.Jc_ln[6 * j + k];
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    if (on) {
      const float wt = tstudent(nr, sigma);
      if (i < K) {
        const float* Jp = jst + head + 18 * (i - r0);
        for (int k = 0; k < 3; ++k) cam_add(acc, wt, Jp + 6 * k, r[k]);
      } else {
        cam_add(acc, wt, J, r[0]);
      }
    }
    __syncthreads();  // the buffer is free for the next round
  }
  // the warp's sums by a reduce-scatter butterfly (scatter_step): lane l
  // ends with value l's sum, 31 shuffles for the 27 values, not 5 x 27
  scatter_step<16>(acc, lane);
  scatter_step<8>(acc, lane);
  scatter_step<4>(acc, lane);
  scatter_step<2>(acc, lane);
  scatter_step<1>(acc, lane);
  if (lane < 27) red[warp][lane] = acc[0];
  __syncthreads();
  // every CTA of the cluster runs before the first remote write
  if (CL) asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  if (tid < 27) {
    float x = 0.0f;
    for (int k = 0; k < T / 32; ++k) x += red[k][tid];
    float* row = &part[c][0];
    if (CL) row = cg::this_cluster().map_shared_rank(row, 0);
    row[tid] = x;
  }
  __syncthreads();
  if (CL) {
    // thread 0's cluster-scope fence after the CTA barrier (cumulative over
    // the CTA's remote writes), every thread's relaxed arrive, the wait
    if (tid == 0) asm volatile("fence.acq_rel.cluster;\n" ::: "memory");
    __syncwarp();
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  }
  if (c != 0) return;
  // the 36 entries of H_cc and the 6 of g_c, one a thread (in rounds of T:
  // a CTA of one warp takes two)
  for (int e = tid; e < 42; e += T) {
    if (e < 36) {
      int p = e / 6, q = e % 6;
      if (p > q) {
        const int t = p;
        p = q;
        q = t;
      }
      // index of (p, q), p <= q, in the row-major upper triangle
      const int o = p * 6 - p * (p - 1) / 2 + (q - p);
      float x = 0.0f;
      for (int k = 0; k < C; ++k) x += part[k][o];
      a.H_cc[36 * w + e] = x;
    } else {
      float x = 0.0f;
      for (int k = 0; k < C; ++k) x += part[k][21 + e - 36];
      a.g_c[6 * w + e - 36] = x;
    }
  }
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

// lba_index: a stable counting sort of the T = W K + 2 W L observation ids
// by landmark slot, over C CTAs that each own a range of S slots
// (backend/lba.py::index_layout: 20 CTAs of 256 at the path's window).
// Every CTA reads all T ids (each thread issuing its loads, 13 at the
// path's window, before their first use), counts the observations of lower
// slots (its base in the lists) and its own slots' with shared atomics,
// and keeps each owned observation's slot in shared memory as a uint16
// and its place among the thread's observations in a bit mask. A
// two-level warp-shuffle scan turns the counts into each slot's end; the
// fill then scatters each owned observation into its slot's range of a
// shared array, in whatever order the atomics take (each slot's cursor
// counting down to the slot's start). No sort follows: an observation's
// place in its list is the number of the slot's members below its id, read
// from that range (a list holds the landmark's observations: a few on the
// path), so every list comes out in observation order, and each CTA writes
// its offsets and lists once.
// Bound: latency. The ids are 51 KB at the path's window and the lists as
// much; the time is the ids' round trip and each CTA's pass over all T of
// them, four block barriers and a few shared-memory operations an owned
// observation; more CTAs shorten only the owned part.
constexpr int IDX_NT = 1024;
constexpr int IDX_UNROLL = 16;
// observation ids and slots held as uint16; a thread's observations in a
// 64-bit mask
constexpr int IDX_MAX_T = 0xFFFF;
constexpr int IDX_MAX_N = 0xFFFF;
// dynamic shared memory a CTA: (S + 1) ints and 2 T uint16s; the 227 KB a
// block may have less 1 KB for the static arrays
constexpr int IDX_MAX_SMEM = 227 * 1024 - 1024;

// h / d for 0 <= h < 2^16 and d >= 1, from inv = 1 / d in f32, corrected
// by one where the product rounds across a multiple
__device__ __forceinline__ int div_small(int h, int d, float inv) {
  int q = __float2int_rz((float)h * inv);
  q -= q * d > h;
  q += (q + 1) * d <= h;
  return q;
}

// raw id of observation g (points g < W K, w-major; then endpoints in
// (w, family, k) order); invL = 1 / L in f32
__device__ __forceinline__ int obs_raw_id(int g, const int* __restrict__ obs_id,
                                          const int* __restrict__ sid,
                                          const int* __restrict__ eid, int WK,
                                          int L, float invL) {
  if (g < WK) return __ldg(obs_id + g);
  const int h = g - WK, blk = div_small(h, L, invL);  // w 2 + family
  return __ldg((blk & 1 ? eid : sid) + (blk >> 1) * L + h - blk * L);
}

// landmark slot of observation g with raw id `id`, or -1 where detached
__device__ __forceinline__ int obs_slot(int g, int id, int WK, int P, int Q) {
  if (g < WK) return id >= 0 && id < P ? id : -1;
  return id >= 0 && id < Q ? P + id : -1;
}

__global__ void __launch_bounds__(IDX_NT)
    lba_index_kernel(const int* __restrict__ obs_id,
                     const int* __restrict__ sid, const int* __restrict__ eid,
                     int* __restrict__ off, int* __restrict__ list, int W,
                     int K, int L, int P, int Q, int S) {
  extern __shared__ int cur[];  // S + 1 counters, then the two uint16 arrays
  __shared__ int wsum[32], wbelow[32];
  const int N = P + Q, WK = W * K, T = WK + 2 * W * L;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int lo = blockIdx.x * S, ns = max(0, min(S, N - lo));
  uint16_t* slot = reinterpret_cast<uint16_t*>(cur + S + 1);
  uint16_t* mem = slot + T;
  for (int j = tid; j <= ns; j += IDX_NT) cur[j] = 0;
  __syncthreads();
  // the slots: the ids of a batch loaded before their first use; the
  // thread's observations g = tid + j IDX_NT, its owned ones the bits j of
  // `own`
  const float invL = L > 0 ? 1.f / (float)L : 0.f;
  int below = 0;
  unsigned long long own = 0ull;
  for (int j0 = 0; j0 * IDX_NT < T; j0 += IDX_UNROLL) {
    int id[IDX_UNROLL];
#pragma unroll
    for (int u = 0; u < IDX_UNROLL; ++u) {
      const int g = tid + (j0 + u) * IDX_NT;
      id[u] = g < T ? obs_raw_id(g, obs_id, sid, eid, WK, L, invL) : -1;
    }
#pragma unroll
    for (int u = 0; u < IDX_UNROLL; ++u) {
      const int g = tid + (j0 + u) * IDX_NT;
      const int s = g < T ? obs_slot(g, id[u], WK, P, Q) : -1;
      if (s >= 0 && s < lo) ++below;
      if (s >= lo && s < lo + ns) {
        slot[g] = s - lo;
        atomicAdd(&cur[s - lo], 1);
        own |= 1ull << (j0 + u);
      }
    }
  }
  __syncthreads();
  // each slot's end (inclusive scan): a run of slots a thread, the runs'
  // sums scanned by warp shuffles, the warps' totals by warp 0
  const int per = (ns + IDX_NT - 1) / IDX_NT;
  const int r0 = min(tid * per, ns), r1 = min(r0 + per, ns);
  int sum = 0;
  for (int n = r0; n < r1; ++n) sum += cur[n];
  int inc = sum;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, inc, d);
    if (lane >= d) inc += v;
  }
  below = __reduce_add_sync(0xffffffffu, below);
  if (lane == 31) wsum[warp] = inc;
  if (lane == 0) wbelow[warp] = below;
  __syncthreads();
  if (warp == 0) {
    const int t = wsum[lane];
    int x = t;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, x, d);
      if (lane >= d) x += v;
    }
    wsum[lane] = x - t;  // the warps before this one
    wbelow[lane] = __reduce_add_sync(0xffffffffu, wbelow[lane]);
  }
  __syncthreads();
  int end = wsum[warp] + inc - sum;
  for (int n = r0; n < r1; ++n) {
    end += cur[n];
    cur[n] = end;
  }
  const int base = wbelow[0];
  if (tid == IDX_NT - 1) cur[ns] = wsum[warp] + inc;  // the CTA's total
  __syncthreads();
  // the fill: each owned observation into its slot's range, the slot's
  // cursor counting down from its end to its start
  for (unsigned long long m = own; m; m &= m - 1) {
    const int g = tid + (__ffsll((long long)m) - 1) * IDX_NT;
    mem[atomicSub(&cur[slot[g]], 1) - 1] = g;
  }
  __syncthreads();
  // each owned observation's place: the members of its slot below it
  for (unsigned long long m = own; m; m &= m - 1) {
    const int g = tid + (__ffsll((long long)m) - 1) * IDX_NT;
    const int j = slot[g], b = cur[j], e = cur[j + 1];
    int r = 0;
    for (int i = b; i < e; ++i) r += mem[i] < g;
    list[base + b + r] = g;
  }
  for (int j = tid; j < ns; j += IDX_NT) off[lo + j] = base + cur[j];
  if (blockIdx.x == gridDim.x - 1) {
    const int n_att = base + cur[ns];
    if (tid == 0) off[N] = n_att;
    for (int g = n_att + tid; g < T; g += IDX_NT) list[g] = -1;
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

// -- lba_solve: the Schur complement, the damped solve and the landmark
//    steps of one LM step ---------------------------------------------------
//
// H_cl[w, n] is zero unless pose w is free and observes landmark n (lba_bin
// writes Jc masked by free), so a landmark adds to S only over the pose
// pairs that observe it: ~2.5 poses a landmark at the path's shapes against
// the W = 10 a dense pass walks. Blocks take SOLVE_CH landmarks each:
//   - the observing free poses of each landmark from lba_index's lists (a
//     bit mask; integer shared atomics, exact), and the block's touched
//     pose pairs w <= v;
//   - each landmark's H_inv as L D L^T (ldl_factor, float64), and the
//     observed blocks C = H_cl[w, n] row by row (predicated on the masks,
//     4 rows a thread in flight) into shared memory as E = C L, float64;
//   - a warp a touched pair (or a run of the chunk's landmarks of one, when
//     there are fewer pairs than warps; the runs then added in order) sums
//     B_wn C_vn^T = E_w D E_v^T, B = C H_inv[n], and on a diagonal pair
//     B_wn g_l[n] = E_w z, over the landmarks that observe both poses in
//     order, a lane an entry, and writes the chunk's partials of the pairs
//     it touched to the scratch, with the pair mask and each landmark's
//     pose mask;
//   - the block that takes the last ticket adds each pair's partials over
//     the chunks that touched it in chunk order (a warp a pair), damps the
//     ORIGINAL H_cc diagonal and pins as the plain version does, and solves
//     the system in shared memory: LU with partial pivoting of the free
//     poses' block augmented by its right-hand side (getrf's and getrs's
//     operations; a zero pivot gives non-finite steps, which the LM
//     rejects), one barrier a column, then the triangular solve in one
//     warp. The other poses' rows and columns are zero off the diagonal
//     (no H_cl) and their steps masked, so the full LU would leave the free
//     rows as they are. The ticket is reset there; nothing else in the
//     scratch is read before it is written.
//   - a second launch, one thread a landmark, steps every landmark from the
//     poses in its mask (the support floor and the caps).
// The landmarks' products (B C^T and B g_l from the float32 blocks, through
// H_inv's L D L^T factors, ldl_factor) and their sums, and S's factoring
// and solve, are in float64: the endpoint steps amplify the error of dxi
// by their blocks' condition (one scalar residual an observation). With
// the sums and the LU in float32 a window's endpoint steps landed further
// from float64 than K15's band around the plain version's distance allows,
// and with the products alone in float32 the SLAM path's ill-conditioned
// final window's did. H_inv is symmetric (lba_bin and the plain inv3 write
// one value for each pair of mirrored entries); its lower triangle is read.
// Inputs and outputs stay float32. No float atomics: two launches give the
// same bits. The owner-sharded step's two entries (lba_schur_corr,
// lba_solve_reduced) are kernels of their own, below, at schur_corr_kernel.
//
// Bound: the bytes of the blocks it must read (H_cl's observed blocks,
// H_inv, g_l, H_ll, H_cc, g_c) and the products B C^T over the observed
// pose pairs, a few microseconds. The LU is a chain of 6F pivot steps (F
// free poses) that no roofline covers, and on an H100 it takes the
// longest: a step's chain in warp 0 (loads, two warp reductions, a
// shuffle, a reciprocal) and its barrier cost more than the column's work.

constexpr int SOLVE_NT = 512;
constexpr int SOLVE_CH = 64;        // landmarks a block
constexpr int SOLVE_MAX_W = 16;     // the 6W x (6W + 1) system in shared memory
constexpr int SOLVE_PAIRS = SOLVE_MAX_W * (SOLVE_MAX_W + 1) / 2;
constexpr int SOLVE_PW = (SOLVE_PAIRS + 31) / 32;   // words of a pair mask
constexpr int SOLVE_SLOT = 42;      // a pair's partial: S_wv (36), g_w (6)
constexpr int SOLVE_HEAD = 4 + 12 * SOLVE_MAX_W;    // ticket, pad, the step
constexpr int STEP_NT = 256;

// the scratch, in 32-bit words: a ticket (zero between launches), the
// masked uncapped pose step (W, 6, float64), each landmark's pose mask (N),
// each chunk's pair mask (G, SOLVE_PW) and partials (G, pairs, SOLVE_SLOT,
// float64)
struct SolveScratch {
  unsigned int* ticket;
  double* dxi;
  unsigned int* lm_mask;
  unsigned int* pm;
  double* part;
};

__host__ __device__ inline SolveScratch solve_scratch(unsigned int* s, int N,
                                                     int G) {
  SolveScratch r;
  r.ticket = s;
  r.dxi = reinterpret_cast<double*>(s + 4);
  r.lm_mask = s + SOLVE_HEAD;
  r.pm = r.lm_mask + N;
  // 8-byte aligned: N + G * SOLVE_PW rounded up to even words
  r.part = reinterpret_cast<double*>(
      r.pm + (((size_t)G * SOLVE_PW + N) & 1 ? (size_t)G * SOLVE_PW + 1
                                             : (size_t)G * SOLVE_PW));
  return r;
}

// 1 / x to a few ulps of float64 (the hardware's approximation and two
// Newton steps): a correctly rounded reciprocal takes several times as
// long, on the LU's chain of pivots. 0, inf and NaN give inf or NaN.
__device__ __forceinline__ double rcp64(double x) {
  double r;
  asm("rcp.approx.ftz.f64 %0, %1;" : "=d"(r) : "d"(x));
  r = fma(r, fma(-x, r, 1.0), r);
  return fma(r, fma(-x, r, 1.0), r);
}

__host__ __device__ inline int pair_index(int w, int v, int W) {
  return w * W - w * (w - 1) / 2 + (v - w);      // w <= v, row-major
}

// landmark n's step from the pose step x (6W, shared) over the poses in m:
// d = -H_inv (g_l + sum_w H_cl[w, n]^T x_w), zero under the support floor,
// capped at 10 m
__device__ __forceinline__ void landmark_step(
    int n, unsigned int m, const double* x, const float* __restrict__ H_cl,
    const float* __restrict__ H_inv, const float* __restrict__ g_l,
    const float* __restrict__ H_ll, float* d_out, int N, int cap) {
  double rhs[3] = {g_l[3 * n], g_l[3 * n + 1], g_l[3 * n + 2]};
  for (; m; m &= m - 1) {
    const int w = __ffs(m) - 1;
    const float* A = H_cl + ((size_t)w * N + n) * 18;
    const double* xw = x + 6 * w;
#pragma unroll
    for (int b = 0; b < 3; ++b)
#pragma unroll
      for (int a = 0; a < 6; ++a) rhs[b] += (double)A[3 * a + b] * xw[a];
  }
  const float* Hi = H_inv + 9 * n;
  float d[3];
#pragma unroll
  for (int a = 0; a < 3; ++a)
    d[a] = (float)-(Hi[3 * a] * rhs[0] + Hi[3 * a + 1] * rhs[1] +
                    Hi[3 * a + 2] * rhs[2]);
  const float* H = H_ll + 9 * n;
  const bool moves = H[0] + H[4] + H[8] > 1e-2f;
  float sc = 1.0f;
  if (cap) {
    const float nn = sqrtf(d[0] * d[0] + d[1] * d[1] + d[2] * d[2]);
    sc = fminf(1.0f, 10.0f / fmaxf(nn, 1e-12f));
  }
#pragma unroll
  for (int a = 0; a < 3; ++a) d_out[3 * n + a] = moves ? d[a] * sc : 0.0f;
}

// A landmark's symmetric H_inv (float32, row-major 3 x 3) as L D L^T in
// float64, L unit lower triangular: f = (l21, l31, l32, d1, d2, d3); and
// z = D L^T g. Then C H_inv C'^T = E D E'^T and C H_inv g = E z with
// E = C L: B = C H_inv's products in float64 from E, whose storage is that
// of C and B in float32.
__device__ __forceinline__ void ldl_factor(const float* __restrict__ h,
                                           const float* __restrict__ g,
                                           double* f, double* z) {
  const double h21 = h[3], h31 = h[6];
  const double d1 = h[0], l21 = h21 / d1, l31 = h31 / d1;
  const double d2 = h[4] - l21 * h21;
  const double l32 = (h[7] - l31 * h21) / d2;
  const double d3 = h[8] - l31 * h31 - l32 * l32 * d2;
  f[0] = l21;
  f[1] = l31;
  f[2] = l32;
  f[3] = d1;
  f[4] = d2;
  f[5] = d3;
  const double g0 = g[0], g1 = g[1], g2 = g[2];
  z[0] = d1 * (g0 + l21 * g1 + l31 * g2);
  z[1] = d2 * (g1 + l32 * g2);
  z[2] = d3 * g2;
}

// a D b^T for the rows a, b (3) and the diagonal d (3)
__device__ __forceinline__ double ldl_dot(const double* a, const double* d,
                                          const double* b) {
  return a[0] * d[0] * b[0] + a[1] * d[1] * b[1] + a[2] * d[2] * b[2];
}

__global__ void __launch_bounds__(SOLVE_NT, 1) schur_solve_kernel(
    const int* __restrict__ off, const int* __restrict__ list,
    const float* __restrict__ H_cc, const float* __restrict__ g_c,
    const float* __restrict__ H_inv, const float* __restrict__ g_l,
    const float* __restrict__ H_cl, const float* lam_p,
    const uint8_t* __restrict__ free_, float* dxi_out,
    unsigned int* scratch, int W, int K, int L, int N, float pin_weight,
    int cap) {
  extern __shared__ float dyn[];
  __shared__ unsigned int s_mask[SOLVE_CH], s_pm[SOLVE_PW];
  __shared__ int s_off[SOLVE_CH + 1], s_pstart[SOLVE_CH + 1];
  __shared__ unsigned char s_pw[SOLVE_PAIRS], s_pv[SOLVE_PAIRS],
      s_plist[SOLVE_PAIRS], s_poses[SOLVE_MAX_W], s_free[SOLVE_MAX_W];
  __shared__ int s_npl, s_npose, s_rank[SOLVE_MAX_W];
  __shared__ int s_step[6 * SOLVE_MAX_W], s_row[6 * SOLVE_MAX_W];
  __shared__ double s_x[6 * SOLVE_MAX_W];
  __shared__ double s_seg[SOLVE_NT / 32][SOLVE_SLOT];
  __shared__ bool s_last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  constexpr int NWARP = SOLVE_NT / 32;
  const unsigned int FULL = 0xffffffffu;
  const int G = gridDim.x, NPAIR = W * (W + 1) / 2;
  const int n0 = blockIdx.x * SOLVE_CH, nch = min(SOLVE_CH, N - n0);
  const SolveScratch scr = solve_scratch(scratch, N, G);
  // E = C L of the observed blocks C = H_cl[w, n]; each landmark's
  // H_inv = L D L^T (l21, l31, l32, D) and z = D L^T g_l
  double* sE = reinterpret_cast<double*>(dyn);
  double* sLD = sE + SOLVE_CH * W * 18;
  double* sz = sLD + SOLVE_CH * 6;

  // 1. each landmark's factors; its observing free poses, the chunk's
  // poses and pairs
  if (tid < nch) ldl_factor(H_inv + 9 * (n0 + tid), g_l + 3 * (n0 + tid),
                            sLD + 6 * tid, sz + 3 * tid);
  if (tid <= nch) s_off[tid] = off[n0 + tid];
  if (tid < W) s_free[tid] = free_[tid];
  if (tid < SOLVE_CH) s_mask[tid] = 0;
  if (tid < SOLVE_PW) s_pm[tid] = 0;
  for (int p = tid; p < NPAIR; p += SOLVE_NT) {
    int w = 0, r = p;
    while (r >= W - w) r -= W - w++;
    s_pw[p] = (unsigned char)w;
    s_pv[p] = (unsigned char)(w + r);
  }
  __syncthreads();
  const int WK = W * K;
  for (int e = s_off[0] + tid; e < s_off[nch]; e += SOLVE_NT) {
    const int g = list[e];
    const int w = g < WK ? g / K : (g - WK) / (2 * L);
    if (!s_free[w]) continue;
    int lo = 0, hi = nch;            // the last t with s_off[t] <= e
    while (hi - lo > 1) {
      const int mid = (lo + hi) >> 1;
      if (s_off[mid] <= e) lo = mid;
      else hi = mid;
    }
    atomicOr(&s_mask[lo], 1u << w);
  }
  __syncthreads();
  if (warp == 0) {   // pair offsets (a scan of the counts), the chunk's poses
    const unsigned int m0 = 2 * lane < nch ? s_mask[2 * lane] : 0u;
    const unsigned int m1 = 2 * lane + 1 < nch ? s_mask[2 * lane + 1] : 0u;
    const int c0 = __popc(m0), c1 = __popc(m1);
    int x = c0 + c1;
#pragma unroll
    for (int s = 1; s < 32; s <<= 1) {
      const int y = __shfl_up_sync(FULL, x, s);
      if (lane >= s) x += y;
    }
    s_pstart[2 * lane] = x - c0 - c1;
    s_pstart[2 * lane + 1] = x - c1;
    if (lane == 31) s_pstart[SOLVE_CH] = x;
    const unsigned int um = __reduce_or_sync(FULL, m0 | m1);
    if (lane == 0) s_npose = __popc(um);
    if (lane < W && ((um >> lane) & 1u))
      s_poses[__popc(um & ((1u << lane) - 1u))] = (unsigned char)lane;
  } else if (tid - 32 < nch) {
    const int t = tid - 32;
    const unsigned int m = s_mask[t];
    scr.lm_mask[n0 + t] = m;
    for (unsigned int mw = m; mw; mw &= mw - 1) {
      const int w = __ffs(mw) - 1;
      for (unsigned int mv = mw; mv; mv &= mv - 1) {
        const int p = pair_index(w, __ffs(mv) - 1, W);
        atomicOr(&s_pm[p >> 5], 1u << (p & 31));
      }
    }
  }
  __syncthreads();

  // 2. the rows of the observed blocks C = H_cl[w, n] of the chunk's poses
  // (4 rows a thread in flight) and their E = C L in float64; the touched
  // pairs' list
  const int per = nch * 6, total = s_npose * per;
  for (int i0 = tid; i0 < total; i0 += 4 * SOLVE_NT) {
    float v[4][3];
    int dst[4], lm[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u * SOLVE_NT;
      dst[u] = -1;
      lm[u] = 0;
      if (i < total) {
        const int jj = i / per, r = i - jj * per, t = r / 6;
        const int j = s_poses[jj];
        const unsigned int m = s_mask[t];
        if ((m >> j) & 1u) {
          const int q = s_pstart[t] + __popc(m & ((1u << j) - 1u));
          const float* row = H_cl + ((size_t)j * N + n0) * 18 + 3 * r;
          for (int k = 0; k < 3; ++k) v[u][k] = row[k];
          dst[u] = q * 18 + 3 * (r - 6 * t);
          lm[u] = t;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (dst[u] >= 0) {
        const double* f = sLD + 6 * lm[u];
        double* e = sE + dst[u];
        e[0] = v[u][0] + v[u][1] * f[0] + v[u][2] * f[1];
        e[1] = v[u][1] + v[u][2] * f[2];
        e[2] = v[u][2];
      }
  }
  if (warp == 0) {
    const unsigned int bits = lane < SOLVE_PW ? s_pm[lane] : 0u;
    const int c = __popc(bits);
    int x = c;
#pragma unroll
    for (int s = 1; s < 8; s <<= 1) {
      const int y = __shfl_up_sync(FULL, x, s);
      if (lane >= s) x += y;
    }
    int at = x - c;
    for (unsigned int b = bits; b; b &= b - 1)
      s_plist[at++] = (unsigned char)(32 * lane + __ffs(b) - 1);
    if (lane == SOLVE_PW - 1) s_npl = x;
  }
  __syncthreads();

  // 3. the chunk's partials: a warp sums a touched pair's S_wv[e / 6][e % 6]
  // (lane e < 36) and, on a diagonal pair, g_w[lane] (lanes 0-5; slot
  // entries 36-41) over the chunk's landmarks in order. With fewer pairs
  // than warps, each pair's landmarks are cut into nseg runs, a warp each,
  // whose sums are then added in run order.
  double* part = scr.part + (size_t)blockIdx.x * NPAIR * SOLVE_SLOT;
  const int npl = s_npl, nseg = npl > 0 && npl < NWARP ? NWARP / npl : 1;
  for (int k = warp; k < npl * nseg; k += NWARP) {
    const int pi = k / nseg, sg = k - pi * nseg;
    const int p = s_plist[pi], w = s_pw[p], v = s_pv[p];
    const int e1 = lane + 32;                 // the lane's second entry
    const int r0 = lane / 6, c0 = lane - 6 * r0;
    const int r1 = e1 < 36 ? e1 / 6 : 0, c1 = e1 < 36 ? e1 - 6 * r1 : 0;
    const int rg = w == v && lane < 6 ? lane : 0;
    double a0 = 0.0, a1 = 0.0, ag = 0.0;
    // the landmarks the pair observes (a branch the whole warp takes):
    // B_wn C_vn^T = E_w D E_v^T and B_wn g_l = E_w z, in float64
    for (int t = sg * nch / nseg; t < (sg + 1) * nch / nseg; ++t) {
      const unsigned int m = s_mask[t];
      if (!((m >> w) & (m >> v) & 1u)) continue;
      const int base = s_pstart[t];
      const double* Ew = sE + (base + __popc(m & ((1u << w) - 1u))) * 18;
      const double* Ev = sE + (base + __popc(m & ((1u << v) - 1u))) * 18;
      const double* d = sLD + 6 * t + 3;
      const double* z = sz + 3 * t;
      a0 += ldl_dot(Ew + 3 * r0, d, Ev + 3 * c0);
      a1 += ldl_dot(Ew + 3 * r1, d, Ev + 3 * c1);
      ag += Ew[3 * rg] * z[0] + Ew[3 * rg + 1] * z[1] + Ew[3 * rg + 2] * z[2];
    }
    double* slot = nseg > 1 ? s_seg[k] : part + p * SOLVE_SLOT;
    slot[lane] = a0;
    if (e1 < 36) slot[e1] = a1;
    if (w == v && lane < 6) slot[36 + lane] = ag;
  }
  if (nseg > 1) {
    __syncthreads();
    for (int i = tid; i < npl * SOLVE_SLOT; i += SOLVE_NT) {
      const int pi = i / SOLVE_SLOT, e = i - pi * SOLVE_SLOT;
      const int p = s_plist[pi];
      if (e >= 36 && s_pw[p] != s_pv[p]) continue;
      double acc = 0.0;
      for (int sg = 0; sg < nseg; ++sg) acc += s_seg[pi * nseg + sg][e];
      part[p * SOLVE_SLOT + e] = acc;
    }
  }
  if (tid < SOLVE_PW) scr.pm[blockIdx.x * SOLVE_PW + tid] = s_pm[tid];
  __threadfence();                   // partials and masks before the ticket
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(scr.ticket, 1u) == (unsigned int)G - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();

  // 4. the last block: each pair's partials over the chunks that touched
  // it, in chunk order (a warp a pair, a lane an entry, 8 loads in
  // flight), into S (both triangles) and the reduced gradient (the last
  // column). A pose that is not free has no H_cl, so its rows and columns
  // of S are zero off its diagonal and its step is masked to 0: the
  // system is the free poses' alone, nf = 6 x their number (rank[w]:
  // pose w's place among them).
  if (tid == 0) *scr.ticket = 0;
  if (warp == 0) {
    const unsigned int fm =
        __ballot_sync(FULL, lane < W && s_free[lane] != 0);
    if (lane < W)
      s_rank[lane] = s_free[lane] ? __popc(fm & ((1u << lane) - 1u)) : -1;
  }
  const int n6 = 6 * W;
  double* A = reinterpret_cast<double*>(dyn);
  unsigned int* spm = reinterpret_cast<unsigned int*>(A + n6 * (n6 + 1));
  for (int i = tid; i < G * SOLVE_PW; i += SOLVE_NT)
    spm[i] = __ldcg(scr.pm + i);
  __syncthreads();
  int nfree = 0;
  for (int w = 0; w < W; ++w) nfree += s_free[w] != 0;
  const int nf = 6 * nfree, LD = nf + 1;
  const float lam = *lam_p;
  for (int p = warp; p < NPAIR; p += NWARP) {
    const int w = s_pw[p], v = s_pv[p], word = p >> 5;
    if (s_rank[w] < 0 || s_rank[v] < 0) continue;
    const int fw = 6 * s_rank[w], fv = 6 * s_rank[v];
    const unsigned int bit = 1u << (p & 31);
    double acc0 = 0.0, acc1 = 0.0;
    for (int b0 = 0; b0 < G; b0 += 32) {
      unsigned int tm = __ballot_sync(
          FULL, b0 + lane < G && (spm[(b0 + lane) * SOLVE_PW + word] & bit));
      while (tm) {
        double x0[8], x1[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          x0[u] = x1[u] = 0.0;
          if (tm) {
            const double* src =
                scr.part + ((size_t)(b0 + __ffs(tm) - 1) * NPAIR + p) * SOLVE_SLOT;
            tm &= tm - 1;
            x0[u] = __ldcg(src + lane);
            if (lane < SOLVE_SLOT - 32) x1[u] = __ldcg(src + 32 + lane);
          }
        }
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          acc0 += x0[u];
          acc1 += x1[u];
        }
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int e = lane + 32 * h;
      const double acc = h ? acc1 : acc0;
      if (e >= SOLVE_SLOT || (e >= 36 && w != v)) continue;
      if (e >= 36) {
        A[(fw + e - 36) * LD + nf] = (double)g_c[6 * w + e - 36] - acc;
        continue;
      }
      const int r = e / 6, c = e - 6 * r;
      double s = -acc;
      if (w == v) {
        const float* Hw = H_cc + 36 * w;
        s += Hw[e];
        if (r == c) {
          float support = 0.0f;
          for (int q = 0; q < 6; ++q) support += Hw[7 * q];
          const float pin =
              (s_free[w] != 0 && support > 1.0f) ? 0.0f : pin_weight;
          s += lam * fmaxf(Hw[7 * r], 1e-3f) + 1e-6f;
          s += pin;
        }
      } else {
        A[(fv + c) * LD + fw + r] = s;
      }
      A[(fw + r) * LD + fv + c] = s;
    }
  }
  __syncthreads();

  // 5. LU with partial pivoting of [S | g] (getrf's and getrs's
  // operations: the reference's jnp.linalg.solve), one barrier a column.
  // s_step[s]: the column at which storage row s became a pivot row
  // (INT_MAX: not yet); s_row[k]: the pivot row of column k. Warp 0 holds
  // its rows s = lane + 32 m (m < 3) of the next column in registers: it
  // updates them with the last column's multipliers, picks the pivot (the
  // largest |a|, the lowest row on ties, NaN wins: two warp reductions on
  // the bits of |a|) and writes the new multipliers, while the other warps
  // update the columns right of it. A zero pivot gives non-finite steps,
  // which the LM rejects.
  if (tid < nf) s_step[tid] = INT_MAX;
  __syncthreads();
  unsigned int act = 0;              // warp 0: its rows not yet pivot rows
  double lm[3] = {0.0, 0.0, 0.0};    // warp 0: their multipliers
  int prow = -1;                     // warp 0: the last pivot row
#pragma unroll
  for (int m = 0; m < 3; ++m)
    if (lane + 32 * m < nf) act |= 1u << m;
  auto column = [&](int c) {         // warp 0: the pivot of column c
    const double u = prow >= 0 ? A[prow * LD + c] : 0.0;
    double cv[3];
    unsigned int best = 0;
    int brow = INT_MAX;
#pragma unroll
    for (int m = 0; m < 3; ++m) {
      cv[m] = 0.0;
      if ((act >> m) & 1u) {
        cv[m] = A[(lane + 32 * m) * LD + c];
        if (prow >= 0) cv[m] -= lm[m] * u;
        // |a|'s high word orders as |a| does (to 2^-20 of it)
        const unsigned int key = (unsigned int)__double2hiint(fabs(cv[m]));
        if (brow == INT_MAX || key > best) {
          best = key;
          brow = lane + 32 * m;
        }
      }
    }
    const unsigned int mx = __reduce_max_sync(FULL, best);
    const unsigned int row = __reduce_min_sync(
        FULL, best == mx ? (unsigned int)brow : 0xffffffffu);
    const int mr = row >> 5, owner = row & 31;
    const double pv = __shfl_sync(
        FULL, mr == 0 ? cv[0] : (mr == 1 ? cv[1] : cv[2]), owner);
    if (lane == owner) {
      act &= ~(1u << mr);
      A[row * LD + c] = pv;
    }
    const double inv = rcp64(pv);
#pragma unroll
    for (int m = 0; m < 3; ++m)
      if ((act >> m) & 1u) {
        lm[m] = cv[m] * inv;
        A[(lane + 32 * m) * LD + c] = lm[m];
      }
    if (lane == 0) {
      s_step[row] = c;
      s_row[c] = (int)row;
    }
    prow = (int)row;
  };
  const int o = tid - 32, ncg = nf > 0 ? (SOLVE_NT - 32) / nf : 1;
  const int my_row = o >= 0 && nf > 0 ? o % nf : 0;
  const int my_cg = o >= 0 && nf > 0 ? o / nf : ncg;
  if (warp == 0 && nf > 0) column(0);
  __syncthreads();
  for (int k = 0; k < nf; ++k) {
    if (warp == 0) {
      if (k + 1 < nf) column(k + 1);
    } else if (my_cg < ncg && s_step[my_row] > k) {
      // columns k + 2 .. nf (the right-hand side last) of a row not yet a
      // pivot row, 4 at a time (loads first); s_step of the row warp 0
      // marks now stays > k
      double* Ar = A + my_row * LD;
      const double* U = A + s_row[k] * LD;
      const double l = Ar[k];
      for (int j0 = k + 2 + my_cg; j0 <= nf; j0 += 4 * ncg) {
        double uv[4], av[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int j = j0 + q * ncg;
          uv[q] = j <= nf ? U[j] : 0.0;
          av[q] = j <= nf ? Ar[j] : 0.0;
        }
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (j0 + q * ncg <= nf) Ar[j0 + q * ncg] = av[q] - l * uv[q];
      }
    }
    __syncthreads();
  }

  // 6. U x = y in warp 0 (a lane: the logical rows lane + 32 m; the next
  // column's entries loaded a step ahead), then dxi = where(free, -x, 0)
  // and the pose cap
  if (warp == 0) {
    double y[3], rd[3], un[3];
    int rr[3];
#pragma unroll
    for (int m = 0; m < 3; ++m) {
      const int i = lane + 32 * m;
      rr[m] = i < nf ? s_row[i] : 0;
      y[m] = i < nf ? A[rr[m] * LD + nf] : 0.0;
      rd[m] = i < nf ? 1.0 / A[rr[m] * LD + i] : 0.0;
      un[m] = i < nf ? A[rr[m] * LD + nf - 1] : 0.0;
    }
    for (int k = nf - 1; k >= 0; --k) {
      const int mk = k >> 5, owner = k & 31;
      double uc[3];
#pragma unroll
      for (int m = 0; m < 3; ++m) {
        uc[m] = un[m];
        un[m] = k > 0 ? A[rr[m] * LD + k - 1] : 0.0;
      }
      const double xk = __shfl_sync(
          FULL, (mk == 0 ? y[0] : (mk == 1 ? y[1] : y[2])) *
                    (mk == 0 ? rd[0] : (mk == 1 ? rd[1] : rd[2])),
          owner);
      if (lane == owner) s_x[k] = xk;
#pragma unroll
      for (int m = 0; m < 3; ++m)
        if (lane + 32 * m < k) y[m] -= uc[m] * xk;
    }
    __syncwarp();
    if (lane < W) {
      float x6[6], s = 0.0f;
      const bool fr = s_free[lane] != 0;
#pragma unroll
      for (int a = 0; a < 6; ++a) {
        x6[a] = fr ? (float)-s_x[6 * s_rank[lane] + a] : 0.0f;
        s += x6[a] * x6[a];
      }
      const float sc = cap ? fminf(1.0f, 1.0f / fmaxf(sqrtf(s), 1e-12f)) : 1.0f;
#pragma unroll
      for (int a = 0; a < 6; ++a) {
        dxi_out[6 * lane + a] = x6[a] * sc;
        scr.dxi[6 * lane + a] = fr ? -s_x[6 * s_rank[lane] + a] : 0.0;
      }
    }
  }
}

__global__ void __launch_bounds__(STEP_NT) landmark_step_kernel(
    const unsigned int* __restrict__ scratch, const float* __restrict__ H_cl,
    const float* __restrict__ H_inv, const float* __restrict__ g_l,
    const float* __restrict__ H_ll, float* d_out, int W, int N, int cap) {
  __shared__ double x[6 * SOLVE_MAX_W];
  const SolveScratch scr =
      solve_scratch(const_cast<unsigned int*>(scratch), N, 1);
  if ((int)threadIdx.x < 6 * W) x[threadIdx.x] = scr.dxi[threadIdx.x];
  __syncthreads();
  const int n = blockIdx.x * STEP_NT + threadIdx.x;
  if (n < N)
    landmark_step(n, scr.lm_mask[n], x, H_cl, H_inv, g_l, H_ll, d_out, N,
                  cap);
}

// -- the owner-sharded step: lba_schur_corr and lba_solve_reduced ----------
//
// Replace plslam_tpu/parallel/dist_lba.py::_owner_shard_step_local's Schur
// correction and g_corr before their psum (:293-300), and its damped and
// pinned reduced system, jnp.linalg.solve and back-substitution (:304-326).
// The owner-sharded window LBA splits lba_solve's step around the
// collective: each shard sums its landmarks' corrections (lba_schur_corr),
// the collective adds the shards' sums, and every shard solves the one
// reduced system and steps its own landmarks (lba_solve_reduced). A shard's
// two launches share its scratch: the first leaves each landmark's pose
// mask there for the second, and no other launch may use it in between.
//
// Bound: bytes, tens of KB at a shard of the path's window (~7e-5 ms at
// 3.35 TB/s). What takes the time is latency: dependent loads, barriers and
// the factorization's chain of block steps.
//
// schur_corr_kernel, one launch of a thread-block cluster of C <= 16 CTAs
// (backend/lba.py::schur_corr_layout plans C, the chunk CH and the chunks a
// CTA, per): CTA c takes the chunks [c per, (c + 1) per) in chunk order and,
// chunk by chunk, does what lba_solve's blocks do (the landmarks' masks,
// E = C L in float64 into sE[pose][landmark], the touched pairs; here the
// factors' loads overlap the masks' and E's the pair bits), but keeps its
// pairs' float64 sums in its own shared memory across its chunks. Each
// touched pair gets the list of the chunk's landmarks that observe both its
// poses, in order; the lists are cut into pieces of about equal length, a
// warp a piece, whose 5 groups of 6 lanes (a lane a row of S_wv) take every
// fifth landmark of the piece; the groups' sums are added in group order
// and a pair's pieces in piece order. After one cluster barrier each CTA
// adds its slice of the (pair, entry) sums over the CTAs in rank order
// through distributed shared memory and writes corr (W, W, 6, 6; both
// triangles) and g_corr (W, 6) in float32: zero where a pose is not free,
// since no landmark adds to such a pair. No global partials, no ticket, no
// last block; no float atomics and a fixed order: two launches give the
// same bits.
//
// solve_reduced_kernel, one launch of a cluster of 1 + S CTAs (S <= 7
// stepping CTAs, a landmark a thread and round). CTA 0 assembles S and g
// from the all-reduced H_cc, g_c, corr and g_corr over the F free poses
// (lba_solve's damping, floor and pins) and factors S = L D L^T by 6 x 6
// pose blocks in float64 (D block diagonal, L unit block lower triangular),
// the gradient carried as one more block row, so the forward substitution
// comes with the factorization. Block step k:
//   - warps 1-15 form the panel, L_ik = A_ik D_k^-1 for i > k (a thread an
//     entry), written transposed above the diagonal, and z_k = D_k^-1 y_k,
//     then, after a barrier of their own, update the trailing blocks and
//     the gradient row, A_ij -= L_ik A_jk^T (a thread a row's run);
//   - meanwhile warp 0 forms D_k+1 from its own L_k+1,k and inverts it (a
//     look-ahead) by the symmetric sweep: Gauss-Jordan with no pivoting, a
//     lane an entry of the lower triangle, in registers (sweep_inverse;
//     an inverse of D_k's 3 x 3 blocks by cofactors, two reciprocals and
//     six levels of small dot products, took longer on the card). S is
//     symmetric and positive definite in exact arithmetic (the Schur
//     complement of the damped Gauss-Newton Hessian, plus 1e-6 I and the
//     pins), and so is each D_k.
// One barrier of the CTA a block step, F + 1 in all, where lba_solve's LU
// takes 6F column steps behind barriers. Then warp 0 solves L^T x = z by
// blocks, writes the masked and capped pose step and pushes the uncapped
// one into every stepping CTA's shared memory before a cluster barrier. A
// D_k that is not positive definite (an S made indefinite by the float32
// collective) meets a pivot that is not positive, which is made NaN, and
// NaN then fills the step, which the LM rejects, as the LU's zero pivot
// did. Meanwhile each stepping CTA has loaded its first round of
// landmarks' inputs (the pose mask lba_schur_corr left, g_l, H_inv,
// whether it moves, the blocks of its first two poses); after the barrier
// it takes landmark_step's arithmetic from them.
constexpr int CORR_NT = 512;
constexpr int CORR_MAX_C = 16;      // CTAs a cluster (past 8: non-portable)
constexpr int CORR_MAX_CH = 128;    // landmarks a chunk
constexpr int CORR_MAX_SMEM = 227 * 1024 - 16 * 1024;   // dynamic, a CTA
constexpr int RED_NT = 512;
constexpr int RED_MAX_S = 7;        // stepping CTAs: a portable cluster
constexpr int RED_AS = 6;           // S's entries a thread, loads first
constexpr int ATTR_DEVICES = 64;

// a schur_corr_kernel CTA's dynamic shared bytes: its pairs' sums and the
// receive buffer of its slice of the cluster's, a chunk's E, L D L^T
// factors and z (float64), each pair's landmark bits and landmark list
__host__ __device__ inline size_t corr_smem(int W, int CH) {
  const size_t np = (size_t)W * (W + 1) / 2;
  return sizeof(double) * (2 * np * SOLVE_SLOT + CORR_MAX_C +
                           (size_t)CH * W * 18 + (size_t)CH * 9) +
         sizeof(unsigned int) * np * (CH / 32) + np * CH;
}

// After a CTA barrier: thread 0's cluster-scope fence (cumulative over the
// CTA's writes the barrier ordered before it), every thread's relaxed
// arrive, the aligned wait (pose_graph.cu's cluster_arrive_wait)
__device__ __forceinline__ void cluster_sync_all() {
  if (threadIdx.x == 0) asm volatile("fence.acq_rel.cluster;\n" ::: "memory");
  __syncwarp();
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

struct CorrArgs {
  const int* off;
  const int* list;
  const float* H_inv;
  const float* g_l;
  const float* H_cl;
  const uint8_t* free_;
  float* corr;
  float* g_corr;
  unsigned int* lm_mask;
  int W, K, L, N, CH, per;
};

__global__ void __launch_bounds__(CORR_NT, 1) schur_corr_kernel(CorrArgs a) {
  constexpr int NWARP = CORR_NT / 32;
  extern __shared__ double cdyn[];
  __shared__ unsigned int s_mask[CORR_MAX_CH], s_pm[SOLVE_PW];
  __shared__ int s_off[CORR_MAX_CH + 1];
  __shared__ unsigned char s_pw[SOLVE_PAIRS], s_pv[SOLVE_PAIRS],
      s_plist[SOLVE_PAIRS], s_free[SOLVE_MAX_W];
  __shared__ int s_npl, s_items, s_split;
  // the pieces of the pairs' landmark runs: pair (its place in s_plist),
  // first landmark, landmarks; each split pair's first piece
  __shared__ unsigned char s_ipair[2 * NWARP];
  __shared__ short s_it0[2 * NWARP], s_icnt[2 * NWARP];
  __shared__ int s_first[NWARP + 1];
  __shared__ double s_part[2 * NWARP][SOLVE_SLOT];
  const unsigned int FULL = 0xffffffffu;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int W = a.W, N = a.N, CH = a.CH, CW = CH / 32;
  const int NPAIR = W * (W + 1) / 2, G = (N + CH - 1) / CH;
  const int rank = blockIdx.x, C = gridDim.x;
  // the cluster barrier's first phase: this CTA runs
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  double* sums = cdyn;                          // NPAIR x SOLVE_SLOT
  double* rb = sums + NPAIR * SOLVE_SLOT;       // the receive buffer
  double* sE = rb + NPAIR * SOLVE_SLOT + CORR_MAX_C;   // (W, CH, 18)
  double* sLD = sE + CH * W * 18;               // CH x 6
  double* sz = sLD + CH * 6;                    // CH x 3
  unsigned int* s_lm = reinterpret_cast<unsigned int*>(sz + CH * 3);
  unsigned char* s_list =                       // NPAIR x CH
      reinterpret_cast<unsigned char*>(s_lm + NPAIR * CW);
  if (tid < W) s_free[tid] = a.free_[tid];
  for (int p = tid; p < NPAIR; p += CORR_NT) {
    int w = 0, r = p;
    while (r >= W - w) r -= W - w++;
    s_pw[p] = (unsigned char)w;
    s_pv[p] = (unsigned char)(w + r);
  }
  for (int i = tid; i < NPAIR * SOLVE_SLOT; i += CORR_NT) sums[i] = 0.0;
  const int WK = W * a.K;
  const int q1 = min((rank + 1) * a.per, G);
  for (int q = rank * a.per; q < q1; ++q) {
    const int n0 = q * CH, nch = min(CH, N - n0);
    __syncthreads();                 // the last chunk's reads are done
    // 1. the chunk's offsets; the masks cleared
    if (tid <= nch) s_off[tid] = a.off[n0 + tid];
    if (tid < CH) s_mask[tid] = 0;
    if (tid < SOLVE_PW) s_pm[tid] = 0;
    for (int i = tid; i < NPAIR * CW; i += CORR_NT) s_lm[i] = 0;
    __syncthreads();
    // 2. each landmark's observing free poses; and (threads t < nch, their
    // loads in flight with the lists') each landmark's factors, lba_solve's
    if (tid < nch)
      ldl_factor(a.H_inv + 9 * (n0 + tid), a.g_l + 3 * (n0 + tid),
                 sLD + 6 * tid, sz + 3 * tid);
    for (int e = s_off[0] + tid; e < s_off[nch]; e += CORR_NT) {
      const int g = a.list[e];
      const int w = g < WK ? g / a.K : (g - WK) / (2 * a.L);
      if (!s_free[w]) continue;
      int lo = 0, hi = nch;          // the last t with s_off[t] <= e
      while (hi - lo > 1) {
        const int mid = (lo + hi) >> 1;
        if (s_off[mid] <= e) lo = mid;
        else hi = mid;
      }
      atomicOr(&s_mask[lo], 1u << w);
    }
    __syncthreads();
    // 3. warps 0-1: each landmark's mask out, its pairs' landmark bits and
    // the touched pairs; warps 2-15: E = C L of each observed block C =
    // H_cl[w, n] into sE[w][t], a thread the k-th observing pose of a
    // landmark (k = i / nch, t = i % nch), two in flight, 18 floats loaded
    // at once
    if (warp < 2) {
      for (int t = tid; t < nch; t += 64) {
        const unsigned int m = s_mask[t];
        a.lm_mask[n0 + t] = m;
        for (unsigned int mw = m; mw; mw &= mw - 1) {
          const int w = __ffs(mw) - 1;
          for (unsigned int mv = mw; mv; mv &= mv - 1) {
            const int p = pair_index(w, __ffs(mv) - 1, W);
            atomicOr(&s_pm[p >> 5], 1u << (p & 31));
            atomicOr(&s_lm[p * CW + (t >> 5)], 1u << (t & 31));
          }
        }
      }
    } else {
      constexpr int NE = CORR_NT - 64;
      for (int i0 = tid - 64; i0 < W * nch; i0 += 2 * NE) {
        float v[2][18];
        int dst[2], lm[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int i = i0 + u * NE;
          dst[u] = -1;
          lm[u] = 0;
          if (i < W * nch) {
            const int k = i / nch, t = i - k * nch;
            unsigned int m = s_mask[t];
            for (int c = 0; c < k && m; ++c) m &= m - 1;
            if (m) {
              const int j = __ffs(m) - 1;
              const float2* row = reinterpret_cast<const float2*>(
                  a.H_cl + ((size_t)j * N + n0 + t) * 18);
#pragma unroll
              for (int q = 0; q < 9; ++q) {
                const float2 x = row[q];
                v[u][2 * q] = x.x;
                v[u][2 * q + 1] = x.y;
              }
              dst[u] = (j * CH + t) * 18;
              lm[u] = t;
            }
          }
        }
#pragma unroll
        for (int u = 0; u < 2; ++u)
          if (dst[u] >= 0) {
            const double* f = sLD + 6 * lm[u];
            double* e = sE + dst[u];
#pragma unroll
            for (int r = 0; r < 6; ++r) {
              const float* c = v[u] + 3 * r;
              e[3 * r] = c[0] + c[1] * f[0] + c[2] * f[1];
              e[3 * r + 1] = c[1] + c[2] * f[2];
              e[3 * r + 2] = c[2];
            }
          }
      }
    }
    __syncthreads();
    // 4. warp 0: the touched pairs, and their landmark runs cut into pieces
    // of about equal length (a pair a piece where there are at least as many
    // pairs as warps); warps 1-4: each pair's landmarks in order, s_list[p
    // CH + rank] (rank: the landmark's place among the pair's bits)
    if (warp == 0) {
      int npl = 0;                   // the touched pairs in order, by ballots
      for (int p0 = 0; p0 < NPAIR; p0 += 32) {
        const int p = p0 + lane;
        const bool on = p < NPAIR && ((s_pm[p >> 5] >> (p & 31)) & 1u);
        const unsigned int bal = __ballot_sync(FULL, on);
        if (on) s_plist[npl + __popc(bal & ((1u << lane) - 1u))] =
            (unsigned char)p;
        npl += __popc(bal);
      }
      __syncwarp();
      const bool split = npl > 0 && npl < NWARP;
      int cnt = 0;
      if (split && lane < npl)
        for (int wd = 0; wd < CW; ++wd)
          cnt += __popc(s_lm[s_plist[lane] * CW + wd]);
      const int total = __reduce_add_sync(FULL, cnt);
      const int len = split ? (total + NWARP - 1) / NWARP : 0;
      const int np = split && lane < npl ? (cnt + len - 1) / len : 0;
      int f = np;                    // each pair's first piece: a scan
#pragma unroll
      for (int s = 1; s < 32; s <<= 1) {
        const int y = __shfl_up_sync(FULL, f, s);
        if (lane >= s) f += y;
      }
      const int pieces = __shfl_sync(FULL, f, 31);
      if (split) {
        if (lane <= npl) s_first[lane] = f - np;
        for (int k = 0; k < np; ++k) {
          s_ipair[f - np + k] = (unsigned char)lane;
          s_it0[f - np + k] = (short)(k * len);
          s_icnt[f - np + k] = (short)min(len, cnt - k * len);
        }
      }
      if (lane == 0) {
        s_npl = npl;
        s_split = split;
        s_items = split ? pieces : npl;
      }
    } else if (warp <= 4) {
      for (int t = tid - 32; t < nch; t += 128) {
        const unsigned int m = s_mask[t], low = (1u << (t & 31)) - 1u;
        for (unsigned int mw = m; mw; mw &= mw - 1) {
          const int w = __ffs(mw) - 1;
          for (unsigned int mv = mw; mv; mv &= mv - 1) {
            const int p = pair_index(w, __ffs(mv) - 1, W);
            const unsigned int* lb = s_lm + p * CW;
            int r = __popc(lb[t >> 5] & low);
            for (int wd = 0; wd < (t >> 5); ++wd) r += __popc(lb[wd]);
            s_list[p * CH + r] = (unsigned char)t;
          }
        }
      }
    }
    __syncthreads();
    // 5. the pieces: a warp a piece, ranks [r0, r0 + n) of a pair's
    // landmark list. Lane l < 30 is row r = l % 6 of group l / 6 of 5; group
    // g takes the piece's landmarks g, g + 5, ... in order and sums row r of
    // B_wn C_vn^T = E_w D E_v^T and, on a diagonal pair, B_wn g_l[r] =
    // (E_w z)[r], in float64. The groups' sums are added in group order, a
    // pair's pieces in piece order.
    const int items = s_items, split = s_split, npl = s_npl;
    const int grp = lane / 6, row = lane - 6 * grp;   // lanes 30, 31: none
    for (int k = warp; k < items; k += NWARP) {
      const int pi = split ? s_ipair[k] : k;
      const int p = s_plist[pi], w = s_pw[p], v = s_pv[p];
      int r0 = 0, n = 0;
      if (split) {
        r0 = s_it0[k];
        n = s_icnt[k];
      } else {
        for (int wd = 0; wd < CW; ++wd) n += __popc(s_lm[p * CW + wd]);
      }
      const unsigned char* list = s_list + p * CH + r0;
      double acc[7] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
      for (int j = grp; grp < 5 && j < n; j += 5) {
        const int t = list[j];
        const double* Ew = sE + (w * CH + t) * 18 + 3 * row;
        const double* Ev = sE + (v * CH + t) * 18;   // 16-byte aligned
        const double* d = sLD + 6 * t + 3;
        const double* z = sz + 3 * t;
        const double e0 = Ew[0], e1 = Ew[1], e2 = Ew[2];
        const double f0 = e0 * d[0], f1 = e1 * d[1], f2 = e2 * d[2];
#pragma unroll
        for (int c = 0; c < 6; c += 2) {  // rows c, c + 1: 16 + 8 + 8 + 16 B
          const double2 p = *reinterpret_cast<const double2*>(Ev + 3 * c);
          const double q = Ev[3 * c + 2], s = Ev[3 * c + 3];
          const double2 u = *reinterpret_cast<const double2*>(Ev + 3 * c + 4);
          acc[c] += f0 * p.x + f1 * p.y + f2 * q;
          acc[c + 1] += f0 * s + f1 * u.x + f2 * u.y;
        }
        acc[6] += e0 * z[0] + e1 * z[1] + e2 * z[2];
      }
#pragma unroll
      for (int c = 0; c < 7; ++c) {  // group 0's lanes: the 5 groups' sums
        double s = acc[c];
#pragma unroll
        for (int g = 1; g < 5; ++g) s += __shfl_sync(FULL, acc[c], 6 * g + row);
        acc[c] = s;
      }
      if (lane < 6) {
        double* slot = split ? s_part[k] : sums + p * SOLVE_SLOT;
#pragma unroll
        for (int c = 0; c < 6; ++c) {
          if (split) slot[6 * row + c] = acc[c];
          else slot[6 * row + c] += acc[c];
        }
        if (w == v) {
          if (split) slot[36 + row] = acc[6];
          else slot[36 + row] += acc[6];
        }
      }
    }
    if (split) {
      __syncthreads();
      for (int i = tid; i < npl * SOLVE_SLOT; i += CORR_NT) {
        const int pi = i / SOLVE_SLOT, e = i - pi * SOLVE_SLOT;
        const int p = s_plist[pi];
        if (e >= 36 && s_pw[p] != s_pv[p]) continue;
        double acc = 0.0;
        for (int k = s_first[pi]; k < s_first[pi + 1]; ++k)
          acc += s_part[k][e];
        sums[p * SOLVE_SLOT + e] += acc;
      }
    }
  }
  // 6. every CTA runs (the first phase, arrived at the start): each CTA
  // sends its sums to their owners, slices of sl = ceil(M / C) (pair,
  // entry) sums, into the owner's receive buffer at its rank; after the
  // second phase each CTA adds its slice's C sums in rank order and writes
  // them out
  __syncthreads();
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  cg::cluster_group cl = cg::this_cluster();
  const int M = NPAIR * SOLVE_SLOT, sl = (M + C - 1) / C;
  for (int i = tid; i < M; i += CORR_NT) {
    const int r = i / sl;
    cl.map_shared_rank(rb, r)[rank * sl + i - r * sl] = sums[i];
  }
  __syncthreads();
  cluster_sync_all();
  const int lo = rank * sl, hi = min(lo + sl, M);
  for (int i = lo + tid; i < hi; i += CORR_NT) {
    const int p = i / SOLVE_SLOT, e = i - p * SOLVE_SLOT;
    const int w = s_pw[p], v = s_pv[p];
    if (e >= 36 && w != v) continue;
    double acc = 0.0;
    for (int k = 0; k < C; ++k) acc += rb[k * sl + i - lo];
    const float f = (float)acc;
    if (e >= 36) {
      a.g_corr[6 * w + e - 36] = f;
      continue;
    }
    const int r = e / 6, c = e - 6 * r;
    a.corr[((size_t)w * W + v) * 36 + e] = f;
    if (w != v) a.corr[((size_t)v * W + w) * 36 + 6 * c + r] = f;
  }
}

struct RedArgs {
  const float* H_cc;
  const float* g_c;
  const float* corr;
  const float* g_corr;
  const float* H_ll;
  const float* H_inv;
  const float* g_l;
  const float* H_cl;
  const float* lam;
  const uint8_t* free_;
  float* dxi;
  float* d;
  const unsigned int* lm_mask;
  int W, N;
  float pin_weight;
  int cap;
};

// landmark n's inputs to landmark_step that do not depend on the pose step:
// its pose mask, g_l, H_inv, whether it moves, its first two poses' blocks
struct LmIn {
  unsigned int m;
  float g[3], Hi[9], A[2][18];
  bool moves;
};

__device__ __forceinline__ void lm_load(int n, const RedArgs& a, LmIn& in) {
  in.m = a.lm_mask[n];
#pragma unroll
  for (int b = 0; b < 3; ++b) in.g[b] = a.g_l[3 * n + b];
#pragma unroll
  for (int i = 0; i < 9; ++i) in.Hi[i] = a.H_inv[9 * n + i];
  const float* H = a.H_ll + 9 * (size_t)n;
  in.moves = H[0] + H[4] + H[8] > 1e-2f;
  unsigned int m = in.m;
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int w = m ? __ffs(m) - 1 : 0;
    const float* A = a.H_cl + ((size_t)w * a.N + n) * 18;
#pragma unroll
    for (int i = 0; i < 18; ++i) in.A[s][i] = m ? A[i] : 0.0f;
    m &= m - 1;
  }
}

// landmark_step's arithmetic from lm_load's inputs and the pose step x
__device__ __forceinline__ void lm_finish(int n, const LmIn& in,
                                          const double* x, const RedArgs& a) {
  double rhs[3] = {in.g[0], in.g[1], in.g[2]};
  unsigned int m = in.m;
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    if (!m) break;
    const double* xw = x + 6 * (__ffs(m) - 1);
    m &= m - 1;
#pragma unroll
    for (int b = 0; b < 3; ++b)
#pragma unroll
      for (int j = 0; j < 6; ++j) rhs[b] += (double)in.A[s][3 * j + b] * xw[j];
  }
  for (; m; m &= m - 1) {
    const int w = __ffs(m) - 1;
    const float* A = a.H_cl + ((size_t)w * a.N + n) * 18;
    const double* xw = x + 6 * w;
#pragma unroll
    for (int b = 0; b < 3; ++b)
#pragma unroll
      for (int j = 0; j < 6; ++j) rhs[b] += (double)A[3 * j + b] * xw[j];
  }
  float d[3];
#pragma unroll
  for (int j = 0; j < 3; ++j)
    d[j] = (float)-(in.Hi[3 * j] * rhs[0] + in.Hi[3 * j + 1] * rhs[1] +
                    in.Hi[3 * j + 2] * rhs[2]);
  float sc = 1.0f;
  if (a.cap) {
    const float nn = sqrtf(d[0] * d[0] + d[1] * d[1] + d[2] * d[2]);
    sc = fminf(1.0f, 10.0f / fmaxf(nn, 1e-12f));
  }
#pragma unroll
  for (int j = 0; j < 3; ++j) a.d[3 * n + j] = in.moves ? d[j] * sc : 0.0f;
}

// the place of the i-th set bit (i from 0) of m
__device__ __forceinline__ int nth_bit(unsigned int m, int i) {
  for (; i > 0; --i) m &= m - 1;
  return __ffs(m) - 1;
}

// warp 0: lane l < 21 holds v, entry (ra, cb), ra >= cb, l = ra (ra + 1) / 2
// + cb, of a symmetric 6 x 6 block D; the symmetric sweep on each index in
// turn (Gauss-Jordan with no pivoting) leaves -D^-1 there, and Q (6 x 6,
// both triangles) gets D^-1. D is positive definite iff every pivot is
// positive; a pivot that is not is made NaN, and NaN then fills Q.
__device__ __forceinline__ void sweep_inverse(double v, int ra, int cb,
                                              int lane, double* Q) {
  const unsigned int FULL = 0xffffffffu;
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    const int la = ra >= k ? ra * (ra + 1) / 2 + k : k * (k + 1) / 2 + ra;
    const int lb = cb >= k ? cb * (cb + 1) / 2 + k : k * (k + 1) / 2 + cb;
    double p = __shfl_sync(FULL, v, k * (k + 1) / 2 + k);
    const double vak = __shfl_sync(FULL, v, la);
    const double vbk = __shfl_sync(FULL, v, lb);
    if (!(p > 0.0)) p = __longlong_as_double(0x7ff8000000000000LL);
    double inv;                      // 1 / p to ~2^-40: one Newton step
    asm("rcp.approx.ftz.f64 %0, %1;" : "=d"(inv) : "d"(p));
    inv = fma(inv, fma(-p, inv, 1.0), inv);
    if (ra == k && cb == k) v = -inv;
    else if (ra == k || cb == k) v *= inv;
    else v = fma(-vak * inv, vbk, v);
  }
  if (lane < 21) {
    Q[6 * ra + cb] = -v;
    Q[6 * cb + ra] = -v;
  }
}

__global__ void __launch_bounds__(RED_NT, 1) solve_reduced_kernel(RedArgs a) {
  extern __shared__ double rdyn[];
  __shared__ double s_step[6 * SOLVE_MAX_W], s_Q[2][36],
      s_z[6 * SOLVE_MAX_W], s_x[6 * SOLVE_MAX_W];
  const unsigned int FULL = 0xffffffffu;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int W = a.W, N = a.N, rank = blockIdx.x, C = gridDim.x;
  // the cluster barrier's first phase: this CTA runs
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  if (rank > 0) {
    // a stepping CTA: its first round's inputs while CTA 0 solves, then the
    // step CTA 0 pushed here
    const int stride = (C - 1) * RED_NT;
    int n = (rank - 1) * RED_NT + tid;
    LmIn in;
    if (n < N) lm_load(n, a, in);
    __syncwarp();
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
    if (n < N) lm_finish(n, in, s_step, a);
    for (n += stride; n < N; n += stride)
      landmark_step(n, a.lm_mask[n], s_step, a.H_cl, a.H_inv, a.g_l, a.H_ll,
                    a.d, N, a.cap);
    return;
  }
  // 1. the free poses, a bit each: every warp's own ballot, no barrier
  const unsigned int fm = __ballot_sync(FULL, lane < W && a.free_[lane] != 0);
  // A, (nf + 1) x LD: S's lower blocks, L^T's blocks above them as the
  // factorization writes them, the gradient's row nf
  const int F = __popc(fm), nf = 6 * F, LD = nf + 1;
  double* A = rdyn;
  const float lam = *a.lam;
  // 2. S and g (lba_solve's arithmetic, corr's entry for the chunks' sum):
  // a thread an entry of a free pair's block (i <= j, pf = j (j + 1) / 2 +
  // i: the lower triangle of the diagonal blocks, the blocks below them),
  // or of a free pose's gradient, RED_AS entries at a time, their loads
  // first. Each entry of S is the mean of the inputs' two mirrored ones:
  // the same where H_cc and corr are symmetric, as lba_camera and
  // lba_schur_corr write them; S's symmetric part where they are not.
  const int items = F * (F + 1) / 2 * SOLVE_SLOT;
  for (int i0 = tid; i0 < items; i0 += RED_AS * RED_NT) {
    float x[RED_AS][4], support[RED_AS];
    int dst[RED_AS], kind[RED_AS];
#pragma unroll
    for (int u = 0; u < RED_AS; ++u) {
      const int it = i0 + u * RED_NT;
      kind[u] = 0;     // 0 none, 1 gradient, 2 S, 3 a diagonal block's,
                       // 4 on the diagonal
      if (it >= items) continue;
      const int pf = it / SOLVE_SLOT, e = it - pf * SOLVE_SLOT;
      int j = (int)((sqrtf(8.0f * pf + 1.0f) - 1.0f) * 0.5f);
      while ((j + 1) * (j + 2) / 2 <= pf) ++j;
      while (j * (j + 1) / 2 > pf) --j;
      const int i = pf - j * (j + 1) / 2;
      const int w = nth_bit(fm, i), v = nth_bit(fm, j);
      if (e >= 36) {
        if (i != j) continue;
        kind[u] = 1;
        dst[u] = nf * LD + 6 * i + e - 36;
        x[u][0] = a.g_c[6 * w + e - 36];
        x[u][1] = a.g_corr[6 * w + e - 36];
        continue;
      }
      const int rr = e / 6, cc = e - 6 * rr;
      if (i == j && rr < cc) continue;
      x[u][0] = a.corr[((size_t)w * W + v) * 36 + e];
      x[u][1] = a.corr[((size_t)v * W + w) * 36 + 6 * cc + rr];
      if (i == j) {
        kind[u] = rr == cc ? 4 : 3;
        x[u][2] = a.H_cc[36 * w + e];
        x[u][3] = a.H_cc[36 * w + 6 * cc + rr];
        dst[u] = (6 * i + rr) * LD + 6 * i + cc;
        support[u] = 0.0f;           // the trace of H_cc[w], lba_solve's order
        if (rr == cc)
          for (int q = 0; q < 6; ++q) support[u] += a.H_cc[36 * w + 7 * q];
      } else {
        kind[u] = 2;
        dst[u] = (6 * j + cc) * LD + 6 * i + rr;   // block (j, i), below
      }
    }
#pragma unroll
    for (int u = 0; u < RED_AS; ++u) {
      if (kind[u] == 0) continue;
      if (kind[u] == 1) {
        A[dst[u]] = (double)x[u][0] - (double)x[u][1];
        continue;
      }
      double s = -0.5 * ((double)x[u][0] + (double)x[u][1]);
      if (kind[u] >= 3) {
        s += 0.5 * ((double)x[u][2] + (double)x[u][3]);
        if (kind[u] == 4) {
          const float pin = support[u] > 1.0f ? 0.0f : a.pin_weight;
          s += lam * fmaxf(x[u][2], 1e-3f) + 1e-6f;
          s += pin;
        }
      }
      A[dst[u]] = s;
    }
  }
  __syncthreads();
  // 3. the block L D L^T. Warp 0 inverts the diagonal blocks (lanes 0-20
  // each an entry (ra, cb) of a block's lower triangle; sweep_inverse) a
  // block ahead:
  // while warps 1-15 form step k's panel and, after a barrier of their
  // own, its trailing update, warp 0 forms D_k+1 = A_k+1,k+1 - L_k+1,k
  // A_k+1,k^T from its own L_k+1,k and inverts it into the other half of
  // s_Q; one barrier of the whole CTA a step.
  int ra = 0;
  if (lane < 21)
    while ((ra + 1) * (ra + 2) / 2 <= lane) ++ra;
  const int cb = lane < 21 ? lane - ra * (ra + 1) / 2 : 0;
  if (F > 0 && warp == 0)
    sweep_inverse(lane < 21 ? A[ra * LD + cb] : 0.0, ra, cb, lane, s_Q[0]);
  __syncthreads();
  for (int k = 0; k < F; ++k) {
    const int b = 6 * (k + 1), nt = nf - b;   // the trailing rows
    const double* Q = s_Q[k & 1];
    if (warp == 0) {
      if (k + 1 < F) {
        const int m = b + ra, col = b + cb;
        double v = 0.0;
        if (lane < 21) {
          const double* ar = A + m * LD + 6 * k;
          const double* ac = A + col * LD + 6 * k;
          double l[6], v1 = 0.0;
#pragma unroll
          for (int t = 0; t < 6; ++t) {   // two chains of three a term
            const double h = fma(ar[0], Q[t], fma(ar[1], Q[6 + t],
                                                  ar[2] * Q[12 + t]));
            l[t] = h + fma(ar[3], Q[18 + t], fma(ar[4], Q[24 + t],
                                                 ar[5] * Q[30 + t]));
          }
          v = A[m * LD + col];
#pragma unroll
          for (int t = 0; t < 3; ++t) {
            v = fma(-l[t], ac[t], v);
            v1 = fma(-l[t + 3], ac[t + 3], v1);
          }
          v += v1;
        }
        sweep_inverse(v, ra, cb, lane, s_Q[(k + 1) & 1]);
      }
    } else {
      const int o = tid - 32;
      // the panel, a thread an entry (m, c), m in b .. nf: L_mk = A_mk
      // D_k^-1, written transposed above the diagonal (m < nf), and for the
      // gradient's row z_k = D_k^-1 y_k
      for (int it = o; it < (nt + 1) * 6; it += RED_NT - 32) {
        const int m = b + it / 6, c = it - 6 * (it / 6);
        const double* ar = A + m * LD + 6 * k;
        const double l =
            fma(ar[0], Q[c], fma(ar[1], Q[6 + c], ar[2] * Q[12 + c])) +
            fma(ar[3], Q[18 + c], fma(ar[4], Q[24 + c], ar[5] * Q[30 + c]));
        if (m < nf) A[(6 * k + c) * LD + m] = l;
        else s_z[6 * k + c] = l;
      }
      asm volatile("bar.sync 1, %0;" ::"r"(RED_NT - 32) : "memory");
      // the trailing update A_ij -= L_ik A_jk^T of the lower triangle and
      // the gradient's row (rows b .. nf), but for D_k+1 (warp 0's): a
      // thread a row and a run of its columns (every ncg-th), the row's
      // L_mk loaded once
      const int ncg = (RED_NT - 32) / (nt + 1);
      const int m = b + o % (nt + 1), cg0 = o / (nt + 1);
      if (cg0 < ncg) {
        double l[6];
#pragma unroll
        for (int t = 0; t < 6; ++t)
          l[t] = m < nf ? A[(6 * k + t) * LD + m] : s_z[6 * k + t];
        const int last = m < nf ? m : nf - 1;
        for (int col = b + cg0; col <= last; col += ncg) {
          if (m < b + 6 && col < b + 6) continue;
          const double* ac = A + col * LD + 6 * k;
          double v = A[m * LD + col], v1 = 0.0;
#pragma unroll
          for (int t = 0; t < 3; ++t) {
            v = fma(-l[t], ac[t], v);
            v1 = fma(-l[t + 3], ac[t + 3], v1);
          }
          A[m * LD + col] = v + v1;
        }
      }
    }
    __syncthreads();
  }
  // 4. warp 0: L^T x = z by blocks (a lane the rows lane + 32 q), then the
  // step out, masked and capped, and the uncapped one for the landmarks
  if (warp == 0) {
    double y[3];
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      const int m = lane + 32 * q;
      y[q] = m < nf ? s_z[m] : 0.0;
    }
    for (int i = F - 1; i >= 0; --i) {
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        const int m = lane + 32 * q;
        if (m >= 6 * i && m < 6 * i + 6) s_x[m] = y[q];
      }
      __syncwarp();
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        const int m = lane + 32 * q;
        if (m < 6 * i) {
          const double* u = A + m * LD + 6 * i;
#pragma unroll
          for (int c = 0; c < 6; ++c) y[q] = fma(-u[c], s_x[6 * i + c], y[q]);
        }
      }
    }
    __syncwarp();
    if (lane < W) {
      const int rw = (fm >> lane) & 1u ? __popc(fm & ((1u << lane) - 1u))
                                       : -1;
      float x6[6], s = 0.0f;
#pragma unroll
      for (int j = 0; j < 6; ++j) {
        x6[j] = rw >= 0 ? (float)-s_x[6 * rw + j] : 0.0f;
        s += x6[j] * x6[j];
      }
      const float sc =
          a.cap ? fminf(1.0f, 1.0f / fmaxf(sqrtf(s), 1e-12f)) : 1.0f;
#pragma unroll
      for (int j = 0; j < 6; ++j) {
        a.dxi[6 * lane + j] = x6[j] * sc;
        s_step[6 * lane + j] = rw >= 0 ? -s_x[6 * rw + j] : 0.0;
      }
    }
  }
  __syncthreads();
  // 5. every CTA runs (the first phase): the step into each stepping CTA's
  // shared memory, then the second phase
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  cg::cluster_group cl = cg::this_cluster();
  for (int i = tid; i < 6 * W * (C - 1); i += RED_NT)
    cl.map_shared_rank(s_step, 1 + i / (6 * W))[i % (6 * W)] =
        s_step[i % (6 * W)];
  __syncthreads();
  cluster_sync_all();
}

// cudaFuncSetAttribute once a device for a kernel, at the largest size its
// entry launches (done: a flag a device)
template <typename Kernel>
cudaError_t attributes_once(Kernel kernel, unsigned char* done, int smem,
                            bool non_portable) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < ATTR_DEVICES && done[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem);
  if (e == cudaSuccess && non_portable)
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e == cudaSuccess && dev < ATTR_DEVICES) done[dev] = 1;
  return e;
}

unsigned char corr_attr[ATTR_DEVICES], red_attr[ATTR_DEVICES];

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

// -> H_cc (W, 6, 6), g_c (W, 6): a cluster of C CTAs of T threads a pose,
// each CTA S observations (backend/lba.py::camera_layout)
int lba_camera(const float* Jc_pt, const float* r_pt, const float* rn,
               const uint8_t* ok_pt, const float* Jc_ln, const float* r_ln,
               const uint8_t* ok_ln, const float* sigma, const uint8_t* free_,
               float* H_cc, float* g_c, int W, int K, int L, int C, int S,
               int T, cudaStream_t stream) {
  if (W < 1 || W > 65535 || K < 0 || L < 0 || K + 2 * L < 1 || C < 1 ||
      C > CAM_MAX_C || S < 1 || (long long)C * S < K + 2 * L || T < 32 ||
      T > CAM_MAX_T || T % 32 != 0)
    return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, W, 1);
  cfg.blockDim = dim3(T, 1, 1);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = C > 1 ? 1 : 0;
  const CamArgs args{Jc_pt, r_pt, rn,  ok_pt, Jc_ln, r_ln, ok_ln, sigma,
                     free_, H_cc, g_c, W,  K,     L,    S};
  auto kernel = C > 1 ? camera_kernel<true> : camera_kernel<false>;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// obs_id (W, K), sid, eid (W, L) -> off (P + Q + 1) CSR offsets and list
// (W K + 2 W L) observation ids slot by slot (points g = w K + k, then
// endpoints W K + (w 2 + family) L + k), -1 after off[P + Q]. C CTAs of S
// slots each (backend/lba.py::index_layout, which mirrors these limits).
int lba_index(const int* obs_id, const int* sid, const int* eid, int* off,
              int* list, int W, int K, int L, int P, int Q, int C, int S,
              cudaStream_t stream) {
  const long long T = (long long)W * K + 2LL * W * L, N = (long long)P + Q;
  const size_t smem = sizeof(int) * ((size_t)S + 1) + 4 * (size_t)T;
  if (W < 0 || K < 0 || L < 0 || P < 0 || Q < 0 || T > IDX_MAX_T ||
      N > IDX_MAX_N || S < 0 || C < 1 || (long long)C * S < N ||
      (N > 0 && (long long)(C - 1) * S >= N) || smem > IDX_MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        lba_index_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  lba_index_kernel<<<C, IDX_NT, smem, stream>>>(obs_id, sid, eid, off, list,
                                                W, K, L, P, Q, S);
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

// One LM step after the blocks: the Schur complement over lba_index's
// lists, the damped and pinned 6W x 6W solve and the landmark steps ->
// dxi (W, 6) masked and (cap) capped, d (N, 3) floored and capped. scratch:
// backend/lba.py::_solve_words(W, N) words, zero at first use; the launch leaves it so
// for the next (launches that share one run one after another).
int lba_solve(const int* off, const int* list, const float* H_cc,
              const float* g_c, const float* H_ll, const float* H_inv,
              const float* g_l, const float* H_cl, const float* lam,
              const uint8_t* free_, float* dxi, float* d,
              unsigned int* scratch, int scratch_words, int W, int K, int L,
              int N, float pin_weight, int cap, cudaStream_t stream) {
  if (W < 1 || W > SOLVE_MAX_W || N < 1) return (int)cudaErrorInvalidValue;
  const int G = (N + SOLVE_CH - 1) / SOLVE_CH, npair = W * (W + 1) / 2;
  const long long need = SOLVE_HEAD + (long long)N + (long long)G * SOLVE_PW +
                        1 + 2LL * G * npair * SOLVE_SLOT;
  if (scratch_words < need) return (int)cudaErrorInvalidValue;
  const size_t smem1 = sizeof(double) * (SOLVE_CH * W * 18 + SOLVE_CH * 9);
  const size_t smem2 = sizeof(double) * 6 * W * (6 * W + 1) +
                       sizeof(unsigned int) * G * SOLVE_PW;
  const size_t smem = smem1 > smem2 ? smem1 : smem2;
  // with the kernel's static shared memory, the default 48 KB limit may be
  // passed below 48 KB of dynamic: set the limit at every launch
  const cudaError_t e0 = cudaFuncSetAttribute(
      schur_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e0 != cudaSuccess) return (int)e0;
  schur_solve_kernel<<<G, SOLVE_NT, smem, stream>>>(
      off, list, H_cc, g_c, H_inv, g_l, H_cl, lam, free_, dxi, scratch, W, K,
      L, N, pin_weight, cap);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  landmark_step_kernel<<<(N + STEP_NT - 1) / STEP_NT, STEP_NT, 0, stream>>>(
      scratch, H_cl, H_inv, g_l, H_ll, d, W, N, cap);
  return (int)cudaGetLastError();
}

// The owner-sharded step's first half on one shard: the Schur sums over
// lba_index's lists of the shard's landmarks -> corr (W, W, 6, 6) =
// sum_n B_wn C_vn^T and g_corr (W, 6) = sum_n B_wn g_l[n], B = H_cl H_inv,
// for the free pose pairs (zero elsewhere): one launch of a cluster of C
// CTAs, chunks of CH landmarks, per chunks a CTA (backend/lba.py::
// schur_corr_layout). scratch: lba_solve's size; lba_solve_reduced of the
// same shard reads the pose masks it leaves there.
int lba_schur_corr(const int* off, const int* list, const float* H_inv,
                   const float* g_l, const float* H_cl, const uint8_t* free_,
                   float* corr, float* g_corr, unsigned int* scratch,
                   int scratch_words, int W, int K, int L, int N, int C,
                   int CH, int per, cudaStream_t stream) {
  if (W < 1 || W > SOLVE_MAX_W || N < 1 || N > IDX_MAX_N || CH < 32 ||
      CH > CORR_MAX_CH || CH % 32 != 0 || C < 1 || C > CORR_MAX_C ||
      per < 1 || (long long)C * per * CH < N ||
      (long long)scratch_words < SOLVE_HEAD + (long long)N ||
      corr_smem(W, CH) > (size_t)CORR_MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  cudaError_t e =
      attributes_once(schur_corr_kernel, corr_attr, CORR_MAX_SMEM, true);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, 1, 1);
  cfg.blockDim = dim3(CORR_NT, 1, 1);
  cfg.dynamicSmemBytes = corr_smem(W, CH);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const CorrArgs args{off,    list,   H_inv, g_l, H_cl, free_,
                      corr,   g_corr, scratch + SOLVE_HEAD,
                      W,      K,      L,     N,   CH,   per};
  e = cudaLaunchKernelEx(&cfg, schur_corr_kernel, args);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The second half: from the all-reduced H_cc (W, 6, 6), g_c (W, 6), corr and
// g_corr, the damped and pinned reduced system's block L D L^T and solve,
// and the shard's landmark steps -> dxi (W, 6) masked and (cap) capped,
// d (N, 3) floored and capped, as lba_solve's: one launch of a cluster of
// 1 + min(7, ceil(N / 512)) CTAs. scratch: the one the shard's
// lba_schur_corr launch wrote.
int lba_solve_reduced(const float* H_cc, const float* g_c, const float* corr,
                      const float* g_corr, const float* H_ll,
                      const float* H_inv, const float* g_l, const float* H_cl,
                      const float* lam, const uint8_t* free_, float* dxi,
                      float* d, unsigned int* scratch, int scratch_words,
                      int W, int N, float pin_weight, int cap,
                      cudaStream_t stream) {
  if (W < 1 || W > SOLVE_MAX_W || N < 1 ||
      (long long)scratch_words < SOLVE_HEAD + (long long)N)
    return (int)cudaErrorInvalidValue;
  constexpr int most = 6 * SOLVE_MAX_W + 1;
  cudaError_t e = attributes_once(solve_reduced_kernel, red_attr,
                                  (int)sizeof(double) * most * most, false);
  if (e != cudaSuccess) return (int)e;
  const int S = (N + RED_NT - 1) / RED_NT;
  const int C = 1 + (S < RED_MAX_S ? S : RED_MAX_S);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, 1, 1);
  cfg.blockDim = dim3(RED_NT, 1, 1);
  cfg.dynamicSmemBytes = sizeof(double) * (6 * W + 1) * (6 * W + 1);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const RedArgs args{H_cc,  g_c, corr, g_corr, H_ll, H_inv,
                     g_l,   H_cl, lam, free_,  dxi,  d,
                     scratch + SOLVE_HEAD, W, N, pin_weight, cap};
  e = cudaLaunchKernelEx(&cfg, solve_reduced_kernel, args);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // extern "C"
