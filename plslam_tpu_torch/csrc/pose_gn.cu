// Kernel I: the robust Gauss-Newton tracking pose (K13), one launch per
// optimize_pose call for all B frame pairs: both GN phases, the outlier
// gate, the final statistics, the covariance and the isGoodSolution gates.
// A phase-only form (gn_iters) runs n iterations and writes the pose alone.
// An LM mode (optimize_pose_lm) runs n_lm Levenberg-Marquardt iterations
// first, in the same launch, and then the whole tail.
//
// Replaces plslam_tpu/tracking/pose_gn.py::optimize_pose (:130): gn_iter
// (:144-154) with point_terms_rj (:67), line_terms_rj (:81), _weights
// (:117), _assemble_normal_eqs (:102) and the damped solve + exp_se3
// update; the outlier gate (:159-170); the statistics, covariance and
// gates (:176-195). The reference runs them as einsums on the MXU inside
// fori_loops; the port's plain version (tracking/pose_gn.py::
// optimize_pose_plain) issues a few hundred small PyTorch ops a call.
//
// Bound: operations, and in practice latency. An iteration reads a pair's
// K point and L line terms once (K x 24 + L x 40 bytes, 29 KB at K = 1024,
// L = 128) and does ~150 flops a term: tens of nanoseconds for a chunk of
// B = 20 at the card's rates. What costs is the chain of dependent steps
// (residuals -> lower median -> weights -> 27-value reduction -> 6x6 solve
// -> exp update), so block b owns pair b, keeps its pose, masks and norms
// in shared memory and runs every step without leaving the kernel.
//
// The lower median, max((n - 1) // 2, 0)-th smallest of the K + 2L norms
// with the masked ones at the FLT_MAX sentinel (plslam_tpu/core/robust.py
// :18-30), is an exact radix select (csrc/radix_select.cuh): the norm pass
// adds each key's top 11 bits to a shared histogram (warp-aggregated with
// __match_any_sync: the keys cluster in a few buckets), then two more
// digits of 10 bits each walk the keys in shared memory. It returns the
// sort's float, bit for bit, in 12 barriers an iteration where the
// bitonic sort of 2,048 padded floats it replaced took 66, and its only
// limit is the shared memory that holds the K + 2L keys.
//
// Everything else keeps the arithmetic of the sorting kernel, so the
// phase-only form is bit-equal to it: thread tid takes terms tid,
// tid + NT, ... (the terms are recomputed for the normal equations:
// cheaper than keeping 14 floats a term), the 21 + 6 entries of H and g
// are summed by a fixed-order warp-shuffle tree and a fixed-order sum
// over warps, and thread 0 solves (H + 1e-6 I) dxi = -g by Gaussian
// elimination with partial pivoting (now in registers: the pivot rows are
// swapped by selects, not by indexing a local array) and applies
// exp_se3(dxi) on the left, keeping the pose when dxi is not finite
// (pose_gn.py:152-153).
// After the phases, thread 0 inverts H + 1e-6 I by Gauss-Jordan with
// partial pivoting in f32 for the covariance.
//
// The LM mode replaces optimize_pose_lm (plslam_tpu/tracking/pose_gn.py
// :198): 2 max_iters iterations on every valid term, each solving
// (H + lambda diag(H) + 1e-9 I) dxi = -g, trying T_try = exp(dxi) T and
// accepting it iff its cost (the weighted SSE under its own MAD scale) is
// finite and below the cost at T; lambda x 0.33 on accept, x 3 on reject;
// then optimize_pose's tail with a first phase of one iteration. The
// reference evaluates the terms twice an iteration (H and g at T, the
// cost at T_try). Here one evaluation at T_try gives its cost and its H
// and g with its own scale, which are the next iteration's H and g when
// it is accepted; a reject keeps the H and g at T. So an iteration is one
// norm pass, one median and one normal-equation pass, as a GN iteration.
// The decision compares two sums in the kernel's order: a NaN trial
// (a singular solve) is rejected, as isfinite(c_try) rejects it.
//
// On an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py): a phase of 20
// pairs, K = 1,024, L = 128, 8 iterations, 0.075 ms (the bitonic kernel
// 0.238); the whole optimize_pose (8 + 8) 0.171 ms at B = 20 and 0.165 at
// B = 1, ~10 us an iteration, one block a pair. What is left is latency:
// ~15 barriers an iteration, two passes over the terms, a serial 6 x 6
// solve on one thread; B = 20 fills 20 of 132 SMs.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#include "radix_select.cuh"

namespace {

using radix::key_of;
using radix::SEL_D1, radix::SEL_D2, radix::SEL_D3;
using radix::SEL_SHIFT1, radix::SEL_SHIFT2;

constexpr int NT = 512;
constexpr int NWARP = NT / 32;
constexpr int NV = 27;  // H upper triangle (21) + g (6); + sse in the stats

struct Cam {
  float fx, fy, cx, cy;
};

// optimize_pose's scalars (TrackingConfig), as float32 as torch casts them
struct Gates {
  float inlier_k, min_inlier_ratio, max_optim_error;
  int min_features;
};

__device__ __forceinline__ float safe_z(float z) {
  return fabsf(z) < 1e-7f ? 1e-7f : z;
}

// Pc = R p + t with T row-major 4x4 in shared memory
__device__ __forceinline__ void xform(const float* T, const float* p,
                                      float* pc) {
#pragma unroll
  for (int a = 0; a < 3; ++a)
    pc[a] = T[a * 4 + 0] * p[0] + T[a * 4 + 1] * p[1] + T[a * 4 + 2] * p[2] +
            T[a * 4 + 3];
}

// pixel of a camera point and d(pixel)/d(twist), 2 x 6
__device__ __forceinline__ void project_jac(const Cam& c, const float* pc,
                                            float* uv, float J[2][6]) {
  const float x = pc[0], y = pc[1], z = safe_z(pc[2]);
  uv[0] = __fadd_rn(__fdiv_rn(__fmul_rn(c.fx, pc[0]), z), c.cx);
  uv[1] = __fadd_rn(__fdiv_rn(__fmul_rn(c.fy, pc[1]), z), c.cy);
  const float iz = 1.0f / z, iz2 = iz * iz;
  const float jp[2][3] = {{c.fx * iz, 0.0f, -c.fx * x * iz2},
                          {0.0f, c.fy * iz, -c.fy * y * iz2}};
  const float X = pc[0], Y = pc[1], Z = pc[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    J[i][0] = jp[i][0];
    J[i][1] = jp[i][1];
    J[i][2] = jp[i][2];
    // [I, -skew(Pc)]
    J[i][3] = -jp[i][1] * Z + jp[i][2] * Y;
    J[i][4] = jp[i][0] * Z - jp[i][2] * X;
    J[i][5] = -jp[i][0] * Y + jp[i][1] * X;
  }
}

// one point term: residual (2), Jacobian (2 x 6), residual norm
__device__ __forceinline__ void point_term(const Cam& c, const float* T,
                                           const float* P, const float* uvo,
                                           bool valid, float r[2],
                                           float J[2][6], float* norm) {
  float pc[3], uv[2];
  xform(T, P, pc);
  project_jac(c, pc, uv, J);
  const bool ok = valid && !(pc[2] < 0.1f);
  r[0] = ok ? __fsub_rn(uv[0], uvo[0]) : 0.0f;
  r[1] = ok ? __fsub_rn(uv[1], uvo[1]) : 0.0f;
  if (!ok)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 6; ++j) J[i][j] = 0.0f;
  *norm = __fsqrt_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(r[0], r[0]), __fmul_rn(r[1], r[1])),
                1e-12f));
}

// one line term: point-to-line residuals of both endpoints (2), 2 x 6
__device__ __forceinline__ void line_term(const Cam& c, const float* T,
                                          const float* sP, const float* eP,
                                          const float* le, bool valid,
                                          float r[2], float J[2][6]) {
  bool behind = false;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    float pc[3], uv[2], Jp[2][6];
    xform(T, e == 0 ? sP : eP, pc);
    project_jac(c, pc, uv, Jp);
    behind |= pc[2] < 0.1f;
    r[e] = __fadd_rn(__fadd_rn(__fmul_rn(le[0], uv[0]),
                               __fmul_rn(le[1], uv[1])), le[2]);
#pragma unroll
    for (int j = 0; j < 6; ++j) J[e][j] = le[0] * Jp[0][j] + le[1] * Jp[1][j];
  }
  if (!(valid && !behind)) {
    r[0] = r[1] = 0.0f;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 6; ++j) J[i][j] = 0.0f;
  }
}

__device__ __forceinline__ float tstudent(float r, float sigma) {
  const float q = __fdiv_rn(r, sigma);
  return __fdiv_rn(6.0f, __fadd_rn(5.0f, __fmul_rn(q, q)));
}

__device__ __forceinline__ void accumulate(float* acc, float w,
                                           const float* J, float r) {
  int o = 0;
#pragma unroll
  for (int p = 0; p < 6; ++p)
#pragma unroll
    for (int q = p; q < 6; ++q) acc[o++] += w * J[p] * J[q];
#pragma unroll
  for (int p = 0; p < 6; ++p) acc[21 + p] += w * J[p] * r;
}

// swap rows c and piv (> c) of a register matrix by selects
template <int C, int N>
__device__ __forceinline__ void swap_rows(float (&A)[6][N], int piv) {
#pragma unroll
  for (int i = C + 1; i < 6; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const bool s = piv == i;
      const float a = A[C][j], b = A[i][j];
      A[C][j] = s ? b : a;
      A[i][j] = s ? a : b;
    }
}

// the first row i >= C with the largest |A[i][C]| (strict >: the first)
template <int C, int N>
__device__ __forceinline__ int pivot_row(const float (&A)[6][N]) {
  int piv = C;
  float best = fabsf(A[C][C]);
#pragma unroll
  for (int i = C + 1; i < 6; ++i)
    if (fabsf(A[i][C]) > best) {
      piv = i;
      best = fabsf(A[i][C]);
    }
  return piv;
}

// solve A x = b (6 x 6, b in column 6) by Gaussian elimination with partial
// pivoting: the sorting kernel's loops and expressions, unrolled into
// registers
template <int C>
__device__ __forceinline__ void eliminate(float (&A)[6][7]) {
  if constexpr (C < 6) {
    swap_rows<C, 7>(A, pivot_row<C, 7>(A));
#pragma unroll
    for (int i = C + 1; i < 6; ++i) {
      const float f = A[i][C] / A[C][C];
#pragma unroll
      for (int j = C; j < 7; ++j) A[i][j] -= f * A[C][j];
    }
    eliminate<C + 1>(A);
  }
}

__device__ __forceinline__ void solve6(float (&A)[6][7]) {
  eliminate<0>(A);
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float s = A[i][6];
#pragma unroll
    for (int j = i + 1; j < 6; ++j) s -= A[i][j] * A[j][6];
    A[i][6] = s / A[i][i];
  }
}

// (A)^-1 of the left half of [A | I] (6 x 12) into the right half:
// Gauss-Jordan with partial pivoting
template <int C>
__device__ __forceinline__ void gauss_jordan(float (&M)[6][12]) {
  if constexpr (C < 6) {
    swap_rows<C, 12>(M, pivot_row<C, 12>(M));
    const float p = M[C][C];
#pragma unroll
    for (int j = 0; j < 12; ++j) M[C][j] = M[C][j] / p;
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      if (i == C) continue;
      const float f = M[i][C];
#pragma unroll
      for (int j = 0; j < 12; ++j) M[i][j] -= f * M[C][j];
    }
    gauss_jordan<C + 1>(M);
  }
}

// exp_se3 (core/lie.py, the same small-angle switch) applied on the left
__device__ void exp_left(const float* xi, float* T) {
  const float v[3] = {xi[0], xi[1], xi[2]}, w[3] = {xi[3], xi[4], xi[5]};
  const float th2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
  const bool small = th2 < 1e-4f;
  const float t2 = small ? 1.0f : th2, t = sqrtf(t2);
  const float A = small ? 1.0f - th2 / 6.0f : sinf(t) / t;
  const float B = small ? 0.5f - th2 / 24.0f : (1.0f - cosf(t)) / t2;
  const float C = small ? 1.0f / 6.0f - th2 / 120.0f : (1.0f - A) / t2;
  const float W[3][3] = {{0.f, -w[2], w[1]}, {w[2], 0.f, -w[0]},
                         {-w[1], w[0], 0.f}};
  float W2[3][3], R[3][3], V[3][3], tr[3];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      W2[i][j] = W[i][0] * W[0][j] + W[i][1] * W[1][j] + W[i][2] * W[2][j];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      const float e = i == j ? 1.0f : 0.0f;
      R[i][j] = e + A * W[i][j] + B * W2[i][j];
      V[i][j] = e + B * W[i][j] + C * W2[i][j];
    }
  for (int i = 0; i < 3; ++i) tr[i] = V[i][0] * v[0] + V[i][1] * v[1] + V[i][2] * v[2];
  float out[12];
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 4; ++j)
      out[i * 4 + j] = R[i][0] * T[j] + R[i][1] * T[4 + j] + R[i][2] * T[8 + j] +
                       (j == 3 ? tr[i] : 0.0f);
  }
  for (int k = 0; k < 12; ++k) T[k] = out[k];
}

// *count += the warp's lanes that are on; every lane of the warp calls it
__device__ __forceinline__ void warp_count(int* count, bool on) {
  const unsigned int mask = __ballot_sync(0xffffffffu, on);
  if ((threadIdx.x & 31) == 0 && mask) atomicAdd(count, __popc(mask));
}

// h[bucket] += 1 for the lanes that are in, one atomic a distinct bucket;
// every lane of the warp calls it
__device__ __forceinline__ void hist_add(unsigned int* h, unsigned int bucket,
                                         bool in) {
  const unsigned int on = __ballot_sync(0xffffffffu, in);
  if (in) {
    const unsigned int peers = __match_any_sync(on, bucket);
    if ((int)(threadIdx.x & 31) == __ffs(peers) - 1)
      atomicAdd(&h[bucket], (unsigned int)__popc(peers));
  }
}

// Shared state of a block: the pose, the current masks and norms, the
// select's histograms (zero between selects) and the reductions.
struct Block {
  float* T;              // 16
  unsigned int* keys;    // K + 2L norms' keys, FLT_MAX where masked
  uint8_t* mpt;          // K current point mask
  uint8_t* mln;          // L current line mask
  unsigned int* h1;      // SEL_D1, holds the norm pass's top digits
  unsigned int* h2;      // SEL_D2
  unsigned int* h3;      // SEL_D3
  unsigned int* scan;    // NWARP
  float (*red)[NV + 1];  // NWARP x (NV + 1)
  float* tot;            // NV + 1
  float* cur;            // NV + 1: H, g and cost at the LM's current pose
  float* Tk;             // 16: the LM's current pose while T holds T_try
  const float *P, *uvo, *sP, *eP, *le;
  int K, L;
  Cam cam;
};

// the keys of every norm at the current pose and masks, and their top
// digits into h1; ends with a barrier
__device__ void norm_pass(const Block& s) {
  const int tid = threadIdx.x, N = s.K + 2 * s.L;
  for (int i0 = 0; i0 < N; i0 += NT) {
    const int i = i0 + tid;
    float v = FLT_MAX;
    if (i < s.K) {
      float r[2], J[2][6], nrm;
      const bool valid = s.mpt[i] != 0;
      point_term(s.cam, s.T, s.P + 3 * i, s.uvo + 2 * i, valid, r, J, &nrm);
      if (valid) v = nrm;
    } else if (i < N) {
      const int l = (i - s.K) >> 1, e = (i - s.K) & 1;
      float r[2], J[2][6];
      const bool valid = s.mln[l] != 0;
      line_term(s.cam, s.T, s.sP + 3 * l, s.eP + 3 * l, s.le + 3 * l, valid,
                r, J);
      if (valid) v = fabsf(r[e]);
    }
    const unsigned int key = key_of(v);
    if (i < N) s.keys[i] = key;
    hist_add(s.h1, key >> SEL_SHIFT1, i < N);
  }
  __syncthreads();
}

// the element of rank max((n - 1) / 2, 0) of the keys (0 where n = 0):
// h1 holds their top digits; leaves h1, h2, h3 zero
__device__ float lower_median(const Block& s, int n) {
  const int tid = threadIdx.x, N = s.K + 2 * s.L;
  if (n <= 0) {
    for (int b = tid; b < SEL_D1; b += NT) s.h1[b] = 0;
    return 0.0f;
  }
  unsigned int k = (unsigned int)(n - 1) / 2;
  int b1, b2, b3;
  radix::select_bucket<NT, SEL_D1>(s.h1, k, &b1, &k, s.scan);
  for (int b = tid; b < SEL_D1; b += NT) s.h1[b] = 0;
  for (int i0 = 0; i0 < N; i0 += NT) {
    const int i = i0 + tid;
    const unsigned int key = i < N ? s.keys[i] : 0u;
    hist_add(s.h2, (key >> SEL_SHIFT2) & (SEL_D2 - 1),
             i < N && (int)(key >> SEL_SHIFT1) == b1);
  }
  __syncthreads();
  radix::select_bucket<NT, SEL_D2>(s.h2, k, &b2, &k, s.scan);
  for (int b = tid; b < SEL_D2; b += NT) s.h2[b] = 0;
  const unsigned int prefix =
      ((unsigned int)b1 << (SEL_SHIFT1 - SEL_SHIFT2)) | (unsigned int)b2;
  for (int i0 = 0; i0 < N; i0 += NT) {
    const int i = i0 + tid;
    const unsigned int key = i < N ? s.keys[i] : 0u;
    hist_add(s.h3, key & (SEL_D3 - 1), i < N && key >> SEL_SHIFT2 == prefix);
  }
  __syncthreads();
  radix::select_bucket<NT, SEL_D3>(s.h3, k, &b3, &k, s.scan);
  for (int b = tid; b < SEL_D3; b += NT) s.h3[b] = 0;
  return __uint_as_float((prefix << SEL_SHIFT2) | (unsigned int)b3);
}

// the weighted normal equations at the current pose and masks into
// tot[0 .. 27) (+ tot[27] = sum w |r|^2 with SSE), in the sorting
// kernel's order; ends with
// a barrier
template <bool SSE>
__device__ void normal_eqs(const Block& s, float sigma) {
  constexpr int NA = NV + (SSE ? 1 : 0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float acc[NA];
#pragma unroll
  for (int v = 0; v < NA; ++v) acc[v] = 0.0f;
  for (int i = tid; i < s.K + s.L; i += NT) {
    float r[2], J[2][6];
    if (i < s.K) {
      float nrm;
      const bool valid = s.mpt[i] != 0;
      point_term(s.cam, s.T, s.P + 3 * i, s.uvo + 2 * i, valid, r, J, &nrm);
      const float w = valid ? tstudent(nrm, sigma) : 0.0f;
      accumulate(acc, w, J[0], r[0]);
      accumulate(acc, w, J[1], r[1]);
      if constexpr (SSE) acc[NA - 1] += w * (nrm * nrm);
    } else {
      const int l = i - s.K;
      const bool valid = s.mln[l] != 0;
      line_term(s.cam, s.T, s.sP + 3 * l, s.eP + 3 * l, s.le + 3 * l, valid,
                r, J);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float w = valid ? tstudent(fabsf(r[e]), sigma) : 0.0f;
        accumulate(acc, w, J[e], r[e]);
        if constexpr (SSE) acc[NA - 1] += w * (r[e] * r[e]);
      }
    }
  }
#pragma unroll
  for (int v = 0; v < NA; ++v) {
    float x = acc[v];
    for (int d = 16; d > 0; d >>= 1) x += __shfl_xor_sync(0xffffffffu, x, d);
    if (lane == 0) s.red[warp][v] = x;
  }
  __syncthreads();
  if (tid < NA) {
    float x = 0.0f;
    for (int w = 0; w < NWARP; ++w) x += s.red[w][tid];
    s.tot[tid] = x;
  }
  __syncthreads();
}

// the MAD scale of the current norms: max(1.4826 med, 1e-4)
__device__ __forceinline__ float mad_scale(const Block& s, int n) {
  norm_pass(s);
  return fmaxf(__fmul_rn(1.4826f, lower_median(s, n)), 1e-4f);
}

// n_iters robust GN iterations on the current masks (n keys valid)
__device__ void gn_phase(const Block& s, int n, int n_iters) {
  for (int it = 0; it < n_iters; ++it) {
    normal_eqs<false>(s, mad_scale(s, n));
    // the damped 6 x 6 solve and the left update, on one thread
    if (threadIdx.x == 0) {
      float A[6][7];
      int o = 0;
#pragma unroll
      for (int p = 0; p < 6; ++p)
#pragma unroll
        for (int q = p; q < 6; ++q) {
          A[p][q] = A[q][p] = s.tot[o++];
        }
#pragma unroll
      for (int p = 0; p < 6; ++p) {
        A[p][p] += 1e-6f;
        A[p][6] = s.tot[21 + p];
      }
      solve6(A);
      float dxi[6];
      bool finite = true;
#pragma unroll
      for (int p = 0; p < 6; ++p) {
        dxi[p] = -A[p][6];
        finite = finite && isfinite(dxi[p]);
      }
      if (finite) exp_left(dxi, s.T);
    }
    __syncthreads();
  }
}

// n_lm Levenberg-Marquardt iterations on the current masks (n keys valid),
// damping from lam0; trace (n_lm x 3: the cost at T, at T_try and lambda
// after the iteration) where not null
__device__ void lm_phase(const Block& s, int n, int n_lm, float lam0,
                         float* trace) {
  const int tid = threadIdx.x;
  normal_eqs<true>(s, mad_scale(s, n));
  if (tid <= NV) s.cur[tid] = s.tot[tid];
  float lam = lam0;   // thread 0's
  __syncthreads();
  for (int it = 0; it < n_lm; ++it) {
    if (tid == 0) {
      float A[6][7];
      int o = 0;
#pragma unroll
      for (int p = 0; p < 6; ++p)
#pragma unroll
        for (int q = p; q < 6; ++q) {
          A[p][q] = A[q][p] = s.cur[o++];
        }
#pragma unroll
      for (int p = 0; p < 6; ++p) {
        A[p][p] = __fadd_rn(__fadd_rn(A[p][p], __fmul_rn(lam, A[p][p])),
                            1e-9f);
        A[p][6] = s.cur[21 + p];
      }
      solve6(A);
      float dxi[6];
#pragma unroll
      for (int p = 0; p < 6; ++p) dxi[p] = -A[p][6];
#pragma unroll
      for (int k = 0; k < 16; ++k) s.Tk[k] = s.T[k];
      exp_left(dxi, s.T);
    }
    __syncthreads();
    normal_eqs<true>(s, mad_scale(s, n));
    if (tid == 0) {
      const float c = s.cur[NV], c_try = s.tot[NV];
      const bool accept = isfinite(c_try) && c_try < c;
      lam = accept ? __fmul_rn(lam, 0.33f) : __fmul_rn(lam, 3.0f);
      if (accept) {
        for (int v = 0; v <= NV; ++v) s.cur[v] = s.tot[v];
      } else {
        for (int k = 0; k < 16; ++k) s.T[k] = s.Tk[k];
      }
      if (trace) {
        trace[3 * it] = c;
        trace[3 * it + 1] = c_try;
        trace[3 * it + 2] = lam;
      }
    }
    __syncthreads();
  }
}

// lie.is_valid_rotation (tol 1e-3) and finiteness of a row-major 4 x 4
__device__ bool pose_ok(const float* T) {
  bool ok = true;
#pragma unroll
  for (int k = 0; k < 16; ++k) ok = ok && isfinite(T[k]);
  const float R[3][3] = {{T[0], T[1], T[2]}, {T[4], T[5], T[6]},
                         {T[8], T[9], T[10]}};
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float d = R[i][0] * R[j][0] + R[i][1] * R[j][1] +
                      R[i][2] * R[j][2] - (i == j ? 1.0f : 0.0f);
      ok = ok && fabsf(d) < 1e-3f;   // false for a NaN, as amax's
    }
  const float det = R[0][0] * (R[1][1] * R[2][2] - R[1][2] * R[2][1]) -
                    R[0][1] * (R[1][0] * R[2][2] - R[1][2] * R[2][0]) +
                    R[0][2] * (R[1][0] * R[2][1] - R[1][1] * R[2][0]);
  return ok && fabsf(det - 1.0f) < 1e-3f;
}

// LM (with WHOLE): the LM mode, its own instance, so the other two compile
// as they did before it
template <bool WHOLE, bool LM>
__global__ void __launch_bounds__(NT) pose_optimize_kernel(
    const float* __restrict__ T0, const float* __restrict__ P,
    const float* __restrict__ uvo, const uint8_t* __restrict__ pmask,
    const float* __restrict__ sP, const float* __restrict__ eP,
    const float* __restrict__ le, const uint8_t* __restrict__ lmask,
    float* __restrict__ Tout, float* __restrict__ cov_out,
    int* __restrict__ ninl_out, float* __restrict__ err_out,
    uint8_t* __restrict__ inl_pt, uint8_t* __restrict__ inl_ln,
    uint8_t* __restrict__ good_out, float* __restrict__ lm_trace, int K,
    int L, int n_iters, int n_ref, int n_lm, float lam0, Cam cam,
    Gates gates) {
  extern __shared__ unsigned int dyn[];
  __shared__ unsigned int h1[SEL_D1], h2[SEL_D2], h3[SEL_D3];
  __shared__ unsigned int scan[NWARP];
  __shared__ float T[16];
  __shared__ float red[NWARP][NV + 1];
  __shared__ float tot[NV + 1];
  __shared__ float cur[LM ? NV + 1 : 1];
  __shared__ float Tk[LM ? 16 : 1];
  __shared__ int counts[4];  // valid points, lines; inlier points, lines
  const int b = blockIdx.x, tid = threadIdx.x;
  Block s;
  s.T = T;
  s.keys = dyn;
  s.mpt = reinterpret_cast<uint8_t*>(dyn + K + 2 * L);
  s.mln = s.mpt + K;
  s.h1 = h1;
  s.h2 = h2;
  s.h3 = h3;
  s.scan = scan;
  s.red = red;
  s.tot = tot;
  s.cur = cur;
  s.Tk = Tk;
  s.P = P + (size_t)b * K * 3;
  s.uvo = uvo + (size_t)b * K * 2;
  s.sP = sP + (size_t)b * L * 3;
  s.eP = eP + (size_t)b * L * 3;
  s.le = le + (size_t)b * L * 3;
  s.K = K;
  s.L = L;
  s.cam = cam;
  pmask += (size_t)b * K;
  lmask += (size_t)b * L;
  if (tid < 16) T[tid] = T0[(size_t)b * 16 + tid];
  if (tid < 4) counts[tid] = 0;
  for (int i = tid; i < SEL_D1; i += NT) h1[i] = 0;
  for (int i = tid; i < SEL_D2; i += NT) h2[i] = 0;
  for (int i = tid; i < SEL_D3; i += NT) h3[i] = 0;
  __syncthreads();
  for (int k0 = 0; k0 < K; k0 += NT) {
    const int k = k0 + tid;
    const bool on = k < K && pmask[k] != 0;
    if (k < K) s.mpt[k] = on;
    warp_count(&counts[0], on);
  }
  for (int l0 = 0; l0 < L; l0 += NT) {
    const int l = l0 + tid;
    const bool on = l < L && lmask[l] != 0;
    if (l < L) s.mln[l] = on;
    warp_count(&counts[1], on);
  }
  __syncthreads();
  const int n_pt = counts[0], n_ln = counts[1];

  // the LM mode's iterations on every valid term
  if constexpr (LM)
    lm_phase(s, n_pt + 2 * n_ln, n_lm, lam0,
             lm_trace ? lm_trace + (size_t)b * n_lm * 3 : nullptr);

  // the robust phase on every valid term
  gn_phase(s, n_pt + 2 * n_ln, n_iters);
  if (!WHOLE) {
    if (tid < 16) Tout[(size_t)b * 16 + tid] = T[tid];
    return;
  }

  // the outlier gate on the robust scale, floored at a quarter pixel: a
  // thread reads and rewrites only its own terms' masks
  const float sigma = fmaxf(mad_scale(s, n_pt + 2 * n_ln), 0.25f);
  const float thr = __fmul_rn(gates.inlier_k, sigma);
  for (int k0 = 0; k0 < K; k0 += NT) {
    const int k = k0 + tid;
    const bool on = k < K && s.mpt[k] && __uint_as_float(s.keys[k]) < thr;
    if (k < K) s.mpt[k] = on;
    warp_count(&counts[2], on);
  }
  for (int l0 = 0; l0 < L; l0 += NT) {
    const int l = l0 + tid;
    const bool on = l < L && s.mln[l] &&
                    __uint_as_float(s.keys[K + 2 * l]) < thr &&
                    __uint_as_float(s.keys[K + 2 * l + 1]) < thr;
    if (l < L) s.mln[l] = on;
    warp_count(&counts[3], on);
  }
  __syncthreads();
  const int i_pt = counts[2], i_ln = counts[3];

  // the refinement phase on the inliers, then the final statistics
  gn_phase(s, i_pt + 2 * i_ln, n_ref);
  normal_eqs<true>(s, mad_scale(s, i_pt + 2 * i_ln));
  for (int k = tid; k < K; k += NT) inl_pt[(size_t)b * K + k] = s.mpt[k];
  for (int l = tid; l < L; l += NT) inl_ln[(size_t)b * L + l] = s.mln[l];
  if (tid < 16) Tout[(size_t)b * 16 + tid] = T[tid];
  if (tid != 0) return;
  float M[6][12];
  int o = 0;
#pragma unroll
  for (int p = 0; p < 6; ++p)
#pragma unroll
    for (int q = p; q < 6; ++q) M[p][q] = M[q][p] = tot[o++];
#pragma unroll
  for (int p = 0; p < 6; ++p) {
    M[p][p] += 1e-6f;
#pragma unroll
    for (int q = 0; q < 6; ++q) M[p][6 + q] = p == q ? 1.0f : 0.0f;
  }
  gauss_jordan<0>(M);
  const float sse = tot[NV];
  const int n_inl = i_pt + i_ln;
  const float n_res = 2.0f * (float)n_inl;
  const float sigma2 = sse / fmaxf(n_res - 6.0f, 1.0f);
  float* cov = cov_out + (size_t)b * 36;
#pragma unroll
  for (int p = 0; p < 6; ++p)
#pragma unroll
    for (int q = 0; q < 6; ++q) cov[p * 6 + q] = sigma2 * M[p][6 + q];
  const float err = sqrtf(sse / fmaxf(n_res, 1.0f));
  const int n_total = max(n_pt + n_ln, 1);
  ninl_out[b] = n_inl;
  err_out[b] = err;
  good_out[b] = n_inl >= gates.min_features &&
                (float)n_inl >=
                    __fmul_rn(gates.min_inlier_ratio, (float)n_total) &&
                err < gates.max_optim_error && pose_ok(T);
}

}  // namespace

extern "C" {

// T0 (B, 4, 4); points P (B, K, 3), uv (B, K, 2), mask (B, K) u8; lines
// sP, eP, le (B, L, 3), mask (B, L) u8. whole = 0: T (B, 4, 4) after n_iters
// robust GN iterations (the other outputs are not touched and may be null).
// whole = 1: optimize_pose, n_iters robust and n_ref refinement iterations:
// T, cov (B, 6, 6), n_inliers (B,) int32, err (B,), the inlier masks (B, K)
// and (B, L) and good (B,), as bytes of 0 or 1. n_lm > 0 (whole only): n_lm
// Levenberg-Marquardt iterations from lambda lam0 before the robust phase
// (optimize_pose_lm), and, where lm_trace is not null, each iteration's
// cost at T, cost at T_try and lambda after it, (B, n_lm, 3).
int pose_gn_optimize(const float* T0, const float* P, const float* uv,
                     const uint8_t* pmask, const float* sP, const float* eP,
                     const float* le, const uint8_t* lmask, float* T,
                     float* cov, int* n_inliers, float* err, uint8_t* inl_pt,
                     uint8_t* inl_ln, uint8_t* good, float* lm_trace, int B,
                     int K, int L, int n_iters, int n_ref, int whole,
                     int min_features, int n_lm, float fx, float fy,
                     float cx, float cy, float inlier_k,
                     float min_inlier_ratio, float max_optim_error,
                     float lam0, cudaStream_t stream) {
  if (B == 0) return 0;
  const Cam cam{fx, fy, cx, cy};
  const Gates gates{inlier_k, min_inlier_ratio, max_optim_error,
                    min_features};
  const size_t smem = sizeof(unsigned int) * ((size_t)K + 2 * (size_t)L) +
                      (size_t)K + (size_t)L;
  if (n_lm > 0 && !whole) return (int)cudaErrorInvalidValue;
  auto kernel = n_lm > 0 ? pose_optimize_kernel<true, true>
                : whole  ? pose_optimize_kernel<true, false>
                         : pose_optimize_kernel<false, false>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<B, NT, smem, stream>>>(T0, P, uv, pmask, sP, eP, le, lmask, T,
                                  cov, n_inliers, err, inl_pt, inl_ln, good,
                                  lm_trace, K, L, n_iters, n_ref, n_lm, lam0,
                                  cam, gates);
  return (int)cudaGetLastError();
}

}  // extern "C"
