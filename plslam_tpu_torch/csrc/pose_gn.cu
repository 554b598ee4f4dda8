// Kernel I: robust Gauss-Newton iterations of the SE(3) tracking pose (K13),
// one launch for all the iterations of one GN phase of all B frame pairs.
//
// Replaces plslam_tpu/tracking/pose_gn.py::point_terms_rj (:67),
// line_terms_rj (:81), _weights (:117), _assemble_normal_eqs (:102) and the
// damped solve + exp_se3 update of gn_iter (:144-154). The reference runs
// them as einsums on the MXU inside a fori_loop; the port's plain version
// issues a few hundred small PyTorch ops per iteration.
//
// Bound: operations, and in practice latency. Per iteration a pair reads its
// K point and L line terms once (K x 24 + L x 40 bytes, 29 KB at K=1024,
// L=128) and does ~150 flops per term, ~0.2 MFLOP: both bounds are tens of
// nanoseconds for a chunk of B=20. What costs is the chain of dependent
// steps (residuals -> lower median -> weights -> 27-value reduction -> 6x6
// solve -> exp update), so one block per pair keeps the pose in shared
// memory and runs all n_iters iterations without leaving the kernel.
//
// Design: block b owns pair b. The K + 2L residual norms go to shared
// memory (masked entries as FLT_MAX, padded to a power of two S) and a
// bitonic sort gives the exact lower median at index max((n-1)//2, 0), as
// plslam_tpu/core/robust.py:18-30. The residuals and Jacobians are then
// recomputed per term (cheaper than keeping 14 floats per term), weighted
// (t-student, dof 5) and summed into the 21 + 6 entries of H and g by a
// fixed-order warp-shuffle tree and a fixed-order sum over warps: the result
// does not depend on scheduling. Thread 0 solves (H + 1e-6 I) dxi = -g by
// Gaussian elimination with partial pivoting and applies exp_se3(dxi) on the
// left, keeping the pose when dxi is not finite (pose_gn.py:152-153).

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 512;
constexpr int NWARP = NT / 32;
constexpr int NV = 27;  // H upper triangle (21) + g (6)

struct Cam {
  float fx, fy, cx, cy;
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

// solve A x = b (6 x 6) by Gaussian elimination with partial pivoting
__device__ void solve6(float A[6][7]) {
  for (int c = 0; c < 6; ++c) {
    int piv = c;
    for (int i = c + 1; i < 6; ++i)
      if (fabsf(A[i][c]) > fabsf(A[piv][c])) piv = i;
    if (piv != c)
      for (int j = 0; j < 7; ++j) {
        float t = A[c][j];
        A[c][j] = A[piv][j];
        A[piv][j] = t;
      }
    for (int i = c + 1; i < 6; ++i) {
      const float f = A[i][c] / A[c][c];
      for (int j = c; j < 7; ++j) A[i][j] -= f * A[c][j];
    }
  }
  for (int i = 5; i >= 0; --i) {
    float s = A[i][6];
    for (int j = i + 1; j < 6; ++j) s -= A[i][j] * A[j][6];
    A[i][6] = s / A[i][i];
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

__global__ void __launch_bounds__(NT)
    pose_gn_kernel(const float* __restrict__ T0, const float* __restrict__ P,
                   const float* __restrict__ uvo,
                   const uint8_t* __restrict__ pmask,
                   const float* __restrict__ sP, const float* __restrict__ eP,
                   const float* __restrict__ le,
                   const uint8_t* __restrict__ lmask, float* __restrict__ Tout,
                   int K, int L, int S, int n_iters, Cam cam) {
  extern __shared__ float sorted[];  // S floats
  __shared__ float T[16];
  __shared__ float red[NWARP][NV];
  __shared__ float tot[NV];
  __shared__ int n_valid;
  const int b = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  P += (size_t)b * K * 3;
  uvo += (size_t)b * K * 2;
  pmask += (size_t)b * K;
  sP += (size_t)b * L * 3;
  eP += (size_t)b * L * 3;
  le += (size_t)b * L * 3;
  lmask += (size_t)b * L;
  if (tid < 16) T[tid] = T0[(size_t)b * 16 + tid];
  if (tid == 0) n_valid = 0;
  __syncthreads();
  int mine = 0;
  for (int k = tid; k < K; k += NT) mine += pmask[k] != 0;
  for (int l = tid; l < L; l += NT) mine += 2 * (lmask[l] != 0);
  atomicAdd(&n_valid, mine);  // integer: order-free
  __syncthreads();
  const int n = n_valid;

  for (int it = 0; it < n_iters; ++it) {
    // 1. norms of every term into the sort buffer
    for (int i = tid; i < S; i += NT) {
      float v = FLT_MAX;
      if (i < K) {
        float r[2], J[2][6], nrm;
        const bool valid = pmask[i] != 0;
        point_term(cam, T, P + 3 * i, uvo + 2 * i, valid, r, J, &nrm);
        if (valid) v = nrm;
      } else if (i < K + 2 * L) {
        const int l = (i - K) >> 1, e = (i - K) & 1;
        float r[2], J[2][6];
        const bool valid = lmask[l] != 0;
        line_term(cam, T, sP + 3 * l, eP + 3 * l, le + 3 * l, valid, r, J);
        if (valid) v = fabsf(r[e]);
      }
      sorted[i] = v;
    }
    __syncthreads();
    // 2. bitonic sort (ascending), then the lower median
    for (int k = 2; k <= S; k <<= 1)
      for (int j = k >> 1; j > 0; j >>= 1) {
        for (int i = tid; i < S; i += NT) {
          const int ixj = i ^ j;
          if (ixj > i) {
            const float a = sorted[i], c = sorted[ixj];
            if ((a > c) == ((i & k) == 0)) {
              sorted[i] = c;
              sorted[ixj] = a;
            }
          }
        }
        __syncthreads();
      }
    const float med = n > 0 ? sorted[max((n - 1) / 2, 0)] : 0.0f;
    const float sigma = fmaxf(__fmul_rn(1.4826f, med), 1e-4f);

    // 3. weighted normal equations
    float acc[NV];
#pragma unroll
    for (int v = 0; v < NV; ++v) acc[v] = 0.0f;
    for (int i = tid; i < K + L; i += NT) {
      float r[2], J[2][6];
      if (i < K) {
        float nrm;
        const bool valid = pmask[i] != 0;
        point_term(cam, T, P + 3 * i, uvo + 2 * i, valid, r, J, &nrm);
        const float w = valid ? tstudent(nrm, sigma) : 0.0f;
        accumulate(acc, w, J[0], r[0]);
        accumulate(acc, w, J[1], r[1]);
      } else {
        const int l = i - K;
        const bool valid = lmask[l] != 0;
        line_term(cam, T, sP + 3 * l, eP + 3 * l, le + 3 * l, valid, r, J);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float w = valid ? tstudent(fabsf(r[e]), sigma) : 0.0f;
          accumulate(acc, w, J[e], r[e]);
        }
      }
    }
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      float x = acc[v];
      for (int s = 16; s > 0; s >>= 1) x += __shfl_xor_sync(0xffffffffu, x, s);
      if (lane == 0) red[warp][v] = x;
    }
    __syncthreads();
    if (tid < NV) {
      float x = 0.0f;
      for (int w = 0; w < NWARP; ++w) x += red[w][tid];
      tot[tid] = x;
    }
    __syncthreads();
    // 4. damped 6 x 6 solve and the left update, on one thread
    if (tid == 0) {
      float A[6][7];
      int o = 0;
      for (int p = 0; p < 6; ++p)
        for (int q = p; q < 6; ++q) {
          A[p][q] = A[q][p] = tot[o++];
        }
      for (int p = 0; p < 6; ++p) {
        A[p][p] += 1e-6f;
        A[p][6] = tot[21 + p];
      }
      solve6(A);
      float dxi[6];
      bool finite = true;
      for (int p = 0; p < 6; ++p) {
        dxi[p] = -A[p][6];
        finite = finite && isfinite(dxi[p]);
      }
      if (finite) exp_left(dxi, T);
    }
    __syncthreads();
  }
  if (tid < 16) Tout[(size_t)b * 16 + tid] = T[tid];
}

}  // namespace

extern "C" {

// T0 (B, 4, 4); points P (B, K, 3), uv (B, K, 2), mask (B, K) u8; lines
// sP, eP, le (B, L, 3), mask (B, L) u8 -> T (B, 4, 4) after n_iters robust
// GN iterations. S: power of two >= K + 2L, at most 8192.
int pose_gn_iters(const float* T0, const float* P, const float* uv,
                  const uint8_t* pmask, const float* sP, const float* eP,
                  const float* le, const uint8_t* lmask, float* T, int B,
                  int K, int L, int S, int n_iters, float fx, float fy,
                  float cx, float cy, cudaStream_t stream) {
  Cam cam{fx, fy, cx, cy};
  pose_gn_kernel<<<B, NT, S * sizeof(float), stream>>>(
      T0, P, uv, pmask, sP, eP, le, lmask, T, K, L, S, n_iters, cam);
  return (int)cudaGetLastError();
}

}  // extern "C"
