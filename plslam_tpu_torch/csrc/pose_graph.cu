// Kernel M: the SE(3) pose-graph Gauss-Newton solve (K18), dense and PCG.
//
// Replaces plslam_tpu/loop/pose_graph.py::edge_residuals (:89),
// _optimize_dense (:109) and _optimize_pcg (:175). Per edge e = (i, j, Tm, w)
// the residual is r = log(Tm^-1 Ti^-1 Tj) (core/lie.py's log_se3, with its
// near-pi branch), the Jacobians Ji = -Ad(Tm^-1) and Jj = I. The reference
// scatter-adds the 6 x 6 blocks into a dense (6F)^2 system (dense) or applies
// H matrix-free through one-hot incidence matmuls (PCG, a TPU idiom).
//
// Bound: latency, then operations. A closure's graph is small (F = 64..512
// slots, E = 4F edges, 12 GN iterations): an edge is ~600 flops, the dense
// assembly 36 x 2 multiply-adds per edge, a CG step ~130 flops per edge.
// What costs is the chain of dependent steps, so the launches are few and
// every sum has one fixed order (no float atomics: edge pairs repeat, and the
// reference's CPU scatter-adds sum them in edge order).
//
//   pg_edges     edge_ctas(E) CTAs of 256 threads, 32 edge slots each
//                (a lane of warp 0 an edge, the other warps beside it): r
//                of every edge, in one mode Ji too, and the cost sum
//                w |r|^2 (each CTA's partial in thread order, then the
//                last CTA to finish adds the partials in CTA order: the
//                cost decides the accept test c_new <= c). A solve
//                launches it once, with Ji.
//   pg_assemble  dense, once a solve, one CTA per slot i: its 6 rows of H
//                (6F wide) and g_i, from the node's edge lists in edge
//                order, in the reference's four scatter phases (Hii over
//                edges leaving i; w I over edges entering i; the
//                off-diagonal blocks w Ji^T and w Ji), then the pins and the
//                1e-5 + 1e-6 diagonal; the touched blocks in shared memory
//                while four warps stream the zeros. The (6F)^2 solve stays
//                the library's: H's LU once a solve and a solve from it each
//                step, the bits of torch.linalg.solve_ex (the reference
//                calls jnp.linalg.solve).
//   pg_blocks    PCG, once a solve, one CTA per slot: g_i and the exact
//                6 x 6 diagonal block of H (its inverse stays
//                torch.linalg.inv_ex, once a solve, as the reference calls
//                jnp.linalg.inv).
//   pg_pcg       PCG, one thread-block cluster (sm_90) runs the whole fixed
//                cg_iters schedule of one GN step: each CTA owns a range of
//                nodes and of used edges, stages their Ji rows, Minv blocks
//                and lists in its shared memory once, and the CG steps read
//                the other CTAs' p, z and edge products through distributed
//                shared memory (see pg_pcg_kernel). One CTA up to F = 128
//                (E = 512), 2 at F = 256, 4 at F = 512. The ok gate, alpha
//                and beta follow the reference.
//   pg_update    the same CTAs: T <- T exp(dx) on valid slots (each CTA a
//                range of slots), every edge's residual at the trial poses
//                (an end node's trial pose recomputed by the same
//                function), the trial cost in the same two-level order,
//                then (a cooperative launch, one grid barrier) in every
//                CTA the accept (finite and c_new <= c): on a reject each
//                CTA restores its old poses and residuals into the
//                outputs. The residuals it hands on are the ones the next
//                GN step needs, and so is the gradient there, in
//                pg_assemble's or pg_blocks' order.
//
// Launches per solve: one pg_edges (r, Ji and the first cost; Ji depends
// only on the edges' measurements, so it serves the whole solve), one
// pg_assemble (dense) or pg_blocks (PCG): H or its diagonal blocks depend
// only on Ji, w and the pins, so they too serve the whole solve (with the
// library's LU or batched 6 x 6 inverse, once); then per GN iteration
// dense 1 (pg_update) + the library's solve from the LU, PCG 2 (pg_pcg,
// pg_update): 14 dense, 26 PCG at 12 iterations (25 and 37 while H was
// built every step).

#include <algorithm>
#include <cooperative_groups.h>
#include <initializer_list>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr float kEps = 1e-8f;

// C = A B, 4 x 4 row-major, each entry summed over k = 0..3 in order
__device__ void mm4(const float* A, const float* B, float* C) {
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j) {
      float s = 0.0f;
      for (int k = 0; k < 4; ++k) s += A[i * 4 + k] * B[k * 4 + j];
      C[i * 4 + j] = s;
    }
}

// rigid inverse (R^T, -R^T t), as core/lie.py::inverse_se3
__device__ void inv_se3(const float* T, float* O) {
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) O[i * 4 + j] = T[j * 4 + i];
    O[i * 4 + 3] =
        -(T[0 * 4 + i] * T[3] + T[1 * 4 + i] * T[7] + T[2 * 4 + i] * T[11]);
  }
  O[12] = O[13] = O[14] = 0.0f;
  O[15] = 1.0f;
}

__device__ void sinc_terms(float th2, float* A, float* B, float* C) {
  const bool small = th2 < 1e-4f;
  const float t2 = small ? 1.0f : th2, t = sqrtf(t2);
  *A = small ? 1.0f - th2 / 6.0f : sinf(t) / t;
  *B = small ? 0.5f - th2 / 24.0f : (1.0f - cosf(t)) / t2;
  *C = small ? 1.0f / 6.0f - th2 / 120.0f : (1.0f - *A) / t2;
}

__device__ void skew_sq(const float* w, float W[3][3], float W2[3][3]) {
  W[0][0] = 0.f; W[0][1] = -w[2]; W[0][2] = w[1];
  W[1][0] = w[2]; W[1][1] = 0.f; W[1][2] = -w[0];
  W[2][0] = -w[1]; W[2][1] = w[0]; W[2][2] = 0.f;
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      W2[i][j] = W[i][0] * W[0][j] + W[i][1] * W[1][j] + W[i][2] * W[2][j];
}

// core/lie.py::log_so3 with its small-angle and near-pi branches
__device__ void log_so3(const float* T, float* w) {
  const float R[3][3] = {{T[0], T[1], T[2]}, {T[4], T[5], T[6]},
                         {T[8], T[9], T[10]}};
  const float trace = R[0][0] + R[1][1] + R[2][2];
  const float cos_t = fminf(fmaxf((trace - 1.0f) * 0.5f, -1.0f), 1.0f);
  const float theta = acosf(cos_t);
  const float v[3] = {R[2][1] - R[1][2], R[0][2] - R[2][0], R[1][0] - R[0][1]};
  if (!(cos_t < -0.99f)) {
    const float sin_t = sinf(theta);
    const float safe = fabsf(sin_t) < kEps ? 1.0f : sin_t;
    const float sc = theta < 1e-5f ? 0.5f + theta * theta / 12.0f
                                   : theta / (2.0f * safe);
    for (int a = 0; a < 3; ++a) w[a] = sc * v[a];
    return;
  }
  const float s =
      fminf(fmaxf(0.5f * sqrtf(v[0] * v[0] + v[1] * v[1] + v[2] * v[2]), 0.0f),
            1.0f);
  const float theta_pi = 3.14159265358979323846f - asinf(s);
  const float one_mc = fmaxf(1.0f - cos_t, kEps);
  float n_abs[3];
  for (int a = 0; a < 3; ++a)
    n_abs[a] = sqrtf(fminf(fmaxf((R[a][a] - cos_t) / one_mc, 0.0f), 1.0f));
  int k = 0;
  for (int a = 1; a < 3; ++a)
    if (n_abs[a] > n_abs[k]) k = a;  // first maximum, as argmax
  float axis[3];
  for (int j = 0; j < 3; ++j) {
    const float rs = R[k][j] + R[j][k];
    axis[j] = n_abs[j] * ((j == k || rs >= 0.0f) ? 1.0f : -1.0f);
  }
  const float nrm = fmaxf(
      sqrtf(axis[0] * axis[0] + axis[1] * axis[1] + axis[2] * axis[2]), kEps);
  float dot = 0.0f;
  for (int j = 0; j < 3; ++j) {
    axis[j] = axis[j] / nrm;
    dot += axis[j] * v[j];
  }
  const float sg = dot < 0.0f ? -1.0f : 1.0f;
  for (int j = 0; j < 3; ++j) w[j] = theta_pi * axis[j] * sg;
}

// core/lie.py::log_se3: (V^-1 t, w)
__device__ void log_se3(const float* T, float* xi) {
  float w[3];
  log_so3(T, w);
  const float th2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
  float A, B, C, W[3][3], W2[3][3];
  sinc_terms(th2, &A, &B, &C);
  skew_sq(w, W, W2);
  const bool small = th2 < 1e-4f;
  const float t2 = small ? 1.0f : th2;
  const float coef =
      small ? 1.0f / 12.0f + th2 / 720.0f : (1.0f - A / (2.0f * B)) / t2;
  const float t[3] = {T[3], T[7], T[11]};
  for (int i = 0; i < 3; ++i) {
    float s = 0.0f;
    for (int j = 0; j < 3; ++j) {
      const float Vi = (i == j ? 1.0f : 0.0f) - 0.5f * W[i][j] + coef * W2[i][j];
      s += Vi * t[j];
    }
    xi[i] = s;
    xi[3 + i] = w[i];
  }
}

// core/lie.py::exp_se3
__device__ void exp_se3(const float* xi, float* E) {
  const float w[3] = {xi[3], xi[4], xi[5]};
  const float th2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
  float A, B, C, W[3][3], W2[3][3];
  sinc_terms(th2, &A, &B, &C);
  skew_sq(w, W, W2);
  for (int i = 0; i < 3; ++i) {
    float t = 0.0f;
    for (int j = 0; j < 3; ++j) {
      const float e = i == j ? 1.0f : 0.0f;
      E[i * 4 + j] = e + A * W[i][j] + B * W2[i][j];
      t += (e + B * W[i][j] + C * W2[i][j]) * xi[j];
    }
    E[i * 4 + 3] = t;
  }
  E[12] = E[13] = E[14] = 0.0f;
  E[15] = 1.0f;
}

struct Graph {
  const float* poses;  // (F, 16)
  const int* ei;
  const int* ej;
  const float* eT;  // (E, 16)
  const float* ew;
  int F, E;
};

// -- the edge sweep: pg_edges and pg_update -----------------------------------
//
// CTA b of edge_ctas(E) owns the edge slots [32 b, 32 b + 32), a lane of
// warp 0 each, and in pg_update the pose slots [b NC, (b + 1) NC), NC =
// ceil(F / CTAs); loop/pose_graph.py::edge_layout and edge_partition
// mirror it. An edge is a chain of dependent steps (~250: two inverses,
// two 4 x 4 products, the log's acos, sin and divisions), so the CTA's
// warps take the other chains beside it: the loads of the edges' Tm rows
// (64 bytes each, 16-byte loads into shared memory) while warp 0 loads the
// ends and their poses (16-byte loads); in pg_edges warp 1 forms the Ji
// rows while warp 0 forms the residuals; in pg_update warps 1 and 2 form
// the edges' end poses at the trial step, warps 3-4 the CTA's own slots'
// trial poses and, with a gradient, warps 5-7 stage the edges' Ji rows and
// the slots' list entries, then warp 0 the residuals. r (24 bytes an edge) and
// Ji (144) leave through shared memory in 16-byte stores: a warp's global
// accesses are contiguous. Unused slots (w <= 0) skip the residual and
// write r = 0; their Ji is written as for any slot (it depends only on
// Tm). The cost: each CTA's partial in thread order; then in pg_edges the
// last CTA to finish (a counter after a fence, which that CTA sets back to
// 0 for the next launch), in pg_update every CTA after a grid barrier (the
// same counter), adds the partials in CTA order. No float atomics: the
// cost is the same bits in every run and every CTA, and a CUDA graph may
// replay the launch. On a rejected step each pg_update CTA writes back its
// own slots' old poses and edges' old residuals.

constexpr int EDGE_SLOTS = 32;  // edge slots a CTA, a lane of warp 0 each
constexpr int EDGE_NT = 256;    // threads a CTA: warps 1-7 take the rest

inline int edge_ctas(int E) {
  return std::max(1, (E + EDGE_SLOTS - 1) / EDGE_SLOTS);
}

// r = log(Tm^-1 Ti^-1 Tj): the one evaluation of an edge that pg_edges and
// pg_update share, not inlined, so the residuals pg_update hands on are the
// bits pg_edges gives at the same poses
__device__ __noinline__ void edge_residual(const float* Tm, const float* Ti,
                                           const float* Tj, float* r) {
  float Tm_inv[16], Ti_inv[16], A[16], B[16];
  inv_se3(Tm, Tm_inv);
  inv_se3(Ti, Ti_inv);
  mm4(Tm_inv, Ti_inv, A);
  mm4(A, Tj, B);
  log_se3(B, r);
}

// Ji = -Ad(Tm^-1) (6 x 6 row-major), Ad(T) = [[R, skew(t) R], [0, R]]
__device__ void edge_jac(const float* Tm, float* J) {
  float M[16];
  inv_se3(Tm, M);
  const float t[3] = {M[3], M[7], M[11]};
  const float S[3][3] = {{0.f, -t[2], t[1]}, {t[2], 0.f, -t[0]},
                         {-t[1], t[0], 0.f}};
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      const float Rij = M[i * 4 + j];
      const float SR = S[i][0] * M[0 * 4 + j] + S[i][1] * M[1 * 4 + j] +
                       S[i][2] * M[2 * 4 + j];
      J[i * 6 + j] = -Rij;
      J[i * 6 + 3 + j] = -SR;
      J[(3 + i) * 6 + j] = -0.0f;
      J[(3 + i) * 6 + 3 + j] = -Rij;
    }
}

// a 4 x 4 pose at a 16-byte aligned address
__device__ __forceinline__ void load16(const float* p, float* T) {
  const float4* q = reinterpret_cast<const float4*>(p);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float4 v = q[k];
    T[4 * k] = v.x;
    T[4 * k + 1] = v.y;
    T[4 * k + 2] = v.z;
    T[4 * k + 3] = v.w;
  }
}

__device__ __forceinline__ void store16(float* p, const float* T) {
  float4* q = reinterpret_cast<float4*>(p);
#pragma unroll
  for (int k = 0; k < 4; ++k)
    q[k] = make_float4(T[4 * k], T[4 * k + 1], T[4 * k + 2], T[4 * k + 3]);
}

// six floats at an 8-byte aligned address
__device__ __forceinline__ void load6(const float* p, float v[6]) {
  const float2* q = reinterpret_cast<const float2*>(p);
  const float2 a = q[0], b = q[1], c = q[2];
  v[0] = a.x;
  v[1] = a.y;
  v[2] = b.x;
  v[3] = b.y;
  v[4] = c.x;
  v[5] = c.y;
}

__device__ __forceinline__ void store6(float* p, const float v[6]) {
  float2* q = reinterpret_cast<float2*>(p);
  q[0] = make_float2(v[0], v[1]);
  q[1] = make_float2(v[2], v[3]);
  q[2] = make_float2(v[4], v[5]);
}

// T exp(scale step) of slot n (a zero step on an invalid slot): the pose
// pg_update's node pass writes and the one its edge pass forms for an end
// node, the same function, so the same bits
__device__ __noinline__ void trial_pose(const float* poses, const float* step,
                                        const uint8_t* valid, float scale,
                                        int n, float* T) {
  float xi[6], E[16], P[16];
  for (int a = 0; a < 6; ++a)
    xi[a] = valid[n] ? scale * step[(size_t)n * 6 + a] : 0.0f;
  exp_se3(xi, E);
  load16(poses + (size_t)n * 16, P);
  mm4(P, E, T);
}

// n floats between 16-byte aligned addresses by the caller's threads t =
// 0 .. nt - 1: B 16-byte loads a thread in flight before their stores
template <int B>
__device__ __forceinline__ void copy_floats(float* __restrict__ dst,
                                            const float* __restrict__ src,
                                            int n, int t, int nt) {
  const int n4 = n >> 2;
  const float4* s4 = reinterpret_cast<const float4*>(src);
  float4* d4 = reinterpret_cast<float4*>(dst);
  for (int k0 = t; k0 < n4; k0 += B * nt) {
    float4 v[B];
#pragma unroll
    for (int i = 0; i < B; ++i)
      if (k0 + i * nt < n4) v[i] = s4[k0 + i * nt];
#pragma unroll
    for (int i = 0; i < B; ++i)
      if (k0 + i * nt < n4) d4[k0 + i * nt] = v[i];
  }
  for (int k = 4 * n4 + t; k < n; k += nt) dst[k] = src[k];
}

__device__ __forceinline__ void fence_acq_rel_gpu() {
  asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
}

struct Sweep {
  const float* poses;  // (F, 16)
  const int* ei;
  const int* ej;
  const float* eT;  // (E, 16)
  const float* ew;
  float* r;           // (E, 6) out
  float* partial;     // (CTAs,) scratch
  unsigned* count;    // 0 before and after every launch
  int F, E;
};

// Warp 0's lane l < n after the staging barrier: r of the CTA's edge l
// (zero where w <= 0) into sR, w |r|^2 into sc
__device__ void sweep_residuals(const float* sT, const float* Ti,
                                const float* Tj, float w, float* sR,
                                float* sc, int n) {
  const int l = threadIdx.x;
  if (l < n) {
    float r[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    if (w > 0.0f) edge_residual(sT + l * 16, Ti, Tj, r);
    float q = 0.0f;
    for (int a = 0; a < 6; ++a) q += r[a] * r[a];
    sc[l] = w * q;
    for (int a = 0; a < 6; ++a) sR[l * 6 + a] = r[a];
  }
}

// thread 0: the CTA's partial of the cost, sc[0 .. n) in thread order
__device__ __forceinline__ void write_partial(const Sweep& s, const float* sc,
                                              int n) {
  float p = 0.0f;
  for (int i = 0; i < n; ++i) p += sc[i];
  s.partial[blockIdx.x] = p;
}

// the CTAs' partials added in CTA order by thread 0 into *total (shared),
// every thread past its barrier
__device__ void sum_partials(const Sweep& s, float* sp, float* total) {
  const int tid = threadIdx.x;
  float c = 0.0f;
  for (int b0 = 0; b0 < (int)gridDim.x; b0 += EDGE_NT) {
    const int m = min(EDGE_NT, (int)gridDim.x - b0);
    if (tid < m) sp[tid] = __ldcg(s.partial + b0 + tid);
    __syncthreads();
    if (tid == 0)
      for (int b = 0; b < m; ++b) c += sp[b];
    __syncthreads();
  }
  if (tid == 0) *total = c;
  __syncthreads();
}

// The cost. After a CTA barrier (every thread's stores before it), thread
// 0 writes the CTA's partial (sc[0 .. n) in thread order), a release
// fence, and counts the CTA in; the last CTA to count (an acquire fence)
// loads the partials, a thread each, into sp, and thread 0 adds them in
// CTA order into *total. Returns, for every thread, whether this CTA is the
// last. (A fence by one thread after the barrier, as CUTLASS's split-K
// semaphore: the barrier orders the CTA's stores before it.)
__device__ bool sweep_total(const Sweep& s, const float* sc, int n,
                            float* sp, float* total, int* s_last) {
  const int tid = threadIdx.x;
  __syncthreads();
  if (tid == 0) {
    write_partial(s, sc, n);
    fence_acq_rel_gpu();
    const bool last = atomicAdd(s.count, 1u) == gridDim.x - 1;
    if (last) {
      *s.count = 0;
      fence_acq_rel_gpu();
    }
    *s_last = last;
  }
  __syncthreads();
  if (!*s_last) return false;
  sum_partials(s, sp, total);
  return true;
}

template <bool JAC>
__global__ void __launch_bounds__(EDGE_NT)
    pg_edges_kernel(Sweep s, float* J_out, float* cost) {
  __shared__ __align__(16) float sT[EDGE_SLOTS * 16];
  __shared__ __align__(16) float sR[EDGE_SLOTS * 6];
  __shared__ __align__(16) float sJ[JAC ? EDGE_SLOTS * 36 : 4];
  __shared__ float sc[EDGE_SLOTS], sp[EDGE_NT], s_total;
  __shared__ int s_last;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int e0 = blockIdx.x * EDGE_SLOTS, n = min(EDGE_SLOTS, s.E - e0);
  float Ti[16], Tj[16], w = 0.0f;
  if (warp == 0) {  // the ends' poses
    if (lane < n) {
      const int e = e0 + lane;
      w = s.ew[e];
      if (w > 0.0f) {
        load16(s.poses + (size_t)s.ei[e] * 16, Ti);
        load16(s.poses + (size_t)s.ej[e] * 16, Tj);
      }
    }
  } else {  // the Tm rows
    copy_floats<1>(sT, s.eT + (size_t)e0 * 16, n * 16, tid - 32,
                   EDGE_NT - 32);
  }
  __syncthreads();
  if (warp == 0)
    sweep_residuals(sT, Ti, Tj, w, sR, sc, n);
  else if (JAC && warp == 1 && lane < n)
    edge_jac(sT + lane * 16, sJ + lane * 36);
  __syncthreads();
  copy_floats<1>(s.r + (size_t)e0 * 6, sR, n * 6, tid, EDGE_NT);
  if (JAC) copy_floats<2>(J_out + (size_t)e0 * 36, sJ, n * 36, tid, EDGE_NT);
  if (sweep_total(s, sc, n, sp, &s_total, &s_last) && tid == 0)
    *cost = s_total;
}

// node lists: edges leaving n are oi[pi[n] .. pi[n+1]), entering n are
// oj[pj[n] .. pj[n+1]), each in edge order
struct Incidence {
  const int* oi;
  const int* pi;
  const int* oj;
  const int* pj;
};

// -- the normal equations once a solve: pg_assemble and pg_blocks -----------
//
// H, its diagonal blocks and the first g depend on the residuals only
// through g: Ji, w and the pins are fixed for a solve, so a solve builds
// them once (after pg_edges) and each GN step's pg_update computes only the
// next g. The sums keep the reference's scatter order, as the kernels that
// built them every step did; every product-add is one fmaf, as nvcc's
// contraction compiled those kernels' `x += a * b`:
//   Hii[p][q] = sum over edges leaving i (list order) of w d, d = sum_a
//               Ji[a][p] Ji[a][q]; dense: then + w over the entering edges
//               into the same sum (PCG: wj, a sum of its own, added after)
//   dense H   a band of zeros, + Hii on the diagonal block, then for each
//             leaving edge (i, j) H[i][j][p][q] += w Ji[q][p], then for each
//             entering edge (j, i) H[i][j][p][q] += w Ji[p][q], then the
//             diagonal + diag[i]
//   PCG Hd    Hii + wj e + diag e (e the identity's entry)
//   g[p]      d = sum_a Ji[a][p] r[a] over the leaving edges, w d summed in
//             list order, then w r[p] over the entering edges: dense in the
//             same sum, PCG in a sum of its own, g = gi + gj
// One CTA a slot. Its building threads (dense: the first NORMAL_CT, four
// warps with a barrier of their own; PCG: all 2 NORMAL_CT) build the sums:
// the first NORMAL_CH entries of both lists go to shared memory together
// (the edge ids, then w, the other end, Ji and r, 16-byte loads), then any
// further chunk; the threads compute the entries' d in parallel, and the
// 36 + 6 sums run down the staged entries in order. Dense: four more warps
// stream the slot's six rows of H (one contiguous, 16-byte aligned run of
// 36F floats) out as zeros meanwhile; the blocks the rows touch (the
// diagonal, each neighbour's) are summed in shared memory, at a slot of
// their own (a table of F block slots, claimed as the lists are staged),
// and written over the zeros after a barrier of the whole CTA. Past
// NORMAL_BLOCKS distinct blocks (a hub) a block is summed in H itself after
// that barrier, its entries walked again in the same order.
// Bound: the band's bytes (144F a slot, 37.7 MB at F = 512) at the store
// rate at large F, where every byte leaves once; at small F the chain of
// dependent loads (list offsets, edge ids, the entries).

constexpr int NORMAL_CT = 128;             // threads that build the sums
constexpr int NORMAL_CH = 32;              // list entries staged at once
constexpr int NORMAL_BLOCKS = 64;          // 6 x 6 blocks in shared memory
// a staged chunk: Ji, r, w, the other end and (dense) its block slot; the
// leaving chunk also d and the gradient's d (36 + 6)
constexpr int NORMAL_STAGE_E = NORMAL_CH * (36 + 6 + 3);
constexpr int NORMAL_STAGE_L = NORMAL_STAGE_E + NORMAL_CH * (36 + 6);
// dense: the blocks, their block columns and the count
constexpr int NORMAL_DENSE = NORMAL_BLOCKS * 37 + 1;

// 32-bit words of pg_assemble's (dense) or pg_blocks' shared memory
__host__ __device__ inline size_t normal_words(int F, bool dense) {
  return NORMAL_STAGE_L + NORMAL_STAGE_E + (dense ? NORMAL_DENSE + F : 0);
}

struct Staged {
  float* J;  // CH x 36
  float* R;  // CH x 6
  float* W;  // CH
  int* O;    // CH: the other end
  int* S;    // CH: dense, the other end's block slot
  float* D;  // CH x 36 (leaving only)
  float* G;  // CH x 6 (leaving only)
  __device__ Staged(float* s, bool leaving) {
    J = s;
    R = J + NORMAL_CH * 36;
    W = R + NORMAL_CH * 6;
    O = (int*)(W + NORMAL_CH);
    S = O + NORMAL_CH;
    D = leaving ? (float*)(S + NORMAL_CH) : nullptr;
    G = leaving ? D + NORMAL_CH * 36 : nullptr;
  }
};

// the building warps' barrier (nt threads)
__device__ __forceinline__ void build_sync(int nt) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(nt) : "memory");
}

// nl leaving entries from position sl0 into L and ne entering entries from
// se0 into E (the caller's barrier after): 9 float4 pieces of Ji, r and
// (w, other end) an entry, a task a building thread (nt of them)
__device__ void stage_entries(const Graph& g, const Incidence& inc,
                              const float* J, const float* r, int sl0,
                              int nl, Staged L, int se0, int ne, Staged E,
                              int nt) {
  for (int k = threadIdx.x; k < (nl + ne) * 11; k += nt) {
    const bool lv = k < nl * 11;
    const int kk = lv ? k : k - nl * 11, l = kk / 11, part = kk - l * 11;
    const int e = lv ? inc.oi[sl0 + l] : inc.oj[se0 + l];
    if (part < 9) {
      reinterpret_cast<float4*>((lv ? L.J : E.J) + l * 36)[part] =
          reinterpret_cast<const float4*>(J + (size_t)e * 36)[part];
    } else if (part == 9) {
      float v[6];
      load6(r + (size_t)e * 6, v);
      float* R = (lv ? L.R : E.R) + l * 6;
      for (int a = 0; a < 6; ++a) R[a] = v[a];
    } else {
      (lv ? L.W : E.W)[l] = g.ew[e];
      (lv ? L.O : E.O)[l] = lv ? g.ej[e] : g.ei[e];
    }
  }
}

// the staged leaving entries' d of Hii (36 an entry) and of g (6), every
// building thread, each d in the order over a
__device__ void entry_products(Staged st, int n, int nt) {
  for (int k = threadIdx.x; k < n * 42; k += nt) {
    const int l = k / 42, t = k - l * 42;
    const float* Je = st.J + l * 36;
    float d = 0.0f;
    if (t < 36) {
      const int p = t / 6, q = t - p * 6;
      for (int a = 0; a < 6; ++a) d = fmaf(Je[a * 6 + p], Je[a * 6 + q], d);
      st.D[l * 36 + t] = d;
    } else {
      const int p = t - 36;
      for (int a = 0; a < 6; ++a) d = fmaf(Je[a * 6 + p], st.R[l * 6 + a], d);
      st.G[l * 6 + p] = d;
    }
  }
}

// dense: the block slot of block column j, claimed at its first entry (a
// slot past NORMAL_BLOCKS: summed in H itself)
__device__ __forceinline__ void claim_block(int* slot_of, int* col_of,
                                            int* n_slots, int j) {
  if (atomicCAS(&slot_of[j], -1, -2) == -1) {
    const int b = atomicAdd(n_slots, 1);
    if (b < NORMAL_BLOCKS) col_of[b] = j;
    slot_of[j] = b;
  }
}

// dense: the off-diagonal phases, thread (p, q) < 36 owning entry (p, q) of
// every block: H[i][j] += w Ji^T over the leaving entries, then += w Ji
// over the entering ones (edge j -> i), each list in order, on the shared
// blocks (global false) or on the blocks past NORMAL_BLOCKS in H (true);
// a list longer than a chunk is staged again
__device__ void band_phases(const Graph& g, const Incidence& inc,
                            const float* J, const float* r, Staged sl,
                            Staged se, const int* slot_of, float* blk,
                            float* band, int a0, int a1, int b0, int b1,
                            bool global) {
  const int tid = threadIdx.x, p = tid / 6, q = tid - p * 6;
  const size_t F6 = 6 * (size_t)g.F;
  for (int pass = 0; pass < 2; ++pass) {
    const int c0 = pass ? b0 : a0, c1 = pass ? b1 : a1;
    const float* sJ = pass ? se.J : sl.J;
    const float* sW = pass ? se.W : sl.W;
    const int* sO = pass ? se.O : sl.O;
    int* sS = pass ? se.S : sl.S;
    // Ji^T (leaving) or Ji (entering): entry (p, q) of the block
    const int jx = pass ? p * 6 + q : q * 6 + p;
    for (int s = c0; s < c1; s += NORMAL_CH) {
      const int n = min(NORMAL_CH, c1 - s);
      build_sync(NORMAL_CT);
      if (c1 - c0 > NORMAL_CH) {
        stage_entries(g, inc, J, r, s, pass ? 0 : n, sl, s, pass ? n : 0,
                      se, NORMAL_CT);
        build_sync(NORMAL_CT);
      }
      for (int l = tid; l < n; l += NORMAL_CT) sS[l] = slot_of[sO[l]];
      build_sync(NORMAL_CT);
      if (tid < 36)
        for (int l = 0; l < n; ++l) {
          const int b = sS[l];
          if ((b >= NORMAL_BLOCKS) != global) continue;
          float* d = global ? band + p * F6 + 6 * sO[l] + q
                            : blk + b * 36 + tid;
          *d = fmaf(sW[l], sJ[l * 36 + jx], *d);
        }
    }
  }
}

// slot i's Hii and g sums (and, dense, its band of H) or Hd and g
template <bool DENSE>
__device__ void normal_slot(const Graph& g, const Incidence& inc,
                            const float* __restrict__ r,
                            const float* __restrict__ J,
                            const float* __restrict__ diag, float* out,
                            float* gvec) {
  extern __shared__ __align__(16) float sm[];
  const int i = blockIdx.x, tid = threadIdx.x;
  const int nt = DENSE ? NORMAL_CT : blockDim.x;  // the building threads
  const int F6 = 6 * g.F;
  const Staged sl(sm, true);
  const Staged se(sm + NORMAL_STAGE_L, false);
  float* blk = sm + NORMAL_STAGE_L + NORMAL_STAGE_E;  // dense: 64 x 36
  int* col_of = (int*)(blk + NORMAL_BLOCKS * 36);
  int* n_slots = col_of + NORMAL_BLOCKS;
  int* slot_of = n_slots + 1;                         // F
  float* band = out + (size_t)6 * i * F6;
  const int a0 = inc.pi[i], a1 = inc.pi[i + 1];
  const int b0 = inc.pj[i], b1 = inc.pj[i + 1];
  if (DENSE && tid >= NORMAL_CT) {  // the zeros
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int k = tid - NORMAL_CT; k < 9 * g.F; k += blockDim.x - NORMAL_CT)
      reinterpret_cast<float4*>(band)[k] = z;
  } else {
    if (DENSE) {
      for (int k = tid; k < NORMAL_BLOCKS * 36; k += nt) blk[k] = 0.0f;
      for (int k = tid; k < g.F; k += nt) slot_of[k] = k == i ? 0 : -1;
      if (tid == 0) {
        col_of[0] = i;
        *n_slots = 1;
      }
    }
    stage_entries(g, inc, J, r, a0, min(NORMAL_CH, a1 - a0), sl, b0,
                  min(NORMAL_CH, b1 - b0), se, nt);
    build_sync(nt);
    const int p = tid / 6, q = tid - p * 6;  // tid < 36: Hii[p][q]
    const int pg = tid - 36;                 // 36 <= tid < 42: g[pg]
    float hii = 0.0f, wj = 0.0f, gi = 0.0f, gj = 0.0f;
    for (int s = a0; s < a1; s += NORMAL_CH) {  // edges leaving i
      const int n = min(NORMAL_CH, a1 - s);
      if (s != a0) {
        build_sync(nt);
        stage_entries(g, inc, J, r, s, n, sl, 0, 0, se, nt);
        build_sync(nt);
      }
      if (DENSE)
        for (int k = tid; k < n; k += nt)
          claim_block(slot_of, col_of, n_slots, sl.O[k]);
      entry_products(sl, n, nt);
      build_sync(nt);
      if (tid < 36)
        for (int l = 0; l < n; ++l)
          hii = fmaf(sl.W[l], sl.D[l * 36 + tid], hii);
      else if (tid < 42)
        for (int l = 0; l < n; ++l) gi = fmaf(sl.W[l], sl.G[l * 6 + pg], gi);
    }
    for (int s = b0; s < b1; s += NORMAL_CH) {  // edges entering i
      const int n = min(NORMAL_CH, b1 - s);
      if (s != b0) {
        build_sync(nt);
        stage_entries(g, inc, J, r, 0, 0, sl, s, n, se, nt);
        build_sync(nt);
      }
      if (DENSE)
        for (int k = tid; k < n; k += nt)
          claim_block(slot_of, col_of, n_slots, se.O[k]);
      if (tid < 36 && p == q) {
        for (int l = 0; l < n; ++l) {
          if (DENSE) hii += se.W[l];
          else wj += se.W[l];
        }
      } else if (tid >= 36 && tid < 42) {
        for (int l = 0; l < n; ++l) {
          if (DENSE) gi = fmaf(se.W[l], se.R[l * 6 + pg], gi);
          else gj = fmaf(se.W[l], se.R[l * 6 + pg], gj);
        }
      }
    }
    if (tid >= 36 && tid < 42) gvec[(size_t)i * 6 + pg] = DENSE ? gi : gi + gj;
    if (!DENSE) {
      if (tid < 36) {
        const float e = p == q ? 1.0f : 0.0f;
        out[(size_t)i * 36 + tid] = hii + wj * e + diag[i] * e;
      }
      return;
    }
    // the band's shared blocks in the order of the reference's phases (the
    // barriers in band_phases: every entry's block slot claimed first)
    if (tid < 36) blk[tid] = blk[tid] + hii;
    band_phases(g, inc, J, r, sl, se, slot_of, blk, band, a0, a1, b0, b1,
                false);
    if (tid < 36 && p == q) blk[tid] = blk[tid] + diag[i];
  }
  __syncthreads();  // the zeros and the shared blocks are done
  if (*n_slots > NORMAL_BLOCKS && tid < NORMAL_CT)
    band_phases(g, inc, J, r, sl, se, slot_of, blk, band, a0, a1, b0, b1,
                true);
  // the shared blocks over the zeros, a row of six floats in three float2
  const int nb = min(*n_slots, NORMAL_BLOCKS);
  for (int k = tid; k < nb * 18; k += blockDim.x) {
    const int b = k / 18, t = k - b * 18, pr = t / 3, h = t - pr * 3;
    reinterpret_cast<float2*>(band + (size_t)pr * F6 + 6 * col_of[b])[h] =
        reinterpret_cast<const float2*>(blk + b * 36 + pr * 6)[h];
  }
}

__global__ void __launch_bounds__(2 * NORMAL_CT)
    pg_assemble_kernel(Graph g, Incidence inc, const float* __restrict__ r,
                       const float* __restrict__ J,
                       const float* __restrict__ diag, float* H, float* gvec) {
  normal_slot<true>(g, inc, r, J, diag, H, gvec);
}

__global__ void __launch_bounds__(2 * NORMAL_CT)
    pg_blocks_kernel(Graph g, Incidence inc, const float* __restrict__ r,
                     const float* __restrict__ J,
                     const float* __restrict__ diag, float* Hd, float* gvec) {
  normal_slot<false>(g, inc, r, J, diag, Hd, gvec);
}

// -- pg_pcg: one thread-block cluster, the CG state in shared memory --------
//
// Cluster size C (pcg_cluster): the smallest power of two up to 16 whose
// CTAs hold their share (below) in shared memory and own at most 128 nodes;
// the same arithmetic as loop/pose_graph.py::pcg_layout. CTA c owns nodes
// [c NC, (c + 1) NC) with NC = ceil(F / C), and the used edges at positions
// [c CE, (c + 1) CE) of the leaving lists oi (CE = ceil(U / C), U used
// edges): contiguous, in edge order within each node's list. At the start
// it stages, once, its edges' Ji rows (cp.async), w and end nodes, its
// nodes' Minv blocks (cp.async), diag, -g and list offsets, the (rank,
// local) address of every entry of its nodes' leaving and entering lists
// (an entering edge's by a binary search in its tail's leaving list), and
// the lanes of pass B. No CG step reads global memory after that. Every
// CTA keeps z and p of all F nodes (p in two buffers, by the step's
// parity): distributed shared memory moves ~5 bytes a cycle an SM for
// scattered 8-byte accesses against ~39 within the CTA
// (tools/cluster_microbench.py, H100 80GB HBM3, 700 W), so the owner of a
// node writes its new z into every CTA once a step (24-byte rows,
// consecutive across threads) and the edge pass reads only local memory.
//
// A CG step, two barriers:
//   A  every CTA writes p = z + beta p_old of all F nodes into its other p
//      buffer; its edges, a thread an edge: p of both ends, t = Ji p_i +
//      p_j and u = w Ji^T t row by row of Ji, v = w t, into the CTA's uv
//      rows (in a cluster, u summed over each warp's run of edges of one
//      tail: pass B pulls one entry a run); p.Hp as H's own sum of squares,
//      sum_e w |t_e|^2 + sum_n diag_n |p_n|^2 (the reference sums p.(H p):
//      the same quantity, rounded otherwise); barrier 1 with the sum
//   B  the owned nodes' (H p)_n = the sum of u over the node's leaving
//      edges and of v over its entering edges (pulled from their owners)
//      + diag p, by a team of T lanes a node (T = 1, 2, ..., 32, the least
//      with at most 4 list entries a lane: lane k of the team takes
//      entries k, k + T, ..., then a fixed butterfly; a hub's list is
//      spread over up to 32 lanes); then the team's first lane: alpha, x
//      += alpha p, r -= alpha H p, z = Minv r into every CTA, r.z;
//      barrier 2 with the sum
// Every sum has one fixed order and no float atomics. A dot product: each
// warp's partial by a shuffle butterfly into one word; after a CTA barrier
// warp 0 adds the CTA's words into one; after the cluster barrier every
// thread adds the C words in rank order, so ok, alpha and beta are the same
// bits in every CTA. A cluster barrier is a CTA barrier and then
// cluster_arrive_wait. A single CTA (C = 1, up to F = 128) compiles without
// the cluster: CTA barriers, plain shared memory. The kernel ends on a
// cluster barrier: no CTA exits while another still reads its memory.

constexpr int PCG_MAX_CLUSTER = 16;
constexpr int PCG_MAX_NODES = 128;          // nodes a CTA
constexpr size_t PCG_SMEM_MAX = 232448;     // dynamic shared memory a CTA

// lane slots of pass B's teams (a team of T lanes takes at most 4 list
// entries a lane, T < d / 2 for d > 4): at most NC + E, whole warps
__host__ __device__ inline size_t pcg_task_slots(int F, int E, int C) {
  return (size_t)((F + C - 1) / C) + E + 32;
}

// 32-bit words of one CTA's shared memory (the same offsets in every CTA)
__host__ __device__ inline size_t pcg_words(int F, int E, int C) {
  const size_t EC = (E + C - 1) / C, NC = (F + C - 1) / C;
  return EC * (36 + 12 + 3) + NC * (36 + 2 * 6 + 1 + 2) + 2 + 18 * (size_t)F +
         2 * (size_t)E + pcg_task_slots(F, E, C) + 96;
}

// the cluster size for F slots and E edge slots, 0 if none fits
inline int pcg_cluster(int F, int E) {
  for (int C = 1; C <= PCG_MAX_CLUSTER; C *= 2)
    if (pcg_words(F, E, C) * 4 <= PCG_SMEM_MAX &&
        ((F + C - 1) / C <= PCG_MAX_NODES || C == PCG_MAX_CLUSTER))
      return C;
  return 0;
}

struct PcgArgs {
  const int* ei;
  const int* ej;
  const float* ew;
  Incidence inc;
  const float* J;
  const float* Minv;
  const float* diag;
  const float* gvec;
  float* dx;
  int F, E, cg_iters;
};

__device__ __forceinline__ float warp_sum(float v) {
  for (int s = 16; s > 0; s >>= 1) v += __shfl_xor_sync(0xffffffffu, v, s);
  return v;
}

// 16 bytes global -> shared, asynchronous where both are 16-byte aligned
__device__ __forceinline__ void stage16(float* dst, const float* src,
                                        bool aligned) {
  if (aligned) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src));
  } else {
    for (int k = 0; k < 4; ++k) dst[k] = src[k];
  }
}

// After a CTA barrier: thread 0's cluster-scope fence (cumulative over the
// CTA's writes that the CTA barrier ordered before it), every thread's
// relaxed arrive, then the aligned wait (tools/cluster_microbench.py times
// the forms). A release arrive by thread 0 alone, in a divergent warp, hung
// the kernel.
__device__ __forceinline__ void cluster_arrive_wait() {
  if (threadIdx.x == 0) asm volatile("fence.acq_rel.cluster;\n" ::: "memory");
  __syncwarp();
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// The cluster, or one CTA (CL false): addresses in another CTA's shared
// memory, barriers, and the cluster-wide sums of the warps' words.
template <bool CL>
struct Team {
  int C, rank, nw;
  float* words;  // two banks of 32 warp words and the CTA's word
  __device__ float* at(float* buf, int r) const {
    if (!CL || r == rank) return buf;
    return cg::this_cluster().map_shared_rank(buf, r);
  }
  __device__ void barrier() const {
    __syncthreads();
    if (CL) cluster_arrive_wait();
  }
  // the sum over the cluster of every thread's v, the same bits everywhere;
  // consecutive sums alternate banks, so a bank is written again only
  // after a barrier that follows every read of it
  __device__ float sum(float v, int bank) const {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    float* word = words + 33 * bank;
    v = warp_sum(v);
    if (lane == 0) word[warp] = v;
    __syncthreads();
    if (!CL) return warp_sum(lane < nw ? word[lane] : 0.0f);
    if (warp == 0) {
      const float s = warp_sum(lane < nw ? word[lane] : 0.0f);
      if (lane == 0) word[32] = s;
    }
    cluster_arrive_wait();
    float s = 0.0f;
    for (int r = 0; r < C; ++r) s += at(word, r)[32];
    return s;
  }
};

// z = M r for a 6 x 6 row-major block at a 16-byte aligned address, each
// row summed over k in order
__device__ __forceinline__ void mat6(const float* M, const float r[6],
                                     float z[6]) {
  const float4* m = reinterpret_cast<const float4*>(M);
  float e[36];
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    const float4 f = m[i];
    e[4 * i] = f.x;
    e[4 * i + 1] = f.y;
    e[4 * i + 2] = f.z;
    e[4 * i + 3] = f.w;
  }
#pragma unroll
  for (int q = 0; q < 6; ++q) {
    float s = 0.0f;
#pragma unroll
    for (int k = 0; k < 6; ++k) s += e[q * 6 + k] * r[k];
    z[q] = s;
  }
}

template <bool CL>
__global__ void __launch_bounds__(1024) pg_pcg_kernel(PcgArgs a) {
  extern __shared__ __align__(16) float sm[];
  const int C = CL ? (int)cg::this_cluster().num_blocks() : 1;
  const int c = CL ? (int)cg::this_cluster().block_rank() : 0;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nw = nt >> 5;
  const int F6 = 6 * a.F;
  const int EC = (a.E + C - 1) / C, NC = (a.F + C - 1) / C;
  float* sJ = sm;                          // EC x 36, Ji rows
  float* sM = sJ + (size_t)EC * 36;        // NC x 36, Minv blocks
  float* uv = sM + (size_t)NC * 36;        // EC x 12: u = w Ji^T t, v = w t
  float* zr = uv + (size_t)EC * 12;        // F x 6: z of every node
  float* pr = zr + F6;                     // 2 x F x 6: p, by step parity
  float* x = pr + 2 * F6;                  // NC x 6 each: x, r
  float* r = x + NC * 6;
  float* dg = r + NC * 6;                  // NC
  float* w = dg + NC;                      // EC
  int* ti = (int*)(w + EC);                // EC: tail node
  int* hj = ti + EC;                       // EC: head node
  int* lst = hj + EC;                      // NC + 1: leaving lists in oi
  int* est = lst + NC + 1;                 // NC + 1: entering lists
  int* refs = est + NC + 1;                // 2E: each owned node's leaving,
                                           // then entering entries: rank
                                           // << 20 | offset of u or v in uv
                                           // << 2 | is v << 1 | whether to
                                           // load it
  int* task = refs + 2 * a.E;              // pass B's lane slots
  const int n_slots = (int)pcg_task_slots(a.F, a.E, C);
  // two banks of 33 words for the sums, pass B's slot count
  const Team<CL> team{C, c, nw, (float*)(task + n_slots)};

  if (CL)
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  // the partition: nodes by NC, used edges by CE positions of oi
  const Incidence& in = a.inc;
  const int U = in.pi[a.F];
  const int CE = max((U + C - 1) / C, 1);
  const int n0 = min(c * NC, a.F), nn = min(n0 + NC, a.F) - n0;
  const int s0 = min(c * CE, U), ne = min(s0 + CE, U) - s0;

  // staging
  const bool al = (((uintptr_t)a.J | (uintptr_t)a.Minv) & 15) == 0;
  for (int k = tid; k < ne * 9; k += nt) {
    const int le = k / 9, part = k - le * 9;
    stage16(sJ + le * 36 + part * 4,
            a.J + (size_t)in.oi[s0 + le] * 36 + part * 4, al);
  }
  for (int k = tid; k < nn * 9; k += nt)
    stage16(sM + k * 4, a.Minv + (size_t)n0 * 36 + k * 4, al);
  for (int le = tid; le < ne; le += nt) {
    const int e = in.oi[s0 + le];
    w[le] = a.ew[e];
    ti[le] = a.ei[e];
    hj[le] = a.ej[e];
  }
  const int b0 = in.pj[n0];
  for (int k = tid; k <= nn; k += nt) {
    lst[k] = in.pi[n0 + k];
    est[k] = in.pj[n0 + k] - b0;
  }
  for (int k = tid; k < nn; k += nt) dg[k] = a.diag[n0 + k];
  for (int k = tid; k < nn * 6; k += nt) {
    r[k] = -a.gvec[(size_t)n0 * 6 + k];
    x[k] = 0.0f;
  }
  for (int k = tid; k < 2 * F6; k += nt) pr[k] = 0.0f;
  __syncthreads();
  // each owned node's entries from (lst[ln] - lst[0]) + est[ln]: leaving at
  // positions lst[ln] .., then entering (the edge's position in its tail's
  // list, by a binary search)
  const int l_all = lst[nn] - lst[0], nin = est[nn];
  for (int k = tid; k < l_all + nin; k += nt) {
    const bool leaving = k < l_all;
    const int* off = leaving ? lst : est;
    const int key = leaving ? lst[0] + k : k - l_all;
    int lo = 0, hi = nn;  // the last node whose list starts at or before key
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (off[mid] <= key) lo = mid; else hi = mid - 1;
    }
    const int ln = lo, base = lst[ln] - lst[0] + est[ln];
    int pos, slot;
    if (leaving) {
      pos = key;
      slot = base + key - lst[ln];
    } else {
      const int e = in.oj[b0 + key];
      int l = in.pi[a.ei[e]], h = in.pi[a.ei[e] + 1];
      while (l < h) {  // e's position in its tail's list (edge order)
        const int mid = (l + h) >> 1;
        if (in.oi[mid] < e) l = mid + 1; else h = mid;
      }
      pos = l;
      slot = base + lst[ln + 1] - lst[ln] + key - est[ln];
    }
    // in a cluster a leaving entry is loaded only where its piece ends: the
    // node's last entry, a warp's last lane (le % 32 == 31) or the CTA's
    // last edge
    const int rk = pos / CE, le = pos - rk * CE;
    const bool load = !CL || !leaving || pos == lst[ln + 1] - 1 ||
                      (le & 31) == 31 || pos == min((rk + 1) * CE, U) - 1;
    refs[slot] = (rk << 20) | ((le * 12 + (leaving ? 0 : 6)) << 2) |
                 (leaving ? 0 : 2) | load;
  }
  // pass B's teams, grouped by size from 32 lanes down (so every team is
  // aligned to its size, with no gaps): slot = node << 8 | log2 T << 5 |
  // lane in team
  if (warp == 0) {
    int cnt[6] = {0, 0, 0, 0, 0, 0};
    for (int pass = 0; pass < 2; ++pass) {
      int base_[6], seen[6] = {0, 0, 0, 0, 0, 0}, off = 0;
      for (int cl = 5; cl >= 0; --cl) {
        base_[cl] = off;
        off += cnt[cl] << cl;
      }
      for (int b = 0; b < nn; b += 32) {
        const int ln = b + lane;
        int cls = -1;
        if (ln < nn) {
          const int d = lst[ln + 1] - lst[ln] + est[ln + 1] - est[ln];
          cls = 0;
          while (cls < 5 && (4 << cls) < d) ++cls;
        }
        for (int cl = 0; cl < 6; ++cl) {
          const unsigned m = __ballot_sync(0xffffffffu, cls == cl);
          if (pass == 0) {
            cnt[cl] += __popc(m);
          } else if (cls == cl) {
            const int rank_ = seen[cl] + __popc(m & ((1u << lane) - 1u));
            const int t0 = base_[cl] + (rank_ << cl);
            for (int k = 0; k < (1 << cl); ++k)
              task[t0 + k] = (ln << 8) | (cl << 5) | k;
          }
          seen[cl] += __popc(m);
        }
      }
      if (pass == 1) {
        for (int k = off + lane; k < (off + 31) / 32 * 32; k += 32)
          task[k] = -1;
        if (lane == 0) ((int*)team.words)[66] = (off + 31) / 32 * 32;
      }
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  const int n_task = ((const int*)team.words)[66];  // slots, whole warps
  // every CTA of the cluster runs before the first remote write
  if (CL) asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");

  // z = Minv r into every CTA; b.b and r.z
  float b2p = 0.0f, rzp = 0.0f;
  for (int ln = tid; ln < nn; ln += nt) {
    float rv[6], zv[6];
    load6(r + ln * 6, rv);
    mat6(sM + ln * 36, rv, zv);
#pragma unroll
    for (int q = 0; q < 6; ++q) {
      b2p += rv[q] * rv[q];
      rzp += rv[q] * zv[q];
    }
    for (int rk = 0; rk < C; ++rk) store6(team.at(zr, rk) + (n0 + ln) * 6, zv);
  }
  // every CTA staged and z is everywhere before the first read
  const float b2 = team.sum(b2p, 0);
  float rz = team.sum(rzp, 1), beta = 0.0f;

  for (int it = 0; it < a.cg_iters; ++it) {
    const float* pold = pr + ((it + 1) & 1) * F6;  // p of the last step
    float* pnew = pr + (it & 1) * F6;
    // A: p of every node into the other p buffer; t, u, v of the owned
    // edges, a thread an edge; in a cluster then the sums of w u over each
    // run of consecutive lanes with one tail node (a segmented shuffle
    // scan): the run's last lane holds its piece of the node's leaving sum,
    // and pass B pulls one entry a piece. p.Hp = sum_e w |t_e|^2 + sum_n
    // diag_n |p_n|^2 (H's own form), so alpha is known after this pass
    for (int k = tid; k < F6; k += nt) pnew[k] = fmaf(beta, pold[k], zr[k]);
    float php = 0.0f;
    for (int ln = tid; ln < nn; ln += nt) {
      float po[6], zo[6], q = 0.0f;
      load6(pold + (n0 + ln) * 6, po);
      load6(zr + (n0 + ln) * 6, zo);
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        const float pn = fmaf(beta, po[k], zo[k]);
        q += pn * pn;
      }
      php += dg[ln] * q;
    }
    for (int base = warp * 32; base < ne; base += nt) {
      const int le = base + lane;
      const bool act = le < ne;
      const int li = act ? le : 0;
      const float2* pi2 = reinterpret_cast<const float2*>(pold + ti[li] * 6);
      const float2* zi2 = reinterpret_cast<const float2*>(zr + ti[li] * 6);
      const float2* pj2 = reinterpret_cast<const float2*>(pold + hj[li] * 6);
      const float2* zj2 = reinterpret_cast<const float2*>(zr + hj[li] * 6);
      float pi_[6], pj_[6];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float2 P = pi2[k], Z = zi2[k], Pj = pj2[k], Zj = zj2[k];
        pi_[2 * k] = fmaf(beta, P.x, Z.x);
        pi_[2 * k + 1] = fmaf(beta, P.y, Z.y);
        pj_[2 * k] = fmaf(beta, Pj.x, Zj.x);
        pj_[2 * k + 1] = fmaf(beta, Pj.y, Zj.y);
      }
      const float2* Je = reinterpret_cast<const float2*>(sJ + li * 36);
      float t[6], u[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int row = 0; row < 6; ++row) {
        const float2 j0 = Je[row * 3], j1 = Je[row * 3 + 1],
                     j2 = Je[row * 3 + 2];
        const float jr6[6] = {j0.x, j0.y, j1.x, j1.y, j2.x, j2.y};
        float s = 0.0f;
#pragma unroll
        for (int k = 0; k < 6; ++k) s += jr6[k] * pi_[k];
        t[row] = s + pj_[row];
#pragma unroll
        for (int k = 0; k < 6; ++k) u[k] += jr6[k] * t[row];
      }
      const float wv = act ? w[li] : 0.0f;
      const int key = act ? ti[li] : -1 - lane;
      php += wv * (t[0] * t[0] + t[1] * t[1] + t[2] * t[2] + t[3] * t[3] +
                   t[4] * t[4] + t[5] * t[5]);
#pragma unroll
      for (int k = 0; k < 6; ++k) u[k] *= wv;
#pragma unroll
      for (int dl = 1; dl < (CL ? 32 : 1); dl <<= 1) {
        const int ok_ = __shfl_up_sync(0xffffffffu, key, dl);
#pragma unroll
        for (int k = 0; k < 6; ++k) {
          const float o = __shfl_up_sync(0xffffffffu, u[k], dl);
          if (lane >= dl && ok_ == key) u[k] += o;
        }
      }
      if (act) {
        float4* o = reinterpret_cast<float4*>(uv + le * 12);
        o[0] = make_float4(u[0], u[1], u[2], u[3]);
        o[1] = make_float4(u[4], u[5], wv * t[0], wv * t[1]);
        o[2] = make_float4(wv * t[2], wv * t[3], wv * t[4], wv * t[5]);
      }
    }
    const float pHp = team.sum(php, 0);  // 1: u, v and p visible too
    const bool ok = (pHp > 1e-12f) && (rz > 1e-12f * b2 + 1e-30f);
    const float alpha = ok ? rz / fmaxf(pHp, 1e-30f) : 0.0f;

    // B: of the owned nodes, H p, then x += alpha p, r -= alpha H p and
    // z = Minv r into every CTA, and r.z
    float rzn = 0.0f;
    for (int base = warp * 32; base < n_task; base += nw * 32) {
      const int tk = task[base + lane];
      const int lt = tk < 0 ? 0 : (tk >> 5) & 7, T = 1 << lt;
      float acc[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      const int ln = tk >> 8;
      if (tk >= 0) {
        const int cb = lst[ln] - lst[0] + est[ln];
        const int d = lst[ln + 1] - lst[ln] + est[ln + 1] - est[ln];
        // four entries at a time: their addresses, then their loads, then
        // the adds (in entry order); an entry inside a leaving piece adds 0
        for (int k0 = tk & 31; k0 < d; k0 += 4 * T) {
          int rf[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            rf[i] = k0 + i * T < d ? refs[cb + k0 + i * T] : 0;
          float e[4][6];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const bool on = rf[i] & 1, isv = rf[i] & 2;
            const float* src =
                on ? team.at(uv, rf[i] >> 20) + ((rf[i] >> 2) & 0x3ffff) : uv;
            const float2 a2 =
                *reinterpret_cast<const float2*>(src + (isv ? 0 : 4));
            const float4 b4 =
                *reinterpret_cast<const float4*>(src + (isv ? 2 : 0));
            e[i][0] = on ? (isv ? a2.x : b4.x) : 0.0f;
            e[i][1] = on ? (isv ? a2.y : b4.y) : 0.0f;
            e[i][2] = on ? (isv ? b4.x : b4.z) : 0.0f;
            e[i][3] = on ? (isv ? b4.y : b4.w) : 0.0f;
            e[i][4] = on ? (isv ? b4.z : a2.x) : 0.0f;
            e[i][5] = on ? (isv ? b4.w : a2.y) : 0.0f;
          }
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 6; ++j) acc[j] += e[i][j];
        }
      }
      const unsigned tmax = __reduce_max_sync(0xffffffffu, (unsigned)T);
      for (int m = 1; m < (int)tmax; m <<= 1)
#pragma unroll
        for (int k = 0; k < 6; ++k) {
          const float o = __shfl_xor_sync(0xffffffffu, acc[k], m);
          if (m < T) acc[k] += o;
        }
      if (tk >= 0 && (tk & 31) == 0) {
        float pv[6], xv[6], rv[6], zv[6];
        load6(pnew + (n0 + ln) * 6, pv);
        load6(x + ln * 6, xv);
        load6(r + ln * 6, rv);
        const float dgn = dg[ln];
#pragma unroll
        for (int k = 0; k < 6; ++k) {
          const float h = acc[k] + dgn * pv[k];
          xv[k] = xv[k] + alpha * pv[k];
          rv[k] = rv[k] - alpha * h;
        }
        store6(x + ln * 6, xv);
        store6(r + ln * 6, rv);
        mat6(sM + ln * 36, rv, zv);
#pragma unroll
        for (int q = 0; q < 6; ++q) rzn += rv[q] * zv[q];
        for (int rk = 0; rk < C; ++rk)
          store6(team.at(zr, rk) + (n0 + ln) * 6, zv);
      }
    }
    const float rz_new = team.sum(rzn, 1);  // 2: z everywhere too
    beta = ok ? rz_new / fmaxf(rz, 1e-30f) : 0.0f;
    rz = rz_new;
  }
  for (int k = tid; k < nn * 6; k += nt) a.dx[(size_t)n0 * 6 + k] = x[k];
  if (CL) team.barrier();  // no CTA exits while another reads its memory
}

// -- the gradient each GN step: pg_update hands it on -----------------------
//
// A GN step after the first needs g at the residuals that pg_update hands
// on. pg_update computes it in the same launch, in one of the two orders of
// the one-launch kernels (GRAD_DENSE: pg_assemble's one sum over the leaving,
// then the entering list; GRAD_PCG: pg_blocks' gi + gj). Each CTA's edge
// pass also forms u = Ji^T r of its edges (d of the reference's order: Ji
// rows staged in shared memory by warps 5-7 while warp 0 evaluates the
// residuals), so a slot's g needs only w and u (leaving) or r (entering) of
// its list entries: g[n][p] = sum over leaving w u[p], then over entering
// w r[p]. On a reject the residuals handed on are r_in's, whose gradient is
// g_in: it is handed on as is. A slot's g needs other CTAs' residuals, so
// pg_update is a cooperative launch (every CTA co-resident) with one grid
// barrier: each CTA adds the partials itself (in CTA order: the same bits
// in each), takes the accept, restores its own slots and edges on a
// reject, and computes the g of its own slots, their list entries and w
// staged in shared memory before the barrier. (The last CTA computing
// every slot's g alone was slower at every slot bucket past 64.)
constexpr int GRAD_DENSE = 1, GRAD_PCG = 2;
constexpr int GRAD_STAGE = 256;  // list entries of a CTA's slots staged

struct GradArgs {
  Incidence inc;
  const float* J;     // (E, 36)
  const float* g_in;  // (F * 6): the gradient at r_in
  float* g_out;       // (F * 6)
  float* u;           // (E, 6) scratch: Ji^T r at the trial poses
  int mode;           // 0: no gradient
};

// the staged list entries (edge id, w) of a CTA's slots: leaving positions
// l0 .. l0 + nl, entering q0 .. q0 + nq
struct ListStage {
  const int* le;
  const float* lw;
  const int* qe;
  const float* qw;
  int l0, nl, q0, nq;
};

// g[n][p] in the mode's order from u (leaving) and r (entering), eight
// entries' loads in flight before their adds
__device__ float node_gradient(const GradArgs& ga, const float* ew,
                               const float* r, const ListStage& st, int n,
                               int p) {
  const Incidence& in = ga.inc;
  const bool dense = ga.mode == GRAD_DENSE;
  float gi = 0.0f, gj = 0.0f;
  for (int pass = 0; pass < 2; ++pass) {
    const int* list = pass ? in.oj : in.oi;
    const int* ptr = pass ? in.pj : in.pi;
    const float* val = pass ? r : ga.u;
    const int* se = pass ? st.qe : st.le;
    const float* sw = pass ? st.qw : st.lw;
    const int base = pass ? st.q0 : st.l0, ns = pass ? st.nq : st.nl;
    const int a0 = ptr[n], a1 = ptr[n + 1];
    float& acc = (pass && !dense) ? gj : gi;
    for (int s0 = a0; s0 < a1; s0 += 8) {
      float wv[8], dv[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int sidx = s0 + k, ls = sidx - base;
        if (sidx < a1) {
          const bool staged = ls >= 0 && ls < ns;
          const int e = staged ? se[ls] : list[sidx];
          wv[k] = staged ? sw[ls] : ew[e];
          dv[k] = __ldcg(val + (size_t)e * 6 + p);
        }
      }
#pragma unroll
      for (int k = 0; k < 8; ++k)
        if (s0 + k < a1) acc = fmaf(wv[k], dv[k], acc);
    }
  }
  return dense ? gi : gi + gj;
}

// Every CTA of a cooperative launch past this point only after all have
// reached it, their writes before it visible after it. The counter is 0
// before and after: each CTA counts in, waits for all, counts out, and the
// last to count out sets it back.
__device__ void grid_barrier(unsigned* count) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned G = gridDim.x;
    fence_acq_rel_gpu();
    atomicAdd(count, 1u);
    unsigned v;
    do {
      asm volatile("ld.acquire.gpu.u32 %0, [%1];\n"
                   : "=r"(v)
                   : "l"(count)
                   : "memory");
    } while (v < G);
    if (atomicAdd(count, 1u) == 2 * G - 1) atomicExch(count, 0u);
  }
  __syncthreads();
}

// T <- T exp(scale step) on valid slots, the residuals and cost there, and
// the accept; on a reject the old poses, the old residuals r_in, c and g_in
// are handed back; with a gradient mode, g at the residuals handed on
__global__ void __launch_bounds__(EDGE_NT)
    pg_update_kernel(Sweep s, const float* c_in, const float* step,
                     float scale, const uint8_t* __restrict__ valid,
                     const float* r_in, float* poses_out, float* c_out,
                     GradArgs ga) {
  __shared__ __align__(16) float sT[EDGE_SLOTS * 16];
  __shared__ __align__(16) float sTi[EDGE_SLOTS * 16];
  __shared__ __align__(16) float sTj[EDGE_SLOTS * 16];
  __shared__ __align__(16) float sR[EDGE_SLOTS * 6];
  __shared__ __align__(16) float sJ[EDGE_SLOTS * 36];
  __shared__ __align__(16) float sU[EDGE_SLOTS * 6];
  __shared__ int sle[GRAD_STAGE], sqe[GRAD_STAGE];
  __shared__ float slw[GRAD_STAGE], sqw[GRAD_STAGE];
  __shared__ int s_lists[4];
  __shared__ float sc[EDGE_SLOTS], sp[EDGE_NT], s_total;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.x, e0 = b * EDGE_SLOTS;
  const int n = min(EDGE_SLOTS, s.E - e0);
  const int NC = (s.F + gridDim.x - 1) / gridDim.x;
  const int n0 = min(b * NC, s.F), nn = min(n0 + NC, s.F) - n0;
  const bool grad = ga.mode != 0;
  float w = 0.0f;
  if (warp == 0) {  // w and the Tm rows
    if (lane < n) w = s.ew[e0 + lane];
    copy_floats<4>(sT, s.eT + (size_t)e0 * 16, n * 16, lane, 32);
  } else if (warp <= 2) {  // an end's trial pose: the tail, then the head
    if (lane < n && s.ew[e0 + lane] > 0.0f)
      trial_pose(s.poses, step, valid, scale,
                 (warp == 1 ? s.ei : s.ej)[e0 + lane],
                 (warp == 1 ? sTi : sTj) + lane * 16);
  } else if (warp <= 4) {  // the CTA's own slots' trial poses
    for (int k = tid - 96; k < nn; k += 64) {
      float T[16];
      trial_pose(s.poses, step, valid, scale, n0 + k, T);
      store16(poses_out + (size_t)(n0 + k) * 16, T);
    }
  } else if (grad) {  // the edges' Ji rows; the slots' list entries
    const int t = tid - 160;
    copy_floats<3>(sJ, ga.J + (size_t)e0 * 36, n * 36, t, 96);
    const Incidence& in = ga.inc;
    const int l0 = in.pi[n0], q0 = in.pj[n0];
    const int nl = min(in.pi[n0 + nn] - l0, GRAD_STAGE);
    const int nq = min(in.pj[n0 + nn] - q0, GRAD_STAGE);
    for (int k = t; k < nl + nq; k += 96) {
      const bool lv = k < nl;
      const int e = lv ? in.oi[l0 + k] : in.oj[q0 + k - nl];
      (lv ? sle : sqe)[lv ? k : k - nl] = e;
      (lv ? slw : sqw)[lv ? k : k - nl] = s.ew[e];
    }
    if (t == 0) {
      s_lists[0] = l0;
      s_lists[1] = nl;
      s_lists[2] = q0;
      s_lists[3] = nq;
    }
  }
  __syncthreads();
  if (warp == 0)
    sweep_residuals(sT, sTi + lane * 16, sTj + lane * 16, w, sR, sc, n);
  __syncthreads();
  if (grad) {  // u = Ji^T r of the CTA's edges, each sum over a in order
    for (int k = tid; k < n * 6; k += EDGE_NT) {
      const int l = k / 6, p = k - l * 6;
      float d = 0.0f;
      for (int a = 0; a < 6; ++a)
        d = fmaf(sJ[l * 36 + a * 6 + p], sR[l * 6 + a], d);
      sU[k] = d;
    }
    __syncthreads();
    copy_floats<1>(ga.u + (size_t)e0 * 6, sU, n * 6, tid, EDGE_NT);
  }
  copy_floats<1>(s.r + (size_t)e0 * 6, sR, n * 6, tid, EDGE_NT);
  __syncthreads();
  if (tid == 0) write_partial(s, sc, n);
  grid_barrier(s.count);
  sum_partials(s, sp, &s_total);
  const float c = *c_in, c_new = s_total;
  const bool ok = isfinite(c_new) && c_new <= c;
  // this CTA's slots and edges
  if (!ok) {
    copy_floats<1>(poses_out + (size_t)n0 * 16, s.poses + (size_t)n0 * 16,
                   nn * 16, tid, EDGE_NT);
    copy_floats<1>(s.r + (size_t)e0 * 6, r_in + (size_t)e0 * 6, n * 6, tid,
                   EDGE_NT);
    if (grad)
      for (int k = tid; k < nn * 6; k += EDGE_NT)
        ga.g_out[(size_t)n0 * 6 + k] = ga.g_in[(size_t)n0 * 6 + k];
  } else if (grad) {
    const ListStage st{sle, slw, sqe, sqw, s_lists[0], s_lists[1],
                       s_lists[2], s_lists[3]};
    for (int k = tid; k < nn * 6; k += EDGE_NT) {
      const int ln = k / 6;
      ga.g_out[(size_t)n0 * 6 + k] =
          node_gradient(ga, s.ew, s.r, st, n0 + ln, k - ln * 6);
    }
  }
  if (tid == 0 && b == 0) *c_out = ok ? c_new : c;
}

}  // namespace

extern "C" {

// the 16-byte alignment the sweep's vector accesses need
inline bool aligned16(std::initializer_list<const void*> ps) {
  for (const void* p : ps)
    if ((uintptr_t)p & 15) return false;
  return true;
}

// poses (F, 4, 4), edges ei, ej (E,) int32, eT (E, 4, 4), ew (E,) ->
// r (E, 6) (0 on unused edges), Ji (E, 6, 6) unless J is null, cost (1,);
// partial (ctas,) scratch, count a zero that the launch leaves at 0; ctas
// and threads as edge_ctas and EDGE_NT (any other plan is refused)
int pg_edges(const float* poses, const int* ei, const int* ej,
             const float* eT, const float* ew, float* r, float* J,
             float* cost, float* partial, unsigned* count, int F, int E,
             int ctas, int threads, cudaStream_t stream) {
  if (ctas != edge_ctas(E) || threads != EDGE_NT)
    return (int)cudaErrorInvalidValue;
  if (!aligned16({poses, eT, r, J})) return (int)cudaErrorMisalignedAddress;
  Sweep s{poses, ei, ej, eT, ew, r, partial, count, F, E};
  if (J != nullptr)
    pg_edges_kernel<true><<<ctas, EDGE_NT, 0, stream>>>(s, J, cost);
  else
    pg_edges_kernel<false><<<ctas, EDGE_NT, 0, stream>>>(s, J, cost);
  return (int)cudaGetLastError();
}

// dense normal equations: H (6F, 6F) and g (6F,) with the pins in diag (F,),
// once a solve (pg_update hands on each later g): F CTAs; refuses F past
// what a CTA's block-slot table holds (~51,000)
int pg_assemble(const float* poses, const int* ei, const int* ej,
                const float* eT, const float* ew, const int* oi,
                const int* pi, const int* oj, const int* pj, const float* r,
                const float* J, const float* diag, float* H, float* gvec,
                int F, int E, cudaStream_t stream) {
  if (!aligned16({r, J, H})) return (int)cudaErrorMisalignedAddress;
  Graph g{poses, ei, ej, eT, ew, F, E};
  Incidence inc{oi, pi, oj, pj};
  const size_t smem = normal_words(F, true) * 4;
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      pg_assemble_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  pg_assemble_kernel<<<F, 2 * NORMAL_CT, smem, stream>>>(g, inc, r, J, diag,
                                                         H, gvec);
  return (int)cudaGetLastError();
}

// PCG: the exact diagonal blocks Hd (F, 6, 6) and the gradient g (F, 6),
// once a solve: F CTAs
int pg_blocks(const float* poses, const int* ei, const int* ej,
              const float* eT, const float* ew, const int* oi, const int* pi,
              const int* oj, const int* pj, const float* r, const float* J,
              const float* diag, float* Hd, float* gvec, int F, int E,
              cudaStream_t stream) {
  if (!aligned16({r, J})) return (int)cudaErrorMisalignedAddress;
  Graph g{poses, ei, ej, eT, ew, F, E};
  Incidence inc{oi, pi, oj, pj};
  const size_t smem = normal_words(F, false) * 4;
  pg_blocks_kernel<<<F, 2 * NORMAL_CT, smem, stream>>>(g, inc, r, J, diag,
                                                       Hd, gvec);
  return (int)cudaGetLastError();
}

// PCG: cg_iters steps on H dx = -g with the block-Jacobi inverses Minv, one
// launch of a thread-block cluster (pcg_cluster); refuses a graph that no
// cluster of up to 16 CTAs holds, or a cluster the card cannot co-schedule
int pg_pcg(const float* poses, const int* ei, const int* ej, const float* eT,
           const float* ew, const int* oi, const int* pi, const int* oj,
           const int* pj, const float* J, const float* Minv,
           const float* diag, const float* gvec, float* dx, int F, int E,
           int cg_iters, cudaStream_t stream) {
  (void)poses;
  (void)eT;
  const int C = pcg_cluster(F, E);
  if (C == 0) return (int)cudaErrorInvalidValue;
  const int EC = (E + C - 1) / C;
  const int threads = std::min(1024, std::max(64, (EC + 31) / 32 * 32));
  const size_t smem = pcg_words(F, E, C) * 4;
  auto kernel = C > 1 ? pg_pcg_kernel<true> : pg_pcg_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (C > 8) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (err != cudaSuccess) return (int)err;
  if (clusters < 1) return (int)cudaErrorLaunchOutOfResources;
  PcgArgs args{ei, ej, ew, Incidence{oi, pi, oj, pj}, J, Minv, diag, gvec,
               dx, F, E, cg_iters};
  err = cudaLaunchKernelEx(&cfg, kernel, args);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// poses_out = accepted(poses exp(scale step on valid slots)), r_out the
// residuals at poses_out (r_in, the residuals at poses, on a reject), c_out;
// the plan as pg_edges'. mode GRAD_DENSE or GRAD_PCG: also g_out, the
// gradient at r_out in that order (g_in, the gradient at r_in, on a
// reject), from the node lists oi .. pj and the Jacobians J, with u (E, 6)
// scratch; mode 0: none (those pointers unused). A cooperative launch: the
// card refuses a grid it cannot hold at once
int pg_update(const float* poses, const int* ei, const int* ej,
              const float* eT, const float* ew, const float* c_in,
              const float* step, const uint8_t* valid, const float* r_in,
              float* poses_out, float* r_out, float* c_out, float* partial,
              unsigned* count, const int* oi, const int* pi, const int* oj,
              const int* pj, const float* J, const float* g_in, float* g_out,
              float* u, int F, int E, int ctas, int threads, int mode,
              float scale, cudaStream_t stream) {
  if (ctas != edge_ctas(E) || threads != EDGE_NT || mode < 0 ||
      mode > GRAD_PCG)
    return (int)cudaErrorInvalidValue;
  if (!aligned16({poses, eT, r_in, poses_out, r_out}) ||
      (mode && !aligned16({J, u})))
    return (int)cudaErrorMisalignedAddress;
  Sweep s{poses, ei, ej, eT, ew, r_out, partial, count, F, E};
  GradArgs ga{Incidence{oi, pi, oj, pj}, J, g_in, g_out, u, mode};
  void* args[] = {(void*)&s,         (void*)&c_in,  (void*)&step,
                  (void*)&scale,     (void*)&valid, (void*)&r_in,
                  (void*)&poses_out, (void*)&c_out, (void*)&ga};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)pg_update_kernel, dim3(ctas), dim3(EDGE_NT), args, 0,
      stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
