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
//   pg_edges     one block: r, Ji of every edge and the cost sum w |r|^2
//                (per-thread strided sums, then a fixed tree: the cost
//                decides the accept test c_new <= c).
//   pg_assemble  dense, one block per slot i: its 6 rows of H (6F wide) and
//                g_i, from the node's edge lists in edge order, in the
//                reference's four scatter phases (Hii over edges leaving i;
//                w I over edges entering i; the off-diagonal blocks w Ji^T
//                and w Ji), then the pins and the 1e-5 + 1e-6 diagonal. The
//                (6F)^2 solve stays torch.linalg.solve_ex (the reference
//                calls jnp.linalg.solve).
//   pg_blocks    PCG, one block per slot: g_i and the exact 6 x 6 diagonal
//                block of H (its inverse stays torch.linalg.inv_ex, as the
//                reference calls jnp.linalg.inv).
//   pg_pcg       PCG, one block runs the whole fixed cg_iters schedule of one
//                GN step with x, r, z, p, Hp (5 x 6F floats) and the per-edge
//                t = Ji p_i + p_j (6E floats) in shared memory (111 KB at
//                F = 512, E = 2048; dynamic shared memory). H p is applied
//                node-wise over the edge incidence lists (edges leaving,
//                then entering, each in edge order), so again no atomics.
//                The ok gate, alpha and beta follow the reference.
//   pg_update    one block: T <- T exp(dx) on valid slots, the trial cost,
//                and the accept (finite and c_new <= c) into the outputs.
//
// Launches per GN iteration: dense 3 (pg_edges, pg_assemble, pg_update) +
// the library solve; PCG 4 (pg_edges, pg_blocks, pg_pcg, pg_update) + the
// library's batched 6 x 6 inverse. Per solve one more pg_edges (the initial
// cost): 37 dense, 49 PCG at 12 iterations.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 1024;
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

// residual r = log(Tm^-1 Ti^-1 Tj) and Ji = -Ad(Tm^-1) (6 x 6 row-major)
__device__ void edge_eval(const Graph& g, const float* poses, int e, float* r,
                          float* J) {
  float Tm_inv[16], Ti_inv[16], A[16], B[16];
  inv_se3(g.eT + (size_t)e * 16, Tm_inv);
  inv_se3(poses + (size_t)g.ei[e] * 16, Ti_inv);
  mm4(Tm_inv, Ti_inv, A);
  mm4(A, poses + (size_t)g.ej[e] * 16, B);
  log_se3(B, r);
  if (J == nullptr) return;
  // Ad(T) = [[R, skew(t) R], [0, R]]
  const float* M = Tm_inv;
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

// fixed-order block sum of one value per thread; every thread gets it
__device__ float block_sum(float v, float* red) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int s = 16; s > 0; s >>= 1) v += __shfl_xor_sync(0xffffffffu, v, s);
  __syncthreads();  // red may still be read from an earlier call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (tid == 0) {
    float s = 0.0f;
    for (int i = 0; i < (int)(blockDim.x >> 5); ++i) s += red[i];
    red[32] = s;
  }
  __syncthreads();
  return red[32];
}

// the cost sum_e w |r|^2 of ``poses``; optionally r and Ji of every edge
__device__ float graph_cost(const Graph& g, const float* poses, float* r_out,
                            float* J_out, float* red) {
  float part = 0.0f;
  for (int e = threadIdx.x; e < g.E; e += blockDim.x) {
    float r[6], J[36];
    edge_eval(g, poses, e, r, J_out ? J : nullptr);
    const float w = g.ew[e];
    const bool used = w > 0.0f;
    float s = 0.0f;
    for (int a = 0; a < 6; ++a) {
      if (!used) r[a] = 0.0f;
      s += r[a] * r[a];
    }
    part += w * s;
    if (r_out)
      for (int a = 0; a < 6; ++a) r_out[(size_t)e * 6 + a] = r[a];
    if (J_out)
      for (int a = 0; a < 36; ++a) J_out[(size_t)e * 36 + a] = J[a];
  }
  return block_sum(part, red);
}

__global__ void __launch_bounds__(NT)
    pg_edges_kernel(Graph g, float* r_out, float* J_out, float* cost) {
  __shared__ float red[33];
  const float c = graph_cost(g, g.poses, r_out, J_out, red);
  if (threadIdx.x == 0) *cost = c;
}

// node lists: edges leaving n are oi[pi[n] .. pi[n+1]), entering n are
// oj[pj[n] .. pj[n+1]), each in edge order
struct Incidence {
  const int* oi;
  const int* pi;
  const int* oj;
  const int* pj;
};

__global__ void pg_assemble_kernel(Graph g, Incidence inc,
                                   const float* __restrict__ r,
                                   const float* __restrict__ J,
                                   const float* __restrict__ diag, float* H,
                                   float* gvec) {
  const int i = blockIdx.x, tid = threadIdx.x;
  const size_t n6 = 6 * (size_t)g.F;
  float* band = H + (size_t)6 * i * n6;
  for (size_t k = tid; k < 6 * n6; k += blockDim.x) band[k] = 0.0f;
  __syncthreads();
  const int a0 = inc.pi[i], a1 = inc.pi[i + 1];
  const int b0 = inc.pj[i], b1 = inc.pj[i + 1];
  if (tid < 36) {
    const int p = tid / 6, q = tid % 6;
    float* row = band + p * n6;
    float hii = 0.0f;
    for (int s = a0; s < a1; ++s) {  // H[i,i] += w Ji^T Ji (edges leaving)
      const int e = inc.oi[s];
      const float* Je = J + (size_t)e * 36;
      float d = 0.0f;
      for (int a = 0; a < 6; ++a) d += Je[a * 6 + p] * Je[a * 6 + q];
      hii += g.ew[e] * d;
    }
    if (p == q)
      for (int s = b0; s < b1; ++s) hii += g.ew[inc.oj[s]];  // w I (entering)
    row[6 * i + q] += hii;
    for (int s = a0; s < a1; ++s) {  // H[i,j] += w Ji^T
      const int e = inc.oi[s];
      row[6 * (size_t)g.ej[e] + q] += g.ew[e] * J[(size_t)e * 36 + q * 6 + p];
    }
    for (int s = b0; s < b1; ++s) {  // H[j,i] += w Ji, seen from row j = i
      const int e = inc.oj[s];
      row[6 * (size_t)g.ei[e] + q] += g.ew[e] * J[(size_t)e * 36 + p * 6 + q];
    }
    if (p == q) row[6 * i + p] += diag[i];
  } else if (tid < 42) {
    const int p = tid - 36;
    float acc = 0.0f;
    for (int s = a0; s < a1; ++s) {  // w Ji^T r (leaving)
      const int e = inc.oi[s];
      float d = 0.0f;
      for (int a = 0; a < 6; ++a)
        d += J[(size_t)e * 36 + a * 6 + p] * r[(size_t)e * 6 + a];
      acc += g.ew[e] * d;
    }
    for (int s = b0; s < b1; ++s) {  // w r (entering)
      const int e = inc.oj[s];
      acc += g.ew[e] * r[(size_t)e * 6 + p];
    }
    gvec[6 * i + p] = acc;
  }
}

__global__ void pg_blocks_kernel(Graph g, Incidence inc,
                                 const float* __restrict__ r,
                                 const float* __restrict__ J,
                                 const float* __restrict__ diag, float* Hd,
                                 float* gvec) {
  const int i = blockIdx.x, tid = threadIdx.x;
  const int a0 = inc.pi[i], a1 = inc.pi[i + 1];
  const int b0 = inc.pj[i], b1 = inc.pj[i + 1];
  if (tid < 36) {
    const int p = tid / 6, q = tid % 6;
    float h = 0.0f;
    for (int s = a0; s < a1; ++s) {
      const int e = inc.oi[s];
      const float* Je = J + (size_t)e * 36;
      float d = 0.0f;
      for (int a = 0; a < 6; ++a) d += Je[a * 6 + p] * Je[a * 6 + q];
      h += g.ew[e] * d;
    }
    float wj = 0.0f;
    for (int s = b0; s < b1; ++s) wj += g.ew[inc.oj[s]];
    const float e = p == q ? 1.0f : 0.0f;
    Hd[(size_t)i * 36 + tid] = h + wj * e + diag[i] * e;
  } else if (tid < 42) {
    const int p = tid - 36;
    float gi = 0.0f, gj = 0.0f;
    for (int s = a0; s < a1; ++s) {
      const int e = inc.oi[s];
      float d = 0.0f;
      for (int a = 0; a < 6; ++a)
        d += J[(size_t)e * 36 + a * 6 + p] * r[(size_t)e * 6 + a];
      gi += g.ew[e] * d;
    }
    for (int s = b0; s < b1; ++s) {
      const int e = inc.oj[s];
      gj += g.ew[e] * r[(size_t)e * 6 + p];
    }
    gvec[(size_t)i * 6 + p] = gi + gj;
  }
}

__global__ void __launch_bounds__(NT)
    pg_pcg_kernel(Graph g, Incidence inc, const float* __restrict__ J,
                  const float* __restrict__ Minv,
                  const float* __restrict__ diag,
                  const float* __restrict__ gvec, int cg_iters,
                  float* __restrict__ dx) {
  extern __shared__ float sm[];
  __shared__ float red[33];
  const int F6 = 6 * g.F, tid = threadIdx.x;
  float *x = sm, *rr = x + F6, *z = rr + F6, *p = z + F6, *Hp = p + F6,
        *t = Hp + F6;
  float b2p = 0.0f;
  for (int k = tid; k < F6; k += NT) {
    const float b = -gvec[k];
    x[k] = 0.0f;
    rr[k] = b;
    b2p += b * b;
  }
  const float b2 = block_sum(b2p, red);  // syncs: rr is complete
  float rzp = 0.0f;
  for (int k = tid; k < F6; k += NT) {  // z = M^-1 r, p = z
    const int n = k / 6, a = k % 6;
    float s = 0.0f;
    for (int q = 0; q < 6; ++q) s += Minv[(size_t)n * 36 + a * 6 + q] * rr[6 * n + q];
    z[k] = s;
    p[k] = s;
    rzp += rr[k] * s;
  }
  float rz = block_sum(rzp, red);
  for (int it = 0; it < cg_iters; ++it) {
    for (int e = tid; e < g.E; e += NT) {  // t = Ji p_i + p_j
      const bool used = g.ew[e] > 0.0f;
      const float* Je = J + (size_t)e * 36;
      const int i = g.ei[e], j = g.ej[e];
      for (int a = 0; a < 6; ++a) {
        float s = 0.0f;
        for (int q = 0; q < 6; ++q) s += Je[a * 6 + q] * p[6 * i + q];
        t[6 * e + a] = used ? s + p[6 * j + a] : 0.0f;
      }
    }
    __syncthreads();
    float php = 0.0f;
    for (int k = tid; k < F6; k += NT) {  // H p, node-wise
      const int n = k / 6, a = k % 6;
      float yi = 0.0f, yj = 0.0f;
      for (int s = inc.pi[n]; s < inc.pi[n + 1]; ++s) {
        const int e = inc.oi[s];
        float d = 0.0f;
        for (int c = 0; c < 6; ++c)
          d += J[(size_t)e * 36 + c * 6 + a] * t[6 * e + c];
        yi += g.ew[e] * d;
      }
      for (int s = inc.pj[n]; s < inc.pj[n + 1]; ++s) {
        const int e = inc.oj[s];
        yj += g.ew[e] * t[6 * e + a];
      }
      const float h = (yi + yj) + diag[n] * p[k];
      Hp[k] = h;
      php += p[k] * h;
    }
    const float pHp = block_sum(php, red);
    const bool ok = (pHp > 1e-12f) && (rz > 1e-12f * b2 + 1e-30f);
    const float alpha = ok ? rz / fmaxf(pHp, 1e-30f) : 0.0f;
    for (int k = tid; k < F6; k += NT) {
      x[k] = x[k] + alpha * p[k];
      rr[k] = rr[k] - alpha * Hp[k];
    }
    __syncthreads();
    float rzn = 0.0f;
    for (int k = tid; k < F6; k += NT) {
      const int n = k / 6, a = k % 6;
      float s = 0.0f;
      for (int q = 0; q < 6; ++q)
        s += Minv[(size_t)n * 36 + a * 6 + q] * rr[6 * n + q];
      z[k] = s;
      rzn += rr[k] * s;
    }
    const float rz_new = block_sum(rzn, red);
    const float beta = ok ? rz_new / fmaxf(rz, 1e-30f) : 0.0f;
    for (int k = tid; k < F6; k += NT) p[k] = z[k] + beta * p[k];
    rz = rz_new;
    __syncthreads();
  }
  for (int k = tid; k < F6; k += NT) dx[k] = x[k];
}

__global__ void __launch_bounds__(NT)
    pg_update_kernel(Graph g, const float* c_in, const float* step,
                     float scale, const uint8_t* __restrict__ valid,
                     float* poses_out, float* c_out) {
  __shared__ float red[33];
  for (int n = threadIdx.x; n < g.F; n += NT) {
    float xi[6], E[16];
    for (int a = 0; a < 6; ++a)
      xi[a] = valid[n] ? scale * step[(size_t)n * 6 + a] : 0.0f;
    exp_se3(xi, E);
    mm4(g.poses + (size_t)n * 16, E, poses_out + (size_t)n * 16);
  }
  __syncthreads();
  const float c_new = graph_cost(g, poses_out, nullptr, nullptr, red);
  const float c = *c_in;
  const bool ok = isfinite(c_new) && c_new <= c;
  if (!ok)
    for (int k = threadIdx.x; k < g.F * 16; k += NT) poses_out[k] = g.poses[k];
  if (threadIdx.x == 0) *c_out = ok ? c_new : c;
}

}  // namespace

extern "C" {

// poses (F, 4, 4), edges ei, ej (E,) int32, eT (E, 4, 4), ew (E,) ->
// r (E, 6) (0 on unused edges), Ji (E, 6, 6), cost (1,)
int pg_edges(const float* poses, const int* ei, const int* ej,
             const float* eT, const float* ew, float* r, float* J,
             float* cost, int F, int E, cudaStream_t stream) {
  Graph g{poses, ei, ej, eT, ew, F, E};
  pg_edges_kernel<<<1, NT, 0, stream>>>(g, r, J, cost);
  return (int)cudaGetLastError();
}

// dense normal equations: H (6F, 6F) and g (6F,) with the pins in diag (F,)
int pg_assemble(const float* poses, const int* ei, const int* ej,
                const float* eT, const float* ew, const int* oi,
                const int* pi, const int* oj, const int* pj, const float* r,
                const float* J, const float* diag, float* H, float* gvec,
                int F, int E, cudaStream_t stream) {
  Graph g{poses, ei, ej, eT, ew, F, E};
  Incidence inc{oi, pi, oj, pj};
  pg_assemble_kernel<<<F, 64, 0, stream>>>(g, inc, r, J, diag, H, gvec);
  return (int)cudaGetLastError();
}

// PCG: the exact diagonal blocks Hd (F, 6, 6) and the gradient g (F, 6)
int pg_blocks(const float* poses, const int* ei, const int* ej,
              const float* eT, const float* ew, const int* oi, const int* pi,
              const int* oj, const int* pj, const float* r, const float* J,
              const float* diag, float* Hd, float* gvec, int F, int E,
              cudaStream_t stream) {
  Graph g{poses, ei, ej, eT, ew, F, E};
  Incidence inc{oi, pi, oj, pj};
  pg_blocks_kernel<<<F, 64, 0, stream>>>(g, inc, r, J, diag, Hd, gvec);
  return (int)cudaGetLastError();
}

// PCG: cg_iters steps on H dx = -g with the block-Jacobi inverses Minv
int pg_pcg(const float* poses, const int* ei, const int* ej, const float* eT,
           const float* ew, const int* oi, const int* pi, const int* oj,
           const int* pj, const float* J, const float* Minv,
           const float* diag, const float* gvec, float* dx, int F, int E,
           int cg_iters, cudaStream_t stream) {
  Graph g{poses, ei, ej, eT, ew, F, E};
  Incidence inc{oi, pi, oj, pj};
  const size_t smem = (size_t)(5 * 6 * F + 6 * E) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      pg_pcg_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  pg_pcg_kernel<<<1, NT, smem, stream>>>(g, inc, J, Minv, diag, gvec,
                                         cg_iters, dx);
  return (int)cudaGetLastError();
}

// poses_out = accepted(poses exp(scale step on valid slots)), c_out
int pg_update(const float* poses, const int* ei, const int* ej,
              const float* eT, const float* ew, const float* c_in,
              const float* step, const uint8_t* valid, float* poses_out,
              float* c_out, int F, int E, float scale, cudaStream_t stream) {
  Graph g{poses, ei, ej, eT, ew, F, E};
  pg_update_kernel<<<1, NT, 0, stream>>>(g, c_in, step, scale, valid,
                                         poses_out, c_out);
  return (int)cudaGetLastError();
}

}  // extern "C"
