// Kernel G: per-root refit of the tile components into candidate
// segments (K10), and the segment-level collinear merge (K11). Two
// launches.
//
// Launch 1 (lines_refit) replaces plslam_tpu/ops/lines.py::refit_roots
// (:474), whose member aggregation is a one-hot (R, n) matmul on the MXU
// and whose min/max projections are masked (R, n) reductions. Here one
// warp takes one root slot: the lanes walk the image's labels (in shared
// memory) in tile order, each summing its members' payload (S and the
// image-centre moments, :499-517); a fixed shuffle tree adds the lanes'
// sums. No float atomics: the sums feed the length gate and the top-k
// ranking, and a run-to-run change of summation order could flip either.
// A second walk takes min/max of the members' projections -+ their
// half-extent, after the closed-form principal axis of the merged moments.
//
// Launch 2 (lines_merge) replaces ::merge_segments (:214): one block per
// image holds the M x M compatibility bits (angle mod pi, mutual
// perpendicular midpoint offset, projection gap) in shared memory, runs
// the reference's `iters` synchronous label-min sweeps, each followed by
// the hop lab <- min(lab, lab[clip(lab, 0, M - 1)]) (invalid slots carry
// M and hop through slot M - 1, as the reference), then each root's
// support-weighted double-angle refit and endpoint min/max, members
// summed in slot order.
//
// Bound: operations and latency. Launch 1 reads the labels once per block
// and each member's 7 payload floats; the cost is the warps' walk over
// the labels (n / 32 steps per root with a gated-in root). Launch 2 is
// M^2 pair tests and M^2 label reads per sweep, all in shared memory.
//
// Rounding: products and sums are explicit _rn intrinsics in the plain
// version's order; atan2f, cosf and sinf of the merged direction are the
// CUDA library's, so angles and endpoints agree with the plain version to
// a few ulps, and labels, roots and gates exactly.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float INF = 1e9f;
constexpr int SEG = 13;  // sp(2) ep(2) mid(2) du(2) half ang w wc2 ws2

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }

// unit eigenvector of the larger eigenvalue of [[sxx, sxy], [sxy, syy]]
// (lines.py::_principal_axis, with its 1e-12 / 1e-20 guards)
__device__ void principal_axis(float sxx, float syy, float sxy, float* nx,
                               float* ny) {
  const float tr = add(sxx, syy), diff = sub(sxx, syy);
  const float disc = __fsqrt_rn(
      add(add(mul(diff, diff), mul(mul(4.f, sxy), sxy)), 1e-20f));
  const float l1 = mul(0.5f, add(tr, disc));
  const bool big = fabsf(sxy) > 1e-12f;
  const float vx = big ? sxy : sub(l1, syy);
  const float vy = big ? sub(l1, sxx) : 1e-12f;
  const float n = __fsqrt_rn(add(add(mul(vx, vx), mul(vy, vy)), 1e-20f));
  *nx = dvd(vx, n);
  *ny = dvd(vy, n);
}

__global__ void refit_kernel(const int* __restrict__ root_id,
                             const int* __restrict__ lab,
                             const float* __restrict__ payload,
                             const float* __restrict__ cx,
                             const float* __restrict__ cy,
                             const float* __restrict__ he,
                             float* __restrict__ sp, float* __restrict__ ep,
                             float* __restrict__ score, int R, int n,
                             float x0, float y0, float len_th) {
  extern __shared__ int slab[];
  const int b = blockIdx.y;
  const int* labs = lab + (size_t)b * n;
  for (int t = threadIdx.x; t < n; t += blockDim.x) slab[t] = labs[t];
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (r >= R) return;
  const int rid = root_id[(size_t)b * R + r];
  const float* pay = payload + (size_t)b * n * 7;
  float acc[7] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (rid >= 0) {
    for (int t = lane; t < n; t += 32) {
      if (slab[t] != rid) continue;
#pragma unroll
      for (int k = 0; k < 7; ++k) acc[k] = add(acc[k], pay[(size_t)t * 7 + k]);
    }
  }
#pragma unroll
  for (int k = 0; k < 7; ++k) {
    for (int s = 16; s > 0; s >>= 1)
      acc[k] = add(acc[k], __shfl_down_sync(0xffffffffu, acc[k], s));
    acc[k] = __shfl_sync(0xffffffffu, acc[k], 0);
  }
  const float mS = acc[0];
  const float ms = fmaxf(mS, 1e-6f);
  const float mcx = dvd(acc[1], ms), mcy = dvd(acc[2], ms);
  const float mcxx = sub(dvd(acc[3], ms), mul(mcx, mcx));
  const float mcyy = sub(dvd(acc[4], ms), mul(mcy, mcy));
  const float mcxy = sub(dvd(acc[5], ms), mul(mcx, mcy));
  float mdx, mdy;
  principal_axis(mcxx, mcyy, mcxy, &mdx, &mdy);
  const float off = add(mul(mdx, mcx), mul(mdy, mcy));
  float pmin = INF, pmax = -INF;
  if (rid >= 0) {
    const size_t tb = (size_t)b * n;
    for (int t = lane; t < n; t += 32) {
      if (slab[t] != rid) continue;
      const float pc = sub(add(mul(sub(cx[tb + t], x0), mdx),
                               mul(sub(cy[tb + t], y0), mdy)), off);
      pmin = fminf(pmin, sub(pc, he[tb + t]));
      pmax = fmaxf(pmax, add(pc, he[tb + t]));
    }
  }
  for (int s = 16; s > 0; s >>= 1) {
    pmin = fminf(pmin, __shfl_down_sync(0xffffffffu, pmin, s));
    pmax = fmaxf(pmax, __shfl_down_sync(0xffffffffu, pmax, s));
  }
  if (lane != 0) return;
  const bool root_ok = rid >= 0 && mS > 0.f && acc[6] > 0.f;
  const float length = root_ok ? sub(pmax, pmin) : 0.f;
  const bool seg_ok = root_ok && length > len_th;
  const size_t o = (size_t)b * R + r;
  sp[2 * o] = add(add(mcx, x0), mul(pmin, mdx));
  sp[2 * o + 1] = add(add(mcy, y0), mul(pmin, mdy));
  ep[2 * o] = add(add(mcx, x0), mul(pmax, mdx));
  ep[2 * o + 1] = add(add(mcy, y0), mul(pmax, mdy));
  score[o] = seg_ok ? mS : 0.f;
}

__global__ void merge_kernel(const float* __restrict__ seg,
                             const uint8_t* __restrict__ valid,
                             float* __restrict__ sp_m, float* __restrict__ ep_m,
                             float* __restrict__ ang_m,
                             float* __restrict__ score_m,
                             uint8_t* __restrict__ root_out,
                             int* __restrict__ lab_out, int M, float ang_th,
                             float dist_th, float gap_th, int iters) {
  extern __shared__ float sm[];
  const int Wd = (M + 31) / 32;
  float* S = sm;                                              // M * SEG
  uint32_t* okb = reinterpret_cast<uint32_t*>(S + M * SEG);   // M * Wd
  uint32_t* sym = okb + M * Wd;                               // M * Wd
  int* A = reinterpret_cast<int*>(sym + M * Wd);              // M
  int* B = A + M;                                             // M
  int* v = B + M;                                             // M
  const int b = blockIdx.x;
  const float PI = 3.14159265358979323846f;
  for (int k = threadIdx.x; k < M * SEG; k += blockDim.x)
    S[k] = seg[(size_t)b * M * SEG + k];
  for (int i = threadIdx.x; i < M; i += blockDim.x)
    v[i] = valid[(size_t)b * M + i];
  __syncthreads();
  for (int i = threadIdx.x; i < M; i += blockDim.x) {
    const float* si = S + i * SEG;
    for (int wd = 0; wd < Wd; ++wd) {
      uint32_t bits = 0;
      for (int jj = 0; jj < 32; ++jj) {
        const int j = wd * 32 + jj;
        if (j >= M || !v[i] || !v[j]) continue;
        const float* sj = S + j * SEG;
        float dang = fabsf(sub(si[9], sj[9]));
        dang = fminf(dang, sub(PI, dang));
        const float r0 = sub(sj[4], si[4]), r1 = sub(sj[5], si[5]);
        const float off = fabsf(add(mul(-si[7], r0), mul(si[6], r1)));
        const float pm = add(mul(si[6], r0), mul(si[7], r1));
        const float gap = sub(fabsf(pm), add(si[8], sj[8]));
        if (dang < ang_th && off < dist_th && gap < gap_th) bits |= 1u << jj;
      }
      okb[i * Wd + wd] = bits;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < M; i += blockDim.x) {
    for (int wd = 0; wd < Wd; ++wd) {
      uint32_t bits = okb[i * Wd + wd], s = 0;
      for (int jj = 0; jj < 32; ++jj) {
        const int j = wd * 32 + jj;
        if (((bits >> jj) & 1) && ((okb[j * Wd + (i >> 5)] >> (i & 31)) & 1))
          s |= 1u << jj;
      }
      sym[i * Wd + wd] = s;
    }
    A[i] = v[i] ? i : M;
  }
  __syncthreads();
  for (int it = 0; it < iters; ++it) {
    for (int i = threadIdx.x; i < M; i += blockDim.x) {
      int m = A[i];
      for (int wd = 0; wd < Wd; ++wd) {
        uint32_t bits = sym[i * Wd + wd];
        while (bits) {
          const int jj = __ffs(bits) - 1;
          bits &= bits - 1;
          m = min(m, A[wd * 32 + jj]);
        }
      }
      B[i] = m;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < M; i += blockDim.x) {
      const int x = B[i];
      A[i] = min(x, B[min(max(x, 0), M - 1)]);
    }
    __syncthreads();
  }
  for (int r = threadIdx.x; r < M; r += blockDim.x) {
    float wsum = 0.f, c2 = 0.f, s2 = 0.f, cx = 0.f, cy = 0.f;
    for (int j = 0; j < M; ++j) {
      if (A[j] != r || !v[j]) continue;
      const float* sj = S + j * SEG;
      wsum = add(wsum, sj[10]);
      c2 = add(c2, sj[11]);
      s2 = add(s2, sj[12]);
      cx = add(cx, mul(sj[10], sj[4]));
      cy = add(cy, mul(sj[10], sj[5]));
    }
    const float am = mul(0.5f, atan2f(s2, c2));
    const float dmx = cosf(am), dmy = sinf(am);
    const float ws = fmaxf(wsum, 1e-6f);
    const float cenx = dvd(cx, ws), ceny = dvd(cy, ws);
    const float dcen = add(mul(dmx, cenx), mul(dmy, ceny));
    float lo = INF, hi = -INF;
    for (int j = 0; j < M; ++j) {
      if (A[j] != r || !v[j]) continue;
      const float* sj = S + j * SEG;
      const float ps = sub(add(mul(dmx, sj[0]), mul(dmy, sj[1])), dcen);
      const float pe = sub(add(mul(dmx, sj[2]), mul(dmy, sj[3])), dcen);
      lo = fminf(lo, fminf(ps, pe));
      hi = fmaxf(hi, fmaxf(ps, pe));
    }
    const bool is_root = v[r] && A[r] == r && wsum > 0.f;
    const size_t o = (size_t)b * M + r;
    sp_m[2 * o] = add(cenx, mul(lo, dmx));
    sp_m[2 * o + 1] = add(ceny, mul(lo, dmy));
    ep_m[2 * o] = add(cenx, mul(hi, dmx));
    ep_m[2 * o + 1] = add(ceny, mul(hi, dmy));
    ang_m[o] = am;
    score_m[o] = is_root ? wsum : 0.f;
    root_out[o] = is_root;
    lab_out[o] = A[r];
  }
}

}  // namespace

extern "C" {

// root_id (N, R) int32 (-1 empty), labels (N, n) int32, payload (N, n, 7),
// cx, cy, he (N, n) f32 -> sp, ep (N, R, 2), score (N, R) f32.
int lines_refit(const int* root_id, const int* lab, const float* payload,
                const float* cx, const float* cy, const float* he, float* sp,
                float* ep, float* score, int N, int R, int n, float x0,
                float y0, float len_th, cudaStream_t stream) {
  const int warps = 16;
  const size_t smem = (size_t)n * sizeof(int);
  cudaError_t e = cudaFuncSetAttribute(
      refit_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((R + warps - 1) / warps, N);
  refit_kernel<<<grid, warps * 32, smem, stream>>>(
      root_id, lab, payload, cx, cy, he, sp, ep, score, R, n, x0, y0, len_th);
  return (int)cudaGetLastError();
}

// seg (N, M, 13) per-segment table, valid (N, M) u8 -> merged sp, ep
// (N, M, 2), angle, score (N, M) f32, is_root (N, M) u8, labels (N, M).
int lines_merge(const float* seg, const uint8_t* valid, float* sp_m,
                float* ep_m, float* ang_m, float* score_m, uint8_t* root,
                int* lab, int N, int M, float ang_th, float dist_th,
                float gap_th, int iters, cudaStream_t stream) {
  const int Wd = (M + 31) / 32;
  const size_t smem = (size_t)M * SEG * sizeof(float) +
                      2 * (size_t)M * Wd * sizeof(uint32_t) +
                      3 * (size_t)M * sizeof(int);
  cudaError_t e = cudaFuncSetAttribute(
      merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  merge_kernel<<<N, 256, smem, stream>>>(seg, valid, sp_m, ep_m, ang_m,
                                         score_m, root, lab, M, ang_th,
                                         dist_th, gap_th, iters);
  return (int)cudaGetLastError();
}

}  // extern "C"
