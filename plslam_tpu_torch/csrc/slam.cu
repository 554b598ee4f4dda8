// Kernel J: the keyframe criterion scan over a tracked chunk (K14) and the
// landmark descriptor medoid (K16).
//
// kf_scan replaces plslam_tpu/backend/fused_slam.py::kf_scan (:83), a
// lax.scan over the B frames of a chunk. Per frame: Adj cov Adj^T + cov_i,
// a 6 x 6 slogdet by LU with partial pivoting (sign > 0 test), the entropy
// ratio against the first post-KF frame, the pose since the last KF (T_acc
// inverse-step compounding), its translation norm and rotation angle, and
// the kmax cap. Bound: latency. The scan is sequential (each frame's
// compounded covariance, pose and decision depend on the last) and its
// work is ~2,000 flops a frame.
// Design: one CTA of KF_SCAN_NT threads. The prologue loads DT, cov, good
// and the packed carry into shared memory in 16-byte pieces, then does the
// frame-local work of every frame at once, two threads a frame: Adj(DT_f)
// (from DT_f even where the frame is not good, as the reference), step_f
// (the latest good DT at or before f, else the carry's last_step: a ballot
// of good a 32-frame word and a find-last-set), inverse(step_f), and the
// pose a frame has if a KF fired on the frame before, I inverse(step_f),
// with its distances. Then five warps run the scan. The chain from frame
// to frame is the decision, and what a decision needs is known early:
// frame f's covariance is P_f + cov_f if no KF fired on frame f - 1, else
// cov_f, and P_f = Adj_f C_f-1 Adj_f^T is one of two values once frame
// f - 3 is decided, picked by frame f - 2's decision. Warp 2 forms both
// values a frame ahead. Warps 3 and 5 take the frames in turn: once frame
// f - 2 is decided, a warp factors both covariances frame f can have
// (lanes 0-5 and 8-13, a lane a row, in the same instructions), so two
// factorisations, the longest step, run at once. Warp 1 carries the pose
// since the last KF and its distances a frame ahead. Warp 0 picks, from
// what the others made ready, frame f's entropy and distances and decides.
// The warps hand on by ready flags in shared memory; where a value is one
// 64-bit store (an entropy pair, a distance pair) or one int (a decision,
// 1 + is_kf), the store is the flag, over a sentinel NaN no arithmetic
// returns, and no fence is needed; every wait is bounded, so a fault ends
// the launch with wrong outputs and never hangs it.
// The LU: a column's pivot is the first row of largest |A[i][c]| among
// rows c..5, which the single-thread kernel this one replaced found by a
// scan with a strict >; here the values, gathered by shuffles, meet in a
// tournament with ties to the earlier row (a NaN below row c never wins, a
// NaN at row c always does, as in the scan); the swap and the pivot row
// are shuffles from static register indices, issued before the division
// (its branch to a slow path ends a block); each row below the pivot
// updates its entries as A[i][j] -= f * A[c][j]; the six logs are one logf
// across the group's lanes, summed in column order. Every value is
// computed with the same operations in the same order as in the
// single-thread kernel. Warp 0 writes each frame's flag, blocked and
// ratio, and warp 1 each T_acc, to the output as it makes them; the carry
// goes out from shared memory at the end.
// The carry is one 16-byte aligned buffer of KF_CARRY_BYTES (the KF_CARRY_*
// byte offsets, mirrored by backend/fused_slam.py), read and written whole;
// the outputs and the carry out share one buffer, so the C entry takes
// five pointers.
//
// medoid replaces plslam_tpu/backend/map.py::_medoid_desc (:112) and what
// add_keyframe does with it (:242-244, :303-306): out[n] = valid[n] ?
// bits(medoid(ring[n], count[n])) : desc[n], the (N, 256) uint8 rows the map
// stores. The medoid is the ring member (of R packed 256-bit descriptors,
// the first min(count, R) valid) with the least summed Hamming distance to
// the valid members, the first index on ties as jnp.argmin; a row with no
// valid member takes member 0. Bound: bytes (8192 points and 1024 lines a
// keyframe: R x 32 bytes of ring or 256 of desc in, 256 out a row); the
// R^2 x 8 popcounts are cheap. A group of G lanes a landmark (G = R rounded
// up to a power of two): lane i loads member i as two 16-byte vectors
// (coalesced over the group), takes the others' words by shuffles, sums its
// distances, and the group's argmin is a shuffle butterfly (ties to the
// lower index). Each lane then writes 256 / G bytes of the row in 16-byte
// stores, the bits spread into bytes by a multiply; an invalid row copies
// desc in 16-byte vectors. One launch replaces the packed medoid and the
// torch unpack and select after it (~6 launches and an int64 (N, 8, 32)
// intermediate).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// the packed criterion carry: byte offsets of CritCarry's fields
constexpr int KF_CARRY_COV_KF = 0;       // (6, 6) f32
constexpr int KF_CARRY_T_ACC = 144;      // (4, 4) f32
constexpr int KF_CARRY_LAST_STEP = 208;  // (4, 4) f32
constexpr int KF_CARRY_EF = 272;         // f32
constexpr int KF_CARRY_FRAMES = 288;     // i32
constexpr int KF_CARRY_HAVE_COV = 304;   // u8
constexpr int KF_CARRY_HAVE_EF = 320;    // u8
constexpr int KF_CARRY_BYTES = 336;
// the largest chunk whose frames fit in shared memory (~101 KB at 128)
constexpr int KF_SCAN_MAX_B = 128, KF_SCAN_NT = 256;

// kf_scan's shared memory, in floats, every array 16-byte aligned: the
// carry in and out and the covariance warp's P_f + cov_f, then per frame
// DT, cov, Adj, inverse(step), the reset pose I inverse(step) and the two
// values P_f = Adj_f C_f-1 Adj_f^T can take (C_f-1 = P_f-1 + cov_f-1, then
// C_f-1 = cov_f-1; P_0 in both at frame 0), then the distances (t, r) of
// each frame's pose if no KF fired on the frame before and if one did, the
// entropies h of C_f if no KF fired on the frame before and if one did,
// the Q ready flag and the decision (1 + is_kf once made) a frame, then
// the good bytes and the good words
struct KfSmem {
  float *cin, *cout, *C, *dt, *cov, *adj, *inv, *R, *Q;
  float2 *dist_c, *dist_r, *h;
  int* rdy;
  uint8_t* good;
  uint32_t* words;
};

__host__ __device__ inline int kf_round4(int x) { return (x + 3) & ~3; }

__host__ __device__ inline size_t kf_smem_bytes(int B) {
  return 4 * (size_t)(240 + 200 * B) + kf_round4(B) +
         4 * (size_t)((B + 31) / 32);
}

__device__ inline KfSmem kf_smem(float* base, int B) {
  KfSmem s;
  s.cin = base;
  s.cout = base + 84;
  s.C = base + 168;
  s.dt = base + 240;
  s.cov = s.dt + 16 * B;
  s.adj = s.cov + 36 * B;
  s.inv = s.adj + 36 * B;
  s.R = s.inv + 16 * B;
  s.Q = s.R + 16 * B;
  s.dist_c = reinterpret_cast<float2*>(s.Q + 72 * B);
  s.dist_r = s.dist_c + B;
  s.h = s.dist_r + B;
  s.rdy = reinterpret_cast<int*>(s.h + B);
  s.good = reinterpret_cast<uint8_t*>(s.rdy + 2 * B);
  s.words = reinterpret_cast<uint32_t*>(s.good + kf_round4(B));
  return s;
}

// frame f's Q ready flag and decision: s.rdy[2 f + KF_RDY_*]
constexpr int KF_RDY_Q = 0, KF_RDY_KF = 1;
// a NaN that no operation returns (theirs is 0x7fffffff): the entropies
// and distances of a frame not made yet, which their one 64-bit store ends
constexpr uint32_t KF_EMPTY = 0x7fbadbadu;

// C = A B of n x n row-major matrices, each entry summed in k order
__device__ __forceinline__ void kf_matmul4(const float* A, const float* B,
                                           float* C) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float acc = 0.0f;
#pragma unroll
      for (int k = 0; k < 4; ++k) acc += A[i * 4 + k] * B[k * 4 + j];
      C[i * 4 + j] = acc;
    }
}

// translation norm and rotation angle of a pose
__device__ __forceinline__ float2 kf_dist(const float* T) {
  const float t = sqrtf(T[3] * T[3] + T[7] * T[7] + T[11] * T[11]);
  const float tr = T[0] + T[5] + T[10];
  return make_float2(t, acosf(fminf(fmaxf((tr - 1.0f) * 0.5f, -1.0f), 1.0f)));
}

// row r of Adj X Adj^T (X in shared memory), each entry summed in k order
__device__ __forceinline__ void kf_adj_row(const float* Adj, const float* X,
                                           int r, float* out) {
  float a[6], tmp[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) a[k] = Adj[r * 6 + k];
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < 6; ++k) acc += a[k] * X[k * 6 + j];
    tmp[j] = acc;
  }
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < 6; ++k) acc += tmp[k] * Adj[j * 6 + k];
    out[j] = acc;
  }
}

// a warp waits for another's ready flag: bounded, so that a fault upstream
// ends the launch with wrong outputs and never hangs it
__device__ __forceinline__ void kf_wait(const int* flag) {
  for (int i = 0; i < (1 << 22); ++i)
    if (*reinterpret_cast<const volatile int*>(flag)) break;
  __threadfence_block();
}

// a pair of floats that one 64-bit store publishes, once it is there
__device__ __forceinline__ float2 kf_take2(const float2* p) {
  unsigned long long v = 0;
  for (int i = 0; i < (1 << 22); ++i) {
    v = *reinterpret_cast<const volatile unsigned long long*>(p);
    if ((uint32_t)v != KF_EMPTY) break;
  }
  return make_float2(__uint_as_float((uint32_t)v),
                     __uint_as_float((uint32_t)(v >> 32)));
}

__device__ __forceinline__ void kf_give2(float2* p, float x, float y) {
  *reinterpret_cast<volatile unsigned long long*>(p) =
      (unsigned long long)__float_as_uint(x) |
      ((unsigned long long)__float_as_uint(y) << 32);
}

// frame f's decision, once made (the int is 1 + is_kf)
__device__ __forceinline__ bool kf_take_kf(const int* rdy, int f) {
  int v = 0;
  for (int i = 0; i < (1 << 22) && v == 0; ++i)
    v = *reinterpret_cast<const volatile int*>(rdy + 2 * f + KF_RDY_KF);
  return v == 2;
}

// every lane of a warp, after its stores: set the ready flag
__device__ __forceinline__ void kf_post(int* flag) {
  __threadfence_block();
  __syncwarp();
  if ((threadIdx.x & 31) == 0) *reinterpret_cast<volatile int*>(flag) = 1;
}

// of two pivot candidates, a before b: b where its key is strictly larger
__device__ __forceinline__ void kf_pick(float& ka, int& ia, float& va,
                                        float kb, int ib, float vb) {
  const bool take = kb > ka;
  ka = take ? kb : ka;
  ia = take ? ib : ia;
  va = take ? vb : va;
}

// n floats (a multiple of 4) from global to shared memory, in 16-byte
// pieces where the source is 16-byte aligned
__device__ inline void kf_load(float* dst, const float* __restrict__ src,
                               int n, int tid, int nt) {
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    for (int i = tid; i < n / 4; i += nt)
      reinterpret_cast<float4*>(dst)[i] =
          reinterpret_cast<const float4*>(src)[i];
  } else {
    for (int i = tid; i < n; i += nt) dst[i] = src[i];
  }
}

__global__ void __launch_bounds__(KF_SCAN_NT)
    kf_scan_kernel(const float* __restrict__ DT, const float* __restrict__ cov,
                   const uint8_t* __restrict__ good,
                   const uint8_t* __restrict__ carry_in,
                   uint8_t* __restrict__ out, int B, int min_frames, int kmax,
                   float min_ratio, float max_t, float r_cap) {
  extern __shared__ float4 kf_shared[];
  const KfSmem s = kf_smem(reinterpret_cast<float*>(kf_shared), B);
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31,
            warp = tid >> 5;
  const uint8_t* cin_b = reinterpret_cast<const uint8_t*>(s.cin);
  uint8_t* cout_b = reinterpret_cast<uint8_t*>(s.cout);

  // 1. the chunk and the carry into shared memory
  for (int i = tid; i < KF_CARRY_BYTES / 16; i += nt)
    reinterpret_cast<uint4*>(s.cin)[i] =
        reinterpret_cast<const uint4*>(carry_in)[i];
  kf_load(s.dt, DT, 16 * B, tid, nt);
  kf_load(s.cov, cov, 36 * B, tid, nt);
  for (int i = tid; i < B; i += nt) s.good[i] = good[i];
  for (int i = tid; i < KF_CARRY_BYTES / 4; i += nt) s.cout[i] = 0.0f;
  for (int i = tid; i < 2 * B; i += nt) s.rdy[i] = 0;
  for (int i = tid; i < B; i += nt) {
    s.h[i] = make_float2(__uint_as_float(KF_EMPTY), __uint_as_float(KF_EMPTY));
    s.dist_c[i] = s.h[i];
  }
  __syncthreads();
  for (int base = warp * 32; base < B; base += nt) {
    const unsigned m =
        __ballot_sync(0xffffffffu, base + lane < B && s.good[base + lane]);
    if (lane == 0) s.words[base / 32] = m;
  }
  __syncthreads();

  // 2. the frame-local work, two threads a frame where the CTA has them:
  // Adj(DT_f); then step_f, inverse(step_f), the pose after a KF on the
  // frame before (I inverse(step_f)) and its distances
  const int parts = 2 * B <= nt ? 2 : 1;
  for (int t = tid; t < parts * B; t += nt) {
    const int f = t % B, part = parts == 1 ? 2 : t / B;
    const float* D = s.dt + 16 * f;
    if (part != 1) {
      float* Adj = s.adj + 36 * f;
      // adjoint of DT (v, w ordering): [[R, skew(t) R], [0, R]]
      const float tx = D[3], ty = D[7], tz = D[11];
      const float S[9] = {0.f, -tz, ty, tz, 0.f, -tx, -ty, tx, 0.f};
      for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j) {
          const float r = D[i * 4 + j];
          Adj[i * 6 + j] = r;
          Adj[(i + 3) * 6 + j + 3] = r;
          Adj[i * 6 + j + 3] = S[i * 3 + 0] * D[0 * 4 + j] +
                               S[i * 3 + 1] * D[1 * 4 + j] +
                               S[i * 3 + 2] * D[2 * 4 + j];
          Adj[(i + 3) * 6 + j] = 0.0f;
        }
    }
    if (part == 0) continue;
    // step_f: the latest good frame at or before f (the reference's
    // where(good, DT, last_step) chain), else the carry's last_step
    int w = f >> 5;
    uint32_t m = s.words[w] & (0xffffffffu >> (31 - (f & 31)));
    while (m == 0 && w > 0) m = s.words[--w];
    const float* step = m ? s.dt + 16 * (32 * w + 31 - __clz(m))
                          : s.cin + KF_CARRY_LAST_STEP / 4;
    float inv[16], eye[16], R[16];
    for (int i = 0; i < 3; ++i) {
      for (int j = 0; j < 3; ++j) inv[i * 4 + j] = step[j * 4 + i];
      inv[i * 4 + 3] = -(step[0 * 4 + i] * step[3] + step[1 * 4 + i] * step[7] +
                         step[2 * 4 + i] * step[11]);
    }
    inv[12] = inv[13] = inv[14] = 0.0f;
    inv[15] = 1.0f;
#pragma unroll
    for (int i = 0; i < 16; ++i) eye[i] = i % 5 == 0 ? 1.0f : 0.0f;
    kf_matmul4(eye, inv, R);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      s.inv[16 * f + i] = inv[i];
      s.R[16 * f + i] = R[i];
    }
    s.dist_r[f] = kf_dist(R);
    if (f == B - 1)
      for (int i = 0; i < 16; ++i) s.cout[KF_CARRY_LAST_STEP / 4 + i] = step[i];
  }
  __syncthreads();

  // 3. the scan: five warps that hand frames on by ready flags (above)
  if (warp == 2) {
    // lanes 0-5 rows of Adj_g+1 (P_g + cov_g) Adj_g+1^T, lanes 8-13 rows of
    // Adj_g+1 cov_g Adj_g+1^T: P_g+1 is one of the two, by frame g - 1's
    // decision, and both are ready once frame g - 2 is decided
    const int base = lane & 8, r = min(lane & 7, 5);
    const bool have_cov0 = cin_b[KF_CARRY_HAVE_COV] != 0;
    float prod[6], Prow[6];
    kf_adj_row(s.adj, s.cin + KF_CARRY_COV_KF / 4, r, prod);
    // P_0 as both values of frame 0
    if (lane < 6 || (lane >= 8 && lane < 14)) {
#pragma unroll
      for (int j = 0; j < 6; ++j) s.Q[(base ? 36 : 0) + r * 6 + j] = prod[j];
    }
    kf_post(s.rdy + KF_RDY_Q);
    for (int g = 0; g < B; ++g) {
      // P_g: Adj_g C_g-1 Adj_g^T, C_g-1 = P_g-1 + cov_g-1 where frame g - 1
      // kept the covariance (no KF on frame g - 2), else cov_g-1
      bool have_prev = true;
      if (g == 1) {
        have_prev = have_cov0;
      } else if (g > 1) {
        have_prev = !kf_take_kf(s.rdy, g - 2);
      }
#pragma unroll
      for (int j = 0; j < 6; ++j) {
        const float q1 = __shfl_sync(0xffffffffu, prod[j], 8 + r);
        Prow[j] = have_prev ? prod[j] : q1;
      }
      if (g + 1 < B) {
        if (lane < 6) {
#pragma unroll
          for (int j = 0; j < 6; ++j)
            s.C[r * 6 + j] = Prow[j] + s.cov[36 * g + r * 6 + j];
        }
        __syncwarp();
        kf_adj_row(s.adj + 36 * (g + 1), base ? s.cov + 36 * g : s.C, r, prod);
        if (lane < 6 || (lane >= 8 && lane < 14)) {
#pragma unroll
          for (int j = 0; j < 6; ++j)
            s.Q[72 * (g + 1) + (base ? 36 : 0) + r * 6 + j] = prod[j];
        }
        kf_post(s.rdy + 2 * (g + 1) + KF_RDY_Q);
      }
    }
    // the carry's C_B-1
    bool have_last = have_cov0;
    if (B > 1) have_last = !kf_take_kf(s.rdy, B - 2);
    if (lane < 6) {
#pragma unroll
      for (int j = 0; j < 6; ++j) {
        const float c = s.cov[36 * (B - 1) + r * 6 + j];
        s.cout[KF_CARRY_COV_KF / 4 + r * 6 + j] = have_last ? Prow[j] + c : c;
      }
    }
  } else if (warp == 3 || warp == 5) {
    // lanes 0-5: P_f + cov_f; lanes 8-13: cov_f; the rest shadow row 5
    const int base = lane & 8, r = min(lane & 7, 5);
    const bool have_cov0 = cin_b[KF_CARRY_HAVE_COV] != 0;
    for (int f = warp == 3 ? 0 : 1; f < B; f += 2) {
      // P_f, by frame f - 2's decision
      kf_wait(s.rdy + 2 * f + KF_RDY_Q);
      const bool have_prev = f > 1 ? !kf_take_kf(s.rdy, f - 2)
                                   : (f == 0 || have_cov0);
      const float* Pf = s.Q + 72 * f + (have_prev ? 0 : 36);
      float row[6];
#pragma unroll
      for (int j = 0; j < 6; ++j) {
        const float c = s.cov[36 * f + r * 6 + j];
        row[j] = base ? c : Pf[r * 6 + j] + c;
      }
      // sign and log|det| by LU with partial pivoting, a lane a row
      float sg = 1.0f, piv_d[6];
      bool zero = false;
#pragma unroll
      for (int c = 0; c < 6; ++c) {
        float v[6];
#pragma unroll
        for (int i = c; i < 6; ++i)
          v[i] = __shfl_sync(0xffffffffu, row[c], base + i);
        // the pivot: the first row of largest |A[i][c]|, as a scan with a
        // strict > from row c takes it (a NaN below row c never; a NaN at
        // row c always), here as a tournament with ties to the earlier
        float key[6];
#pragma unroll
        for (int i = c; i < 6; ++i)
          key[i] = i == c ? (isnan(v[c]) ? INFINITY : fabsf(v[c]))
                          : (isnan(v[i]) ? -1.0f : fabsf(v[i]));
        int piv = c;
        float d = v[c], kbest = key[c];
        if (c + 1 < 6) {
          float k2 = key[c + 1], d2 = v[c + 1];
          int p2 = c + 1;
          if (c + 2 < 6) {
            float k3 = key[c + 2], d3 = v[c + 2];
            int p3 = c + 2;
            if (c + 3 < 6) kf_pick(k3, p3, d3, key[c + 3], c + 3, v[c + 3]);
            kf_pick(kbest, piv, d, k2, p2, d2);
            if (c + 4 < 6) {
              float k5 = key[c + 4], d5 = v[c + 4];
              int p5 = c + 4;
              if (c + 5 < 6) kf_pick(k5, p5, d5, key[c + 5], c + 5, v[c + 5]);
              kf_pick(kbest, piv, d, k3, p3, d3);
              kf_pick(kbest, piv, d, k5, p5, d5);
            } else {
              kf_pick(kbest, piv, d, k3, p3, d3);
            }
          } else {
            kf_pick(kbest, piv, d, k2, p2, d2);
          }
        }
        if (piv != c) sg = -sg;
        zero = zero || d == 0.0f;
        if (d < 0.0f) sg = -sg;
        piv_d[c] = d;
        if (c == 5) break;
        // this lane's row after the swap of rows c and piv: its entries by
        // shuffles (issued first: the division's branch to its slow path
        // ends the block), its factor from the values gathered above
        float p[6], o[6];
#pragma unroll
        for (int j = c + 1; j < 6; ++j) {
          p[j] = __shfl_sync(0xffffffffu, row[j], base + piv);
          o[j] = __shfl_sync(0xffffffffu, row[j], base + c);
        }
        const float f_row = (r == piv ? v[c] : row[c]) / d;
#pragma unroll
        for (int j = c + 1; j < 6; ++j) {
          float x = r == c ? p[j] : (r == piv ? o[j] : row[j]);
          if (r > c) x -= f_row * p[j];
          row[j] = x;
        }
      }
      // log |d_c| in lane c of the group, summed in column order
      float my_d = piv_d[0];
#pragma unroll
      for (int c = 1; c < 6; ++c)
        if (r == c) my_d = piv_d[c];
      const float lg = logf(fabsf(my_d));
      float la = 0.0f;
#pragma unroll
      for (int c = 0; c < 6; ++c) la += __shfl_sync(0xffffffffu, lg, base + c);
      const float h = (!zero && sg > 0.0f) ? 0.5f * la : -INFINITY;
      const float h_reset = __shfl_sync(0xffffffffu, h, 8);
      if (lane == 0) kf_give2(s.h + f, h, h_reset);
    }
  } else if (warp == 1) {
    float T[16], Tc[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) T[i] = s.cin[KF_CARRY_T_ACC / 4 + i];
    kf_matmul4(T, s.inv, Tc);
    if (lane == 0) {
      const float2 d = kf_dist(Tc);
      kf_give2(s.dist_c, d.x, d.y);
    }
    for (int f = 0; f < B; ++f) {
      const bool reset = f > 0 && kf_take_kf(s.rdy, f - 1);
#pragma unroll
      for (int i = 0; i < 16; ++i) T[i] = reset ? s.R[16 * f + i] : Tc[i];
      if (lane == 0) {
        float4* To = reinterpret_cast<float4*>(out + KF_CARRY_BYTES) + 4 * f;
#pragma unroll
        for (int i = 0; i < 4; ++i)
          To[i] = make_float4(T[4 * i], T[4 * i + 1], T[4 * i + 2],
                              T[4 * i + 3]);
      }
      if (f + 1 < B) {
        kf_matmul4(T, s.inv + 16 * (f + 1), Tc);
        if (lane == 0) {
          const float2 d = kf_dist(Tc);
          kf_give2(s.dist_c + f + 1, d.x, d.y);
        }
      }
    }
    const bool reset_last = kf_take_kf(s.rdy, B - 1);
    if (lane == 0) {
      const bool reset = reset_last;
#pragma unroll
      for (int i = 0; i < 16; ++i)
        s.cout[KF_CARRY_T_ACC / 4 + i] =
            reset ? (i % 5 == 0 ? 1.0f : 0.0f) : T[i];
    }
  } else if (warp == 0) {
    bool have_cov = cin_b[KF_CARRY_HAVE_COV] != 0;
    bool have_ef = cin_b[KF_CARRY_HAVE_EF] != 0;
    float ef = s.cin[KF_CARRY_EF / 4];
    int frames = reinterpret_cast<const int*>(s.cin)[KF_CARRY_FRAMES / 4];
    int n_fired = 0;
    bool kf_prev = false;
    for (int f = 0; f < B; ++f) {
      const float2 dist_r = s.dist_r[f];
      const bool good_f = s.good[f] != 0;
      const float2 hh = kf_take2(s.h + f);
      const float h = have_cov ? hh.x : hh.y;
      const float ef_new = have_ef ? ef : h;
      const float ratio = ef_new != 0.0f ? h / ef_new : 1.0f;
      const float2 dist = kf_prev ? dist_r : kf_take2(s.dist_c + f);
      const int fr = frames + 1;
      const bool crit =
          (ratio < min_ratio) || (dist.x > max_t) || (dist.y > r_cap);
      const bool want = good_f && fr >= min_frames && crit;
      const bool is_kf = want && n_fired < kmax;
      if (lane == 0) {
        *reinterpret_cast<volatile int*>(s.rdy + 2 * f + KF_RDY_KF) = 1 + is_kf;
        reinterpret_cast<float*>(out + KF_CARRY_BYTES + 64 * B)[f] = ratio;
        out[KF_CARRY_BYTES + 68 * B + f] = is_kf;
        out[KF_CARRY_BYTES + 69 * B + f] = want && n_fired >= kmax;
      }
      have_cov = !is_kf;
      ef = is_kf ? 0.0f : ef_new;
      have_ef = !is_kf;
      frames = is_kf ? 0 : fr;
      n_fired += is_kf;
      kf_prev = is_kf;
    }
    if (lane == 0) {
      s.cout[KF_CARRY_EF / 4] = ef;
      reinterpret_cast<int*>(s.cout)[KF_CARRY_FRAMES / 4] = frames;
      cout_b[KF_CARRY_HAVE_COV] = have_cov;
      cout_b[KF_CARRY_HAVE_EF] = have_ef;
    }
  }
  __syncthreads();

  // 4. the carry out (the scan wrote the rest as it went)
  for (int i = tid; i < KF_CARRY_BYTES / 16; i += nt)
    reinterpret_cast<uint4*>(out)[i] =
        reinterpret_cast<const uint4*>(s.cout)[i];
}

constexpr int MAX_RING = 8;

// four bits into the low bit of four bytes
__device__ __forceinline__ uint32_t spread4(uint32_t nib) {
  return (nib * 0x00204081u) & 0x01010101u;
}

template <int G>
__global__ void medoid_kernel(const uint4* __restrict__ ring,
                              const int* __restrict__ count,
                              const uint8_t* __restrict__ valid,
                              const uint4* __restrict__ desc,
                              uint4* __restrict__ out, int N, int R) {
  constexpr int PER = 16 / G;  // 16-byte chunks of the row a lane
  const int gid = blockIdx.x * blockDim.x + threadIdx.x;
  const int n = gid / G, i = gid % G;
  if (n >= N) return;  // the whole group: n is the group's
  const int lane = threadIdx.x & 31;
  const unsigned gm = (G == 32 ? 0xffffffffu : ((1u << G) - 1u))
                      << (lane & ~(G - 1));
  uint4* orow = out + (size_t)n * 16 + i * PER;
  if (!valid[n]) {
    const uint4* drow = desc + (size_t)n * 16 + i * PER;
#pragma unroll
    for (int k = 0; k < PER; ++k) orow[k] = drow[k];
    return;
  }
  const int nv = min(count[n], R);
  uint4 a = make_uint4(0u, 0u, 0u, 0u), b = a;
  if (i < R) {
    const uint4* m = ring + ((size_t)n * R + i) * 2;
    a = m[0];
    b = m[1];
  }
  int s = 0;
  for (int j = 0; j < R; ++j) {
    const uint32_t w0 = __shfl_sync(gm, a.x, j, G);
    const uint32_t w1 = __shfl_sync(gm, a.y, j, G);
    const uint32_t w2 = __shfl_sync(gm, a.z, j, G);
    const uint32_t w3 = __shfl_sync(gm, a.w, j, G);
    const uint32_t w4 = __shfl_sync(gm, b.x, j, G);
    const uint32_t w5 = __shfl_sync(gm, b.y, j, G);
    const uint32_t w6 = __shfl_sync(gm, b.z, j, G);
    const uint32_t w7 = __shfl_sync(gm, b.w, j, G);
    if (j < nv)
      s += __popc(a.x ^ w0) + __popc(a.y ^ w1) + __popc(a.z ^ w2) +
           __popc(a.w ^ w3) + __popc(b.x ^ w4) + __popc(b.y ^ w5) +
           __popc(b.z ^ w6) + __popc(b.w ^ w7);
  }
  if (i >= nv) s = 1 << 30;
  int best = i;
#pragma unroll
  for (int m = 1; m < G; m <<= 1) {  // argmin, the lower index on ties
    const int so = __shfl_xor_sync(gm, s, m, G);
    const int bo = __shfl_xor_sync(gm, best, m, G);
    if (so < s || (so == s && bo < best)) {
      s = so;
      best = bo;
    }
  }
  const uint32_t wd[8] = {
      __shfl_sync(gm, a.x, best, G), __shfl_sync(gm, a.y, best, G),
      __shfl_sync(gm, a.z, best, G), __shfl_sync(gm, a.w, best, G),
      __shfl_sync(gm, b.x, best, G), __shfl_sync(gm, b.y, best, G),
      __shfl_sync(gm, b.z, best, G), __shfl_sync(gm, b.w, best, G)};
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    // bytes 16 c .. 16 c + 15 of the row: bits (16 c) % 32 .. + 15 of word
    // 16 c / 32 (byte 32 w + j is bit j of word w, as hamming.unpack_bits)
    const int chunk = i * PER + k, sh = (chunk & 1) * 16;
    uint32_t word = wd[0];
#pragma unroll
    for (int t = 1; t < 8; ++t)
      if ((chunk >> 1) == t) word = wd[t];
    orow[k] = make_uint4(spread4((word >> sh) & 15u),
                         spread4((word >> (sh + 4)) & 15u),
                         spread4((word >> (sh + 8)) & 15u),
                         spread4((word >> (sh + 12)) & 15u));
  }
}

}  // namespace

extern "C" {

// DT (B, 4, 4) f32, cov (B, 6, 6) f32, good (B,) u8 and the packed carry
// (KF_CARRY_BYTES) -> out: the carry out, then T_accs (B, 4, 4) f32 at
// KF_CARRY_BYTES, ratios (B,) f32 at KF_CARRY_BYTES + 64 B, flags (B,) u8
// at KF_CARRY_BYTES + 68 B and blocked (B,) u8 at KF_CARRY_BYTES + 69 B.
// carry and out 16-byte aligned; B in 1..KF_SCAN_MAX_B.
int kf_scan(const float* DT, const float* cov, const uint8_t* good,
            const uint8_t* carry, uint8_t* out, int B, int min_frames,
            int kmax, float min_ratio, float max_t, float r_cap,
            cudaStream_t stream) {
  if (B < 1 || B > KF_SCAN_MAX_B) return (int)cudaErrorInvalidValue;
  if ((((uintptr_t)carry) | ((uintptr_t)out)) & 15)
    return (int)cudaErrorMisalignedAddress;
  const size_t smem = kf_smem_bytes(B);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kf_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kf_scan_kernel<<<1, KF_SCAN_NT, smem, stream>>>(
      DT, cov, good, carry, out, B, min_frames, kmax, min_ratio, max_t,
      r_cap);
  return (int)cudaGetLastError();
}

// ring (N, R, 8) packed words, count (N,) i32, valid (N,) u8, desc (N, 256)
// u8 -> out (N, 256) u8: valid ? the medoid's bits : desc. Every pointer
// 16-byte aligned; R in 1..MAX_RING.
int medoid(const uint32_t* ring, const int* count, const uint8_t* valid,
           const uint8_t* desc, uint8_t* out, int N, int R,
           cudaStream_t stream) {
  if (R < 1 || R > MAX_RING) return (int)cudaErrorInvalidValue;
  if ((((uintptr_t)ring) | ((uintptr_t)desc) | ((uintptr_t)out)) & 15)
    return (int)cudaErrorMisalignedAddress;
  const int G = R <= 1 ? 1 : R <= 2 ? 2 : R <= 4 ? 4 : 8;
  const int threads = 256;
  const int blocks = (int)(((size_t)N * G + threads - 1) / threads);
  const uint4* r4 = reinterpret_cast<const uint4*>(ring);
  const uint4* d4 = reinterpret_cast<const uint4*>(desc);
  uint4* o4 = reinterpret_cast<uint4*>(out);
  switch (G) {
    case 1:
      medoid_kernel<1><<<blocks, threads, 0, stream>>>(r4, count, valid, d4,
                                                       o4, N, R);
      break;
    case 2:
      medoid_kernel<2><<<blocks, threads, 0, stream>>>(r4, count, valid, d4,
                                                       o4, N, R);
      break;
    case 4:
      medoid_kernel<4><<<blocks, threads, 0, stream>>>(r4, count, valid, d4,
                                                       o4, N, R);
      break;
    default:
      medoid_kernel<8><<<blocks, threads, 0, stream>>>(r4, count, valid, d4,
                                                       o4, N, R);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
