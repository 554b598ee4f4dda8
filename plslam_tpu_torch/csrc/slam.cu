// Kernel J: the keyframe criterion scan over a tracked chunk (K14) and the
// landmark descriptor medoid (K16).
//
// kf_scan replaces plslam_tpu/backend/fused_slam.py::kf_scan (:83), a
// lax.scan over the B frames of a chunk. Bound: latency. The scan is
// sequential (each frame's compounded covariance and pose depend on the
// last), and its work is ~2,000 flops a frame, so one thread runs the B
// frames in order with the carry in registers: one launch replaces ~30 small
// PyTorch ops per frame. Per frame: Adj cov Adj^T + cov_i, a 6 x 6 slogdet by
// LU with partial pivoting (sign > 0 test), the entropy ratio against the
// first post-KF frame, the pose since the last KF (T_acc inverse-step
// compounding), its translation norm and rotation angle, and the kmax cap.
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

__device__ void matmul(const float* A, const float* B, float* C, int n) {
  for (int i = 0; i < n; ++i)
    for (int j = 0; j < n; ++j) {
      float s = 0.0f;
      for (int k = 0; k < n; ++k) s += A[i * n + k] * B[k * n + j];
      C[i * n + j] = s;
    }
}

// sign and log|det| of a 6 x 6 by LU with partial pivoting
__device__ void slogdet6(const float* M, float* sign, float* logabs) {
  float A[36];
  for (int i = 0; i < 36; ++i) A[i] = M[i];
  float sg = 1.0f, la = 0.0f;
  for (int c = 0; c < 6; ++c) {
    int piv = c;
    for (int i = c + 1; i < 6; ++i)
      if (fabsf(A[i * 6 + c]) > fabsf(A[piv * 6 + c])) piv = i;
    if (piv != c) {
      sg = -sg;
      for (int j = 0; j < 6; ++j) {
        float t = A[c * 6 + j];
        A[c * 6 + j] = A[piv * 6 + j];
        A[piv * 6 + j] = t;
      }
    }
    const float d = A[c * 6 + c];
    if (d == 0.0f) {
      *sign = 0.0f;
      *logabs = -INFINITY;
      return;
    }
    if (d < 0.0f) sg = -sg;
    la += logf(fabsf(d));
    for (int i = c + 1; i < 6; ++i) {
      const float f = A[i * 6 + c] / d;
      for (int j = c; j < 6; ++j) A[i * 6 + j] -= f * A[c * 6 + j];
    }
  }
  *sign = sg;
  *logabs = la;
}

__global__ void kf_scan_kernel(
    const float* __restrict__ DT, const float* __restrict__ cov,
    const uint8_t* __restrict__ good, const float* cov_kf_in,
    const uint8_t* have_cov_in, const float* ef_in, const uint8_t* have_ef_in,
    const int* frames_in, const float* T_acc_in, const float* last_step_in,
    uint8_t* flags, float* T_accs, float* ratios, uint8_t* blocked,
    float* cov_kf_out, uint8_t* have_cov_out, float* ef_out,
    uint8_t* have_ef_out, int* frames_out, float* T_acc_out,
    float* last_step_out, int B, int min_frames, int kmax, float min_ratio,
    float max_t, float r_cap) {
  if (blockIdx.x != 0 || threadIdx.x != 0) return;
  float C[36], T[16], last[16];
  for (int i = 0; i < 36; ++i) C[i] = cov_kf_in[i];
  for (int i = 0; i < 16; ++i) {
    T[i] = T_acc_in[i];
    last[i] = last_step_in[i];
  }
  bool have_cov = *have_cov_in != 0, have_ef = *have_ef_in != 0;
  float ef = *ef_in;
  int frames = *frames_in, n_fired = 0;
  for (int f = 0; f < B; ++f) {
    const float* D = DT + 16 * f;
    const bool g = good[f] != 0;
    float step[16];
    for (int i = 0; i < 16; ++i) step[i] = g ? D[i] : last[i];
    // adjoint of DT (v, w ordering): [[R, skew(t) R], [0, R]]
    float Adj[36] = {0.0f}, AdjT[36], tmp[36], cn[36];
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
      }
    for (int i = 0; i < 6; ++i)
      for (int j = 0; j < 6; ++j) AdjT[i * 6 + j] = Adj[j * 6 + i];
    if (have_cov) {
      matmul(Adj, C, tmp, 6);
      matmul(tmp, AdjT, cn, 6);
      for (int i = 0; i < 36; ++i) cn[i] += cov[36 * f + i];
    } else {
      for (int i = 0; i < 36; ++i) cn[i] = cov[36 * f + i];
    }
    float sign, logabs;
    slogdet6(cn, &sign, &logabs);
    const float h = sign > 0.0f ? 0.5f * logabs : -INFINITY;
    const float ef_new = have_ef ? ef : h;
    const float ratio = ef_new != 0.0f ? h / ef_new : 1.0f;
    // T_acc <- T_acc inverse(step)
    float inv[16] = {0.0f}, Tn[16];
    for (int i = 0; i < 3; ++i) {
      for (int j = 0; j < 3; ++j) inv[i * 4 + j] = step[j * 4 + i];
      inv[i * 4 + 3] = -(step[0 * 4 + i] * step[3] + step[1 * 4 + i] * step[7] +
                         step[2 * 4 + i] * step[11]);
    }
    inv[15] = 1.0f;
    matmul(T, inv, Tn, 4);
    const float t_dist =
        sqrtf(Tn[3] * Tn[3] + Tn[7] * Tn[7] + Tn[11] * Tn[11]);
    const float tr = Tn[0] + Tn[5] + Tn[10];
    const float r_dist = acosf(fminf(fmaxf((tr - 1.0f) * 0.5f, -1.0f), 1.0f));
    const int fr = frames + 1;
    const bool crit = (ratio < min_ratio) || (t_dist > max_t) || (r_dist > r_cap);
    const bool want = g && fr >= min_frames && crit;
    const bool is_kf = want && n_fired < kmax;
    flags[f] = is_kf;
    blocked[f] = want && n_fired >= kmax;
    ratios[f] = ratio;
    for (int i = 0; i < 16; ++i) T_accs[16 * f + i] = Tn[i];
    for (int i = 0; i < 36; ++i) C[i] = cn[i];
    have_cov = !is_kf;
    ef = is_kf ? 0.0f : ef_new;
    have_ef = !is_kf;
    frames = is_kf ? 0 : fr;
    for (int i = 0; i < 16; ++i) {
      T[i] = is_kf ? (i % 5 == 0 ? 1.0f : 0.0f) : Tn[i];
      last[i] = step[i];
    }
    n_fired += is_kf;
  }
  for (int i = 0; i < 36; ++i) cov_kf_out[i] = C[i];
  for (int i = 0; i < 16; ++i) {
    T_acc_out[i] = T[i];
    last_step_out[i] = last[i];
  }
  *have_cov_out = have_cov;
  *ef_out = ef;
  *have_ef_out = have_ef;
  *frames_out = frames;
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

// DT (B, 4, 4), cov (B, 6, 6), good (B,) u8 and the criterion carry in
// (cov_kf (6, 6), have_cov u8, ef, have_ef u8, frames i32, T_acc (4, 4),
// last_step (4, 4)) -> flags (B,) u8, T_accs (B, 4, 4), ratios (B,),
// blocked (B,) u8 and the carry out, in separate buffers.
int kf_scan(const float* DT, const float* cov, const uint8_t* good,
            const float* cov_kf, const uint8_t* have_cov, const float* ef,
            const uint8_t* have_ef, const int* frames, const float* T_acc,
            const float* last_step, uint8_t* flags, float* T_accs,
            float* ratios, uint8_t* blocked, float* cov_kf_o,
            uint8_t* have_cov_o, float* ef_o, uint8_t* have_ef_o,
            int* frames_o, float* T_acc_o, float* last_step_o, int B,
            int min_frames, int kmax, float min_ratio, float max_t,
            float r_cap, cudaStream_t stream) {
  kf_scan_kernel<<<1, 32, 0, stream>>>(
      DT, cov, good, cov_kf, have_cov, ef, have_ef, frames, T_acc, last_step,
      flags, T_accs, ratios, blocked, cov_kf_o, have_cov_o, ef_o, have_ef_o,
      frames_o, T_acc_o, last_step_o, B, min_frames, kmax, min_ratio, max_t,
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
