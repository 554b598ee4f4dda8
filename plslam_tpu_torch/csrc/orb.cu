// Kernel C: orientation and steered BRIEF bits of ORB keypoints (K5).
//
// Replaces plslam_tpu/ops/orb.py::describe_multilevel (:131) after its
// moment filters (lines :175-220): the octave clamp, the orientation
// atan2 of the half-res moments read at each keypoint, its 32-bin
// quantisation, the full-res centre clamp, the one-hot selection of the
// rotated (dy, dx) offsets, the flat gather of 64 pool samples and the
// (64, 256) +-1 pair-difference matmul. Each column of that matrix holds
// one +1 (p1) and one -1 (p0), so bit j is pool[p1] > pool[p0].
//
// One launch from the keypoints to the bits and the angle. The pyramid
// levels are read where they lie (a by-value table of up to 8 level
// pointers and shapes, no concatenated copy), and the half-res moment
// maps from their flat buffers. The per-keypoint arithmetic is the torch
// plain version's, operation for operation: rintf is torch.round (half
// to even), the float -> int casts truncate, atan2f is the function
// torch's CUDA atan2 calls for float (this file is built without fast
// math, as torch's kernels), and the bin is rintf(theta * 32/2pi) taken
// modulo 32 with the divisor's sign; so bits and theta are bit-equal to
// the plain version on the card.
//
// Bound: scattered bytes. A keypoint reads 64 scattered pixels (~29
// distinct 32-byte sectors of a 1241-wide level; the levels are 187 MB at
// 40 x 376 x 1241, far past L2) and writes 256 bytes; the compares are
// free. The grid is CTAS_PER_SM CTAs a SM, each looping over batches of
// KPB keypoints a warp. The (32, 64) offset table, packed to one int16
// (dy, dx) an entry, is loaded into shared memory once a CTA; each lane
// holds its 16 pair indices (8 pairs) in four registers for the whole
// run. A batch's orientation is lane-parallel: lane l < KPB loads
// keypoint l's uv and octave, its two moments, and computes theta, the
// bin and the centre, so the batch pays the two dependent round trips of
// that prologue once. The warp then samples its keypoints GROUP at a
// time: each lane issues its two samples of GROUP keypoints before any
// pair test, so 2 x GROUP loads a lane are in flight together. Each lane
// writes its 8 bit bytes as one 8-byte store: a keypoint's 256 bytes are
// one coalesced warp store. On the H100 at 40 x 1,024 keypoints, batches
// of 8 sampled all at once ran faster than batches of 32 sampled 4 or 8
// at a time; more CTAs a SM than 4 ran slower.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int N_POOL = 64, N_BITS = 256, N_BINS = 32, MAX_LEVELS = 8;
constexpr int PATCH_HALF = 15;
constexpr int WARPS = 8, KPB = 8, GROUP = 8, CTAS_PER_SM = 4;

struct Levels {
  const float* img[MAX_LEVELS];  // (N, H, W) each, contiguous
  int H[MAX_LEVELS], W[MAX_LEVELS];
  int hbase[MAX_LEVELS], hH[MAX_LEVELS], hW[MAX_LEVELS];
  int n;
};

__global__ void __launch_bounds__(WARPS * 32, CTAS_PER_SM)
    orb_describe_kernel(const Levels lv, const float* __restrict__ m10,
                        const float* __restrict__ m01, int n_half,
                        const float2* __restrict__ uv,
                        const int* __restrict__ octave,
                        const int16_t* __restrict__ rot,    // (32, 64)
                        const uint4* __restrict__ pairs,    // (32,) lanes
                        uint8_t* __restrict__ bits, float* __restrict__ theta,
                        int N, int K) {
  __shared__ int16_t s_rot[N_BINS * N_POOL];
  __shared__ float s_pool[WARPS][GROUP][N_POOL];
  __shared__ Levels s_lv;
  for (int i = threadIdx.x; i < N_BINS * N_POOL; i += blockDim.x)
    s_rot[i] = rot[i];
  if (threadIdx.x == 0) s_lv = lv;
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // lane l tests the pairs 8l .. 8l + 7: byte 2q = p0, 2q + 1 = p1
  const uint4 pq = pairs[lane];
  const uint32_t pw[4] = {pq.x, pq.y, pq.z, pq.w};
  const float scale = (float)(N_BINS / (2.0 * 3.14159265358979323846));
  const int NK = N * K;
  float* pool = s_pool[warp][0];
  for (int base = (blockIdx.x * WARPS + warp) * KPB; base < NK;
       base += gridDim.x * WARPS * KPB) {
    // the batch's orientation, one keypoint a lane
    const int kp = base + lane;
    int meta = 0;          // W << 8 | level << 5 | bin
    long long off = 0;     // the centre's offset in its level's buffer
    if (lane < KPB && kp < NK) {
      const int n = kp / K;
      const int o = min(max(octave[kp], 0), s_lv.n - 1);
      const float2 p = uv[kp];
      const int hW = s_lv.hW[o], hH = s_lv.hH[o];
      const int u2 = min(max((int)rintf(p.x * 0.5f), 0), hW - 1);
      const int v2 = min(max((int)rintf(p.y * 0.5f), 0), hH - 1);
      const size_t hidx =
          (size_t)n * n_half + s_lv.hbase[o] + (size_t)v2 * hW + u2;
      const float th = atan2f(m01[hidx], m10[hidx]);
      theta[kp] = th;
      // torch.remainder(r, 32) of the rounded r in [-16, 16]
      const float r = rintf(th * scale);
      float md = fmodf(r, (float)N_BINS);
      if (md != 0.f && md < 0.f) md += (float)N_BINS;
      const int bin = (int)md;
      const int W = s_lv.W[o], H = s_lv.H[o];
      const int u = min(max((int)rintf(p.x), PATCH_HALF), W - 1 - PATCH_HALF);
      const int v = min(max((int)rintf(p.y), PATCH_HALF), H - 1 - PATCH_HALF);
      meta = (W << 8) | (o << 5) | (bin & (N_BINS - 1));
      off = ((long long)n * H + v) * W + u;
    }
    const int cnt = min(KPB, NK - base);
    for (int j0 = 0; j0 < cnt; j0 += GROUP) {
      float s[GROUP][2];
#pragma unroll
      for (int g = 0; g < GROUP; ++g) {
        const int j = min(j0 + g, cnt - 1);
        const int mj = __shfl_sync(0xffffffffu, meta, j);
        const long long oj = __shfl_sync(0xffffffffu, off, j);
        const float* img = s_lv.img[(mj >> 5) & 7] + oj;
        const int W = mj >> 8;
        const int16_t* tab = s_rot + (mj & (N_BINS - 1)) * N_POOL;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int e = tab[lane + 32 * h];
          const int dy = (int)(int8_t)(e >> 8), dx = (int)(int8_t)(e & 0xff);
          s[g][h] = __ldg(img + dy * W + dx);
        }
      }
#pragma unroll
      for (int g = 0; g < GROUP; ++g) {
        pool[g * N_POOL + lane] = s[g][0];
        pool[g * N_POOL + lane + 32] = s[g][1];
      }
      __syncwarp();
#pragma unroll
      for (int g = 0; g < GROUP; ++g) {
        if (j0 + g < cnt) {
          const float* q = pool + g * N_POOL;
          uint32_t lo = 0, hi = 0;
#pragma unroll
          for (int b = 0; b < 8; ++b) {
            const uint32_t w = pw[b / 2] >> (16 * (b % 2));
            const uint32_t bit = q[(w >> 8) & 0xff] > q[w & 0xff];
            if (b < 4) lo |= bit << (8 * b);
            else hi |= bit << (8 * (b - 4));
          }
          reinterpret_cast<uint2*>(bits + (size_t)(base + j0 + g) * N_BITS)
              [lane] = make_uint2(lo, hi);
        }
      }
      __syncwarp();
    }
  }
}

}  // namespace

extern "C" {

// levels: a host table of n_lvl rows (pointer, H, W, half base, half H,
// half W) as int64, the level tensors (N, H, W) f32 on the card; m10, m01
// (N, n_half) f32, each level's half-res map at its half base; uv (N, K,
// 2) f32 level-local; octave (N, K) int32; rot (32, 64) int16 (dy << 8 |
// dx & 0xff); pairs (32, 16) u8, lane l's 8 pairs (p0, p1) -> bits (N,
// K, 256) u8 in {0, 1}, theta (N, K) f32.
int orb_describe(const long long* levels, int n_lvl, const float* m10,
                 const float* m01, int n_half, const float* uv,
                 const int* octave, const int16_t* rot, const uint8_t* pairs,
                 uint8_t* bits, float* theta, int N, int K,
                 cudaStream_t stream) {
  static_assert(N_BINS == 32, "rotation table has 32 angle bins");
  if (n_lvl < 1 || n_lvl > MAX_LEVELS || N < 1 || K < 1)
    return (int)cudaErrorInvalidValue;
  Levels lv{};
  lv.n = n_lvl;
  for (int i = 0; i < n_lvl; ++i) {
    const long long* r = levels + 6 * i;
    lv.img[i] = reinterpret_cast<const float*>(r[0]);
    lv.H[i] = (int)r[1];
    lv.W[i] = (int)r[2];
    lv.hbase[i] = (int)r[3];
    lv.hH[i] = (int)r[4];
    lv.hW[i] = (int)r[5];
    // the packed meta word holds W in 23 bits; the centre clamp needs
    // room for the patch
    if (lv.W[i] >= (1 << 23) || lv.H[i] < 2 * PATCH_HALF + 1 ||
        lv.W[i] < 2 * PATCH_HALF + 1 || lv.hH[i] < 1 || lv.hW[i] < 1)
      return (int)cudaErrorInvalidValue;
  }
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const long long batches =
      ((long long)N * K + WARPS * KPB - 1) / (WARPS * KPB);
  const long long most = (long long)CTAS_PER_SM * sms;
  const int blocks = (int)(batches < most ? batches : most);
  orb_describe_kernel<<<blocks, WARPS * 32, 0, stream>>>(
      lv, m10, m01, n_half, reinterpret_cast<const float2*>(uv), octave, rot,
      reinterpret_cast<const uint4*>(pairs), bits, theta, N, K);
  return (int)cudaGetLastError();
}

}  // extern "C"
