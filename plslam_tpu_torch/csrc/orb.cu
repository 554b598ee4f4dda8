// Kernel C: steered 64-point pool gather and 256 pair tests (K5).
//
// Replaces the sampling and bit stage of
// plslam_tpu/ops/orb.py::describe_multilevel (:131, lines :204-220): the
// one-hot selection of the rotated (dy, dx) offsets, the flat gather of
// K x 64 pool samples from the concatenated pyramid levels, and the
// (64, 256) +-1 pair-difference matmul. Each column of that matrix holds
// exactly one +1 (p1) and one -1 (p0), so bit j is pool[p1] > pool[p0].
// The angle (atan2 of the gathered half-res moments) and its 32-bin
// quantisation stay in PyTorch, so this kernel is exact.
//
// Bound: bytes, and latency of scattered reads. Per keypoint it reads 64
// scattered floats from a ~1.2 M-pixel level buffer (mostly L2 hits: the
// 31x31 support of neighbouring keypoints overlaps) and writes 256 bytes;
// the 256 compares are free. One warp per keypoint: each lane gathers two
// pool samples into shared memory, then writes 8 consecutive bit bytes as
// one 8-byte store, so the output is written coalesced. The (32, 64, 2)
// offset table (16 KB) stays in global memory and is served from L1/L2:
// the lanes of a warp read 32 different entries of it, which constant
// memory would serialise, and staging the whole table in shared memory
// would copy 16 KB for every 4 keypoints. The 256 pairs are staged once
// per block in shared memory, where every lane reads them.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int N_POOL = 64, N_BITS = 256, N_BINS = 32, WARPS = 4;

__global__ void orb_describe_kernel(const float* __restrict__ flat,
                                    const int* __restrict__ center,
                                    const int* __restrict__ width,
                                    const int* __restrict__ bins,
                                    const int* __restrict__ rot,  // (32,64,2)
                                    const int* __restrict__ pairs,  // (256,2)
                                    uint8_t* __restrict__ bits, int N, int K,
                                    int L) {
  __shared__ int s_pairs[N_BITS * 2];
  __shared__ float s_pool[WARPS][N_POOL];
  for (int i = threadIdx.x; i < N_BITS * 2; i += blockDim.x)
    s_pairs[i] = pairs[i];
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int kp = blockIdx.x * WARPS + warp;  // flat (n, k) keypoint index
  if (kp >= N * K) return;
  const int n = kp / K;
  const float* img = flat + (size_t)n * L;
  const int c = center[kp], w = width[kp], b = bins[kp];
  const int* off = rot + (size_t)b * N_POOL * 2;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    int p = lane + 32 * h;
    s_pool[warp][p] = img[c + off[2 * p] * w + off[2 * p + 1]];
  }
  __syncwarp();
  uint8_t out[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    int j = lane * 8 + q;
    out[q] = s_pool[warp][s_pairs[2 * j + 1]] > s_pool[warp][s_pairs[2 * j]];
  }
  uint2 v;
  v.x = out[0] | (out[1] << 8) | (out[2] << 16) | ((unsigned)out[3] << 24);
  v.y = out[4] | (out[5] << 8) | (out[6] << 16) | ((unsigned)out[7] << 24);
  reinterpret_cast<uint2*>(bits + (size_t)kp * N_BITS)[lane] = v;
}

}  // namespace

extern "C" {

// flat (N, L) concatenated levels; center/width/bins (N, K) int32;
// rot (32, 64, 2) int32 (dy, dx); pairs (256, 2) int32 (p0, p1)
// -> bits (N, K, 256) u8 in {0, 1}.
int orb_describe(const float* flat, const int* center, const int* width,
                 const int* bins, const int* rot, const int* pairs,
                 uint8_t* bits, int N, int K, int L, cudaStream_t stream) {
  static_assert(N_BINS == 32, "rotation table has 32 angle bins");
  int blocks = (N * K + WARPS - 1) / WARPS;
  orb_describe_kernel<<<blocks, WARPS * 32, 0, stream>>>(
      flat, center, width, bins, rot, pairs, bits, N, K, L);
  return (int)cudaGetLastError();
}

}  // extern "C"
