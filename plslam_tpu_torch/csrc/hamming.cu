// Kernel D: masked Hamming distance matrix and NN-ratio matching (K6),
// two launches, batched over B frame pairs.
//
// Replaces plslam_tpu/ops/hamming.py::hamming_matrix (:30) with
// apply_mask (:91), and match_nnr (:57). The reference computes the
// distance as a +-1 bf16 matmul on the MXU (exact); here it is __popc of
// the XOR of 8 packed 32-bit words (pack_bits layout, :95-99).
//
// Bound: bytes. Launch 1 reads the (B, N, M) bool mask and writes the
// f32 distance matrix (5 bytes per entry); the descriptors (32 bytes per
// row) are staged once per 32x32 tile in shared memory and the 8 popcounts
// per entry are cheap. Launch 2 reads the matrix twice: once by columns
// (coalesced across threads) for the reverse argmin of the mutual check,
// once by rows (one warp per row) for the best, second-best and gates.
//
// Exactness: distances are integers; every argmin reduces on the pair
// (distance, index) so ties go to the lowest index, as jnp.argmin does.
// The second best is the minimum over all columns but the best one, with
// the reference's 1e9 sentinel as its ceiling.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float INVALID = 1e9f;
constexpr int T = 32, WORDS = 8;

__global__ void dist_kernel(const uint32_t* __restrict__ pa,
                            const uint32_t* __restrict__ pb,
                            const uint8_t* __restrict__ va,
                            const uint8_t* __restrict__ vb,
                            const uint8_t* __restrict__ mask,
                            float* __restrict__ dist, int N, int M) {
  __shared__ uint32_t sa[T][WORDS + 1];
  __shared__ uint32_t sb[T][WORDS + 1];
  const int b = blockIdx.z, i0 = blockIdx.y * T, j0 = blockIdx.x * T;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  for (int idx = tid; idx < T * WORDS; idx += blockDim.x * blockDim.y) {
    int r = idx / WORDS, w = idx % WORDS;
    sa[r][w] = i0 + r < N ? pa[((size_t)b * N + i0 + r) * WORDS + w] : 0u;
    sb[r][w] = j0 + r < M ? pb[((size_t)b * M + j0 + r) * WORDS + w] : 0u;
  }
  __syncthreads();
  const int j = j0 + threadIdx.x;
  if (j >= M) return;
  const bool vj = vb[(size_t)b * M + j] != 0;
  for (int rr = threadIdx.y; rr < T && i0 + rr < N; rr += blockDim.y) {
    const int i = i0 + rr;
    const size_t o = ((size_t)b * N + i) * M + j;
    int d = 0;
#pragma unroll
    for (int w = 0; w < WORDS; ++w) d += __popc(sa[rr][w] ^ sb[threadIdx.x][w]);
    const bool ok = vj && va[(size_t)b * N + i] && mask[o];
    dist[o] = ok ? (float)d : INVALID;
  }
}

// best_rev[b, j] = first argmin over i of dist[b, i, j]
__global__ void col_argmin_kernel(const float* __restrict__ dist,
                                  int* __restrict__ best_rev, int B, int N,
                                  int M) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= B * M) return;
  const int b = t / M, j = t % M;
  const float* col = dist + (size_t)b * N * M + j;
  float best = INFINITY;
  int arg = 0;
  for (int i = 0; i < N; ++i) {
    float v = col[(size_t)i * M];
    if (v < best) { best = v; arg = i; }
  }
  best_rev[t] = arg;
}

__global__ void row_match_kernel(const float* __restrict__ dist,
                                 const int* __restrict__ best_rev,
                                 int* __restrict__ idx_out,
                                 float* __restrict__ d1_out,
                                 uint8_t* __restrict__ ok_out, int B, int N,
                                 int M, float max_dist, float ratio,
                                 int mutual) {
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (warp >= B * N) return;
  const int b = warp / N, i = warp % N;
  const float* row = dist + (size_t)warp * M;
  float v1 = INFINITY, v2 = INFINITY;
  int i1 = 0x7fffffff;
  for (int j = lane; j < M; j += 32) {  // increasing j: strict < keeps first
    float v = row[j];
    if (v < v1) { v2 = v1; v1 = v; i1 = j; }
    else if (v < v2) { v2 = v; }
  }
  for (int s = 16; s > 0; s >>= 1) {
    float o1 = __shfl_down_sync(0xffffffffu, v1, s);
    int oi1 = __shfl_down_sync(0xffffffffu, i1, s);
    float o2 = __shfl_down_sync(0xffffffffu, v2, s);
    if (o1 < v1 || (o1 == v1 && oi1 < i1)) {
      v2 = fminf(v1, o2);
      v1 = o1;
      i1 = oi1;
    } else {
      v2 = fminf(v2, o1);
    }
  }
  if (lane != 0) return;
  v2 = fminf(v2, INVALID);
  bool ok = (v1 <= max_dist) && (v1 < ratio * v2);
  if (mutual) ok = ok && best_rev[(size_t)b * M + i1] == i;
  idx_out[warp] = ok ? i1 : -1;
  d1_out[warp] = v1;
  ok_out[warp] = ok;
}

}  // namespace

extern "C" {

// packed a (B, N, 8), b (B, M, 8) uint32 words; valid_a (B, N), valid_b
// (B, M), mask (B, N, M) u8 -> dist (B, N, M) f32, 1e9 where masked.
int hamming_dist(const uint32_t* pa, const uint32_t* pb, const uint8_t* va,
                 const uint8_t* vb, const uint8_t* mask, float* dist, int B,
                 int N, int M, cudaStream_t stream) {
  dim3 block(T, 8);
  dim3 grid((M + T - 1) / T, (N + T - 1) / T, B);
  dist_kernel<<<grid, block, 0, stream>>>(pa, pb, va, vb, mask, dist, N, M);
  return (int)cudaGetLastError();
}

// dist (B, N, M) -> idx (B, N) int32 (-1 unmatched), best distance
// (B, N) f32, ok (B, N) u8; best_rev (B, M) int32 is scratch.
int hamming_match(const float* dist, int* best_rev, int* idx, float* d1,
                  uint8_t* ok, int B, int N, int M, float max_dist,
                  float ratio, int mutual, cudaStream_t stream) {
  if (mutual) {
    int threads = 256;
    col_argmin_kernel<<<(B * M + threads - 1) / threads, threads, 0,
                        stream>>>(dist, best_rev, B, N, M);
  }
  int rows_per_block = 8;
  row_match_kernel<<<(B * N + rows_per_block - 1) / rows_per_block,
                     rows_per_block * 32, 0, stream>>>(
      dist, best_rev, idx, d1, ok, B, N, M, max_dist, ratio, mutual);
  return (int)cudaGetLastError();
}

}  // extern "C"
