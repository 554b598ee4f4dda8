// Kernel L: the bag-of-words vocabulary descent and the BoW histogram (K17).
//
// Replaces plslam_tpu/loop/vocabulary.py::transform_leaves (:129) and
// bow_vector (:145). The reference descends all N descriptors in lockstep,
// one level at a time, as a +-1 bf16 einsum against the gathered (N, k, 256)
// children and an argmax, then scatter-adds the masked leaf histogram.
//
// Launch 1, bow_descend: one thread per descriptor. Per level it computes
// the popcount distances from its 8 packed words to the node's k children
// (8 words each; the centroids, 32 bytes a node, sit in global memory and
// L2: 11,110 nodes, 355 KB at k=10, L=4) and takes the FIRST child of least
// distance, which is the reference's argmax of 256 - 2 ham. Exact.
// Bound: bytes. A descriptor reads L x k x 32 bytes (1.3 KB) of centroids,
// which L2 serves after the first warps: per keyframe 1,024 ORB + 128 LBD
// descriptors, microseconds, and the launch latency dominates.
//
// Launch 2, bow_hist: one block per vector. The block zeroes the n_leaves
// histogram in the output, adds 1.0 per valid descriptor at its leaf with
// float atomics, multiplies by idf and divides by max(sum |v|, 1e-9). The
// atomics are exact in any order here and only here: every addend is 1.0
// and every count stays far below 2^24. The L1 norm is a fixed-order
// reduction (per-thread strided sums in index order, then a fixed tree), so
// the result does not depend on scheduling; it differs from XLA's sum order
// by f32 rounding (~1e-7 relative). Bound: bytes (n_leaves x 8 bytes in and
// 4 out, 80 KB at 10,000 leaves).
//
// The L1 scores against the (F, n_leaves) database stay a PyTorch reduction
// (loop/vocabulary.py::l1_score), as the reference leaves them to XLA.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT_HIST = 1024;

__global__ void bow_descend_kernel(const uint32_t* __restrict__ desc,
                                   const uint32_t* __restrict__ cents, int n,
                                   int k, int levels,
                                   int* __restrict__ leaves) {
  const int d = blockIdx.x * blockDim.x + threadIdx.x;
  if (d >= n) return;
  uint32_t w[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) w[i] = desc[(size_t)d * 8 + i];
  long long node = 0, level_off = 0, level_n = k;
  for (int l = 0; l < levels; ++l) {
    int best = 0, best_d = 1 << 30;
    for (int c = 0; c < k; ++c) {
      const uint32_t* cw = cents + (size_t)(level_off + node * k + c) * 8;
      int h = 0;
#pragma unroll
      for (int i = 0; i < 8; ++i) h += __popc(w[i] ^ cw[i]);
      if (h < best_d) {  // strict: the first child of least distance
        best_d = h;
        best = c;
      }
    }
    node = node * k + best;
    level_off += level_n;
    level_n *= k;
  }
  leaves[d] = (int)node;
}

__global__ void __launch_bounds__(NT_HIST)
    bow_hist_kernel(const int* __restrict__ leaves,
                    const uint8_t* __restrict__ valid,
                    const float* __restrict__ idf, int n, int n_leaves,
                    float* out) {
  __shared__ float red[NT_HIST / 32];
  __shared__ float total;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < n_leaves; i += NT_HIST) out[i] = 0.0f;
  __syncthreads();
  for (int i = tid; i < n; i += NT_HIST)
    if (valid[i]) atomicAdd(out + leaves[i], 1.0f);  // exact: addends 1.0
  __syncthreads();
  float part = 0.0f;
  for (int i = tid; i < n_leaves; i += NT_HIST) {
    const float v = out[i] * idf[i];
    out[i] = v;
    part += fabsf(v);
  }
  for (int s = 16; s > 0; s >>= 1) part += __shfl_xor_sync(0xffffffffu, part, s);
  if (lane == 0) red[warp] = part;
  __syncthreads();
  if (tid == 0) {
    float s = 0.0f;
    for (int i = 0; i < NT_HIST / 32; ++i) s += red[i];
    total = fmaxf(s, 1e-9f);
  }
  __syncthreads();
  const float t = total;
  for (int i = tid; i < n_leaves; i += NT_HIST) out[i] = out[i] / t;
}

}  // namespace

extern "C" {

// desc (n, 8) packed words; cents: every level's (k^(l+1), 8) words back to
// back -> leaves (n,) int32
int bow_descend(const uint32_t* desc, const uint32_t* cents, int* leaves,
                int n, int k, int levels, cudaStream_t stream) {
  const int nt = 128;
  bow_descend_kernel<<<(n + nt - 1) / nt, nt, 0, stream>>>(desc, cents, n, k,
                                                           levels, leaves);
  return (int)cudaGetLastError();
}

// leaves (n,) int32, valid (n,) u8, idf (n_leaves,) -> out (n_leaves,) the
// L1-normalised TF-IDF vector
int bow_hist(const int* leaves, const uint8_t* valid, const float* idf,
             float* out, int n, int n_leaves, cudaStream_t stream) {
  bow_hist_kernel<<<1, NT_HIST, 0, stream>>>(leaves, valid, idf, n, n_leaves,
                                             out);
  return (int)cudaGetLastError();
}

}  // extern "C"
