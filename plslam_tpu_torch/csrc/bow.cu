// Kernel L: the bag-of-words vocabulary descent and the BoW histogram (K17).
//
// Replaces plslam_tpu/loop/vocabulary.py::transform_leaves (:129) and
// bow_vector (:145). The reference descends all N descriptors in lockstep,
// one level at a time, as a +-1 bf16 einsum against the gathered (N, k, 256)
// children and an argmax, then scatter-adds the masked leaf histogram.
//
// Launch 1, bow_descend: a group of 8 lanes a descriptor, one lane a packed
// 32-bit word. Per level it takes the FIRST child of least Hamming distance,
// which is the reference's argmax of 256 - 2 ham. Exact.
// Bound: bytes. A descriptor reads L x k x 32 bytes (1.3 KB) of centroids,
// which L2 serves after the first warps: per keyframe 1,024 ORB + 128 LBD
// descriptors, microseconds. What the launch takes is latency: the kernel it
// replaced, a thread a descriptor, loaded the node's k children one child at
// a time, ~40 dependent L2 round trips a descriptor, and 128 descriptors
// sat on one SM (0.0107 ms on an NVIDIA H100 80GB HBM3 at 700 W).
// Design: a node's children are k contiguous 32-byte rows, so at each level
// every lane issues its word's loads of all k children before using any
// (coalesced: the group reads whole rows), one round trip a level; XOR and
// popcount a child, two children's counts packed in one word (each at most
// 256), a 3-step shuffle sum within the group, then the first minimum in
// child order, the same in every lane. The top two levels (k + k^2 rows,
// 3.5 KB at k = 10) are staged in shared memory once a CTA, in 16-byte
// cp.async pieces issued together, while the descriptors load. 128 threads
// a CTA: 1,024 ORB descriptors occupy 64 CTAs, 128 LBD descriptors 8. k is
// at most BOW_MAX_K (the wrapper raises above).

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

constexpr int BOW_MAX_K = 16, BOW_NT = 128, BOW_STAGED = 2;

// lane j's word of the k children rows first .. first + k - 1 of ``cw``
// (shared or global memory), loaded together, and the first child of least
// distance to the group's descriptor, whose word j is ``x``
template <bool SHARED>
__device__ __forceinline__ int bow_child(const uint32_t* __restrict__ cw,
                                         long long first, int k, int j,
                                         uint32_t x, unsigned gmask) {
  uint32_t v[BOW_MAX_K];
#pragma unroll
  for (int c = 0; c < BOW_MAX_K; ++c)
    if (c < k) {
      const uint32_t* p = cw + (first + c) * 8 + j;
      if constexpr (SHARED)
        v[c] = *p;
      else
        v[c] = __ldg(p);
    }
  // two children's counts a word: each sums to at most 256
  uint32_t h[BOW_MAX_K / 2];
#pragma unroll
  for (int c = 0; c < BOW_MAX_K; c += 2) {
    uint32_t y = c < k ? (uint32_t)__popc(x ^ v[c]) : 0u;
    if (c + 1 < k) y |= (uint32_t)__popc(x ^ v[c + 1]) << 16;
    h[c / 2] = y;
  }
#pragma unroll
  for (int c = 0; c < BOW_MAX_K / 2; ++c)
    if (2 * c < k)
#pragma unroll
      for (int s = 1; s < 8; s <<= 1)
        h[c] += __shfl_xor_sync(gmask, h[c], s, 8);
  int best = 0, best_d = 1 << 30;
#pragma unroll
  for (int c = 0; c < BOW_MAX_K; ++c)
    if (c < k) {
      const int d = (int)((h[c / 2] >> (16 * (c & 1))) & 0xffffu);
      if (d < best_d) {  // strict: the first child of least distance
        best_d = d;
        best = c;
      }
    }
  return best;
}

__global__ void __launch_bounds__(BOW_NT)
    bow_descend_kernel(const uint32_t* __restrict__ desc,
                       const uint32_t* __restrict__ cents, int n, int k,
                       int levels, int* __restrict__ leaves) {
  constexpr int TOP_ROWS = BOW_MAX_K + BOW_MAX_K * BOW_MAX_K;
  __shared__ __align__(16) uint32_t top[TOP_ROWS * 8];
  const int tid = threadIdx.x, j = tid & 7;
  const int d = blockIdx.x * (BOW_NT / 8) + (tid >> 3);
  const int staged = min(levels, BOW_STAGED);
  const int rows = staged == 0 ? 0 : (staged == 1 ? k : k + k * k);
  const uint32_t x = d < n ? __ldg(desc + (size_t)d * 8 + j) : 0u;
  // the staged rows in 16-byte pieces, every piece's load issued at once
  // (a row is two pieces; where ``cents`` is not 16-byte aligned, words)
  if (((uintptr_t)cents & 15) == 0) {
    for (int i = tid; i < rows * 2; i += BOW_NT) {
      const unsigned dst = (unsigned)__cvta_generic_to_shared(top + 4 * i);
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                   "l"(cents + 4 * i));
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  } else {
    for (int i = tid; i < rows * 8; i += BOW_NT) top[i] = __ldg(cents + i);
  }
  __syncthreads();
  if (d >= n) return;
  const unsigned gmask = 0xffu << (tid & 24);
  long long node = 0, level_off = 0, level_n = k;
  for (int l = 0; l < levels; ++l) {
    const long long first = level_off + node * k;
    const int c = l < staged
                      ? bow_child<true>(top, first, k, j, x, gmask)
                      : bow_child<false>(cents, first, k, j, x, gmask);
    node = node * k + c;
    level_off += level_n;
    level_n *= k;
  }
  if (j == 0) leaves[d] = (int)node;
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
// back -> leaves (n,) int32; k at most BOW_MAX_K
int bow_descend(const uint32_t* desc, const uint32_t* cents, int* leaves,
                int n, int k, int levels, cudaStream_t stream) {
  if (n < 1 || k < 1 || k > BOW_MAX_K || levels < 0)
    return (int)cudaErrorInvalidValue;
  const int per = BOW_NT / 8;
  bow_descend_kernel<<<(n + per - 1) / per, BOW_NT, 0, stream>>>(
      desc, cents, n, k, levels, leaves);
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
