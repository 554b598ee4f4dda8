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

// Launch 2, bow_hist: the masked leaf histogram times idf, divided by
// max(sum |v|, 1e-9). At most N of the n_leaves entries are nonzero (1,024
// ORB and 128 LBD descriptors a keyframe, 10,000 leaves), so the launch
// works on the descriptors and touches the vector only to write it.
// Bound: bytes (N x 5 in, an idf entry a distinct leaf gathered, n_leaves
// x 4 out); what it takes is latency. Every CTA, independently (no CTA
// waits on another: no global atomics, no cluster barrier): a thread holds
// descriptors tid, tid + HIST_NT, ...; their idf entries are gathered
// first; the valid ones go into a shared-memory hash of their leaf ids
// (linear probing, at least 2N slots), which counts each distinct leaf
// (exact: every addend is 1) and keeps its first valid descriptor
// (atomicMin). A descriptor that is its leaf's first gives the term
// count * idf[leaf]; the L1 norm is a fixed-order sum of |term|: each
// thread's terms in descriptor order, then a shuffle butterfly in each
// warp, then the warps' sums in warp order, so it does not depend on
// scheduling (it differs from XLA's order by f32 rounding, ~1e-7
// relative). CTA c writes its own slice of the vector, HIST_SLICE leaves or
// more (HIST_MAX_CTAS CTAs at most), first zeros in 16-byte stores, then,
// after the barriers, count * idf / max(norm, 1e-9) at each distinct leaf
// in the slice. 10,000 leaves take 10 CTAs of HIST_NT threads (1,024: a
// thread a descriptor at N = 1,024; with fewer, each thread's inserts, one
// after another, add to the launch's latency). N is at
// most HIST_MAX_N (the wrapper raises above); nothing is sized by n_leaves.
//
// The L1 scores against the (F, n_leaves) database stay a PyTorch reduction
// (loop/vocabulary.py::l1_score), as the reference leaves them to XLA.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// bow_hist: threads a CTA, the most descriptors (so HIST_PER a thread),
// the least leaves a CTA writes and the most CTAs
constexpr int HIST_NT = 1024, HIST_MAX_N = 4096,
              HIST_PER = HIST_MAX_N / HIST_NT, HIST_SLICE = 1024,
              HIST_MAX_CTAS = 128;

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

// the first slot of ``leaf`` in a hash of 2^bits slots
__device__ __forceinline__ int hist_slot(int leaf, int bits) {
  return (int)(((uint32_t)leaf * 2654435761u) >> (32 - bits));
}

__global__ void __launch_bounds__(HIST_NT)
    bow_hist_kernel(const int* __restrict__ leaves,
                    const uint8_t* __restrict__ valid,
                    const float* __restrict__ idf, int n, int n_leaves,
                    int slice, int bits, float* __restrict__ out) {
  extern __shared__ int hist_hash[];
  __shared__ float red[HIST_NT / 32];
  __shared__ float total;
  const int H = 1 << bits;
  int* key = hist_hash;
  int* cnt = hist_hash + H;
  int* first = hist_hash + 2 * H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // this CTA's slice of the vector, zeros first
  const int lo = blockIdx.x * slice, hi = min(lo + slice, n_leaves);
  const int n4 = max(hi - lo, 0) / 4;
  for (int i = tid; i < n4; i += HIST_NT)
    reinterpret_cast<float4*>(out + lo)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i = lo + 4 * n4 + tid; i < hi; i += HIST_NT) out[i] = 0.0f;
  for (int i = tid; i < H; i += HIST_NT) {
    key[i] = -1;
    cnt[i] = 0;
    first[i] = 0x7fffffff;
  }
  // this thread's descriptors, their idf entries gathered at once
  int lf[HIST_PER], slot[HIST_PER];
  bool ok[HIST_PER];
  float w[HIST_PER];
#pragma unroll
  for (int k = 0; k < HIST_PER; ++k) {
    const int d = tid + k * HIST_NT;
    slot[k] = 0;
    ok[k] = d < n && valid[d] != 0;
    lf[k] = ok[k] ? leaves[d] : 0;
    w[k] = ok[k] ? __ldg(idf + lf[k]) : 0.0f;
  }
  __syncthreads();
  // count each distinct valid leaf, keep its first valid descriptor
#pragma unroll
  for (int k = 0; k < HIST_PER; ++k)
    if (ok[k]) {
      int h = hist_slot(lf[k], bits);
      for (;;) {
        const int old = atomicCAS(key + h, -1, lf[k]);
        if (old == -1 || old == lf[k]) break;
        h = (h + 1) & (H - 1);
      }
      atomicAdd(cnt + h, 1);
      atomicMin(first + h, tid + k * HIST_NT);
      slot[k] = h;
    }
  __syncthreads();
  // the first-occurrence terms and the fixed-order L1 norm
  float part = 0.0f;
#pragma unroll
  for (int k = 0; k < HIST_PER; ++k) {
    ok[k] = ok[k] && first[slot[k]] == tid + k * HIST_NT;
    if (ok[k]) {
      w[k] = (float)cnt[slot[k]] * w[k];
      part += fabsf(w[k]);
    }
  }
#pragma unroll
  for (int s = 16; s > 0; s >>= 1)
    part += __shfl_xor_sync(0xffffffffu, part, s);
  if (lane == 0) red[warp] = part;
  __syncthreads();
  if (tid == 0) {
    float s = 0.0f;
    for (int i = 0; i < HIST_NT / 32; ++i) s += red[i];
    total = fmaxf(s, 1e-9f);
  }
  __syncthreads();
  const float t = total;
#pragma unroll
  for (int k = 0; k < HIST_PER; ++k)
    if (ok[k] && lf[k] >= lo && lf[k] < hi) out[lf[k]] = w[k] / t;
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

// the CTAs and the slice of the vector each writes (a multiple of 4
// leaves), mirrored by loop/vocabulary.py::hist_layout
static void hist_layout(int n_leaves, int* ctas, int* slice) {
  const int c = (n_leaves + HIST_SLICE - 1) / HIST_SLICE;
  *ctas = c < 1 ? 1 : (c > HIST_MAX_CTAS ? HIST_MAX_CTAS : c);
  *slice = (((n_leaves + *ctas - 1) / *ctas) + 3) & ~3;
}

// leaves (n,) int32, valid (n,) u8, idf (n_leaves,) -> out (n_leaves,) the
// L1-normalised TF-IDF vector; n at most HIST_MAX_N, out 16-byte aligned
int bow_hist(const int* leaves, const uint8_t* valid, const float* idf,
             float* out, int n, int n_leaves, cudaStream_t stream) {
  if (n < 0 || n > HIST_MAX_N || n_leaves < 1)
    return (int)cudaErrorInvalidValue;
  if ((uintptr_t)out & 15) return (int)cudaErrorMisalignedAddress;
  int bits = 1;
  while ((1 << bits) < 2 * n) ++bits;
  const size_t smem = (size_t)3 * sizeof(int) << bits;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        bow_hist_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  int ctas, slice;
  hist_layout(n_leaves, &ctas, &slice);
  bow_hist_kernel<<<ctas, HIST_NT, smem, stream>>>(
      leaves, valid, idf, n, n_leaves, slice, bits, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
