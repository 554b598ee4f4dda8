// Exact order statistics of non-negative floats inside one thread block,
// by radix select (kernels I and K: the lower median of a MAD scale).
//
// A non-negative float orders as its bits, so the element of rank k among
// keys (key_of: the 31 bits below the sign) is found digit by digit: digits
// of 11, 10 and 10 bits (SEL_D1, SEL_D2, SEL_D3 buckets), each a histogram
// of the keys that share the digits found so far and a scan that picks the
// bucket holding the rank. Integer counts: the result does not depend on
// the order in which threads add them.

#pragma once

#include <cuda_runtime.h>

namespace radix {

constexpr int SEL_D1 = 2048, SEL_D2 = 1024, SEL_D3 = 1024;  // 11, 10, 10 bits
constexpr int SEL_SHIFT1 = 20, SEL_SHIFT2 = 10;

__device__ __forceinline__ unsigned int key_of(float a) {
  return __float_as_uint(a) & 0x7fffffffu;
}

// The bucket of h[0 .. NB) (counts in bucket order) that holds rank k < the
// counts' sum, and k's rank inside it, for a block of NT threads. Every
// thread returns the same; h is read before the first barrier, so a thread
// may clear it once this returns.
template <int NT, int NB>
__device__ void select_bucket(const unsigned int* h, unsigned int k,
                              int* bucket, unsigned int* rank,
                              unsigned int* scan) {
  constexpr int PER = NB / NT;
  static_assert(PER * NT == NB, "NB must be a multiple of NT");
  __shared__ int s_bucket;
  __shared__ unsigned int s_rank;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  unsigned int c[PER], sum = 0;
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    c[q] = h[tid * PER + q];
    sum += c[q];
  }
  // inclusive scan of the threads' sums: warps, then the warps' totals
  unsigned int x = sum;
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned int y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) scan[warp] = x;
  __syncthreads();
  unsigned int lo = x - sum;
  for (int w = 0; w < warp; ++w) lo += scan[w];
  if (k >= lo && k < lo + sum) {
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      if (k >= lo && k < lo + c[q]) {
        s_bucket = tid * PER + q;
        s_rank = k - lo;
      }
      lo += c[q];
    }
  }
  __syncthreads();
  *bucket = s_bucket;
  *rank = s_rank;
  __syncthreads();
}

}  // namespace radix
