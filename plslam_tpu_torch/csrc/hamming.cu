// Kernel D: binary-descriptor matching (K6), batched over B frame pairs.
//
// Replaces plslam_tpu/ops/hamming.py::hamming_matrix (:30), match_nnr
// (:57), window_mask (:79) and apply_mask (:91), and the gates the
// callers build around them (frontend/stereo_points.py:93-98,
// tracking/frame_handler.py:42-46, backend/map.py:190-193). The reference
// computes the distance as a +-1 bf16 matmul on the MXU (exact) and the
// gates as (N, M) masks; here it is __popc of the XOR of 8 packed 32-bit
// words (pack_bits layout, :95-99: bit b of word w is bit 32 w + b).
//
// The matcher on the main path, two launches:
//   hamming_scan    one block per (32-row tile, frame): the tile's rows
//                   packed into registers (a bit descriptor is packed while
//                   it is staged: 32 bytes to a word), the columns streamed
//                   through shared memory in tiles of 256, double-buffered
//                   (cp.async for packed words), with their gate data. Each
//                   of the 8 warps takes 32 columns of a tile, a lane one
//                   row: 8 popcounts and the gate in registers, the row's
//                   best (v1, i1) and second best v2 kept as it goes (ties
//                   to the lowest column), the column's best row over the
//                   tile by one warp min-reduction, then one 64-bit
//                   atomicMin per (column, row tile) on (distance bits <<
//                   32 | row) into a (B, M) buffer set to all ones: a
//                   minimum over a total order, so exact and independent of
//                   the atomics' order, lowest row first as argmin over
//                   rows. The warps' row results merge on (value, column).
//   hamming_finish  one thread per row: the 1e9 ceiling of v2, the
//                   absolute and ratio gates and the mutual check.
// No (B, N, M) tensor is written. Bound: operations, a pair's distance as
// a 256-deep +-1 product on the int8 tensor cores (1,979 TOP/s): 0.0054 ms
// at 20 x 1024 x 1024; the 8 popcounts of a pair on the CUDA cores (16 a
// clock per SM) cannot go below 0.04 ms there. The gate repeats the plain
// version's f32 operations (__fsub_rn, fabsf, compare).
//
// The matrix-based pair it replaced, kept as the "before" that
// chip_smoke.py times on the same inputs (no main-path caller):
//   hamming_dist    the masked (B, N, M) f32 distance matrix, 32 x 32
//                   tiles; bound: bytes (a mask byte in, 4 bytes out).
//   hamming_match   reads the matrix by columns (reverse argmin) and by
//                   rows (best, second best, gates).
//
// Exactness: distances are integers; every argmin reduces on the pair
// (distance, index) so ties go to the lowest index, as jnp.argmin does.
// The second best is the minimum over all columns but the best one, with
// the reference's 1e9 sentinel as its ceiling. Masked pairs are 1e9: an
// all-masked row takes column 0, an all-masked column row 0.

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

// ---- the fused, gated matcher ----------------------------------------------

constexpr int SCAN_WARPS = 8;
constexpr int SCAN_NT = SCAN_WARPS * 32;
constexpr int SCAN_CT = SCAN_WARPS * 32;    // columns of a shared tile
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned MASKED_CODE = 511u;      // > 256: a masked pair (1e9)

// gate kinds (ops/hamming.py::_GATE_KIND)
enum { GATE_NONE = 0, GATE_WINDOW = 1, GATE_WINDOW_OCT = 2, GATE_STEREO = 3,
       GATE_MASK = 4 };

struct Gate {
  const float* pos_a;      // (B, N, 2) rows' positions (window; stereo uv_l)
  const float* pos_b;      // (B, M, 2)
  const int* oct_a;        // (B, N) octaves
  const int* oct_b;        // (B, M)
  const uint8_t* mask;     // (B, N, M) explicit mask
  float p0, p1, p2;        // radius | row_tol, min_disp, max_disp
};

// 32 descriptor bytes (each 0 or 1) -> one word, byte k to bit k
__device__ __forceinline__ uint32_t pack_word(const uint8_t* p) {
  const uint4 lo = *reinterpret_cast<const uint4*>(p);
  const uint4 hi = *reinterpret_cast<const uint4*>(p + 16);
  const uint32_t v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  uint32_t w = 0;
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    // nonzero bytes to 1, then the 4 bytes' low bits gathered into bits
    // 21..24 by one multiply (no two partial products share a bit)
    const uint32_t x = __vcmpne4(v[q], 0u) & 0x01010101u;
    w |= (((x * 0x00204081u) >> 21) & 0xFu) << (4 * q);
  }
  return w;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n));
}

// the reference's gate of one pair, in its f32 operations
template <int GATE>
__device__ __forceinline__ bool gate_ok(const Gate& g, float ax, float ay,
                                        int oa, const float4 c, size_t mo) {
  if (GATE == GATE_WINDOW || GATE == GATE_WINDOW_OCT) {
    bool ok = fabsf(__fsub_rn(ax, c.x)) <= g.p0 &&
              fabsf(__fsub_rn(ay, c.y)) <= g.p0;
    if (GATE == GATE_WINDOW_OCT) ok = ok && abs(oa - __float_as_int(c.z)) <= 1;
    return ok;
  }
  if (GATE == GATE_STEREO) {
    const float d = __fsub_rn(ax, c.x);
    return fabsf(__fsub_rn(ay, c.y)) <= g.p0 && d >= g.p1 && d <= g.p2 &&
           abs(oa - __float_as_int(c.z)) <= 1;
  }
  if (GATE == GATE_MASK) return g.mask[mo] != 0;
  return true;
}

template <int GATE>
__global__ void __launch_bounds__(SCAN_NT)
    hamming_scan_kernel(const void* __restrict__ da, int a_bits,
                        const void* __restrict__ db, int b_bits,
                        const uint8_t* __restrict__ va,
                        const uint8_t* __restrict__ vb, Gate g,
                        float* __restrict__ d1_out, int* __restrict__ i1_out,
                        float* __restrict__ v2_out,
                        unsigned long long* __restrict__ col_best, int N,
                        int M) {
  __shared__ __align__(16) uint32_t s_desc[2][SCAN_CT][WORDS];
  // per column: x, y, octave bits, valid
  __shared__ __align__(16) float4 s_col[2][SCAN_CT];
  __shared__ uint32_t s_rows[32][WORDS + 1];
  __shared__ float s_v1[SCAN_WARPS][32], s_v2[SCAN_WARPS][32];
  __shared__ int s_i1[SCAN_WARPS][32];
  const int b = blockIdx.y, i0 = blockIdx.x * 32;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t rowN = (size_t)b * N, rowM = (size_t)b * M;

  {  // the tile's 32 rows, one word a thread
    const int r = tid >> 3, w = tid & 7, i = i0 + r;
    uint32_t word = 0u;
    if (i < N)
      word = a_bits ? pack_word(static_cast<const uint8_t*>(da) +
                                (rowN + i) * 256 + 32 * w)
                    : static_cast<const uint32_t*>(da)[(rowN + i) * WORDS + w];
    s_rows[r][w] = word;
  }

  auto stage = [&](int t, int buf) {
    const int j0 = t * SCAN_CT;
    if (b_bits) {
      for (int q = tid; q < SCAN_CT * WORDS; q += SCAN_NT) {
        const int jl = q >> 3, w = q & 7, j = j0 + jl;
        if (j < M)
          s_desc[buf][jl][w] = pack_word(static_cast<const uint8_t*>(db) +
                                         (rowM + j) * 256 + 32 * w);
      }
    } else {
      for (int q = tid; q < SCAN_CT * 2; q += SCAN_NT) {
        const int jl = q >> 1, h = q & 1, j = j0 + jl;
        if (j < M)
          cp_async16(&s_desc[buf][jl][4 * h],
                     static_cast<const uint32_t*>(db) + (rowM + j) * WORDS +
                         4 * h);
      }
    }
    cp_async_commit();
    const int j = j0 + tid;  // SCAN_CT == SCAN_NT: one column a thread
    if (j < M) {
      float4 c = make_float4(0.f, 0.f, 0.f, 0.f);
      if (GATE == GATE_WINDOW || GATE == GATE_WINDOW_OCT ||
          GATE == GATE_STEREO) {
        c.x = g.pos_b[2 * (rowM + j)];
        c.y = g.pos_b[2 * (rowM + j) + 1];
      }
      if (GATE == GATE_WINDOW_OCT || GATE == GATE_STEREO)
        c.z = __int_as_float(g.oct_b[rowM + j]);
      c.w = __int_as_float(vb == nullptr || vb[rowM + j] != 0);
      s_col[buf][tid] = c;
    }
  };

  const int n_tiles = (M + SCAN_CT - 1) / SCAN_CT;
  stage(0, 0);
  __syncthreads();
  const int i = i0 + lane;
  const bool real = i < N;
  uint32_t ra[WORDS];
#pragma unroll
  for (int w = 0; w < WORDS; ++w) ra[w] = s_rows[lane][w];
  const bool row_ok = real && (va == nullptr || va[rowN + i] != 0);
  float ax = 0.f, ay = 0.f;
  int oa = 0;
  if (real && (GATE == GATE_WINDOW || GATE == GATE_WINDOW_OCT ||
               GATE == GATE_STEREO)) {
    ax = g.pos_a[2 * (rowN + i)];
    ay = g.pos_a[2 * (rowN + i) + 1];
  }
  if (real && (GATE == GATE_WINDOW_OCT || GATE == GATE_STEREO))
    oa = g.oct_a[rowN + i];

  float v1 = INFINITY, v2 = INFINITY;
  int i1 = 0;
  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < n_tiles) {
      stage(t + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int jw = t * SCAN_CT + warp * 32;  // this warp's 32 columns
    unsigned mine = FULL;
    for (int c = 0; c < 32; ++c) {
      const int j = jw + c;
      if (j >= M) break;  // warp-uniform
      const int jl = warp * 32 + c;
      const uint4 q0 = *reinterpret_cast<const uint4*>(&s_desc[buf][jl][0]);
      const uint4 q1 = *reinterpret_cast<const uint4*>(&s_desc[buf][jl][4]);
      const float4 cd = s_col[buf][jl];
      const int d = __popc(ra[0] ^ q0.x) + __popc(ra[1] ^ q0.y) +
                    __popc(ra[2] ^ q0.z) + __popc(ra[3] ^ q0.w) +
                    __popc(ra[4] ^ q1.x) + __popc(ra[5] ^ q1.y) +
                    __popc(ra[6] ^ q1.z) + __popc(ra[7] ^ q1.w);
      const bool ok = row_ok && __float_as_int(cd.w) != 0 &&
                      gate_ok<GATE>(g, ax, ay, oa, cd, (rowN + i) * M + j);
      const float v = ok ? (float)d : INVALID;
      if (v < v1) {  // increasing j: strict < keeps the first
        v2 = v1;
        v1 = v;
        i1 = j;
      } else {
        v2 = fminf(v2, v);
      }
      if (col_best != nullptr) {
        const unsigned key =
            real ? (((ok ? (unsigned)d : MASKED_CODE) << 5) | (unsigned)lane)
                 : FULL;
        const unsigned k = __reduce_min_sync(FULL, key);
        if (lane == c) mine = k;
      }
    }
    if (col_best != nullptr && jw + lane < M) {
      const unsigned code = mine >> 5;
      const float d = code == MASKED_CODE ? INVALID : (float)code;
      const unsigned long long key =
          ((unsigned long long)__float_as_uint(d) << 32) |
          (unsigned)(i0 + (int)(mine & 31u));
      atomicMin(&col_best[rowM + jw + lane], key);
    }
    __syncthreads();
  }

  // merge the warps' row results on (value, column)
  s_v1[warp][lane] = v1;
  s_v2[warp][lane] = v2;
  s_i1[warp][lane] = i1;
  __syncthreads();
  if (warp != 0 || !real) return;
  for (int w = 1; w < SCAN_WARPS; ++w) {
    const float o1 = s_v1[w][lane], o2 = s_v2[w][lane];
    const int oi = s_i1[w][lane];
    if (o1 < v1 || (o1 == v1 && oi < i1)) {
      v2 = fminf(v1, o2);
      v1 = o1;
      i1 = oi;
    } else {
      v2 = fminf(v2, o1);
    }
  }
  d1_out[rowN + i] = v1;
  i1_out[rowN + i] = i1;
  v2_out[rowN + i] = v2;
}

__global__ void hamming_finish_kernel(const float* __restrict__ d1,
                                      const int* __restrict__ i1,
                                      const float* __restrict__ v2,
                                      const unsigned long long* __restrict__
                                          col_best,
                                      int* __restrict__ idx,
                                      uint8_t* __restrict__ ok_out, int B,
                                      int N, int M, float max_dist,
                                      float ratio) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= B * N) return;
  const float v1 = d1[t], s2 = fminf(v2[t], INVALID);
  const int best = i1[t];
  bool ok = (v1 <= max_dist) && (v1 < ratio * s2);
  if (col_best != nullptr)
    ok = ok && (int)(unsigned)(col_best[(size_t)(t / N) * M + best] &
                               0xffffffffull) == t % N;
  idx[t] = ok ? best : -1;
  ok_out[t] = ok;
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

// descriptors a (B, N, 256) u8 bits or (B, N, 8) words (a_bits says which),
// b (B, M, ...) likewise; valid_a (B, N), valid_b (B, M) u8 or null; the
// gate (kind and its arrays, null where unused) -> d1 (B, N) f32 best
// distance, i1 (B, N) int32 its first column, v2 (B, N) f32 second best
// (before the 1e9 ceiling), and, unless null, col_best (B, M) u64:
// (distance bits << 32 | row) of each column's first best row.
int hamming_scan(const void* a, int a_bits, const void* b, int b_bits,
                 const uint8_t* va, const uint8_t* vb, int gate,
                 const float* pos_a, const float* pos_b, const int* oct_a,
                 const int* oct_b, const uint8_t* mask, float p0, float p1,
                 float p2, float* d1, int* i1, float* v2,
                 unsigned long long* col_best, int B, int N, int M,
                 cudaStream_t stream) {
  if (col_best != nullptr) {
    const cudaError_t e = cudaMemsetAsync(
        col_best, 0xff, sizeof(unsigned long long) * (size_t)B * M, stream);
    if (e != cudaSuccess) return (int)e;
  }
  const Gate g{pos_a, pos_b, oct_a, oct_b, mask, p0, p1, p2};
  const dim3 grid((N + 31) / 32, B);
#define SCAN(K)                                                          \
  hamming_scan_kernel<K><<<grid, SCAN_NT, 0, stream>>>(                  \
      a, a_bits, b, b_bits, va, vb, g, d1, i1, v2, col_best, N, M)
  switch (gate) {
    case GATE_NONE: SCAN(GATE_NONE); break;
    case GATE_WINDOW: SCAN(GATE_WINDOW); break;
    case GATE_WINDOW_OCT: SCAN(GATE_WINDOW_OCT); break;
    case GATE_STEREO: SCAN(GATE_STEREO); break;
    case GATE_MASK: SCAN(GATE_MASK); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef SCAN
  return (int)cudaGetLastError();
}

// hamming_scan's outputs -> idx (B, N) int32 (-1 unmatched), ok (B, N) u8;
// col_best null: no mutual check.
int hamming_finish(const float* d1, const int* i1, const float* v2,
                   const unsigned long long* col_best, int* idx, uint8_t* ok,
                   int B, int N, int M, float max_dist, float ratio,
                   cudaStream_t stream) {
  const int threads = 256;
  hamming_finish_kernel<<<(B * N + threads - 1) / threads, threads, 0,
                          stream>>>(d1, i1, v2, col_best, idx, ok, B, N, M,
                                    max_dist, ratio);
  return (int)cudaGetLastError();
}

}  // extern "C"
