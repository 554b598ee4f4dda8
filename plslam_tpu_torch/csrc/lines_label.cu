// Kernel F: per-tile gates and collinear min-label propagation over the
// tile grid (K9), one launch.
//
// Replaces the gates and the connected-component stage of
// plslam_tpu/ops/lines.py::tile_stage (:377-468): from the reweighted
// window moments, each tile's centroid, covariance, closed-form principal
// axis, elongation, perpendicular spread, coherence and alignment gates;
// then the compatibility of each tile with its 8 neighbours (both gated
// in, angle mod pi within merge_ang_th, perpendicular centroid offset
// within merge_dist_th), and merge_iters synchronous sweeps of min-label
// propagation, each followed by one pointer hop label <- min(label,
// label[label]).
//
// The gate pass is instructions (correctly rounded divisions and roots,
// atan2), 7,084 tiles an image at 376 x 1241: too many for one SM an
// image. So it is spread over the card: S CTAs an image, as many as one
// wave holds (lines_label picks S), each a slice of the tiles. A tile's
// gates follow lines.py::tile_gates operation for operation, each
// product, sum, quotient and root an explicit _rn intrinsic (nothing is
// contracted into an FMA), torch's NaN rule for clamp (NaN passes) and
// its CUDA atan2 (atan2f; built without fast math, as torch's kernels):
// so tile_ok, cx, cy, cx_l, cy_l and l1 are the bits of the torch plain
// version on the card. The slice writes them, a bit mask of tile_ok (a
// warp's ballot a word), the label Th * Tw + 7 of every gated-out tile,
// and the angle and canonical direction (dx, dy) of every gated-in one to
// a scratch buffer; angle and direction are computed only where the gates
// pass (tested in order, stopping at the first that fails: the same
// tile_ok).
//
// The last CTA of an image to finish its slice (a counter an image,
// after a __threadfence; it sets the counter back to 0) does the rest,
// reading what the slices wrote from L2, each step one round of loads
// issued together: it lists the gated-in tiles (a word of the mask a
// thread, a warp scan and one shared counter a warp: the order of a list
// is not fixed, and no result depends on it); computes their forward
// compatibilities with their gated-in neighbours and sets each found
// link's two bits (shared atomicOr); labels the tiles without a link at
// once (their index: such a tile keeps its first label through every
// sweep and hop) and lists the LINKED ones. Any label a linked tile holds
// is the index of a linked tile of its own component, so the sweeps and
// hops run over that list alone, with the same synchronous update as
// before: every neighbour term reads the previous sweep's labels (A ->
// B), the hop the pre-hop labels (B -> A); a thread keeps its first
// entry's tile, bits and swept label in registers. They stop early once
// an iteration changes no label, a fixed point of the update, which is
// exact. An in-place or union-find update would converge faster and give
// other labels after a fixed number of sweeps; this gives exactly the
// plain version's (and the reference's) labels.
//
// Shared memory: the last CTA holds 9 bytes and a bit a tile of the
// image, labels and lists as int16 (A, B, the gated-in and the linked
// list), the compatibility byte and the mask: 65 KB at 376 x 1241, at most
// lines.py::LABEL_MAX_TILES tiles an image (the entry refuses more).
//
// Bound: the gate pass's instructions, spread over the SMs, then the last
// CTA's dependent steps (tools/k9_timeline.py times each); bytes in and
// out (32 in, 25 out a tile) are a small share.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 1024;
constexpr int BYTES_PER_TILE = 4 * 2 + 1;

__constant__ int DI[4] = {0, 1, 1, 1};
__constant__ int DJ[4] = {1, 0, 1, -1};

struct Moments {
  const float *S, *Sx, *Sy, *Sxx, *Syy, *Sxy, *D2x, *D2y;
};

struct Stage {
  uint8_t* ok;
  float *cx, *cy, *cx_l, *cy_l, *l1;
  int* labels;
  float* dir;         // (N, 3, n) angle, dx, dy of the gated-in tiles
  unsigned* okbits;   // (N, ceil(n / 32)) tile_ok, a bit a tile
  unsigned* count;    // (N,) slices done, 0 between launches
};

struct Gates {
  float s_th, elong_th, perp_th, coh_th, ang_th, dist_th;
};

// torch.clamp(x, min=lo): NaN passes through
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}

// append the tiles t0 + e, bit e of `take`, to list at *count (a warp
// scan of the counts, one atomicAdd a warp)
__device__ __forceinline__ void append(unsigned take, int t0, int16_t* list,
                                       int* count) {
  const int lane = threadIdx.x % 32;
  const int cnt = __popc(take);
  int incl = cnt;
  for (int o = 1; o < 32; o *= 2) {
    const int y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  int at = 0;
  if (lane == 31 && incl) at = atomicAdd(count, incl);
  at = __shfl_sync(0xffffffffu, at, 31) + incl - cnt;
  for (unsigned b = take; b; b &= b - 1)
    list[at++] = (int16_t)(t0 + __ffs(b) - 1);
}

__global__ void __launch_bounds__(THREADS)
    label_kernel(const Moments m, const Stage out, const Gates g, int Th,
                 int Tw, int stride, int iters, int per) {
  extern __shared__ __align__(16) int16_t smem[];
  __shared__ int s_last, s_nok, s_nlink;
  const int n = Th * Tw;
  const int BIG = n + 7;
  const int img = blockIdx.y, tid = threadIdx.x;
  const size_t base = (size_t)img * n;
  const float PI = 3.14159265358979323846f;
  float* dir = out.dir + 3 * base;

  // the slice's gates (lines.py::tile_gates, in its order); each round's
  // eight loads are issued a round ahead; (i, j) advance with t
  const int lo = blockIdx.x * per, hi = min(lo + per, n);
  float nx[8];
  auto load = [&](int t) {
    const size_t q = base + t;
    nx[0] = m.S[q], nx[1] = m.Sx[q], nx[2] = m.Sy[q], nx[3] = m.Sxx[q];
    nx[4] = m.Syy[q], nx[5] = m.Sxy[q], nx[6] = m.D2x[q], nx[7] = m.D2y[q];
  };
  if (lo + tid < hi) load(lo + tid);
  int i = (lo + tid) / Tw, j = (lo + tid) - i * Tw;
  const int di = THREADS / Tw, dj = THREADS - di * Tw;
  const int nw = (n + 31) / 32;
  for (int t0 = lo; t0 < hi; t0 += THREADS) {
    const int t = t0 + tid;
    bool ok = false;
    if (t < hi) {
      const size_t q = base + t;
      const float S = nx[0], Sx = nx[1], Sy = nx[2], Sxx = nx[3];
      const float Syy = nx[4], Sxy = nx[5], D2x = nx[6], D2y = nx[7];
      if (t + THREADS < hi) load(t + THREADS);
      const float S_safe = clamp_min(S, 1e-6f);
      const float cx_l = __fdiv_rn(Sx, S_safe);
      const float cy_l = __fdiv_rn(Sy, S_safe);
      const float cxx =
          __fsub_rn(__fdiv_rn(Sxx, S_safe), __fmul_rn(cx_l, cx_l));
      const float cyy =
          __fsub_rn(__fdiv_rn(Syy, S_safe), __fmul_rn(cy_l, cy_l));
      const float cxy =
          __fsub_rn(__fdiv_rn(Sxy, S_safe), __fmul_rn(cx_l, cy_l));
      const float cx = __fadd_rn(cx_l, __fmul_rn((float)stride, (float)j));
      const float cy = __fadd_rn(cy_l, __fmul_rn((float)stride, (float)i));
      // principal_axis(cxx, cyy, cxy)
      const float tr = __fadd_rn(cxx, cyy);
      const float diff = __fsub_rn(cxx, cyy);
      const float disc = __fsqrt_rn(__fadd_rn(
          __fadd_rn(__fmul_rn(diff, diff),
                    __fmul_rn(__fmul_rn(cxy, 4.0f), cxy)), 1e-20f));
      const float l1r = __fmul_rn(__fadd_rn(tr, disc), 0.5f);
      const float l2r = __fmul_rn(__fsub_rn(tr, disc), 0.5f);
      const float l1 = clamp_min(l1r, 0.0f);
      out.cx_l[q] = cx_l;
      out.cy_l[q] = cy_l;
      out.cx[q] = cx;
      out.cy[q] = cy;
      out.l1[q] = l1;
      ok = S > g.s_th;
      float dx = 0.f, dy = 0.f;
      if (ok) {
        const bool big = fabsf(cxy) > 1e-12f;
        const float vx = big ? cxy : __fsub_rn(l1r, cyy);
        const float vy = big ? __fsub_rn(l1r, cxx) : 1e-12f;
        const float nrm = __fsqrt_rn(__fadd_rn(
            __fadd_rn(__fmul_rn(vx, vx), __fmul_rn(vy, vy)), 1e-20f));
        dx = __fdiv_rn(vx, nrm);
        dy = __fdiv_rn(vy, nrm);
        const float l2 = clamp_min(l2r, 0.0f);
        const float elong = __fsqrt_rn(__fdiv_rn(l1, clamp_min(l2, 1e-4f)));
        ok = elong > g.elong_th;
        if (ok) ok = __fsqrt_rn(l2) < g.perp_th;
        if (ok) {
          const float dn = __fsqrt_rn(
              __fadd_rn(__fmul_rn(D2x, D2x), __fmul_rn(D2y, D2y)));
          ok = __fdiv_rn(dn, S_safe) > g.coh_th;
          if (ok) {
            // the normal (-dy, dx), its double angle
            const float n2x = __fsub_rn(__fmul_rn(-dy, -dy), __fmul_rn(dx, dx));
            const float n2y = __fmul_rn(__fmul_rn(-dy, 2.0f), dx);
            const float align = __fdiv_rn(
                __fadd_rn(__fmul_rn(D2x, n2x), __fmul_rn(D2y, n2y)),
                clamp_min(dn, 1e-6f));
            ok = align > g.coh_th;
          }
        }
      }
      out.ok[q] = ok;
      if (ok) {
        if (dx < 0.f) {
          dx = -dx;
          dy = -dy;
        }
        dir[t] = atan2f(dy, dx);
        dir[n + t] = dx;
        dir[2 * n + t] = dy;
      } else {
        out.labels[q] = BIG;
      }
      i += di;
      j += dj;
      if (j >= Tw) {
        j -= Tw;
        ++i;
      }
    }
    // a warp's 32 tiles are one word of the bit mask (lo and THREADS are
    // multiples of 32)
    const unsigned word = __ballot_sync(0xffffffffu, ok);
    if (tid % 32 == 0 && t < hi) out.okbits[(size_t)img * nw + t / 32] = word;
  }
  // the last slice of the image to finish goes on
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const unsigned done = atomicAdd(&out.count[img], 1u);
    s_last = done == gridDim.x - 1;
    if (s_last) out.count[img] = 0;
    s_nok = 0;
    s_nlink = 0;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();

  int16_t* A = smem;
  int16_t* B = A + n;
  int16_t* okl = B + n;
  int16_t* lnk = okl + n;
  uint8_t* comp = reinterpret_cast<uint8_t*>(lnk + n);  // 8n bytes in
  unsigned* comp32 = reinterpret_cast<unsigned*>(comp);
  unsigned* okb = comp32 + (n + 3) / 4;
  for (int w = tid; w < (n + 3) / 4; w += THREADS) comp32[w] = 0u;
  // the gated-in tiles, a word of the bit mask a thread (from L2)
  for (int w0 = 0; w0 < nw; w0 += THREADS) {
    const int w = w0 + tid;
    const unsigned take = w < nw ? __ldcg(out.okbits + (size_t)img * nw + w)
                                 : 0u;
    if (w < nw) okb[w] = take;
    append(take, 32 * w, okl, &s_nok);
  }
  __syncthreads();
  // forward compatibilities of the gated-in tiles, bit d: tile (i, j)
  // with (i + DI[d], j + DJ[d]); the link's reverse bit 4 + d on the
  // neighbour. A tile's and its neighbours' loads are issued together
  // (a neighbour off the grid reads the tile itself and is skipped).
  const int nok = s_nok;
  for (int k = tid; k < nok; k += THREADS) {
    const int t = okl[k];
    const int ti = t / Tw, tj = t - ti * Tw;
    const float a = __ldcg(dir + t), ux = __ldcg(dir + n + t),
                uy = __ldcg(dir + 2 * n + t);
    const float x = __ldcg(out.cx + base + t), y = __ldcg(out.cy + base + t);
    int nt[4];
    bool in[4], okn[4];
    float na[4], ncx[4], ncy[4];
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      const int ni = ti + DI[d], nj = tj + DJ[d];
      in[d] = ni < Th && nj >= 0 && nj < Tw;
      nt[d] = in[d] ? ni * Tw + nj : t;
      okn[d] = (okb[nt[d] / 32] >> (nt[d] % 32)) & 1;
      na[d] = __ldcg(dir + nt[d]);
      ncx[d] = __ldcg(out.cx + base + nt[d]);
      ncy[d] = __ldcg(out.cy + base + nt[d]);
    }
    unsigned f = 0;
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      if (!in[d] || !okn[d]) continue;
      float dang = fabsf(__fsub_rn(a, na[d]));
      dang = fminf(dang, __fsub_rn(PI, dang));
      const float off =
          fabsf(__fadd_rn(__fmul_rn(-uy, __fsub_rn(ncx[d], x)),
                          __fmul_rn(ux, __fsub_rn(ncy[d], y))));
      if (dang < g.ang_th && off < g.dist_th) {
        f |= 1u << d;
        atomicOr(comp32 + nt[d] / 4, (1u << (4 + d)) << (8 * (nt[d] % 4)));
      }
    }
    if (f) atomicOr(comp32 + t / 4, f << (8 * (t % 4)));
  }
  __syncthreads();
  // a gated-in tile without a link keeps its index; the linked ones
  for (int k0 = 0; k0 < nok; k0 += THREADS) {
    const int k = k0 + tid;
    const int t = k < nok ? okl[k] : 0;
    const bool linked = k < nok && comp[t] != 0;
    if (k < nok && !linked) out.labels[base + t] = t;
    if (linked) A[t] = (int16_t)t;
    append(linked ? 1u : 0u, t, lnk, &s_nlink);
  }
  __syncthreads();
  const int L = s_nlink;
  // this thread's first entry in registers: its tile, bits, neighbours
  const bool own = tid < L;
  const int t1 = own ? lnk[tid] : 0;
  const unsigned c1 = own ? comp[t1] : 0u;
  for (int it = 0; it < iters; ++it) {
    int v1 = 0;
    if (own) {
      v1 = A[t1];
#pragma unroll
      for (int d = 0; d < 4; ++d) {
        const int off = DI[d] * Tw + DJ[d];
        if ((c1 >> d) & 1) v1 = min(v1, (int)A[t1 + off]);
        if ((c1 >> (4 + d)) & 1) v1 = min(v1, (int)A[t1 - off]);
      }
      B[t1] = (int16_t)v1;
    }
    for (int k = tid + THREADS; k < L; k += THREADS) {
      const int t = lnk[k];
      const unsigned c = comp[t];
      int v = A[t];
      for (int d = 0; d < 4; ++d) {
        const int off = DI[d] * Tw + DJ[d];
        if ((c >> d) & 1) v = min(v, (int)A[t + off]);
        if ((c >> (4 + d)) & 1) v = min(v, (int)A[t - off]);
      }
      B[t] = (int16_t)v;
    }
    __syncthreads();
    int changed = 0;
    if (own) {
      const int h = min(v1, (int)B[v1]);  // v1 is a linked tile's index
      changed |= h != A[t1];
      A[t1] = (int16_t)h;
    }
    for (int k = tid + THREADS; k < L; k += THREADS) {
      const int t = lnk[k];
      const int v = B[t];
      const int h = min(v, (int)B[v]);
      changed |= h != A[t];
      A[t] = (int16_t)h;
    }
    if (!__syncthreads_or(changed)) break;
  }
  for (int k = tid; k < L; k += THREADS) {
    const int t = lnk[k];
    out.labels[base + t] = A[t];
  }
}

}  // namespace

extern "C" {

// S, Sx, Sy, Sxx, Syy, Sxy, D2x, D2y (N, Th, Tw) f32, the reweighted
// window moments -> tile_ok (N, Th, Tw) u8 {0, 1}; cx, cy, cx_l, cy_l, l1
// (N, Th, Tw) f32; labels (N, Th, Tw) int32, Th * Tw + 7 on gated-out
// tiles. dir (N, 3, Th, Tw) f32 and okbits (N, ceil(Th Tw / 32)) uint32
// scratch; count (N,) uint32, zero before the launch and after it. stride
// = tile / 2; s_th = min_support * tile.
int lines_label(const float* S, const float* Sx, const float* Sy,
                const float* Sxx, const float* Syy, const float* Sxy,
                const float* D2x, const float* D2y, uint8_t* ok, float* cx,
                float* cy, float* cx_l, float* cy_l, float* l1, int* labels,
                float* dir, unsigned* okbits, unsigned* count, int N, int Th,
                int Tw, int stride, float s_th, float elong_th, float perp_th,
                float coh_th, float ang_th, float dist_th, int iters,
                cudaStream_t stream) {
  if (N < 1 || N > 65535 || Th < 1 || Tw < 1 ||
      (long long)Th * Tw + 7 > 32767)
    return (int)cudaErrorInvalidValue;
  const int n = Th * Tw;
  // A, B and the two lists, the compatibility bytes in whole words, the
  // bit mask
  const int smem = n * (BYTES_PER_TILE - 1) + (n + 3) / 4 * 4 +
                   (n + 31) / 32 * 4;
  if (smem > 232448 - 64) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      label_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int dev = 0, sms = 0, fit = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit, label_kernel,
                                                      THREADS, smem);
  if (e != cudaSuccess) return (int)e;
  // slices an image: as many as one wave of the card holds (at least 256
  // tiles each), of equal size to a warp
  const int want = max(1, min((n + 255) / 256, max(1, fit) * sms / N));
  const int per = ((n + want - 1) / want + 31) / 32 * 32;
  const int slices = (n + per - 1) / per;
  const Moments m{S, Sx, Sy, Sxx, Syy, Sxy, D2x, D2y};
  const Stage out{ok, cx, cy, cx_l, cy_l, l1, labels, dir, okbits, count};
  const Gates g{s_th, elong_th, perp_th, coh_th, ang_th, dist_th};
  label_kernel<<<dim3(slices, N), THREADS, smem, stream>>>(
      m, out, g, Th, Tw, stride, iters, per);
  return (int)cudaGetLastError();
}

}  // extern "C"
