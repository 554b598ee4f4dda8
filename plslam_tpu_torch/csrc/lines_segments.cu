// Kernel G: per-root refit of the tile components into candidate
// segments (K10), and the segment-level collinear merge (K11). Two
// launches.
//
// Launch 1 (lines_refit) replaces plslam_tpu/ops/lines.py::refit_roots
// (:474, up to the candidate top_k), whose member aggregation is a one-hot
// (R, n) matmul on the MXU and whose min/max projections are masked (R, n)
// reductions. Here the work is linear in the tiles. `splits` blocks (up
// to 4, one wave of the SMs) share an image, block s taking the root
// slots s, s + splits, ... (the slots come in rank order, the large ones
// first). A block builds a tile -> slot table from its root ids in
// shared memory (an entry counts only where the root id it names matches,
// so the table is never cleared), finds each tile's slot in one pass over the labels, compacts the members in tile
// order (a block scan) and groups them by slot with a stable counting
// sort (block_stable_scatter). Groups of G = 8 lanes then take one slot
// each and reduce over its members only; a thread finishes each slot
// without members. The payload (S and the moments shifted to the image
// centre, a ones column, zero off the gates) and each member's half-extent
// are computed here from the TileStage planes, in the torch glue's
// operation order (lines.py::tile_payload), so the values are those the
// glue gave. Summation order: the members with tile index t = l (mod 32)
// are summed in increasing t for each l, then a fixed 32-lane
// __shfl_down_sync tree adds the 32 sums, the order of the kernel this
// one replaced (a warp a slot, lane l walking the labels t = l mod 32); a
// lane of a group holds the classes g + 8u (u < 4), so the tree's steps 16
// and 8 add its own classes and steps 4, 2, 1 are shuffles in the group.
// The outputs are bit-equal to that kernel's. No float atomics: the sums
// feed the length gate and the top-k ranking, and a run-to-run change of
// summation order could flip either. The min/max projections of the members' centroids -+
// their half-extent on the closed-form principal axis of the merged
// moments are exact in any order.
//
// Launch 2 (lines_merge) replaces ::merge_segments (:214), one block of
// 1024 threads an image. It compacts the valid slots in slot order and
// computes their table (midpoint, canonical direction, half length, angle,
// the weights w, w cos 2a, w sin 2a) in the torch order of
// lines.py::_segment_table. The compatibility test (angle mod pi, mutual
// perpendicular midpoint offset, projection gap) runs on the upper triangle
// of 32 x 32 blocks of the valid slots: a lane tests (i, j) and (j, i), the
// ballot of both gives the symmetric word, a ballot transpose fills the
// lower triangle. The reference's `iters` synchronous label-min sweeps
// follow (labels are slot indices, so the compaction, being monotone,
// keeps every minimum), each row's minimum a reduction over the lanes that
// hold its words, each sweep followed by the hop
// lab <- min(lab, lab[clip(lab, 0, M - 1)]) over all M slots (invalid
// slots carry M and hop through slot M - 1, as the reference); the sweeps
// stop once the labels are a fixed point, which is exact. A stable counting
// sort of the valid slots by label gives each slot its members in
// increasing slot order; one thread per slot sums them in that order (the
// replaced kernel's), takes the support-weighted double-angle direction
// and the endpoints' min/max.
//
// Bound: the refit reads the labels once and the planes of the member
// tiles only (8% of the tiles on the flagship scene): latency, its
// barriers, and the gather of the members' scattered planes hold it; the
// merge is operations (the pair tests), all in shared memory.
//
// Rounding: products and sums are explicit _rn intrinsics in the plain
// version's (and the torch glue's) order; atan2f, cosf and sinf are the
// CUDA library's (built without fast math, as torch's own kernels), so
// the outputs equal those of the torch glue and the kernels these
// replaced to the bit, and the plain versions' to a few ulps, with
// labels, roots and gates exact.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float INF = 1e9f;
constexpr int THREADS = 1024;

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }

// unit eigenvector of the larger eigenvalue of [[sxx, sxy], [sxy, syy]]
// (lines.py::_principal_axis, with its 1e-12 / 1e-20 guards)
__device__ void principal_axis(float sxx, float syy, float sxy, float* nx,
                               float* ny) {
  const float tr = add(sxx, syy), diff = sub(sxx, syy);
  const float disc = __fsqrt_rn(
      add(add(mul(diff, diff), mul(mul(4.f, sxy), sxy)), 1e-20f));
  const float l1 = mul(0.5f, add(tr, disc));
  const bool big = fabsf(sxy) > 1e-12f;
  const float vx = big ? sxy : sub(l1, syy);
  const float vy = big ? sub(l1, sxx) : 1e-12f;
  const float n = __fsqrt_rn(add(add(mul(vx, vx), mul(vy, vy)), 1e-20f));
  *nx = dvd(vx, n);
  *ny = dvd(vy, n);
}

// Exclusive prefix sum of one int per thread over the block; `total`
// gets the block's sum. scratch: 33 ints. Every thread calls it.
__device__ int block_scan(int v, int* scratch, int& total) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  int x = v;
  for (int s = 1; s < 32; s <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, s);
    if (lane >= s) x += y;
  }
  if (lane == 31) scratch[wid] = x;
  __syncthreads();
  if (wid == 0) {
    int w = lane < (int)(blockDim.x >> 5) ? scratch[lane] : 0;
    for (int s = 1; s < 32; s <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, s);
      if (lane >= s) w += y;
    }
    scratch[lane] = w;                      // inclusive over the warps
  }
  __syncthreads();
  const int r = x - v + (wid ? scratch[wid - 1] : 0);
  total = scratch[31];
  __syncthreads();
  return r;
}

// In place exclusive prefix sum of a[0, L); returns the total.
__device__ int scan_array(int* a, int L, int* scratch) {
  int carry = 0;
  for (int base = 0; base < L; base += blockDim.x) {
    const int i = base + threadIdx.x;
    int tot;
    const int e = block_scan(i < L ? a[i] : 0, scratch, tot);
    if (i < L) a[i] = carry + e;
    carry += tot;
  }
  return carry;
}

// A stable counting sort by the block: item i of [0, m) goes to
// out[cur[key(i)]++] as val(i), in the order of i within a key (cur holds
// each key's offset). Each warp ranks the items of its 32-item chunks
// among their peers (same key), one warp walks the chunks in order handing
// each chunk's key groups their offsets (the keys of a chunk's groups are
// distinct), then every item is placed. info, base: m ints of scratch
// each.
template <class Key, class Val>
__device__ void block_stable_scatter(int m, Key key, Val val, int* cur,
                                     int* info, int* base, int* out) {
  const int lane = threadIdx.x & 31;
  const int mr = (m + 31) & ~31;
  for (int i = threadIdx.x; i < mr; i += blockDim.x) {
    const bool act = i < m;
    const int k = act ? key(i) : -1;
    const unsigned am = __ballot_sync(0xffffffffu, act);
    if (act) {
      const unsigned peers = __match_any_sync(am, k);
      info[i] = __popc(peers & ((1u << lane) - 1u)) |
                ((__ffs(peers) - 1) << 5) | (__popc(peers) << 10);
    }
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    for (int c = 0; c < mr; c += 32) {
      const int i = c + lane;
      const int f = i < m ? info[i] : 0;
      if (i < m && ((f >> 5) & 31) == lane) {
        const int k = key(i);
        base[i] = cur[k];
        cur[k] += f >> 10;
      }
      __syncwarp();
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    const int f = info[i];
    out[base[(i & ~31) + ((f >> 5) & 31)] + (f & 31)] = val(i);
  }
}

// ---- launch 1: the refit -------------------------------------------------

struct Planes {
  const uint8_t* ok;
  const float *S, *Sx, *Sy, *Sxx, *Syy, *Sxy, *cx, *cy, *cx_l, *cy_l, *l1;
};

// the 7-float payload of tile t (lines.py::tile_payload, torch's order:
// computed for every tile, then zero off the gates) and its projection
// inputs cx - x0, cy - y0 and half-extent sqrt(max(12 l1, 0)) / 2
__device__ void tile_payload(const Planes& P, size_t t, float x0, float y0,
                             float* p, float* px, float* py, float* he) {
  const bool ok = P.ok[t];
  const float fS = P.S[t], fSx = P.Sx[t], fSy = P.Sy[t];
  const float fSxx = P.Sxx[t], fSyy = P.Syy[t], fSxy = P.Sxy[t];
  const float cx = P.cx[t], cy = P.cy[t], v = mul(12.f, P.l1[t]);
  const float dxc = sub(sub(cx, P.cx_l[t]), x0);
  const float dyc = sub(sub(cy, P.cy_l[t]), y0);
  p[0] = fS;
  p[1] = add(fSx, mul(dxc, fS));
  p[2] = add(fSy, mul(dyc, fS));
  p[3] = add(add(fSxx, mul(mul(2.f, dxc), fSx)), mul(mul(dxc, dxc), fS));
  p[4] = add(add(fSyy, mul(mul(2.f, dyc), fSy)), mul(mul(dyc, dyc), fS));
  p[5] = add(add(add(fSxy, mul(dyc, fSx)), mul(dxc, fSy)),
             mul(mul(dxc, dyc), fS));
  p[6] = 1.f;
#pragma unroll
  for (int k = 0; k < 7; ++k) p[k] = ok ? p[k] : 0.f;
  *px = sub(cx, x0);
  *py = sub(cy, y0);
  *he = mul(__fsqrt_rn(v < 0.f ? 0.f : v), 0.5f);
}

struct Axis {
  float mcx, mcy, mdx, mdy, off;
};

__device__ Axis slot_axis(const float* acc) {
  Axis a;
  const float ms = fmaxf(acc[0], 1e-6f);
  a.mcx = dvd(acc[1], ms);
  a.mcy = dvd(acc[2], ms);
  const float mcxx = sub(dvd(acc[3], ms), mul(a.mcx, a.mcx));
  const float mcyy = sub(dvd(acc[4], ms), mul(a.mcy, a.mcy));
  const float mcxy = sub(dvd(acc[5], ms), mul(a.mcx, a.mcy));
  principal_axis(mcxx, mcyy, mcxy, &a.mdx, &a.mdy);
  a.off = add(mul(a.mdx, a.mcx), mul(a.mdy, a.mcy));
  return a;
}

__device__ void slot_write(size_t o, int rid, const float* acc, Axis a,
                           float pmin, float pmax, float x0, float y0,
                           float len_th, float* sp, float* ep,
                           float* score) {
  const float mS = acc[0];
  const bool root_ok = rid >= 0 && mS > 0.f && acc[6] > 0.f;
  const float length = root_ok ? sub(pmax, pmin) : 0.f;
  const bool seg_ok = root_ok && length > len_th;
  sp[2 * o] = add(add(a.mcx, x0), mul(pmin, a.mdx));
  sp[2 * o + 1] = add(add(a.mcy, y0), mul(pmin, a.mdy));
  ep[2 * o] = add(add(a.mcx, x0), mul(pmax, a.mdx));
  ep[2 * o + 1] = add(add(a.mcy, y0), mul(pmax, a.mdy));
  score[o] = seg_ok ? mS : 0.f;
}

// Lanes a slot in the refit's reduction: G lanes take one slot, each lane
// the U = 32 / G residue classes g, g + G, ... of tile indices mod 32.
constexpr int G = 8, U = 32 / G;

template <int THR>
__global__ void __launch_bounds__(THR)
refit_kernel(const int* __restrict__ root_id, const int* __restrict__ lab,
             Planes P, float* __restrict__ sp, float* __restrict__ ep,
             float* __restrict__ score, int R, int n, int splits, float x0,
             float y0, float len_th) {
  extern __shared__ int sm[];
  const int b = blockIdx.y, split = blockIdx.x;
  // this block's slots: r = split + splits * k, k < L
  const int L = (R - split + splits - 1) / splits;
  int* slot_of = sm;        // n: tile -> this block's slot k, valid where
                            // rid_of[k] names the tile (no clearing), then
                            // the members grouped by slot
  int* tslot = sm + n;      // n: each tile's slot k (-1: none), then the
                            // sort's ranks, then members' cx - x0
  int* list = tslot + n;    // n: (k << 16) | t of the members in tile
                            // order, then members' cy - y0
  int* aux = list + n;      // n: the sort's offsets, then half-extents
  int* rid_of = aux + n;    // L: the slots' root ids
  int* cnt = rid_of + L;    // L
  int* off = cnt + L;       // L
  int* cur = off + L;       // L
  int* scratch = cur + L;   // 33
  const int tid = threadIdx.x;
  const size_t tb = (size_t)b * n;
  const int* labs = lab + tb;
  for (int k = tid; k < L; k += blockDim.x) {
    const int rid = root_id[(size_t)b * R + split + splits * k];
    rid_of[k] = rid;
    cnt[k] = 0;
    if (rid >= 0 && rid < n) slot_of[rid] = k;
  }
  __syncthreads();
  // each tile's slot: one pass over the labels, 8 loads in flight
  for (int tb8 = 0; tb8 < n; tb8 += 8 * blockDim.x) {
    int l[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int t = tb8 + u * blockDim.x + tid;
      l[u] = t < n ? labs[t] : -1;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int t = tb8 + u * blockDim.x + tid;
      if (t >= n) break;
      int s = -1;
      if (l[u] >= 0 && l[u] < n) {
        s = slot_of[l[u]];
        if (s < 0 || s >= L || rid_of[s] != l[u]) s = -1;
      }
      tslot[t] = s;
      if (s >= 0) atomicAdd(&cnt[s], 1);
    }
  }
  __syncthreads();
  // the members in tile order (each thread a contiguous run of tiles),
  // then each slot's offset
  const int run = (n + blockDim.x - 1) / blockDim.x;
  const int t0 = min(n, tid * run), t1 = min(n, t0 + run);
  int c = 0;
  for (int t = t0; t < t1; ++t) c += tslot[t] >= 0;
  int m;
  int pos = block_scan(c, scratch, m);
  for (int k = tid; k < L; k += blockDim.x) off[k] = cnt[k];
  scan_array(off, L, scratch);
  for (int k = tid; k < L; k += blockDim.x) cur[k] = off[k];
  for (int t = t0; t < t1; ++t)
    if (tslot[t] >= 0) list[pos++] = (tslot[t] << 16) | t;
  __syncthreads();
  int* grp = slot_of;
  block_stable_scatter(
      m, [&](int i) { return list[i] >> 16; },
      [&](int i) { return list[i] & 0xffff; }, cur, tslot, aux, grp);
  __syncthreads();
  float* kx = reinterpret_cast<float*>(tslot);
  float* ky = reinterpret_cast<float*>(list);
  float* kh = reinterpret_cast<float*>(aux);

  // slots with members: G lanes a slot, 32 / G slots a warp; warp w's
  // groups take slots w, w + nw, ... (the largest slots come first)
  const int lane = tid & 31, g = lane & (G - 1), gbase = lane & ~(G - 1);
  const int nw = blockDim.x >> 5;
  for (int k0 = tid >> 5; k0 < L; k0 += nw * (32 / G)) {
    const int k = k0 + (lane / G) * nw;
    const int cr = k < L ? cnt[k] : 0;
    // the warp's loops run to the largest member count of its groups
    int crmax = cr;
    for (int s = 16; s > 0; s >>= 1)
      crmax = max(crmax, __shfl_xor_sync(0xffffffffu, crmax, s));
    if (crmax == 0) continue;
    const int o = k < L ? off[k] : 0;
    const int* mem = grp + o;
    const int rid = k < L ? rid_of[k] : -1;
    // G members at a time: each lane loads one member's payload (and
    // stages its projection inputs); then in rounds each lane gathers by
    // shuffles, in tile order, the members of its residue classes
    // t mod 32 = g + G u (u < U) and adds them to class u's sums
    float acc[U][7];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int q = 0; q < 7; ++q) acc[u][q] = 0.f;
    for (int j0 = 0; j0 < crmax; j0 += G) {
      const bool here = j0 + g < cr;
      const int t = here ? mem[j0 + g] : 0;
      float p[7], px, py, he;
      tile_payload(P, tb + t, x0, y0, p, &px, &py, &he);
      if (here) {
        kx[o + j0 + g] = px;
        ky[o + j0 + g] = py;
        kh[o + j0 + g] = he;
      }
      unsigned own = 0;   // bit i: member j0 + i is in one of my classes
#pragma unroll
      for (int r = 0; r < G; ++r) {
        const unsigned bal =
            __ballot_sync(0xffffffffu, here && (t & (G - 1)) == r);
        if (g == r) own = (bal >> gbase) & ((1u << G) - 1u);
      }
      int rounds = __popc(own);
      for (int s = 16; s > 0; s >>= 1)
        rounds = max(rounds, __shfl_xor_sync(0xffffffffu, rounds, s));
      for (int rd = 0; rd < rounds; ++rd) {
        const bool take = own != 0;
        const int src = gbase + (take ? __ffs(own) - 1 : 0);
        own &= own - 1;
        const int ui = (__shfl_sync(0xffffffffu, t, src) / G) & (U - 1);
#pragma unroll
        for (int q = 0; q < 7; ++q) {
          const float x = __shfl_sync(0xffffffffu, p[q], src);
#pragma unroll
          for (int u = 0; u < U; ++u)
            if (take && u == ui) acc[u][q] = add(acc[u][q], x);
        }
      }
    }
    // the 32-lane __shfl_down_sync tree of a warp a slot: its steps
    // 16 .. G add a lane's own residue classes, the steps below G are
    // shuffles in the group
#pragma unroll
    for (int h = U / 2; h > 0; h >>= 1)
#pragma unroll
      for (int u = 0; u < h; ++u)
#pragma unroll
        for (int q = 0; q < 7; ++q) acc[u][q] = add(acc[u][q], acc[u + h][q]);
    float tot[7];
#pragma unroll
    for (int q = 0; q < 7; ++q) tot[q] = acc[0][q];
    for (int s = G / 2; s > 0; s >>= 1)
#pragma unroll
      for (int q = 0; q < 7; ++q)
        tot[q] = add(tot[q], __shfl_down_sync(0xffffffffu, tot[q], s, G));
#pragma unroll
    for (int q = 0; q < 7; ++q)
      tot[q] = __shfl_sync(0xffffffffu, tot[q], gbase);
    const Axis a = slot_axis(tot);
    float pmin = INF, pmax = -INF;
    for (int j = g; j < cr; j += G) {
      const float pc = sub(add(mul(kx[o + j], a.mdx), mul(ky[o + j], a.mdy)),
                           a.off);
      pmin = fminf(pmin, sub(pc, kh[o + j]));
      pmax = fmaxf(pmax, add(pc, kh[o + j]));
    }
    for (int s = G / 2; s > 0; s >>= 1) {
      pmin = fminf(pmin, __shfl_down_sync(0xffffffffu, pmin, s, G));
      pmax = fmaxf(pmax, __shfl_down_sync(0xffffffffu, pmax, s, G));
    }
    if (g == 0 && cr > 0)
      slot_write((size_t)b * R + split + splits * k, rid, tot, a, pmin, pmax,
                 x0, y0, len_th, sp, ep, score);
  }
  // slots without members (empty slots): one thread a slot
  for (int k = tid; k < L; k += blockDim.x) {
    if (cnt[k] != 0) continue;
    const float acc[7] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    slot_write((size_t)b * R + split + splits * k, rid_of[k], acc,
               slot_axis(acc), INF, -INF, x0, y0, len_th, sp, ep, score);
  }
}

// ---- launch 2: the merge -------------------------------------------------

__global__ void __launch_bounds__(THREADS)
merge_kernel(const float* __restrict__ sp, const float* __restrict__ ep,
             const float* __restrict__ score, int score_stride,
             const uint8_t* __restrict__ valid, float* __restrict__ sp_m,
             float* __restrict__ ep_m, float* __restrict__ ang_m,
             float* __restrict__ score_m, uint8_t* __restrict__ root_out,
             int* __restrict__ lab_out, int M, float ang_th, float dist_th,
             float gap_th, int iters) {
  extern __shared__ float4 sm4[];
  const int Wd = (M + 31) / 32;
  float4* geo = sm4;                       // M: mid.x, mid.y, du.x, du.y
  float4* ends = geo + M;                  // M: sp.x, sp.y, ep.x, ep.y
  float4* wts = ends + M;                  // M: half, ang, w, w cos 2a
  float* ws2 = reinterpret_cast<float*>(wts + M);               // M
  uint32_t* sym = reinterpret_cast<uint32_t*>(ws2 + M);         // M * Wd
  int* A = reinterpret_cast<int*>(sym + M * Wd);                // M
  int* B = A + M;                                               // M
  int* v = B + M;                                               // M
  int* vi = v + M;                                              // M
  int* cnt = vi + M;                                            // M
  int* off = cnt + M;                                           // M
  int* grp = off + M;                                           // M
  int* info = grp + M;                                          // M
  int* base = info + M;                                         // M
  int* scratch = base + M;                                      // 33
  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31;
  const int wid = tid >> 5, nw = blockDim.x >> 5;
  const float PI = 3.14159265358979323846f;

  // the valid slots in slot order (vi[0, mv)) and the per-segment table
  // (lines.py::_segment_table, torch's order) of each
  int mv = 0;
  for (int base = 0; base < M; base += blockDim.x) {
    const int i = base + tid;
    const bool vb = i < M && valid[(size_t)b * M + i] != 0;
    int tot;
    const int e = block_scan(vb, scratch, tot);
    if (vb) vi[mv + e] = i;
    mv += tot;
    if (i < M) {
      v[i] = vb;
      A[i] = vb ? i : M;
      cnt[i] = 0;
    }
    if (!vb) continue;
    const size_t o = (size_t)b * M + i;
    const float spx = sp[2 * o], spy = sp[2 * o + 1];
    const float epx = ep[2 * o], epy = ep[2 * o + 1];
    const float dx = sub(epx, spx), dy = sub(epy, spy);
    const float len =
        __fsqrt_rn(add(add(mul(dx, dx), mul(dy, dy)), (float)1e-12));
    float dux = dvd(dx, len), duy = dvd(dy, len);
    if (dux < 0.f) {
      dux = -dux;
      duy = -duy;
    }
    const float ang = atan2f(duy, dux);
    const float w = score[(size_t)b * score_stride + i];
    geo[i] = make_float4(mul(0.5f, add(spx, epx)), mul(0.5f, add(spy, epy)),
                         dux, duy);
    ends[i] = make_float4(spx, spy, epx, epy);
    wts[i] = make_float4(mul(0.5f, len), ang, w, mul(w, cosf(mul(2.f, ang))));
    ws2[i] = mul(w, sinf(mul(2.f, ang)));
  }
  __syncthreads();

  // compatibility of the valid slots, on the upper triangle of 32 x 32
  // blocks of their compacted indices (I <= J), 8 rows a task: lane =
  // column; both directions, ANDed, in one ballot
  const int Wc = (mv + 31) / 32;
  const int pairs = Wc * (Wc + 1) / 2;
  for (int task = wid; task < pairs * 4; task += nw) {
    int p = task >> 2, I = 0;
    while (p >= Wc - I) {
      p -= Wc - I;
      ++I;
    }
    const int J = I + p;
    const int jc = J * 32 + lane;
    const bool vj = jc < mv;
    const int j = vj ? vi[jc] : 0;
    const float4 gj = geo[j], wj = wts[j];
    const int i0 = I * 32 + (task & 3) * 8;
    for (int ic = i0; ic < min(i0 + 8, mv); ++ic) {
      const int i = vi[ic];
      const float4 gi = geo[i], wi = wts[i];
      float dang = fabsf(sub(wi.y, wj.y));
      dang = fminf(dang, sub(PI, dang));
      const float hs = add(wi.x, wj.x);
      // i's test of j (mid_j - mid_i on i's frame)
      const float r0 = sub(gj.x, gi.x), r1 = sub(gj.y, gi.y);
      const float off_ij = fabsf(add(mul(-gi.w, r0), mul(gi.z, r1)));
      const float gap_ij = sub(fabsf(add(mul(gi.z, r0), mul(gi.w, r1))), hs);
      // j's test of i
      const float q0 = sub(gi.x, gj.x), q1 = sub(gi.y, gj.y);
      const float off_ji = fabsf(add(mul(-gj.w, q0), mul(gj.z, q1)));
      const float gap_ji = sub(fabsf(add(mul(gj.z, q0), mul(gj.w, q1))), hs);
      const bool ok = vj && dang < ang_th && off_ij < dist_th &&
                      gap_ij < gap_th && off_ji < dist_th && gap_ji < gap_th;
      const uint32_t word = __ballot_sync(0xffffffffu, ok);
      if (lane == 0) sym[ic * Wc + J] = word;
    }
  }
  __syncthreads();
  // the lower triangle: each off-diagonal block transposed by ballots
  for (int p = wid; p < pairs; p += nw) {
    int q = p, I = 0;
    while (q >= Wc - I) {
      q -= Wc - I;
      ++I;
    }
    const int J = I + q;
    if (I == J) continue;
    const int ic = I * 32 + lane;
    const uint32_t w = ic < mv ? sym[ic * Wc + J] : 0u;
    uint32_t mine = 0;
    for (int c = 0; c < 32; ++c) {
      const uint32_t t = __ballot_sync(0xffffffffu, (w >> c) & 1u);
      if (lane == c) mine = t;
    }
    const int jc = J * 32 + lane;
    if (jc < mv) sym[jc * Wc + I] = mine;
  }
  __syncthreads();

  // label-min sweeps over the valid rows: G lanes a row, each G-th word,
  // a shuffle minimum; invalid slots keep their label
  int Gs = 1;
  while (Gs < Wc && Gs < 32) Gs <<= 1;
  const int rows_w = 32 / Gs;
  for (int it = 0; it < iters; ++it) {
    for (int r0 = wid * rows_w; r0 < mv; r0 += nw * rows_w) {
      const int ic = r0 + lane / Gs, q = lane % Gs;
      int mn = 0x7fffffff;
      if (ic < mv) {
        if (q == 0) mn = A[vi[ic]];
        for (int wd = q; wd < Wc; wd += Gs) {
          uint32_t bits = sym[ic * Wc + wd];
          while (bits) {
            const int jj = __ffs(bits) - 1;
            bits &= bits - 1;
            mn = min(mn, A[vi[wd * 32 + jj]]);
          }
        }
      }
      for (int s = Gs >> 1; s > 0; s >>= 1)
        mn = min(mn, __shfl_xor_sync(0xffffffffu, mn, s));
      if (ic < mv && q == 0) B[vi[ic]] = mn;
    }
    for (int i = tid; i < M; i += blockDim.x)
      if (!v[i]) B[i] = A[i];
    __syncthreads();
    int changed = 0;
    for (int i = tid; i < M; i += blockDim.x) {
      const int x = B[i];
      const int nv = min(x, B[min(max(x, 0), M - 1)]);
      changed |= nv != A[i];
      A[i] = nv;
    }
    // a fixed point stays one: the remaining sweeps change nothing
    if (!__syncthreads_or(changed)) break;
  }

  // each label's members, in increasing slot order
  for (int ic = tid; ic < mv; ic += blockDim.x) atomicAdd(&cnt[A[vi[ic]]], 1);
  __syncthreads();
  for (int r = tid; r < M; r += blockDim.x) off[r] = cnt[r];
  scan_array(off, M, scratch);
  // cur aliases B (the sweeps are done)
  for (int r = tid; r < M; r += blockDim.x) B[r] = off[r];
  __syncthreads();
  block_stable_scatter(
      mv, [&](int ic) { return A[vi[ic]]; }, [&](int ic) { return vi[ic]; },
      B, info, base, grp);
  __syncthreads();

  // one thread a slot: the support-weighted double-angle refit (a slot
  // without members: atan2f(0, 0) = 0, cosf(0) = 1, sinf(0) = 0 exactly)
  for (int r = tid; r < M; r += blockDim.x) {
    const int c = cnt[r];
    const int* mem = grp + off[r];
    float wsum = 0.f, c2 = 0.f, s2 = 0.f, cx = 0.f, cy = 0.f;
    for (int k = 0; k < c; ++k) {
      const int j = mem[k];
      const float4 wj = wts[j], gj = geo[j];
      wsum = add(wsum, wj.z);
      c2 = add(c2, wj.w);
      s2 = add(s2, ws2[j]);
      cx = add(cx, mul(wj.z, gj.x));
      cy = add(cy, mul(wj.z, gj.y));
    }
    float am = 0.f, dmx = 1.f, dmy = 0.f;
    if (c > 0) {
      am = mul(0.5f, atan2f(s2, c2));
      dmx = cosf(am);
      dmy = sinf(am);
    }
    const float ws = fmaxf(wsum, 1e-6f);
    const float cenx = dvd(cx, ws), ceny = dvd(cy, ws);
    const float dcen = add(mul(dmx, cenx), mul(dmy, ceny));
    float lo = INF, hi = -INF;
    for (int k = 0; k < c; ++k) {
      const float4 e = ends[mem[k]];
      const float ps = sub(add(mul(dmx, e.x), mul(dmy, e.y)), dcen);
      const float pe = sub(add(mul(dmx, e.z), mul(dmy, e.w)), dcen);
      lo = fminf(lo, fminf(ps, pe));
      hi = fmaxf(hi, fmaxf(ps, pe));
    }
    const bool is_root = v[r] && A[r] == r && wsum > 0.f;
    const size_t o = (size_t)b * M + r;
    sp_m[2 * o] = add(cenx, mul(lo, dmx));
    sp_m[2 * o + 1] = add(ceny, mul(lo, dmy));
    ep_m[2 * o] = add(cenx, mul(hi, dmx));
    ep_m[2 * o + 1] = add(ceny, mul(hi, dmy));
    ang_m[o] = am;
    score_m[o] = is_root ? wsum : 0.f;
    root_out[o] = is_root;
    lab_out[o] = A[r];
  }
}

}  // namespace

extern "C" {

// root_id (N, R) int32 (-1 empty), labels (N, n) int32, tile_ok (N, n)
// bool, the TileStage planes S, Sx, Sy, Sxx, Syy, Sxy, cx, cy, cx_l,
// cy_l, l1 (N, n) f32 -> sp, ep (N, R, 2), score (N, R) f32.
int lines_refit(const int* root_id, const int* lab, const uint8_t* ok,
                const float* S, const float* Sx, const float* Sy,
                const float* Sxx, const float* Syy, const float* Sxy,
                const float* cx, const float* cy, const float* cx_l,
                const float* cy_l, const float* l1, float* sp, float* ep,
                float* score, int N, int R, int n, float x0, float y0,
                float len_th, cudaStream_t stream) {
  // blocks an image: as many as keep the grid in one wave of the card's
  // SMs, at most 4 (each repeats the pass over the labels); 3 beat 1, 2
  // and 4 on the H100 at 40 images, both resolutions
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const int splits = max(1, min(min(4, R), sms / max(N, 1)));
  // list packs (slot << 16) | tile
  if (R < 1 || n > 65536 || R / splits >= 32768)
    return (int)cudaErrorInvalidValue;
  const int L = (R + splits - 1) / splits;
  const size_t smem = ((size_t)4 * n + 4 * (size_t)L + 33) * sizeof(int);
  const Planes P{ok, S, Sx, Sy, Sxx, Syy, Sxy, cx, cy, cx_l, cy_l, l1};
  // 1024 threads a block for a full-resolution grid (7,084 tiles), 512
  // for a half-resolution one (1,672), the faster of each on the H100
  const int threads = n > 4096 ? 1024 : 512;
  auto kernel = threads == 1024 ? refit_kernel<1024> : refit_kernel<512>;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<dim3(splits, N), threads, smem, stream>>>(
      root_id, lab, P, sp, ep, score, R, n, splits, x0, y0, len_th);
  return (int)cudaGetLastError();
}

// sp, ep (N, M, 2), score (N, M) rows `score_stride` apart, valid (N, M)
// bool -> merged sp, ep (N, M, 2), angle, score (N, M) f32, is_root (N, M)
// bool, labels (N, M) int32.
int lines_merge(const float* sp, const float* ep, const float* score,
                const uint8_t* valid, float* sp_m, float* ep_m, float* ang_m,
                float* score_m, uint8_t* root, int* lab, int N, int M,
                int score_stride, float ang_th, float dist_th, float gap_th,
                int iters, cudaStream_t stream) {
  const int Wd = (M + 31) / 32;
  const size_t smem = (size_t)M * (3 * sizeof(float4) + sizeof(float)) +
                      (size_t)M * Wd * sizeof(uint32_t) +
                      ((size_t)9 * M + 33) * sizeof(int);
  cudaError_t e = cudaFuncSetAttribute(
      merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  merge_kernel<<<N, THREADS, smem, stream>>>(
      sp, ep, score, score_stride, valid, sp_m, ep_m, ang_m, score_m, root,
      lab, M, ang_th, dist_th, gap_th, iters);
  return (int)cudaGetLastError();
}

}  // extern "C"
