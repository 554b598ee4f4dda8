// Kernel A: separable edge-replicate filter and bilinear resize (K3).
//
// Replaces plslam_tpu/ops/image.py::separable_filter2d (:71, with
// gaussian_blur :80) and ::resize_bilinear (:86), which the reference
// runs as banded-matrix products Mr @ img @ Mc^T (_filter_matrix :35,
// _resize_matrix :48). Here they are what those matrices compute, batched
// over N images of one shape, each in one pass.
//
// Filter (filter_kernel), bound by bytes: a 7- or 15-tap pass does 2
// flops a tap a pixel against 8 bytes of traffic a pixel (12 for the
// pair), far below the card's ~20 flop/byte balance for f32. One launch
// moves only those bytes. Each block
//  1. stages a (FT_Y + 2R) x (FT_X + 2R + 3) input tile in shared memory,
//     rows and columns clamped (edge replication), by asynchronous copies
//     (cp.async): a thread's loads are all in flight at once, not one
//     round trip each;
//  2. runs the vertical pass over every tile column into a second shared
//     buffer (a thread walks FT_G rows of one column with its 2R + FT_G
//     inputs in registers);
//  3. runs the horizontal pass from that buffer into registers (a
//     thread's 4 outputs and their 4 + 2R inputs, read as 16-byte loads)
//     and writes each output once: a thread writes a strip of 4 columns
//     of one row, aligned to the output's addresses as resize_kernel's
//     strips are (16-byte stores; a row's ragged ends singly).
// The taps come by value in the launch's parameters: no table in device
// memory. The paired mode filters one input with two tap sets (ORB's
// moment maps m10, m01): the input is read and staged once, two vertical
// passes fill two buffers, two horizontal passes write two outputs, and
// the outputs may be columns of larger buffers (a row stride per image).
// On an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py): the level-0 blur
// 0.059 ms at 40 x 376x1241 (bound 0.0446; the two passes it replaced:
// 0.255), the moment pair 0.027 ms at 40 x 188x620 (bound 0.0167).
//
// Rounding: each output is the two expressions of the two-pass kernels
// it replaced, acc = 0; acc += k[t] * x in tap order, vertical then
// horizontal, so nvcc contracts the same FMAs and the f32 intermediate
// is the same: their bits. The reference sums the banded
// products in its own order: a few ulps apart (<= 1e-6 absolute for
// images in [0, 1]). A tap set shorter than the launch's radius is padded
// with zero taps, which leave an f32 sum of finite values unchanged (the
// sum starts at +0 and never becomes -0).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// 4-byte global -> shared copy that does not wait for its data
// (cp.async, sm_80 and later); cp_async_wait_all waits for the thread's own
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

constexpr int FT_NX = 32, FT_NY = 8;     // 256 threads
constexpr int FT_X = 4 * FT_NX;          // 128 output columns a block
constexpr int FT_Y = 16;                 // output rows a block
constexpr int FT_G = 4;                  // vertical outputs a thread walk
constexpr int FT_MAXR = 7;

// vertical taps then horizontal taps of each of (at most) two filters
struct FilterTaps {
  float k[2][2][2 * FT_MAXR + 2];
};

template <int R>
struct FilterShape {
  static constexpr int CW = FT_X + 2 * R + 3;     // tile columns
  static constexpr int NV = (2 * R + 10) / 4;     // 16-byte loads a strip
  static constexpr int P = 4 * (FT_NX - 1 + NV);  // buffer pitch (>= CW)
  static constexpr int TR = FT_Y + 2 * R;         // tile rows
};

// A thread's 4 outputs of one row from its window w of the vertical
// buffer: w[S + q + t] is tap t of output q (S = 3 - the row's shift).
template <int R, int S, int NW>
__device__ __forceinline__ void horizontal(const float (&w)[NW],
                                           const float (&k)[2 * R + 1],
                                           float (&o)[4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    float acc = 0.f;
#pragma unroll
    for (int t = 0; t <= 2 * R; ++t) acc += k[t] * w[S + q + t];
    o[q] = acc;
  }
}

template <int R, int NW>
__device__ __forceinline__ void horizontal_s(int s, const float (&w)[NW],
                                             const float (&k)[2 * R + 1],
                                             float (&o)[4]) {
  switch (s) {  // the row's shift: the same for the whole warp
    case 0: horizontal<R, 3>(w, k, o); break;
    case 1: horizontal<R, 2>(w, k, o); break;
    case 2: horizontal<R, 1>(w, k, o); break;
    default: horizontal<R, 0>(w, k, o); break;
  }
}

template <int R, bool PAIR>
__global__ void __launch_bounds__(FT_NX * FT_NY)
    filter_kernel(const float* __restrict__ in, float* __restrict__ out0,
                  float* __restrict__ out1, const FilterTaps taps, int H,
                  int W, long long out_stride) {
  using S = FilterShape<R>;
  constexpr int NF = PAIR ? 2 : 1;
  __shared__ __align__(16) float tile[S::TR * S::CW];
  __shared__ __align__(16) float vbuf[NF][FT_Y * S::P];
  const int tid = threadIdx.y * FT_NX + threadIdx.x;
  const int x0 = blockIdx.x * FT_X, y0 = blockIdx.y * FT_Y;
  const float* src = in + (size_t)blockIdx.z * H * W;
  // 1. the input tile: tile column c holds image column x0 - R - 3 + c
  // (asynchronous copies: a thread's loads are all in flight at once;
  // its columns' clamps are computed once)
  constexpr int NC = (S::CW + FT_NX - 1) / FT_NX;
  int xs[NC];
#pragma unroll
  for (int u = 0; u < NC; ++u)
    xs[u] = clampi(x0 - R - 3 + (int)threadIdx.x + u * FT_NX, 0, W - 1);
  for (int r = threadIdx.y; r < S::TR; r += FT_NY) {
    const float* row = src + clampi(y0 - R + r, 0, H - 1) * W;
#pragma unroll
    for (int u = 0; u < NC; ++u) {
      const int c = threadIdx.x + u * FT_NX;
      if (c < S::CW) cp_async4(tile + r * S::CW + c, row + xs[u]);
    }
  }
  cp_async_wait_all();
  __syncthreads();
  // 2. vertical passes: vbuf[f][i][c] = sum_t ky[t] tile[i + t][c]
  for (int item = tid; item < (FT_Y / FT_G) * S::CW;
       item += FT_NX * FT_NY) {
    const int g = item / S::CW, c = item - g * S::CW;
    float v[FT_G + 2 * R];
#pragma unroll
    for (int r = 0; r < FT_G + 2 * R; ++r)
      v[r] = tile[(g * FT_G + r) * S::CW + c];
#pragma unroll
    for (int f = 0; f < NF; ++f) {
#pragma unroll
      for (int q = 0; q < FT_G; ++q) {
        float acc = 0.f;
#pragma unroll
        for (int t = 0; t <= 2 * R; ++t) acc += taps.k[f][0][t] * v[q + t];
        vbuf[f][(g * FT_G + q) * S::P + c] = acc;
      }
    }
  }
  __syncthreads();
  // 3. horizontal passes, 4 columns of a row a thread, and the stores
  for (int i = threadIdx.y; i < FT_Y; i += FT_NY) {
    const int y = y0 + i;
    if (y >= H) break;
    const size_t row = (size_t)blockIdx.z * out_stride + (size_t)y * W;
    // this thread's columns j0 .. j0 + 3, aligned to 16 bytes of out0
    const int s = (int)(((uintptr_t)(out0 + row) >> 2) & 3);
    const int j0 = x0 + 4 * threadIdx.x - s;
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      float w[4 * S::NV];
      const float4* b =
          reinterpret_cast<const float4*>(vbuf[f] + i * S::P) + threadIdx.x;
#pragma unroll
      for (int u = 0; u < S::NV; ++u) {
        const float4 q = b[u];
        w[4 * u] = q.x; w[4 * u + 1] = q.y;
        w[4 * u + 2] = q.z; w[4 * u + 3] = q.w;
      }
      float kx[2 * R + 1], o[4];
#pragma unroll
      for (int t = 0; t <= 2 * R; ++t) kx[t] = taps.k[f][1][t];
      horizontal_s<R>(s, w, kx, o);
      float* dst = (f == 0 ? out0 : out1) + row;
      if (j0 >= 0 && j0 + 4 <= W) {
        *reinterpret_cast<float4*>(dst + j0) = make_float4(o[0], o[1], o[2],
                                                           o[3]);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (j0 + q >= 0 && j0 + q < W) dst[j0 + q] = o[q];
      }
    }
  }
}

template <int R>
void launch_filter(const float* in, float* out0, float* out1,
                   const FilterTaps& taps, int N, int H, int W,
                   long long out_stride, cudaStream_t stream) {
  const dim3 block(FT_NX, FT_NY);
  const dim3 grid((W + 3 + FT_X - 1) / FT_X, (H + FT_Y - 1) / FT_Y, N);
  if (out1)
    filter_kernel<R, true><<<grid, block, 0, stream>>>(in, out0, out1, taps,
                                                      H, W, out_stride);
  else
    filter_kernel<R, false><<<grid, block, 0, stream>>>(in, out0, nullptr,
                                                       taps, H, W, out_stride);
}

// Resize (ops/image.py::resize_bilinear :86), one pass: out[n, i, j] =
// cw0[j] v(ci0[j]) + cw1[j] v(ci1[j]) with v(c) = rw0[i] in[n, ri0[i], c]
// + rw1[i] in[n, ri1[i], c]. These are the two expressions of the
// vertical and horizontal kernels it replaced, so nvcc contracts the same
// FMAs and the outputs are the same bits, but their (N, Ho, W)
// intermediate never reaches device memory.
//
// Bound: bytes, the input read once and the output written once (2 x 2
// FMAs a pixel). A thread writes a strip of RS_STRIP columns of one output
// row; the strips are aligned to the output's addresses, not to the row,
// so every full strip is one 16-byte store and only a row's first and
// last strips store singly. The source reads go through L1: a warp's 32
// strips read ~RS_STRIP x 32 x (W / Wo) neighbouring columns of two
// source rows, and a block's 8 output rows share most of their source
// rows. (Staging each block's source band in shared memory with 16-byte
// loads first took 0.1128 ms against this kernel's 0.0506 at 40 x
// 376x1241 -> 313x1034, and 0.0624 against 0.0383 at 1/2, on an NVIDIA
// H100 80GB HBM3 at 700 W: the L1 path already moves about the bytes the
// function needs.) The taps come from one packed table: int4 (ri0, ri1,
// rw0, rw1)
// per output row, then (ci0, ci1, cw0, cw1) per output column, the
// weights as float bits.
constexpr int RS_STRIP = 4;
constexpr int RS_NX = 32, RS_NY = 8;

__global__ void __launch_bounds__(RS_NX * RS_NY)
    resize_kernel(const float* __restrict__ in, float* __restrict__ out,
                  const int4* __restrict__ taps, int H, int W, int Ho,
                  int Wo) {
  const int i = blockIdx.y * RS_NY + threadIdx.y;
  if (i >= Ho) return;
  const size_t row = ((size_t)blockIdx.z * Ho + i) * Wo;
  // this thread's columns j0 .. j0 + 3, aligned to 16 bytes of out
  const int j0 = (blockIdx.x * RS_NX + threadIdx.x) * RS_STRIP -
                 (int)(row % RS_STRIP);
  if (j0 >= Wo) return;
  const int4 rt = taps[i];
  const float rw0 = __int_as_float(rt.z), rw1 = __int_as_float(rt.w);
  const float* src0 = in + ((size_t)blockIdx.z * H + rt.x) * W;
  const float* src1 = in + ((size_t)blockIdx.z * H + rt.y) * W;
  float o[RS_STRIP];
#pragma unroll
  for (int q = 0; q < RS_STRIP; ++q) {
    const int j = min(max(j0 + q, 0), Wo - 1);
    const int4 ct = taps[Ho + j];
    const float v0 = rw0 * src0[ct.x] + rw1 * src1[ct.x];
    const float v1 = rw0 * src0[ct.y] + rw1 * src1[ct.y];
    o[q] = __int_as_float(ct.z) * v0 + __int_as_float(ct.w) * v1;
  }
  float* dst = out + row;
  if (j0 >= 0 && j0 + RS_STRIP <= Wo) {
    *reinterpret_cast<float4*>(dst + j0) =
        make_float4(o[0], o[1], o[2], o[3]);
  } else {
#pragma unroll
    for (int q = 0; q < RS_STRIP; ++q)
      if (j0 + q >= 0 && j0 + q < Wo) dst[j0 + q] = o[q];
  }
}

}  // namespace

extern "C" {

// in (N, H, W) -> out0 (and with out1, the paired mode, out1): image n's
// output row y at out + n * out_stride + y * W, out_stride >= H * W (4-byte
// aligned). taps: host floats [filter][vertical, horizontal][16], each set
// 2 * radius + 1 taps from index 0 (shorter ones padded with zeros around
// their centre); radius 0..7.
int image_sep_filter(const float* in, float* out0, float* out1,
                     const float* taps, int N, int H, int W, int radius,
                     int out_stride, cudaStream_t stream) {
  // the paired outputs share their strips' alignment
  if (out1 && (((uintptr_t)out0 ^ (uintptr_t)out1) & 15))
    return (int)cudaErrorMisalignedAddress;
  FilterTaps t;
  for (int i = 0; i < 2 * 2 * (2 * FT_MAXR + 2); ++i)
    (&t.k[0][0][0])[i] = taps[i];
  using Launch = void (*)(const float*, float*, float*, const FilterTaps&,
                          int, int, int, long long, cudaStream_t);
  static const Launch by_radius[FT_MAXR + 1] = {
      launch_filter<0>, launch_filter<1>, launch_filter<2>, launch_filter<3>,
      launch_filter<4>, launch_filter<5>, launch_filter<6>, launch_filter<7>};
  if (radius < 0 || radius > FT_MAXR) return (int)cudaErrorInvalidValue;
  by_radius[radius](in, out0, out1, t, N, H, W, out_stride, stream);
  return (int)cudaGetLastError();
}

// in (N, H, W) -> out (N, Ho, Wo), one launch; taps (Ho + Wo) int4 of
// _resize_matrix's two source indices and weights per output row, then
// per output column. out must be 16-byte aligned.
int image_resize(const float* in, float* out, const int4* taps, int N, int H,
                 int W, int Ho, int Wo, cudaStream_t stream) {
  const int strips = (Wo + 2 * RS_STRIP - 2) / RS_STRIP;
  const dim3 block(RS_NX, RS_NY);
  const dim3 grid((strips + RS_NX - 1) / RS_NX, (Ho + RS_NY - 1) / RS_NY, N);
  resize_kernel<<<grid, block, 0, stream>>>(in, out, taps, H, W, Ho, Wo);
  return (int)cudaGetLastError();
}

}  // extern "C"
