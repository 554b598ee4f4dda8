// Kernel A: separable edge-replicate filter and bilinear resize (K3).
//
// Replaces plslam_tpu/ops/image.py::separable_filter2d (:71) and
// ::resize_bilinear (:86), which the reference runs as banded-matrix
// products Mr @ img @ Mc^T (_filter_matrix :35, _resize_matrix :48). Here
// they are what those matrices compute, batched over N images of one
// shape: the filter as a vertical pass, then a horizontal pass; the resize
// (two taps a side) as one pass, below.
//
// Bound: bytes. A 7- or 15-tap pass does 2 flops per tap per pixel
// (at most 30 per pixel) against 8 bytes of traffic per pixel, far below
// the card's ~20 flop/byte balance point for f32. The filter reads each
// source row through L1 (neighbouring threads share taps), writes the
// intermediate once, and keeps the kernels simple: one thread per output
// pixel, rows of 32 threads on contiguous addresses.
//
// Rounding: the taps are summed in tap order with FMA contraction, the
// reference sums the banded products in its own order, so results differ
// by a few ulps (<= 1e-6 absolute for images in [0, 1]).

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// out[n, i, j] = sum_t k[t] * in[n, clamp(i + t - r), j]
__global__ void filter_vertical(const float* __restrict__ in,
                                float* __restrict__ out,
                                const float* __restrict__ k, int H, int W,
                                int r) {
  int j = blockIdx.x * blockDim.x + threadIdx.x;
  int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= H || j >= W) return;
  const float* src = in + (size_t)blockIdx.z * H * W;
  float acc = 0.f;
  for (int t = 0; t <= 2 * r; ++t)
    acc += k[t] * src[(size_t)clampi(i + t - r, 0, H - 1) * W + j];
  out[(size_t)blockIdx.z * H * W + (size_t)i * W + j] = acc;
}

// out[n, i, j] = sum_t k[t] * in[n, i, clamp(j + t - r)]
__global__ void filter_horizontal(const float* __restrict__ in,
                                  float* __restrict__ out,
                                  const float* __restrict__ k, int H, int W,
                                  int r) {
  int j = blockIdx.x * blockDim.x + threadIdx.x;
  int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= H || j >= W) return;
  const float* src = in + (size_t)blockIdx.z * H * W + (size_t)i * W;
  float acc = 0.f;
  for (int t = 0; t <= 2 * r; ++t)
    acc += k[t] * src[clampi(j + t - r, 0, W - 1)];
  out[(size_t)blockIdx.z * H * W + (size_t)i * W + j] = acc;
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

dim3 grid_for(int W, int H, int N, dim3 block) {
  return dim3((W + block.x - 1) / block.x, (H + block.y - 1) / block.y, N);
}

}  // namespace

extern "C" {

// in (N, H, W) -> tmp (N, H, W) vertical pass -> out (N, H, W) horizontal.
int image_sep_filter(const float* in, float* tmp, float* out, const float* ky,
                     const float* kx, int N, int H, int W, int ry, int rx,
                     cudaStream_t stream) {
  dim3 block(32, 8);
  filter_vertical<<<grid_for(W, H, N, block), block, 0, stream>>>(
      in, tmp, ky, H, W, ry);
  filter_horizontal<<<grid_for(W, H, N, block), block, 0, stream>>>(
      tmp, out, kx, H, W, rx);
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
