// Adaptive separable convolution for Hopper (sm_90a): the SepConv hot op.
//
//   out(n, c, y, x) = sum_k sum_l in(n, c, y+k, x+l) * kv(n, k, y, x) * kh(n, l, y, x)
//
// Layouts are the model's natural NCHW: in (N, C, H+F-1, W+F-1), kv/kh
// (N, F, H, W), out (N, C, H, W), all float32 and contiguous.
//
// sepconv_forward replaces the TPU forward kernel
// meta_interpolation_tpu/ops/sepconv.py:134 (_pallas_forward / _fwd_kernel).
// sepconv_grad_kernels replaces the fused kernel-map gradient
// meta_interpolation_tpu/ops/sepconv.py:233 (_pallas_grad_kernels /
// _grad_kernels_kernel):
//   gw(k, l)  = sum_c g(c) * in(c, y+k, x+l)
//   gkv(k)    = sum_l kh(l) * gw(k, l)
//   gkh(l)    = sum_k kv(k) * gw(k, l)
//
// Bound on an H100 at the SepConv shape (N=1, C=3, F=51, maps 384x512):
//   forward   F(F+1)C = 7956 FMA a pixel, 3.1 GFLOP against ~85 MB moved:
//             compute-bound (~47 us at 67 TFLOP/s fp32, SXM data sheet);
//   gradient  F^2(C+2) = 13005 FMA a pixel, 5.1 GFLOP against ~166 MB:
//             compute-bound (~76 us).
// Neither fits the tensor cores: every pixel has its own 51x51 filter, so
// there is no weight shared across a tile to feed a matrix product.
//
// Design (first, simple version): one thread owns one output pixel, in
// 32x8 blocks so that a warp is one row of 32 neighbouring pixels. The
// block stages its (8+F-1) x (32+F-1) input halo for all C channels in
// shared memory once (C=3: 57 KB, dynamic), so device memory is read
// O(HWC) times instead of O(F^2 HWC). The thread keeps its F horizontal
// taps (and, for the gradient, its F gkh sums) in registers; the tap loop
// is unrolled for F <= kFMax so those arrays stay in registers. Both
// kernels keep the rank-1 factorisation of the TPU kernels (the vertical
// tap multiplies once per row k), and both own their pixel, so no atomics
// are needed and the sums are deterministic. Each tap costs one shared
// load per FMA, which caps the rate well below the fp32 peak: register
// blocking across neighbouring pixels is the next step.

#include <cuda_runtime.h>

namespace {

constexpr int kFMax = 51;  // largest filter the unrolled tap loop takes
constexpr int kC = 3;      // channels (RGB frames)
constexpr int kBX = 32;    // block width: one warp is one output row
constexpr int kBY = 8;     // block height

// Stage rows [y0, y0+kBY+f-1) x cols [x0, x0+kBX+f-1) of every channel of
// image n; positions past the input edge (ragged last blocks) read as 0
// and feed only pixels that are never written.
__device__ __forceinline__ void load_tile(float* tile, const float* in_n,
                                          int hp, int wp, int th, int tw,
                                          int y0, int x0) {
  const int tid = threadIdx.y * kBX + threadIdx.x;
  const int plane = th * tw;
  for (int i = tid; i < kC * plane; i += kBX * kBY) {
    const int c = i / plane;
    const int r = (i - c * plane) / tw;
    const int col = i - c * plane - r * tw;
    const int gy = y0 + r, gx = x0 + col;
    tile[i] = (gy < hp && gx < wp)
                  ? in_n[(static_cast<size_t>(c) * hp + gy) * wp + gx]
                  : 0.f;
  }
}

__global__ void __launch_bounds__(kBX * kBY)
sepconv_fwd_kernel(const float* __restrict__ inp, const float* __restrict__ kv,
                   const float* __restrict__ kh, float* __restrict__ out,
                   int h, int w, int f) {
  extern __shared__ float tile[];  // (kC, kBY+f-1, kBX+f-1)
  const int hp = h + f - 1, wp = w + f - 1;
  const int th = kBY + f - 1, tw = kBX + f - 1;
  const int n = blockIdx.z;
  const int y0 = blockIdx.y * kBY, x0 = blockIdx.x * kBX;
  load_tile(tile, inp + static_cast<size_t>(n) * kC * hp * wp, hp, wp, th, tw,
            y0, x0);
  __syncthreads();

  const int y = y0 + threadIdx.y, x = x0 + threadIdx.x;
  if (y >= h || x >= w) return;
  const size_t hw = static_cast<size_t>(h) * w;
  const size_t pix = static_cast<size_t>(y) * w + x;
  const float* kv_p = kv + static_cast<size_t>(n) * f * hw + pix;
  const float* kh_p = kh + static_cast<size_t>(n) * f * hw + pix;

  float khr[kFMax];
#pragma unroll
  for (int l = 0; l < kFMax; ++l) khr[l] = l < f ? kh_p[l * hw] : 0.f;

  float acc[kC];
#pragma unroll
  for (int c = 0; c < kC; ++c) acc[c] = 0.f;

  const int plane = th * tw;
  for (int k = 0; k < f; ++k) {
    const float kvk = kv_p[k * hw];
    const float* row = tile + (threadIdx.y + k) * tw + threadIdx.x;
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const float* rc = row + c * plane;
      float acc_h = 0.f;
#pragma unroll
      for (int l = 0; l < kFMax; ++l) {
        if (l < f) acc_h = fmaf(rc[l], khr[l], acc_h);
      }
      acc[c] = fmaf(acc_h, kvk, acc[c]);
    }
  }

  float* out_p = out + static_cast<size_t>(n) * kC * hw + pix;
#pragma unroll
  for (int c = 0; c < kC; ++c) out_p[c * hw] = acc[c];
}

__global__ void __launch_bounds__(kBX * kBY)
sepconv_grad_kernels_kernel(const float* __restrict__ inp,
                            const float* __restrict__ g,
                            const float* __restrict__ kv,
                            const float* __restrict__ kh,
                            float* __restrict__ gkv, float* __restrict__ gkh,
                            int h, int w, int f) {
  extern __shared__ float tile[];  // (kC, kBY+f-1, kBX+f-1)
  const int hp = h + f - 1, wp = w + f - 1;
  const int th = kBY + f - 1, tw = kBX + f - 1;
  const int n = blockIdx.z;
  const int y0 = blockIdx.y * kBY, x0 = blockIdx.x * kBX;
  load_tile(tile, inp + static_cast<size_t>(n) * kC * hp * wp, hp, wp, th, tw,
            y0, x0);
  __syncthreads();

  const int y = y0 + threadIdx.y, x = x0 + threadIdx.x;
  if (y >= h || x >= w) return;
  const size_t hw = static_cast<size_t>(h) * w;
  const size_t pix = static_cast<size_t>(y) * w + x;
  const size_t map_off = static_cast<size_t>(n) * f * hw + pix;

  float gr[kC];
#pragma unroll
  for (int c = 0; c < kC; ++c)
    gr[c] = g[static_cast<size_t>(n) * kC * hw + c * hw + pix];

  float khr[kFMax], gkh_acc[kFMax];
#pragma unroll
  for (int l = 0; l < kFMax; ++l) {
    khr[l] = l < f ? kh[map_off + l * hw] : 0.f;
    gkh_acc[l] = 0.f;
  }

  const int plane = th * tw;
  for (int k = 0; k < f; ++k) {
    const float kvk = kv[map_off + k * hw];
    const float* row = tile + (threadIdx.y + k) * tw + threadIdx.x;
    float gkv_k = 0.f;
#pragma unroll
    for (int l = 0; l < kFMax; ++l) {
      if (l < f) {
        float gw = 0.f;
#pragma unroll
        for (int c = 0; c < kC; ++c) gw = fmaf(gr[c], row[c * plane + l], gw);
        gkv_k = fmaf(khr[l], gw, gkv_k);
        gkh_acc[l] = fmaf(kvk, gw, gkh_acc[l]);
      }
    }
    gkv[map_off + k * hw] = gkv_k;
  }

#pragma unroll
  for (int l = 0; l < kFMax; ++l) {
    if (l < f) gkh[map_off + l * hw] = gkh_acc[l];
  }
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, int n, int c, int h, int w, int f,
                    dim3* grid, size_t* smem) {
  if (c != kC || f < 1 || f > kFMax || n < 1 || n > 65535 || h < 1 || w < 1)
    return cudaErrorInvalidValue;
  *smem = sizeof(float) * kC * (kBY + f - 1) * (kBX + f - 1);
  *grid = dim3((w + kBX - 1) / kBX, (h + kBY - 1) / kBY, n);
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(*smem));
}

}  // namespace

// Both entry points launch on `stream`, do not synchronise, and return the
// launch status (cudaGetLastError) as an int: 0 is success.
extern "C" int sepconv_forward(const float* inp, const float* kv,
                               const float* kh, float* out, int n, int c,
                               int h, int w, int f, void* stream) {
  dim3 grid;
  size_t smem;
  cudaError_t err = prepare(sepconv_fwd_kernel, n, c, h, w, f, &grid, &smem);
  if (err != cudaSuccess) return err;
  sepconv_fwd_kernel<<<grid, dim3(kBX, kBY), smem,
                       static_cast<cudaStream_t>(stream)>>>(inp, kv, kh, out,
                                                            h, w, f);
  return cudaGetLastError();
}

extern "C" int sepconv_grad_kernels(const float* inp, const float* g,
                                    const float* kv, const float* kh,
                                    float* gkv, float* gkh, int n, int c,
                                    int h, int w, int f, void* stream) {
  dim3 grid;
  size_t smem;
  cudaError_t err =
      prepare(sepconv_grad_kernels_kernel, n, c, h, w, f, &grid, &smem);
  if (err != cudaSuccess) return err;
  sepconv_grad_kernels_kernel<<<grid, dim3(kBX, kBY), smem,
                                static_cast<cudaStream_t>(stream)>>>(
      inp, g, kv, kh, gkv, gkh, h, w, f);
  return cudaGetLastError();
}
