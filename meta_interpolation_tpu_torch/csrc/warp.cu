// Bounded bilinear warp for Hopper (sm_90a): the accumulation of the flow
// models' fast warp.
//
//   out(n, c, y, x) = sum_{d, e in [-R, R+1]} wy_d * wx_e * img_edge(n, c, y+d, x+e)
//   wy_d = [dy0 == d] (1 - fy) + [dy0 == d-1] fy          (wx_e likewise)
//
// Layouts: img and out (N, C, H, W) float32; dy0/dx0 int32 and fy/fx float32
// (N, H, W); all contiguous. img_edge clamps rows to [0, H-1] and columns to
// [0, W-1].
//
// warp_bounded_forward replaces the TPU kernel
// meta_interpolation_tpu/ops/warp_pallas.py:86 (warp_bounded_pallas /
// _warp_kernel). warp_bounded_grad_frac is the gradient with respect to fy
// and fx, which the TPU path gets by autodiff of the XLA sweep
// (meta_interpolation_tpu/ops/warp.py:305-319):
//   gfy = sum_c g_c [my1 (wx0 v10 + wx1 v11) - my0 (wx0 v00 + wx1 v01)]
//   gfx = sum_c g_c [mx1 (wy0 v01 + wy1 v11) - mx0 (wy0 v00 + wy1 v10)]
//
// Contract (the caller's, as in the JAX package: ops/warp.py clips before
// it calls): dy0, dx0 in [-R, R-1]. Then only d = dy0 and d = dy0+1 carry
// weight, and the sum is one edge-clamped bilinear 2x2 tap at
// (y+dy0+fy, x+dx0+fx). The kernels compute exactly that: what the TPU
// kernel computes, not how. The Pallas kernel sweeps all (2R+2)^2 shifted
// windows with pltpu.roll because a TPU has no cheap gather; on Hopper a
// direct 4-tap gather per pixel is the natural form. R enters only through
// the window masks my0/my1/mx0/mx1 (1 where the tap's shift lies in
// [-R, R+1]), so that the kernels equal the sweep even outside the contract.
// None of the Mosaic constraints carry over (W % 128, H % 8, halos, column
// pads): one thread owns one output pixel, the grid is 1-D over N*H*W, and
// the last block masks its own ragged edge.
//
// Bound on an H100 (N=1, C=3, 256x512, the RRIN main path): bytes. The
// forward moves ~40 B a pixel (four 4-byte index/fraction planes, C=3 image
// reads that mostly hit L1/L2, C=3 writes), ~5.2 MB, ~1.6 us at 3.35 TB/s;
// it does ~30 operations a pixel, nowhere near the fp32 rate. The gradient
// adds C=3 reads of g and writes two planes instead of C. At this size launch
// overhead dominates both: that is recorded, not fixed, here. Each thread
// owns its pixel, so the channel sums are deterministic and need no atomics.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

struct Taps {
  size_t o00, o01, o10, o11;  // offsets of the four taps in one (H, W) plane
  float my0, my1, mx0, mx1;   // 1 where the tap's shift lies in [-R, R+1]
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ float in_window(int d, int r) {
  return (d >= -r && d <= r + 1) ? 1.f : 0.f;
}

__device__ __forceinline__ Taps taps(int y, int x, int dy, int dx, int h,
                                     int w, int r) {
  const int y0 = clampi(y + dy, 0, h - 1), y1 = clampi(y + dy + 1, 0, h - 1);
  const int x0 = clampi(x + dx, 0, w - 1), x1 = clampi(x + dx + 1, 0, w - 1);
  Taps t;
  t.o00 = static_cast<size_t>(y0) * w + x0;
  t.o01 = static_cast<size_t>(y0) * w + x1;
  t.o10 = static_cast<size_t>(y1) * w + x0;
  t.o11 = static_cast<size_t>(y1) * w + x1;
  t.my0 = in_window(dy, r);
  t.my1 = in_window(dy + 1, r);
  t.mx0 = in_window(dx, r);
  t.mx1 = in_window(dx + 1, r);
  return t;
}

__global__ void __launch_bounds__(kThreads)
warp_bounded_fwd_kernel(const float* __restrict__ img,
                        const int* __restrict__ dy0,
                        const int* __restrict__ dx0,
                        const float* __restrict__ fy,
                        const float* __restrict__ fx,
                        float* __restrict__ out, int n, int c, int h, int w,
                        int r) {
  const size_t hw = static_cast<size_t>(h) * w;
  const size_t idx = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= static_cast<size_t>(n) * hw) return;
  const int b = static_cast<int>(idx / hw);
  const size_t pix = idx - b * hw;
  const int y = static_cast<int>(pix / w), x = static_cast<int>(pix % w);
  const Taps t = taps(y, x, dy0[idx], dx0[idx], h, w, r);
  const float fyv = fy[idx], fxv = fx[idx];
  const float wy0 = t.my0 * (1.f - fyv), wy1 = t.my1 * fyv;
  const float wx0 = t.mx0 * (1.f - fxv), wx1 = t.mx1 * fxv;
  const float* p = img + static_cast<size_t>(b) * c * hw;
  float* o = out + static_cast<size_t>(b) * c * hw + pix;
  for (int ch = 0; ch < c; ++ch, p += hw) {
    const float top = fmaf(wx0, __ldg(p + t.o00), wx1 * __ldg(p + t.o01));
    const float bot = fmaf(wx0, __ldg(p + t.o10), wx1 * __ldg(p + t.o11));
    o[ch * hw] = fmaf(wy0, top, wy1 * bot);
  }
}

__global__ void __launch_bounds__(kThreads)
warp_bounded_grad_frac_kernel(const float* __restrict__ img,
                              const int* __restrict__ dy0,
                              const int* __restrict__ dx0,
                              const float* __restrict__ fy,
                              const float* __restrict__ fx,
                              const float* __restrict__ g,
                              float* __restrict__ gfy,
                              float* __restrict__ gfx, int n, int c, int h,
                              int w, int r) {
  const size_t hw = static_cast<size_t>(h) * w;
  const size_t idx = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= static_cast<size_t>(n) * hw) return;
  const int b = static_cast<int>(idx / hw);
  const size_t pix = idx - b * hw;
  const int y = static_cast<int>(pix / w), x = static_cast<int>(pix % w);
  const Taps t = taps(y, x, dy0[idx], dx0[idx], h, w, r);
  const float fyv = fy[idx], fxv = fx[idx];
  const float wy0 = t.my0 * (1.f - fyv), wy1 = t.my1 * fyv;
  const float wx0 = t.mx0 * (1.f - fxv), wx1 = t.mx1 * fxv;
  const float* p = img + static_cast<size_t>(b) * c * hw;
  const float* gp = g + static_cast<size_t>(b) * c * hw + pix;
  float sy = 0.f, sx = 0.f;
  for (int ch = 0; ch < c; ++ch, p += hw) {
    const float v00 = __ldg(p + t.o00), v01 = __ldg(p + t.o01);
    const float v10 = __ldg(p + t.o10), v11 = __ldg(p + t.o11);
    const float gc = __ldg(gp + ch * hw);
    const float dy = t.my1 * fmaf(wx0, v10, wx1 * v11)
                     - t.my0 * fmaf(wx0, v00, wx1 * v01);
    const float dx = t.mx1 * fmaf(wy0, v01, wy1 * v11)
                     - t.mx0 * fmaf(wy0, v00, wy1 * v10);
    sy = fmaf(gc, dy, sy);
    sx = fmaf(gc, dx, sx);
  }
  gfy[idx] = sy;
  gfx[idx] = sx;
}

cudaError_t grid_for(int n, int c, int h, int w, int r, dim3* grid) {
  if (n < 1 || c < 1 || h < 1 || w < 1 || r < 1)
    return cudaErrorInvalidValue;
  const size_t total = static_cast<size_t>(n) * h * w;
  const size_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffu) return cudaErrorInvalidValue;
  *grid = dim3(static_cast<unsigned>(blocks));
  return cudaSuccess;
}

}  // namespace

// Both entry points launch on `stream`, do not synchronise, and return the
// launch status (cudaGetLastError) as an int: 0 is success.
extern "C" int warp_bounded_forward(const float* img, const int* dy0,
                                    const int* dx0, const float* fy,
                                    const float* fx, float* out, int n, int c,
                                    int h, int w, int r, void* stream) {
  dim3 grid;
  cudaError_t err = grid_for(n, c, h, w, r, &grid);
  if (err != cudaSuccess) return err;
  warp_bounded_fwd_kernel<<<grid, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      img, dy0, dx0, fy, fx, out, n, c, h, w, r);
  return cudaGetLastError();
}

extern "C" int warp_bounded_grad_frac(const float* img, const int* dy0,
                                      const int* dx0, const float* fy,
                                      const float* fx, const float* g,
                                      float* gfy, float* gfx, int n, int c,
                                      int h, int w, int r, void* stream) {
  dim3 grid;
  cudaError_t err = grid_for(n, c, h, w, r, &grid);
  if (err != cudaSuccess) return err;
  warp_bounded_grad_frac_kernel<<<grid, kThreads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      img, dy0, dx0, fy, fx, g, gfy, gfx, n, c, h, w, r);
  return cudaGetLastError();
}
