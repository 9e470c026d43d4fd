// Bounded bilinear grid sampler for Hopper (sm_90a): the flow models' fast
// warp, grid in, output (forward), grid gradient (backward) or that
// gradient's derivative (second order) out.
//
// Layouts: img and out (N, C, H, W) float32; grid and ggrid (N, H, W, 2)
// float32 with (gx, gy) last, as F.grid_sample takes them; g (N, C, H, W);
// all contiguous. Per output pixel (n, y, x) and axis (x shown):
//
//   ix = ((gx + 1) W - 1) / 2        ((gx + 1) / 2 (W - 1) with align_corners)
//   border: ix = clamp(ix, 0, W-1);  zeros: valid iff -1 < ix < W (both axes)
//   dx = clamp(ix - x, -R, R-1),  dx0 = floor(dx),  fx = dx - dx0
//   out_c = edge-clamped bilinear tap of img_c at (y + dy0 + fy, x + dx0 + fx)
//   zeros: out_c *= mass = (wy0 my0 + wy1 my1)(wx0 mx0 + wx1 mx1), with
//          wx1 = ix - floor(ix), wx0 = 1 - wx1 and mx0, mx1 the in-image
//          masks of the columns floor(ix) and floor(ix) + 1; 0 where invalid.
//
// The backward is the grid gradient that autograd gives through that
// composition (ops/warp_bounded.py, grid_sample_bounded_ref), by hand:
//
//   g_ix = sum_c g_c [mass cx dbil_c/dfx + bil_c dmass/dix]   (zeros, valid)
//   g_ix = bx cx sum_c g_c dbil_c/dfx                          (border)
//   dbil/dfx = wy0 (v01 - v00) + wy1 (v11 - v10),  dmass/dix = Y (mx1 - mx0)
//   cx = [-R <= ix - x <= R-1] (torch's clamp gradient, inclusive at both
//   ends), bx = [0 <= ix <= W-1], Y = wy0 my0 + wy1 my1; the floors pass no
//   gradient. g_gx = g_ix W / 2 ((W - 1) / 2 with align_corners).
//
// warp_sample_bounded_forward replaces the TPU kernel
// meta_interpolation_tpu/ops/warp_pallas.py:86 (warp_bounded_pallas) with
// the coordinate math that XLA fuses around it
// (meta_interpolation_tpu/ops/warp.py:218-245 and :259-271);
// warp_sample_bounded_grad_grid is the gradient of the whole sampler with
// respect to the grid, which the TPU path gets by autodiff of the XLA sweep
// under its custom VJP (meta_interpolation_tpu/ops/warp.py:299-319), and
// warp_sample_bounded_grad_grid_backward the derivative of that gradient,
// which the TPU path gets by differentiating the XLA backward again. What
// the TPU kernel computes, not how: the Pallas kernel sweeps all (2R+2)^2
// shifted windows with pltpu.roll because a TPU has no cheap gather; the
// floors lie in [-R, R-1], so on Hopper the sweep is one direct 2x2 gather
// a pixel, and R enters only through the clamp.
//
// Rounding: ix, iy, the clamps and the floors are written with __fadd_rn /
// __fsub_rn / __fmul_rn in PyTorch's operation order, so that they are
// bitwise equal to the plain composition's on the card and on the CPU: an
// FMA-contracted ((gx + 1) W - 1) / 2 could flip a floor next to an integer,
// where the output is continuous but its gradient jumps. Only the channel
// sums and the mass products may round otherwise.
//
// Bound on an H100 (N = 1, C = 3, 256x512, the RRIN main path): bytes. The
// forward reads the grid (8 B a pixel) and the image (12 B) and writes the
// output (12 B): 4.19 MB, 1.25 us at 3.35 TB/s; the backward also reads g
// and writes ggrid instead of the output: 40 B a pixel, 5.24 MB, 1.56 us;
// its derivative (second-order meta-training) reads the image, grid, g
// and v and writes gg and ggrid: 60 B a pixel, 7.86 MB, 2.35 us.
// Both do ~40-80 operations a pixel, far from the fp32 rate, and at this
// size a launch's fixed cost is of the bound's order. Design: a 3-D launch
// (column chunk, row, image) with threads along x, no 64-bit division; each
// thread takes kPix pixels of its row, kThreads apart, so that every grid
// load (float2), g load and output store of a warp is one coalesced run;
// all of a thread's grid loads are issued before their use, then all of a
// pixel's taps, with the channel loop unrolled for C = 3. With |flow| <= R
// a warp's taps fall in a band ~2R + 2 rows deep that L1 holds, so taps go
// through the read-only path (__ldg): staging the tile's halo in shared
// memory with cp.async lost to it, and 1 or 4 pixels a thread, 64 or 256
// threads a block and g loaded ahead in the backward did not win (PERF.md).
// The backward recomputes the four taps and keeps its three channel sums
// in registers: no atomics, deterministic.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // threads a block, along x
constexpr int kPix = 2;        // pixels a thread, kThreads apart

// One axis of one pixel: the two clamped tap indices and their weights, and
// what the zero padding and the gradient need.
struct Axis {
  int i0, i1;      // edge-clamped tap indices
  float w0, w1;    // bilinear weights 1 - f, f
  float m;         // zeros: in-image mass w0' m0 + w1' m1 of this axis
  float dm;        // zeros: m1 - m0, the mass's derivative in the coordinate
  float c;         // gradient pass-through of the clamps (0 or 1)
  bool valid;      // zeros: -1 < coordinate < size
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ Axis axis(float g, int pos, int size, int r,
                                     bool align, bool border) {
  const float fsize = static_cast<float>(size);
  const float last = static_cast<float>(size - 1);
  float i = align
      ? __fmul_rn(__fmul_rn(__fadd_rn(g, 1.f), 0.5f), last)
      : __fmul_rn(__fsub_rn(__fmul_rn(__fadd_rn(g, 1.f), fsize), 1.f), 0.5f);
  Axis a;
  float pass = 1.f;
  if (border) {
    pass = (i >= 0.f && i <= last) ? 1.f : 0.f;
    i = fminf(fmaxf(i, 0.f), last);
    a.valid = true;
    a.m = 1.f;
    a.dm = 0.f;
  } else {
    a.valid = i > -1.f && i < fsize;
    const float i0 = floorf(i);
    const float w1 = __fsub_rn(i, i0), w0 = __fsub_rn(1.f, w1);
    const float m0 = (i0 >= 0.f && i0 <= last) ? 1.f : 0.f;
    const float i1 = __fadd_rn(i0, 1.f);
    const float m1 = (i1 >= 0.f && i1 <= last) ? 1.f : 0.f;
    a.m = __fadd_rn(__fmul_rn(w0, m0), __fmul_rn(w1, m1));
    a.dm = m1 - m0;
  }
  // fminf/fmaxf also send a NaN coordinate to -R: every tap stays in range
  const float d = __fsub_rn(i, static_cast<float>(pos));
  a.c = (d >= static_cast<float>(-r) && d <= static_cast<float>(r - 1))
      ? pass : 0.f;
  const float dc = fminf(fmaxf(d, static_cast<float>(-r)),
                         static_cast<float>(r - 1));
  const float d0 = floorf(dc);
  const float f = __fsub_rn(dc, d0);
  const int k = pos + static_cast<int>(d0);
  a.i0 = clampi(k, 0, size - 1);
  a.i1 = clampi(k + 1, 0, size - 1);
  a.w0 = __fsub_rn(1.f, f);
  a.w1 = f;
  return a;
}

// kC: the channel count when it is known at compile time (3, every flow
// model's frames: the channel loop unrolls and all of a pixel's taps are
// issued together), or 0 to take it at run time.
template <int kC>
__global__ void __launch_bounds__(kThreads)
warp_sample_fwd_kernel(const float* __restrict__ img,
                       const float2* __restrict__ grid,
                       float* __restrict__ out, int c, int h, int w, int r,
                       bool align, bool border) {
  const int y = blockIdx.y, b = blockIdx.z;
  const int x_base = blockIdx.x * (kThreads * kPix) + threadIdx.x;
  const int nc = kC > 0 ? kC : c;
  const size_t hw = static_cast<size_t>(h) * w;
  const float2* grow = grid + (static_cast<size_t>(b) * h + y) * w;
  float2 gv[kPix];
#pragma unroll
  for (int p = 0; p < kPix; ++p) {
    const int x = x_base + p * kThreads;
    gv[p] = x < w ? __ldg(grow + x) : make_float2(0.f, 0.f);
  }
  const float* plane = img + static_cast<size_t>(b) * nc * hw;
  float* orow = out + static_cast<size_t>(b) * nc * hw
      + static_cast<size_t>(y) * w;
#pragma unroll
  for (int p = 0; p < kPix; ++p) {
    const int x = x_base + p * kThreads;
    if (x >= w) break;
    const Axis ax = axis(gv[p].x, x, w, r, align, border);
    const Axis ay = axis(gv[p].y, y, h, r, align, border);
    const float scale = border ? 1.f
        : ((ax.valid && ay.valid) ? __fmul_rn(ay.m, ax.m) : 0.f);
    const int o00 = ay.i0 * w + ax.i0, o01 = ay.i0 * w + ax.i1;
    const int o10 = ay.i1 * w + ax.i0, o11 = ay.i1 * w + ax.i1;
    const float* q = plane;
#pragma unroll
    for (int ch = 0; ch < nc; ++ch, q += hw) {
      const float top = fmaf(ax.w0, __ldg(q + o00), ax.w1 * __ldg(q + o01));
      const float bot = fmaf(ax.w0, __ldg(q + o10), ax.w1 * __ldg(q + o11));
      orow[ch * hw + x] = fmaf(ay.w0, top, ay.w1 * bot) * scale;
    }
  }
}

template <int kC>
__global__ void __launch_bounds__(kThreads)
warp_sample_grad_grid_kernel(const float* __restrict__ img,
                             const float2* __restrict__ grid,
                             const float* __restrict__ g,
                             float2* __restrict__ ggrid, int c, int h, int w,
                             int r, bool align, bool border) {
  const int y = blockIdx.y, b = blockIdx.z;
  const int x_base = blockIdx.x * (kThreads * kPix) + threadIdx.x;
  const int nc = kC > 0 ? kC : c;
  const size_t hw = static_cast<size_t>(h) * w;
  const size_t row = (static_cast<size_t>(b) * h + y) * w;
  const float* grow = g + static_cast<size_t>(b) * nc * hw
      + static_cast<size_t>(y) * w;
  float2 gv[kPix];
#pragma unroll
  for (int p = 0; p < kPix; ++p) {
    const int x = x_base + p * kThreads;
    gv[p] = x < w ? __ldg(grid + row + x) : make_float2(0.f, 0.f);
  }
  const float* plane = img + static_cast<size_t>(b) * nc * hw;
  // g_coordinate = g_grid * s: W / 2, or (W - 1) / 2 with align_corners
  const float sx = 0.5f * static_cast<float>(align ? w - 1 : w);
  const float sy = 0.5f * static_cast<float>(align ? h - 1 : h);
#pragma unroll
  for (int p = 0; p < kPix; ++p) {
    const int x = x_base + p * kThreads;
    if (x >= w) break;
    const Axis ax = axis(gv[p].x, x, w, r, align, border);
    const Axis ay = axis(gv[p].y, y, h, r, align, border);
    const int o00 = ay.i0 * w + ax.i0, o01 = ay.i0 * w + ax.i1;
    const int o10 = ay.i1 * w + ax.i0, o11 = ay.i1 * w + ax.i1;
    // sums over channels of g times dbil/dfx, dbil/dfy and bil
    float sdx = 0.f, sdy = 0.f, sb = 0.f;
    const float* q = plane;
#pragma unroll
    for (int ch = 0; ch < nc; ++ch, q += hw) {
      const float v00 = __ldg(q + o00), v01 = __ldg(q + o01);
      const float v10 = __ldg(q + o10), v11 = __ldg(q + o11);
      const float gc = __ldg(grow + ch * hw + x);
      const float top = fmaf(ax.w0, v00, ax.w1 * v01);
      const float bot = fmaf(ax.w0, v10, ax.w1 * v11);
      sdx = fmaf(gc, fmaf(ay.w0, v01 - v00, ay.w1 * (v11 - v10)), sdx);
      sdy = fmaf(gc, bot - top, sdy);
      sb = fmaf(gc, fmaf(ay.w0, top, ay.w1 * bot), sb);
    }
    float gx, gy;
    if (border) {
      gx = ax.c * sdx;
      gy = ay.c * sdy;
    } else if (ax.valid && ay.valid) {
      const float mass = ay.m * ax.m;
      gx = fmaf(mass * ax.c, sdx, ay.m * ax.dm * sb);
      gy = fmaf(mass * ay.c, sdy, ax.m * ay.dm * sb);
    } else {
      gx = gy = 0.f;
    }
    ggrid[row + x] = make_float2(gx * sx, gy * sy);
  }
}

// The derivative of the grid gradient, given the cotangent v (N, H, W, 2)
// of its output: gg_c = sum_k v_k dout_c/dgrid_k, the cotangent of g, and
// ggrid_k = sum_j v_j d(g_grid_j)/dgrid_k, the grid's second-order
// cotangent. With u = (vx sx, vy sy) and the sums over channels
// S_x = sum_c g_c dbil_c/dfx, S_y = sum_c g_c dbil_c/dfy, S_b = sum_c g_c
// bil_c and S_xy = sum_c g_c (v11 - v10 - v01 + v00) (= d2 bil/dfx dfy):
//
//   border: gg_c = ux cx dbil_c/dfx + uy cy dbil_c/dfy;
//           ggrid = (sx uy Hxy, sy ux Hxy), Hxy = cx cy S_xy: bil is linear
//           in fx and in fy, so only the cross term is left.
//   zeros (valid): out = bil mass with mass = Y X, each factor linear in its
//           coordinate (dX/dix = dmx), so
//           gg_c = ux Y (X cx dbil_c/dfx + dmx bil_c)
//                + uy X (Y cy dbil_c/dfy + dmy bil_c)
//           Hxx = 2 Y dmx cx S_x,  Hyy = 2 X dmy cy S_y,
//           Hxy = dmy X cx S_x + X Y cx cy S_xy + dmx dmy S_b + Y dmx cy S_y,
//           ggrid = (sx (ux Hxx + uy Hxy), sy (ux Hxy + uy Hyy));
//           0 where the sample is invalid.
//
// The clamps pass cx, cy as in the first derivative; the floors and masks
// pass nothing. This is what autograd gives through
// grid_sample_bounded_grad_grid_ref (ops/warp_bounded.py), its plain
// version. One thread a pixel and the same taps as the grad kernel; g is
// read once a channel, gg written once.
template <int kC>
__global__ void __launch_bounds__(kThreads)
warp_sample_grad_grid_backward_kernel(const float* __restrict__ img,
                                      const float2* __restrict__ grid,
                                      const float* __restrict__ g,
                                      const float2* __restrict__ v,
                                      float* __restrict__ gg,
                                      float2* __restrict__ ggrid, int c,
                                      int h, int w, int r, bool align,
                                      bool border) {
  const int y = blockIdx.y, b = blockIdx.z;
  const int x_base = blockIdx.x * (kThreads * kPix) + threadIdx.x;
  const int nc = kC > 0 ? kC : c;
  const size_t hw = static_cast<size_t>(h) * w;
  const size_t row = (static_cast<size_t>(b) * h + y) * w;
  const size_t crow = static_cast<size_t>(b) * nc * hw
      + static_cast<size_t>(y) * w;
  float2 gv[kPix], vv[kPix];
#pragma unroll
  for (int p = 0; p < kPix; ++p) {
    const int x = x_base + p * kThreads;
    gv[p] = x < w ? __ldg(grid + row + x) : make_float2(0.f, 0.f);
    vv[p] = x < w ? __ldg(v + row + x) : make_float2(0.f, 0.f);
  }
  const float* plane = img + static_cast<size_t>(b) * nc * hw;
  const float sx = 0.5f * static_cast<float>(align ? w - 1 : w);
  const float sy = 0.5f * static_cast<float>(align ? h - 1 : h);
#pragma unroll
  for (int p = 0; p < kPix; ++p) {
    const int x = x_base + p * kThreads;
    if (x >= w) break;
    const Axis ax = axis(gv[p].x, x, w, r, align, border);
    const Axis ay = axis(gv[p].y, y, h, r, align, border);
    const bool live = border || (ax.valid && ay.valid);
    const float ux = vv[p].x * sx, uy = vv[p].y * sy;
    // per channel, gg_c = ax_d dbil/dfx + ay_d dbil/dfy + b_d bil
    float ax_d, ay_d, b_d;
    if (border) {
      ax_d = ux * ax.c;
      ay_d = uy * ay.c;
      b_d = 0.f;
    } else if (live) {
      ax_d = ux * ay.m * ax.m * ax.c;
      ay_d = uy * ax.m * ay.m * ay.c;
      b_d = ux * ay.m * ax.dm + uy * ax.m * ay.dm;
    } else {
      ax_d = ay_d = b_d = 0.f;
    }
    const int o00 = ay.i0 * w + ax.i0, o01 = ay.i0 * w + ax.i1;
    const int o10 = ay.i1 * w + ax.i0, o11 = ay.i1 * w + ax.i1;
    float sdx = 0.f, sdy = 0.f, sb = 0.f, sxy = 0.f;
    const float* q = plane;
#pragma unroll
    for (int ch = 0; ch < nc; ++ch, q += hw) {
      const float v00 = __ldg(q + o00), v01 = __ldg(q + o01);
      const float v10 = __ldg(q + o10), v11 = __ldg(q + o11);
      const float gc = __ldg(g + crow + ch * hw + x);
      const float top = fmaf(ax.w0, v00, ax.w1 * v01);
      const float bot = fmaf(ax.w0, v10, ax.w1 * v11);
      const float dbx = fmaf(ay.w0, v01 - v00, ay.w1 * (v11 - v10));
      const float dby = bot - top;
      const float bil = fmaf(ay.w0, top, ay.w1 * bot);
      sdx = fmaf(gc, dbx, sdx);
      sdy = fmaf(gc, dby, sdy);
      sb = fmaf(gc, bil, sb);
      sxy = fmaf(gc, (v11 - v10) - (v01 - v00), sxy);
      gg[crow + ch * hw + x] = fmaf(ax_d, dbx, fmaf(ay_d, dby, b_d * bil));
    }
    float gx, gy;
    if (border) {
      const float hxy = ax.c * ay.c * sxy;
      gx = sx * (uy * hxy);
      gy = sy * (ux * hxy);
    } else if (live) {
      const float hxx = 2.f * ay.m * ax.dm * ax.c * sdx;
      const float hyy = 2.f * ax.m * ay.dm * ay.c * sdy;
      const float hxy = ay.dm * ax.m * ax.c * sdx
          + ax.m * ay.m * ax.c * ay.c * sxy + ax.dm * ay.dm * sb
          + ay.m * ax.dm * ay.c * sdy;
      gx = sx * fmaf(ux, hxx, uy * hxy);
      gy = sy * fmaf(ux, hxy, uy * hyy);
    } else {
      gx = gy = 0.f;
    }
    ggrid[row + x] = make_float2(gx, gy);
  }
}

cudaError_t grid_for(int n, int c, int h, int w, int r, dim3* grid) {
  if (n < 1 || c < 1 || h < 1 || w < 1 || r < 1 || n > 65535 || h > 65535)
    return cudaErrorInvalidValue;
  if (static_cast<long long>(h) * w > 0x7fffffffLL)
    return cudaErrorInvalidValue;  // tap offsets within a plane are int
  *grid = dim3((w + kThreads * kPix - 1) / (kThreads * kPix), h, n);
  return cudaSuccess;
}

}  // namespace

// Both entry points launch on `stream`, do not synchronise, and return the
// launch status (cudaGetLastError) as an int: 0 is success. border: 1 for
// padding_mode 'border', 0 for 'zeros'.
extern "C" int warp_sample_bounded_forward(const float* img, const float* grid,
                                           float* out, int n, int c, int h,
                                           int w, int r, int align_corners,
                                           int border, void* stream) {
  dim3 blocks;
  cudaError_t err = grid_for(n, c, h, w, r, &blocks);
  if (err != cudaSuccess) return err;
  (c == 3 ? warp_sample_fwd_kernel<3> : warp_sample_fwd_kernel<0>)
      <<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      img, reinterpret_cast<const float2*>(grid), out, c, h, w, r,
      align_corners != 0, border != 0);
  return cudaGetLastError();
}

extern "C" int warp_sample_bounded_grad_grid(const float* img,
                                             const float* grid,
                                             const float* g, float* ggrid,
                                             int n, int c, int h, int w,
                                             int r, int align_corners,
                                             int border, void* stream) {
  dim3 blocks;
  cudaError_t err = grid_for(n, c, h, w, r, &blocks);
  if (err != cudaSuccess) return err;
  (c == 3 ? warp_sample_grad_grid_kernel<3>
          : warp_sample_grad_grid_kernel<0>)
      <<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      img, reinterpret_cast<const float2*>(grid), g,
      reinterpret_cast<float2*>(ggrid), c, h, w, r, align_corners != 0,
      border != 0);
  return cudaGetLastError();
}

extern "C" int warp_sample_bounded_grad_grid_backward(
    const float* img, const float* grid, const float* g, const float* v,
    float* gg, float* ggrid, int n, int c, int h, int w, int r,
    int align_corners, int border, void* stream) {
  dim3 blocks;
  cudaError_t err = grid_for(n, c, h, w, r, &blocks);
  if (err != cudaSuccess) return err;
  (c == 3 ? warp_sample_grad_grid_backward_kernel<3>
          : warp_sample_grad_grid_backward_kernel<0>)
      <<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      img, reinterpret_cast<const float2*>(grid), g,
      reinterpret_cast<const float2*>(v), gg,
      reinterpret_cast<float2*>(ggrid), c, h, w, r, align_corners != 0,
      border != 0);
  return cudaGetLastError();
}
