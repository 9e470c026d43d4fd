// Bounded bilinear grid sampler for Hopper (sm_90a): the flow models' fast
// warp, grid in, output (forward), grid gradient (backward) or that
// gradient's derivative (second order) out.
//
// Layouts: img and out (N, C, H, W) float32; grid and ggrid (N, H, W, 2)
// float32 with (gx, gy) last, as F.grid_sample takes them; g (N, C, H, W);
// all contiguous. The forward and the grid gradient also take img, out and
// g in bfloat16 (the _bf16 entry points, --dtype bfloat16); the grid and
// its gradient stay float32, as the TPU path keeps its coordinate math in
// f32 (meta_interpolation_tpu/ops/warp.py:33-37). In bf16 the kernels
// widen every image and g value to float, sum in float32, and round where
// the TPU path rounds: the fractions fx, fy to bf16 before the taps
// (ops/warp.py:242-243), the tap sum once (warp_pallas.py:99-103: the
// kernel runs in f32 and is cast back), and with zeros padding the mass to
// bf16 and the product to bf16 (ops/warp.py:270). The gradient uses the
// same rounded fractions and sums in float32. The float32 instantiations
// round nothing. Per output pixel (n, y, x) and axis (x shown):
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
// Row bands (the row-sharded evaluation and training, --spatial_shards): the
// float32 K3, K3-grad and K3-grad² also take a band of output rows, the
// _band entry points. The grid, output and gradients hold the band's h_out
// rows, and output row y measures its displacement from image row row0 + y
// of the whole image, which every rank holds. The image's H stays in the
// clamp and the zero padding, so a band's rows are the whole-frame call's
// rows bit for bit. The bf16 tile kernels have no band form.
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
// and v and writes gg and ggrid: 60 B a pixel, 7.86 MB, 2.35 us (in bf16,
// image, g and gg at 2 B a value: 42 B a pixel, 5.5 MB, 1.64 us).
// All do ~40-160 operations a pixel, far from the fp32 rate, and at this
// size a launch's fixed cost is of the bound's order.
//
// K3-grad² replaces none of the JAX package's Pallas kernels: the TPU path
// gets this derivative by differentiating its XLA backward again
// (meta_interpolation_tpu/ops/warp.py:275, :299-319), from the upcast
// values in bf16 (:33-37). In float32 it is the gather kernel below; in
// bf16 (the _bf16 entry point) the tile kernel, which gives the bits of
// the float32 kernel on the widened operands with gg rounded once, and
// past C = 4 or a window over 227 KB of shared memory the wrapper widens
// the call onto the float32 kernel.
//
// The float32 design (K3, K3-grad, K3-grad², and the gather route of the
// bf16 K3 and K3-grad): a 3-D launch (column chunk, row, image) with
// threads along x, no 64-bit division; each thread takes kPix pixels of
// its row, kThreads apart, so that every grid load (float2), g load and
// output store of a warp is one coalesced run; all of a thread's grid
// loads are issued before their use, then all of a pixel's taps, with the
// channel loop unrolled for C = 3. With |flow| <= R a warp's taps fall in
// a band ~2R + 2 rows deep that L1 holds, so taps go through the
// read-only path (__ldg): for these float32 kernels, staging the tile's
// halo in shared memory lost to it (K3 and K3-grad: planar, by cp.async;
// K3-grad²: the bf16 tile design below with 16- or 12-byte float texels,
// faster on random displacements and at 8 images, slower on the smooth
// ones a flow network gives), and 1 or 4 pixels a thread, 64 or 256
// threads a block and g loaded ahead in the backward did not win
// (PERF.md). The backward recomputes the four taps and keeps its three
// channel sums in registers: no atomics, deterministic.
//
// The bf16 design (K3, K3-grad and K3-grad² in bf16, the tile route):
// there the float32 design issues 12 (K3-grad 15) dependent 2-byte
// gathers a pixel, and their count and latency, not bytes, set its pace;
// K3-grad²'s bf16 route before this kernel also widened the operands and
// rounded gg in three device ops of their own. A block owns a 16 x 32
// tile and stages its tap window, the tile grown by R on every side and
// clipped to the image, once, with 16-byte loads, as channel-interleaved
// 8-byte texels (c0, c1, c2, c3 or 0) in shared memory: a tap is one
// 8-byte shared load for all channels. A thread takes two adjacent
// pixels: grid, v and grid gradient as float4, output, g and gg as bf16
// pairs. The window is sized from R at launch; past C = 4 (a texel's
// channels) or 227 KB of shared memory (R > 72 on a large frame) the
// wrapper takes the gather route (ops/warp_bounded.py, bf16_window). Both
// routes give the same bits. Tiles of 8 x 64, 32 x 32, 16 x 16, 32 x 16,
// 16 x 64, 8 x 32 and 4 x 64, 4 pixels a thread, the window copied by
// cp.async then interleaved, and K3-grad²'s g loaded before the window
// was staged, were slower (PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>
#include <type_traits>

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

// An image value of the storage type, widened to float (read-only path).
__device__ __forceinline__ float ld(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// kBf16: the fraction is rounded to bf16 before it weights the taps.
template <bool kBf16>
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
  float f = __fsub_rn(dc, d0);
  if constexpr (kBf16) f = round_bf16(f);
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
// T: the image's storage type, float or __nv_bfloat16.
// A band (row0, h_out): the grid, out (and g, ggrid below) hold h_out rows,
// output row y being image row row0 + y; the image keeps its h rows for the
// taps, the edge clamp and the zero padding. The whole frame is row0 = 0,
// h_out = h, with the same arithmetic.
template <int kC, typename T>
__global__ void __launch_bounds__(kThreads)
warp_sample_fwd_kernel(const T* __restrict__ img,
                       const float2* __restrict__ grid,
                       T* __restrict__ out, int c, int h, int w, int row0,
                       int h_out, int r, bool align, bool border) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  const int y = blockIdx.y, b = blockIdx.z;
  const int x_base = blockIdx.x * (kThreads * kPix) + threadIdx.x;
  const int nc = kC > 0 ? kC : c;
  const size_t hw = static_cast<size_t>(h) * w;
  const size_t ohw = static_cast<size_t>(h_out) * w;
  const float2* grow = grid + (static_cast<size_t>(b) * h_out + y) * w;
  float2 gv[kPix];
#pragma unroll
  for (int p = 0; p < kPix; ++p) {
    const int x = x_base + p * kThreads;
    gv[p] = x < w ? __ldg(grow + x) : make_float2(0.f, 0.f);
  }
  const T* plane = img + static_cast<size_t>(b) * nc * hw;
  T* orow = out + static_cast<size_t>(b) * nc * ohw
      + static_cast<size_t>(y) * w;
#pragma unroll
  for (int p = 0; p < kPix; ++p) {
    const int x = x_base + p * kThreads;
    if (x >= w) break;
    const Axis ax = axis<kBf16>(gv[p].x, x, w, r, align, border);
    const Axis ay = axis<kBf16>(gv[p].y, row0 + y, h, r, align, border);
    const float scale = border ? 1.f
        : ((ax.valid && ay.valid) ? __fmul_rn(ay.m, ax.m) : 0.f);
    const int o00 = ay.i0 * w + ax.i0, o01 = ay.i0 * w + ax.i1;
    const int o10 = ay.i1 * w + ax.i0, o11 = ay.i1 * w + ax.i1;
    const T* q = plane;
#pragma unroll
    for (int ch = 0; ch < nc; ++ch, q += hw) {
      const float top = fmaf(ax.w0, ld(q + o00), ax.w1 * ld(q + o01));
      const float bot = fmaf(ax.w0, ld(q + o10), ax.w1 * ld(q + o11));
      const float bil = fmaf(ay.w0, top, ay.w1 * bot);
      if constexpr (kBf16) {
        // the sum rounded, then times the mass rounded, rounded
        orow[ch * ohw + x] = __float2bfloat16_rn(
            border ? bil : round_bf16(bil) * round_bf16(scale));
      } else {
        orow[ch * ohw + x] = bil * scale;
      }
    }
  }
}

template <int kC, typename T>
__global__ void __launch_bounds__(kThreads)
warp_sample_grad_grid_kernel(const T* __restrict__ img,
                             const float2* __restrict__ grid,
                             const T* __restrict__ g,
                             float2* __restrict__ ggrid, int c, int h, int w,
                             int row0, int h_out, int r, bool align,
                             bool border) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  const int y = blockIdx.y, b = blockIdx.z;
  const int x_base = blockIdx.x * (kThreads * kPix) + threadIdx.x;
  const int nc = kC > 0 ? kC : c;
  const size_t hw = static_cast<size_t>(h) * w;
  const size_t ohw = static_cast<size_t>(h_out) * w;
  const size_t row = (static_cast<size_t>(b) * h_out + y) * w;
  const T* grow = g + static_cast<size_t>(b) * nc * ohw
      + static_cast<size_t>(y) * w;
  float2 gv[kPix];
#pragma unroll
  for (int p = 0; p < kPix; ++p) {
    const int x = x_base + p * kThreads;
    gv[p] = x < w ? __ldg(grid + row + x) : make_float2(0.f, 0.f);
  }
  const T* plane = img + static_cast<size_t>(b) * nc * hw;
  // g_coordinate = g_grid * s: W / 2, or (W - 1) / 2 with align_corners
  const float sx = 0.5f * static_cast<float>(align ? w - 1 : w);
  const float sy = 0.5f * static_cast<float>(align ? h - 1 : h);
#pragma unroll
  for (int p = 0; p < kPix; ++p) {
    const int x = x_base + p * kThreads;
    if (x >= w) break;
    const Axis ax = axis<kBf16>(gv[p].x, x, w, r, align, border);
    const Axis ay = axis<kBf16>(gv[p].y, row0 + y, h, r, align, border);
    const int o00 = ay.i0 * w + ax.i0, o01 = ay.i0 * w + ax.i1;
    const int o10 = ay.i1 * w + ax.i0, o11 = ay.i1 * w + ax.i1;
    // sums over channels of g times dbil/dfx, dbil/dfy and bil
    float sdx = 0.f, sdy = 0.f, sb = 0.f;
    const T* q = plane;
#pragma unroll
    for (int ch = 0; ch < nc; ++ch, q += hw) {
      const float v00 = ld(q + o00), v01 = ld(q + o01);
      const float v10 = ld(q + o10), v11 = ld(q + o11);
      const float gc = ld(grow + ch * ohw + x);
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
// read once a channel, gg written once. A band (row0, h_out) as the grad
// kernel's: the grid, g, v, gg and ggrid hold h_out rows.
template <int kC>
__global__ void __launch_bounds__(kThreads)
warp_sample_grad_grid_backward_kernel(const float* __restrict__ img,
                                      const float2* __restrict__ grid,
                                      const float* __restrict__ g,
                                      const float2* __restrict__ v,
                                      float* __restrict__ gg,
                                      float2* __restrict__ ggrid, int c,
                                      int h, int w, int row0, int h_out,
                                      int r, bool align, bool border) {
  const int y = blockIdx.y, b = blockIdx.z;
  const int x_base = blockIdx.x * (kThreads * kPix) + threadIdx.x;
  const int nc = kC > 0 ? kC : c;
  const size_t hw = static_cast<size_t>(h) * w;
  const size_t ohw = static_cast<size_t>(h_out) * w;
  const size_t row = (static_cast<size_t>(b) * h_out + y) * w;
  const size_t crow = static_cast<size_t>(b) * nc * ohw
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
    const Axis ax = axis<false>(gv[p].x, x, w, r, align, border);
    const Axis ay = axis<false>(gv[p].y, row0 + y, h, r, align, border);
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
      const float gc = __ldg(g + crow + ch * ohw + x);
      const float top = fmaf(ax.w0, v00, ax.w1 * v01);
      const float bot = fmaf(ax.w0, v10, ax.w1 * v11);
      const float dbx = fmaf(ay.w0, v01 - v00, ay.w1 * (v11 - v10));
      const float dby = bot - top;
      const float bil = fmaf(ay.w0, top, ay.w1 * bot);
      sdx = fmaf(gc, dbx, sdx);
      sdy = fmaf(gc, dby, sdy);
      sb = fmaf(gc, bil, sb);
      sxy = fmaf(gc, (v11 - v10) - (v01 - v00), sxy);
      gg[crow + ch * ohw + x] = fmaf(ax_d, dbx, fmaf(ay_d, dby, b_d * bil));
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

// ---------------------------------------------------------------------------
// The bf16 K3, K3-grad and K3-grad²: a block's output tile and its tap
// window staged in shared memory as channel-interleaved texels.
//
// A block owns kTileH x kTileW output pixels of one image. The floors lie
// in [-R, R-1] (a NaN coordinate goes to -R) and the taps are edge-clamped,
// so every tap of the tile lies in rows [y0 - R, y0 + kTileH - 1 + R] and
// columns [x0 - R, x0 + kTileW - 1 + R], clipped to the image. The block
// copies that window from the channel planes once, 8 columns at a time
// (16-byte loads of the aligned chunks that cover them, shifted where a
// row does not start on a chunk), and stores it as 8-byte texels (c0, c1,
// c2, c3 or 0): a tap is then one 8-byte shared load for every channel.
// A thread takes kPairs pairs of horizontally adjacent pixels: their grid
// as one float4, their outputs as bf16 pairs, their g as bf16 pairs and
// their grid gradients as one float4 (scalar where a pair is not aligned
// or straddles the edge). The arithmetic is the gather kernels', in the
// same order, so the two give the same bits.
constexpr int kTileH = 16;       // output rows a block
constexpr int kTileW = 32;       // output columns a block
constexpr int kPairs = 1;        // pixel pairs a thread, side by side
constexpr int kTileThreads = kTileH * kTileW / (2 * kPairs);
constexpr int kTexelC = 4;       // channels a texel holds
constexpr int kMaxWindowBytes = 232448;  // shared memory a block, sm_90

using bf16 = __nv_bfloat16;

// The values before p in its 16-byte chunk.
__device__ __forceinline__ int misalignment(const bf16* p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) & 15) >> 1);
}

// Values s .. s + 7 of the 16 bf16 values of (lo, hi), s in [0, 8).
__device__ __forceinline__ uint4 shift8(uint4 lo, uint4 hi, int s) {
  uint32_t v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  if (s & 4) {
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = i + 2 < 8 ? v[i + 2] : 0u;
  }
  if (s & 2) {
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = i + 1 < 8 ? v[i + 1] : 0u;
  }
  if (s & 1) {
#pragma unroll
    for (int i = 0; i < 7; ++i) v[i] = __funnelshift_r(v[i], v[i + 1], 16);
  }
  return make_uint4(v[0], v[1], v[2], v[3]);
}

// The 8 bf16 values at p, of which the first `valid` (>= 1) are read
// (the rest are what the covering chunks hold); p need not be aligned.
// Only the aligned chunks that hold a valid value are loaded.
__device__ __forceinline__ uint4 load8(const bf16* p, int valid) {
  const int s = misalignment(p);
  const uint4* base = reinterpret_cast<const uint4*>(p - s);
  const uint4 lo = __ldg(base);
  if (s == 0) return lo;
  const uint4 hi = s + valid > 8 ? __ldg(base + 1) : make_uint4(0, 0, 0, 0);
  return shift8(lo, hi, s);
}

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : (i == 1 ? v.y : (i == 2 ? v.z : v.w));
}

// A block's window: its first row and column in the image, its rows and
// columns, and its row pitch in texels (the same for every block).
struct Window {
  int r0, c0, rows, cols, pitch;
};

__device__ __forceinline__ Window block_window(int h, int w, int r,
                                               int pitch) {
  const int y0 = blockIdx.y * kTileH, x0 = blockIdx.x * kTileW;
  Window win;
  win.r0 = max(y0 - r, 0);
  win.c0 = max(x0 - r, 0);
  win.rows = static_cast<int>(min(static_cast<long long>(y0) + kTileH - 1 + r,
                                  static_cast<long long>(h - 1))) - win.r0 + 1;
  win.cols = static_cast<int>(min(static_cast<long long>(x0) + kTileW - 1 + r,
                                  static_cast<long long>(w - 1))) - win.c0 + 1;
  win.pitch = pitch;
  return win;
}

// Copy the window of the nc (<= kTexelC) planes at `plane` into `texels`,
// (rows, pitch) texels of 8 bytes: one work item a row and 8 columns, the
// texels written two at a time (16 bytes).
__device__ __forceinline__ void stage_window(uint4* texels, const bf16* plane,
                                             int nc, int w, size_t hw,
                                             const Window& win) {
  const int chunks = (win.cols + 7) >> 3;
  for (int i = threadIdx.x; i < win.rows * chunks; i += kTileThreads) {
    const int row = i / chunks, k = i - row * chunks;
    const int valid = win.cols - 8 * k;
    const bf16* p = plane + static_cast<size_t>(win.r0 + row) * w + win.c0
        + 8 * k;
    uint4 v[kTexelC];
#pragma unroll
    for (int ch = 0; ch < kTexelC; ++ch) {
      v[ch] = ch < nc ? load8(p + ch * hw, valid) : make_uint4(0, 0, 0, 0);
    }
    uint4* dst = texels + (row * win.pitch + 8 * k) / 2;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const uint32_t a = word(v[0], m), b = word(v[1], m);
      const uint32_t c = word(v[2], m), d = word(v[3], m);
      dst[m] = make_uint4(__byte_perm(a, b, 0x5410), __byte_perm(c, d, 0x5410),
                          __byte_perm(a, b, 0x7632),
                          __byte_perm(c, d, 0x7632));
    }
  }
}

// The kTexelC channels of the texel at (row, col) of the image, widened.
__device__ __forceinline__ void texel(const uint2* texels, const Window& win,
                                      int row, int col,
                                      float (&v)[kTexelC]) {
  const uint2 t = texels[(row - win.r0) * win.pitch + (col - win.c0)];
  v[0] = __uint_as_float(t.x << 16);
  v[1] = __uint_as_float(t.x & 0xffff0000u);
  v[2] = __uint_as_float(t.y << 16);
  v[3] = __uint_as_float(t.y & 0xffff0000u);
}

// The grid of pixels x and x + 1 of a row (x + 1 only if inside).
__device__ __forceinline__ void load_pair(const float2* p, int x, int w,
                                          float2 (&gv)[2]) {
  if (x + 1 < w && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    gv[0] = make_float2(q.x, q.y);
    gv[1] = make_float2(q.z, q.w);
  } else {
    gv[0] = x < w ? __ldg(p) : make_float2(0.f, 0.f);
    gv[1] = x + 1 < w ? __ldg(p + 1) : make_float2(0.f, 0.f);
  }
}

// The bf16 values of pixels x and x + 1 (x + 1 only if inside; else 0) of
// the nc (<= kTexelC) channel planes, hw apart, from p (pixel x of plane
// 0), widened: a pair as one load where it is aligned.
__device__ __forceinline__ void load_pairs(const bf16* p, int x, int w,
                                           size_t hw, int nc,
                                           float (&v)[2][kTexelC]) {
#pragma unroll
  for (int ch = 0; ch < kTexelC; ++ch) {
    v[0][ch] = v[1][ch] = 0.f;
    if (ch >= nc) continue;
    const bf16* q = p + ch * hw;
    if (x + 1 < w && (reinterpret_cast<uintptr_t>(q) & 3) == 0) {
      const float2 t = __bfloat1622float2(
          __ldg(reinterpret_cast<const __nv_bfloat162*>(q)));
      v[0][ch] = t.x;
      v[1][ch] = t.y;
    } else {
      v[0][ch] = __bfloat162float(__ldg(q));
      if (x + 1 < w) v[1][ch] = __bfloat162float(__ldg(q + 1));
    }
  }
}

// Store pixels x and x + 1 (x + 1 only if inside) of the nc channel
// planes, hw apart, at p (pixel x of plane 0), each rounded once to bf16:
// a pair as one store where it is aligned.
__device__ __forceinline__ void store_pairs(bf16* p, int x, int w, size_t hw,
                                            int nc,
                                            const float (&v)[2][kTexelC]) {
#pragma unroll
  for (int ch = 0; ch < kTexelC; ++ch) {
    if (ch >= nc) break;
    bf16* q = p + ch * hw;
    const bf16 a = __float2bfloat16_rn(v[0][ch]);
    if (x + 1 < w && (reinterpret_cast<uintptr_t>(q) & 3) == 0) {
      *reinterpret_cast<__nv_bfloat162*>(q) =
          __halves2bfloat162(a, __float2bfloat16_rn(v[1][ch]));
    } else {
      q[0] = a;
      if (x + 1 < w) q[1] = __float2bfloat16_rn(v[1][ch]);
    }
  }
}

// Store the (gx, gy) of pixels x and x + 1 (x + 1 only if inside) at o.
__device__ __forceinline__ void store_pair(float2* o, int x, int w,
                                           const float2 (&v)[2]) {
  if (x + 1 < w && (reinterpret_cast<uintptr_t>(o) & 15) == 0) {
    *reinterpret_cast<float4*>(o) = make_float4(v[0].x, v[0].y, v[1].x,
                                                v[1].y);
  } else {
    o[0] = v[0];
    if (x + 1 < w) o[1] = v[1];
  }
}

// A thread's pixel pairs: (y, x) of the first pixel of pair q.
__device__ __forceinline__ int pair_y(int q) {
  return blockIdx.y * kTileH + (threadIdx.x * kPairs + q) / (kTileW / 2);
}
__device__ __forceinline__ int pair_x(int q) {
  return blockIdx.x * kTileW + 2 * ((threadIdx.x * kPairs + q) % (kTileW / 2));
}

template <int kC>
__global__ void __launch_bounds__(kTileThreads)
warp_fwd_bf16_tile_kernel(const bf16* __restrict__ img,
                          const float2* __restrict__ grid,
                          bf16* __restrict__ out, int c, int h, int w, int r,
                          int pitch, bool align, bool border) {
  extern __shared__ uint4 texels[];
  const int b = blockIdx.z;
  const int nc = kC > 0 ? kC : c;
  const size_t hw = static_cast<size_t>(h) * w;
  float2 gv[kPairs][2];
#pragma unroll
  for (int q = 0; q < kPairs; ++q) {
    const int y = pair_y(q), x = pair_x(q);
    if (y < h) {
      load_pair(grid + (static_cast<size_t>(b) * h + y) * w + x, x, w, gv[q]);
    }
  }
  const Window win = block_window(h, w, r, pitch);
  const bf16* plane = img + static_cast<size_t>(b) * nc * hw;
  stage_window(texels, plane, nc, w, hw, win);
  __syncthreads();
  const uint2* tx = reinterpret_cast<const uint2*>(texels);
#pragma unroll
  for (int q = 0; q < kPairs; ++q) {
    const int y = pair_y(q), x = pair_x(q);
    if (y >= h || x >= w) continue;
    bf16 res[2][kTexelC];
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      if (x + p >= w) break;
      const Axis ax = axis<true>(gv[q][p].x, x + p, w, r, align, border);
      const Axis ay = axis<true>(gv[q][p].y, y, h, r, align, border);
      const float scale = border ? 1.f
          : ((ax.valid && ay.valid) ? __fmul_rn(ay.m, ax.m) : 0.f);
      float v00[kTexelC], v01[kTexelC], v10[kTexelC], v11[kTexelC];
      texel(tx, win, ay.i0, ax.i0, v00);
      texel(tx, win, ay.i0, ax.i1, v01);
      texel(tx, win, ay.i1, ax.i0, v10);
      texel(tx, win, ay.i1, ax.i1, v11);
#pragma unroll
      for (int ch = 0; ch < kTexelC; ++ch) {
        if (ch >= nc) break;
        const float top = fmaf(ax.w0, v00[ch], ax.w1 * v01[ch]);
        const float bot = fmaf(ax.w0, v10[ch], ax.w1 * v11[ch]);
        const float bil = fmaf(ay.w0, top, ay.w1 * bot);
        // the sum rounded, then times the mass rounded, rounded
        res[p][ch] = __float2bfloat16_rn(
            border ? bil : round_bf16(bil) * round_bf16(scale));
      }
    }
    bf16* o = out + static_cast<size_t>(b) * nc * hw
        + static_cast<size_t>(y) * w + x;
#pragma unroll
    for (int ch = 0; ch < kTexelC; ++ch) {
      if (ch >= nc) break;
      if (x + 1 < w && (reinterpret_cast<uintptr_t>(o + ch * hw) & 3) == 0) {
        *reinterpret_cast<__nv_bfloat162*>(o + ch * hw) =
            __halves2bfloat162(res[0][ch], res[1][ch]);
      } else {
        o[ch * hw] = res[0][ch];
        if (x + 1 < w) o[ch * hw + 1] = res[1][ch];
      }
    }
  }
}

template <int kC>
__global__ void __launch_bounds__(kTileThreads)
warp_grad_grid_bf16_tile_kernel(const bf16* __restrict__ img,
                                const float2* __restrict__ grid,
                                const bf16* __restrict__ g,
                                float2* __restrict__ ggrid, int c, int h,
                                int w, int r, int pitch, bool align,
                                bool border) {
  extern __shared__ uint4 texels[];
  const int b = blockIdx.z;
  const int nc = kC > 0 ? kC : c;
  const size_t hw = static_cast<size_t>(h) * w;
  float2 gv[kPairs][2];
#pragma unroll
  for (int q = 0; q < kPairs; ++q) {
    const int y = pair_y(q), x = pair_x(q);
    if (y < h) {
      load_pair(grid + (static_cast<size_t>(b) * h + y) * w + x, x, w, gv[q]);
    }
  }
  const Window win = block_window(h, w, r, pitch);
  const bf16* plane = img + static_cast<size_t>(b) * nc * hw;
  stage_window(texels, plane, nc, w, hw, win);
  __syncthreads();
  const uint2* tx = reinterpret_cast<const uint2*>(texels);
  // g_coordinate = g_grid * s: W / 2, or (W - 1) / 2 with align_corners
  const float sx = 0.5f * static_cast<float>(align ? w - 1 : w);
  const float sy = 0.5f * static_cast<float>(align ? h - 1 : h);
#pragma unroll
  for (int q = 0; q < kPairs; ++q) {
    const int y = pair_y(q), x = pair_x(q);
    if (y >= h || x >= w) continue;
    const size_t row = (static_cast<size_t>(b) * h + y) * w + x;
    // the pair's g, channel by channel
    float gc[2][kTexelC];
    load_pairs(g + static_cast<size_t>(b) * nc * hw
                   + static_cast<size_t>(y) * w + x, x, w, hw, nc, gc);
    float2 res[2];
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      if (x + p >= w) break;
      const Axis ax = axis<true>(gv[q][p].x, x + p, w, r, align, border);
      const Axis ay = axis<true>(gv[q][p].y, y, h, r, align, border);
      float v00[kTexelC], v01[kTexelC], v10[kTexelC], v11[kTexelC];
      texel(tx, win, ay.i0, ax.i0, v00);
      texel(tx, win, ay.i0, ax.i1, v01);
      texel(tx, win, ay.i1, ax.i0, v10);
      texel(tx, win, ay.i1, ax.i1, v11);
      // sums over channels of g times dbil/dfx, dbil/dfy and bil
      float sdx = 0.f, sdy = 0.f, sb = 0.f;
#pragma unroll
      for (int ch = 0; ch < kTexelC; ++ch) {
        if (ch >= nc) break;
        const float top = fmaf(ax.w0, v00[ch], ax.w1 * v01[ch]);
        const float bot = fmaf(ax.w0, v10[ch], ax.w1 * v11[ch]);
        sdx = fmaf(gc[p][ch],
                   fmaf(ay.w0, v01[ch] - v00[ch], ay.w1 * (v11[ch] - v10[ch])),
                   sdx);
        sdy = fmaf(gc[p][ch], bot - top, sdy);
        sb = fmaf(gc[p][ch], fmaf(ay.w0, top, ay.w1 * bot), sb);
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
      res[p] = make_float2(gx * sx, gy * sy);
    }
    store_pair(ggrid + row, x, w, res);
  }
}

// ---------------------------------------------------------------------------
// K3-grad² in bf16 (image, g and gg bf16; grid, v and the grid's cotangent
// float32): the tile, window and pixel pairs of the bf16 K3 and K3-grad.
// A thread loads its pair's grid and v as one float4 each and g as a bf16
// pair a channel, and stores gg as a bf16 pair a channel and the grid's
// cotangent as one float4. The arithmetic is the float32 kernel's
// (warp_sample_grad_grid_backward_kernel), in the same order with the same
// fmaf chains, on the widened values with unrounded fractions (the TPU
// path differentiates this from the upcast values,
// meta_interpolation_tpu/ops/warp.py:33-37), and gg is rounded once: the
// bits of the float32 kernel on the widened operands, gg rounded.
template <int kC>
__global__ void __launch_bounds__(kTileThreads)
warp_grad_grid_backward_bf16_tile_kernel(const bf16* __restrict__ img,
                                         const float2* __restrict__ grid,
                                         const bf16* __restrict__ g,
                                         const float2* __restrict__ v,
                                         bf16* __restrict__ gg,
                                         float2* __restrict__ ggrid, int c,
                                         int h, int w, int r, int pitch,
                                         bool align, bool border) {
  extern __shared__ uint4 texels[];
  const int b = blockIdx.z;
  const int nc = kC > 0 ? kC : c;
  const size_t hw = static_cast<size_t>(h) * w;
  float2 gv[kPairs][2], vv[kPairs][2];
#pragma unroll
  for (int q = 0; q < kPairs; ++q) {
    const int y = pair_y(q), x = pair_x(q);
    if (y < h) {
      const size_t row = (static_cast<size_t>(b) * h + y) * w + x;
      load_pair(grid + row, x, w, gv[q]);
      load_pair(v + row, x, w, vv[q]);
    }
  }
  const Window win = block_window(h, w, r, pitch);
  stage_window(texels, img + static_cast<size_t>(b) * nc * hw, nc, w, hw,
               win);
  __syncthreads();
  const uint2* tx = reinterpret_cast<const uint2*>(texels);
  const float sx = 0.5f * static_cast<float>(align ? w - 1 : w);
  const float sy = 0.5f * static_cast<float>(align ? h - 1 : h);
#pragma unroll
  for (int q = 0; q < kPairs; ++q) {
    const int y = pair_y(q), x = pair_x(q);
    if (y >= h || x >= w) continue;
    const size_t crow = static_cast<size_t>(b) * nc * hw
        + static_cast<size_t>(y) * w + x;
    float gc[2][kTexelC], res[2][kTexelC];
    float2 out[2];
    load_pairs(g + crow, x, w, hw, nc, gc);
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      if (x + p >= w) break;
      const Axis ax = axis<false>(gv[q][p].x, x + p, w, r, align, border);
      const Axis ay = axis<false>(gv[q][p].y, y, h, r, align, border);
      const bool live = border || (ax.valid && ay.valid);
      const float ux = vv[q][p].x * sx, uy = vv[q][p].y * sy;
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
      float v00[kTexelC], v01[kTexelC], v10[kTexelC], v11[kTexelC];
      texel(tx, win, ay.i0, ax.i0, v00);
      texel(tx, win, ay.i0, ax.i1, v01);
      texel(tx, win, ay.i1, ax.i0, v10);
      texel(tx, win, ay.i1, ax.i1, v11);
      float sdx = 0.f, sdy = 0.f, sb = 0.f, sxy = 0.f;
#pragma unroll
      for (int ch = 0; ch < kTexelC; ++ch) {
        if (ch >= nc) break;
        const float gch = gc[p][ch];
        const float top = fmaf(ax.w0, v00[ch], ax.w1 * v01[ch]);
        const float bot = fmaf(ax.w0, v10[ch], ax.w1 * v11[ch]);
        const float dbx = fmaf(ay.w0, v01[ch] - v00[ch],
                               ay.w1 * (v11[ch] - v10[ch]));
        const float dby = bot - top;
        const float bil = fmaf(ay.w0, top, ay.w1 * bot);
        sdx = fmaf(gch, dbx, sdx);
        sdy = fmaf(gch, dby, sdy);
        sb = fmaf(gch, bil, sb);
        sxy = fmaf(gch, (v11[ch] - v10[ch]) - (v01[ch] - v00[ch]), sxy);
        res[p][ch] = fmaf(ax_d, dbx, fmaf(ay_d, dby, b_d * bil));
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
      out[p] = make_float2(gx, gy);
    }
    store_pairs(gg + crow, x, w, hw, nc, res);
    store_pair(ggrid + (static_cast<size_t>(b) * h + y) * w + x, x, w, out);
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

// The launch of a band of h_out output rows from image row row0: the
// whole-frame grid_for over h_out rows, the band inside the image.
cudaError_t band_grid_for(int n, int c, int h, int w, int row0, int h_out,
                          int r, dim3* grid) {
  if (row0 < 0 || h_out < 1 || h_out > h - row0) return cudaErrorInvalidValue;
  cudaError_t err = grid_for(n, c, h, w, r, grid);
  grid->y = h_out;
  return err;
}

template <typename T>
int forward(const T* img, const float* grid, T* out, int n, int c, int h,
            int w, int row0, int h_out, int r, int align_corners, int border,
            void* stream) {
  dim3 blocks;
  cudaError_t err = band_grid_for(n, c, h, w, row0, h_out, r, &blocks);
  if (err != cudaSuccess) return err;
  (c == 3 ? warp_sample_fwd_kernel<3, T> : warp_sample_fwd_kernel<0, T>)
      <<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      img, reinterpret_cast<const float2*>(grid), out, c, h, w, row0, h_out,
      r, align_corners != 0, border != 0);
  return cudaGetLastError();
}

template <typename T>
int grad_grid(const T* img, const float* grid, const T* g, float* ggrid,
              int n, int c, int h, int w, int row0, int h_out, int r,
              int align_corners, int border, void* stream) {
  dim3 blocks;
  cudaError_t err = band_grid_for(n, c, h, w, row0, h_out, r, &blocks);
  if (err != cudaSuccess) return err;
  (c == 3 ? warp_sample_grad_grid_kernel<3, T>
          : warp_sample_grad_grid_kernel<0, T>)
      <<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      img, reinterpret_cast<const float2*>(grid), g,
      reinterpret_cast<float2*>(ggrid), c, h, w, row0, h_out, r,
      align_corners != 0, border != 0);
  return cudaGetLastError();
}

int grad_grid_backward(const float* img, const float* grid, const float* g,
                       const float* v, float* gg, float* ggrid, int n, int c,
                       int h, int w, int row0, int h_out, int r,
                       int align_corners, int border, void* stream) {
  dim3 blocks;
  cudaError_t err = band_grid_for(n, c, h, w, row0, h_out, r, &blocks);
  if (err != cudaSuccess) return err;
  (c == 3 ? warp_sample_grad_grid_backward_kernel<3>
          : warp_sample_grad_grid_backward_kernel<0>)
      <<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      img, reinterpret_cast<const float2*>(grid), g,
      reinterpret_cast<const float2*>(v), gg,
      reinterpret_cast<float2*>(ggrid), c, h, w, row0, h_out, r,
      align_corners != 0, border != 0);
  return cudaGetLastError();
}

// The bf16 tile kernels' launch: blocks, the window's row pitch in texels
// and its shared memory, the most any block's window takes: min(kTileH +
// 2R, H) rows of min(kTileW + 2R, W) texels, the pitch rounded up to whole
// chunks of 8. C > kTexelC, or a window past kMaxWindowBytes, is refused:
// the wrapper sends those to the gather kernels (ops/warp_bounded.py,
// bf16_window, computes the same).
struct TileLaunch {
  dim3 blocks;
  int pitch;
  size_t smem;
};

template <typename Kernel>
cudaError_t tile_launch(Kernel kernel, int n, int c, int h, int w, int r,
                        TileLaunch* launch) {
  dim3 unused;
  cudaError_t err = grid_for(n, c, h, w, r, &unused);
  if (err != cudaSuccess) return err;
  const long long rows = std::min<long long>(kTileH + 2LL * r, h);
  const long long cols = std::min<long long>(kTileW + 2LL * r, w);
  const long long pitch = (cols + 7) / 8 * 8;
  const long long bytes = rows * pitch * 8;
  if (c > kTexelC || bytes > kMaxWindowBytes) return cudaErrorInvalidValue;
  launch->blocks = dim3((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH,
                        n);
  launch->pitch = static_cast<int>(pitch);
  launch->smem = static_cast<size_t>(bytes);
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

int forward_tile(const bf16* img, const float* grid, bf16* out, int n, int c,
                 int h, int w, int r, int align_corners, int border,
                 void* stream) {
  const auto kernel = c == 3 ? warp_fwd_bf16_tile_kernel<3>
                             : warp_fwd_bf16_tile_kernel<0>;
  TileLaunch l;
  cudaError_t err = tile_launch(kernel, n, c, h, w, r, &l);
  if (err != cudaSuccess) return err;
  kernel<<<l.blocks, kTileThreads, l.smem,
           static_cast<cudaStream_t>(stream)>>>(
      img, reinterpret_cast<const float2*>(grid), out, c, h, w, r, l.pitch,
      align_corners != 0, border != 0);
  return cudaGetLastError();
}

int grad_grid_tile(const bf16* img, const float* grid, const bf16* g,
                   float* ggrid, int n, int c, int h, int w, int r,
                   int align_corners, int border, void* stream) {
  const auto kernel = c == 3 ? warp_grad_grid_bf16_tile_kernel<3>
                             : warp_grad_grid_bf16_tile_kernel<0>;
  TileLaunch l;
  cudaError_t err = tile_launch(kernel, n, c, h, w, r, &l);
  if (err != cudaSuccess) return err;
  kernel<<<l.blocks, kTileThreads, l.smem,
           static_cast<cudaStream_t>(stream)>>>(
      img, reinterpret_cast<const float2*>(grid), g,
      reinterpret_cast<float2*>(ggrid), c, h, w, r, l.pitch,
      align_corners != 0, border != 0);
  return cudaGetLastError();
}

int grad_grid_backward_tile(const bf16* img, const float* grid,
                            const bf16* g, const float* v, bf16* gg,
                            float* ggrid, int n, int c, int h, int w, int r,
                            int align_corners, int border, void* stream) {
  const auto kernel = c == 3 ? warp_grad_grid_backward_bf16_tile_kernel<3>
                             : warp_grad_grid_backward_bf16_tile_kernel<0>;
  TileLaunch l;
  cudaError_t err = tile_launch(kernel, n, c, h, w, r, &l);
  if (err != cudaSuccess) return err;
  kernel<<<l.blocks, kTileThreads, l.smem,
           static_cast<cudaStream_t>(stream)>>>(
      img, reinterpret_cast<const float2*>(grid), g,
      reinterpret_cast<const float2*>(v), gg,
      reinterpret_cast<float2*>(ggrid), c, h, w, r, l.pitch,
      align_corners != 0, border != 0);
  return cudaGetLastError();
}

}  // namespace

// The entry points launch on `stream`, do not synchronise, and return the
// launch status (cudaGetLastError) as an int: 0 is success. border: 1 for
// padding_mode 'border', 0 for 'zeros'. The _bf16 ones take img, out, g
// and gg in bfloat16, the grid, v and ggrid in float32: the _bf16 ones run
// the tile kernels, for C <= 4 and a window that fits (tile_launch; else
// they return cudaErrorInvalidValue), the _bf16_gather ones the gather
// kernels, for any C and R.
extern "C" int warp_sample_bounded_forward(const float* img, const float* grid,
                                           float* out, int n, int c, int h,
                                           int w, int r, int align_corners,
                                           int border, void* stream) {
  return forward(img, grid, out, n, c, h, w, 0, h, r, align_corners, border,
                 stream);
}

// The float32 K3 and K3-grad on a band: out, the grid, g and ggrid hold
// h_out rows, output row y sampling around image row row0 + y of the
// (N, C, H, W) image (0 <= row0, row0 + h_out <= H); H stays the image's for
// the clamp and the zero padding. row0 = 0, h_out = H is the whole-frame
// call, bit for bit; a band's rows are the whole-frame call's same rows.
extern "C" int warp_sample_bounded_forward_band(
    const float* img, const float* grid, float* out, int n, int c, int h,
    int w, int row0, int h_out, int r, int align_corners, int border,
    void* stream) {
  return forward(img, grid, out, n, c, h, w, row0, h_out, r, align_corners,
                 border, stream);
}

extern "C" int warp_sample_bounded_grad_grid_band(
    const float* img, const float* grid, const float* g, float* ggrid, int n,
    int c, int h, int w, int row0, int h_out, int r, int align_corners,
    int border, void* stream) {
  return grad_grid(img, grid, g, ggrid, n, c, h, w, row0, h_out, r,
                   align_corners, border, stream);
}

extern "C" int warp_sample_bounded_forward_bf16(
    const __nv_bfloat16* img, const float* grid, __nv_bfloat16* out, int n,
    int c, int h, int w, int r, int align_corners, int border,
    void* stream) {
  return forward_tile(img, grid, out, n, c, h, w, r, align_corners, border,
                      stream);
}

extern "C" int warp_sample_bounded_forward_bf16_gather(
    const __nv_bfloat16* img, const float* grid, __nv_bfloat16* out, int n,
    int c, int h, int w, int r, int align_corners, int border,
    void* stream) {
  return forward(img, grid, out, n, c, h, w, 0, h, r, align_corners, border,
                 stream);
}

extern "C" int warp_sample_bounded_grad_grid(const float* img,
                                             const float* grid,
                                             const float* g, float* ggrid,
                                             int n, int c, int h, int w,
                                             int r, int align_corners,
                                             int border, void* stream) {
  return grad_grid(img, grid, g, ggrid, n, c, h, w, 0, h, r, align_corners,
                   border, stream);
}

extern "C" int warp_sample_bounded_grad_grid_bf16(
    const __nv_bfloat16* img, const float* grid, const __nv_bfloat16* g,
    float* ggrid, int n, int c, int h, int w, int r, int align_corners,
    int border, void* stream) {
  return grad_grid_tile(img, grid, g, ggrid, n, c, h, w, r, align_corners,
                        border, stream);
}

extern "C" int warp_sample_bounded_grad_grid_bf16_gather(
    const __nv_bfloat16* img, const float* grid, const __nv_bfloat16* g,
    float* ggrid, int n, int c, int h, int w, int r, int align_corners,
    int border, void* stream) {
  return grad_grid(img, grid, g, ggrid, n, c, h, w, 0, h, r, align_corners,
                   border, stream);
}

extern "C" int warp_sample_bounded_grad_grid_backward(
    const float* img, const float* grid, const float* g, const float* v,
    float* gg, float* ggrid, int n, int c, int h, int w, int r,
    int align_corners, int border, void* stream) {
  return grad_grid_backward(img, grid, g, v, gg, ggrid, n, c, h, w, 0, h, r,
                            align_corners, border, stream);
}

// The float32 K3-grad² on a band, as K3-grad's band entry: the grid, g, v,
// gg and ggrid hold h_out rows from image row row0; row0 = 0, h_out = H is
// the whole-frame call, bit for bit.
extern "C" int warp_sample_bounded_grad_grid_backward_band(
    const float* img, const float* grid, const float* g, const float* v,
    float* gg, float* ggrid, int n, int c, int h, int w, int row0, int h_out,
    int r, int align_corners, int border, void* stream) {
  return grad_grid_backward(img, grid, g, v, gg, ggrid, n, c, h, w, row0,
                            h_out, r, align_corners, border, stream);
}

extern "C" int warp_sample_bounded_grad_grid_backward_bf16(
    const __nv_bfloat16* img, const float* grid, const __nv_bfloat16* g,
    const float* v, __nv_bfloat16* gg, float* ggrid, int n, int c, int h,
    int w, int r, int align_corners, int border, void* stream) {
  return grad_grid_backward_tile(img, grid, g, v, gg, ggrid, n, c, h, w, r,
                                 align_corners, border, stream);
}
