// Adaptive separable convolution for Hopper (sm_90a): the SepConv hot op.
//
//   out(n, c, y, x) = sum_k sum_l in(n, c, y+k, x+l) * kv(n, k, y, x) * kh(n, l, y, x)
//
// Layouts are the model's natural NCHW: in (N, C, H+F-1, W+F-1), kv/kh
// (N, F, H, W), out (N, C, H, W), all contiguous and of one storage type:
// float32, or bfloat16 (--dtype bfloat16). Both kernels are templates on
// that type T. A bf16 value is widened to float where it is read (the
// halo as it is staged, the taps and g as they are loaded), every sum runs
// in float32 in the same order as for float32, and each output is rounded
// once to bf16 (round to nearest even) where it is stored. So the bf16
// instantiation gives, bit for bit, the float32 kernel's result on the
// widened inputs, rounded: what the TPU kernels do for bf16
// (meta_interpolation_tpu/ops/sepconv.py:139-143, :237-241 upcast, run in
// f32 and cast back). The float32 instantiation converts nothing.
// A bf16 call moves half the bytes; the operation count is the same.
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
// What bounds them on an H100 at the SepConv shape (N=1, C=3, F=51, maps
// 384x512): fp32 operations outside the tensor cores. The forward does
// F(F+1)C = 7956 FMA a pixel (3.1 GFLOP against ~85 MB moved, ~47 us at
// 67 TFLOP/s, SXM data sheet); the gradient F^2(C+2) = 13005 FMA a pixel
// (5.1 GFLOP against ~166 MB, ~76 us). Neither fits the tensor cores:
// every pixel has its own 51x51 filter, so a matrix product over a tile
// would mostly compute products outside each pixel's band.
//
// So the limit is the SM's issue rate and its shared-memory rate. An SM
// issues 4 warp instructions a clock (128 fp32 FMA lanes) but serves one
// shared-memory wavefront (32 words) a clock, so a design with one shared
// load per FMA reaches at most a quarter of the fp32 rate. Both kernels
// block registers across neighbouring pixels instead:
//
// - A thread holds a strip of P vertically adjacent pixels of one column.
//   Pixel j of the strip uses staged row r at vertical tap k = r - j, at
//   the same horizontal tap l, so one shared load of in(c, r, x+l) feeds P
//   pixels. A row outside a pixel's band [j, j+F) is masked, which costs
//   (P-1)/(F+P-1) of the work; the rows inside every pixel's band (all but
//   2(P-1)) run without masks.
// - The taps of a pixel column are split across S = 2 neighbouring lanes,
//   which take alternate taps (l = s mod 2): each lane holds 26 of the 51
//   taps of each pixel in registers. A warp's 16 lane pairs read 17
//   consecutive words a load, so there are no bank conflicts.
// - Every index into a tap array is a compile-time constant (the tap loop
//   is unrolled over the lane's 26 taps, a tap past F has weight 0), so
//   the arrays stay in registers. The staged tile is kTW = 68 columns
//   wide, zero past the F-1 halo columns, so the unpredicated 26th tap
//   reads a zero.
// - A block stages its input halo once, with cp.async (zero-fill form at
//   the ragged edge), while the threads load their taps from device
//   memory. Channels 0 and 1 are staged as pairs, so a tap takes one
//   64-bit and one 32-bit shared load.
// - The vertical taps of the next row are loaded a row ahead, at a
//   running offset that also addresses gkv.
// - Each thread owns its outputs: no atomics, and the sums are
//   deterministic. Threads outside the map run to the end with zero taps,
//   so every lane's shuffle partner is active; only the stores are masked.
//
// sepconv_fwd_kernel: P = 4, S = 2. A 128-thread block (4 warps of 16
// columns, one strip each) covers a 16x16 pixel tile; halo (16+50) x 68 x
// 3 floats = 52.6 KiB. Per lane and (row, tap): 2 shared loads feed 12
// FMAs. Each row's horizontal sums u_j(c) are folded with kv_j(r-j) at
// once, so the two lanes' outputs are summed by one shuffle at the end.
// 168 registers, no spill: 3 blocks (12 warps) an SM by registers (shared
// memory would allow 4), 768 blocks at 384x512 maps, 1.94 waves over the
// 396 slots of 132 SMs.
//
// sepconv_grad_kernels_kernel: P = 2, S = 2, the fused form of the TPU
// kernel. A 128-thread block covers a 16x8 pixel tile; halo (8+50) x 68 x
// 3 floats = 46.2 KiB. Per lane and (row, tap): 2 shared loads feed 10 FP
// operations (gw, then gkv and gkh). A warp's tap then takes 3 clocks of
// the SM's shared pipe (3 wavefronts) and 3 of its issue slots (12
// instructions over 4 schedulers): both pipes are equally loaded, and
// neither runs full. Each lane holds kh and the gkh sums only for its own
// taps, so gkh needs no combination; each row's gkv is the sum of the two
// lanes' partials, one shuffle, stored by one lane.
// 168 registers, no spill: 3 blocks an SM, 1,536 blocks, 3.88 waves.
//
// Times on the card, and the designs tried: PERF.md, section 6.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kFMax = 51;   // largest filter the unrolled tap loops take
constexpr int kC = 3;       // channels (RGB frames)
constexpr int kS = 2;       // lanes a pixel column, on alternate taps
constexpr int kNT = (kFMax + kS - 1) / kS;  // taps a lane holds: 26
constexpr int kTileW = 16;  // pixel columns a block: a warp's 16 lane pairs
constexpr int kTW = kTileW + kS * kNT;      // staged width: 68
constexpr int kWarps = 4;   // warps a block, one strip row each
constexpr int kThreads = 32 * kWarps;
constexpr int kP1 = 4;  // forward: pixels a strip, so 16x16 tiles
constexpr int kP2 = 2;  // gradient: pixels a strip, so 16x8 tiles
constexpr int kRows1 = kP1 * kWarps;  // pixel rows a block
constexpr int kRows2 = kP2 * kWarps;
constexpr unsigned kFull = 0xffffffffu;

// A value of the storage type, widened to float through the read-only path.
__device__ __forceinline__ float ld(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}
// A float sum stored in the storage type, rounded to nearest even.
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Start the copy of rows [y0, y0+th) x cols [x0, x0+kTW) of every channel
// of image n into tile: channels 0 and 1 as pairs, (th, kTW, 2), so that
// one 64-bit load reads both, then channel 2, (th, kTW). Columns past the
// halo (col >= kTileW + f - 1) and positions past the input edge read as
// 0: they meet only taps of weight 0 or pixels that are never written.
// float32 copies with cp.async; bf16 is widened by the threads, a plain
// load and a float store each, since cp.async copies bytes unchanged.
template <typename T>
__device__ __forceinline__ void stage(float* tile, const T* in_n, int hp,
                                      int wp, int th, int f, int y0, int x0) {
  const int plane = th * kTW;
  const int halo_w = kTileW + f - 1;
  for (int c = 0; c < kC; ++c) {
    const T* in_c = in_n + static_cast<size_t>(c) * hp * wp;
    for (int i = threadIdx.x; i < plane; i += kThreads) {
      const int r = i / kTW, col = i - r * kTW;
      const int gy = y0 + r, gx = x0 + col;
      const bool valid = col < halo_w && gy < hp && gx < wp;
      float* dst = c < 2 ? tile + 2 * i + c : tile + 2 * plane + i;
      if constexpr (std::is_same<T, float>::value) {
        cp_async4(dst, valid ? in_c + static_cast<size_t>(gy) * wp + gx : in_c,
                  valid);
      } else {
        *dst = valid ? ld(in_c + static_cast<size_t>(gy) * wp + gx) : 0.f;
      }
    }
  }
}

// The vertical taps of row r for the strip's pixels: kv_j(r - j), or 0
// outside pixel j's band or the map. kv_r points at plane r of pixel 0;
// plane r - j of pixel j is dj = w - h*w further (a row down, j planes up).
template <int kP, typename T>
__device__ __forceinline__ void load_kv(const T* kv_r, long long dj,
                                        int r, int f,
                                        const bool (&in_map)[kP],
                                        float (&wv)[kP]) {
#pragma unroll
  for (int j = 0; j < kP; ++j) {
    const bool band = static_cast<unsigned>(r - j) < static_cast<unsigned>(f);
    wv[j] = in_map[j] && band ? ld(kv_r + j * dj) : 0.f;
  }
}

// One staged row of the forward: each pixel's horizontal sums over this
// lane's taps, folded at once with its vertical tap. t points at the row's
// channel pair at the lane's first tap, t2 at its channel 2. kMasked: a
// pixel of the strip lies outside its band on this row, and band says
// which.
template <bool kMasked>
__device__ __forceinline__ void fwd_row(const float* t, const float* t2,
                                        const float (&khr)[kP1][kNT],
                                        const float (&wv)[kP1],
                                        const bool (&band)[kP1],
                                        float (&acc)[kP1][kC]) {
  float u[kP1][kC] = {};
#pragma unroll
  for (int i = 0; i < kNT; ++i) {
    const float2 v01 = *reinterpret_cast<const float2*>(t + 2 * kS * i);
    const float v[kC] = {v01.x, v01.y, t2[kS * i]};
#pragma unroll
    for (int j = 0; j < kP1; ++j) {
#pragma unroll
      for (int c = 0; c < kC; ++c) u[j][c] = fmaf(v[c], khr[j][i], u[j][c]);
    }
  }
#pragma unroll
  for (int j = 0; j < kP1; ++j) {
    if (!kMasked || band[j]) {
#pragma unroll
      for (int c = 0; c < kC; ++c) acc[j][c] = fmaf(wv[j], u[j][c], acc[j][c]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 3)
sepconv_fwd_kernel(const T* __restrict__ inp, const T* __restrict__ kv,
                   const T* __restrict__ kh, T* __restrict__ out,
                   int h, int w, int f) {
  extern __shared__ float tile[];  // see stage()
  const int hp = h + f - 1, wp = w + f - 1, th = kRows1 + f - 1;
  const int n = blockIdx.z;
  const int y0 = blockIdx.y * kRows1, x0 = blockIdx.x * kTileW;
  stage(tile, inp + static_cast<size_t>(n) * kC * hp * wp, hp, wp, th, f, y0,
        x0);

  const int lane = threadIdx.x & 31, s = lane & 1, col = lane >> 1;
  const int ys = (threadIdx.x >> 5) * kP1;  // the strip's first tile row
  const int y = y0 + ys, x = x0 + col;
  const size_t hw = static_cast<size_t>(h) * w;
  const long long dj = static_cast<long long>(w) - static_cast<long long>(hw);
  // plane k of pixel (y+j, x) of image n is at map0 + k*hw + j*w
  const size_t map0 = static_cast<size_t>(n) * f * hw +
                      static_cast<size_t>(y) * w + x;
  bool in_map[kP1];
#pragma unroll
  for (int j = 0; j < kP1; ++j) in_map[j] = x < w && y + j < h;

  // this lane's taps l = s + 2i, loaded while the halo copy runs
  float khr[kP1][kNT];
#pragma unroll
  for (int j = 0; j < kP1; ++j) {
#pragma unroll
    for (int i = 0; i < kNT; ++i) {
      const int l = s + kS * i;
      khr[j][i] =
          in_map[j] && l < f ? ld(kh + map0 + l * hw + j * w) : 0.f;
    }
  }
  const T* kv_r = kv + map0;  // plane r of pixel 0
  float wn[kP1];
  load_kv(kv_r, dj, 0, f, in_map, wn);
  cp_async_wait_all();
  __syncthreads();

  float acc[kP1][kC] = {};
  const int plane = th * kTW;
  const int rows = f + kP1 - 1;
  const float* t = tile + 2 * (ys * kTW + col + s);
  const float* t2 = tile + 2 * plane + ys * kTW + col + s;
  for (int r = 0; r < rows; ++r, t += 2 * kTW, t2 += kTW) {
    float wv[kP1];
    bool band[kP1];
#pragma unroll
    for (int j = 0; j < kP1; ++j) {
      wv[j] = wn[j];
      band[j] = static_cast<unsigned>(r - j) < static_cast<unsigned>(f);
    }
    load_kv(kv_r + hw, dj, r + 1, f, in_map, wn);  // a row ahead
    // rows [kP1-1, f) have every pixel of the strip inside its band
    if (r >= kP1 - 1 && r < f)
      fwd_row<false>(t, t2, khr, wv, band, acc);
    else
      fwd_row<true>(t, t2, khr, wv, band, acc);
    kv_r += hw;
  }

  // the two lanes' sums over their taps; lane s stores pixels j = s mod 2
  T* out_p = out + static_cast<size_t>(n) * kC * hw +
                 static_cast<size_t>(y) * w + x;
#pragma unroll
  for (int j = 0; j < kP1; ++j) {
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const float sum = acc[j][c] + __shfl_xor_sync(kFull, acc[j][c], 1);
      if ((j & 1) == s && in_map[j]) st(out_p + c * hw + j * w, sum);
    }
  }
}

// One staged row of the gradient, at vertical tap k = r - j for pixel j:
// gw = sum_c g(c) in(c, .), then gkv_j(k) over this lane's taps and gkh_j
// of each. t and t2 as for fwd_row; kMasked: a pixel of the strip lies
// outside its band on this row, and band says which.
template <bool kMasked>
__device__ __forceinline__ void grad_row(const float* t, const float* t2,
                                         const float (&gr)[kP2][kC],
                                         const float (&khr)[kP2][kNT],
                                         float (&gkh_acc)[kP2][kNT],
                                         const float (&wv)[kP2],
                                         const bool (&band)[kP2],
                                         float (&gkv_row)[kP2]) {
  float part[kP2] = {};
#pragma unroll
  for (int i = 0; i < kNT; ++i) {
    const float2 v01 = *reinterpret_cast<const float2*>(t + 2 * kS * i);
    const float v[kC] = {v01.x, v01.y, t2[kS * i]};
#pragma unroll
    for (int j = 0; j < kP2; ++j) {
      float gw = gr[j][0] * v[0];
#pragma unroll
      for (int c = 1; c < kC; ++c) gw = fmaf(gr[j][c], v[c], gw);
      part[j] = fmaf(khr[j][i], gw, part[j]);
      if (!kMasked || band[j]) gkh_acc[j][i] = fmaf(wv[j], gw, gkh_acc[j][i]);
    }
  }
#pragma unroll
  for (int j = 0; j < kP2; ++j) gkv_row[j] = part[j];
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 3)
sepconv_grad_kernels_kernel(const T* __restrict__ inp,
                            const T* __restrict__ g,
                            const T* __restrict__ kv,
                            const T* __restrict__ kh,
                            T* __restrict__ gkv, T* __restrict__ gkh,
                            int h, int w, int f) {
  extern __shared__ float tile[];  // see stage()
  const int hp = h + f - 1, wp = w + f - 1, th = kRows2 + f - 1;
  const int n = blockIdx.z;
  const int y0 = blockIdx.y * kRows2, x0 = blockIdx.x * kTileW;
  stage(tile, inp + static_cast<size_t>(n) * kC * hp * wp, hp, wp, th, f, y0,
        x0);

  const int lane = threadIdx.x & 31, s = lane & 1, col = lane >> 1;
  const int ys = (threadIdx.x >> 5) * kP2;
  const int y = y0 + ys, x = x0 + col;
  const size_t hw = static_cast<size_t>(h) * w;
  const long long dj = static_cast<long long>(w) - static_cast<long long>(hw);
  const size_t pix = static_cast<size_t>(y) * w + x;
  const size_t map0 = static_cast<size_t>(n) * f * hw + pix;
  bool in_map[kP2];
#pragma unroll
  for (int j = 0; j < kP2; ++j) in_map[j] = x < w && y + j < h;

  float gr[kP2][kC];
#pragma unroll
  for (int j = 0; j < kP2; ++j) {
#pragma unroll
    for (int c = 0; c < kC; ++c)
      gr[j][c] = in_map[j] ? ld(g + static_cast<size_t>(n) * kC * hw +
                                c * hw + pix + j * w)
                           : 0.f;
  }
  float khr[kP2][kNT], gkh_acc[kP2][kNT] = {};
#pragma unroll
  for (int j = 0; j < kP2; ++j) {
#pragma unroll
    for (int i = 0; i < kNT; ++i) {
      const int l = s + kS * i;
      khr[j][i] =
          in_map[j] && l < f ? ld(kh + map0 + l * hw + j * w) : 0.f;
    }
  }
  const T* kv_r = kv + map0;  // plane r of pixel 0
  float wn[kP2];
  load_kv(kv_r, dj, 0, f, in_map, wn);
  cp_async_wait_all();
  __syncthreads();

  const int plane = th * kTW;
  const int rows = f + kP2 - 1;
  const float* t = tile + 2 * (ys * kTW + col + s);
  const float* t2 = tile + 2 * plane + ys * kTW + col + s;
  for (int r = 0; r < rows; ++r, t += 2 * kTW, t2 += kTW) {
    float wv[kP2];
    bool band[kP2];
#pragma unroll
    for (int j = 0; j < kP2; ++j) {
      wv[j] = wn[j];
      band[j] = static_cast<unsigned>(r - j) < static_cast<unsigned>(f);
    }
    load_kv(kv_r + hw, dj, r + 1, f, in_map, wn);  // a row ahead
    float gkv_row[kP2];
    // rows [kP2-1, f) have every pixel of the strip inside its band
    if (r >= kP2 - 1 && r < f)
      grad_row<false>(t, t2, gr, khr, gkh_acc, wv, band, gkv_row);
    else
      grad_row<true>(t, t2, gr, khr, gkh_acc, wv, band, gkv_row);
    // gkv_j(r - j), at the same offset as kv_j(r - j): the two lanes'
    // partials; lane s stores pixels j = s mod 2
    T* gkv_r = gkv + (kv_r - kv);
#pragma unroll
    for (int j = 0; j < kP2; ++j) {
      const float sum = gkv_row[j] + __shfl_xor_sync(kFull, gkv_row[j], 1);
      if ((j & 1) == s && in_map[j] && band[j]) st(gkv_r + j * dj, sum);
    }
    kv_r += hw;
  }

#pragma unroll
  for (int j = 0; j < kP2; ++j) {
#pragma unroll
    for (int i = 0; i < kNT; ++i) {
      const int l = s + kS * i;
      if (in_map[j] && l < f) st(gkh + map0 + l * hw + j * w, gkh_acc[j][i]);
    }
  }
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, int rows, int n, int c, int h, int w,
                    int f, dim3* grid, size_t* smem) {
  if (c != kC || f < 1 || f > kFMax || n < 1 || n > 65535 || h < 1 || w < 1)
    return cudaErrorInvalidValue;
  *smem = sizeof(float) * kC * (rows + f - 1) * kTW;
  *grid = dim3((w + kTileW - 1) / kTileW, (h + rows - 1) / rows, n);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(*smem));
  if (err != cudaSuccess) return err;
  // all of the SM's unified memory as shared memory, so that the blocks
  // the registers allow (3) are not cut by the carveout
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

template <typename T>
int forward(const T* inp, const T* kv, const T* kh, T* out, int n, int c,
            int h, int w, int f, void* stream) {
  dim3 grid;
  size_t smem;
  cudaError_t err = prepare(sepconv_fwd_kernel<T>, kRows1, n, c, h, w, f,
                            &grid, &smem);
  if (err != cudaSuccess) return err;
  sepconv_fwd_kernel<T><<<grid, kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(inp, kv, kh,
                                                               out, h, w, f);
  return cudaGetLastError();
}

template <typename T>
int grad_kernels(const T* inp, const T* g, const T* kv, const T* kh, T* gkv,
                 T* gkh, int n, int c, int h, int w, int f, void* stream) {
  dim3 grid;
  size_t smem;
  cudaError_t err = prepare(sepconv_grad_kernels_kernel<T>, kRows2, n, c, h,
                            w, f, &grid, &smem);
  if (err != cudaSuccess) return err;
  sepconv_grad_kernels_kernel<T><<<grid, kThreads, smem,
                                   static_cast<cudaStream_t>(stream)>>>(
      inp, g, kv, kh, gkv, gkh, h, w, f);
  return cudaGetLastError();
}

}  // namespace

// The entry points launch on `stream`, do not synchronise, and return the
// launch status (cudaGetLastError) as an int: 0 is success. The _bf16
// ones take every tensor in bfloat16.
extern "C" int sepconv_forward(const float* inp, const float* kv,
                               const float* kh, float* out, int n, int c,
                               int h, int w, int f, void* stream) {
  return forward(inp, kv, kh, out, n, c, h, w, f, stream);
}

extern "C" int sepconv_forward_bf16(const __nv_bfloat16* inp,
                                    const __nv_bfloat16* kv,
                                    const __nv_bfloat16* kh,
                                    __nv_bfloat16* out, int n, int c, int h,
                                    int w, int f, void* stream) {
  return forward(inp, kv, kh, out, n, c, h, w, f, stream);
}

extern "C" int sepconv_grad_kernels(const float* inp, const float* g,
                                    const float* kv, const float* kh,
                                    float* gkv, float* gkh, int n, int c,
                                    int h, int w, int f, void* stream) {
  return grad_kernels(inp, g, kv, kh, gkv, gkh, n, c, h, w, f, stream);
}

extern "C" int sepconv_grad_kernels_bf16(
    const __nv_bfloat16* inp, const __nv_bfloat16* g,
    const __nv_bfloat16* kv, const __nv_bfloat16* kh, __nv_bfloat16* gkv,
    __nv_bfloat16* gkh, int n, int c, int h, int w, int f, void* stream) {
  return grad_kernels(inp, g, kv, kh, gkv, gkh, n, c, h, w, f, stream);
}
