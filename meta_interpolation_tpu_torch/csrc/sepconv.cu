// Adaptive separable convolution for Hopper (sm_90a): the SepConv hot op.
//
//   out(n, c, y, x) = sum_k sum_l in(n, c, y+k, x+l) * kv(n, k, y, x) * kh(n, l, y, x)
//
// Layouts are the model's natural NCHW: in (N, C, H+F-1, W+F-1), kv/kh
// (N, F, H, W), out (N, C, H, W), all contiguous and of one storage type:
// float32, or bfloat16 (--dtype bfloat16). Each type has kernels of its
// own. The TPU kernels take bf16 by upcasting, running in f32 and casting
// back (meta_interpolation_tpu/ops/sepconv.py:139-143, :237-241); the bf16
// kernels here compute the same up to the order of the float32 sums: the
// products of bf16 values are exact in float32, every sum runs in float32,
// and each output is rounded once to bf16 (round to nearest even) where
// it is stored.
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
// float32 (sepconv_fwd_kernel, sepconv_grad_kernels_kernel). What bounds
// them on an H100 at the SepConv shape (N=1, C=3, F=51, maps 384x512):
// fp32 operations outside the tensor cores. The forward does
// F(F+1)C = 7956 FMA a pixel (3.1 GFLOP against ~85 MB moved, ~47 us at
// 67 TFLOP/s, SXM data sheet); the gradient F^2(C+2) = 13005 FMA a pixel
// (5.1 GFLOP against ~166 MB, ~76 us). TF32 would round the operands, so
// they stay on the fp32 pipes.
//
// So their limit is the SM's issue rate and its shared-memory rate. An SM
// issues 4 warp instructions a clock (128 fp32 FMA lanes) but serves one
// shared-memory wavefront (32 words) a clock, so a design with one shared
// load per FMA reaches at most a quarter of the fp32 rate. Both float32
// kernels block registers across neighbouring pixels instead:
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
// bf16 (sepconv_fwd_bf16_kernel, sepconv_grad_kernels_bf16_kernel):
// banded matrix products on the tensor cores. For the 16 pixels x of a
// tile row j, the horizontal sums on every staged input row r are one
// product,
//   U_j[x, (c, r)] = sum_m A_j[x, m] in_c(r, m),  A_j[x, m] = kh_(m-x)(j, x),
// with A_j a 16 x 66 band (51 of 66 entries are taps) padded with zeros to
// K = 80, five mma k-steps. K1 folds it with kv, out_c(j, x) = sum_r
// kv_(r-j)(j, x) U_j[x, (c, r)] (153 FMA a pixel where the float32 kernel
// does 7956); K2 folds it with g, gkv_k(j, x) = sum_c g_c(j, x)
// U_j[x, (c, j + k)], and gets gkh from the transposed product down a
// column x: V_x[y, (c, col)] = sum_r kv_(r-y)(y, x) in_c(r, col), gkh_l(y,
// x) = sum_c g_c(y, x) V_x[y, (c, x + l)]. With the arithmetic on the
// tensor cores (989 TFLOP/s dense bf16, SXM data sheet) both kernels are
// bound by bytes: K1 moves 42.8 MB at the SepConv shape (12.8 us at 3.35
// TB/s) and does 3.1 GFLOP of useful work (3.2 us), K2 82.9 MB (24.7 us);
// the maps are ~95 % of the bytes.
//
// - A block covers a 16x16 tile. A warp holds the band matrices of R tile
//   rows (K2's vertical pass: columns) as mma A fragments in registers,
//   built once from the staged kh (kv) tile; the n index of B is the
//   absolute staged row (column), so one B fragment, loaded with ldmatrix
//   (.trans for the vertical product, whose k is the staged rows), feeds
//   the R rows' mma.sync.m16n8k16 (bf16 operands, float32 sums). A warp
//   covers the n8 tiles of rows [8 floor(j0/8), 8 ceil((j0 + R + F - 1)/8)),
//   7 or 8 a channel: ~7 mma (2048 MAC each) a pixel and pass, of which
//   ~44 % fall outside the band or in the padding; the tensor cores
//   absorb that.
// - K1: R = 2, 8 warps (256 threads); K2: R = 1, 16 warps (512 threads),
//   which leaves 63 registers a thread and more warps to hide the staged
//   loads than R = 2 (PERF.md, section 6). Both: 2 blocks an SM by shared
//   memory, 768 blocks at 384x512 maps.
// - The folds run in float32 on the accumulator fragments: lane (g, q)
//   holds pixels g and g + 8 on the rows 8t + 2q + {0, 1} of n8 tile t. K1
//   sums its partial outputs across the quad's 4 lanes with two shuffles;
//   each of K2's outputs is held by one lane.
// - Staging: the map tiles ((F, 16, 16) bf16, planes padded to 264 values
//   so that the bands' and the folds' shared loads of the horizontal pass
//   do not conflict) with 16-byte cp.async where every chunk is aligned
//   (W % 8 == 0: the model's maps are), else through registers; the input
//   halo ((3, 72 or 80, 88) bf16, rows padded to 176 bytes so that an
//   ldmatrix's 8 rows fall on distinct banks) with cp.async of the aligned
//   16-byte chunks that cover each row, then shifted into place in shared
//   memory (a row of W + F - 1 values seldom starts on a 16-byte boundary).
//   Halo and maps are 0 past the tile's halo, the map and the input's edge,
//   so the padding of K (66 -> 80) and of N meets only zeros.
// - K2 writes gkv over the staged kh and gkh over the staged kv once every
//   warp holds its bands, and copies both out with 16-byte stores. Every
//   output is owned by one thread: no atomics, deterministic sums.
//
// Times on the card, and the designs tried: PERF.md, section 6.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

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

// A value through the read-only path, and a store.
__device__ __forceinline__ float ld(const float* p) { return __ldg(p); }
__device__ __forceinline__ void st(float* p, float v) { *p = v; }

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
      cp_async4(dst, valid ? in_c + static_cast<size_t>(gy) * wp + gx : in_c,
                valid);
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

// ---------------------------------------------------------------------------
// bf16: banded matrix products on the tensor cores
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kT = 16;      // a block's tile: 16x16 pixels
constexpr int kRFwd = 2;    // K1: tile rows a warp, so 8 warps a block
constexpr int kRGrad = 1;   // K2: tile rows, then columns, a warp: 16 warps
constexpr int kK = 80;      // K of the band: 16 + kFMax - 1 = 66, padded
constexpr int kKSteps = kK / 16;  // mma k-steps
constexpr int kHaloStride = kK + 8;  // a staged row: 176 bytes, so the 8
                                     // rows of an ldmatrix hit distinct banks
constexpr int kHaloRows1 = 72;  // K1: the rows of the 9 n8 tiles a warp reads
constexpr int kHaloRows2 = kK;  // K2: also the vertical product's K
constexpr int kPlane = kT * kT + 8;  // a staged map plane, padded: 264

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
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

// The first `valid` of the 8 bf16 values of v, the rest 0.
__device__ __forceinline__ uint4 keep(uint4 v, int valid) {
  uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (2 * i >= valid) w[i] = 0u;
    else if (2 * i + 1 >= valid) w[i] &= 0xffffu;
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// The values before p in its 16-byte chunk.
__device__ __forceinline__ int misalignment(const bf16* p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) & 15) >> 1);
}

// The first `valid` (at most 8) of the 8 bf16 values at p, the rest 0; p
// need not be 16-byte aligned. Nothing is read when valid <= 0, and only
// the aligned chunks that hold a valid value.
__device__ __forceinline__ uint4 load8(const bf16* p, int valid) {
  if (valid <= 0) return make_uint4(0, 0, 0, 0);
  const int s = misalignment(p);
  const uint4* base = reinterpret_cast<const uint4*>(p - s);
  const uint4 lo = __ldg(base);
  const uint4 hi = s + valid > 8 ? __ldg(base + 1) : make_uint4(0, 0, 0, 0);
  return keep(shift8(lo, hi, s), valid);
}

// The input halo of a tile: rows [y0, y0 + hr) x cols [x0, x0 + kK) of the
// three channels of an image as bf16, (kC, hr, kHaloStride). Positions
// past the tile's halo (row or col >= kT + f - 1) or the input's edge are
// 0: they meet only band entries of 0, and must not be NaN. A row of the
// input seldom starts on a 16-byte boundary (rows of W + F - 1 values), so
// stage_halo copies the kHaloStride / 8 = 11 aligned chunks that cover
// each row's kK values with cp.async, and align_halo, once they have
// landed, shifts each row into place and zeroes what lies outside.
struct HaloRow {
  const bf16* start;  // the row's first value in device memory
  int cols;           // its values inside the halo and the input
};

__device__ __forceinline__ HaloRow halo_row(const bf16* in_n, int hp, int wp,
                                            int hr, int f, int y0, int x0,
                                            int row) {
  const int r = row % hr, c = row / hr, span = kT + f - 1;
  const bf16* start = in_n + (static_cast<size_t>(c) * hp + y0 + r) * wp + x0;
  const int cols = r < min(span, hp - y0) ? min(span, wp - x0) : 0;
  return {start, cols};
}

template <int kN>
__device__ __forceinline__ void stage_halo(bf16* halo, const bf16* in_n,
                                           int hp, int wp, int hr, int f,
                                           int y0, int x0) {
  constexpr int kChunks = kHaloStride / 8;
  for (int i = threadIdx.x; i < kC * hr * kChunks; i += kN) {
    const int chunk = i % kChunks, row = i / kChunks;
    const HaloRow hrow = halo_row(in_n, hp, wp, hr, f, y0, x0, row);
    const int s = misalignment(hrow.start);
    const bool valid = hrow.cols > 0 && 8 * chunk - s < hrow.cols;
    cp_async16(halo + row * kHaloStride + 8 * chunk,
               valid ? hrow.start - s + 8 * chunk : in_n, valid);
  }
}

template <int kN>
__device__ __forceinline__ void align_halo(bf16* halo, const bf16* in_n,
                                           int hp, int wp, int hr, int f,
                                           int y0, int x0) {
  for (int row = threadIdx.x; row < kC * hr; row += kN) {
    const HaloRow hrow = halo_row(in_n, hp, wp, hr, f, y0, x0, row);
    const int s = misalignment(hrow.start);
    uint4* p = reinterpret_cast<uint4*>(halo + row * kHaloStride);
    uint4 lo = p[0];
#pragma unroll
    for (int i = 0; i < kK / 8; ++i) {
      const uint4 hi = p[i + 1];
      p[i] = keep(shift8(lo, hi, s), hrow.cols - 8 * i);
      lo = hi;
    }
  }
}

// Visit the 16-byte chunks of a map's tile, (f, kT, kT) at plane stride
// kPlane in shared memory, (f, h, w) from (y0, x0) in device memory, with
// kN threads: fn(shared offset, device offset, values of the chunk inside
// the map).
template <int kN, typename Fn>
__device__ __forceinline__ void for_map_chunks(int h, int w, int f, int y0,
                                               int x0, Fn fn) {
  const size_t hw = static_cast<size_t>(h) * w;
  for (int i = threadIdx.x; i < f * kT * 2; i += kN) {
    const int half = i & 1, y = (i >> 1) % kT, k = i / (2 * kT);
    const int gy = y0 + y, gx = x0 + half * 8;
    const int valid = gy < h ? max(0, min(w - gx, 8)) : 0;
    fn(k * kPlane + y * kT + half * 8,
       k * hw + static_cast<size_t>(gy) * w + gx, valid);
  }
}

// Stage a map's tile: cp.async when every chunk is 16-byte aligned in
// device memory (w % 8 == 0 and an aligned base), else load8. Out of the
// map: 0.
template <int kN>
__device__ __forceinline__ void stage_map(bf16* dst, const bf16* map_n,
                                          int h, int w, int f, int y0,
                                          int x0, bool aligned) {
  for_map_chunks<kN>(h, w, f, y0, x0, [&](int s, size_t d, int valid) {
    if (aligned)
      cp_async16(dst + s, valid > 0 ? map_n + d : map_n, valid > 0);
    else
      *reinterpret_cast<uint4*>(dst + s) = load8(map_n + d, valid);
  });
}

// Write a staged map tile back to device memory: the pixels in the map.
template <int kN>
__device__ __forceinline__ void write_map(bf16* map_n, const bf16* src,
                                          int h, int w, int f, int y0,
                                          int x0, bool aligned) {
  for_map_chunks<kN>(h, w, f, y0, x0, [&](int s, size_t d, int valid) {
    if (aligned && valid == 8) {
      *reinterpret_cast<uint4*>(map_n + d) =
          *reinterpret_cast<const uint4*>(src + s);
    } else {
      for (int e = 0; e < valid; ++e) map_n[d + e] = src[s + e];
    }
  });
}

// D += A B on the tensor cores: m16n8k16, bf16 operands, float32 sums.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The B fragment of one k-step from the halo: lanes 0-7 address the 8
// rows of its first 8x8 matrix, lanes 8-15 those of its second. kTrans:
// the halo rows are B's k (the vertical product), else its n.
template <bool kTrans>
__device__ __forceinline__ void ldmatrix_b(uint32_t& b0, uint32_t& b1,
                                           const bf16* row) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(row));
  if constexpr (kTrans)
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, "
                 "[%2];\n" : "=r"(b0), "=r"(b1) : "r"(a) : "memory");
  else
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
                 : "=r"(b0), "=r"(b1) : "r"(a) : "memory");
}

// The A fragments of a band matrix, A[p][m] = tap m - p of pixel p (0
// outside [0, f)), for the 16 pixels p at map + p * step in a staged map
// tile: lane (g, q) holds rows g and g + 8, columns 2q, 2q + 1 and those
// + 8 of each k-step (the m16n8k16 layout).
__device__ __forceinline__ void band_fragments(uint32_t (&a)[kKSteps][4],
                                               const bf16* map, int step,
                                               int f, int g, int q) {
  const unsigned short* m = reinterpret_cast<const unsigned short*>(map);
#pragma unroll
  for (int ks = 0; ks < kKSteps; ++ks) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int p = g + (r & 1) * 8;
      const int l = 16 * ks + 2 * q + (r >> 1) * 8 - p;
      const uint32_t lo = static_cast<unsigned>(l) < static_cast<unsigned>(f)
                              ? m[l * kPlane + p * step] : 0u;
      const uint32_t hi =
          static_cast<unsigned>(l + 1) < static_cast<unsigned>(f)
              ? m[(l + 1) * kPlane + p * step] : 0u;
      a[ks][r] = lo | (hi << 16);
    }
  }
}

// The products of one n8 tile of the halo against a warp's kR band
// matrices: d[j] = A_j B over the first nks k-steps. kTrans: B's n is
// halo columns [n0, n0 + 8) (the vertical product), else halo rows.
template <bool kTrans, int kR>
__device__ __forceinline__ void band_products(
    float (&d)[kR][4], const uint32_t (&a)[kR][kKSteps][4],
    const bf16* halo_c, int n0, int nks, int lane) {
#pragma unroll
  for (int j = 0; j < kR; ++j) d[j][0] = d[j][1] = d[j][2] = d[j][3] = 0.f;
#pragma unroll
  for (int ks = 0; ks < kKSteps; ++ks) {
    if (ks < nks) {
      uint32_t b0, b1;
      if constexpr (kTrans)
        ldmatrix_b<true>(b0, b1, halo_c + (16 * ks + (lane & 15)) *
                                               kHaloStride + n0);
      else
        ldmatrix_b<false>(b0, b1, halo_c + (n0 + (lane & 7)) * kHaloStride +
                                      16 * ks + (lane & 8));
#pragma unroll
      for (int j = 0; j < kR; ++j) mma(d[j], a[j][ks], b0, b1);
    }
  }
}

__device__ __forceinline__ float wide(bf16 v) { return __bfloat162float(v); }

__global__ void __launch_bounds__(32 * kT / kRFwd, 2)
sepconv_fwd_bf16_kernel(const bf16* __restrict__ inp,
                        const bf16* __restrict__ kv,
                        const bf16* __restrict__ kh, bf16* __restrict__ out,
                        int h, int w, int f, int aligned) {
  extern __shared__ uint4 smem[];
  bf16* halo = reinterpret_cast<bf16*>(smem);
  bf16* kv_s = halo + kC * kHaloRows1 * kHaloStride;
  bf16* kh_s = kv_s + f * kPlane;
  const int hp = h + f - 1, wp = w + f - 1, n = blockIdx.z;
  const int y0 = blockIdx.y * kT, x0 = blockIdx.x * kT;
  const size_t hw = static_cast<size_t>(h) * w;
  constexpr int kR = kRFwd, kN = 32 * kT / kR;
  stage_map<kN>(kv_s, kv + n * f * hw, h, w, f, y0, x0, aligned);
  stage_map<kN>(kh_s, kh + n * f * hw, h, w, f, y0, x0, aligned);
  const bf16* in_n = inp + static_cast<size_t>(n) * kC * hp * wp;
  stage_halo<kN>(halo, in_n, hp, wp, kHaloRows1, f, y0, x0);
  cp_async_wait_all();
  __syncthreads();
  align_halo<kN>(halo, in_n, hp, wp, kHaloRows1, f, y0, x0);
  __syncthreads();

  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const int j0 = (threadIdx.x >> 5) * kR;  // the warp's first tile row
  const int nks = (kT + f - 1 + 15) / 16;
  // U_j[x][r] = sum_m kh_(m-x)(j, x) in(r, m): row j's horizontal sums on
  // every staged input row r, as the band of kh times the halo
  uint32_t a[kR][kKSteps][4];
#pragma unroll
  for (int j = 0; j < kR; ++j)
    band_fragments(a[j], kh_s + (j0 + j) * kT, 1, f, g, q);

  // out(j, x) = sum_r kv_(r-j)(j, x) U_j[x][r]: lane (g, q) holds pixels
  // x = g, g + 8 and rows r = 8t + 2q + e of each n8 tile t
  float acc[kR][2][kC] = {};
  const int t_end = (j0 + kR + f - 2) / 8 + 1;
  for (int t = j0 / 8; t < t_end; ++t) {
    float wv[kR][2][2];
#pragma unroll
    for (int j = 0; j < kR; ++j) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int k = 8 * t + 2 * q + e - j0 - j;
          wv[j][hh][e] = static_cast<unsigned>(k) < static_cast<unsigned>(f)
                             ? wide(kv_s[k * kPlane + (j0 + j) * kT + g +
                                         8 * hh])
                             : 0.f;
        }
      }
    }
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      float u[kR][4];
      band_products<false>(u, a, halo + c * kHaloRows1 * kHaloStride, 8 * t,
                           nks, lane);
#pragma unroll
      for (int j = 0; j < kR; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          acc[j][i >> 1][c] = fmaf(wv[j][i >> 1][i & 1], u[j][i],
                                   acc[j][i >> 1][c]);
      }
    }
  }

  // the quad's lanes hold the same pixels on other rows r; lane q stores
  // tile row j0 + q
#pragma unroll
  for (int j = 0; j < kR; ++j) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        float s = acc[j][hh][c];
        s += __shfl_xor_sync(kFull, s, 1);
        s += __shfl_xor_sync(kFull, s, 2);
        const int y = y0 + j0 + j, x = x0 + g + 8 * hh;
        if (j == q && y < h && x < w)
          out[(static_cast<size_t>(n) * kC + c) * hw +
              static_cast<size_t>(y) * w + x] = __float2bfloat16_rn(s);
      }
    }
  }
}

__global__ void __launch_bounds__(32 * kT / kRGrad, 2)
sepconv_grad_kernels_bf16_kernel(const bf16* __restrict__ inp,
                                 const bf16* __restrict__ g_in,
                                 const bf16* __restrict__ kv,
                                 const bf16* __restrict__ kh,
                                 bf16* __restrict__ gkv,
                                 bf16* __restrict__ gkh, int h, int w, int f,
                                 int aligned) {
  extern __shared__ uint4 smem[];
  bf16* halo = reinterpret_cast<bf16*>(smem);
  bf16* kv_s = halo + kC * kHaloRows2 * kHaloStride;  // later gkh
  bf16* kh_s = kv_s + f * kPlane;                     // later gkv
  float* g_s = reinterpret_cast<float*>(kh_s + f * kPlane);  // (kC, kT, kT)
  const int hp = h + f - 1, wp = w + f - 1, n = blockIdx.z;
  const int y0 = blockIdx.y * kT, x0 = blockIdx.x * kT;
  const size_t hw = static_cast<size_t>(h) * w;
  constexpr int kR = kRGrad, kN = 32 * kT / kR;
  stage_map<kN>(kv_s, kv + n * f * hw, h, w, f, y0, x0, aligned);
  stage_map<kN>(kh_s, kh + n * f * hw, h, w, f, y0, x0, aligned);
  for (int i = threadIdx.x; i < kC * kT * kT; i += kN) {
    const int x = x0 + i % kT, y = y0 + (i / kT) % kT, c = i / (kT * kT);
    g_s[i] = y < h && x < w
                 ? wide(g_in[(static_cast<size_t>(n) * kC + c) * hw +
                             static_cast<size_t>(y) * w + x])
                 : 0.f;
  }
  const bf16* in_n = inp + static_cast<size_t>(n) * kC * hp * wp;
  stage_halo<kN>(halo, in_n, hp, wp, kHaloRows2, f, y0, x0);
  cp_async_wait_all();
  __syncthreads();
  align_halo<kN>(halo, in_n, hp, wp, kHaloRows2, f, y0, x0);
  __syncthreads();

  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const int j0 = (threadIdx.x >> 5) * kR;  // the warp's first row / column
  const int nks = (kT + f - 1 + 15) / 16;
  const int t_end = (j0 + kR + f - 2) / 8 + 1;
  uint32_t a[kR][kKSteps][4];
  float gr[kR][2][kC];

  // gkv_k(j, x) = sum_c g_c(j, x) U_c,j[x][j + k], U as in the forward
#pragma unroll
  for (int j = 0; j < kR; ++j) {
    band_fragments(a[j], kh_s + (j0 + j) * kT, 1, f, g, q);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
      for (int c = 0; c < kC; ++c)
        gr[j][hh][c] = g_s[(c * kT + j0 + j) * kT + g + 8 * hh];
    }
  }
  __syncthreads();  // every warp holds its kh bands: kh_s takes gkv
  for (int t = j0 / 8; t < t_end; ++t) {
    float sum[kR][4] = {};
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      float u[kR][4];
      band_products<false>(u, a, halo + c * kHaloRows2 * kHaloStride, 8 * t,
                           nks, lane);
#pragma unroll
      for (int j = 0; j < kR; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          sum[j][i] = fmaf(gr[j][i >> 1][c], u[j][i], sum[j][i]);
      }
    }
#pragma unroll
    for (int j = 0; j < kR; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = 8 * t + 2 * q + (i & 1) - j0 - j;
        if (static_cast<unsigned>(k) < static_cast<unsigned>(f))
          kh_s[k * kPlane + (j0 + j) * kT + g + 8 * (i >> 1)] =
              __float2bfloat16_rn(sum[j][i]);
      }
    }
  }

  // gkh_l(y, x) = sum_c g_c(y, x) V_c,x[y][x + l], V_c,x[y][col] =
  // sum_r kv_(r-y)(y, x) in_c(r, col): the band of kv down column x times
  // the halo, whose rows are now the product's k
#pragma unroll
  for (int j = 0; j < kR; ++j) {
    band_fragments(a[j], kv_s + j0 + j, kT, f, g, q);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
      for (int c = 0; c < kC; ++c)
        gr[j][hh][c] = g_s[(c * kT + g + 8 * hh) * kT + j0 + j];
    }
  }
  __syncthreads();  // every warp holds its kv bands: kv_s takes gkh
  for (int t = j0 / 8; t < t_end; ++t) {
    float sum[kR][4] = {};
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      float v[kR][4];
      band_products<true>(v, a, halo + c * kHaloRows2 * kHaloStride, 8 * t,
                          nks, lane);
#pragma unroll
      for (int j = 0; j < kR; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          sum[j][i] = fmaf(gr[j][i >> 1][c], v[j][i], sum[j][i]);
      }
    }
#pragma unroll
    for (int j = 0; j < kR; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int l = 8 * t + 2 * q + (i & 1) - j0 - j;
        if (static_cast<unsigned>(l) < static_cast<unsigned>(f))
          kv_s[l * kPlane + (g + 8 * (i >> 1)) * kT + j0 + j] =
              __float2bfloat16_rn(sum[j][i]);
      }
    }
  }
  __syncthreads();
  write_map<kN>(gkv + n * f * hw, kh_s, h, w, f, y0, x0, aligned);
  write_map<kN>(gkh + n * f * hw, kv_s, h, w, f, y0, x0, aligned);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename Kernel>
cudaError_t prepare_bf16(Kernel kernel, size_t smem, int n, int c, int h,
                         int w, int f, dim3* grid) {
  if (c != kC || f < 1 || f > kFMax || n < 1 || n > 65535 || h < 1 || w < 1)
    return cudaErrorInvalidValue;
  *grid = dim3((w + kT - 1) / kT, (h + kT - 1) / kT, n);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

int forward_bf16(const bf16* inp, const bf16* kv, const bf16* kh, bf16* out,
                 int n, int c, int h, int w, int f, void* stream) {
  const size_t smem =
      sizeof(bf16) * (kC * kHaloRows1 * kHaloStride + 2 * f * kPlane);
  dim3 grid;
  cudaError_t err =
      prepare_bf16(sepconv_fwd_bf16_kernel, smem, n, c, h, w, f, &grid);
  if (err != cudaSuccess) return err;
  const int aligned = w % 8 == 0 && aligned16(kv) && aligned16(kh);
  sepconv_fwd_bf16_kernel<<<grid, 32 * kT / kRFwd, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      inp, kv, kh, out, h, w, f, aligned);
  return cudaGetLastError();
}

int grad_kernels_bf16(const bf16* inp, const bf16* g, const bf16* kv,
                      const bf16* kh, bf16* gkv, bf16* gkh, int n, int c,
                      int h, int w, int f, void* stream) {
  const size_t smem =
      sizeof(bf16) * (kC * kHaloRows2 * kHaloStride + 2 * f * kPlane) +
      sizeof(float) * kC * kT * kT;
  dim3 grid;
  cudaError_t err = prepare_bf16(sepconv_grad_kernels_bf16_kernel, smem, n,
                                 c, h, w, f, &grid);
  if (err != cudaSuccess) return err;
  const int aligned = w % 8 == 0 && aligned16(kv) && aligned16(kh) &&
                      aligned16(gkv) && aligned16(gkh);
  sepconv_grad_kernels_bf16_kernel<<<grid, 32 * kT / kRGrad, smem,
                                     static_cast<cudaStream_t>(stream)>>>(
      inp, g, kv, kh, gkv, gkh, h, w, f, aligned);
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
  return forward_bf16(inp, kv, kh, out, n, c, h, w, f, stream);
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
  return grad_kernels_bf16(inp, g, kv, kh, gkv, gkh, n, c, h, w, f, stream);
}
