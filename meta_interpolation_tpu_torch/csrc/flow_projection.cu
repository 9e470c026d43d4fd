// Bounded depth-weighted flow projection for Hopper (sm_90a): DAIN's
// scatter-average of the negated flow onto the target grid, forward only.
//
// Each source pixel (y, x) with flow (fx, fy) lands at (x + fx, y + fy). It
// is valid only if it lands inside [0, W-1] x [0, H-1]; its weight wv is the
// inverse depth (or 1 without depth) and 0 where invalid. It adds
// (-fx wv, -fy wv) and wv to its four neighbours (iy_t, iy_b) x (ix_l, ix_r):
//   iy_t = clip(floor(y + fy), 0, H-1), iy_b = min(iy_t + 1, H-1)
// (columns likewise), counted with multiplicity: at the bottom or right edge
// iy_t == iy_b and the cell receives twice. A neighbour whose offset from its
// source, target - source, lies outside [-R, R+1] on either axis receives
// nothing: the source is dropped there. Then
//   proj = cnt > 0 ? acc / max(cnt, 1e-12) : acc,   cnt = the summed wv.
// Layouts: flow and proj (N, H, W, 2) float32 in (fx, fy) order; depth (N, H,
// W) float32 or null; cnt (N, H, W) float32; all contiguous.
//
// Replaces the TPU kernel meta_interpolation_tpu/ops/flow_projection_pallas.py
// :96 (flow_projection_bounded, kernel _make_kernel :38), which sweeps the
// (2R+2)^2 shifted source windows with pltpu.roll over VMEM tiles because a
// TPU's XLA scatter serialises. On Hopper the reference CUDA kernel scatters
// with atomicAdd, which makes the float sum depend on the order the atomics
// land in. This kernel is a target-side gather instead, so every sum has a
// fixed order and the result is deterministic:
//   - one thread per target pixel, blocks of 32 x 8 targets;
//   - the block first stages the landing cells (iy_t, ix_l), the two
//     contributions and wv of every source that can reach one of its targets
//     into shared memory: the halo of (8 + 2R + 1) x (32 + 2R + 1) sources,
//     each read from device memory once per block (24.5 KB at R = 8; above
//     48 KB it asks for the dynamic shared memory it needs);
//   - each thread then sweeps its own (2R+2)^2 source window in shared memory
//     in a fixed row-major order; sources outside the image or landing
//     outside it are staged as landing nowhere;
//   - the block masks its own ragged edge, so any H and W work. None of the
//     Mosaic constraints of the TPU kernel (W % 128, H % 8, halos of 8 rows,
//     128-column pads) carry over.
// The landing test and x + fx are computed in float32, as the JAX package
// does, so both take the same floors.
//
// Bound on an H100 (N = 1, 256 x 448, DAIN's served frame): bytes. The
// function reads the flow (2 planes) and the depth (1 plane) and writes proj
// (2 planes) and cnt (1 plane): 6 x 4 B x 114,688 pixels = 2.75 MB, 0.82 us at
// 3.35 TB/s. The window sweep is ~324 compare-and-add steps a target on
// shared memory, ~0.4 G integer and float operations at R = 8; that, the
// staging pass and the launch keep it several times above its byte bound,
// which is recorded, not fixed, here.

#include <cuda_runtime.h>

namespace {

constexpr int kTileX = 32;
constexpr int kTileY = 8;
constexpr int kThreads = kTileX * kTileY;
// a staged landing row or column that no target matches, even after + 1
constexpr int kNowhere = -(1 << 30);
constexpr size_t kMaxSharedBytes = 232448;  // 227 KB a block on sm_90

__host__ __device__ inline size_t halo_count(int r) {
  return static_cast<size_t>(kTileY + 2 * r + 1) * (kTileX + 2 * r + 1);
}

__global__ void __launch_bounds__(kThreads)
flow_projection_kernel(const float* __restrict__ flow,
                       const float* __restrict__ depth,
                       float* __restrict__ proj, float* __restrict__ cnt,
                       int h, int w, int r) {
  extern __shared__ float smem[];
  const int span_x = kTileX + 2 * r + 1;
  const int count = static_cast<int>(halo_count(r));
  int* s_iy = reinterpret_cast<int*>(smem);
  int* s_ix = s_iy + count;
  float* s_cx = reinterpret_cast<float*>(s_ix + count);
  float* s_cy = s_cx + count;
  float* s_wv = s_cy + count;

  const int b = blockIdx.z;
  const size_t plane = static_cast<size_t>(h) * w;
  const float* fb = flow + static_cast<size_t>(b) * plane * 2;
  const float* db =
      depth == nullptr ? nullptr : depth + static_cast<size_t>(b) * plane;
  // the halo's first source: R + 1 rows above and columns left of the tile
  const int y0 = static_cast<int>(blockIdx.y) * kTileY - r - 1;
  const int x0 = static_cast<int>(blockIdx.x) * kTileX - r - 1;
  const int tid = threadIdx.y * kTileX + threadIdx.x;

  for (int i = tid; i < count; i += kThreads) {
    const int sy = y0 + i / span_x, sx = x0 + i % span_x;
    int iy = kNowhere, ix = kNowhere;
    float cx = 0.f, cy = 0.f, wv = 0.f;
    if (sy >= 0 && sy < h && sx >= 0 && sx < w) {
      const size_t p = static_cast<size_t>(sy) * w + sx;
      const float2 f = reinterpret_cast<const float2*>(fb)[p];
      const float x2 = static_cast<float>(sx) + f.x;
      const float y2 = static_cast<float>(sy) + f.y;
      if (x2 >= 0.f && y2 >= 0.f && x2 <= static_cast<float>(w - 1) &&
          y2 <= static_cast<float>(h - 1)) {
        wv = db == nullptr ? 1.f : __ldg(db + p);
        cx = -f.x * wv;
        cy = -f.y * wv;
        // in range after the landing test, so the clip is a no-op
        iy = static_cast<int>(floorf(y2));
        ix = static_cast<int>(floorf(x2));
      }
    }
    s_iy[i] = iy;
    s_ix[i] = ix;
    s_cx[i] = cx;
    s_cy[i] = cy;
    s_wv[i] = wv;
  }
  __syncthreads();

  const int ty = static_cast<int>(blockIdx.y) * kTileY + threadIdx.y;
  const int tx = static_cast<int>(blockIdx.x) * kTileX + threadIdx.x;
  if (ty >= h || tx >= w) return;
  // sources of this target: rows ty - R - 1 .. ty + R, which are local rows
  // threadIdx.y .. threadIdx.y + 2R + 1 of the halo (columns likewise)
  float ax = 0.f, ay = 0.f, ac = 0.f;
  const int side = 2 * r + 2;
  for (int dy = 0; dy < side; ++dy) {
    const int row = (threadIdx.y + dy) * span_x + threadIdx.x;
    for (int dx = 0; dx < side; ++dx) {
      const int i = row + dx;
      const int iy = s_iy[i], ix = s_ix[i];
      const int hy = (iy == ty) + (min(iy + 1, h - 1) == ty);
      const int hx = (ix == tx) + (min(ix + 1, w - 1) == tx);
      if (hy * hx != 0) {
        const float m = static_cast<float>(hy * hx);
        ax = fmaf(m, s_cx[i], ax);
        ay = fmaf(m, s_cy[i], ay);
        ac = fmaf(m, s_wv[i], ac);
      }
    }
  }
  const size_t p = static_cast<size_t>(b) * plane +
                   static_cast<size_t>(ty) * w + tx;
  cnt[p] = ac;
  const float den = fmaxf(ac, 1e-12f);
  float2 out;
  out.x = ac > 0.f ? ax / den : ax;
  out.y = ac > 0.f ? ay / den : ay;
  reinterpret_cast<float2*>(proj)[p] = out;
}

}  // namespace

// Launches on `stream`, does not synchronise, and returns the launch status
// (cudaGetLastError) as an int: 0 is success. `depth` may be null.
extern "C" int flow_projection_bounded(const float* flow, const float* depth,
                                       float* proj, float* cnt, int n, int h,
                                       int w, int r, void* stream) {
  if (n < 1 || n > 65535 || h < 1 || w < 1 || r < 0)
    return cudaErrorInvalidValue;
  const size_t smem = halo_count(r) * 5 * sizeof(float);
  if (smem > kMaxSharedBytes) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flow_projection_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((w + kTileX - 1) / kTileX, (h + kTileY - 1) / kTileY, n);
  const dim3 block(kTileX, kTileY);
  flow_projection_kernel<<<grid, block, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      flow, depth, proj, cnt, h, w, r);
  return cudaGetLastError();
}
