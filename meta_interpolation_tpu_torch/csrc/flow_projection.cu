// Bounded depth-weighted flow projection for Hopper (sm_90a): DAIN's
// scatter-average of the negated flow onto the target grid, forward only.
//
// Each source pixel (y, x) with flow (fx, fy) lands at (x + fx, y + fy). It
// is valid only if it lands inside [0, W-1] x [0, H-1]; its weight wv is the
// inverse depth (or 1 without depth) and 0 where invalid. It adds
// (-fx wv, -fy wv) and wv to its four neighbours (t, b) x (l, r):
//   t = clip(floor(y + fy), 0, H-1), b = min(t + 1, H-1)
// (columns likewise), counted with multiplicity: at the bottom or right edge
// t == b and the cell receives twice. A neighbour whose offset from its
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
// land in. This kernel gathers on the target side instead, so every sum has
// a fixed order and the result is deterministic. Blocks of 32 x 32 targets;
// warp a owns tile row a, lane j target column j:
//   1. stage: the block copies every source that can reach its tile, the
//      halo of (32 + 2R + 1)^2 sources, into shared memory with cp.async
//      (all copies in flight at once, no registers held), and decides once
//      what each does here. A landing row (t, b) or column (l, r) is kept
//      only if it lies in the source's [-R, R+1] window and inside the tile:
//      the window is separable, so this per-axis test equals the per-target
//      one. The kept columns become a bit mask of the tile's columns; the
//      multiplicity (2 where t == b, 2 where l == r) is folded into the three
//      contributions, exactly, since it is a power of two. The kept rows of
//      32 neighbouring sources, one a lane, are transposed across the warp
//      (five shuffles) into one 32-bit mask for each tile row;
//   2. list: warp a gathers the masks of its row over the halo rows that
//      can reach it, and from their counts summed across the warp writes the
//      halo indices of the sources that land on its row, in halo
//      (row-major) order, into a list of its own: no atomics, no cross-warp
//      scan. A list is sized for the worst case, every source of those rows
//      landing on the warp's row;
//   3. sweep: the warp takes its list 32 entries at a time, one a lane,
//      transposes their column masks the same way, and each lane adds, in
//      list order, the contributions of the entries that hit its column,
//      taken from their lanes by shuffles. A target thus adds the same terms
//      in the same order as a sweep of its whole (2R+2)^2 window in row-major
//      order with fmaf(multiplicity, c, acc) would, the misses left out: the
//      sums are those of that earlier design bit for bit.
// A halo that does not fit the 227 KB of shared memory a block may hold
// (R > 16) is staged in bands of halo rows, one after another, which keeps
// the order; above 48 KB the launch asks for the dynamic shared memory it
// needs. The block masks its own ragged edge, so any N, H and W work; none of
// the Mosaic constraints of the TPU kernel (W % 128, H % 8, halos of 8 rows,
// 128-column pads) carry over. The landing test and x + fx are computed in
// float32, as the JAX package does, so both take the same floors.
//
// Bound on an H100 (N = 1, 256 x 448, DAIN's served frame): bytes. The
// function reads the flow (2 planes) and the depth (1 plane) and writes proj
// (2 planes) and cnt (1 plane): 6 x 4 B x 114,688 pixels = 2.75 MB, 0.82 us at
// 3.35 TB/s. The earlier design swept all 324 sources of each target's window
// (~650 shared loads a target, ~98 % of them on sources landing elsewhere);
// here a warp's list holds ~65 of the 2,401 halo sources at the uniform
// timing flow, and each source is staged by ~2.3 blocks. What is left is
// latency: a frame is 112 blocks on 132 SMs, one block of 32 warps on an SM,
// and each phase is a chain of shared loads and shuffles.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kTileX = 32;
constexpr int kTileY = 32;
constexpr int kThreads = kTileX * kTileY;
static_assert(kTileX == 32 && kTileY <= 32,
              "a lane a tile column, a bit of a 32-bit mask a tile row");
constexpr size_t kMaxSharedBytes = 232448;  // 227 KB a block on sm_90

// Shared memory of a band of `band` halo rows: the sources (float4: first
// the raw flow and depth, then the three contributions and the tile-column
// mask), for each tile row the ballots of the 32-source chunks that land on
// it, then one list of halo indices for each warp.
struct Layout {
  int span, rows, band, chunks, cap;
  __host__ __device__ Layout(int r, int band_rows)
      : span(kTileX + 2 * r + 1), rows(kTileY + 2 * r + 1), band(band_rows),
        chunks((band_rows * (kTileX + 2 * r + 1) + 31) / 32),
        // a list holds at most the sources of 2R + 2 halo rows
        cap((band_rows < 2 * r + 2 ? band_rows : 2 * r + 2) *
            (kTileX + 2 * r + 1)) {}
  __host__ __device__ size_t ballot_offset() const {
    return static_cast<size_t>(chunks) * 32 * sizeof(float4);
  }
  __host__ __device__ size_t list_offset() const {
    return ballot_offset() +
           static_cast<size_t>(kTileY) * chunks * sizeof(unsigned);
  }
  __host__ __device__ size_t bytes() const {
    return list_offset() + static_cast<size_t>(kTileY) * cap * sizeof(uint16_t);
  }
};

// Copy `kBytes` from device memory to shared memory without registers; zeros
// where `valid` is false.
template <int kBytes>
__device__ __forceinline__ void copy_async(void* dst, const void* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d),
               "l"(src), "n"(kBytes), "r"(valid ? kBytes : 0)
               : "memory");
}

// Lane k holds row k of a 32 x 32 bit matrix (bit j: column j); returns
// column `lane` (bit k: row k's bit `lane`). Five butterfly steps, each
// swapping the off-diagonal blocks of a pair of lanes.
__device__ __forceinline__ unsigned transpose32(unsigned x, int lane) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    // the bits j with (j & s) == 0
    const unsigned low = s == 16  ? 0x0000ffffu
                         : s == 8 ? 0x00ff00ffu
                         : s == 4 ? 0x0f0f0f0fu
                         : s == 2 ? 0x33333333u
                                  : 0x55555555u;
    const bool upper = (lane & s) != 0;
    const unsigned keep = upper ? ~low : low;
    const unsigned y = __shfl_xor_sync(0xffffffffu, x, s);
    // the partner's bits that move here, rotated into place
    const unsigned moved = __funnelshift_r(y, y, upper ? s : 32 - s);
    x = (x & keep) | (moved & ~keep);
  }
  return x;
}

// The tile bit of landing row or column v, or 0 where v lies outside the
// window [-R, R+1] of its source s or outside the tile [origin, +extent).
__device__ __forceinline__ unsigned landing_bit(int v, int s, int r,
                                                int origin, int extent) {
  const bool in_window = static_cast<unsigned>(v - s + r) <=
                         static_cast<unsigned>(2 * r + 1);
  const bool in_tile = static_cast<unsigned>(v - origin) <
                       static_cast<unsigned>(extent);
  return in_window && in_tile ? 1u << (v - origin) : 0u;
}

__global__ void __launch_bounds__(kThreads, 1024 / kThreads)
flow_projection_kernel(const float* __restrict__ flow,
                       const float* __restrict__ depth,
                       float* __restrict__ proj, float* __restrict__ cnt,
                       int h, int w, int r, int band) {
  extern __shared__ float4 smem[];
  const Layout lay(r, band);
  unsigned char* const base = reinterpret_cast<unsigned char*>(smem);
  float4* const s_src = smem;
  const int lane = threadIdx.x, row = threadIdx.y;  // target column, tile row
  // s_ballots[a][c]: bit j set where source 32c + j lands on tile row a
  unsigned* const s_ballots =
      reinterpret_cast<unsigned*>(base + lay.ballot_offset());
  uint16_t* const list =
      reinterpret_cast<uint16_t*>(base + lay.list_offset()) + row * lay.cap;

  const int b = blockIdx.z;
  const size_t plane = static_cast<size_t>(h) * w;
  const float2* fb = reinterpret_cast<const float2*>(flow) + b * plane;
  const float* db = depth == nullptr ? nullptr : depth + b * plane;
  const int ty0 = static_cast<int>(blockIdx.y) * kTileY;
  const int tx0 = static_cast<int>(blockIdx.x) * kTileX;
  // the halo's first source: R + 1 rows above and columns left of the tile
  const int y0 = ty0 - r - 1, x0 = tx0 - r - 1;
  const int tid = row * kTileX + lane;
  // a thread's sources are kThreads apart: its first (row, column) in the
  // band and the step between them
  const int first_y = tid / lay.span, first_x = tid % lay.span;
  const int step_y = kThreads / lay.span, step_x = kThreads % lay.span;

  float ax = 0.f, ay = 0.f, ac = 0.f;
  for (int r0 = 0; r0 < lay.rows; r0 += band) {
    const int band_rows = min(band, lay.rows - r0);
    const int count = band_rows * lay.span;

    // 1. stage: copy every source's flow and depth into its slot, all
    // copies in flight at once; a source outside the image gets a zero
    // flow, so it lands outside and fails the landing test below
    for (int i = tid, hy = first_y, hx = first_x; i < count; i += kThreads) {
      const int sy = y0 + r0 + hy, sx = x0 + hx;
      const bool inside = sy >= 0 && sy < h && sx >= 0 && sx < w;
      const size_t p = inside ? static_cast<size_t>(sy) * w + sx : 0;
      copy_async<8>(&s_src[i].x, fb + p, inside);
      if (db != nullptr) copy_async<4>(&s_src[i].z, db + p, inside);
      hy += step_y;
      hx += step_x;
      if (hx >= lay.span) {
        hx -= lay.span;
        ++hy;
      }
    }
    // each thread decides on the slots it copied itself
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    // warp `row` handles chunk i0 / 32 + row of each step: the loop is the
    // same for all lanes of a warp, so that they meet at the ballots
    for (int i0 = 0, hy = first_y, hx = first_x; i0 + row * 32 < count;
         i0 += kThreads) {
      const int i = i0 + tid;
      unsigned rows_hit = 0;
      if (i < count) {
        const float4 raw = s_src[i];
        const int sy = y0 + r0 + hy, sx = x0 + hx;
        const float x2 = static_cast<float>(sx) + raw.x;
        const float y2 = static_cast<float>(sy) + raw.y;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (x2 >= 0.f && y2 >= 0.f && x2 <= static_cast<float>(w - 1) &&
            y2 <= static_cast<float>(h - 1)) {
          const float wv = db == nullptr ? 1.f : raw.z;
          // in range after the landing test, so the clip is a no-op
          const int t = static_cast<int>(floorf(y2));
          const int l = static_cast<int>(floorf(x2));
          const int bt = min(t + 1, h - 1), rt = min(l + 1, w - 1);
          const unsigned cols = landing_bit(l, sx, r, tx0, kTileX) |
                                landing_bit(rt, sx, r, tx0, kTileX);
          if (cols != 0)
            rows_hit = landing_bit(t, sy, r, ty0, kTileY) |
                       landing_bit(bt, sy, r, ty0, kTileY);
          // at the bottom or right edge both neighbours are one cell
          const float mult = (t == bt ? 2.f : 1.f) * (l == rt ? 2.f : 1.f);
          v = make_float4(-raw.x * wv * mult, -raw.y * wv * mult, wv * mult,
                          __uint_as_float(cols));
        }
        s_src[i] = v;
      }
      // the chunk's ballot for each tile row: lane a stores row a's
      const unsigned by_row = transpose32(rows_hit, lane);
      if (lane < kTileY) s_ballots[lane * lay.chunks + i0 / 32 + row] = by_row;
      hy += step_y;
      hx += step_x;
      if (hx >= lay.span) {
        hx -= lay.span;
        ++hy;
      }
    }
    __syncthreads();

    if (ty0 + row < h) {
      // 2. the list: this warp's halo rows row .. row + 2R + 1, those in
      // the band, hold every source that lands on its row; a lane a chunk,
      // the chunks' counts summed across the warp give each its place
      const int lo = max(row - r0, 0) * lay.span;
      const int hi = min(row + 2 * r + 2 - r0, band_rows) * lay.span;
      const unsigned* ballots = s_ballots + row * lay.chunks;
      int n = 0;
      for (int c0 = lo / 32; c0 * 32 < hi; c0 += 32) {
        const int c = c0 + lane;
        unsigned bits = c * 32 < hi ? ballots[c] : 0u;
        const int here = __popc(bits);
        int upto = here;  // in this lane's chunk and those before it
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const int before = __shfl_up_sync(0xffffffffu, upto, d);
          if (lane >= d) upto += before;
        }
        for (int at = n + upto - here; bits != 0; bits &= bits - 1, ++at)
          list[at] = static_cast<uint16_t>(c * 32 + __ffs(bits) - 1);
        n += __shfl_sync(0xffffffffu, upto, 31);
      }
      __syncwarp();

      // 3. the sweep, 32 list entries at a time: lane k loads entry k, the
      // column masks are transposed, and each lane adds the entries that
      // hit its column in list order, taking them from their lanes
      for (int e0 = 0; e0 < n; e0 += 32) {
        const int e = e0 + lane;
        const float4 s = e < n ? s_src[list[e]] : make_float4(0.f, 0.f, 0.f, 0.f);
        unsigned hits = transpose32(__float_as_uint(s.w), lane);
        const int steps = __reduce_max_sync(0xffffffffu, __popc(hits));
        for (int step = 0; step < steps; ++step) {
          const int k = (__ffs(hits) - 1) & 31;  // any lane once none is left
          const float cx = __shfl_sync(0xffffffffu, s.x, k);
          const float cy = __shfl_sync(0xffffffffu, s.y, k);
          const float wv = __shfl_sync(0xffffffffu, s.z, k);
          if (hits != 0) {
            ax += cx;
            ay += cy;
            ac += wv;
            hits &= hits - 1;
          }
        }
      }
    }
    // the next band overwrites the sources
    if (r0 + band < lay.rows) __syncthreads();
  }

  const int ty = ty0 + row, tx = tx0 + lane;
  if (ty >= h || tx >= w) return;
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
  // far past the largest R of which one halo row fits in shared memory
  if (n < 1 || n > 65535 || h < 1 || w < 1 || r < 0 || r > 4096)
    return cudaErrorInvalidValue;
  // the whole halo in one band where it fits, else the most rows that do
  int band = kTileY + 2 * r + 1;
  while (band > 0 && Layout(r, band).bytes() > kMaxSharedBytes) --band;
  if (band == 0) return cudaErrorInvalidValue;
  const size_t smem = Layout(r, band).bytes();
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
      flow, depth, proj, cnt, h, w, r, band);
  return cudaGetLastError();
}
