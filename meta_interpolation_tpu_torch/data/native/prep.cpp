// Native data-preprocessing kernels for the input pipeline.
//
// The reference parallelizes its hot decode/transform loop with torch
// DataLoader worker processes (data/__init__.py:559-567) backed by torch's
// C++ ops. Here the equivalent is a small C++ library driven via ctypes:
// crop + temporal-flip + dtype conversion + per-model normalization + batch
// assembly, multi-threaded over tasks. PNG decode stays in PIL (zlib-bound
// either way); everything after decode runs here.
//
// Layout: input frames are HWC uint8; output is a (B, T, H_c, W_c, 3)
// float32 batch in model input space.
//
// Built by __init__.py: g++ -O3 -march=native -shared -fPIC -pthread, into
// build/native/ at the root of the checkout.

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// Transform one clip: crop at (oy, ox), optional temporal flip, normalize
// (x/255 - mean) / std, write (T, crop_h, crop_w, 3) float32.
void prep_clip(const uint8_t* frames,   // (T, H, W, 3) contiguous
               int t_frames, int height, int width,
               int crop_h, int crop_w, int oy, int ox,
               int temporal_flip,
               const float* mean, const float* std_, float inv255,
               float* out) {
  const int64_t in_frame = (int64_t)height * width * 3;
  const int64_t out_frame = (int64_t)crop_h * crop_w * 3;
  for (int t = 0; t < t_frames; ++t) {
    const int src_t = temporal_flip ? (t_frames - 1 - t) : t;
    const uint8_t* src = frames + src_t * in_frame;
    float* dst = out + t * out_frame;
    for (int y = 0; y < crop_h; ++y) {
      const uint8_t* row = src + ((int64_t)(oy + y) * width + ox) * 3;
      float* orow = dst + (int64_t)y * crop_w * 3;
      for (int x = 0; x < crop_w; ++x) {
        for (int c = 0; c < 3; ++c) {
          orow[x * 3 + c] =
              ((float)row[x * 3 + c] * inv255 - mean[c]) / std_[c];
        }
      }
    }
  }
}

// Batch version: B clips processed across a thread pool. Each clip has its
// own crop offsets / flip flag (augmentation randomness stays in python's
// seeded RNG for reproducibility).
void prep_batch(const uint8_t* frames,  // (B, T, H, W, 3)
                int batch, int t_frames, int height, int width,
                int crop_h, int crop_w,
                const int* oys, const int* oxs, const int* flips,
                const float* mean, const float* std_, float inv255,
                float* out,             // (B, T, crop_h, crop_w, 3)
                int num_threads) {
  const int64_t in_clip = (int64_t)t_frames * height * width * 3;
  const int64_t out_clip = (int64_t)t_frames * crop_h * crop_w * 3;
  if (num_threads < 1) num_threads = 1;
  std::vector<std::thread> pool;
  pool.reserve(num_threads);
  for (int w = 0; w < num_threads; ++w) {
    pool.emplace_back([&, w]() {
      for (int b = w; b < batch; b += num_threads) {
        prep_clip(frames + b * in_clip, t_frames, height, width, crop_h,
                  crop_w, oys[b], oxs[b], flips[b], mean, std_, inv255,
                  out + b * out_clip);
      }
    });
  }
  for (auto& th : pool) th.join();
}

}  // extern "C"
