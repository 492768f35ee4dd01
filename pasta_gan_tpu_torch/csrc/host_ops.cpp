// Host-side perspective warp of the host routing path
// (pasta_gan_tpu_torch/data/host_router.py), the same function as the JAX
// package's native `warp_perspective_f32` (pasta_gan_tpu/native/host_ops.cpp):
// cv2.warpPerspective semantics, double-precision sample coordinates, float32
// bilinear blend, rows split over std::threads.  Built as a plain shared
// object with the JAX build's flags and bound with ctypes, which releases the
// interpreter lock for the call.
//
// Images are float32 HWC, row-major.

#include <algorithm>
#include <cmath>
#include <cstddef>
#include <thread>
#include <vector>

extern "C" {

// Bilinear perspective warp.
//   src: [src_h, src_w, ch], dst: [dst_h, dst_w, ch]
//   M: 3x3 row-major src -> dst (cv2's convention; inverted here)
//   border: 0 = constant 0, 1 = replicate
void warp_perspective_f32(const float* src, int src_h, int src_w, int ch,
                          float* dst, int dst_h, int dst_w, const double* M,
                          int border) {
  double a = M[0], b = M[1], c = M[2], d = M[3], e = M[4], f = M[5], g = M[6],
         h = M[7], i = M[8];
  double det = a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g);
  if (std::abs(det) < 1e-12) det = 1e-12;
  double inv[9] = {
      (e * i - f * h) / det, (c * h - b * i) / det, (b * f - c * e) / det,
      (f * g - d * i) / det, (a * i - c * g) / det, (c * d - a * f) / det,
      (d * h - e * g) / det, (b * g - a * h) / det, (a * e - b * d) / det};

  auto row_task = [&](int y0, int y1) {
    for (int y = y0; y < y1; ++y) {
      for (int x = 0; x < dst_w; ++x) {
        double denom = inv[6] * x + inv[7] * y + inv[8];
        if (std::abs(denom) < 1e-12) denom = 1e-12;
        double sx = (inv[0] * x + inv[1] * y + inv[2]) / denom;
        double sy = (inv[3] * x + inv[4] * y + inv[5]) / denom;
        int x0 = (int)std::floor(sx), y0i = (int)std::floor(sy);
        float fx = (float)(sx - x0), fy = (float)(sy - y0i);
        float* out = dst + ((size_t)y * dst_w + x) * ch;
        for (int k = 0; k < ch; ++k) {
          float v[4];
          for (int n = 0; n < 4; ++n) {
            int yy = y0i + n / 2, xx = x0 + n % 2;
            bool inside = (yy >= 0 && yy < src_h && xx >= 0 && xx < src_w);
            if (!inside && border == 0) {
              v[n] = 0.0f;
            } else {
              int yc = std::min(std::max(yy, 0), src_h - 1);
              int xc = std::min(std::max(xx, 0), src_w - 1);
              v[n] = src[((size_t)yc * src_w + xc) * ch + k];
            }
          }
          float top = v[0] * (1 - fx) + v[1] * fx;
          float bot = v[2] * (1 - fx) + v[3] * fx;
          out[k] = top * (1 - fy) + bot * fy;
        }
      }
    }
  };

  int n_threads = std::min((int)std::thread::hardware_concurrency(),
                           std::max(1, dst_h / 64));
  if (n_threads <= 1) {
    row_task(0, dst_h);
    return;
  }
  std::vector<std::thread> threads;
  int chunk = (dst_h + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    int y0 = t * chunk, y1 = std::min(dst_h, y0 + chunk);
    if (y0 < y1) threads.emplace_back(row_task, y0, y1);
  }
  for (auto& th : threads) th.join();
}

}  // extern "C"
