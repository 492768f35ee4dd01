// Grid sizing shared by the kernels that loop over their work (denorm_warp,
// up2, down2): one wave of resident blocks (the card's SM count times the
// blocks of the kernel that fit on one SM), capped at the blocks the work
// needs; `resident` alone tells a launcher how many blocks the card holds
// (down2 sizes its units from it).  A launcher keeps one ResidentWave per
// kernel (a static local of its template instance), so the occupancy query
// runs once per kernel and device, not on every launch.

#pragma once

#include <cuda_runtime.h>

namespace pasta {

struct ResidentWave {
  static constexpr int kMaxDevices = 64;
  int blocks[kMaxDevices] = {};

  // Blocks of `kernel` that the card holds at once.
  template <typename Kernel>
  long long resident(Kernel kernel, int threads) {
    int dev = 0;
    cudaGetDevice(&dev);
    int wave = dev < kMaxDevices ? blocks[dev] : 0;
    if (wave == 0) {
      int sms = 0, per_sm = 0;
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
      wave = (sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
      if (dev < kMaxDevices) blocks[dev] = wave;
    }
    return wave;
  }

  template <typename Kernel>
  long long grid(Kernel kernel, int threads, long long needed) {
    const long long wave = resident(kernel, threads);
    return needed < wave ? needed : wave;
  }
};

}  // namespace pasta
