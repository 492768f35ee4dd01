// DENORM perspective warp: per-part patches -> full frames (bilinear, constant
// or replicate border), one plane per part.
//
// Replaces: pasta_gan_tpu/ops/pallas_warp.py:_warp_kernel (entry
//   warp_parts_pallas, called from data/warp.py:denorm_warp_parts).  It is the
//   first pass of the separate-pass denorm route (warp every part to a full
//   frame, then saturate, erode and composite in separate passes); the fused
//   route runs composite.cu instead.
//
// What bounds it on an H100: bytes.  Every output plane is written in full.
// At batch 16 on the released-256 route (10 parts, 4 channels) it writes
// [16,10,4,256,256] fp32 = 167.8 MB and reads at most the 10.5 MB of planar
// patches [16,10,4,64,64]: ~178 MB / 3.35 TB/s ~ 53 us.  On the 256 try-on
// route (14 parts) ~250 MB, ~75 us.  The arithmetic (~40 flops per output
// pixel) is far below that.
//
// Design: the TPU kernel built hat matrices and contracted them on the MXU in
// bf16x3, because gathers are slow there, and skipped row tiles outside each
// part's support quad.  On Hopper a gather is cheap: one thread per output
// pixel of one (sample, part) computes the sample coordinates once and takes
// the 4 bilinear taps of each of the C planes (a 64x64x4 fp32 patch is 64 KB,
// so the taps stay in L1/L2).  The writes are coalesced along x.  Most pixels
// fall outside the part's quad and only write zeros, so no row skipping is
// needed for the bound: the zeros have to be written either way.  An invalid
// part (valid == 0) writes an all-zero plane without reading its patch.
//
// Numerics: coordinates and blend use explicit round-to-nearest intrinsics in
// the plain PyTorch version's order (warp_math.cuh), then the gate multiplies,
// so the warp equals `denorm_warp_reference` bit for bit and the saturation test
// after it decides the same.  Non-finite coordinates squash as the TPU kernel
// does: outside (zero) for the constant border, NaN -> 0 for replicate.

#include <cuda_runtime.h>

#include "warp_math.cuh"

namespace {

using namespace pasta;

template <bool kReplicate>
__global__ void denorm_warp_kernel(const float* __restrict__ src, const float* __restrict__ minv,
                                   const float* __restrict__ valid, float* __restrict__ out, int C,
                                   int Hs, int Ws, int H, int W) {
  const int bp = blockIdx.y;  // b * N + p
  const int pix = blockIdx.x * blockDim.x + threadIdx.x;
  if (pix >= H * W) return;
  const int y = pix / W;
  const int x = pix - y * W;
  const size_t HW = (size_t)H * W;
  const size_t patch = (size_t)Hs * Ws;
  float* o = out + (size_t)bp * C * HW + pix;

  const float v = valid[bp];
  Taps t;
  bool inside = false;
  if (v != 0.f) {
    float sx, sy;
    src_coords(load_homography(minv + (size_t)bp * 9), x, y, sx, sy);
    if (kReplicate) {
      make_taps_replicate(sx, sy, Hs, Ws, t);
      inside = true;
    } else {
      inside = make_taps(sx, sy, Hs, Ws, t);
    }
  }
  const float* base = src + (size_t)bp * C * patch;
  for (int c = 0; c < C; ++c) o[c * HW] = inside ? __fmul_rn(sample(base + c * patch, t), v) : 0.f;
}

}  // namespace

// src: [B, N, C, Hs, Ws] fp32 planar patches; minv: [B, N, 9] frame->patch
// homographies; valid: [B, N] fp32 gate; out: [B, N, C, H, W] fp32 planar.
// replicate = 0: constant-zero border, 1: replicate border.
// Launches on `stream`, allocates nothing, returns cudaGetLastError().
extern "C" int pasta_denorm_warp_f32(const float* src, const float* minv, const float* valid,
                                     float* out, int B, int N, int C, int Hs, int Ws, int H,
                                     int W, int replicate, void* stream) {
  const int threads = 256;
  const dim3 grid((H * W + threads - 1) / threads, B * N);
  if (replicate) {
    denorm_warp_kernel<true><<<grid, threads, 0, (cudaStream_t)stream>>>(src, minv, valid, out, C, Hs, Ws, H, W);
  } else {
    denorm_warp_kernel<false><<<grid, threads, 0, (cudaStream_t)stream>>>(src, minv, valid, out, C, Hs, Ws, H, W);
  }
  return (int)cudaGetLastError();
}
