// DENORM perspective warp: per-part patches -> full frames (bilinear, constant
// or replicate border), one plane per part.
//
// Replaces: pasta_gan_tpu/ops/pallas_warp.py:_warp_kernel (entry
//   warp_parts_pallas, called from data/warp.py:denorm_warp_parts).  It is the
//   first pass of the separate-pass denorm route (warp every part to a full
//   frame, then saturate, erode and composite in separate passes); the fused
//   route runs composite.cu instead.
//
// What bounds it on an H100: bytes written, in principle.  Every output
// plane is written in full, zeros included.  At batch 16 on the released-256
// route (10 parts, 4 channels) it writes [16,10,4,256,256] fp32 = 167.8 MB
// and reads the ~10 MB of patch sectors its taps touch: ~178 MB / 3.35 TB/s
// ~ 53 us.  Measured on an H100 80GB HBM3 (700 W) it takes ~0.093 ms where a
// memset of the same output takes ~0.056 ms, so what is left is the
// per-pixel work the stores wait on: two IEEE divisions and the tap
// arithmetic for every pixel, zeros included, at 64 registers a thread (half
// the SM's threads resident).
//
// Design: each thread takes 4 adjacent pixels of one row of one (sample,
// part) and writes each channel plane's 4 values as one 16-byte store, so a
// warp stores 512 contiguous bytes per instruction (one thread per pixel and
// four 4-byte stores lost to grid_sample).  The homography is loaded once
// per 256 x 4-pixel tile, and the row's y-column products once per thread
// (row_terms: the same rounded products, so the arithmetic is unchanged).  A
// block loops over tiles (tile, tile + gridDim.x, ...) and the grid is one
// wave of resident blocks (launch.cuh): no storm of short-lived blocks.
// __launch_bounds__(256, 4) caps a thread at 64 registers; more registers
// (fewer resident blocks), two or four quads per tile, or the taps of four
// channels loaded together measured slower.  Stores are streaming (__stcs,
// evict-first), a few percent faster than plain ones: the 168 MB output does
// not stay in the 50 MB L2 for the threshold pass either way.  An invalid
// part (valid == 0) writes zeros without computing coordinates.  A frame
// whose width is not a multiple of 4 (its rows are not 16-byte aligned)
// takes the same loop with scalar stores and a ragged last quad.  No tile
// skipping: it would be exact only with a proof for every homography (a
// horizon may cross the frame), and the zeros are written either way.
//
// Numerics: coordinates and blend use explicit round-to-nearest intrinsics in
// the plain PyTorch version's order (warp_math.cuh), then the gate multiplies,
// so the warp equals `denorm_warp_reference` bit for bit and the saturation test
// after it decides the same.  Non-finite coordinates squash as the TPU kernel
// does: outside (zero) for the constant border, NaN -> 0 for replicate.

#include <cuda_runtime.h>

#include <cstdint>

#include "launch.cuh"
#include "warp_math.cuh"

namespace {

using namespace pasta;

constexpr int kThreads = 256;
constexpr int kPix = 4;          // adjacent pixels of one row per thread
constexpr int kMinBlocks = 4;    // __launch_bounds__: at most 64 registers a thread

// Tile t covers quads [chunk * kThreads, (chunk + 1) * kThreads) of plane
// bp = t / tiles_per_plane, chunk = t % tiles_per_plane; quad q is pixels
// 4 (q % quads_per_row) .. + 3 of row q / quads_per_row.  kVec: W % 4 == 0 and
// `out` 16-byte aligned, so every quad is one aligned float4 per channel.
template <bool kReplicate, bool kVec>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    denorm_warp_kernel(const float* __restrict__ src, const float* __restrict__ minv,
                       const float* __restrict__ valid, float* __restrict__ out, int C, int Hs, int Ws, int H,
                       int W, int quads_per_row, int tiles_per_plane, long long tiles) {
  const long long HW = (long long)H * W;
  const long long patch = (long long)Hs * Ws;
  const int quads = H * quads_per_row;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long bp = tile / tiles_per_plane;  // b * N + p
    const int q = (int)(tile - bp * tiles_per_plane) * kThreads + threadIdx.x;
    if (q >= quads) continue;
    const int y = q / quads_per_row;
    const int x0 = (q - y * quads_per_row) * kPix;
    const float v = __ldg(valid + bp);
    Taps t[kPix];
    bool inside[kPix];
    if (v != 0.f) {
      const Homography M = load_homography(minv + bp * 9);
      const RowTerms rt = row_terms(M, y);
#pragma unroll
      for (int k = 0; k < kPix; ++k) {
        float sx, sy;
        src_coords_row(M, rt, x0 + k, sx, sy);
        if (kReplicate) {
          make_taps_replicate(sx, sy, Hs, Ws, t[k]);
          inside[k] = true;
        } else {
          inside[k] = make_taps(sx, sy, Hs, Ws, t[k]);
        }
      }
    } else {
#pragma unroll
      for (int k = 0; k < kPix; ++k) inside[k] = false;
    }
    const float* plane = src + bp * C * patch;
    float* o = out + bp * C * HW + (long long)y * W + x0;
    for (int c = 0; c < C; ++c, plane += patch, o += HW) {
      float s[kPix];
#pragma unroll
      for (int k = 0; k < kPix; ++k) s[k] = inside[k] ? __fmul_rn(sample(plane, t[k]), v) : 0.f;
      if (kVec) {
        __stcs(reinterpret_cast<float4*>(o), make_float4(s[0], s[1], s[2], s[3]));
      } else {
#pragma unroll
        for (int k = 0; k < kPix; ++k)
          if (x0 + k < W) o[k] = s[k];
      }
    }
  }
}

template <bool kReplicate, bool kVec>
int launch(const float* src, const float* minv, const float* valid, float* out, int B, int N, int C, int Hs,
           int Ws, int H, int W, cudaStream_t stream) {
  const int quads_per_row = (W + kPix - 1) / kPix;
  const int tiles_per_plane = (H * quads_per_row + kThreads - 1) / kThreads;
  const long long tiles = (long long)B * N * tiles_per_plane;
  if (tiles == 0) return (int)cudaGetLastError();
  static ResidentWave wave;
  const long long grid = wave.grid(denorm_warp_kernel<kReplicate, kVec>, kThreads, tiles);
  denorm_warp_kernel<kReplicate, kVec><<<(unsigned)grid, kThreads, 0, stream>>>(
      src, minv, valid, out, C, Hs, Ws, H, W, quads_per_row, tiles_per_plane, tiles);
  return (int)cudaGetLastError();
}

}  // namespace

// src: [B, N, C, Hs, Ws] fp32 planar patches; minv: [B, N, 9] frame->patch
// homographies; valid: [B, N] fp32 gate; out: [B, N, C, H, W] fp32 planar.
// replicate = 0: constant-zero border, 1: replicate border.
// Launches on `stream`, allocates nothing, returns cudaGetLastError().
extern "C" int pasta_denorm_warp_f32(const float* src, const float* minv, const float* valid, float* out, int B,
                                     int N, int C, int Hs, int Ws, int H, int W, int replicate, void* stream) {
  const bool vec = W % kPix == 0 && reinterpret_cast<std::uintptr_t>(out) % 16 == 0;
  const cudaStream_t s = (cudaStream_t)stream;
  if (replicate) {
    return vec ? launch<true, true>(src, minv, valid, out, B, N, C, Hs, Ws, H, W, s)
               : launch<true, false>(src, minv, valid, out, B, N, C, Hs, Ws, H, W, s);
  }
  return vec ? launch<false, true>(src, minv, valid, out, B, N, C, Hs, Ws, H, W, s)
             : launch<false, false>(src, minv, valid, out, B, N, C, Hs, Ws, H, W, s);
}
