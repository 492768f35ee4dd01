// NORM perspective warp: full frames -> per-part patches (bilinear, replicate border).
//
// Replaces: pasta_gan_tpu/ops/pallas_warp.py:_norm_kernel (entries
//   warp_frame_to_parts_pallas[_batched], called from data/warp.py:_warp_parts).
//
// What bounds it on an H100: bytes.  Per batch-16 try-on the planar patch
// output [16,14,4,64,64] fp32 is ~14.7 MB.  The two 256x256x4 fp32 source
// stacks (upper garment, lower garment) hold ~33.6 MB, but the taps reach only
// the part quads: ~5.3 MB of 32-byte sectors on the synthetic batch
// (chip_smoke.py counts them).  The arithmetic (~50 flops per output pixel,
// ~0.9 M pixels) is negligible next to that, so the floor is
// ~20 MB / 3.35 TB/s ~ 6 us.
//
// Design: the TPU kernel contracted hat matrices on the MXU because gathers are
// slow there; on Hopper a gather is cheap, so this is a direct 4-tap bilinear
// gather.  One thread per output pixel of one (sample, part); each tap is one
// 16-byte float4 load per 4 channels of the NHWC source (C = 4: the try-on and
// training routes' image + mask; C = 8: the released-256 route's image +
// mask + stickman + a zero pad), and the planar writes are coalesced along x.
// Parts p < n0 read src0 (the upper or garment source), the rest read src1
// (the lower or person source), so one launch serves both.  The 10 parts of one
// frame overlap in the source, which L2 (50 MB) absorbs.  The part validity
// gate is folded in.
//
// Numerics: coordinates and blend use explicit round-to-nearest intrinsics in
// the same order as the plain PyTorch version (warp_math.cuh), so neither
// compiler contraction nor reassociation moves a sample.  Non-finite
// coordinates are squashed the TPU kernel's way (clip, NaN -> 0); the plain
// gather version yields NaN there instead.

#include <cuda_runtime.h>

#include "warp_math.cuh"

namespace {

using namespace pasta;

__device__ __forceinline__ float blend(float p00, float p01, float p10, float p11, const Taps& t) {
  return lerp2(lerp2(p00, p01, t.ofx, t.fx), lerp2(p10, p11, t.ofx, t.fx), t.ofy, t.fy);
}

// G float4 groups of channels per pixel (C = 4 G).
template <int G>
__global__ void norm_warp_kernel(const float4* __restrict__ src0, const float4* __restrict__ src1,
                                 const float* __restrict__ minv, const float* __restrict__ valid,
                                 float* __restrict__ out, int N, int n0, int H, int W, int h, int w) {
  const int bp = blockIdx.y;  // b * N + p
  const int b = bp / N;
  const int p = bp - b * N;
  const int pix = blockIdx.x * blockDim.x + threadIdx.x;
  if (pix >= h * w) return;
  const int y = pix / w;
  const int x = pix - y * w;

  float sx, sy;
  src_coords(load_homography(minv + (size_t)bp * 9), x, y, sx, sy);
  Taps t;
  make_taps_replicate(sx, sy, H, W, t);

  const float4* img = (p < n0 ? src0 : src1) + (size_t)b * H * W * G;
  const float v = valid[bp];
  const size_t plane = (size_t)h * w;
  float* o = out + (size_t)bp * 4 * G * plane + pix;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const float4 p00 = __ldg(img + (size_t)t.i00 * G + g);
    const float4 p01 = __ldg(img + (size_t)t.i01 * G + g);
    const float4 p10 = __ldg(img + (size_t)t.i10 * G + g);
    const float4 p11 = __ldg(img + (size_t)t.i11 * G + g);
    float* og = o + (size_t)4 * g * plane;
    og[0] = __fmul_rn(blend(p00.x, p01.x, p10.x, p11.x, t), v);
    og[plane] = __fmul_rn(blend(p00.y, p01.y, p10.y, p11.y, t), v);
    og[2 * plane] = __fmul_rn(blend(p00.z, p01.z, p10.z, p11.z, t), v);
    og[3 * plane] = __fmul_rn(blend(p00.w, p01.w, p10.w, p11.w, t), v);
  }
}

}  // namespace

// src0, src1: [B, H, W, C] fp32 NHWC, C = 4 or 8; minv: [B, N, 9] dst->src
// homographies; valid: [B, N] fp32 gate; out: [B, N, C, h, w] fp32 planar.
// Launches on `stream`, allocates nothing, returns cudaGetLastError()
// (cudaErrorInvalidValue for another C).
extern "C" int pasta_norm_warp_f32(const float* src0, const float* src1, const float* minv,
                                   const float* valid, float* out, int B, int N, int n0, int H,
                                   int W, int h, int w, int C, void* stream) {
  const int threads = 256;
  const dim3 grid((h * w + threads - 1) / threads, B * N);
  const float4* s0 = reinterpret_cast<const float4*>(src0);
  const float4* s1 = reinterpret_cast<const float4*>(src1);
  if (C == 4) {
    norm_warp_kernel<1><<<grid, threads, 0, (cudaStream_t)stream>>>(s0, s1, minv, valid, out, N, n0, H, W, h, w);
  } else if (C == 8) {
    norm_warp_kernel<2><<<grid, threads, 0, (cudaStream_t)stream>>>(s0, s1, minv, valid, out, N, n0, H, W, h, w);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
