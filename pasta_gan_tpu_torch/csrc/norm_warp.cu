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
// gather.  One thread per output pixel of one (sample, part); with C = 4 each tap
// is one 16-byte float4 load from the NHWC source, and the planar writes are
// coalesced along x.  Parts p < n0 read src0 (upper source), the rest read src1
// (lower source), so one launch serves both.  The 10 parts of one frame overlap
// in the source, which L2 (50 MB) absorbs.  The part validity gate is folded in.
//
// Numerics: coordinates and blend use explicit round-to-nearest intrinsics in
// the same order as the plain PyTorch version (data/warp.py), so neither
// compiler contraction nor reassociation moves a sample.  Non-finite
// coordinates are squashed the TPU kernel's way (clip, NaN -> 0); the plain
// gather version yields NaN there instead.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float lerp4(float a, float b, float wa, float wb) {
  return __fadd_rn(__fmul_rn(a, wa), __fmul_rn(b, wb));
}

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

  const float* m = minv + (size_t)bp * 9;
  const float gx = (float)x, gy = (float)y;
  float denom = __fadd_rn(__fadd_rn(__fmul_rn(m[6], gx), __fmul_rn(m[7], gy)), m[8]);
  if (fabsf(denom) < 1e-8f) denom = 1e-8f;
  float sx = __fdiv_rn(__fadd_rn(__fadd_rn(__fmul_rn(m[0], gx), __fmul_rn(m[1], gy)), m[2]), denom);
  float sy = __fdiv_rn(__fadd_rn(__fadd_rn(__fmul_rn(m[3], gx), __fmul_rn(m[4], gy)), m[5]), denom);
  // replicate border; fmaxf maps NaN to 0 like the TPU kernel's squash
  sx = fminf(fmaxf(sx, 0.f), (float)(W - 1));
  sy = fminf(fmaxf(sy, 0.f), (float)(H - 1));

  const float x0 = floorf(sx), y0 = floorf(sy);
  const float fx = __fsub_rn(sx, x0), fy = __fsub_rn(sy, y0);
  const float ofx = __fsub_rn(1.f, fx), ofy = __fsub_rn(1.f, fy);
  const int xi = (int)x0, yi = (int)y0;
  const int xj = min(xi + 1, W - 1), yj = min(yi + 1, H - 1);

  const float4* img = (p < n0 ? src0 : src1) + (size_t)b * H * W;
  const float4 p00 = __ldg(img + (size_t)yi * W + xi);
  const float4 p01 = __ldg(img + (size_t)yi * W + xj);
  const float4 p10 = __ldg(img + (size_t)yj * W + xi);
  const float4 p11 = __ldg(img + (size_t)yj * W + xj);
  const float v = valid[bp];

  const size_t plane = (size_t)h * w;
  float* o = out + (size_t)bp * 4 * plane + pix;
  o[0] = __fmul_rn(lerp4(lerp4(p00.x, p01.x, ofx, fx), lerp4(p10.x, p11.x, ofx, fx), ofy, fy), v);
  o[plane] = __fmul_rn(lerp4(lerp4(p00.y, p01.y, ofx, fx), lerp4(p10.y, p11.y, ofx, fx), ofy, fy), v);
  o[2 * plane] = __fmul_rn(lerp4(lerp4(p00.z, p01.z, ofx, fx), lerp4(p10.z, p11.z, ofx, fx), ofy, fy), v);
  o[3 * plane] = __fmul_rn(lerp4(lerp4(p00.w, p01.w, ofx, fx), lerp4(p10.w, p11.w, ofx, fx), ofy, fy), v);
}

}  // namespace

// src0, src1: [B, H, W, 4] fp32 NHWC; minv: [B, N, 9] dst->src homographies;
// valid: [B, N] fp32 gate; out: [B, N, 4, h, w] fp32 planar.
// Launches on `stream`, allocates nothing, returns cudaGetLastError().
extern "C" int pasta_norm_warp_f32(const float* src0, const float* src1, const float* minv,
                                   const float* valid, float* out, int B, int N, int n0, int H,
                                   int W, int h, int w, void* stream) {
  const int threads = 256;
  const dim3 grid((h * w + threads - 1) / threads, B * N);
  norm_warp_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(src0), reinterpret_cast<const float4*>(src1), minv, valid,
      out, N, n0, H, W, h, w);
  return (int)cudaGetLastError();
}
