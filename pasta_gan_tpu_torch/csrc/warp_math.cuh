// Device helpers shared by the routing kernels (norm_warp.cu, composite.cu,
// denorm_warp.cu): the perspective sample coordinates and the bilinear taps of
// a planar patch, in the plain PyTorch versions' order of rounded operations
// (ops/warp_math.py:warp_coords, ops/warp_kernels.py).  Explicit
// round-to-nearest intrinsics keep the compiler from contracting or
// reassociating them, so a kernel's sample equals the plain version's bit for
// bit and the 254.5/255 saturation test decides the same on both.
//
// ops/cuda_kernels.py hashes every header here into each library's file name,
// so editing this file rebuilds every kernel that includes it.

#pragma once

#include <cuda_runtime.h>

namespace pasta {

struct Homography {
  float m[9];
};

__device__ __forceinline__ Homography load_homography(const float* __restrict__ minv) {
  Homography M;
#pragma unroll
  for (int i = 0; i < 9; ++i) M.m[i] = __ldg(minv + i);
  return M;
}

__device__ __forceinline__ float lerp2(float a, float b, float wa, float wb) {
  return __fadd_rn(__fmul_rn(a, wa), __fmul_rn(b, wb));
}

// The homography's y-column products for destination row y: the same rounded
// values that src_coords forms at every pixel of the row, so a kernel that
// walks a row computes them once.
struct RowTerms {
  float m1y, m4y, m7y;
};

__device__ __forceinline__ RowTerms row_terms(const Homography& M, int y) {
  const float gy = (float)y;
  return {__fmul_rn(M.m[1], gy), __fmul_rn(M.m[4], gy), __fmul_rn(M.m[7], gy)};
}

// Source coordinates of destination pixel (x, y) under the dst->src homography
// (cv2 convention: integer pixel centres, |denom| < 1e-8 clamped to 1e-8),
// with row y's terms from row_terms.
__device__ __forceinline__ void src_coords_row(const Homography& M, const RowTerms& r, int x, float& sx,
                                               float& sy) {
  const float gx = (float)x;
  const float* m = M.m;
  float denom = __fadd_rn(__fadd_rn(__fmul_rn(m[6], gx), r.m7y), m[8]);
  if (fabsf(denom) < 1e-8f) denom = 1e-8f;
  sx = __fdiv_rn(__fadd_rn(__fadd_rn(__fmul_rn(m[0], gx), r.m1y), m[2]), denom);
  sy = __fdiv_rn(__fadd_rn(__fadd_rn(__fmul_rn(m[3], gx), r.m4y), m[5]), denom);
}

__device__ __forceinline__ void src_coords(const Homography& M, int x, int y, float& sx, float& sy) {
  src_coords_row(M, row_terms(M, y), x, sx, sy);
}

// Bilinear taps of an Hs x Ws plane: flat indices (-1 = a zero tap) and weights.
struct Taps {
  int i00, i01, i10, i11;
  float ofx, fx, ofy, fy;
};

// Constant-zero border.  Returns false when (sx, sy) lies outside
// (-1, Ws) x (-1, Hs) or is not finite: the sample is 0 there.
__device__ __forceinline__ bool make_taps(float sx, float sy, int Hs, int Ws, Taps& t) {
  if (!(sx > -1.f && sx < (float)Ws && sy > -1.f && sy < (float)Hs)) return false;
  const float x0 = floorf(sx), y0 = floorf(sy);
  t.fx = __fsub_rn(sx, x0);
  t.fy = __fsub_rn(sy, y0);
  t.ofx = __fsub_rn(1.f, t.fx);
  t.ofy = __fsub_rn(1.f, t.fy);
  const int xi = (int)x0, yi = (int)y0;
  const bool x0ok = xi >= 0, x1ok = xi + 1 < Ws, y0ok = yi >= 0, y1ok = yi + 1 < Hs;
  t.i00 = (y0ok && x0ok) ? yi * Ws + xi : -1;
  t.i01 = (y0ok && x1ok) ? yi * Ws + xi + 1 : -1;
  t.i10 = (y1ok && x0ok) ? (yi + 1) * Ws + xi : -1;
  t.i11 = (y1ok && x1ok) ? (yi + 1) * Ws + xi + 1 : -1;
  return true;
}

// Replicate border: the coordinates clamp into [0, Ws-1] x [0, Hs-1] (fmaxf
// maps NaN to 0, the TPU kernel's squash) and the +1 taps clamp to the edge.
__device__ __forceinline__ void make_taps_replicate(float sx, float sy, int Hs, int Ws, Taps& t) {
  sx = fminf(fmaxf(sx, 0.f), (float)(Ws - 1));
  sy = fminf(fmaxf(sy, 0.f), (float)(Hs - 1));
  const float x0 = floorf(sx), y0 = floorf(sy);
  t.fx = __fsub_rn(sx, x0);
  t.fy = __fsub_rn(sy, y0);
  t.ofx = __fsub_rn(1.f, t.fx);
  t.ofy = __fsub_rn(1.f, t.fy);
  const int xi = (int)x0, yi = (int)y0;
  const int xj = min(xi + 1, Ws - 1), yj = min(yi + 1, Hs - 1);
  t.i00 = yi * Ws + xi;
  t.i01 = yi * Ws + xj;
  t.i10 = yj * Ws + xi;
  t.i11 = yj * Ws + xj;
}

__device__ __forceinline__ float sample(const float* __restrict__ plane, const Taps& t) {
  const float p00 = t.i00 >= 0 ? __ldg(plane + t.i00) : 0.f;
  const float p01 = t.i01 >= 0 ? __ldg(plane + t.i01) : 0.f;
  const float p10 = t.i10 >= 0 ? __ldg(plane + t.i10) : 0.f;
  const float p11 = t.i11 >= 0 ? __ldg(plane + t.i11) : 0.f;
  return lerp2(lerp2(p00, p01, t.ofx, t.fx), lerp2(p10, p11, t.ofx, t.fx), t.ofy, t.fy);
}

}  // namespace pasta
