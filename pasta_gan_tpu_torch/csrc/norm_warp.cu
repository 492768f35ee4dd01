// NORM perspective warp: full frames -> per-part patches (bilinear, replicate border).
//
// Replaces: pasta_gan_tpu/ops/pallas_warp.py:_norm_kernel (entries
//   warp_frame_to_parts_pallas[_batched], called from data/warp.py:_warp_parts).
//
// What bounds it on an H100: bytes.  Per batch-16 try-on the planar patch
// output [16,14,4,64,64] fp32 is 14.68 MB.  The two 256x256x4 fp32 source
// stacks hold 33.6 MB, but the taps reach only the part quads: 5.26 MB of
// 32-byte sectors on the synthetic batch (chip_smoke.py counts them).  The
// arithmetic (~50 flops per output pixel, ~0.9 M pixels) is negligible next to
// that, so the floor is ~20 MB / 3.35 TB/s = 0.0060 ms.
//
// What bounded the first design (one thread per output pixel, a block per
// 256 pixels of one (sample, part), 32 pixels of a row per warp): 0.0187 ms
// (median 0.0181) on an H100 80GB HBM3 at 700 W, 32 % of the bound, where a
// memset of its output takes 0.0093 (scripts/norm_warp_ab.py).  Not its
// 3584 short blocks: the same per-pixel work on one wave of resident blocks,
// several pixels a thread, was slower.  A row of 32 patch pixels is a slanted
// line across the frame, so each warp's load of a tap touched ~19.5 distinct
// 128-byte lines (`scripts/norm_warp_ab.py --model`), and every pixel waited
// on its dependent gathers.
//
// Design: one wave of resident 4-warp blocks (launch.cuh); each warp walks a
// contiguous run of units, a unit being a region of RW columns x 8 rows of
// one (sample, part) plane (RW = 32, or 16 when 32-wide units would leave
// more than half of the resident warps idle), so the homography and gate
// are loaded once per plane a warp meets.  A warp gathers its region in
// passes of a 4 x 8 pixel tile, one pixel a lane, whose taps touch ~5.2
// lines per load instead of ~19.5.  Passes go in steps of 2 (1 at C = 8)
// whose taps are loaded before the previous step is blended: the pipeline
// the registers allow (at most 128 a thread at C = 4, 102 at C = 8).  Each
// pass stages its channels in shared memory, and the region's rows go out as
// whole row segments, one 16-byte store a lane, 8 lanes to a 128-byte row;
// written from registers, a tile row is a 16-byte piece of a 32-byte sector.
// An invalid part (valid == 0) writes zeros without computing coordinates or
// loading taps.  Rows that are not a multiple of 4 wide, or an output that is
// not 16-byte aligned, take the same loop with scalar stores.  Stores are
// plain, not streaming: composite and the routes' channel stacking read the
// patches next, from L2.
//
// What bounds it now: 0.0174 ms (median 0.0174) at the Full batch-16 shape,
// 34 % of the bound and 1.9x the memset of its output (0.0093); 0.0159 after
// a flush that leaves the L2 clean (memset 0.0088) (H100 80GB HBM3, 700 W;
// scripts/norm_warp_ab.py).  Writing the same output without computing
// anything takes 0.0101, the coordinates and blends add 0.0016, one
// dependent gather a pixel 0.0042 and the other three taps 0.0015: the
// gathers' round trips and their traffic through each SM's load/store pipe,
// with the registers allowing one step in flight a warp.  Landing the taps
// in shared memory with cp.async to keep more of them in flight, or staging
// each region's source footprint there (a fifth of the bytes in flight a
// pixel), with or without double buffering across units, was slower.

// Numerics: coordinates and blend use explicit round-to-nearest intrinsics in
// the same order as the plain PyTorch version (warp_math.cuh), then the gate
// multiplies, so the kernel equals `norm_warp_reference` bit for bit.  An
// invalid part gives +0 where the plain version's `sample * 0` gives -0 for a
// negative sample (equal under torch.equal) or NaN for a non-finite one.
// Non-finite coordinates are squashed the TPU kernel's way (clip, NaN -> 0);
// the plain gather version yields NaN there instead.

#include <cuda_runtime.h>

#include <cstdint>

#include "launch.cuh"
#include "warp_math.cuh"

namespace {

using namespace pasta;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 8;  // a warp's unit: RW columns x kRows rows of one plane
// __launch_bounds__ blocks an SM: at most 128 registers a thread at C = 4, 102 at C = 8
template <int G>
constexpr int kMinBlocks = G == 1 ? 4 : 5;
// Passes a pipeline step loads together: 8 float4 taps a lane per step.
template <int G>
constexpr int kStep = 2 / G;

__device__ __forceinline__ float blend(float p00, float p01, float p10, float p11, const Taps& t) {
  return lerp2(lerp2(p00, p01, t.ofx, t.fx), lerp2(p10, p11, t.ofx, t.fx), t.ofy, t.fy);
}

// n / d without the 64-bit division routine when n fits in 32 bits.
__device__ __forceinline__ long long idiv(long long n, int d) {
  return n <= 0xffffffffLL ? (long long)((unsigned)n / (unsigned)d) : n / d;
}

// The taps of passes k .. k + S - 1 of the lane (column x0 + 4 k + px of its
// row, whose terms are rt) and their loads.
template <int G, int S>
__device__ __forceinline__ void tap_step(const Homography& M, const RowTerms& rt, const float4* __restrict__ img,
                                         int x0, int px, int w, int H, int W, int k, Taps (&t)[S],
                                         float4 (&q)[S][G][4]) {
#pragma unroll
  for (int j = 0; j < S; ++j) {
    float sx, sy;
    src_coords_row(M, rt, min(x0 + 4 * (k + j) + px, w - 1), sx, sy);
    make_taps_replicate(sx, sy, H, W, t[j]);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      q[j][g][0] = __ldg(img + t[j].i00 * G + g);
      q[j][g][1] = __ldg(img + t[j].i01 * G + g);
      q[j][g][2] = __ldg(img + t[j].i10 * G + g);
      q[j][g][3] = __ldg(img + t[j].i11 * G + g);
    }
  }
}

// G float4 groups of channels per pixel (C = 4 G).  A plane's units are
// RW x kRows regions, regions_x to a band of kRows rows; unit u is
// region u % units_per_plane (row-major) of plane bp = u / units_per_plane,
// and each warp takes a contiguous run of units.  In pass k lane l computes
// the pixel at column 4 k + l % 4, row l / 4 of the region and stages its
// channels in shared memory; the region's rows then go out as whole row
// segments.  kVec: w % 4 == 0 and `out` 16-byte aligned, so every 4 columns
// from a multiple of 4 are one aligned float4.
template <int G, int RW, bool kVec>
__global__ void __launch_bounds__(kThreads, kMinBlocks<G>)
    norm_warp_kernel(const float4* __restrict__ src0, const float4* __restrict__ src1,
                     const float* __restrict__ minv, const float* __restrict__ valid, float* __restrict__ out,
                     int N, int n0, int H, int W, int h, int w, int regions_x, int units_per_plane,
                     long long units) {
  constexpr int C = 4 * G;
  constexpr int kPasses = RW / 4;  // a pass: 4 columns x 8 rows, one pixel a lane
  constexpr int kPitch = RW + 4;   // staged row pitch (floats): a pass's writes hit 32 banks
  __shared__ __align__(16) float stage[kWarps][C][kRows][kPitch];
  float(*st)[kRows][kPitch] = stage[threadIdx.x >> 5];
  const int lane = threadIdx.x & 31;
  const int px = lane & 3;  // the lane's column within a pass
  const int pr = lane >> 2;  // the lane's row within the region
  const int warp = (blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int warps = gridDim.x * kWarps;
  // warp i takes the units from i q + min(i, rem) on, q + 1 of them if i < rem, else q
  const long long q = idiv(units, warps);
  const int rem = (int)(units - q * warps);
  long long u = warp * q + min(warp, rem);
  const long long last = u + q + (warp < rem);
  if (u >= last) return;
  const int plane = h * w;
  long long bp = idiv(u, units_per_plane);
  const int chunk = (int)(u - bp * units_per_plane);
  int ry = chunk / regions_x;
  int rx = chunk - ry * regions_x;
  long long b = idiv(bp, N);
  int p = (int)(bp - b * N);
  Homography M = load_homography(minv + bp * 9);
  float v = __ldg(valid + bp);
  for (;;) {
    const int x0 = rx * RW;
    const int y0 = ry * kRows;
    if (v != 0.f) {
      const float4* img = (p < n0 ? src0 : src1) + b * H * W * G;
      const RowTerms rt = row_terms(M, min(y0 + pr, h - 1));
      // a software pipeline over steps of S passes: the next step's taps are
      // loaded before this step's blend
      constexpr int S = kStep<G>;
      Taps tc[S];
      float4 qc[S][G][4];
      tap_step<G, S>(M, rt, img, x0, px, w, H, W, 0, tc, qc);
#pragma unroll
      for (int k0 = 0; k0 < kPasses; k0 += S) {
        Taps tn[S];
        float4 qn[S][G][4];
        if (k0 + S < kPasses) tap_step<G, S>(M, rt, img, x0, px, w, H, W, k0 + S, tn, qn);
#pragma unroll
        for (int j = 0; j < S; ++j) {
#pragma unroll
          for (int g = 0; g < G; ++g) {
            float* d = &st[4 * g][pr][4 * (k0 + j) + px];
            const float4* q = qc[j][g];
            d[0 * kRows * kPitch] = __fmul_rn(blend(q[0].x, q[1].x, q[2].x, q[3].x, tc[j]), v);
            d[1 * kRows * kPitch] = __fmul_rn(blend(q[0].y, q[1].y, q[2].y, q[3].y, tc[j]), v);
            d[2 * kRows * kPitch] = __fmul_rn(blend(q[0].z, q[1].z, q[2].z, q[3].z, tc[j]), v);
            d[3 * kRows * kPitch] = __fmul_rn(blend(q[0].w, q[1].w, q[2].w, q[3].w, tc[j]), v);
          }
        }
        if (k0 + S < kPasses) {
#pragma unroll
          for (int j = 0; j < S; ++j) {
            tc[j] = tn[j];
#pragma unroll
            for (int g = 0; g < G; ++g)
#pragma unroll
              for (int i = 0; i < 4; ++i) qc[j][g][i] = qn[j][g][i];
          }
        }
      }
    }
    __syncwarp();
    float* o = out + bp * C * plane;
    if (kVec) {
      // staged row (c, r) is RW / 4 float4s; a store covers 32 / (RW / 4) such rows
      constexpr int Q = RW / 4;
      const int j = lane % Q;
#pragma unroll
      for (int s = 0; s < C * kRows * Q / 32; ++s) {
        const int cr = s * (32 / Q) + lane / Q;  // c * kRows + r
        const int c = cr / kRows, r = cr % kRows;
        const int y = y0 + r, x = x0 + 4 * j;
        if (y < h && x < w) {
          const float4 val = v != 0.f ? *reinterpret_cast<const float4*>(&st[c][r][4 * j])
                                      : make_float4(0.f, 0.f, 0.f, 0.f);
          *reinterpret_cast<float4*>(o + c * plane + y * w + x) = val;
        }
      }
    } else {
      constexpr int R = 32 / RW;  // staged rows a store covers
      const int x = x0 + lane % RW;
#pragma unroll
      for (int s = 0; s < C * kRows / R; ++s) {
        const int cr = s * R + lane / RW;
        const int c = cr / kRows, r = cr % kRows;
        const int y = y0 + r;
        if (y < h && x < w) o[c * plane + y * w + x] = v != 0.f ? st[c][r][lane % RW] : 0.f;
      }
    }
    __syncwarp();
    if (++u == last) break;
    if (++rx == regions_x) {
      rx = 0;
      if (++ry * regions_x == units_per_plane) {
        ry = 0;
        ++bp;
        if (++p == N) {
          p = 0;
          ++b;
        }
        M = load_homography(minv + bp * 9);
        v = __ldg(valid + bp);
      }
    }
  }
}

template <int G, int RW, bool kVec>
int launch(const float4* src0, const float4* src1, const float* minv, const float* valid, float* out, int B, int N,
           int n0, int H, int W, int h, int w, cudaStream_t stream) {
  const int regions_x = (w + RW - 1) / RW;
  const int units_per_plane = regions_x * ((h + kRows - 1) / kRows);
  const long long units = (long long)B * N * units_per_plane;
  if (units == 0) return (int)cudaGetLastError();
  static ResidentWave wave;
  const long long grid = wave.grid(norm_warp_kernel<G, RW, kVec>, kThreads, (units + kWarps - 1) / kWarps);
  norm_warp_kernel<G, RW, kVec><<<(unsigned)grid, kThreads, 0, stream>>>(
      src0, src1, minv, valid, out, N, n0, H, W, h, w, regions_x, units_per_plane, units);
  return (int)cudaGetLastError();
}

// 32-wide regions, or 16-wide ones (twice the units) when the 32-wide ones
// would leave more than half of the resident warps without a unit.
template <int G, bool kVec>
int dispatch(const float4* src0, const float4* src1, const float* minv, const float* valid, float* out, int B,
             int N, int n0, int H, int W, int h, int w, cudaStream_t stream) {
  static ResidentWave wave;
  const long long units32 = (long long)B * N * ((w + 31) / 32) * ((h + kRows - 1) / kRows);
  if (2 * units32 >= wave.resident(norm_warp_kernel<G, 32, kVec>, kThreads) * kWarps)
    return launch<G, 32, kVec>(src0, src1, minv, valid, out, B, N, n0, H, W, h, w, stream);
  return launch<G, 16, kVec>(src0, src1, minv, valid, out, B, N, n0, H, W, h, w, stream);
}

}  // namespace

// src0, src1: [B, H, W, C] fp32 NHWC, C = 4 or 8, 16-byte aligned; minv: [B, N, 9]
// dst->src homographies; valid: [B, N] fp32 gate; out: [B, N, C, h, w] fp32 planar.
// Launches on `stream`, allocates nothing, returns cudaGetLastError()
// (cudaErrorInvalidValue for another C).
extern "C" int pasta_norm_warp_f32(const float* src0, const float* src1, const float* minv,
                                   const float* valid, float* out, int B, int N, int n0, int H,
                                   int W, int h, int w, int C, void* stream) {
  const bool vec = w % 4 == 0 && reinterpret_cast<std::uintptr_t>(out) % 16 == 0;
  const float4* s0 = reinterpret_cast<const float4*>(src0);
  const float4* s1 = reinterpret_cast<const float4*>(src1);
  const cudaStream_t s = (cudaStream_t)stream;
  if (C == 4) {
    return vec ? dispatch<1, true>(s0, s1, minv, valid, out, B, N, n0, H, W, h, w, s)
               : dispatch<1, false>(s0, s1, minv, valid, out, B, N, n0, H, W, h, w, s);
  }
  if (C == 8) {
    return vec ? dispatch<2, true>(s0, s1, minv, valid, out, B, N, n0, H, W, h, w, s)
               : dispatch<2, false>(s0, s1, minv, valid, out, B, N, n0, H, W, h, w, s);
  }
  return (int)cudaErrorInvalidValue;
}
