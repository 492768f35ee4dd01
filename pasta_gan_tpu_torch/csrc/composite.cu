// DENORM + saturate + erode + sequential composite of the routed part patches.
//
// Replaces: pasta_gan_tpu/ops/pallas_warp.py:_composite_kernel (entry
//   warp_parts_composite_pallas, called from data/warp.py:_composite_denorm).
//
// What bounds it on an H100: bytes.  Per batch-16 try-on it writes only the
// two composited group planes [16,2,3,256,256] (~25.2 MB) and the hand masks
// [16,4,256,256] (~16.8 MB), and must read of the planar patches
// [16,14,4,64,64] fp32 (~14.7 MB) only the mask taps inside each part's quad and
// the image taps where the part wins its pixel: ~5.8 MB of 32-byte sectors on
// the synthetic batch (chip_smoke.py counts them).  ~48 MB, ~14 us at
// 3.35 TB/s.  The separate-pass pipeline it fuses would also write and re-read
// the 14 full-frame 4-channel warps (~235 MB).
//
// Design: one block per 32x32 output tile of one sample; the 14 parts are a
// loop inside the block (the TPU kernel's sequential grid becomes that loop,
// since later parts overwrite earlier ones).  Per part:
//   * the mask channel is sampled (bilinear, constant-zero border) in fp32 at the
//     tile plus a 2-pixel halo and thresholded at >= 254.5/255 into shared
//     memory; out-of-frame halo pixels hold 1.0, cv2's +inf erosion border;
//   * parts flagged in erode_bits take a separable 5x5 min (rows, then columns);
//   * the 3 image channels are sampled only where the mask is saturated and
//     overwrite that part's group accumulator, held in registers;
//   * hand parts write their mask straight to their output slot.
// Invalid parts (valid == 0) contribute nothing and leave a zero hand mask.
// Only the group planes and hand masks reach device memory.
//
// Numerics: the mask is computed in fp32 (the TPU kernel's single-bf16
// deficit-form dot is not ported).  Coordinates and blend use explicit
// round-to-nearest intrinsics in the plain PyTorch version's order, so the
// saturation test sees the same value bit for bit.  Non-finite coordinates
// fall outside the frame (zero), as the TPU kernel's squash does.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 32;
constexpr int HALO = 2;
constexpr int TH = TILE + 2 * HALO;
constexpr int BY = 8;  // blockDim.y; each thread owns TILE / BY rows of one column
constexpr int ROWS = TILE / BY;

struct Homography {
  float m[9];
};

__device__ __forceinline__ float lerp2(float a, float b, float wa, float wb) {
  return __fadd_rn(__fmul_rn(a, wa), __fmul_rn(b, wb));
}

__device__ __forceinline__ void src_coords(const Homography& M, int x, int y, float& sx, float& sy) {
  const float gx = (float)x, gy = (float)y;
  const float* m = M.m;
  float denom = __fadd_rn(__fadd_rn(__fmul_rn(m[6], gx), __fmul_rn(m[7], gy)), m[8]);
  if (fabsf(denom) < 1e-8f) denom = 1e-8f;
  sx = __fdiv_rn(__fadd_rn(__fadd_rn(__fmul_rn(m[0], gx), __fmul_rn(m[1], gy)), m[2]), denom);
  sy = __fdiv_rn(__fadd_rn(__fadd_rn(__fmul_rn(m[3], gx), __fmul_rn(m[4], gy)), m[5]), denom);
}

// Bilinear taps of planar channels with a constant-zero border.  Returns false
// when (sx, sy) lies outside (-1, Ws) x (-1, Hs) or is not finite.
struct Taps {
  int i00, i01, i10, i11;  // -1 = zero tap
  float ofx, fx, ofy, fy;
};

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

__device__ __forceinline__ float sample(const float* __restrict__ plane, const Taps& t) {
  const float p00 = t.i00 >= 0 ? __ldg(plane + t.i00) : 0.f;
  const float p01 = t.i01 >= 0 ? __ldg(plane + t.i01) : 0.f;
  const float p10 = t.i10 >= 0 ? __ldg(plane + t.i10) : 0.f;
  const float p11 = t.i11 >= 0 ? __ldg(plane + t.i11) : 0.f;
  return lerp2(lerp2(p00, p01, t.ofx, t.fx), lerp2(p10, p11, t.ofx, t.fx), t.ofy, t.fy);
}

__global__ void __launch_bounds__(TILE * BY)
composite_kernel(const float* __restrict__ src, const float* __restrict__ minv,
                 const float* __restrict__ valid, float* __restrict__ groups_out,
                 float* __restrict__ hands_out, int N, int Hs, int Ws, int H, int W, int n_groups,
                 unsigned group_bits, unsigned erode_bits, unsigned hand_bits, int n_hands,
                 float thresh) {
  __shared__ float s_sat[TH][TH];
  __shared__ float s_row[TH][TILE];

  const int b = blockIdx.z;
  const int tx0 = blockIdx.x * TILE, ty0 = blockIdx.y * TILE;
  const int lx = threadIdx.x;
  const int tid = threadIdx.y * TILE + lx;
  const int gx = tx0 + lx;
  const size_t HW = (size_t)H * W;
  const size_t patch = (size_t)Hs * Ws;

  float acc0[3][ROWS], acc1[3][ROWS];
#pragma unroll
  for (int c = 0; c < 3; ++c)
#pragma unroll
    for (int k = 0; k < ROWS; ++k) acc0[c][k] = acc1[c][k] = 0.f;

  for (int p = 0; p < N; ++p) {
    const int bp = b * N + p;
    const bool hand = (hand_bits >> p) & 1u;
    const int slot = __popc(hand_bits & ((1u << p) - 1u));
    if (valid[bp] == 0.f) {
      if (hand) {
#pragma unroll
        for (int k = 0; k < ROWS; ++k) {
          const int gy = ty0 + threadIdx.y + BY * k;
          if (gx < W && gy < H) hands_out[((size_t)b * n_hands + slot) * HW + (size_t)gy * W + gx] = 0.f;
        }
      }
      continue;  // uniform across the block: no barrier is skipped by some threads only
    }
    Homography M;
#pragma unroll
    for (int i = 0; i < 9; ++i) M.m[i] = __ldg(minv + (size_t)bp * 9 + i);
    const float* base = src + (size_t)bp * 4 * patch;
    const float* mask = base + 3 * patch;

    float sat[ROWS];
    if ((erode_bits >> p) & 1u) {
      for (int i = tid; i < TH * TH; i += TILE * BY) {
        const int r = i / TH, c = i - r * TH;
        const int y = ty0 - HALO + r, x = tx0 - HALO + c;
        float s = 1.f;
        if (y >= 0 && y < H && x >= 0 && x < W) {
          float sx, sy;
          src_coords(M, x, y, sx, sy);
          Taps t;
          s = (make_taps(sx, sy, Hs, Ws, t) && sample(mask, t) >= thresh) ? 1.f : 0.f;
        }
        s_sat[r][c] = s;
      }
      __syncthreads();
      for (int i = tid; i < TH * TILE; i += TILE * BY) {
        const int r = i / TILE, c = i - r * TILE;
        float mn = s_sat[r][c];
#pragma unroll
        for (int d = 1; d <= 2 * HALO; ++d) mn = fminf(mn, s_sat[r][c + d]);
        s_row[r][c] = mn;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < ROWS; ++k) {
        const int ly = threadIdx.y + BY * k;
        float mn = s_row[ly][lx];
#pragma unroll
        for (int d = 1; d <= 2 * HALO; ++d) mn = fminf(mn, s_row[ly + d][lx]);
        sat[k] = mn;
      }
      __syncthreads();  // s_sat / s_row are rewritten by the next eroded part
    } else {
#pragma unroll
      for (int k = 0; k < ROWS; ++k) {
        const int gy = ty0 + threadIdx.y + BY * k;
        float s = 0.f;
        if (gx < W && gy < H) {
          float sx, sy;
          src_coords(M, gx, gy, sx, sy);
          Taps t;
          s = (make_taps(sx, sy, Hs, Ws, t) && sample(mask, t) >= thresh) ? 1.f : 0.f;
        }
        sat[k] = s;
      }
    }

    const bool g1 = (group_bits >> p) & 1u;
#pragma unroll
    for (int k = 0; k < ROWS; ++k) {
      const int gy = ty0 + threadIdx.y + BY * k;
      if (gx >= W || gy >= H) continue;
      if (hand) hands_out[((size_t)b * n_hands + slot) * HW + (size_t)gy * W + gx] = sat[k];
      if (sat[k] == 0.f) continue;
      float sx, sy;
      src_coords(M, gx, gy, sx, sy);
      Taps t;
      if (!make_taps(sx, sy, Hs, Ws, t)) continue;  // unreachable: sat implies inside
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float v = sample(base + c * patch, t);
        if (g1) acc1[c][k] = v; else acc0[c][k] = v;
      }
    }
  }

#pragma unroll
  for (int k = 0; k < ROWS; ++k) {
    const int gy = ty0 + threadIdx.y + BY * k;
    if (gx >= W || gy >= H) continue;
    const size_t off = (size_t)gy * W + gx;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      groups_out[((size_t)b * n_groups * 3 + c) * HW + off] = acc0[c][k];
      if (n_groups > 1) groups_out[((size_t)(b * n_groups + 1) * 3 + c) * HW + off] = acc1[c][k];
    }
  }
}

}  // namespace

// src: [B, N, 4, Hs, Ws] fp32 planar patches (mask last); minv: [B, N, 9]
// frame->patch homographies; valid: [B, N] fp32; groups_out: [B, n_groups, 3, H, W];
// hands_out: [B, n_hands, H, W] (may be null when hand_bits == 0).
// Bit p of group_bits puts part p in group 1 (else 0), of erode_bits erodes its
// mask, of hand_bits emits its mask in the next hand slot (slots in part order).
// Launches on `stream`, allocates nothing, returns cudaGetLastError().
extern "C" int pasta_composite_f32(const float* src, const float* minv, const float* valid,
                                   float* groups_out, float* hands_out, int B, int N, int Hs,
                                   int Ws, int H, int W, int n_groups, unsigned group_bits,
                                   unsigned erode_bits, unsigned hand_bits, int n_hands,
                                   float thresh, void* stream) {
  const dim3 block(TILE, BY);
  const dim3 grid((W + TILE - 1) / TILE, (H + TILE - 1) / TILE, B);
  composite_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      src, minv, valid, groups_out, hands_out, N, Hs, Ws, H, W, n_groups, group_bits, erode_bits,
      hand_bits, n_hands, thresh);
  return (int)cudaGetLastError();
}
