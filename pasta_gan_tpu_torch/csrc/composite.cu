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
// Design.  The first port of this kernel ran one block per 32x32 output tile
// of one sample and, in each block, every part at every pixel: two IEEE
// divisions and a 4-tap mask sample per (part, pixel), over the 36x36 erosion
// halo for the eroded parts, and the coordinates and taps once more for each
// saturated pixel's image channels. A part's quad covers a small share of the
// frame, so nearly all of that work gave zeros: 0.092 ms at the Full batch-16
// shape, 16 % of its bound. Now one block of 16 warps still takes one 32x32
// tile (1024 blocks at that shape), warp w its strip of rows 2w and 2w + 1,
// and:
//   * Skipping, exact (the TPU kernel's support flags, as math).  Before the
//     part loop, four lanes per (part, strip) (corner_terms,
//     misses_support) map the strip's four corner pixels through the
//     frame->patch homography; when the denominator keeps one sign, well
//     away from 0, at all four, the strip's image is the convex quad of the
//     corner images, and when all four lie beyond one edge of the sample's
//     support (-1, Ws) x (-1, Hs) by more than a bound on the fp32
//     coordinates' rounding (the test's and src_coords'), no pixel of the
//     strip samples the part.  Erosion never makes a pixel outside the
//     support saturated, so the pixels alone (not their halo) decide.  Any
//     other case (a horizon near or across the strip, a non-finite matrix)
//     keeps the part.  The block loops over the parts that reach any of its
//     strips (uniform across the block, so no barrier is skipped by some
//     threads only); a warp samples only the parts that reach its strip.  A
//     skipped or invalid hand part writes 0 into its slot there.  95 % of
//     the valid (part, strip) pairs are skipped on chip_smoke.py's synthetic
//     batch.  ops/warp_kernels.py:composite_live_tiles is the same test in
//     PyTorch.
//   * Winners, then images.  The in-order overwrite leaves, in each group,
//     the image of the last part whose (eroded) mask is saturated at the
//     pixel.  The part loop samples masks only and records that part and its
//     sample coordinates per pixel and group, in registers (an eroded part's
//     coordinates come from its halo pass, kept in shared memory); then each
//     pixel samples the 3 image channels of each group's winner once and
//     writes them.  So no pixel's coordinates are computed twice, image taps
//     are read once per pixel and group, and a part costs one round of
//     dependent loads, not two (the first port's loop sampled the image of
//     every saturated part).
//   * Per part: the mask sampled (bilinear, constant-zero border) in fp32 and
//     thresholded at >= 254.5/255; for parts flagged in erode_bits over the
//     tile plus a 2-pixel halo into shared memory (out-of-frame halo pixels
//     hold 1.0, cv2's +inf erosion border), then a separable 5x5 min; hand
//     parts write their mask straight to their slot.
// A warp covers 32 consecutive pixels of a row, so every store fills a
// whole 128-byte line.  Only the group planes and hand masks reach device
// memory.
//
// What bounds it now (H100 80GB HBM3, 700 W, chip_smoke.py): 0.041 ms at
// the Full batch-16 shape, 35 % of its bound; the same launch with the part
// loop removed (writes and skip tests only) takes 0.021 ms, a memset of its
// outputs 0.020 ms.  The rest is the latency of each block's chain: the
// matrices, the tests, then one round of dependent mask loads per live part
// and one for the images, at 2 blocks of 512 threads an SM (58 registers).
// Holding fewer registers (40, 32) spilled and ran slower, and taking two
// parts a round needed 120.

// Numerics: the mask is computed in fp32 (the TPU kernel's single-bf16
// deficit-form dot is not ported).  Coordinates and blend use explicit
// round-to-nearest intrinsics in the plain PyTorch version's order, so the
// saturation test sees the same value bit for bit.  Non-finite coordinates
// fall outside the frame (zero), as the TPU kernel's squash does.

#include <cuda_runtime.h>

#include "warp_math.cuh"

namespace {

using namespace pasta;

constexpr int TILE = 32;
constexpr int HALO = 2;
constexpr int TH = TILE + 2 * HALO;
constexpr int WARPS = 16;             // blockDim.y: warp w owns rows 2w, 2w + 1 of the tile
constexpr int ROWS = TILE / WARPS;    // its strip of 32 x ROWS pixels, one column a lane
constexpr int THREADS = TILE * WARPS;
constexpr int kMaxParts = 32;

// The skip test of one (part, tile): see the design note.  Four lanes each
// map one corner pixel of the tile through the frame->patch homography
// (explicit rounding, in the order of ops/warp_kernels.py:composite_live_tiles,
// which computes the same decision) and combine their extremes by shuffles.
// The margin covers the rounding of both this test's and src_coords' fp32
// coordinates: each numerator and denominator carries at most ~3 roundings
// of its terms' magnitudes (a, b, e), the division one more; 2^-16 is over
// 30 times the two together.
struct CornerTerms {
  float lo_x, hi_x, lo_y, hi_y, sx_abs, sy_abs, a, b, e, d_min;
  bool pos, neg;
};

__device__ __forceinline__ CornerTerms corner_terms(const float* m, float x, float y) {
  const float p0 = __fmul_rn(m[0], x), p1 = __fmul_rn(m[1], y), p3 = __fmul_rn(m[3], x), p4 = __fmul_rn(m[4], y),
              p6 = __fmul_rn(m[6], x), p7 = __fmul_rn(m[7], y);
  const float nx = __fadd_rn(__fadd_rn(p0, p1), m[2]);
  const float ny = __fadd_rn(__fadd_rn(p3, p4), m[5]);
  const float d = __fadd_rn(__fadd_rn(p6, p7), m[8]);
  const float sx = __fdiv_rn(nx, d), sy = __fdiv_rn(ny, d);
  CornerTerms t;
  t.lo_x = t.hi_x = sx;
  t.lo_y = t.hi_y = sy;
  t.sx_abs = fabsf(sx);
  t.sy_abs = fabsf(sy);
  t.a = __fadd_rn(__fadd_rn(fabsf(p0), fabsf(p1)), fabsf(m[2]));
  t.b = __fadd_rn(__fadd_rn(fabsf(p3), fabsf(p4)), fabsf(m[5]));
  t.e = __fadd_rn(__fadd_rn(fabsf(p6), fabsf(p7)), fabsf(m[8]));
  t.d_min = fabsf(d);
  t.pos = d > 0.f;
  t.neg = d < 0.f;
  return t;
}

// Combine with lane ^ `mask` (all 32 lanes take part).
__device__ __forceinline__ void combine_corners(CornerTerms& t, int mask) {
  const unsigned all = 0xffffffffu;
  t.lo_x = fminf(t.lo_x, __shfl_xor_sync(all, t.lo_x, mask));
  t.hi_x = fmaxf(t.hi_x, __shfl_xor_sync(all, t.hi_x, mask));
  t.lo_y = fminf(t.lo_y, __shfl_xor_sync(all, t.lo_y, mask));
  t.hi_y = fmaxf(t.hi_y, __shfl_xor_sync(all, t.hi_y, mask));
  t.sx_abs = fmaxf(t.sx_abs, __shfl_xor_sync(all, t.sx_abs, mask));
  t.sy_abs = fmaxf(t.sy_abs, __shfl_xor_sync(all, t.sy_abs, mask));
  t.a = fmaxf(t.a, __shfl_xor_sync(all, t.a, mask));
  t.b = fmaxf(t.b, __shfl_xor_sync(all, t.b, mask));
  t.e = fmaxf(t.e, __shfl_xor_sync(all, t.e, mask));
  t.d_min = fminf(t.d_min, __shfl_xor_sync(all, t.d_min, mask));
  t.pos = __shfl_xor_sync(all, (int)t.pos, mask) && t.pos;
  t.neg = __shfl_xor_sync(all, (int)t.neg, mask) && t.neg;
}

// With the four corners combined: true when no pixel of the tile can sample
// the part.  Only a matrix whose terms are finite and whose denominator
// keeps one sign, well away from 0, at the four corners can skip.
__device__ __forceinline__ bool misses_support(const CornerTerms& t, int Hs, int Ws) {
  constexpr float kU = 1.f / 65536.f;
  const float big = 3.4e38f;
  if (!(t.a <= big && t.b <= big && t.e <= big && (t.pos || t.neg) &&
        t.d_min > __fadd_rn(1e-6f, __fmul_rn(kU, t.e))))
    return false;
  const float mx =
      __fadd_rn(__fmul_rn(kU, __fadd_rn(__fdiv_rn(__fadd_rn(t.a, __fmul_rn(t.sx_abs, t.e)), t.d_min), t.sx_abs)),
                1e-5f);
  const float my =
      __fadd_rn(__fmul_rn(kU, __fadd_rn(__fdiv_rn(__fadd_rn(t.b, __fmul_rn(t.sy_abs, t.e)), t.d_min), t.sy_abs)),
                1e-5f);
  return t.hi_x <= __fsub_rn(-1.f, mx) || t.lo_x >= __fadd_rn((float)Ws, mx) || t.hi_y <= __fsub_rn(-1.f, my) ||
         t.lo_y >= __fadd_rn((float)Hs, my);
}

__global__ void __launch_bounds__(THREADS)
composite_kernel(const float* __restrict__ src, const float* __restrict__ minv,
                 const float* __restrict__ valid, float* __restrict__ groups_out,
                 float* __restrict__ hands_out, int N, int Hs, int Ws, int H, int W, int n_groups,
                 unsigned group_bits, unsigned erode_bits, unsigned hand_bits, int n_hands,
                 float thresh) {
  __shared__ float s_sat[TH][TH];
  __shared__ float s_row[TH][TILE];
  __shared__ float s_sx[TILE][TILE], s_sy[TILE][TILE];
  __shared__ float s_m[kMaxParts][9];
  __shared__ float s_valid[kMaxParts];
  __shared__ unsigned s_strip_live[WARPS];  // bit p: part p can reach warp w's strip

  const int b = blockIdx.z;
  const int tx0 = blockIdx.x * TILE, ty0 = blockIdx.y * TILE;
  const int lx = threadIdx.x, w = threadIdx.y;
  const int tid = w * TILE + lx;
  const int gx = tx0 + lx;
  const size_t HW = (size_t)H * W;
  const size_t patch = (size_t)Hs * Ws;

  if (tid < WARPS) s_strip_live[tid] = 0u;
  for (int i = tid; i < 9 * N; i += THREADS) s_m[i / 9][i % 9] = __ldg(minv + (size_t)b * N * 9 + i);
  if (tid < N) s_valid[tid] = valid[b * N + tid];
  __syncthreads();
  // (part, strip) skip tests, 4 lanes each (one corner); every lane of a warp
  // takes part in the shuffles, so the loop runs to a multiple of the block
  const int n_tests = 4 * WARPS * N;
  for (int base = 0; base < n_tests; base += THREADS) {
    const int i = base + tid;
    const int q = i >> 2, c = i & 3;
    const int p = q / WARPS, sw = q - p * WARPS;
    const bool test = i < n_tests;
    const int y0 = ty0 + ROWS * sw;
    const int x1 = min(tx0 + TILE, W) - 1, y1 = min(y0 + ROWS, H) - 1;
    CornerTerms t = corner_terms(s_m[test ? p : 0], (float)((c & 1) ? x1 : tx0), (float)((c & 2) ? y1 : y0));
    combine_corners(t, 1);
    combine_corners(t, 2);
    if (test && c == 0 && y0 < H && s_valid[p] != 0.f && !misses_support(t, Hs, Ws))
      atomicOr(&s_strip_live[sw], 1u << p);
  }
  __syncthreads();
  unsigned live = 0u;  // parts that reach some strip of the tile: uniform across the block
#pragma unroll
  for (int i = 0; i < WARPS; ++i) live |= s_strip_live[i];
  const unsigned mine = s_strip_live[w];  // uniform across the warp

  // hand parts that are invalid or cannot reach this warp's strip: a zero mask
  for (unsigned dead = hand_bits & ~mine; dead; dead &= dead - 1u) {
    const int p = __ffs(dead) - 1;
    const int slot = __popc(hand_bits & ((1u << p) - 1u));
#pragma unroll
    for (int k = 0; k < ROWS; ++k) {
      const int gy = ty0 + ROWS * w + k;
      if (gx < W && gy < H) hands_out[((size_t)b * n_hands + slot) * HW + (size_t)gy * W + gx] = 0.f;
    }
  }

  // Each group's winner at each of the thread's pixels: the last part in order
  // whose (eroded) mask is saturated there, and its sample coordinates.
  int win0[ROWS], win1[ROWS];
  float wx0[ROWS], wy0[ROWS], wx1[ROWS], wy1[ROWS];
#pragma unroll
  for (int k = 0; k < ROWS; ++k) win0[k] = win1[k] = -1;

  for (unsigned todo = live; todo; todo &= todo - 1u) {
    const int p = __ffs(todo) - 1;  // parts in order: a later one wins
    const bool reach = (mine >> p) & 1u;
    const bool hand = (hand_bits >> p) & 1u;
    const bool g1 = (group_bits >> p) & 1u;
    const size_t hand_plane = ((size_t)b * n_hands + __popc(hand_bits & ((1u << p) - 1u))) * HW;
    Homography M;
#pragma unroll
    for (int i = 0; i < 9; ++i) M.m[i] = s_m[p][i];
    const float* mask = src + ((size_t)(b * N + p) * 4 + 3) * patch;

    if ((erode_bits >> p) & 1u) {
      for (int i = tid; i < TH * TH; i += THREADS) {
        const int r = i / TH, c = i - r * TH;
        const int y = ty0 - HALO + r, x = tx0 - HALO + c;
        float s = 1.f;
        if (y >= 0 && y < H && x >= 0 && x < W) {
          float sx, sy;
          src_coords(M, x, y, sx, sy);
          Taps t;
          s = (make_taps(sx, sy, Hs, Ws, t) && sample(mask, t) >= thresh) ? 1.f : 0.f;
          if (r >= HALO && r < HALO + TILE && c >= HALO && c < HALO + TILE) {
            s_sx[r - HALO][c - HALO] = sx;
            s_sy[r - HALO][c - HALO] = sy;
          }
        }
        s_sat[r][c] = s;
      }
      __syncthreads();
      for (int i = tid; i < TH * TILE; i += THREADS) {
        const int r = i / TILE, c = i - r * TILE;
        float mn = s_sat[r][c];
#pragma unroll
        for (int d = 1; d <= 2 * HALO; ++d) mn = fminf(mn, s_sat[r][c + d]);
        s_row[r][c] = mn;
      }
      __syncthreads();
      if (reach) {  // else the strip's masks are 0 before erosion, so after it
#pragma unroll
        for (int k = 0; k < ROWS; ++k) {
          const int ly = ROWS * w + k;
          const int gy = ty0 + ly;
          if (gx >= W || gy >= H) continue;
          float sat = s_row[ly][lx];
#pragma unroll
          for (int d = 1; d <= 2 * HALO; ++d) sat = fminf(sat, s_row[ly + d][lx]);
          if (hand) hands_out[hand_plane + (size_t)gy * W + gx] = sat;
          if (sat == 0.f) continue;
          if (g1) {  // static indices: the winners stay in registers
            win1[k] = p;
            wx1[k] = s_sx[ly][lx];
            wy1[k] = s_sy[ly][lx];
          } else {
            win0[k] = p;
            wx0[k] = s_sx[ly][lx];
            wy0[k] = s_sy[ly][lx];
          }
        }
      }
      __syncthreads();  // the shared arrays are rewritten by the next eroded part
    } else if (reach) {
#pragma unroll
      for (int k = 0; k < ROWS; ++k) {
        const int gy = ty0 + ROWS * w + k;
        if (gx >= W || gy >= H) continue;
        float sx, sy;
        src_coords(M, gx, gy, sx, sy);
        Taps t;
        const bool sat = make_taps(sx, sy, Hs, Ws, t) && sample(mask, t) >= thresh;
        if (hand) hands_out[hand_plane + (size_t)gy * W + gx] = sat ? 1.f : 0.f;
        if (!sat) continue;
        if (g1) {
          win1[k] = p;
          wx1[k] = sx;
          wy1[k] = sy;
        } else {
          win0[k] = p;
          wx0[k] = sx;
          wy0[k] = sy;
        }
      }
    }
  }

  // The image channels of each group's winner, or 0: the value the in-order
  // overwrite leaves.
#pragma unroll
  for (int k = 0; k < ROWS; ++k) {
    const int gy = ty0 + ROWS * w + k;
    if (gx >= W || gy >= H) continue;
    const size_t off = (size_t)gy * W + gx;
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      if (g >= n_groups) break;
      const int wp = g ? win1[k] : win0[k];
      float v[3] = {0.f, 0.f, 0.f};
      Taps t;
      if (wp >= 0 && make_taps(g ? wx1[k] : wx0[k], g ? wy1[k] : wy0[k], Hs, Ws, t)) {  // saturated: inside
        const float* base = src + (size_t)(b * N + wp) * 4 * patch;
#pragma unroll
        for (int c = 0; c < 3; ++c) v[c] = sample(base + c * patch, t);
      }
#pragma unroll
      for (int c = 0; c < 3; ++c) groups_out[((size_t)(b * n_groups + g) * 3 + c) * HW + off] = v[c];
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
  const dim3 block(TILE, WARPS);
  const dim3 grid((W + TILE - 1) / TILE, (H + TILE - 1) / TILE, B);
  composite_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      src, minv, valid, groups_out, hands_out, N, Hs, Ws, H, W, n_groups, group_bits, erode_bits,
      hand_bits, n_hands, thresh);
  return (int)cudaGetLastError();
}
