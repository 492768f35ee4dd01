// 2x upsample and 2x downsample with the separable [1,3,3,1] FIR, NCHW,
// fp32 or bf16 in and out, fp32 arithmetic, one rounding at the store.
//
// Replaces: pasta_gan_tpu/ops/pallas_upfirdn.py:_up2_kernel (entry
//   upsample2x_pallas) and :_down2_kernel (entry downsample2x_pallas).
//
// Per axis, with zeros outside the input:
//   up2   y[2u]   = 1/4 x[u-1] + 3/4 x[u]      (pad (2,1), gain 2 per axis)
//         y[2u+1] = 3/4 x[u]   + 1/4 x[u+1]
//         `extend` = 1 adds the outputs at index -1 and 2L (the up-conv's
//         pre-FIR, padding (3,2)); the output is 2L + 2*extend long.
//   down2 y[u] = 1/8 x[2u-p] + 3/8 x[2u+1-p] + 3/8 x[2u+2-p] + 1/8 x[2u+3-p],
//         p = `pad` (1: downsample2d and the 1x1 down-conv; 0: the adjoint of
//         the extended up2); the output is L/2 + pad - 1 long.
// Both are scaled by `gain` at the end.  Each is the other's adjoint:
// up2(extend)^T = 4 down2(pad = 1 - extend), down2(pad)^T = 1/4 up2(extend =
// 1 - pad) in 2-D, which is how ops/upfirdn_kernels.py differentiates them.
//
// What bounds it on an H100: bytes.  Each output needs 2 (up) or 4 (down)
// taps per axis and ~10 or ~40 flops, far below the card's ~20 flops per
// byte at fp32.  At the training path's largest shapes (up2 pre-FIR
// [16,128,128,128] bf16 -> [16,128,258,258]: 67 MB read + 273 MB written;
// down2 [32,64,256,256] bf16 -> [32,64,128,128]: 268 MB + 67 MB) the floor is
// ~0.10 ms at 3.35 TB/s.
//
// Design: one thread per output pixel (down2) or output pair (up2) of one
// (n, c) plane; a block covers a run of one output row, so the stores are
// coalesced and the neighbouring threads' overlapping taps come from L1.
// The taps are read straight from device memory, each input byte once from
// DRAM.  Each block loops over a
// share of the planes (grid_for).  The TPU kernel's DMA of row halos,
// sublane padding and stack-temporary interleave have no counterpart here.
//
// Numerics: the vertical pass, then the horizontal one, then the gain, each
// product and sum rounded to nearest (no FMA contraction), in the order of
// the plain PyTorch version (up2_reference / down2_reference), so both agree
// bit for bit in fp32 and, after the one bf16 rounding, in bf16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

template <typename T>
__device__ __forceinline__ float load(const T* p);
template <>
__device__ __forceinline__ float load<float>(const float* p) {
  return __ldg(p);
}
template <>
__device__ __forceinline__ float load<__nv_bfloat16>(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename T>
__device__ __forceinline__ void store(T* p, float v);
template <>
__device__ __forceinline__ void store<float>(float* p, float v) {
  *p = v;
}
template <>
__device__ __forceinline__ void store<__nv_bfloat16>(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float mac(float acc, float v, float w) {
  return __fadd_rn(acc, __fmul_rn(v, w));
}

// One axis of up2: output o reads taps i0 and i0 + 1 with weights w0, w1.
struct UpTaps {
  int i0;
  float w0, w1;
};

__device__ __forceinline__ UpTaps up_taps(int o, int extend) {
  const int j = o - extend;       // index in the unextended output, -1 .. 2L
  const int odd = j & 1;          // two's complement: j = -1 is odd
  const int u = (j - odd) / 2;    // exact: j - odd is even
  UpTaps t;
  t.i0 = u - 1 + odd;
  t.w0 = odd ? 0.75f : 0.25f;
  t.w1 = odd ? 0.25f : 0.75f;
  return t;
}

template <typename T>
__device__ __forceinline__ void store_pair(T* p, float a, float b);
template <>
__device__ __forceinline__ void store_pair<float>(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
template <>
__device__ __forceinline__ void store_pair<__nv_bfloat16>(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Each thread writes the output pair (2t, 2t + 1) of one row: both read
// input columns among t - 1, t, t + 1, so the pair costs 6 loads, not 8, and
// one 4- or 8-byte store (Wo is even, so the pair is aligned).
template <typename T>
__global__ void up2_kernel(const T* __restrict__ x, T* __restrict__ y, long long planes, int H, int W,
                           int extend, float gain) {
  const int Ho = 2 * H + 2 * extend, Wo = 2 * W + 2 * extend;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int oy = blockIdx.y;
  if (2 * t >= Wo) return;
  const UpTaps ty = up_taps(oy, extend), tx0 = up_taps(2 * t, extend), tx1 = up_taps(2 * t + 1, extend);
  const int y0 = ty.i0, y1 = ty.i0 + 1;
  const bool ry0 = y0 >= 0 && y0 < H, ry1 = y1 >= 0 && y1 < H;
  bool rc[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) rc[k] = t - 1 + k >= 0 && t - 1 + k < W;
  // output 2t reads columns t - 1 and t; output 2t + 1 reads t, t + 1
  // (extend 0) or t - 1, t (extend 1)
  const bool shift = tx1.i0 == t;
  const long long in_plane = (long long)H * W, out_plane = (long long)Ho * Wo;
#pragma unroll 4
  for (long long p = blockIdx.z; p < planes; p += gridDim.z) {
    const T* r0 = x + p * in_plane + (long long)y0 * W + (t - 1);
    const T* r1 = x + p * in_plane + (long long)y1 * W + (t - 1);
    float v[3];  // vertical pass at columns t - 1, t, t + 1
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float a0 = (ry0 && rc[k]) ? load(r0 + k) : 0.f;
      const float a1 = (ry1 && rc[k]) ? load(r1 + k) : 0.f;
      v[k] = mac(__fmul_rn(a0, ty.w0), a1, ty.w1);
    }
    const float h0 = mac(__fmul_rn(v[0], tx0.w0), v[1], tx0.w1);
    const float h1 = mac(__fmul_rn(shift ? v[1] : v[0], tx1.w0), shift ? v[2] : v[1], tx1.w1);
    store_pair(y + p * out_plane + (long long)oy * Wo + 2 * t, __fmul_rn(h0, gain), __fmul_rn(h1, gain));
  }
}

template <typename T>
__global__ void down2_kernel(const T* __restrict__ x, T* __restrict__ y, long long planes, int H, int W,
                             int pad, float gain) {
  const int Ho = H / 2 + pad - 1, Wo = W / 2 + pad - 1;
  const int ox = blockIdx.x * blockDim.x + threadIdx.x;
  const int oy = blockIdx.y;
  if (ox >= Wo) return;
  const float w[4] = {0.125f, 0.375f, 0.375f, 0.125f};
  const int iy = 2 * oy - pad, ix = 2 * ox - pad;
  const long long in_plane = (long long)H * W, out_plane = (long long)Ho * Wo;
#pragma unroll 2
  for (long long p = blockIdx.z; p < planes; p += gridDim.z) {
    const T* xp = x + p * in_plane;
    float h = 0.f;
#pragma unroll
    for (int kx = 0; kx < 4; ++kx) {
      const int xx = ix + kx;
      const bool rx = xx >= 0 && xx < W;
      float v = 0.f;
#pragma unroll
      for (int ky = 0; ky < 4; ++ky) {
        const int yy = iy + ky;
        const float a = (rx && yy >= 0 && yy < H) ? load(xp + (long long)yy * W + xx) : 0.f;
        v = ky == 0 ? __fmul_rn(a, w[0]) : mac(v, a, w[ky]);
      }
      h = kx == 0 ? __fmul_rn(v, w[0]) : mac(h, v, w[kx]);
    }
    store(y + p * out_plane + (long long)oy * Wo + ox, __fmul_rn(h, gain));
  }
}

// Blocks of a multiple of 32 threads that cover an output row with the least
// idle threads (at most 256 a block); the grid's z covers the planes, and
// each block loops over planes (z, z + gridDim.z, ...) so that ~8k blocks
// run in all: one short-lived block per (row, plane) spends more time being
// scheduled than working.
int threads_for(int Wo) {
  const int nblk = (Wo + 255) / 256;
  return 32 * ((Wo + 32 * nblk - 1) / (32 * nblk));
}

dim3 grid_for(long long planes, int Ho, int Wo, int threads) {
  const long long per_plane = (long long)((Wo + threads - 1) / threads) * Ho;
  long long z = (8192 + per_plane - 1) / per_plane;
  if (z > planes) z = planes;
  if (z > 65535) z = 65535;
  return dim3((Wo + threads - 1) / threads, Ho, (unsigned)z);
}

}  // namespace

// x: [planes, H, W] contiguous (planes = N * C); y: [planes, 2H + 2 extend,
// 2W + 2 extend]; bf16 != 0 selects __nv_bfloat16 for both, else float.
// Launches on `stream`, allocates nothing, returns cudaGetLastError().
extern "C" int pasta_up2(const void* x, void* y, int bf16, long long planes, int H, int W, int extend,
                         float gain, void* stream) {
  const int Ho = 2 * H + 2 * extend, Wo = 2 * W + 2 * extend;
  const int threads = threads_for(Wo / 2);  // one thread per output pair
  const dim3 grid = grid_for(planes, Ho, Wo / 2, threads);
  const cudaStream_t s = (cudaStream_t)stream;
  if (bf16) {
    up2_kernel<__nv_bfloat16><<<grid, threads, 0, s>>>((const __nv_bfloat16*)x, (__nv_bfloat16*)y, planes, H,
                                                       W, extend, gain);
  } else {
    up2_kernel<float><<<grid, threads, 0, s>>>((const float*)x, (float*)y, planes, H, W, extend, gain);
  }
  return (int)cudaGetLastError();
}

// x: [planes, H, W] with H, W even; y: [planes, H/2 + pad - 1, W/2 + pad - 1].
extern "C" int pasta_down2(const void* x, void* y, int bf16, long long planes, int H, int W, int pad,
                           float gain, void* stream) {
  const int Ho = H / 2 + pad - 1, Wo = W / 2 + pad - 1;
  const int threads = threads_for(Wo);
  const dim3 grid = grid_for(planes, Ho, Wo, threads);
  const cudaStream_t s = (cudaStream_t)stream;
  if (bf16) {
    down2_kernel<__nv_bfloat16><<<grid, threads, 0, s>>>((const __nv_bfloat16*)x, (__nv_bfloat16*)y, planes,
                                                         H, W, pad, gain);
  } else {
    down2_kernel<float><<<grid, threads, 0, s>>>((const float*)x, (float*)y, planes, H, W, pad, gain);
  }
  return (int)cudaGetLastError();
}
