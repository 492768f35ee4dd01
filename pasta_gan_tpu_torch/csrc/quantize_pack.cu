// The int8 activation of int8 serving, quantized and laid out for the
// convolution in one pass.
//
// Replaces no TPU kernel: on the TPU, XLA fused the quantize into its
// neighbours (`pasta_gan_tpu/ops/quant.py:66 quantize_act`, :113
// `quantize_act_with_scale`) and its s8 convolution took the NHWC tensor as
// it was.  The port keeps activations NCHW, and its int8 convolution
// (`csrc/int8_conv.cu`) reads them NHWC with the channels padded to a
// multiple of 16; four to five plain passes (divide, round, clamp, cast)
// and a permute + pad copy stood between the two.  Wrapper and plain
// version: `pasta_gan_tpu_torch/ops/quant.py` (`quantize_pack`,
// `quantize_pack_reference`).
//
// What it computes: q[n, y, x, c] = clamp(rint(x[n, c, y, x] / s[n]),
// -127, 127) as int8 NHWC [N, H, W, Cp], zeros for C <= c < Cp; x is NCHW
// bf16 or fp32 read as fp32 (exact), the division IEEE (`__fdiv_rn`, as the
// plain `x.float() / s`, not a reciprocal), `rintf` rounding half to even as
// `torch.round` does; s a scalar or one value per sample.
//
// What bounds it: bytes, N*C*H*W*elt read and N*H*W*Cp written, against a
// few operations an element.
//
// Design: a block takes 64 consecutive pixels of one sample (of the H*W
// plane, so rows of any width and ragged ends are the same case) and all
// its channels.  Its threads read channel rows along the pixels with
// 16-byte loads (8 bf16 or 4 fp32 pixels; scalar loads where the plane is
// not 16-byte aligned), quantize, and write the bytes transposed into a
// [64][S] shared tile, S = 16 * (an odd count of 16 bytes) so that the
// pixel rows a warp writes at once spread over the banks (each thread
// rotates the order of its pixels; in bf16 the eight rows hit eight
// banks); then 16-byte pieces of
// the tile go out, which for the block is one contiguous run of 64 * Cp
// bytes of the NHWC tensor.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TP = 64;  // pixels a block
constexpr int THREADS = 256;

__device__ __forceinline__ uint32_t quantize(float v, float s) {
  const float r = fminf(fmaxf(rintf(__fdiv_rn(v, s)), -127.f), 127.f);
  return static_cast<uint32_t>(static_cast<uint8_t>(static_cast<int8_t>(__float2int_rn(r))));
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void __launch_bounds__(THREADS) quantize_pack_kernel(const T* __restrict__ x, const float* __restrict__ s,
                                                                 int s_stride, int8_t* __restrict__ q, int C, int HW,
                                                                 int Cp, int ld, int aligned) {
  constexpr int VEC = 16 / sizeof(T);  // pixels a 16-byte load
  constexpr int GROUPS = TP / VEC;     // loads a channel row
  extern __shared__ __align__(16) int8_t tile[];  // [TP][ld]
  const int n = blockIdx.y, p0 = blockIdx.x * TP;
  const int np = min(TP, HW - p0);
  const float sc = s[n * s_stride];
  const T* xn = x + static_cast<size_t>(n) * C * HW + p0;
  for (int item = threadIdx.x; item < Cp * GROUPS; item += THREADS) {
    const int c = item / GROUPS, g = item - c * GROUPS, x0 = g * VEC;
    uint64_t bytes = 0;  // the VEC quantized pixels, pixel k in byte k
    if (c < C && x0 < np) {
      const T* src = xn + static_cast<size_t>(c) * HW + x0;
      __align__(16) T v[VEC];
      if (aligned && x0 + VEC <= np) {
        *reinterpret_cast<uint4*>(v) = __ldg(reinterpret_cast<const uint4*>(src));
      } else {
#pragma unroll
        for (int k = 0; k < VEC; ++k) v[k] = x0 + k < np ? src[k] : T(0.f);
      }
#pragma unroll
      for (int k = 0; k < VEC; ++k) bytes |= static_cast<uint64_t>(quantize(to_float(v[k]), sc)) << (8 * k);
    }
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const int e = (k + g) & (VEC - 1);
      tile[(x0 + e) * ld + c] = static_cast<int8_t>(bytes >> (8 * e));
    }
  }
  __syncthreads();
  const int pieces = Cp / 16;
  int8_t* qn = q + (static_cast<size_t>(n) * HW + p0) * Cp;
  for (int item = threadIdx.x; item < np * pieces; item += THREADS) {
    const int px = item / pieces, k = item - px * pieces;
    *reinterpret_cast<int4*>(qn + static_cast<size_t>(px) * Cp + k * 16) =
        *reinterpret_cast<const int4*>(tile + px * ld + k * 16);
  }
}

template <typename T>
int launch(const void* x, const void* s, int s_stride, void* q, int N, int C, int HW, int Cp, cudaStream_t stream) {
  const int ld = 16 * ((Cp / 16) | 1);
  const int smem = TP * ld;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(quantize_pack_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 && (static_cast<size_t>(HW) * sizeof(T)) % 16 == 0;
  const dim3 grid((HW + TP - 1) / TP, N);
  quantize_pack_kernel<T><<<grid, THREADS, smem, stream>>>((const T*)x, (const float*)s, s_stride, (int8_t*)q, C, HW,
                                                          Cp, ld, aligned);
  return (int)cudaGetLastError();
}

}  // namespace

// x: bf16 (bf16 != 0) or fp32 [N, C, H*W] (NCHW, contiguous); s: fp32,
// s[n * s_stride] (s_stride 0: one scale); q: int8 [N, H*W, Cp] (NHWC, Cp a
// multiple of 16, 16-byte aligned).
extern "C" int pasta_quantize_pack(const void* x, const void* s, int s_stride, void* q, int bf16, int N, int C,
                                   int HW, int Cp, void* stream) {
  if (Cp % 16 || Cp < C || N > 65535 || reinterpret_cast<uintptr_t>(q) % 16) return (int)cudaErrorInvalidValue;
  if (N == 0 || HW == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  return bf16 ? launch<__nv_bfloat16>(x, s, s_stride, q, N, C, HW, Cp, st)
              : launch<float>(x, s, s_stride, q, N, C, HW, Cp, st);
}
