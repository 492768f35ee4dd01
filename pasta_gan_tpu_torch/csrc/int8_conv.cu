// int8 implicit-GEMM convolution with the dequant fused into its epilogue.
//
// Stands where XLA's s8 x s8 -> s32 `conv_general_dilated` stood in the JAX
// package's int8 serving (`pasta_gan_tpu/ops/quant.py:int8_conv_like`, :131);
// the JAX package has no Pallas kernel for it.  Wrapper and plain version:
// `pasta_gan_tpu_torch/ops/quant.py` (`int8_conv`, `int8_conv_reference`).
//
// What it computes: out[n, o, oy, ox] = dequant(sum over (ky, kx, c) of
// xq[n, c, iy, ix] * wq[o, c, ky, kx]) over an int8 activation and an int8
// OIHW weight, with stride S (1 or 2), input (lhs) dilation D (1 or 2,
// stride 1) and any zero padding; the accumulator is a 32-bit integer.  The
// epilogue is JAX's: the accumulator is emitted as the output type
// (s32 -> f32, then -> bf16 for a bf16 output, each round to nearest even),
// multiplied in fp32 by scale = sx[n] * sw[o] (that product rounded first),
// and written NCHW as fp32 or bf16.
//
// What bounds it: int8 multiply-adds.  A 3x3 conv at 512 channels does 4608
// of them per output for a few bytes moved, far above the card's ridge point
// (1979 TOP/s int8 against 3.35 TB/s), so the bound is operations and the
// tensor cores have to do them.
//
// Design: an implicit GEMM, M = output pixels, N = output channels, K =
// (valid tap, channel).  The wrapper lays the activation out NHWC with the
// channels padded to a multiple of 16 and packs the weight [phase][O][K]
// (K a multiple of 64, zeros past the taps), so every 16-byte piece of K is
// 16 channels of one tap of one pixel: one `cp.async` of 16 bytes, zero-filled
// outside the input; no im2col is written to memory.  A block computes 128
// pixels x 128 channels with 8 warps of 32 x 64, in K steps of 64 bytes held
// twice in shared memory (the next step's copies fly while the tensor cores
// work on this one), read with `ldmatrix` from rows whose 16-byte pieces are
// XOR-swizzled so that the reads do not conflict, and multiplied with
// `mma.sync.m16n8k32` s8 x s8 -> s32.  Input dilation: output pixels are
// split by phase (oy mod D, ox mod D), one phase per blockIdx.z; within a
// phase the same taps land on real input for every pixel, so the wrapper lists
// only those taps (with their input offsets dy, dx) and packs only their
// weights: a tap that lands on an inserted zero is skipped, not multiplied (9
// of the folded 6x6 up-conv's 36).  `wgmma` with TMA staging is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;       // output pixels per block
constexpr int BN = 128;       // output channels per block
constexpr int BK = 64;        // K bytes per step
constexpr int THREADS = 256;  // 8 warps: 4 along M x 2 along N, each 32 x 64
constexpr int MAX_TAPS = 64;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; `bytes` 0 writes zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4], unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// byte offset of 16-byte piece `q` (0..3) of row `row` in a [rows][64] tile
__device__ __forceinline__ int swz(int row, int q) { return row * BK + ((q ^ ((row >> 1) & 3)) << 4); }

__global__ void __launch_bounds__(THREADS) int8_conv_kernel(
    const int8_t* __restrict__ x, const int8_t* __restrict__ w, const int* __restrict__ taps,
    const int* __restrict__ ntaps, const float* __restrict__ sx, int sx_stride,
    const float* __restrict__ sw, void* __restrict__ out, int bf16, int N, int Cp, int H, int W, int O,
    int Ho, int Wo, int S, int D, int Kp, int Tmax) {
  __shared__ __align__(128) int8_t As[2][BM * BK];
  __shared__ __align__(128) int8_t Bs[2][BN * BK];
  __shared__ int s_dy[MAX_TAPS], s_dx[MAX_TAPS];

  const int p = blockIdx.z, py = p / D, px = p % D;
  const int Hp = (Ho - py + D - 1) / D, Wp = (Wo - px + D - 1) / D;
  const int HWp = Hp * Wp, Mp = N * HWp;
  const int m0 = blockIdx.x * BM;
  if (m0 >= Mp) return;  // the phase has fewer pixels than phase 0 (block-uniform)
  const int o0 = blockIdx.y * BN;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nT = ntaps[p];
  for (int t = tid; t < nT; t += THREADS) {
    s_dy[t] = taps[2 * (p * Tmax + t)];
    s_dx[t] = taps[2 * (p * Tmax + t) + 1];
  }
  __syncthreads();

  // loading role: row lr of the A tile (pixel m0 + lr) and of the B tile
  // (channel o0 + lr), 16-byte pieces lq and lq + 1 of each 64-byte step
  const int lr = tid >> 1, lq = (tid & 1) * 2;
  const int m = m0 + lr;
  const bool mvalid = m < Mp;
  int n = 0, iy0 = 0, ix0 = 0;
  if (mvalid) {
    n = m / HWp;
    const int r = m - n * HWp, i = r / Wp;
    iy0 = i * S;
    ix0 = (r - i * Wp) * S;
  }
  const int8_t* xn = x + (size_t)n * H * W * Cp;
  const bool ovalid = o0 + lr < O;
  const int8_t* wrow = w + ((size_t)p * O + (ovalid ? o0 + lr : 0)) * Kp;
  const int nk = (nT * Cp + BK - 1) / BK;

  auto load = [&](int kt, int buf) {
#pragma unroll
    for (int q = lq; q < lq + 2; ++q) {
      const int kb = kt * BK + q * 16;  // first K byte of the piece
      const int j = kb / Cp;
      const int8_t* src = x;
      int bytes = 0;
      if (mvalid && j < nT) {
        const int iy = iy0 + s_dy[j], ix = ix0 + s_dx[j];
        if (iy >= 0 && iy < H && ix >= 0 && ix < W) {
          src = xn + ((size_t)iy * W + ix) * Cp + (kb - j * Cp);
          bytes = 16;
        }
      }
      cp_async16(&As[buf][swz(lr, q)], src, bytes);
      cp_async16(&Bs[buf][swz(lr, q)], ovalid ? wrow + kb : w, ovalid ? 16 : 0);
    }
  };

  // computing role: warp rows wm .. wm + 31, columns wn .. wn + 63
  const int wm = (warp & 3) * 32, wn = (warp >> 2) * 64;
  int acc[2][8][4];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 8; ++b)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][b][c] = 0;

  load(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) {
      load(kt + 1, (kt + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int8_t* At = As[kt & 1];
    const int8_t* Bt = Bs[kt & 1];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {  // two k32 steps of the 64-byte tile
      unsigned a[2][4], b[4][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)  // lanes 0-7, 8-15, 16-23, 24-31: rows 0-7 / 8-15 of k 0-15, then of k 16-31
        ldmatrix_x4(a[mi], At + swz(wm + mi * 16 + (lane & 7) + ((lane >> 3) & 1) * 8, kk * 2 + (lane >> 4)));
#pragma unroll
      for (int nj = 0; nj < 4; ++nj)  // channels nj*16 .. +7 (k 0-15, 16-31), then +8 .. +15
        ldmatrix_x4(b[nj], Bt + swz(wn + nj * 16 + (lane & 7) + (lane >> 4) * 8, kk * 2 + ((lane >> 3) & 1)));
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 8; ++ni)
          mma_s8(acc[mi][ni], a[mi], b[ni >> 1][(ni & 1) * 2], b[ni >> 1][(ni & 1) * 2 + 1]);
    }
    __syncthreads();
  }

  // accumulator c of tile (mi, ni): pixel wm + mi*16 + lane/4 (+8 for c >= 2),
  // channel wn + ni*8 + (lane%4)*2 + c%2
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int mm = m0 + wm + mi * 16 + (lane >> 2) + h * 8;
      if (mm >= Mp) continue;
      const int nn = mm / HWp, r = mm - nn * HWp, i = r / Wp;
      const int oy = py + D * i, ox = px + D * (r - i * Wp);
      const float sxn = sx[nn * sx_stride];
      const size_t base = ((size_t)nn * O * Ho + oy) * Wo + ox;
#pragma unroll
      for (int ni = 0; ni < 8; ++ni)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int o = o0 + wn + ni * 8 + (lane & 3) * 2 + e;
          if (o >= O) continue;
          float f = __int2float_rn(acc[mi][ni][h * 2 + e]);
          const float sc = __fmul_rn(sxn, sw[o]);
          const size_t idx = base + (size_t)o * Ho * Wo;
          if (bf16) {
            f = __bfloat162float(__float2bfloat16_rn(f));
            reinterpret_cast<__nv_bfloat16*>(out)[idx] = __float2bfloat16_rn(__fmul_rn(f, sc));
          } else {
            reinterpret_cast<float*>(out)[idx] = __fmul_rn(f, sc);
          }
        }
    }
}

}  // namespace

// x: int8 [N, H, W, Cp] (NHWC, Cp a multiple of 16, zero channels past C);
// w: int8 [D*D, O, Kp] (the phase's valid taps in order, Cp channels each,
// zeros past them; Kp a multiple of 64); taps: int32 [D*D, Tmax, 2] (dy, dx)
// of each phase's valid taps; ntaps: int32 [D*D]; sx: fp32, sx[n * sx_stride];
// sw: fp32 [O]; out: fp32 or bf16 [N, O, Ho, Wo].
extern "C" int pasta_int8_conv(const void* x, const void* w, const void* taps, const void* ntaps,
                               const void* sx, int sx_stride, const void* sw, void* out, int bf16, int N,
                               int Cp, int H, int W, int O, int Ho, int Wo, int S, int D, int Kp, int Tmax,
                               void* stream) {
  if (Tmax > MAX_TAPS || D < 1 || S < 1 || Cp % 16 || Kp % BK) return (int)cudaErrorInvalidValue;
  const long long m_phase0 = (long long)N * ((Ho + D - 1) / D) * ((Wo + D - 1) / D);
  const dim3 grid((unsigned)((m_phase0 + BM - 1) / BM), (unsigned)((O + BN - 1) / BN), (unsigned)(D * D));
  int8_conv_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const int8_t*)x, (const int8_t*)w, (const int*)taps, (const int*)ntaps, (const float*)sx, sx_stride,
      (const float*)sw, out, bf16, N, Cp, H, W, O, Ho, Wo, S, D, Kp, Tmax);
  return (int)cudaGetLastError();
}
