// int8 implicit-GEMM convolution with the dequant fused into its epilogue,
// on Hopper's warpgroup MMA (`wgmma`) fed by TMA and a gathering producer.
//
// Stands where XLA's s8 x s8 -> s32 `conv_general_dilated` stood in the JAX
// package's int8 serving (`pasta_gan_tpu/ops/quant.py:int8_conv_like`, :131);
// the JAX package has no Pallas kernel for it.  Wrapper and plain version:
// `pasta_gan_tpu_torch/ops/quant.py` (`int8_conv`, `int8_conv_packed`,
// `int8_conv_reference`).
//
// What it computes: out[n, o, oy, ox] = dequant(sum over (ky, kx, c) of
// xq[n, c, iy, ix] * wq[o, c, ky, kx]) over an int8 activation and an int8
// OIHW weight, with stride S (1 or 2), input (lhs) dilation D (1 or 2,
// stride 1) and any zero padding; the accumulator is a 32-bit integer.  The
// epilogue is JAX's: the accumulator is emitted as the output type
// (s32 -> f32, then -> bf16 for a bf16 output, each round to nearest even),
// multiplied in fp32 by scale = sx[n] * sw[o] (that product rounded first),
// and written NCHW as fp32 or bf16.  The integer sum is exact in any order,
// so the kernel is bit-exact with the plain version.
//
// What bounds it: the 3x3 and folded 6x6 classes are bound by int8
// operations (a 3x3 conv at 128 channels does 1152 multiply-adds an output
// for a few bytes moved, far above the card's ridge of 1979 TOP/s over
// 3.35 TB/s); most 1x1 classes, the 64-channel classes and the 3- and
// 6-channel entry convs by bytes (the bf16 output is 2 bytes for every
// output and the int8 input 1 for every input, against few operations).
// Below those bounds the kernel meets two walls of its own: the operand
// traffic from L2 (an implicit GEMM reads each input pixel once per tap)
// and the epilogue (the NCHW output leaves one channel plane at a time).
//
// Design: an implicit GEMM, M = output pixels, N = output channels, K =
// (valid tap, channel).  The activation is NHWC with its channels padded to
// a multiple of 16 (`csrc/quantize_pack.cu` writes it so) and the weight is
// packed [phase][O][Kp] (Kp a multiple of 128, zeros past the taps), so every
// 16-byte piece of K is 16 channels of one tap of one pixel.
// * The tensor cores: `wgmma.mma_async` m64nBNk32 s8 x s8 -> s32, both
//   operands K-major in shared memory (the only layout 8-bit `wgmma` takes;
//   NHWC and [O][Kp] already are), in K steps of BK = 128 bytes whose rows
//   carry the 128-byte swizzle, or of 64 bytes in the 64-byte swizzle where
//   the channels come in 64s.  BN follows O: 64 for the 64-channel classes,
//   128, or 256 above, so that no half of the MMA idles at O = 64.  A tile
//   is BM pixels x BN channels, BM = 128 (64 at BN = 256): 128 accumulators
//   a thread.
// * The weight tile comes by TMA (a 2-D tensor map over [P*O, Kp]).
// * The activation tile comes by TMA too where it is a box of the input: at
//   stride 1 with Cp a multiple of BK a K step is BK channels of one tap,
//   and a tile of whole rows (or part of one) of a power-of-two output grid
//   is, for each tap, a box of the NHWC input shifted by the tap's offset
//   (a 4-D tensor map; its zero fill outside the input is the padding, and
//   the input-dilation phases, whose pixels step through the input one by
//   one, qualify).  Elsewhere (stride 2, 16- to 48-channel or odd channel
//   counts, rows that do not tile) a producer warpgroup gathers it with
//   16-byte `cp.async` (zero-fill outside the input), BK / 16 lanes to a
//   pixel's K step so that a warp reads whole rows of it,
//   through a table of the tile's pixels built once a tile in shared memory;
//   each thread's copies arrive on the stage's `full` mbarrier when they
//   land (`cp.async.mbarrier.arrive.noinc`).  The tiled mode rather than
//   TMA's im2col mode: one tiled tensor map serves every tap and every
//   input-dilation phase through the tap table's offsets.
// * A ring of stages with `full`/`empty` mbarriers in place of block
//   barriers; `setmaxnreg` moves registers from the producer to the
//   consumers; a consumer keeps one `wgmma` group in flight while it waits
//   for the next stage.
// * A persistent grid of one block per SM walks over (phase, pixel tile,
//   channel tile), channel tiles of one pixel tile next to each other.  Its
//   two consumer warpgroups take the tiles in turn (ping-pong): one runs
//   its epilogue while the other's MMAs run, an `order` mbarrier pair
//   letting a warpgroup wait on its stages only once the other is done
//   with its own.
// * The epilogue stages a tile's results through shared memory channel-
//   major, 64 channels a pass, so that a warp writes 128 consecutive pixels
//   of one output channel (256 bytes in bf16) in one store instruction.
// Input dilation: output pixels are split by phase (oy mod D, ox mod D);
// within a phase the same taps land on real input for every pixel, so the
// wrapper lists only those taps (with their input offsets dy, dx) and packs
// only their weights: a tap that lands on an inserted zero is skipped, not
// multiplied (27 of the folded 6x6 up-conv's 36 taps in each phase).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 384;     // warpgroup 0 produces, 1 and 2 consume
constexpr int MAX_TAPS = 64;
constexpr int MAX_PHASES = 4;
constexpr int EPI_COLS = 64;     // channels per epilogue pass
constexpr int PRODUCER_REGS = 56, CONSUMER_REGS = 224;

// BK: the K bytes of a stage, one swizzled row (128, or 64 where the channels come in 64s)
template <int BN, int BK>
struct Cfg {
  static constexpr int BM = BN == 256 ? 64 : 128;  // output pixels per tile, each tile one consumer warpgroup's
  static constexpr int MI = BM / 64;               // 64-row MMA blocks per tile
  static constexpr int STAGES = BK == 64 ? (BN == 256 ? 6 : 8) : (BN == 64 ? 5 : 4);
  static constexpr int A_BYTES = BM * BK;
  static constexpr int B_BYTES = BN * BK;
  static constexpr int B_OFF = STAGES * A_BYTES;
  static constexpr int EPI_OFF = B_OFF + STAGES * B_BYTES;
  static constexpr int BAR_OFF = EPI_OFF + 2 * EPI_COLS * (BM + 4) * 4;
  static constexpr int PIX_OFF = BAR_OFF + 2 * STAGES * 8 + 16;
  static constexpr int TAP_OFF = PIX_OFF + BM * 16;
  static constexpr int NT_OFF = TAP_OFF + MAX_PHASES * MAX_TAPS * 8;
  static constexpr int SMEM = NT_OFF + MAX_PHASES * 4 + 1024;  // + the slack of aligning the base to 1024
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// wait until the phase of parity `parity` of the barrier has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}

// 16 bytes global -> shared, asynchronously; `bytes` 0 writes zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(bytes) : "memory");
}

// one arrival on `bar` once every earlier cp.async of this thread has landed
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(
          dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, int c0, int c1, int c2, int c3,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], "
      "[%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// shared-memory matrix descriptor of a K-major tile of BK-byte rows in the BK-byte swizzle, 8-row groups
// 8 BK bytes apart; +2 moves it 32 bytes along K
template <int BK>
__device__ __forceinline__ uint64_t sw_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(8 * BK >> 4) << 32) | (static_cast<uint64_t>(BK == 128 ? 1 : 2) << 62);
}

// byte offset of 16-byte piece q of row r in a BK-byte-swizzled tile
template <int BK>
__device__ __forceinline__ uint32_t swizzled(int r, int q) {
  return r * BK + ((q ^ (BK == 128 ? r & 7 : (r >> 1) & 3)) << 4);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving accumulator accesses across an asynchronous wgmma
template <int R>
__device__ __forceinline__ void fence_acc(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

__device__ __forceinline__ void wgmma_n64(int (&d)[32], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n128(int (&d)[64], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n256(int (&d)[128], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(a), "l"(b), "r"(scale_d));
}


template <int BN>
__device__ __forceinline__ void mma(int (&d)[BN / 2], uint64_t a, uint64_t b) {
  if constexpr (BN == 64) {
    wgmma_n64(d, a, b, 1);
  } else if constexpr (BN == 128) {
    wgmma_n128(d, a, b, 1);
  } else {
    wgmma_n256(d, a, b, 1);
  }
}

// tile t -> (phase p, pixel tile mt within it, channel tile nt) and the phase's Hp x Wp
template <int BM>
__device__ __forceinline__ void decode_tile(int t, int nN, int N, int Ho, int Wo, int D, int& p, int& mt, int& nt,
                                            int& Hp, int& Wp) {
  nt = t % nN;
  mt = t / nN;
  for (p = 0; p < D * D; ++p) {
    Hp = (Ho - p / D + D - 1) / D;
    Wp = (Wo - p % D + D - 1) / D;
    const int tiles = (N * Hp * Wp + BM - 1) / BM;
    if (mt < tiles) return;
    mt -= tiles;
  }
}

// The epilogue of one tile (its MI 64-row MMA blocks, rows m0 .. m0 + 64 MI - 1 of phase (py, px)) by its
// consumer warpgroup, 64 channels a pass through `stg`: the accumulator emitted as the output type, times
// sx[n] * sw[o], written NCHW, a warp writing 64 MI consecutive pixels of one channel at a time.
template <int BN, int MI>
__device__ __forceinline__ void store_tile(const int (&acc)[MI][BN / 2], float* stg, int bar, int warp, int lane,
                                           int m0, int Mp, int HWp, int Wp, int py, int px, int D, int n0, int O,
                                           int Ho, int Wo, const float* __restrict__ sx, int sx_stride,
                                           const float* __restrict__ sw, void* __restrict__ out, int bf16) {
  constexpr int PX = 2 * MI;  // pixels a lane writes
  constexpr int LD = 64 * MI + 4;
  const long long HoWo = static_cast<long long>(Ho) * Wo;
  const int ra = warp * 16 + (lane >> 2);  // accumulator rows ra and ra + 8 of each block
  float sxr[MI][2];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + mi * 64 + ra + 8 * h;
      sxr[mi][h] = m < Mp ? sx[(m / HWp) * sx_stride] : 0.f;
    }
  long long base[PX];  // output offsets (channel 0) of this lane's write-out pixels PX lane ..
#pragma unroll
  for (int e = 0; e < PX; ++e) {
    const int mm = m0 + PX * lane + e;
    base[e] = -1;
    if (mm < Mp) {
      const int nn = mm / HWp, rem = mm - nn * HWp, i = rem / Wp;
      base[e] = (static_cast<long long>(nn) * O * Ho + py + D * i) * Wo + px + D * (rem - i * Wp);
    }
  }
  bool run = base[0] >= 0;
#pragma unroll
  for (int e = 1; e < PX; ++e) run = run && base[e] == base[0] + e;
#pragma unroll
  for (int c = 0; c < BN / EPI_COLS; ++c) {
    float swv[8][2];  // the weight scales of this thread's 16 columns of the pass, loaded ahead of the staging
#pragma unroll
    for (int g = 0; g < 8; ++g)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int o = n0 + c * EPI_COLS + g * 8 + (lane & 3) * 2 + e;
        swv[g][e] = o < O ? __ldg(sw + o) : 0.f;
      }
    named_sync(bar, 128);  // the previous pass's reads are done
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = c * 32 + i;  // accumulator r: row ra (+8 for r & 2), column (r / 4) * 8 + (lane % 4) * 2 + r % 2
      const int col = ((r >> 2) & 7) * 8 + (lane & 3) * 2 + (r & 1);
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        float f = __int2float_rn(acc[mi][r]);
        if (bf16) f = __bfloat162float(__float2bfloat16_rn(f));
        stg[col * LD + mi * 64 + ra + ((r & 2) ? 8 : 0)] =
            __fmul_rn(f, __fmul_rn(sxr[mi][(r >> 1) & 1], swv[(r >> 2) & 7][r & 1]));
      }
    }
    named_sync(bar, 128);
    for (int col = warp; col < EPI_COLS; col += 4) {
      const int o = n0 + c * EPI_COLS + col;
      if (o >= O) break;
      float v[PX];
      if constexpr (PX == 4) {
        const float4 t = *reinterpret_cast<const float4*>(stg + col * LD + 4 * lane);
        v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
      } else {
        const float2 t = *reinterpret_cast<const float2*>(stg + col * LD + 2 * lane);
        v[0] = t.x, v[1] = t.y;
      }
      const long long off = static_cast<long long>(o) * HoWo;
      const bool vec = run && ((base[0] + off) % PX) == 0;
      if (bf16) {
        __nv_bfloat16* ob = reinterpret_cast<__nv_bfloat16*>(out);
        if (vec) {
          __align__(8) __nv_bfloat162 h[PX / 2];
#pragma unroll
          for (int e = 0; e < PX / 2; ++e) h[e] = __floats2bfloat162_rn(v[2 * e], v[2 * e + 1]);
          if constexpr (PX == 4) {
            *reinterpret_cast<uint2*>(ob + base[0] + off) = *reinterpret_cast<const uint2*>(h);
          } else {
            *reinterpret_cast<__nv_bfloat162*>(ob + base[0] + off) = h[0];
          }
        } else {
#pragma unroll
          for (int e = 0; e < PX; ++e)
            if (base[e] >= 0) ob[base[e] + off] = __float2bfloat16_rn(v[e]);
        }
      } else {
        float* of = reinterpret_cast<float*>(out);
        if (vec) {
          if constexpr (PX == 4) {
            *reinterpret_cast<float4*>(of + base[0] + off) = make_float4(v[0], v[1], v[2], v[3]);
          } else {
            *reinterpret_cast<float2*>(of + base[0] + off) = make_float2(v[0], v[1]);
          }
        } else {
#pragma unroll
          for (int e = 0; e < PX; ++e)
            if (base[e] >= 0) of[base[e] + off] = v[e];
        }
      }
    }
  }
}

template <int BN, int BK>
__global__ void __launch_bounds__(THREADS, 1) int8_conv_kernel(
    const __grid_constant__ CUtensorMap wmap, const __grid_constant__ CUtensorMap amap, int a_tma,
    const int8_t* __restrict__ x, const int* __restrict__ taps, const int* __restrict__ ntaps,
    const float* __restrict__ sx, int sx_stride, const float* __restrict__ sw, void* __restrict__ out, int bf16, int N,
    int Cp, int H, int W, int O, int Ho, int Wo, int S, int D, int Tmax, int total_tiles) {
  using C = Cfg<BN, BK>;
  constexpr int BM = C::BM, MI = C::MI;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  // the tiles' 128-byte swizzle wants 1024-byte alignment; offsetting the array (not an integer) keeps the
  // compiler's knowledge that these are shared-memory addresses
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::BAR_OFF);
  uint64_t* empty = full + C::STAGES;
  uint64_t* order = empty + C::STAGES;  // order[w]: the other consumer is done waiting on its tile's stages
  int4* s_pix = reinterpret_cast<int4*>(smem + C::PIX_OFF);
  int2* s_taps = reinterpret_cast<int2*>(smem + C::TAP_OFF);
  int* s_nt = reinterpret_cast<int*>(smem + C::NT_OFF);
  const int tid = threadIdx.x, nN = (O + BN - 1) / BN;

  for (int i = tid; i < D * D * Tmax; i += THREADS) s_taps[i] = make_int2(taps[2 * i], taps[2 * i + 1]);
  if (tid < D * D) s_nt[tid] = ntaps[tid];
  if (tid == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      // the producers' copies and the weight tile's expect_tx, or the one expect_tx of both tiles by TMA
      mbar_init(smem_u32(&full[s]), a_tma ? 1 : 128 + 1);
      mbar_init(smem_u32(&empty[s]), 1);       // the arrival of the warpgroup that consumed the stage
    }
    mbar_init(smem_u32(&order[0]), 1);
    mbar_init(smem_u32(&order[1]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < 128) {
    // ---------------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    int stage = 0, phase = 0;
    if (a_tma) {
      // the activation tile is a box of the NHWC input (stride 1, Cp a multiple of BK, the tiles box-aligned):
      // one thread loads both tiles by TMA, whose zero fill outside the input is the padding
      if (tid == 0) {
        for (int t = blockIdx.x; t < total_tiles; t += gridDim.x) {
          int p, mt, nt, Hp, Wp;
          decode_tile<BM>(t, nN, N, Ho, Wo, D, p, mt, nt, Hp, Wp);
          const int m0 = mt * BM, n0 = m0 / (Hp * Wp), rem = m0 - n0 * Hp * Wp, i0 = rem / Wp, j0 = rem - i0 * Wp;
          const int2* tp = s_taps + p * Tmax;
          const int nk = s_nt[p] * Cp / BK;
          for (int kt = 0; kt < nk; ++kt) {
            mbar_wait(smem_u32(&empty[stage]), phase ^ 1);
            const uint32_t fb = smem_u32(&full[stage]);
            mbar_expect_tx(fb, C::A_BYTES + C::B_BYTES);
            tma_load_2d(smem_u32(smem + C::B_OFF + stage * C::B_BYTES), &wmap, kt * BK, p * O + nt * BN, fb);
            const int j = kt * BK / Cp;
            const int2 d = tp[j];
            tma_load_4d(smem_u32(smem + stage * C::A_BYTES), &amap, kt * BK - j * Cp, j0 + d.y, i0 + d.x, n0, fb);
            if (++stage == C::STAGES) {
              stage = 0;
              phase ^= 1;
            }
          }
        }
      }
      return;
    }
    // lane q of each group of BK / 16 copies bytes 16 q .. 16 q + 15 of a K step, for the tile's pixels
    // pg, pg + 128 / (BK / 16), ...: a warp reads whole rows of the K step at a time
    constexpr int LANES = BK / 16, GROUPS = 128 / LANES;
    const int q = tid % LANES, pg = tid / LANES;
    for (int t = blockIdx.x; t < total_tiles; t += gridDim.x) {
      int p, mt, nt, Hp, Wp;
      decode_tile<BM>(t, nN, N, Ho, Wo, D, p, mt, nt, Hp, Wp);
      const int HWp = Hp * Wp;
      named_sync(3, 128);  // every producer is done with the last tile's pixel table
      for (int r = tid; r < BM; r += 128) {
        const int m = mt * BM + r;
        int4 e = make_int4(-1, 0, 0, 0);  // (first input pixel of the sample, or -1 past the last pixel; iy0, ix0)
        if (m < N * HWp) {
          const int n = m / HWp, rem = m - n * HWp, i = rem / Wp;
          e = make_int4(n * H * W, i * S, (rem - i * Wp) * S, 0);
        }
        s_pix[r] = e;
      }
      named_sync(3, 128);
      const int2* tp = s_taps + p * Tmax;
      const int nT = s_nt[p], nk = (nT * Cp + BK - 1) / BK;
      for (int kt = 0; kt < nk; ++kt) {
        mbar_wait(smem_u32(&empty[stage]), phase ^ 1);
        const uint32_t fb = smem_u32(&full[stage]);
        if (tid == 0) {
          mbar_expect_tx(fb, C::B_BYTES);
          tma_load_2d(smem_u32(smem + C::B_OFF + stage * C::B_BYTES), &wmap, kt * BK, p * O + nt * BN, fb);
        }
        const int kb = kt * BK + q * 16, j = kb / Cp, off = kb - j * Cp;  // this lane's tap and byte within it
        const bool tap = j < nT;
        const int2 d = tap ? tp[j] : make_int2(0, 0);
        const uint32_t dst = smem_u32(smem + stage * C::A_BYTES);
#pragma unroll 4
        for (int r = pg; r < BM; r += GROUPS) {
          const int4 e = s_pix[r];
          const int iy = e.y + d.x, ix = e.z + d.y;
          const bool ok = tap && e.x >= 0 && static_cast<unsigned>(iy) < static_cast<unsigned>(H) &&
                          static_cast<unsigned>(ix) < static_cast<unsigned>(W);
          const int8_t* src = ok ? x + static_cast<size_t>(e.x + iy * W + ix) * Cp + off : x;
          cp_async16(dst + swizzled<BK>(r, q), src, ok ? 16 : 0);
        }
        cp_async_arrive(fb);
        if (++stage == C::STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // ---------------------------------------------------------------- consumers
    // the two warpgroups take the block's tiles in turn (ping-pong), so that one's epilogue runs while the
    // other's MMAs do; each steps over the stages of the other's tiles, and starts waiting on its own only
    // once the other is done waiting on its (`order`): a barrier's parity tells apart only adjacent phases
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int cw = tid / 128 - 1;
    const int warp = (tid & 127) >> 5, lane = tid & 31;
    float* stg = reinterpret_cast<float*>(smem + C::EPI_OFF) + cw * EPI_COLS * (BM + 4);
    const uint32_t a_base = smem_u32(smem), b_base = smem_u32(smem + C::B_OFF);
    int stage = 0, phase = 0, turn = 0;
    for (int t = blockIdx.x, i = 0; t < total_tiles; t += gridDim.x, ++i) {
      int p, mt, nt, Hp, Wp;
      decode_tile<BM>(t, nN, N, Ho, Wo, D, p, mt, nt, Hp, Wp);
      const int nk = (s_nt[p] * Cp + BK - 1) / BK;
      if ((i & 1) != cw) {
        const int s2 = stage + nk;
        stage = s2 % C::STAGES;
        phase ^= (s2 / C::STAGES) & 1;
        continue;
      }
      if (i > 0) {
        mbar_wait(smem_u32(&order[cw]), turn);
        turn ^= 1;
      }
      int acc[MI][BN / 2];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int k = 0; k < BN / 2; ++k) acc[mi][k] = 0;
      int prev = -1;
      for (int kt = 0; kt < nk; ++kt) {
        mbar_wait(smem_u32(&full[stage]), phase);
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // the producers' cp.async writes -> wgmma
        wgmma_fence();
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) fence_acc(acc[mi]);
        const uint64_t da = sw_desc<BK>(a_base + stage * C::A_BYTES), db = sw_desc<BK>(b_base + stage * C::B_BYTES);
#pragma unroll
        for (int kk = 0; kk < BK / 32; ++kk)
#pragma unroll
          for (int mi = 0; mi < MI; ++mi) mma<BN>(acc[mi], da + mi * (64 * BK >> 4) + 2 * kk, db + 2 * kk);
        wgmma_commit();
        wgmma_wait<1>();  // the previous stage's group is done: release its buffers
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) fence_acc(acc[mi]);
        if (prev >= 0 && (tid & 127) == 0) mbar_arrive(smem_u32(&empty[prev]));
        prev = stage;
        if (++stage == C::STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      if ((tid & 127) == 0) mbar_arrive(smem_u32(&order[1 - cw]));
      wgmma_wait<0>();
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) fence_acc(acc[mi]);
      if (prev >= 0 && (tid & 127) == 0) mbar_arrive(smem_u32(&empty[prev]));
      store_tile<BN, MI>(acc, stg, 1 + cw, warp, lane, mt * BM, N * Hp * Wp, Hp * Wp, Wp, p / D, p % D, D, nt * BN,
                         O, Ho, Wo, sx, sx_stride, sw, out, bf16);
    }
  }
}

// cuTensorMapEncodeTiled, reached through the runtime so that the library needs no -lcuda
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

int sm_count() {
  static int counts[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (counts[dev] == 0 && cudaDeviceGetAttribute(&counts[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    counts[dev] = 132;
  return counts[dev];
}

// The box of input pixels (w, h, samples) that a tile of BM output pixels of a Hp x Wp phase grid is, where
// every tile is one (a power-of-two grid: a tile takes whole rows, or part of one row)
bool tile_box(int BM, int Hp, int Wp, cuuint32_t (&box)[3]) {
  if (Wp >= BM) {
    box[0] = BM, box[1] = 1, box[2] = 1;
    return Wp % BM == 0;
  }
  if (BM % Wp) return false;
  const int rows = BM / Wp;
  if (rows <= Hp) {
    box[0] = Wp, box[1] = rows, box[2] = 1;
    return Hp % rows == 0;
  }
  box[0] = Wp, box[1] = Hp, box[2] = rows / Hp;
  return rows % Hp == 0;
}

// the entry point's arguments
struct Args {
  const void *x, *w, *taps, *ntaps, *sx, *sw;
  void* out;
  int sx_stride, bf16, N, Cp, H, W, O, Ho, Wo, S, D, Kp, Tmax;
};

template <int BN, int BK>
int launch(const Args& a, cudaStream_t stream) {
  constexpr int BM = Cfg<BN, BK>::BM;
  constexpr CUtensorMapSwizzle SWIZZLE = BK == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap wmap, amap = {};
  {
    const cuuint64_t dims[2] = {(cuuint64_t)a.Kp, (cuuint64_t)a.D * a.D * a.O};
    const cuuint64_t strides[1] = {(cuuint64_t)a.Kp};
    const cuuint32_t box[2] = {BK, BN}, elem[2] = {1, 1};
    if (encode(&wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(a.w), dims, strides, box, elem,
               CU_TENSOR_MAP_INTERLEAVE_NONE, SWIZZLE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return (int)cudaErrorInvalidValue;
  }
  cuuint32_t pix[3];
  int a_tma = a.S == 1 && a.Cp % BK == 0 && a.Ho % a.D == 0 && a.Wo % a.D == 0 &&
              reinterpret_cast<uintptr_t>(a.x) % 16 == 0 && tile_box(BM, a.Ho / a.D, a.Wo / a.D, pix);
  if (a_tma) {
    const cuuint64_t dims[4] = {(cuuint64_t)a.Cp, (cuuint64_t)a.W, (cuuint64_t)a.H, (cuuint64_t)a.N};
    const cuuint64_t strides[3] = {(cuuint64_t)a.Cp, (cuuint64_t)a.W * a.Cp, (cuuint64_t)a.H * a.W * a.Cp};
    const cuuint32_t box[4] = {BK, pix[0], pix[1], pix[2]}, elem[4] = {1, 1, 1, 1};
    // a class that qualifies for the TMA box never falls back to the gather in silence
    if (encode(&amap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, const_cast<void*>(a.x), dims, strides, box, elem,
               CU_TENSOR_MAP_INTERLEAVE_NONE, SWIZZLE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return (int)cudaErrorInvalidValue;
  }
  long long tiles = 0;
  for (int p = 0; p < a.D * a.D; ++p)
    tiles += ((long long)a.N * ((a.Ho - p / a.D + a.D - 1) / a.D) * ((a.Wo - p % a.D + a.D - 1) / a.D) + BM - 1) / BM;
  tiles *= (a.O + BN - 1) / BN;
  if (tiles <= 0) return 0;
  if (tiles > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const cudaError_t e =
      cudaFuncSetAttribute(int8_conv_kernel<BN, BK>, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg<BN, BK>::SMEM);
  if (e != cudaSuccess) return (int)e;
  const int grid = (int)(tiles < sm_count() ? tiles : sm_count());
  int8_conv_kernel<BN, BK><<<grid, THREADS, Cfg<BN, BK>::SMEM, stream>>>(
      wmap, amap, a_tma, (const int8_t*)a.x, (const int*)a.taps, (const int*)a.ntaps, (const float*)a.sx, a.sx_stride,
      (const float*)a.sw, a.out, a.bf16, a.N, a.Cp, a.H, a.W, a.O, a.Ho, a.Wo, a.S, a.D, a.Tmax, (int)tiles);
  return (int)cudaGetLastError();
}

// 64-byte K steps where the channels come in 64s and the activation tile is a box of the input (so that it
// comes by TMA), else 128-byte ones
template <int BN>
int launch_bn(const Args& a, cudaStream_t stream) {
  cuuint32_t pix[3];
  const bool bk64 = a.S == 1 && a.Cp % 128 && a.Cp % 64 == 0 && a.Ho % a.D == 0 && a.Wo % a.D == 0 &&
                    tile_box(Cfg<BN, 64>::BM, a.Ho / a.D, a.Wo / a.D, pix);
  return bk64 ? launch<BN, 64>(a, stream) : launch<BN, 128>(a, stream);
}

}  // namespace

// x: int8 [N, H, W, Cp] (NHWC, Cp a multiple of 16, zero channels past C);
// w: int8 [D*D, O, Kp] (the phase's valid taps in order, Cp channels each,
// zeros past them; Kp a multiple of 128, 16-byte aligned); taps: int32
// [D*D, Tmax, 2] (dy, dx) of each phase's valid taps; ntaps: int32 [D*D];
// sx: fp32, sx[n * sx_stride]; sw: fp32 [O]; out: fp32 or bf16 [N, O, Ho, Wo].
extern "C" int pasta_int8_conv(const void* x, const void* w, const void* taps, const void* ntaps,
                               const void* sx, int sx_stride, const void* sw, void* out, int bf16, int N,
                               int Cp, int H, int W, int O, int Ho, int Wo, int S, int D, int Kp, int Tmax,
                               void* stream) {
  if (Tmax > MAX_TAPS || D < 1 || D * D > MAX_PHASES || S < 1 || Cp % 16 || Kp % 128 ||
      reinterpret_cast<uintptr_t>(w) % 16)
    return (int)cudaErrorInvalidValue;
  const Args a{x, w, taps, ntaps, sx, sw, out, sx_stride, bf16, N, Cp, H, W, O, Ho, Wo, S, D, Kp, Tmax};
  cudaStream_t st = (cudaStream_t)stream;
  return O <= 64 ? launch_bn<64>(a, st) : O <= 128 ? launch_bn<128>(a, st) : launch_bn<256>(a, st);
}
