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
// taps per axis and ~6 or ~40 flops, far below the card's ~20 flops per
// byte at fp32.  At the training path's largest shapes (up2 pre-FIR
// [16,128,128,128] bf16 -> [16,128,258,258]: 67 MB read + 273 MB written;
// down2 [32,64,256,256] bf16 -> [32,64,128,128]: 268 MB + 67 MB) the floor is
// ~0.10 ms at 3.35 TB/s.  up2 writes four times what it reads, so its pace
// is set by the stores and by the instructions issued per stored byte:
// measured on an H100 80GB HBM3 (700 W) the pre-FIR takes ~0.16 ms where a
// memset of its output takes ~0.087 ms, and the per-output arithmetic and
// index work (64 registers a thread, half the SM's threads) is what is left.
//
// up2 design: each thread computes a unit of 16 outputs (2 x 8 bf16 or 2 x
// 4 fp32 outputs) and writes it as 16-byte stores at 16-byte-aligned offsets
// of the flat output.  A row of an extend-1 output (2W + 2 elements) is never
// 16-byte aligned, so the threads index the flat output, not rows, and carry
// each unit's (plane, row, column) to their next unit by adds and compares.
// A unit of n outputs inside one row needs a window of n/2 + 4 input
// columns from two input rows; the thread loads it as 4- or 8-byte pairs from an even column
// (one thread per output pair took 6 scalar loads for 2 outputs), runs the
// vertical pass once per column and the horizontal pass per output.  A unit
// that crosses a row's end (one per row) is computed from both rows' windows
// by the thread that owns the row, in the iteration whose region holds the
// row's end: a warp's lanes own consecutive rows and take their crossings
// together, and the crossing unit is written beside its neighbours (written
// apart, before or after the main loop, the lone 32-byte sectors and the
// lines around them cost partial-line writes: ~0.02 ms more at the pre-FIR
// shape).  Rows shorter
// than a unit go to a kernel of one thread per output.  The pair loads need an
// even W and an input pointer aligned to a pair; a view at an odd element
// offset or an odd W loads the same window element by element.  Neighbouring
// threads' windows overlap and consecutive output rows share input rows, so
// the reloads hit L1/L2 and each input byte comes from DRAM once.  The grid
// is one wave of resident blocks (launch.cuh) that stride over the units.
//
// down2 design.  The first port of this kernel gave each thread one output: 16
// scalar tap loads (2 bytes each in bf16) and one 2-byte store, with blocks
// covering one output row, so every input row was fetched by the two blocks
// of the output rows that share it; at the D skip's [32,64,256,256] bf16 it
// ran at 0.265 ms, 38 % of its bound, paced by load instructions, not bytes.
// Now a unit is a strip of 8 outputs (4 on rows of 4 to 7) over up to 16
// output rows of one plane, and its thread streams the strip's input rows
// once, top to bottom: each row's 16 aligned columns as 16-byte vectors
// (element pairs where the row or the pointer is not 16-byte aligned: the
// pad-0 adjoint's rows of 2W + 2 are 4-byte aligned in bf16; single elements
// for a view at an odd offset) plus its two edge columns as single loads, and
// each input row feeds the vertical pass of the two output rows it is a tap
// of (the TPU kernel's band of 2 th + 3 rows, held in registers). A finished
// output row takes the horizontal pass and one 16-byte store (two in fp32).
// So a bf16 output costs ~1 load instruction, not 16, and each input byte is
// read once but for the 2 rows that neighbouring units share. Units shrink to
// fewer rows where there would be fewer of them than half the threads the
// card holds, and launches too small to fill the card even so (the fp32 image
// pyramid's [32,3,r,r], r <= 64), or with rows shorter than 4 outputs, take
// one thread per output. The bf16 strips are held to 64 registers (4 blocks
// of 256 threads an SM): the extra occupancy was worth more than the few
// spilled bytes of the pair-load path. The grid is one wave of resident
// blocks (launch.cuh) that stride over the units.
//
// What bounds it now (H100 80GB HBM3, 700 W, chip_smoke.py): at the main
// shape 0.141 ms, 71 % of its bound (2.38 TB/s of 335 MB), where a memset of
// its 67 MB output takes 0.026 ms; the read stream at ~2.4 TB/s, short of the
// card's peak, and the two single edge loads a row beside its two vectors.
// The pad-0 adjoint's pair loads (8 a row) cost 8 % more (0.152 ms at
// [32,64,258,258]); a funnel-shifted 16-byte load would remove them.

// Numerics: the vertical pass, then the horizontal one, then the gain, each
// product and sum rounded to nearest (no FMA contraction), in the order of
// the plain PyTorch version (up2_reference / down2_reference), so both agree
// bit for bit in fp32 and, after the one bf16 rounding, in bf16.  A gain of 1
// skips its multiply, which returns its input unchanged.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "launch.cuh"

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

// ------------------------------------------------------------------- up2

constexpr int kUpThreads = 256;

// Elements p[0], p[1] as one aligned word.
__device__ __forceinline__ void load_pair(const float* p, float& a, float& b) {
  const float2 v = __ldg(reinterpret_cast<const float2*>(p));
  a = v.x;
  b = v.y;
}
__device__ __forceinline__ void load_pair(const __nv_bfloat16* p, float& a, float& b) {
  const unsigned w = __ldg(reinterpret_cast<const unsigned*>(p));
  a = __uint_as_float(w << 16);  // bf16 -> fp32 is exact: the high half of the word
  b = __uint_as_float(w & 0xffff0000u);
}

// 16 bytes of output: kV consecutive elements, one vector store.
template <typename T>
struct Chunk;
template <>
struct Chunk<float> {
  static constexpr int kV = 4;
  __device__ __forceinline__ static void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};
template <>
struct Chunk<__nv_bfloat16> {
  static constexpr int kV = 8;
  __device__ __forceinline__ static unsigned pack(float a, float b) {
    __nv_bfloat162 h = __floats2bfloat162_rn(a, b);  // a in the low half
    return *reinterpret_cast<unsigned*>(&h);
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* p, const float* v) {
    *reinterpret_cast<uint4*>(p) = make_uint4(pack(v[0], v[1]), pack(v[2], v[3]), pack(v[4], v[5]), pack(v[6], v[7]));
  }
};

// Output (r, c) of one plane, before the gain.
template <typename T>
__device__ __forceinline__ float up2_one(const T* __restrict__ plane, int H, int W, int r, int c, int extend) {
  const UpTaps ty = up_taps(r, extend), tx = up_taps(c, extend);
  const int y0 = ty.i0, y1 = ty.i0 + 1;
  const bool ry0 = y0 >= 0 && y0 < H, ry1 = y1 >= 0 && y1 < H;
  float v[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int col = tx.i0 + k;
    const bool rc = col >= 0 && col < W;
    const float a0 = (ry0 && rc) ? load(plane + (long long)y0 * W + col) : 0.f;
    const float a1 = (ry1 && rc) ? load(plane + (long long)y1 * W + col) : 0.f;
    v[k] = mac(__fmul_rn(a0, ty.w0), a1, ty.w1);
  }
  return mac(__fmul_rn(v[0], tx.w0), v[1], tx.w1);
}

// Outputs (r, c0 .. c0 + kOut - 1) of one plane, before the gain; c0 is even
// (every row and chunk starts at an even flat offset), so output c0 + k reads
// input columns lo + i0(k) and lo + i0(k) + 1 with lo = c0 / 2 - 1.  `pairs`:
// W is even and the input is aligned to a pair.
template <typename T, int kExtend, int kOut>
__device__ __forceinline__ void up2_row(const T* __restrict__ plane, int H, int W, int r, int c0, bool pairs,
                                        float* out) {
  constexpr int kN = kOut / 2 + 4;  // window of input columns from an even one
  const UpTaps ty = up_taps(r, kExtend);
  const int y0 = ty.i0, y1 = ty.i0 + 1;
  const bool ry0 = y0 >= 0 && y0 < H, ry1 = y1 >= 0 && y1 < H;
  const T* row0 = plane + (long long)y0 * W;
  const T* row1 = plane + (long long)y1 * W;
  const int lo = c0 / 2 - 1;
  const int base = lo & ~1;  // two's complement: -1 -> -2
  float v[kN];               // vertical pass at columns base .. base + kN - 1
#pragma unroll
  for (int i = 0; i < kN; i += 2) {
    const int col = base + i;
    float a[2] = {0.f, 0.f}, b[2] = {0.f, 0.f};
    if (pairs) {
      if (col >= 0 && col < W) {  // W even: the pair lies inside the row or outside it
        if (ry0) load_pair(row0 + col, a[0], a[1]);
        if (ry1) load_pair(row1 + col, b[0], b[1]);
      }
    } else {
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        if (col + k >= 0 && col + k < W) {
          if (ry0) a[k] = load(row0 + col + k);
          if (ry1) b[k] = load(row1 + col + k);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < 2; ++k) v[i + k] = mac(__fmul_rn(a[k], ty.w0), b[k], ty.w1);
  }
  const bool shift = lo & 1;  // the window starts one column before lo
  float u[kN - 1];            // u[i]: column lo + i
#pragma unroll
  for (int i = 0; i < kN - 1; ++i) u[i] = shift ? v[i + 1] : v[i];
#pragma unroll
  for (int k = 0; k < kOut; ++k) {
    const int i0 = kExtend ? k / 2 : (k + 1) / 2;
    const bool odd = (k + kExtend) & 1;  // parity of the unextended output index
    out[k] = mac(__fmul_rn(u[i0], odd ? 0.75f : 0.25f), u[i0 + 1], odd ? 0.25f : 0.75f);
  }
}

// Outputs f0 .. f0 + kOut - 1 of the flat output, before the gain, that start
// at (plane p, row r, column c0) and run past the row's end into the next row
// (a row holds at least kOut outputs): both rows' windows are computed
// (up2_row masks the columns that fall outside each row) and each element
// takes its own row's value.
template <typename T, int kExtend, int kOut>
__device__ __forceinline__ void up2_crossing(const T* __restrict__ x, int H, int W, long long p, int r, int c0,
                                             long long f0, long long total, bool pairs, float* out) {
  const int Ho = 2 * H + 2 * kExtend, Wo = 2 * W + 2 * kExtend;
  const long long plane_in = (long long)H * W;
  const int split = Wo - c0;  // elements k < split lie in row r
  up2_row<T, kExtend, kOut>(x + p * plane_in, H, W, r, c0, pairs, out);
  if (f0 + split < total) {  // the next row exists
    const bool wrap = r + 1 == Ho;
    float next[kOut];
    up2_row<T, kExtend, kOut>(x + (p + wrap) * plane_in, H, W, wrap ? 0 : r + 1, c0 - Wo, pairs, next);
#pragma unroll
    for (int k = 0; k < kOut; ++k)
      if (k >= split) out[k] = next[k];
  }
}

// Outputs f0 .. f0 + kOut - 1 times the gain, as 16-byte stores where `vec`
// (the output is 16-byte aligned) and the tensor's end allow.
template <typename T, int kOut>
__device__ __forceinline__ void store_outputs(T* __restrict__ y, long long f0, long long total, float gain, bool vec,
                                              float* out) {
  constexpr int kV = Chunk<T>::kV;
  if (gain != 1.f) {
#pragma unroll
    for (int k = 0; k < kOut; ++k) out[k] = __fmul_rn(out[k], gain);
  }
  if (vec && f0 + kOut <= total) {
#pragma unroll
    for (int k = 0; k < kOut; k += kV) Chunk<T>::store(y + f0 + k, out + k);
  } else {
#pragma unroll
    for (int k = 0; k < kOut; ++k)
      if (f0 + k < total) store(y + f0 + k, out[k]);
  }
}

constexpr int kUpMinBlocks = 4;  // __launch_bounds__: at most 64 registers a thread
constexpr int kUpChunks = 2;     // adjacent 16-byte output chunks a thread computes at once

// x: [planes, H, W]; y: the flat [planes, Ho, Wo] output, `total` elements,
// in units of kOut outputs.  Iteration i of every thread covers the region
// [i * step, (i + 1) * step) of the flat output: the thread's own unit
// (tid, tid + stride, ...) when it lies inside one output row, carrying
// (plane, row, column) from one iteration to the next by adds and compares,
// and the units that cross the end of its rows (tid, tid + stride, ...) whose
// end lies in the region.  A warp's 32 rows are consecutive, so its lanes
// take their crossing units in the same iteration (no lane waits on another),
// about once in Wo / kOut iterations; and a crossing unit is written in the
// same iteration as its neighbours: a 32-byte sector written alone, long
// before or after the rest of its 128-byte line, costs the memory a
// partial-line write.
template <typename T, int kExtend>
__global__ void __launch_bounds__(kUpThreads, kUpMinBlocks)
    up2_kernel(const T* __restrict__ x, T* __restrict__ y, int H, int W, long long rows, float gain, bool pairs,
               bool vec_store) {
  constexpr int kOut = kUpChunks * Chunk<T>::kV;  // outputs a thread computes at once
  const int Ho = 2 * H + 2 * kExtend, Wo = 2 * W + 2 * kExtend;
  const long long total = rows * Wo;
  const long long plane_in = (long long)H * W;
  const long long tid = (long long)blockIdx.x * kUpThreads + threadIdx.x;
  const long long stride = (long long)gridDim.x * kUpThreads;

  const long long step = stride * kOut;  // flat elements between a thread's units
  const long long step_rows = step / Wo;
  const int step_c = (int)(step - step_rows * Wo);
  const long long step_p = step_rows / Ho;
  const int step_r = (int)(step_rows - step_p * Ho);
  long long f0 = tid * kOut;  // the thread's unit: (plane p, row r, column c)
  const long long g0 = f0 / Wo;
  int c = (int)(f0 - g0 * Wo);
  long long p = g0 / Ho;
  int r = (int)(g0 - p * Ho);
  long long cg = tid;                // the next row whose crossing unit this thread writes
  long long cg_end = (tid + 1) * Wo;  // and its end in the flat output
#pragma unroll 1
  for (long long start = step; start - step < total; start += step) {
    if (f0 < total && c + kOut <= Wo) {
      float out[kOut];
      up2_row<T, kExtend, kOut>(x + p * plane_in, H, W, r, c, pairs, out);
      store_outputs<T, kOut>(y, f0, total, gain, vec_store, out);
    }
    f0 += step;
    c += step_c;
    r += step_r;
    p += step_p;
    if (c >= Wo) {
      c -= Wo;
      ++r;
    }
    if (r >= Ho) {
      r -= Ho;
      ++p;
    }
    for (; cg < rows && cg_end <= start; cg += stride, cg_end += stride * Wo) {
      const long long fc = cg_end / kOut * kOut;    // the unit holding row cg's last element
      if (fc == cg_end || fc < cg_end - Wo) continue;  // no crossing, or it starts in an earlier row
      const long long pc = cg / Ho;
      float out[kOut];
      up2_crossing<T, kExtend, kOut>(x, H, W, pc, (int)(cg - pc * Ho), (int)(fc - cg_end + Wo), fc, total, pairs,
                                     out);
      store_outputs<T, kOut>(y, fc, total, gain, vec_store, out);
    }
  }
}

// Rows shorter than a unit (Wo < kOut: the b8 up-conv's 10-wide rows in
// bf16): one thread per output of the flat output, scalar stores.  Every
// unit of up2_kernel would cross a row there, and a thread that walks its 16
// outputs one after another made these few-MB launches slower than one
// thread per output pair.
template <typename T, int kExtend>
__global__ void __launch_bounds__(kUpThreads)
    up2_short_rows_kernel(const T* __restrict__ x, T* __restrict__ y, int H, int W, long long total, float gain) {
  const int Ho = 2 * H + 2 * kExtend, Wo = 2 * W + 2 * kExtend;
  const long long plane_in = (long long)H * W;
  const long long stride = (long long)gridDim.x * kUpThreads;
  for (long long f = (long long)blockIdx.x * kUpThreads + threadIdx.x; f < total; f += stride) {
    const long long g = f / Wo;
    const long long p = g / Ho;
    const float v = up2_one(x + p * plane_in, H, W, (int)(g - p * Ho), (int)(f - g * Wo), kExtend);
    store(y + f, gain != 1.f ? __fmul_rn(v, gain) : v);
  }
}

template <typename T, int kExtend>
int launch_up2(const void* x, void* y, long long planes, int H, int W, float gain, cudaStream_t stream) {
  constexpr int kOut = kUpChunks * Chunk<T>::kV;
  const int Ho = 2 * H + 2 * kExtend, Wo = 2 * W + 2 * kExtend;
  const long long rows = planes * Ho;
  if (Wo < kOut) {
    const long long total = rows * Wo;
    const long long blocks = (total + kUpThreads - 1) / kUpThreads;
    if (blocks == 0) return (int)cudaGetLastError();
    static pasta::ResidentWave wave;
    const long long grid = wave.grid(up2_short_rows_kernel<T, kExtend>, kUpThreads, blocks);
    up2_short_rows_kernel<T, kExtend><<<(unsigned)grid, kUpThreads, 0, stream>>>((const T*)x, (T*)y, H, W, total,
                                                                                gain);
    return (int)cudaGetLastError();
  }
  const long long blocks = ((rows * Wo + kOut - 1) / kOut + kUpThreads - 1) / kUpThreads;
  if (blocks == 0) return (int)cudaGetLastError();
  const bool pairs = W % 2 == 0 && reinterpret_cast<std::uintptr_t>(x) % (2 * sizeof(T)) == 0;
  const bool vec_store = reinterpret_cast<std::uintptr_t>(y) % 16 == 0;
  static pasta::ResidentWave wave;
  const long long grid = wave.grid(up2_kernel<T, kExtend>, kUpThreads, blocks);
  up2_kernel<T, kExtend><<<(unsigned)grid, kUpThreads, 0, stream>>>((const T*)x, (T*)y, H, W, rows, gain, pairs,
                                                                     vec_store);
  return (int)cudaGetLastError();
}

// ----------------------------------------------------------------- down2

constexpr int kDownThreads = 256;
constexpr int kDownMaxRows = 16;  // output rows of one unit, at most

// How a strip's aligned input columns are loaded: 16-byte vectors (the row
// and the pointer 16-byte aligned), element pairs (the pointer aligned to a
// pair; W is even) or single elements (a view at an odd element offset).
enum DownLoad { kElems = 0, kPairs = 1, kVec16 = 2 };

// kN consecutive elements from p into v[0 .. kN - 1], as fp32.
template <typename T, int kN, int kLoad>
__device__ __forceinline__ void load_n(const T* __restrict__ p, float* v) {
  if constexpr (kLoad == kVec16 && sizeof(T) == 2) {
#pragma unroll
    for (int i = 0; i < kN; i += 8) {
      const uint4 q = __ldg(reinterpret_cast<const uint4*>(p + i));
      const unsigned w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        v[i + 2 * k] = __uint_as_float(w[k] << 16);  // bf16 -> fp32 is exact
        v[i + 2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
      }
    }
  } else if constexpr (kLoad == kVec16) {
#pragma unroll
    for (int i = 0; i < kN; i += 4) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(p + i));
      v[i] = q.x;
      v[i + 1] = q.y;
      v[i + 2] = q.z;
      v[i + 3] = q.w;
    }
  } else if constexpr (kLoad == kPairs) {
#pragma unroll
    for (int i = 0; i < kN; i += 2) load_pair(p + i, v[i], v[i + 1]);
  } else {
#pragma unroll
    for (int i = 0; i < kN; ++i) v[i] = load(p + i);
  }
}

// v[i] = x[row][2 c0 - kPad + i], i < 2 kOut + 2, zero outside the row;
// `row` is null for a row outside the plane (all zeros).  `full`: the strip's
// kOut outputs lie inside the output row, so the 2 kOut columns from 2 c0 lie
// inside the input row and take kLoad; the two edge columns are single loads
// (their sectors are the neighbouring strips', in L1).
template <typename T, int kOut, int kPad, int kLoad>
__device__ __forceinline__ void down2_row(const T* __restrict__ row, int W, int c0, bool full, float* v) {
  constexpr int kCols = 2 * kOut + 2;
  if (row == nullptr) {
#pragma unroll
    for (int i = 0; i < kCols; ++i) v[i] = 0.f;
    return;
  }
  const int col0 = 2 * c0 - kPad;
  if (full) {
    load_n<T, 2 * kOut, kLoad>(row + 2 * c0, v + kPad);
    if (kPad) {  // columns 2 c0 - 1 and 2 c0 + 2 kOut
      v[0] = c0 > 0 ? load(row + col0) : 0.f;
      v[kCols - 1] = 2 * c0 + 2 * kOut < W ? load(row + 2 * c0 + 2 * kOut) : 0.f;
    } else {  // columns 2 c0 + 2 kOut and + 1, inside the row when full
      v[kCols - 2] = load(row + 2 * c0 + 2 * kOut);
      v[kCols - 1] = load(row + 2 * c0 + 2 * kOut + 1);
    }
  } else {
#pragma unroll
    for (int i = 0; i < kCols; ++i) {
      const int col = col0 + i;
      v[i] = (col >= 0 && col < W) ? load(row + col) : 0.f;
    }
  }
}

// n = kOut outputs at p as one or two 16-byte stores (or one 8-byte store for
// 4 bf16) where `vec` (p aligned to them), else element by element (n <= kOut).
template <typename T, int kOut>
__device__ __forceinline__ void down2_store(T* __restrict__ p, const float* h, int n, bool vec) {
  if (vec && n == kOut) {
    if constexpr (kOut * sizeof(T) >= 16) {
#pragma unroll
      for (int k = 0; k < kOut; k += Chunk<T>::kV) Chunk<T>::store(p + k, h + k);
      return;
    } else if constexpr (sizeof(T) == 2 && kOut == 4) {
      *reinterpret_cast<uint2*>(p) = make_uint2(Chunk<T>::pack(h[0], h[1]), Chunk<T>::pack(h[2], h[3]));
      return;
    }
  }
#pragma unroll
  for (int k = 0; k < kOut; ++k)
    if (k < n) store(p + k, h[k]);
}

// A unit is a strip of kOut output columns over `rows` output rows of one
// plane.  Its thread streams the 2 rows + 2 input rows down the strip
// once, in order: row 2o - kPad + t is tap t of output row o, so every input
// row after the first two is tap 2 or 3 of the row being finished (`cur`)
// and tap 0 or 1 of the next (`nxt`), and the vertical pass keeps the plain
// version's order of taps.  A finished row takes the horizontal pass per
// output and one vector store.  Lanes take consecutive strips of a row, so a
// warp's loads and stores cover whole rows.
template <typename T, int kOut, int kPad, int kLoad>
__global__ void __launch_bounds__(kDownThreads, sizeof(T) == 2 ? 4 : 1)
    down2_kernel(const T* __restrict__ x, T* __restrict__ y, long long planes, int H, int W, int rows,
                 float gain, bool vec_store) {
  constexpr int kCols = 2 * kOut + 2;
  const int Ho = H / 2 + kPad - 1, Wo = W / 2 + kPad - 1;
  const int strips = (Wo + kOut - 1) / kOut;
  const int chunks = (Ho + rows - 1) / rows;
  const long long units = planes * chunks * strips;
  const long long stride = (long long)gridDim.x * kDownThreads;
  const float w0 = 0.125f, w1 = 0.375f, w2 = 0.375f, w3 = 0.125f;
#pragma unroll 1
  for (long long u = (long long)blockIdx.x * kDownThreads + threadIdx.x; u < units; u += stride) {
    const long long g = u / strips;
    const int c0 = (int)(u - g * strips) * kOut;
    const long long p = g / chunks;
    const int o0 = (int)(g - p * chunks) * rows;
    const int o1 = min(o0 + rows, Ho);
    const bool full = c0 + kOut <= Wo;
    const T* plane = x + p * ((long long)H * W);
    T* out = y + (p * Ho + o0) * (long long)Wo + c0;
    const auto row = [&](int r) -> const T* { return (r >= 0 && r < H) ? plane + (long long)r * W : nullptr; };
    float cur[kCols], nxt[kCols], v[kCols];
    const int r0 = 2 * o0 - kPad;
    down2_row<T, kOut, kPad, kLoad>(row(r0), W, c0, full, v);
#pragma unroll
    for (int i = 0; i < kCols; ++i) cur[i] = __fmul_rn(v[i], w0);
    down2_row<T, kOut, kPad, kLoad>(row(r0 + 1), W, c0, full, v);
#pragma unroll
    for (int i = 0; i < kCols; ++i) cur[i] = mac(cur[i], v[i], w1);
#pragma unroll 1
    for (int o = o0; o < o1; ++o, out += Wo) {
      const int r = 2 * o - kPad + 2;
      down2_row<T, kOut, kPad, kLoad>(row(r), W, c0, full, v);
#pragma unroll
      for (int i = 0; i < kCols; ++i) {
        cur[i] = mac(cur[i], v[i], w2);
        nxt[i] = __fmul_rn(v[i], w0);
      }
      down2_row<T, kOut, kPad, kLoad>(row(r + 1), W, c0, full, v);
#pragma unroll
      for (int i = 0; i < kCols; ++i) {
        cur[i] = mac(cur[i], v[i], w3);
        nxt[i] = mac(nxt[i], v[i], w1);
      }
      float h[kOut];
#pragma unroll
      for (int k = 0; k < kOut; ++k) {
        float s = __fmul_rn(cur[2 * k], w0);
        s = mac(s, cur[2 * k + 1], w1);
        s = mac(s, cur[2 * k + 2], w2);
        s = mac(s, cur[2 * k + 3], w3);
        h[k] = __fmul_rn(s, gain);
      }
      down2_store<T, kOut>(out, h, min(kOut, Wo - c0), vec_store);
#pragma unroll
      for (int i = 0; i < kCols; ++i) cur[i] = nxt[i];
    }
  }
}

// Rows shorter than 4 outputs, and launches too small to fill the card with
// strips: one thread per output of the flat output, all 16 taps in flight
// at once, in blocks of 64 threads spread over the SMs.
constexpr int kDownOutThreads = 64;

template <typename T, int kPad>
__global__ void __launch_bounds__(kDownOutThreads)
    down2_per_output_kernel(const T* __restrict__ x, T* __restrict__ y, int H, int W, long long total, float gain) {
  const int Ho = H / 2 + kPad - 1, Wo = W / 2 + kPad - 1;
  const float w[4] = {0.125f, 0.375f, 0.375f, 0.125f};
  const long long stride = (long long)gridDim.x * kDownOutThreads;
  for (long long f = (long long)blockIdx.x * kDownOutThreads + threadIdx.x; f < total; f += stride) {
    const long long g = f / Wo;
    const long long p = g / Ho;
    const int iy = 2 * (int)(g - p * Ho) - kPad, ix = 2 * (int)(f - g * Wo) - kPad;
    const T* xp = x + p * ((long long)H * W);
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
    store(y + f, __fmul_rn(h, gain));
  }
}

// Units of 16 output rows, or fewer where that leaves fewer units than half
// the threads the card holds (few planes, short planes): each unit then
// re-reads 2 of its input rows from L2 for every 2 rows - 2 it reads once.
template <typename T, int kOut, int kPad, int kLoad>
int launch_down2_strips(const void* x, void* y, long long planes, int H, int W, float gain, bool vec_store,
                        cudaStream_t stream) {
  const int Ho = H / 2 + kPad - 1, Wo = W / 2 + kPad - 1;
  static pasta::ResidentWave wave;
  const long long resident = wave.resident(down2_kernel<T, kOut, kPad, kLoad>, kDownThreads) * kDownThreads;
  const long long per_row = planes * ((Wo + kOut - 1) / kOut);  // units of one output row each
  int rows = kDownMaxRows;
  while (rows > 1 && 2 * per_row * ((Ho + rows - 1) / rows) < resident) rows /= 2;
  const long long units = per_row * ((Ho + rows - 1) / rows);
  const long long grid =
      wave.grid(down2_kernel<T, kOut, kPad, kLoad>, kDownThreads, (units + kDownThreads - 1) / kDownThreads);
  down2_kernel<T, kOut, kPad, kLoad><<<(unsigned)grid, kDownThreads, 0, stream>>>((const T*)x, (T*)y, planes, H, W,
                                                                                  rows, gain, vec_store);
  return (int)cudaGetLastError();
}

template <typename T, int kOut, int kPad>
int launch_down2_loads(const void* x, void* y, long long planes, int H, int W, float gain, cudaStream_t stream) {
  const int Wo = W / 2 + kPad - 1;
  const std::uintptr_t xa = reinterpret_cast<std::uintptr_t>(x);
  const std::uintptr_t vbytes = kOut * sizeof(T) < 16 ? kOut * sizeof(T) : 16;
  const bool vec_store = reinterpret_cast<std::uintptr_t>(y) % vbytes == 0 && (Wo * sizeof(T)) % vbytes == 0;
  if (xa % 16 == 0 && (W * sizeof(T)) % 16 == 0)
    return launch_down2_strips<T, kOut, kPad, kVec16>(x, y, planes, H, W, gain, vec_store, stream);
  if (xa % (2 * sizeof(T)) == 0)
    return launch_down2_strips<T, kOut, kPad, kPairs>(x, y, planes, H, W, gain, vec_store, stream);
  return launch_down2_strips<T, kOut, kPad, kElems>(x, y, planes, H, W, gain, vec_store, stream);
}

template <typename T, int kPad>
int launch_down2_per_output(const void* x, void* y, long long planes, int H, int W, float gain, cudaStream_t stream) {
  const long long total = planes * (H / 2 + kPad - 1) * (W / 2 + kPad - 1);
  static pasta::ResidentWave wave;
  const long long grid = wave.grid(down2_per_output_kernel<T, kPad>, kDownOutThreads,
                                   (total + kDownOutThreads - 1) / kDownOutThreads);
  down2_per_output_kernel<T, kPad><<<(unsigned)grid, kDownOutThreads, 0, stream>>>((const T*)x, (T*)y, H, W, total,
                                                                                  gain);
  return (int)cudaGetLastError();
}

// Strips of 8 outputs (4 on rows of 4 to 7), unless they would be fewer than
// a quarter of the threads the card holds even one output row a unit (the
// fp32 image pyramid's [32,3,r,r] for r <= 64: 2-3 waves of a few hundred
// blocks, where a strip's rows in sequence cost more than they save).
template <typename T, int kPad>
int launch_down2(const void* x, void* y, long long planes, int H, int W, float gain, cudaStream_t stream) {
  const int Ho = H / 2 + kPad - 1, Wo = W / 2 + kPad - 1;
  if (planes <= 0 || Ho <= 0 || Wo <= 0) return (int)cudaGetLastError();
  const int strip = Wo >= 8 ? 8 : 4;
  static pasta::ResidentWave wave;  // threads the card holds of the strip kernel
  const long long resident = wave.resident(down2_kernel<T, 8, kPad, kVec16>, kDownThreads) * kDownThreads;
  if (Wo < 4 || 4 * planes * ((Wo + strip - 1) / strip) * Ho < resident)
    return launch_down2_per_output<T, kPad>(x, y, planes, H, W, gain, stream);
  if (Wo >= 8) return launch_down2_loads<T, 8, kPad>(x, y, planes, H, W, gain, stream);
  return launch_down2_loads<T, 4, kPad>(x, y, planes, H, W, gain, stream);
}

}  // namespace

// x: [planes, H, W] contiguous (planes = N * C), any element offset; y:
// [planes, 2H + 2 extend, 2W + 2 extend]; bf16 != 0 selects __nv_bfloat16
// for both, else float.  Launches on `stream`, allocates nothing, returns
// cudaGetLastError().
extern "C" int pasta_up2(const void* x, void* y, int bf16, long long planes, int H, int W, int extend,
                         float gain, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (bf16) {
    return extend ? launch_up2<__nv_bfloat16, 1>(x, y, planes, H, W, gain, s)
                  : launch_up2<__nv_bfloat16, 0>(x, y, planes, H, W, gain, s);
  }
  return extend ? launch_up2<float, 1>(x, y, planes, H, W, gain, s) : launch_up2<float, 0>(x, y, planes, H, W, gain, s);
}

// x: [planes, H, W] with H, W even; y: [planes, H/2 + pad - 1, W/2 + pad - 1].
extern "C" int pasta_down2(const void* x, void* y, int bf16, long long planes, int H, int W, int pad,
                           float gain, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (bf16) {
    return pad ? launch_down2<__nv_bfloat16, 1>(x, y, planes, H, W, gain, s)
               : launch_down2<__nv_bfloat16, 0>(x, y, planes, H, W, gain, s);
  }
  return pad ? launch_down2<float, 1>(x, y, planes, H, W, gain, s) : launch_down2<float, 0>(x, y, planes, H, W, gain, s);
}
