// BCS block-sparse matmul for Hopper (sm_90a):
//   out[:, cols[j]*bn + c] = act(sum_l x[:, k_idx[j,l]*bk : +bk] @ values[j,l][:, c] + bias)
// over the block columns j of ONE degree bin of a PackedLayout.
//
// Replaces the Pallas TPU kernel `bsr_matmul` (body `_kernel`) in
// src/repro/kernels/bsr_matmul.py:63 (launch :143).  There the sequential
// grid (M/bm, Nb, L) carried an fp32 VMEM accumulator across the L steps.
// Here one thread block owns one (M tile, block column j) pair and walks the
// column's slots itself, so nothing carries between blocks.
//
// What bounds it on an H100: the bytes of the live value blocks.  Each is
// read once and used for M rows, so the arithmetic intensity is about M
// flop/byte in bf16, below the card's ~295 at decode (M = 4) and at prefill
// (M = 128) alike.  This version multiplies on CUDA cores in fp32 (the
// block menu has (4,4) and (8,16) blocks, below any MMA tile), so at
// prefill the FMA rate, not the bound, limits it.  What the design
// does about the bytes: the slots of column j are one contiguous
// (L*bk, bn) run of `values`, streamed through shared memory with 16-byte
// loads in chunks as deep as the shared-memory budget allows, and every
// thread of the block works on every chunk: the 256 threads split into
// G = 256/bn reduction groups x bn columns, each thread accumulating all
// rows of the M tile over the reduction rows q with q % G == its group.
//
// Numerics: each thread sums its reduction rows in increasing q order in
// fp32 registers (q = l*bk + kk), and the G group partials of an output
// are then added in group order 0..G-1.  Which rows a group sums depends
// only on q (chunks start at multiples of G), so an output's sum order
// depends only on its column's slot list; padding slots hold zero values
// and add exact zeros.  Reordered and unreordered layouts of one weight
// therefore give bit-identical outputs.  Bias and activation are applied
// to the fp32 sum, followed by one rounding to the output type.  Ragged M
// is masked here: rows >= M are never loaded or stored.
//
// The implicit-GEMM conv (bsr_conv2d_implicit_launch) is the same kernel
// with another x loader.  It replaces the Pallas TPU kernel
// `_conv_implicit_bin` (body `_conv_kernel`) in
// src/repro/kernels/bsr_matmul.py:444 (launch :483, wrapper
// `bsr_conv2d_implicit` :542).  The TPU kernel pins a whole padded image in
// VMEM; here each block gathers its rows straight from the padded NHWC
// image in global memory (through L1/L2): x row m is output position
// (b, ho, wo) = decode(m), and K-block kb of the lowered weight reads
// channels [c0, c0 + bk) of kernel tap (dy, dx) = conv_taps[kb], i.e.
// xp[b, ho*s + dy, wo*s + dx, c0 + kk].  The patch tensor never exists.
// Bound on an H100: for the fp32 convs of the CNN path, the executed FLOPs
// at the CUDA-core fp32 rate (the live blocks are small, (8, 8)); the
// materialized mode adds the patch tensor's bytes, which the implicit mode
// does not move.  The design does nothing more about the FLOP rate yet
// (no tensor cores): it keeps the accumulation code of kernel 1 unchanged,
// so implicit and materialized convs give bit-identical outputs.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC (see repro_torch/kernels/_build.py); bound with ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRows = 8;              // rows of an M tile (one thread's)
constexpr int kSmemBudget = 40 * 1024;   // bytes; below the 48 KB default cap

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(
    __nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(
    float v) {
  return __float2bfloat16_rn(v);
}

// dst[0:n] = float(src[0:n]), 16-byte loads where src is 16-byte aligned
template <typename T>
__device__ __forceinline__ void load_f32(float* dst, const T* __restrict__ src,
                                         int n, int tid) {
  constexpr int kVec = 16 / sizeof(T);
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int nv = n / kVec;
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    for (int i = tid; i < nv; i += kThreads) {
      uint4 u = __ldg(s4 + i);
      const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int k = 0; k < kVec; ++k) dst[i * kVec + k] = to_f32(e[k]);
    }
    for (int i = nv * kVec + tid; i < n; i += kThreads)
      dst[i] = to_f32(src[i]);
  } else {
    for (int i = tid; i < n; i += kThreads) dst[i] = to_f32(src[i]);
  }
}

// Geometry of the implicit conv: x is the padded image (B, Hp, Wp, C),
// row m of the lowered GEMM is output position (b, ho, wo), and taps is
// the (Kb, 3) int32 (dy, dx, c0) table of the K-blocks.
struct ConvGeom {
  const int* taps;
  int C, Wp, HpWp, Ho, Wo, stride;
};

// element offset of output position m's top-left input pixel
__device__ __forceinline__ size_t conv_row_base(int m, const ConvGeom& g) {
  const int howo = g.Ho * g.Wo;
  const int b = m / howo;
  const int p = m - b * howo;
  const int ho = p / g.Wo;
  const int wo = p - ho * g.Wo;
  return ((size_t)b * g.HpWp + (size_t)ho * g.stride * g.Wp +
          (size_t)wo * g.stride) * g.C;
}

// act: 0 none, 1 silu, 2 relu.  CONV selects the x loader: false reads
// row m of the (M, K) matrix x; true gathers it from the padded image.
template <typename T, int RPT, bool CONV>
__global__ void __launch_bounds__(kThreads)
bsr_matmul_kernel(const T* __restrict__ x, const T* __restrict__ values,
                  const int* __restrict__ k_idx, const int* __restrict__ cols,
                  const T* __restrict__ bias, T* __restrict__ out, int M,
                  int ldx, int L, int bk_log2, int bn, int ldo, int kc,
                  int act, ConvGeom geom) {
  extern __shared__ float smem[];
  const int G = kThreads / bn;             // reduction groups
  const int bk = 1 << bk_log2;
  const int j = blockIdx.y;
  const int m0 = blockIdx.x * RPT;
  const int rows = min(RPT, M - m0);
  const int tid = threadIdx.x;
  const int c = tid % bn;
  const int g = tid / bn;
  const int xs_ld = kc + 1;                // odd stride: no bank conflicts
  float* xs = smem;                        // (RPT, kc) gathered x columns
  float* vs = smem + RPT * xs_ld;          // (kc, bn) value rows

  const int R = L * bk;                    // reduction length of column j
  const T* vals_j = values + (size_t)j * R * bn;
  const int* kidx_j = k_idx + (size_t)j * L;
  // start of each row's x: row m of x, or its input pixel in the image
  size_t xrow[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
    xrow[i] = (i < rows) ? (CONV ? conv_row_base(m0 + i, geom)
                                 : (size_t)(m0 + i) * ldx)
                         : 0;

  float acc[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) acc[i] = 0.f;

  for (int q0 = 0; q0 < R; q0 += kc) {
    const int n = min(kc, R - q0);
    // rows q0 .. q0+n of column j's (L*bk, bn) value run are contiguous
    load_f32(vs, vals_j + (size_t)q0 * bn, n * bn, tid);
    // the matching x columns, gathered through k_idx (and, for the
    // implicit conv, through the K-block's tap offsets)
    for (int q = tid; q < n; q += kThreads) {
      const int gq = q0 + q;
      const int kb = kidx_j[gq >> bk_log2];
      const int kk = gq & (bk - 1);
      int col;
      if (CONV) {
        const int* tp = geom.taps + 3 * kb;
        col = (tp[0] * geom.Wp + tp[1]) * geom.C + tp[2] + kk;
      } else {
        col = kb * bk + kk;
      }
#pragma unroll
      for (int r = 0; r < RPT; ++r)
        if (r < rows) xs[r * xs_ld + q] = to_f32(x[xrow[r] + col]);
    }
    __syncthreads();
    for (int q = g; q < n; q += G) {
      const float w = vs[q * bn + c];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
        if (i < rows) acc[i] = fmaf(xs[i * xs_ld + q], w, acc[i]);
    }
    __syncthreads();
  }

  // add the G group partials of each output in group order
  float* red = smem;                       // (G, RPT, bn), reuses xs/vs
#pragma unroll
  for (int i = 0; i < RPT; ++i) red[(g * RPT + i) * bn + c] = acc[i];
  __syncthreads();
  const int oc = cols[j] * bn;
  for (int o = tid; o < rows * bn; o += kThreads) {
    const int i = o / bn;
    const int cc = o - i * bn;
    float y = red[i * bn + cc];
    for (int gg = 1; gg < G; ++gg) y += red[(gg * RPT + i) * bn + cc];
    if (bias != nullptr) y += to_f32(bias[oc + cc]);
    if (act == 1) {
      y = y / (1.f + expf(-y));
    } else if (act == 2) {
      y = fmaxf(y, 0.f);
    }
    out[(size_t)(m0 + i) * ldo + oc + cc] = from_f32<T>(y);
  }
}

template <typename T, bool CONV>
cudaError_t launch_typed(const void* x, const void* values, const int* k_idx,
                         const int* cols, const void* bias, void* out, int M,
                         int ldx, int nb, int L, int bk, int bn, int ldo,
                         int act, const ConvGeom& geom, cudaStream_t stream) {
  const int G = kThreads / bn;
  int rpt = 1;
  while (rpt < kMaxRows && rpt < M) rpt *= 2;
  int bk_log2 = 0;
  while ((1 << bk_log2) < bk) ++bk_log2;
  // deepest chunk that fits: a multiple of G (so a reduction row's group
  // is fixed by q alone) and of 8 (so xs_ld = kc + 1 is odd)
  const int unit = G > 8 ? G : 8;
  int kc = (kSmemBudget / 4 - rpt) / (rpt + bn);
  kc = (kc / unit) * unit;
  const int R = L * bk;
  const int r_units = ((R + unit - 1) / unit) * unit;
  if (kc > r_units) kc = r_units;
  if (kc < unit) return cudaErrorInvalidConfiguration;
  size_t floats = (size_t)rpt * (kc + 1) + (size_t)kc * bn;
  const size_t red = (size_t)G * rpt * bn;
  if (floats < red) floats = red;
  const size_t smem = floats * sizeof(float);
  // M tiles on x (no 65535 cap), block columns on y
  if (nb > 65535) return cudaErrorInvalidConfiguration;
  const dim3 grid((M + rpt - 1) / rpt, nb);
  const T* xt = static_cast<const T*>(x);
  const T* vt = static_cast<const T*>(values);
  const T* bt = static_cast<const T*>(bias);
  T* ot = static_cast<T*>(out);
#define BSR_LAUNCH(RPT_)                                                  \
  bsr_matmul_kernel<T, RPT_, CONV><<<grid, kThreads, smem, stream>>>(     \
      xt, vt, k_idx, cols, bt, ot, M, ldx, L, bk_log2, bn, ldo, kc, act,  \
      geom)
  switch (rpt) {
    case 1: BSR_LAUNCH(1); break;
    case 2: BSR_LAUNCH(2); break;
    case 4: BSR_LAUNCH(4); break;
    default: BSR_LAUNCH(8); break;
  }
#undef BSR_LAUNCH
  return cudaGetLastError();
}

bool bad_args(int nb, int L, int bk, int bn, int act) {
  return nb <= 0 || bn <= 0 || bn > kThreads || kThreads % bn != 0 ||
         bk <= 0 || (bk & (bk - 1)) != 0 || L <= 0 || act < 0 || act > 2;
}

template <bool CONV>
int launch(const void* x, const void* values, const void* k_idx,
           const void* cols, const void* bias, void* out, int M, int ldx,
           int nb, int L, int bk, int bn, int ldo, int act, int dtype,
           const ConvGeom& geom, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ki = static_cast<const int*>(k_idx);
  const int* co = static_cast<const int*>(cols);
  if (dtype == 0)
    return (int)launch_typed<float, CONV>(x, values, ki, co, bias, out, M,
                                          ldx, nb, L, bk, bn, ldo, act, geom,
                                          s);
  if (dtype == 1)
    return (int)launch_typed<__nv_bfloat16, CONV>(x, values, ki, co, bias,
                                                  out, M, ldx, nb, L, bk, bn,
                                                  ldo, act, geom, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (x, values, bias and out share it).
// bk must be a power of two and bn must divide 256 (every block of the
// menu in core/regularity.py qualifies).  Returns the cudaError_t of the
// launch (0 on success); the caller raises.
extern "C" int bsr_matmul_launch(const void* x, const void* values,
                                 const void* k_idx, const void* cols,
                                 const void* bias, void* out, int M, int ldx,
                                 int nb, int L, int bk, int bn, int ldo,
                                 int act, int dtype, void* stream) {
  if (M <= 0) return 0;
  if (bad_args(nb, L, bk, bn, act)) return (int)cudaErrorInvalidValue;
  const ConvGeom none{nullptr, 0, 0, 0, 1, 1, 1};
  return launch<false>(x, values, k_idx, cols, bias, out, M, ldx, nb, L, bk,
                       bn, ldo, act, dtype, none, stream);
}

// The implicit conv: xp is the padded NHWC image (B, Hp, Wp, C) with
// HpWp = Hp * Wp, taps the (Kb, 3) int32 (dy, dx, c0) table, and out the
// (M, N) output with M = B * Ho * Wo rows in (b, ho, wo) order.  bk must
// divide C (every K-block inside one tap).
extern "C" int bsr_conv2d_implicit_launch(
    const void* xp, const void* values, const void* k_idx, const void* cols,
    const void* taps, const void* bias, void* out, int M, int nb, int L,
    int bk, int bn, int ldo, int act, int dtype, int C, int Wp, int HpWp,
    int Ho, int Wo, int stride, void* stream) {
  if (M <= 0) return 0;
  if (bad_args(nb, L, bk, bn, act) || C <= 0 || C % bk != 0 || Ho <= 0 ||
      Wo <= 0 || stride <= 0 || taps == nullptr)
    return (int)cudaErrorInvalidValue;
  const ConvGeom geom{static_cast<const int*>(taps), C, Wp, HpWp, Ho, Wo,
                      stride};
  return launch<true>(xp, values, k_idx, cols, bias, out, M, 0, nb, L, bk,
                      bn, ldo, act, dtype, geom, stream);
}
