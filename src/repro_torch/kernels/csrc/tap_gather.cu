// Tap-gather convolution for Hopper (sm_90a), one degree bin of a TapLayout:
//   out[m, cols[g]*group + c] = act(sum_l x(m, slot[g, l]) * values[g, l, c]
//                                   + bias[cols[g]*group + c])
// for the filter groups g of the bin and c < group.
//
// Replaces two Pallas TPU kernels of src/repro/kernels/bsr_matmul.py:
//   * `tap_gather_conv` (body `_tap_kernel` :287, launch :314, wrapper
//     `tap_gather_conv_packed` :386): x(m, t) is column t of the alive
//     im2col band (M, R), slot = t_idx (materialized mode);
//   * `_tap_implicit_bin` (body `_tap_conv_kernel` :584, launch :613,
//     wrapper `tap_gather_conv_implicit` :668): x(m, k) is read straight from
//     the padded NHWC image, k = k_full = tap*C + channel, tap = dy*kw + dx,
//     at xp[b, ho*s + dy, wo*s + dx, channel] (implicit mode).  Neither the
//     patch tensor nor the alive band exists.
// The TPU kernels keep the whole band / image in VMEM and contract a group's
// gathered (bm, L) taps in one MXU dot.  Pattern masks give every filter its
// own tap list (group = 1), which is no tensor-core tile shape, so here each
// thread owns one output element and walks its group's slots.
//
// What bounds it on an H100: the executed FLOPs (sum over bins of G_b * L_b
// slots, times M) at the CUDA-core fp32 rate, one gathered x value per FMA;
// the materialized mode adds the band's bytes.  What the design does: the
// slot table and the values of a chunk of slots are staged in shared memory
// once per block and read as broadcasts (every thread of a warp reads the
// same slot); a warp is 32 consecutive output rows of one column, so in the
// implicit mode neighbouring threads read neighbouring output pixels, and in
// the materialized mode the block first stages its rows of the band into
// shared memory with contiguous (coalesced) loads when they fit (mode 0),
// else reads the band from global memory (mode 1).  Tensor cores, cp.async
// and tuning are later work.
//
// Numerics: every output is one fp32 FMA chain over its group's slots in
// slot order l = 0 .. L-1, whatever the mode, the chunking or the binning;
// padding slots come last with zero values and add exact zeros.  So the
// implicit and materialized modes, and reordered and unreordered layouts
// (any bin count), give bit-identical outputs.  Bias and activation apply
// to the fp32 sum, then one rounding to the output type.  Rows >= M are
// neither loaded nor stored.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC (see repro_torch/kernels/_build.py); bound with ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kColsPerThread = 4;        // output columns one thread owns
constexpr int kSlotChunk = 64;           // slots staged per round
constexpr int kSmemMax = 200 * 1024;     // dynamic shared memory cap (bytes)

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

// mode 0: band rows staged in shared memory; 1: band read from global
// memory; 2: implicit, gathered from the padded image.
struct TapGeom {
  int C, kw, Wp, HpWp, Ho, Wo, stride;
};

template <typename T, int MODE>
__global__ void __launch_bounds__(kThreads)
tap_gather_kernel(const T* __restrict__ x, const T* __restrict__ values,
                  const int* __restrict__ slots, const int* __restrict__ cols,
                  const T* __restrict__ bias, T* __restrict__ out, int M,
                  int ldx, int R, int n_cols, int L, int group, int ldo,
                  int tg, int cb, int band_ld, int act, TapGeom geom) {
  extern __shared__ float smem[];
  const int tr = kThreads / tg;            // rows of the block
  const int tid = threadIdx.x;
  const int r = tid % tr;                  // a warp: 32 consecutive rows
  const int lane = tid / tr;               // ... of one column lane
  const int m0 = blockIdx.x * tr;
  const int m = m0 + r;
  const bool valid = m < M;
  const int c_begin = blockIdx.y * cb;
  const int ncols = min(cb, n_cols - c_begin);
  const int g_lo = c_begin / group;
  const int ngb = (c_begin + ncols - 1) / group - g_lo + 1;

  float* vs = smem;                        // (kSlotChunk, cb) values
  int* ts = reinterpret_cast<int*>(vs + kSlotChunk * cb);  // (chunk, cb)
  float* xs = reinterpret_cast<float*>(ts + kSlotChunk * cb);  // mode 0

  if (MODE == 0) {                         // the block's rows of the band
    const int rows = min(tr, M - m0);
    for (int i = tid; i < tr * R; i += kThreads) {
      const int rr = i / R;
      const int t = i - rr * R;
      xs[rr * band_ld + t] =
          rr < rows ? to_f32(x[(size_t)(m0 + rr) * ldx + t]) : 0.f;
    }
  }
  size_t xbase = 0;                        // row start (modes 1, 2)
  if (valid) {
    if (MODE == 1) {
      xbase = (size_t)m * ldx;
    } else if (MODE == 2) {
      const int howo = geom.Ho * geom.Wo;
      const int b = m / howo;
      const int p = m - b * howo;
      const int ho = p / geom.Wo;
      const int wo = p - ho * geom.Wo;
      xbase = ((size_t)b * geom.HpWp + (size_t)ho * geom.stride * geom.Wp +
               (size_t)wo * geom.stride) * geom.C;
    }
  }

  int jcol[kColsPerThread], gi[kColsPerThread];
#pragma unroll
  for (int k = 0; k < kColsPerThread; ++k) {
    jcol[k] = lane + k * tg;
    gi[k] = (c_begin + jcol[k]) / group - g_lo;
  }
  float acc[kColsPerThread];
#pragma unroll
  for (int k = 0; k < kColsPerThread; ++k) acc[k] = 0.f;

  for (int l0 = 0; l0 < L; l0 += kSlotChunk) {
    const int n = min(kSlotChunk, L - l0);
    __syncthreads();                       // the previous chunk is consumed
    for (int i = tid; i < n * ncols; i += kThreads) {
      const int l = i / ncols;
      const int j = i - l * ncols;
      const int oc = c_begin + j;
      const int g = oc / group;
      const int c = oc - g * group;
      vs[l * cb + j] = to_f32(values[((size_t)g * L + l0 + l) * group + c]);
    }
    for (int i = tid; i < n * ngb; i += kThreads) {
      const int l = i / ngb;
      const int gg = i - l * ngb;
      int s = slots[(size_t)(g_lo + gg) * L + l0 + l];
      if (MODE == 2) {                     // k_full -> image offset
        const int tap = s / geom.C;
        const int ch = s - tap * geom.C;
        const int dy = tap / geom.kw;
        const int dx = tap - dy * geom.kw;
        s = (dy * geom.Wp + dx) * geom.C + ch;
      }
      ts[l * cb + gg] = s;
    }
    __syncthreads();
    for (int l = 0; l < n; ++l) {
#pragma unroll
      for (int k = 0; k < kColsPerThread; ++k) {
        if (jcol[k] < ncols) {
          const int s = ts[l * cb + gi[k]];
          float xv;
          if (MODE == 0) {
            xv = xs[r * band_ld + s];
          } else {
            xv = valid ? to_f32(x[xbase + s]) : 0.f;
          }
          acc[k] = fmaf(xv, vs[l * cb + jcol[k]], acc[k]);
        }
      }
    }
  }

  if (!valid) return;
#pragma unroll
  for (int k = 0; k < kColsPerThread; ++k) {
    if (jcol[k] >= ncols) continue;
    const int oc = c_begin + jcol[k];
    const int g = oc / group;
    const int oo = cols[g] * group + (oc - g * group);
    float y = acc[k];
    if (bias != nullptr) y += to_f32(bias[oo]);
    if (act == 1) {
      y = y / (1.f + expf(-y));
    } else if (act == 2) {
      y = fmaxf(y, 0.f);
    }
    out[(size_t)m * ldo + oo] = from_f32<T>(y);
  }
}

template <typename T, int MODE>
cudaError_t launch_mode(const T* x, const T* values, const int* slots,
                        const int* cols, const T* bias, T* out, int M,
                        int ldx, int R, int n_cols, int L, int group,
                        int ldo, int tg, int cb, int band_ld, int act,
                        const TapGeom& geom, size_t smem,
                        cudaStream_t stream) {
  static bool attr_set = false;            // once per instantiation
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        tap_gather_kernel<T, MODE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  const int tr = kThreads / tg;
  const dim3 grid((M + tr - 1) / tr, (n_cols + cb - 1) / cb);
  tap_gather_kernel<T, MODE><<<grid, kThreads, smem, stream>>>(
      x, values, slots, cols, bias, out, M, ldx, R, n_cols, L, group, ldo,
      tg, cb, band_ld, act, geom);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_typed(const void* x, const void* values, const int* slots,
                         const int* cols, const void* bias, void* out, int M,
                         int ldx, int R, int ng, int L, int group, int ldo,
                         int act, bool implicit, const TapGeom& geom,
                         cudaStream_t stream) {
  const int n_cols = ng * group;
  // column lanes: as many as the bin has columns, up to 8 (256 / 8 = 32
  // rows, one warp per lane); each lane owns up to kColsPerThread columns
  int tg = 8;
  while (tg > 1 && tg / 2 >= n_cols) tg /= 2;
  const int cb = n_cols < kColsPerThread * tg ? n_cols
                                               : kColsPerThread * tg;
  const int tr = kThreads / tg;
  const size_t tables = (size_t)2 * kSlotChunk * cb * sizeof(float);
  const int band_ld = R | 1;               // odd stride: no bank conflicts
  const size_t band = (size_t)tr * band_ld * sizeof(float);
  const T* xt = static_cast<const T*>(x);
  const T* vt = static_cast<const T*>(values);
  const T* bt = static_cast<const T*>(bias);
  T* ot = static_cast<T*>(out);
  if (implicit)
    return launch_mode<T, 2>(xt, vt, slots, cols, bt, ot, M, 0, 0, n_cols, L,
                             group, ldo, tg, cb, 0, act, geom, tables,
                             stream);
  if (tables + band <= (size_t)kSmemMax)
    return launch_mode<T, 0>(xt, vt, slots, cols, bt, ot, M, ldx, R, n_cols,
                             L, group, ldo, tg, cb, band_ld, act, geom,
                             tables + band, stream);
  return launch_mode<T, 1>(xt, vt, slots, cols, bt, ot, M, ldx, R, n_cols, L,
                           group, ldo, tg, cb, 0, act, geom, tables, stream);
}

int launch(const void* x, const void* values, const void* slots,
           const void* cols, const void* bias, void* out, int M, int ldx,
           int R, int ng, int L, int group, int ldo, int act, int dtype,
           bool implicit, const TapGeom& geom, void* stream) {
  if (M <= 0) return 0;
  if (ng <= 0 || L <= 0 || group <= 0 || act < 0 || act > 2 ||
      ng * group > 65535 * kColsPerThread * 8)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* sl = static_cast<const int*>(slots);
  const int* co = static_cast<const int*>(cols);
  if (dtype == 0)
    return (int)launch_typed<float>(x, values, sl, co, bias, out, M, ldx, R,
                                    ng, L, group, ldo, act, implicit, geom,
                                    s);
  if (dtype == 1)
    return (int)launch_typed<__nv_bfloat16>(x, values, sl, co, bias, out, M,
                                            ldx, R, ng, L, group, ldo, act,
                                            implicit, geom, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Materialized mode: x is the alive band (M, R) with row stride ldx,
// t_idx the bin's (ng, L) int32 band columns.  values (ng, L, group),
// cols (ng,) int32 original group of each layout group, bias None or (P,)
// in ORIGINAL order, out (M, P) with row stride ldo.  dtype: 0 float32,
// 1 bfloat16.  Returns the cudaError_t of the launch (0 on success).
extern "C" int tap_gather_launch(const void* x, const void* values,
                                 const void* t_idx, const void* cols,
                                 const void* bias, void* out, int M, int ldx,
                                 int R, int ng, int L, int group, int ldo,
                                 int act, int dtype, void* stream) {
  if (R <= 0 || ldx < R) return (int)cudaErrorInvalidValue;
  const TapGeom none{1, 1, 0, 0, 1, 1, 1};
  return launch(x, values, t_idx, cols, bias, out, M, ldx, R, ng, L, group,
                ldo, act, dtype, false, none, stream);
}

// Implicit mode: xp is the padded NHWC image (B, Hp, Wp, C), HpWp = Hp*Wp,
// k_full the bin's (ng, L) int32 full-band rows (tap*C + channel, tap =
// dy*kw + dx), out (M, P) with M = B*Ho*Wo rows in (b, ho, wo) order.
extern "C" int tap_gather_implicit_launch(
    const void* xp, const void* values, const void* k_full, const void* cols,
    const void* bias, void* out, int M, int ng, int L, int group, int ldo,
    int act, int dtype, int C, int kw, int Wp, int HpWp, int Ho, int Wo,
    int stride, void* stream) {
  if (C <= 0 || kw <= 0 || Ho <= 0 || Wo <= 0 || stride <= 0)
    return (int)cudaErrorInvalidValue;
  const TapGeom geom{C, kw, Wp, HpWp, Ho, Wo, stride};
  return launch(xp, values, k_full, cols, bias, out, M, 0, 0, ng, L, group,
                ldo, act, dtype, true, geom, stream);
}
