// Tap-gather convolutions for Hopper (sm_90a):
//   out[m, cols[g]*group + c] = act(sum_l x(m, slot[g, l]) * values[g, l, c]
//                                   + bias[cols[g]*group + c])
// for the filter groups g of a TapLayout and c < group.
//
// Kernel 4, tap_conv_kernel (tap_conv_launch), one launch over every bin
// from the NHWC image, slot = k_full = tap*C + channel, tap = dy*kw + dx:
// replaces `_tap_implicit_bin` (body `_tap_conv_kernel` :584, launch :613,
// wrapper `tap_gather_conv_implicit` :668) of src/repro/kernels/
// bsr_matmul.py.  Neither the patch tensor nor the alive band exists.
//
// Kernel 2, the materialized tap gather over the alive im2col band (M, R),
// slot = t_idx: replaces the Pallas TPU kernel `tap_gather_conv` (body
// `_tap_kernel` :287, launch :314, wrapper `tap_gather_conv_packed` :386).
// On the card it is this same kernel 4, the band read as a 1 x M image of
// R channels (a 1x1 conv whose channel c is band row c), so kernel 2 and
// kernel 4 share one FMA chain per output and agree bitwise.  Pattern
// masks give every filter its own tap list (group = 1), no tensor-core
// tile shape, so the kernel uses fp32 FMAs on CUDA cores.
//
// What bounds kernel 4 on an H100: its executed FLOPs need one staged
// input per FMA, so shared-memory reads (one 32-lane word load per clock
// an SM) bound it near 1/4 of the fp32 FMA rate; at VGG_TINY's shapes its
// bytes (image and output) take less time than that.  What held the first
// port back: one output a thread, and every FMA a global load whose warp
// touched 32 sectors (neighbouring lanes C*4*s bytes apart), repeated for
// every filter and bin.  What the design does:
//   * one block per tile of output rows of one image, one launch over all
//     bins; it stages the input window, halo zero-filled, all C channels,
//     channel-major in shared memory (4-byte cp.async, coalesced NHWC
//     reads), stride-s columns split into s phases, and 2^cg_log2 channels
//     side by side in a row so that a warp's 32 positions across several
//     tile rows hit 32 different banks; every filter walks that window;
//   * a lane owns R positions of one filter: per slot one broadcast read
//     of (window offset, value) feeds R FMAs; the offsets come from a
//     per-geometry table, and each warp copies its filter's slots 32 at a
//     time into a shared-memory buffer, the next 32 already in flight;
//   * results gather in a shared-memory (tile, N) tile and leave as whole
//     output rows.
// The tile, the lanes' R, the row layout and the shared-memory bytes come
// from conv_plan in repro_torch/kernels/bsr_matmul.py.
//
// int8 values (the dequant branch of `_tap_kernel` :296-300 and
// `_tap_conv_kernel` :597-600, a scale per tap slot or per filter): a
// slot's table entry stays 8 bytes, (input word + q * 2^16, its fp32
// scale), the word below 2^16 as shared memory caps it; the kernel
// dequantizes once a slot, w = (float)q * s, before its R FMAs.
//
// Numerics: every output is one fp32 FMA chain over its group's slots in
// slot order l = 0 .. L-1, from 0, whatever the tile, R or binning;
// padding slots come last with zero values and add exact zeros.  So the
// implicit and the materialized mode, and reordered and unreordered
// layouts (any bin count), give bit-identical outputs.  Bias and
// activation apply to the fp32 sum, then one rounding to the output type
// (x's, or either of fp32 and bf16 as the caller asks: out_dtype).
//
// ptxas -v (CUDA 12.8, -O3, sm_90a): kernel 4 in fp32 96 registers at
// R = 8, 63 at R = 4, 56 at R = 2 and 1 (bf16 61-96), no spills, under
// __launch_bounds__(256, 2); dynamic shared memory per conv_plan, 40-114
// KB at VGG_TINY's pattern layers (two blocks an SM).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC (see repro_torch/kernels/_build.py); bound with ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

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

// ---------------------------------------------------------------------------
// Kernel 4: the tap-gather conv from an input tile staged in shared memory.

constexpr int kConvThreads = 256;
constexpr int kConvWarps = kConvThreads / 32;
constexpr int kConvSmemMax = 232448;     // bytes a block may use (227 KB)

// One launch's tile geometry, filled by conv_plan in
// repro_torch/kernels/bsr_matmul.py (ConvPlan.args, same field order).
struct ConvTile {
  int B, H, W, C;                        // unpadded NHWC input
  int Ho, Wo, stride, ph0, pw0;          // output, low SAME padding
  int tr, tw, tiles_h, tiles_w;          // output tile, tiles per image
  int rows_in, cols_in, nph, pitch;      // staged window, column phases
  int chan_ld;                           // words per channel-group plane
  int cg_log2;                           // log2 channels side by side a row
  int R, warps_pos, n_cols, N, out_ld;   // lanes, columns, output tile
  int x_floats;                          // floats of the staged window
};
static_assert(sizeof(ConvTile) == 25 * sizeof(int),
              "ConvTile must match ConvPlan.args()");

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool pred) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(pred ? 4 : 0));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// Stage the block's input window channel-major: channel ch of pixel (row,
// col) at float (ch >> cg_log2) * chan_ld + (ch % 2^cg_log2) * s * nph +
// row * pitch + pc, pc = (col % s) * nph + col / s: neighbouring output
// positions read neighbouring words, and 2^cg_log2 channels share a row so
// that a warp's 32 positions over several tile rows hit 32 banks.
// Reads are coalesced (NHWC order), one 4-byte cp.async a word in fp32 (a
// 16-byte load scattered into 4 planes measured slower); pixels outside
// the image (the SAME halo) are zero-filled.
template <typename T>
__device__ __forceinline__ void stage_planes(float* xs,
                                             const T* __restrict__ x,
                                             const ConvTile& g, int b,
                                             int hi0, int wi0) {
  const int per_row = g.cols_in * g.C;
  const int tid = threadIdx.x;
  const int col0 = tid / g.C, ch0 = tid - col0 * g.C;
  const int dcol = kConvThreads / g.C, dch = kConvThreads - dcol * g.C;
  const int cw = g.stride * g.nph;       // words of one channel in a row
  const int cmask = (1 << g.cg_log2) - 1;
  for (int row = 0; row < g.rows_in; ++row) {
    const int hi = hi0 + row;
    const bool row_ok = hi >= 0 && hi < g.H;
    const T* src_row =
        x + ((size_t)b * g.H + (row_ok ? hi : 0)) * g.W * g.C;
    float* dst_row = xs + row * g.pitch;
    int col = col0, ch = ch0;
    for (int u = tid; u < per_row; u += kConvThreads) {
      const int wi = wi0 + col;
      const bool ok = row_ok && wi >= 0 && wi < g.W;
      const int pc = g.stride == 1 ? col
                                   : (col % g.stride) * g.nph + col / g.stride;
      float* dst =
          dst_row + (ch >> g.cg_log2) * g.chan_ld + (ch & cmask) * cw + pc;
      const T* src = src_row + (size_t)(ok ? wi : 0) * g.C + ch;
      if constexpr (sizeof(T) == 4) {
        cp_async4(dst, src, ok);
      } else {
        *dst = ok ? to_f32(*src) : 0.f;
      }
      col += dcol;
      ch += dch;
      if (ch >= g.C) {
        ch -= g.C;
        ++col;
      }
    }
  }
  if constexpr (sizeof(T) == 4) cp_async_wait_all();
}

constexpr int kSlotBuf = 32;             // slots a warp buffers at once
constexpr int kWordBits = 16;            // an int8 slot's input word bits

// Block (tile): stage the window, then every warp walks its output columns
// j = wc, wc + 8 / warps_pos, ...: it copies a column's slots (input word,
// value), 32 at a time, into its own shared-memory buffer, the next 32
// already in flight in registers (the next column's first 32 at a column's
// end), and per slot one broadcast read of the buffer feeds R FMAs, one
// per position of the lane, each reading the staged window at the slot's
// word plus the position's.  Q: an int8 layout's slots, (word + q * 2^16,
// the slot's fp32 scale), each dequantized once a slot, w = (float)q * s
// (the reference's order), before its R FMAs.
template <typename T, bool Q, int R>
__global__ void __launch_bounds__(kConvThreads, 2)
tap_conv_kernel(const T* __restrict__ x, const int2* __restrict__ slots,
                const int4* __restrict__ meta, const T* __restrict__ bias,
                void* __restrict__ out, int ldo, int out_dtype, int act,
                ConvTile g) {
  extern __shared__ float4 smem4[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int2* sbuf = reinterpret_cast<int2*>(smem4) + warp * kSlotBuf;
  float* xs = reinterpret_cast<float*>(smem4) + 2 * kConvWarps * kSlotBuf;
  float* os = xs + g.x_floats;           // (tr * tw, out_ld) results
  int t = blockIdx.x;
  const int tx = t % g.tiles_w;
  t /= g.tiles_w;
  const int ty = t % g.tiles_h;
  const int b = t / g.tiles_h;
  const int ho0 = ty * g.tr, wo0 = tx * g.tw;
  stage_planes<T>(xs, x, g, b, ho0 * g.stride - g.ph0,
                  wo0 * g.stride - g.pw0);

  const int wp = warp % g.warps_pos, wc = warp / g.warps_pos;
  const int warps_col = kConvWarps / g.warps_pos;
  const int tp = g.tr * g.tw;
  int poff[R], pos[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int p = lane + 32 * (wp + g.warps_pos * i);
    pos[i] = p < tp ? p : -1;
    const int pp = p < tp ? p : 0;
    const int r = pp / g.tw, c = pp - r * g.tw;
    poff[i] = r * g.stride * g.pitch + c;
  }
  __syncthreads();

  const int4 none = make_int4(0, 0, 0, 0);
  int4 mt = wc < g.n_cols ? __ldg(meta + wc) : none;
  int2 nxt = lane < mt.y ? __ldg(slots + mt.x + lane) : make_int2(0, 0);
  for (int j = wc; j < g.n_cols; j += warps_col) {
    const int4 cur = mt;                 // first slot, slots, column
    mt = j + warps_col < g.n_cols ? __ldg(meta + j + warps_col) : none;
    float acc[R];
#pragma unroll
    for (int i = 0; i < R; ++i) acc[i] = 0.f;
    for (int c0 = 0; c0 < cur.y; c0 += kSlotBuf) {
      __syncwarp();
      sbuf[lane] = nxt;
      __syncwarp();
      const int cn = c0 + kSlotBuf;
      if (cn < cur.y) {
        nxt = cn + lane < cur.y ? __ldg(slots + cur.x + cn + lane)
                                : make_int2(0, 0);
      } else {
        nxt = lane < mt.y ? __ldg(slots + mt.x + lane) : make_int2(0, 0);
      }
      const int n = min(kSlotBuf, cur.y - c0);
#pragma unroll 4
      for (int k = 0; k < n; ++k) {
        const int2 e = sbuf[k];
        float w = __int_as_float(e.y);
        const float* xb = xs + e.x;
        if constexpr (Q) {
          w = (float)(e.x >> kWordBits) * w;
          xb = xs + (e.x & ((1 << kWordBits) - 1));
        }
#pragma unroll
        for (int i = 0; i < R; ++i) acc[i] = fmaf(xb[poff[i]], w, acc[i]);
      }
    }
    const int oo = cur.z;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      if (pos[i] < 0) continue;
      float y = acc[i];
      if (bias != nullptr) y += to_f32(bias[oo]);
      if (act == 1) {
        y = y / (1.f + expf(-y));
      } else if (act == 2) {
        y = y < 0.f ? 0.f : y;   // NaN passes, as torch.relu passes it
      }
      os[pos[i] * g.out_ld + oo] = y;
    }
  }
  __syncthreads();

  // the tile's rows of the output, each a contiguous run of N columns
  for (int p = warp; p < tp; p += kConvWarps) {
    const int r = p / g.tw, c = p - r * g.tw;
    const int ho = ho0 + r, wo = wo0 + c;
    if (ho >= g.Ho || wo >= g.Wo) continue;
    const size_t row = ((size_t)(b * g.Ho + ho) * g.Wo + wo) * ldo;
    const float* src = os + p * g.out_ld;
    if (out_dtype == 0) {
      float* dst = static_cast<float*>(out) + row;
      for (int oc = lane; oc < g.N; oc += 32) dst[oc] = src[oc];
    } else {
      __nv_bfloat16* dst = static_cast<__nv_bfloat16*>(out) + row;
      for (int oc = lane; oc < g.N; oc += 32)
        dst[oc] = from_f32<__nv_bfloat16>(src[oc]);
    }
  }
}

template <typename T, bool Q, int R>
cudaError_t launch_conv_r(const void* x, const int2* slots, const int4* meta,
                          const void* bias, void* out, int ldo, int odt,
                          int act, const ConvTile& g, int smem,
                          cudaStream_t stream) {
  static bool attr_set = false;          // once per instantiation
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        tap_conv_kernel<T, Q, R>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kConvSmemMax);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  const int grid = g.B * g.tiles_h * g.tiles_w;
  tap_conv_kernel<T, Q, R><<<grid, kConvThreads, smem, stream>>>(
      static_cast<const T*>(x), slots, meta, static_cast<const T*>(bias),
      out, ldo, odt, act, g);
  return cudaGetLastError();
}

template <typename T, bool Q>
cudaError_t launch_conv(const void* x, const int2* slots, const int4* meta,
                        const void* bias, void* out, int ldo, int odt,
                        int act, const ConvTile& g, int smem,
                        cudaStream_t stream) {
  switch (g.R) {
    case 1:
      return launch_conv_r<T, Q, 1>(x, slots, meta, bias, out, ldo, odt,
                                    act, g, smem, stream);
    case 2:
      return launch_conv_r<T, Q, 2>(x, slots, meta, bias, out, ldo, odt,
                                    act, g, smem, stream);
    case 4:
      return launch_conv_r<T, Q, 4>(x, slots, meta, bias, out, ldo, odt,
                                    act, g, smem, stream);
    case 8:
      return launch_conv_r<T, Q, 8>(x, slots, meta, bias, out, ldo, odt,
                                    act, g, smem, stream);
    default:
      return cudaErrorInvalidConfiguration;
  }
}

template <typename T>
cudaError_t launch_conv_q(const void* x, const int2* slots, const int4* meta,
                          const void* bias, void* out, int ldo, int odt,
                          int act, int quant, const ConvTile& g, int smem,
                          cudaStream_t stream) {
  if (quant)
    return launch_conv<T, true>(x, slots, meta, bias, out, ldo, odt, act, g,
                                smem, stream);
  return launch_conv<T, false>(x, slots, meta, bias, out, ldo, odt, act, g,
                               smem, stream);
}

}  // namespace

// Kernel 4 (and kernel 2), one launch over every degree bin of a
// TapLayout: x the unpadded NHWC input (B, H, W, C) (kernel 2: the alive
// band as (1, 1, M, R)), slots (total, 2) int32 of (input word
// in the staged tile, fp32 value bits) per slot of every output column,
// bins concatenated in layout order -- with quant (as kernel 1's: 1 a
// scale a slot, 2 a filter's scale repeated over its slots) not 0, an
// int8 layout's (word + q * 2^16, fp32 scale bits), the word below 2^16
// -- meta (n_cols, 4) int32 (first slot, slots, original output column,
// 0), bias None or (N,) in original order, out (B*Ho*Wo, N) rows in (b,
// ho, wo) order with row stride ldo.  geom: the ConvTile ints (host
// memory).  dtype: x's and bias's, out_dtype out's (0 float32, 1
// bfloat16; either under either x).
extern "C" int tap_conv_launch(const void* x, const void* slots,
                               const void* meta, const void* bias, void* out,
                               const void* geom, int ldo, int act, int dtype,
                               int quant, int smem, int out_dtype,
                               void* stream) {
  ConvTile g;
  memcpy(&g, geom, sizeof(g));
  if (g.B * g.Ho * g.Wo <= 0) return 0;
  if (g.C <= 0 || act < 0 || act > 2 || g.n_cols != g.N ||
      g.x_floats % 4 != 0 || smem > kConvSmemMax || g.warps_pos <= 0 ||
      kConvWarps % g.warps_pos != 0 || quant < 0 || quant > 2 ||
      (quant && g.x_floats > (1 << kWordBits)) ||
      (out_dtype != 0 && out_dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int2* sl = static_cast<const int2*>(slots);
  const int4* mt = static_cast<const int4*>(meta);
  if (dtype == 0)
    return (int)launch_conv_q<float>(x, sl, mt, bias, out, ldo, out_dtype,
                                     act, quant, g, smem, s);
  if (dtype == 1)
    return (int)launch_conv_q<__nv_bfloat16>(x, sl, mt, bias, out, ldo,
                                             out_dtype, act, quant, g, smem,
                                             s);
  return (int)cudaErrorInvalidValue;
}
