// Kernel 1, bsr_matmul_kernel: BCS block-sparse matmul for Hopper (sm_90a):
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
// Kernel 3, bsr_conv_kernel below (bsr_conv_launch), is the BCS conv.  It
// replaces the Pallas TPU kernel `_conv_implicit_bin` (body `_conv_kernel`)
// in src/repro/kernels/bsr_matmul.py:444 (launch :483, wrapper
// `bsr_conv2d_implicit` :542), and on the card it also runs the
// materialized conv: the im2col patch matrix read as a 1 x M image of K
// channels.  out[(b, ho, wo), cols[j]*bn + c] = act(sum over the slots l
// and kk < bk of x(b, ho*s + dy - ph0, wo*s + dx - pw0, c0 + kk) *
// values[j, l, kk, c] + bias), (dy, dx, c0) the tap of K-block k_idx[j, l].
//
// What bounds it on an H100: the live FLOPs at the fp32 CUDA-core rate
// (67 TFLOP/s); its bytes (image, values, output) are a tenth of that
// time at VGG_TINY's shapes.  What held the first port back was issue:
// one M tile of 8 rows per block, every input gathered from global memory
// once per block column, 32 partial sums added through shared memory.
// What the design does:
//   * one block per tile of output positions (rows of one image; rows and
//     columns of the 1 x M patch image), one launch over all degree bins;
//     it stages the input window under the tile, halo zero-filled, all C
//     channels, pixel-major in shared memory (16-byte cp.async; a pixel
//     pitch of 4 mod 8 floats so 8 lanes' float4 reads hit 8 bank quads;
//     stride-s columns split into s phases so neighbouring outputs are
//     neighbouring pixels), and walks every block column against it;
//   * a lane owns R positions x the bn columns of a block column in
//     registers: per slot it reads R x bk inputs (float4) and the (bk, bn)
//     value block once, and does R * bk * bn FMAs (256 at R = 4, (8, 8));
//   * each warp streams its column's value blocks through its own ring of
//     kStages blocks (cp.async, kStages - 1 ahead), and reads the slots'
//     window offsets from a per-geometry table (no k_idx -> tap -> offset
//     chain of dependent loads);
//   * results go from registers straight to the output row: a lane's bn
//     columns of a position are one contiguous 32-byte run (fp32).
// The tile, the lanes' R and the shared-memory bytes come from conv_plan
// in repro_torch/kernels/bsr_matmul.py.
//
// Numerics: each output is one fp32 FMA chain over its column's reduction
// rows q = l*bk + kk in increasing q, from 0, whatever the tile or R;
// padding slots hold zero values and add exact zeros.  The implicit and
// the materialized conv are this one kernel over the same slots, so they
// agree bitwise, as do reordered and unreordered layouts.  Bias and
// activation apply to the fp32 sum, then one rounding to the output type.
//
// ptxas -v (CUDA 12.8, -O3, sm_90a): fp32 with (8, 8) blocks 112
// registers at R = 4, 95 at R = 2, 99 at R = 1 (64-112 over every
// instantiation, bf16 included), no spills, under __launch_bounds__(256,
// 2); dynamic shared memory per conv_plan, 42-91 KB at VGG_TINY's punched
// layers (two blocks an SM).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC (see repro_torch/kernels/_build.py); bound with ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

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

// act: 0 none, 1 silu, 2 relu.  x row m is row m of the (M, K) matrix.
template <typename T, int RPT>
__global__ void __launch_bounds__(kThreads)
bsr_matmul_kernel(const T* __restrict__ x, const T* __restrict__ values,
                  const int* __restrict__ k_idx, const int* __restrict__ cols,
                  const T* __restrict__ bias, T* __restrict__ out, int M,
                  int ldx, int L, int bk_log2, int bn, int ldo, int kc,
                  int act) {
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
  // start of each row's x
  size_t xrow[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
    xrow[i] = (i < rows) ? (size_t)(m0 + i) * ldx : 0;

  float acc[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) acc[i] = 0.f;

  for (int q0 = 0; q0 < R; q0 += kc) {
    const int n = min(kc, R - q0);
    // rows q0 .. q0+n of column j's (L*bk, bn) value run are contiguous
    load_f32(vs, vals_j + (size_t)q0 * bn, n * bn, tid);
    // the matching x columns, gathered through k_idx
    for (int q = tid; q < n; q += kThreads) {
      const int gq = q0 + q;
      const int kb = kidx_j[gq >> bk_log2];
      const int kk = gq & (bk - 1);
      const int col = kb * bk + kk;
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

template <typename T>
cudaError_t launch_typed(const void* x, const void* values, const int* k_idx,
                         const int* cols, const void* bias, void* out, int M,
                         int ldx, int nb, int L, int bk, int bn, int ldo,
                         int act, cudaStream_t stream) {
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
  bsr_matmul_kernel<T, RPT_><<<grid, kThreads, smem, stream>>>(           \
      xt, vt, k_idx, cols, bt, ot, M, ldx, L, bk_log2, bn, ldo, kc, act)
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

// ---------------------------------------------------------------------------
// Kernel 3: the BCS conv from an input tile staged in shared memory.

constexpr int kConvThreads = 256;
constexpr int kConvWarps = kConvThreads / 32;
constexpr int kSmemMax = 232448;         // bytes a block may use (227 KB)

// One launch's tile geometry, filled by conv_plan in
// repro_torch/kernels/bsr_matmul.py (ConvPlan.args, same field order).
struct ConvTile {
  int B, H, W, C;                        // unpadded NHWC input
  int Ho, Wo, stride, ph0, pw0;          // output, low SAME padding
  int tr, tw, tiles_h, tiles_w;          // output tile, tiles per image
  int rows_in, cols_in, nph, pitch;      // staged window, column phases
  int chan_ld;                           // floats per staged pixel
  int cg_log2;                           // 0 (the tap kernel's row groups)
  int R, warps_pos, n_cols, N, out_ld;   // lanes, columns (out_ld unused)
  int x_floats;                          // floats of the staged window
};
static_assert(sizeof(ConvTile) == 25 * sizeof(int),
              "ConvTile must match ConvPlan.args()");

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// Stage the block's input window, pixel-major: pixel (row, col) at float
// (row * pitch + pc) * chan_ld, pc = (col % s) * nph + col / s, its C
// channels contiguous.  Pixels outside the image (the SAME halo) are
// zero-filled.  C % 4 == 0: 16-byte copies (cp.async for fp32).
template <typename T>
__device__ __forceinline__ void stage_pixels(float* xs,
                                             const T* __restrict__ x,
                                             const ConvTile& g, int b,
                                             int hi0, int wi0) {
  const int C4 = g.C >> 2;
  const int per_row = g.cols_in * C4;
  const int tid = threadIdx.x;
  const int col0 = tid / C4, q0 = tid - col0 * C4;
  const int dcol = kConvThreads / C4, dq = kConvThreads - dcol * C4;
  for (int row = 0; row < g.rows_in; ++row) {
    const int hi = hi0 + row;
    const bool row_ok = hi >= 0 && hi < g.H;
    const T* src_row =
        x + ((size_t)b * g.H + (row_ok ? hi : 0)) * g.W * g.C;
    float* dst_row = xs + (size_t)row * g.pitch * g.chan_ld;
    int col = col0, q = q0;
    for (int u = tid; u < per_row; u += kConvThreads) {
      const int wi = wi0 + col;
      const bool ok = row_ok && wi >= 0 && wi < g.W;
      const int pc = g.stride == 1 ? col
                                   : (col % g.stride) * g.nph + col / g.stride;
      float* dst = dst_row + pc * g.chan_ld + 4 * q;
      const T* src = src_row + (size_t)(ok ? wi : 0) * g.C + 4 * q;
      if constexpr (sizeof(T) == 4) {
        cp_async16(dst, src, ok);
      } else {
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (ok) {
          const uint2 u2 = __ldg(reinterpret_cast<const uint2*>(src));
          const T* e = reinterpret_cast<const T*>(&u2);
          v = make_float4(to_f32(e[0]), to_f32(e[1]), to_f32(e[2]),
                          to_f32(e[3]));
        }
        *reinterpret_cast<float4*>(dst) = v;
      }
      col += dcol;
      q += dq;
      if (q >= C4) {
        q -= C4;
        ++col;
      }
    }
  }
  if constexpr (sizeof(T) == 4) cp_async_wait_all();
}

constexpr int kStages = 4;               // value blocks in flight per warp

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Block (tile): stage the window, then every warp walks its block columns
// j = wc, wc + 8 / warps_pos, ...  A column's (bk, BN) value blocks stream
// through the warp's own ring of kStages blocks in shared memory
// (cp.async, kStages - 1 ahead); its slots' window offsets come 32 at a
// time from the per-geometry table, one register a lane, broadcast by a
// shuffle.  Per slot a lane reads R x bk staged inputs (float4) and the
// value block (broadcast float4 reads) and does R * bk * BN FMAs into its
// R x BN register tile.
template <typename T, int BN, int R>
__global__ void __launch_bounds__(kConvThreads, 2)
bsr_conv_kernel(const T* __restrict__ x, const float* __restrict__ vals,
                const int* __restrict__ soffs, const int4* __restrict__ meta,
                const T* __restrict__ bias, T* __restrict__ out, int ldo,
                int bk, int act, ConvTile g) {
  extern __shared__ float4 smem4[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int blk = bk * BN;               // floats of one value block
  float* ring = reinterpret_cast<float*>(smem4) + warp * kStages * blk;
  float* xs = reinterpret_cast<float*>(smem4) + kConvWarps * kStages * blk;
  int t = blockIdx.x;
  const int tx = t % g.tiles_w;
  t /= g.tiles_w;
  const int ty = t % g.tiles_h;
  const int b = t / g.tiles_h;
  const int ho0 = ty * g.tr, wo0 = tx * g.tw;
  stage_pixels<T>(xs, x, g, b, ho0 * g.stride - g.ph0,
                  wo0 * g.stride - g.pw0);

  const int wp = warp % g.warps_pos, wc = warp / g.warps_pos;
  const int warps_col = kConvWarps / g.warps_pos;
  const int tp = g.tr * g.tw;
  int poff[R];
  long long orow[R];                     // output row of each position
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int p = lane + 32 * (wp + g.warps_pos * i);
    const int pp = p < tp ? p : 0;
    const int r = pp / g.tw, c = pp - r * g.tw;
    poff[i] = (r * g.stride * g.pitch + c) * g.chan_ld;
    const int ho = ho0 + r, wo = wo0 + c;
    orow[i] = (p < tp && ho < g.Ho && wo < g.Wo)
                  ? ((long long)b * g.Ho + ho) * g.Wo + wo
                  : -1;
  }
  __syncthreads();

  const int nvec = blk >> 2;             // 16-byte pieces of a block
  for (int j = wc; j < g.n_cols; j += warps_col) {
    const int4 mt = __ldg(meta + j);     // first slot, slots, column
    const float* vj = vals + (size_t)mt.x * blk;
    const int* sj = soffs + mt.x;
#pragma unroll
    for (int q = 0; q < kStages - 1; ++q) {
      if (q < mt.y) {
        float* dst = ring + q * blk;
        for (int v = lane; v < nvec; v += 32)
          cp_async16(dst + 4 * v, vj + (size_t)q * blk + 4 * v, true);
      }
      cp_async_commit();
    }
    int soff_cur = lane < mt.y ? __ldg(sj + lane) : 0;
    int soff_nxt = 32 + lane < mt.y ? __ldg(sj + 32 + lane) : 0;
    float acc[R][BN];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int c = 0; c < BN; ++c) acc[i][c] = 0.f;
    for (int l = 0; l < mt.y; ++l) {
      if ((l & 31) == 0 && l > 0) {
        soff_cur = soff_nxt;
        soff_nxt = l + 32 + lane < mt.y ? __ldg(sj + l + 32 + lane) : 0;
      }
      const int q = l + kStages - 1;     // refill the stage freed at l - 1
      if (q < mt.y) {
        float* dst = ring + (q % kStages) * blk;
        for (int v = lane; v < nvec; v += 32)
          cp_async16(dst + 4 * v, vj + (size_t)q * blk + 4 * v, true);
      }
      cp_async_commit();
      cp_async_wait<kStages - 1>();      // slot l's block has landed
      __syncwarp();
      const int soff = __shfl_sync(0xffffffffu, soff_cur, l & 31);
      const float4* w4 = reinterpret_cast<const float4*>(
          ring + (l % kStages) * blk);
      for (int k0 = 0; k0 < bk; k0 += 4) {
        float4 xv[R];
#pragma unroll
        for (int i = 0; i < R; ++i)
          xv[i] = *reinterpret_cast<const float4*>(xs + poff[i] + soff + k0);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          float wr[BN];
#pragma unroll
          for (int c4 = 0; c4 < BN / 4; ++c4) {
            const float4 v = w4[(k0 + k) * (BN / 4) + c4];
            wr[4 * c4] = v.x;
            wr[4 * c4 + 1] = v.y;
            wr[4 * c4 + 2] = v.z;
            wr[4 * c4 + 3] = v.w;
          }
#pragma unroll
          for (int i = 0; i < R; ++i) {
            const float xk = k == 0 ? xv[i].x
                           : k == 1 ? xv[i].y
                           : k == 2 ? xv[i].z : xv[i].w;
#pragma unroll
            for (int c = 0; c < BN; ++c)
              acc[i][c] = fmaf(xk, wr[c], acc[i][c]);
          }
        }
      }
      __syncwarp();                      // the stage is free to refill
    }
    // epilogue from registers: a lane's BN columns of a position are one
    // contiguous run of the output row (a whole 32-byte sector in fp32)
    const int oc0 = mt.z * BN;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      if (orow[i] < 0) continue;
#pragma unroll
      for (int c = 0; c < BN; ++c) {
        float y = acc[i][c];
        if (bias != nullptr) y += to_f32(bias[oc0 + c]);
        if (act == 1) {
          y = y / (1.f + expf(-y));
        } else if (act == 2) {
          y = fmaxf(y, 0.f);
        }
        acc[i][c] = y;
      }
      T* dst = out + (size_t)orow[i] * ldo + oc0;
#pragma unroll
      for (int c4 = 0; c4 < BN / 4; ++c4) {
        const float* a = &acc[i][4 * c4];
        if constexpr (sizeof(T) == 4) {
          reinterpret_cast<float4*>(dst)[c4] =
              make_float4(a[0], a[1], a[2], a[3]);
        } else {
          T h[4] = {from_f32<T>(a[0]), from_f32<T>(a[1]), from_f32<T>(a[2]),
                    from_f32<T>(a[3])};
          reinterpret_cast<uint2*>(dst)[c4] = *reinterpret_cast<uint2*>(h);
        }
      }
    }
  }
}

template <typename T, int BN, int R>
cudaError_t launch_conv_r(const void* x, const float* vals, const int* soffs,
                          const int4* meta, const void* bias, void* out,
                          int ldo, int bk, int act, const ConvTile& g,
                          int smem, cudaStream_t stream) {
  static bool attr_set = false;          // once per instantiation
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        bsr_conv_kernel<T, BN, R>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  const int grid = g.B * g.tiles_h * g.tiles_w;
  bsr_conv_kernel<T, BN, R><<<grid, kConvThreads, smem, stream>>>(
      static_cast<const T*>(x), vals, soffs, meta,
      static_cast<const T*>(bias), static_cast<T*>(out), ldo, bk, act, g);
  return cudaGetLastError();
}

template <typename T, int BN>
cudaError_t launch_conv_bn(const void* x, const float* vals, const int* soffs,
                           const int4* meta, const void* bias, void* out,
                           int ldo, int bk, int act, const ConvTile& g,
                           int smem, cudaStream_t stream) {
  switch (g.R) {
    case 1:
      return launch_conv_r<T, BN, 1>(x, vals, soffs, meta, bias, out, ldo,
                                     bk, act, g, smem, stream);
    case 2:
      return launch_conv_r<T, BN, 2>(x, vals, soffs, meta, bias, out, ldo,
                                     bk, act, g, smem, stream);
    case 4:
      if constexpr (BN <= 8)
        return launch_conv_r<T, BN, 4>(x, vals, soffs, meta, bias, out, ldo,
                                       bk, act, g, smem, stream);
      [[fallthrough]];
    default:
      return cudaErrorInvalidConfiguration;
  }
}

template <typename T>
cudaError_t launch_conv(const void* x, const float* vals, const int* soffs,
                        const int4* meta, const void* bias, void* out,
                        int ldo, int bk, int bn, int act, const ConvTile& g,
                        int smem, cudaStream_t stream) {
  if (bn == 4)
    return launch_conv_bn<T, 4>(x, vals, soffs, meta, bias, out, ldo, bk,
                                act, g, smem, stream);
  if (bn == 8)
    return launch_conv_bn<T, 8>(x, vals, soffs, meta, bias, out, ldo, bk,
                                act, g, smem, stream);
  if (bn == 16)
    return launch_conv_bn<T, 16>(x, vals, soffs, meta, bias, out, ldo, bk,
                                 act, g, smem, stream);
  return cudaErrorInvalidValue;
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ki = static_cast<const int*>(k_idx);
  const int* co = static_cast<const int*>(cols);
  if (dtype == 0)
    return (int)launch_typed<float>(x, values, ki, co, bias, out, M, ldx, nb,
                                    L, bk, bn, ldo, act, s);
  if (dtype == 1)
    return (int)launch_typed<__nv_bfloat16>(x, values, ki, co, bias, out, M,
                                            ldx, nb, L, bk, bn, ldo, act, s);
  return (int)cudaErrorInvalidValue;
}

// Kernel 3, one launch over every degree bin of a conv PackedLayout:
// x the unpadded NHWC input (B, H, W, C), vals the layout's values as fp32
// (slots, bk, bn) with the bins concatenated in layout order, soffs their
// (slots,) int32 offsets in the staged window (K-block kb's tap (dy, dx,
// c0) under geom), meta (n_cols, 4) int32 (first slot, slots, original
// block column, 0) per layout column, bias None or (N,) in original
// order, out (B*Ho*Wo, N) rows in (b, ho, wo) order with row stride ldo.
// geom: the ConvTile ints (host memory).  bk % 4 == 0, bk | C, bn in
// {4, 8, 16}; smem includes the 8 warps' rings of kStages value blocks.
extern "C" int bsr_conv_launch(const void* x, const void* vals,
                               const void* soffs, const void* meta,
                               const void* bias, void* out, const void* geom,
                               int ldo, int act, int dtype, int bk, int bn,
                               int smem, void* stream) {
  ConvTile g;
  memcpy(&g, geom, sizeof(g));
  if (g.B * g.Ho * g.Wo <= 0) return 0;
  if (bk <= 0 || bk % 4 != 0 || g.C % bk != 0 || g.C % 4 != 0 ||
      act < 0 || act > 2 || g.n_cols * bn != g.N || ldo % 4 != 0 ||
      g.chan_ld % 4 != 0 || g.x_floats % 4 != 0 || smem > kSmemMax ||
      g.warps_pos <= 0 || kConvWarps % g.warps_pos != 0 ||
      (size_t)smem < 4 * ((size_t)kConvWarps * kStages * bk * bn +
                          g.x_floats))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* v = static_cast<const float*>(vals);
  const int* so = static_cast<const int*>(soffs);
  const int4* mt = static_cast<const int4*>(meta);
  if (dtype == 0)
    return (int)launch_conv<float>(x, v, so, mt, bias, out, ldo, bk, bn, act,
                                   g, smem, s);
  if (dtype == 1)
    return (int)launch_conv<__nv_bfloat16>(x, v, so, mt, bias, out, ldo, bk,
                                           bn, act, g, smem, s);
  return (int)cudaErrorInvalidValue;
}
