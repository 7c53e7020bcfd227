// Kernel 1, bsr_matmul_kernel: BCS block-sparse matmul for Hopper (sm_90a):
//   out[:, cols[j]*bn + c] = act(sum_l x[:, k_idx[j,l]*bk : +bk] @ values[j,l][:, c] + bias)
// over every block column j of every degree bin of a PackedLayout, in ONE
// launch (bsr_matmul_launch); for a stack of E expert layouts (MoE), every
// expert's product in the same launch, the expert on grid dimension y.
//
// Replaces the Pallas TPU kernel `bsr_matmul` (body `_kernel`) in
// src/repro/kernels/bsr_matmul.py:63 (launch :143), and its vmap over
// experts in `sparse_expert_linear` (src/repro/kernels/ops.py:437, one
// batched launch per degree bin there).  There the sequential
// grid (M/bm, Nb, L) carried an fp32 VMEM accumulator across the L steps.
// Here a thread block owns one work item -- (layout column j, a sub-column
// of NW of its bn outputs, an M tile of MT rows, a chunk of S of its slots)
// -- and walks the chunk's slots itself; a column's chunks meet through an
// fp32 workspace (below).
//
// What bounds it on an H100: the bytes of the live value blocks.  Each is
// read once per M tile and used for its rows, so the arithmetic intensity
// is about M flop/byte in bf16, far below the card's ~295: at yi-9b decode
// (M = 4) and prefill (M = 128) alike the bound is the value bytes at
// 3.35 TB/s (0.042 ms a layer at rate 0.6), the bf16 operations at
// prefill taking under half of that; mixtral's experts (E = 8, M = 4 at
// decode, 40 at prefill) read ~1.13 GB of live values a layer, 0.34 ms
// at that rate.  The first port reached ~6 % of the HBM rate at decode
// and multiplied on CUDA cores at prefill, one launch per degree bin.
// What the design does:
//   * one launch per call over all bins: the bins' pointers, degrees and
//     work-item offsets travel as a by-value kernel argument (BinDesc), so
//     no table is copied to the card and a CUDA graph captures it as is;
//   * a column's slots are cut into chunks of S slots (S from the shapes
//     alone, bsr_plan in repro_torch/kernels/bsr_matmul.py), so a launch
//     has enough blocks to fill the card even where a bin has few columns
//     (wk / wv at decode); inside a block each of the WK = 4 / WM warp
//     groups walks its own sub-chunk of SW = S / WK slots;
//   * the block first copies its chunk's k_idx to shared memory (no step
//     waits on a k_idx load); then per pipeline step each group takes U
//     units, a unit being one slot's KS-deep piece: the gathered x tile
//     (MT rows x KS) and the (KS, NW) piece of the value block stream
//     through a cp.async ring of `stages` steps in their own dtype
//     (values L2-only, x through L1, where neighbouring columns on the SM
//     find it); x rows >= M are never loaded (they only feed output rows
//     that are never stored), so decode (M = 4 in a 16-row tile) moves
//     only live bytes;
//   * bf16 with bk % 16 == 0 and bn % 8 == 0 (yi-9b's (16, 16) and every
//     menu block from (16, 32) up) multiplies on the tensor cores:
//     mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32, fp32
//     accumulators in registers, A from the x tile by ldmatrix.x4, B from
//     the (KS, NW) row-major value piece by ldmatrix.x4.trans (x2.trans at
//     NW = 8); staged rows are an odd number of 16-byte units long, so
//     the 8 row addresses of an ldmatrix phase hit 8 distinct bank quads.
//     mma.sync rather than wgmma: the bytes bind at both M, and mma.sync
//     keeps the operations well under them;
//   * fp32 (the gate excludes TF32) and the small bf16 blocks ((4, 4),
//     (8, 16)) take the same pipeline with fp32 FMAs on CUDA cores, each
//     lane owning NW / 2 outputs of its warp's 16 x NW tile;
//   * the epilogue (bias, silu / relu, one rounding to the output type:
//     x's, or fp32 under a bf16 x when the caller asks, out_dtype) runs
//     once per output from an fp32 tile in shared memory; each column
//     writes straight to
//     its ORIGINAL columns (cols = layout.perm), so no gather follows;
//   * experts (MoE): blockIdx.y = e.  The per-bin leaves of an expert
//     stack are contiguous (E, nb, L, bk, bn) / (E, nb, L) / (E, nb), so a
//     bin's descriptor addresses expert e by stride (e * nb * L * bk * bn
//     values, e * nb * L k_idx, e * nb cols); x, out and bias get an
//     expert stride each, and the tile counters and the workspace are
//     offset by e times one expert's share.  The bin table stays one
//     expert's (at most 16 bins), so the table never caps E; an unstacked
//     layout is E = 1 (blockIdx.y = 0, every offset 0).
//
//   * int8 values (the dequant branch of `_kernel`, bsr_matmul.py:71-75:
//     w = f32(q) * s before the fp32-accumulated dot): the value pieces
//     stream as bytes (half the bf16 bytes), the chunk's scales (one per
//     block, or the column's) are staged beside its k_idx, and each unit
//     dequantizes in the reference's order on the FMA path (w = (float)q
//     * s, then the FMAs).  On the tensor cores, rounding q * s to bf16
//     would add up to 2^-9 relative error a weight, which the reference
//     does not have; instead the mma runs on bf16(q) (exact, |q| <= 127),
//     B fragments built by hand from the staged bytes (ldmatrix moves b16
//     only), into a zeroed fragment a k16 step, and acc += s * part.  One
//     launch a projection still; no dequantized weight exists anywhere.
//
// Numerics: inside a warp group's sub-chunk every output is one chain over
// its slots in slot order (one MMA k-step, or bk FMAs, per slot and KS
// piece, from 0).  A block adds its WK sub-chunk sums in sub-chunk order;
// a column cut into nch > 1 chunks writes each chunk's sum to the fp32
// workspace, and the block that arrives last (a per-tile counter) adds
// them in chunk order, applies the epilogue, stores, and resets the
// counter to 0, so the next launch and a CUDA-graph replay find it clean.
// Chunk and sub-chunk edges depend on the slot index and the shapes only,
// never on a bin's degree or the bin count, and padding slots (zero
// values, k_idx 0) and the all-padding chunks of a longer bin add exact
// zeros: reordered and unreordered layouts give bit-identical outputs.
// bf16 products are exact in fp32; the sums round in fp32.
//
// ptxas -v (CUDA 12.8, -O3, sm_90a): kernel 1 93-128 registers over its
// 18 instantiations with the expert axis (93 for the (16, 16) decode
// tile, 113 for the 64-row tile of the expert prefill), no spills, under
// __launch_bounds__(128, 4); dynamic
// shared memory per bsr_plan, 49-56 KB at yi-9b's shapes (the chunk's
// k_idx, a 4-deep ring of 2 units a group, the flag).
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
//   * a lane owns R positions x the BN = min(bn, 16) columns of a block
//     column in registers (a wider block column is walked as bn / 16
//     subcolumns, each a work item of its own): per slot it reads R x bk
//     inputs (float4) and the (bk, BN) values once, and does R * bk * BN
//     FMAs (256 at R = 4, (8, 8));
//   * each warp streams its work item's values through its own ring of
//     kStages pieces (cp.async, kStages - 1 ahead): a piece is kp rows of
//     the slot's (bk, BN) values, the whole of them unless that passes 512
//     values (so (64, 32) and (128, 128) blocks fit the ring), and reads
//     the slots' window offsets from a per-geometry table (no k_idx -> tap
//     -> offset chain of dependent loads);
//   * results go from registers straight to the output row: a lane's BN
//     columns of a position are one contiguous run (32 bytes or more in
//     fp32).
// The tile, the lanes' R, the piece (conv_piece) and the shared-memory
// bytes come from conv_plan in repro_torch/kernels/bsr_matmul.py.
//
// int8 values (the dequant branch of `_conv_kernel`, bsr_matmul.py:465-466)
// stream as bytes through the same rings, with a scale a slot beside the
// slot's window offset; each value is dequantized at its read, (float)q *
// s, then the same FMAs.
//
// Numerics: each output is one fp32 FMA chain over its column's reduction
// rows q = l*bk + kk in increasing q, from 0, whatever the tile, R, piece
// or subcolumn;
// padding slots hold zero values and add exact zeros.  The implicit and
// the materialized conv are this one kernel over the same slots, so they
// agree bitwise, as do reordered and unreordered layouts.  Bias and
// activation apply to the fp32 sum, then one rounding to the output type.
//
// ptxas -v (CUDA 12.8, -O3, sm_90a): fp32 with (8, 8) blocks 112
// registers at R = 4, 95 at R = 2, 99 at R = 1 (64-112 over every
// whole-block instantiation, bf16 included), no spills, under
// __launch_bounds__(256, 2); chip_smoke.py prints every instantiation's
// count at build time.  Dynamic shared memory per conv_plan, 42-91 KB at
// VGG_TINY's punched (8, 8) layers (two blocks an SM).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC (see repro_torch/kernels/_build.py); bound with ctypes.


#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kSmemMax = 232448;         // bytes a block may use (227 KB)

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(
    __nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <> __device__ __forceinline__ float to_f32<int8_t>(int8_t v) {
  return (float)v;
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(
    float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// wait until at most n (< kMaxStages) committed groups are pending
__device__ __forceinline__ void cp_async_wait_n(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    default: cp_async_wait<6>(); break;
  }
}

// one output element, fp32 or bf16 whatever x's type (an fp32 out of a
// bf16 x keeps the epilogue's fp32 value)
__device__ __forceinline__ void store_out(void* out, int out_dtype, size_t i,
                                          float y) {
  if (out_dtype == 0)
    static_cast<float*>(out)[i] = y;
  else
    static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(y);
}

__device__ __forceinline__ float epilogue(float y, int act) {
  if (act == 1) return y / (1.f + expf(-y));
  // relu as a compare, so a NaN passes through as torch.relu passes it
  // (fmaxf would turn it into 0)
  if (act == 2) return y < 0.f ? 0.f : y;
  return y;
}

// ---------------------------------------------------------------------------
// Kernel 1: the BCS matmul, one launch over every bin.

constexpr int kBsrThreads = 128;
constexpr int kBsrWarps = kBsrThreads / 32;
constexpr int kMaxStages = 8;            // ring depth: steps in flight + 1
constexpr int kMaxBins = 16;

// One launch's shape, filled by bsr_plan in repro_torch/kernels/
// bsr_matmul.py (BsrPlan.args, same field order).
struct BsrShape {
  int M, bk, bn;
  int mma;                               // 1: tensor cores, 0: fp32 FMAs
  int MT, FM, WM, NW, KS;                // M tile, warps, sub-column, k piece
  int S, SW, subcols, mtiles;            // chunk, warp sub-chunk, tiles
  int xp, vp;                            // elements of a staged x / value row
  int U;                                 // units (slot pieces) per step
  int stages;                            // depth of the cp.async ring
  int smem;                              // dynamic shared-memory bytes
};
constexpr int kFlagBytes = 16;           // the last-arrival flag, at the end
static_assert(sizeof(BsrShape) == 18 * sizeof(int),
              "BsrShape must match BsrPlan.args()");

// One degree bin (the wrapper's _bsr_bins, same field order).
struct BinDesc {
  long long vals, kidx, cols;            // (nb, L, bk, bn), (nb, L), (nb,)
  long long ws0;                         // first workspace float of the bin
  long long ncols, L, nch;               // columns, padded degree, chunks
  long long item0, tile0;                // first block and tile of the bin
  long long scales;                      // int8: (nb, L) or (nb,) fp32
};
static_assert(sizeof(BinDesc) == 10 * sizeof(long long),
              "BinDesc must match the wrapper's table rows");

struct BsrArgs {
  BsrShape p;
  int ldx, ldo, act, n_bins;
  int quant;                             // 0 float, 1 int8 "block", 2 "out"
  int out_dtype;                         // out: 0 float32, 1 bfloat16
  // one expert's stride in x, out and bias (elements), its tile counters
  // and workspace floats; all 0 for an unstacked layout
  long long ldx_e, ldo_e, ldb_e, tiles_e, ws_e;
  BinDesc bins[kMaxBins];
};

// cp.async of 16, 8 or 4 bytes; 16-byte copies of streamed data skip L1
template <bool kL1>
__device__ __forceinline__ void cp_async_bytes(void* dst, const void* src,
                                               int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if (bytes == 16) {
    if (kL1)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(d),
                   "l"(src));
    else
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                   "l"(src));
  } else if (bytes == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
                 "l"(src));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src));
  }
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldsm_x2_t(unsigned (&r)[2], const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(a));
}

// two int8 values as the bf16 pair of one fragment register (exact:
// |q| <= 127), lo in the low half
__device__ __forceinline__ unsigned bf16_pair(int8_t lo, int8_t hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn((float)lo, (float)hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// d += a (16x16, row) @ b (16x8, col): bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float* d, const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Block = one work item.  Warp w is (wm, wk) = (w % WM, w / WM): it owns
// rows [16*FM*wm, +16*FM) of the M tile and the slots [slot0 + wk*SW, +SW)
// of the chunk, SW * bk / KS units (one slot's KS-deep piece each).  Stage
// st of the ring holds, for each warp group g, the U units of the group's
// current step, each the x tile (MT rows of xp elements of T; rows >= M
// are never loaded and only feed output rows that are never stored) and
// then the value piece (KS rows of vp elements of V); the group's own WM
// warps load it.  NWT: NW at compile time on the tensor-core path, 0 on
// the FMA path (NW from the shape, FM = 1).  V = T, or int8_t for a
// quantized layout: then the chunk's scales are staged beside its k_idx
// (one per slot; an "out" layout's column scale repeated), and each unit
// dequantizes in the reference's order -- w = (float)q * s before the FMA
// on the FMA path; on the tensor cores, where rounding q * s to bf16 would
// add error the reference does not have, the mma runs on bf16(q) (exact)
// into a zeroed fragment per k16 step and acc += s * part.  The arguments
// stay in the parameter space (__grid_constant__): the bins are indexed at
// run time.
template <typename T, typename V, bool MMA, int FM, int WM, int NWT>
__global__ void __launch_bounds__(kBsrThreads, 4)
bsr_matmul_kernel(const T* __restrict__ x, const T* __restrict__ bias,
                  void* __restrict__ out, float* __restrict__ ws,
                  int* __restrict__ counters,
                  const __grid_constant__ BsrArgs a) {
  constexpr bool kQ = sizeof(V) == 1;
  constexpr int WK = kBsrWarps / WM;
  constexpr int MT = 16 * FM * WM;
  constexpr int TPG = kBsrThreads / WK;  // threads loading one group
  constexpr int kAcc = MMA ? FM * (NWT / 8) * 4 : 16;
  extern __shared__ uint4 smem_raw[];
  const BsrShape& p = a.p;
  // shared memory: the chunk's k_idx (S ints, 16-byte padded), with int8
  // values its scales (S floats, the same), the ring (later the fp32 red
  // tile), the last-arrival flag
  const int head = (p.S * 4 + 15) & ~15;
  int* skid = reinterpret_cast<int*>(smem_raw);
  float* sscale = reinterpret_cast<float*>(reinterpret_cast<char*>(smem_raw)
                                           + head);
  char* ring = reinterpret_cast<char*>(smem_raw) + (kQ ? 2 * head : head);
  int& s_last = *reinterpret_cast<int*>(reinterpret_cast<char*>(smem_raw) +
                                        p.smem - kFlagBytes);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp % WM, wk = warp / WM;
  const int NW = MMA ? NWT : p.NW;

  // the work item: expert ex, bin b, column j, sub-column s, M tile mt,
  // chunk c
  const int ex = blockIdx.y;
  x += ex * a.ldx_e;
  const size_t o0 = (size_t)ex * a.ldo_e;  // expert ex's first output
  if (bias != nullptr) bias += ex * a.ldb_e;
  int b = 0;
  while (b + 1 < a.n_bins && (long long)blockIdx.x >= a.bins[b + 1].item0)
    ++b;
  const BinDesc& d = a.bins[b];
  const int nch = (int)d.nch, L = (int)d.L;
  int r = (int)(blockIdx.x - d.item0);
  const int c = r % nch;
  r /= nch;
  const int mt = r % p.mtiles;
  r /= p.mtiles;
  const int s = r % p.subcols;
  const int j = r / p.subcols;
  const int tile = (j * p.subcols + s) * p.mtiles + mt;
  const int m0 = mt * MT;
  const int rows = min(MT, p.M - m0);
  const int bk = p.bk, bn = p.bn, KS = p.KS, nks = bk / KS;
  const int ns = p.stages;
  const size_t je = (size_t)ex * d.ncols + j;  // column j of expert ex
  const V* vj = reinterpret_cast<const V*>(d.vals) + je * L * bk * bn +
                s * NW;
  const int* kj = reinterpret_cast<const int*>(d.kidx) + je * L;
  const int slot0 = c * p.S;

  const int U = p.U;
  const int xbytes = MT * p.xp * (int)sizeof(T);
  const int sub = xbytes + KS * p.vp * (int)sizeof(V);  // bytes of a unit
  const int stage = WK * U * sub;
  auto units_of = [&](int g) {           // units of warp group g
    const int n = L - (slot0 + g * p.SW);
    return (n < 0 ? 0 : (n > p.SW ? p.SW : n)) * nks;
  };
  const int nsteps = (units_of(0) + U - 1) / U, my_units = units_of(wk);

  // the chunk's slots' K-blocks (and scales), read once (no step waits on
  // a k_idx or scale load); expert ex's scales at ex times its leaf, like
  // its k_idx
  const int nkid = min(p.S, L - slot0);
  const float* sj = nullptr;
  if constexpr (kQ)
    sj = reinterpret_cast<const float*>(d.scales) +
         (a.quant == 1 ? je * L + slot0 : je);
  for (int i = tid; i < nkid; i += kBsrThreads) {
    skid[i] = __ldg(kj + slot0 + i);
    if constexpr (kQ) sscale[i] = __ldg(sj + (a.quant == 1 ? i : 0));
  }
  __syncthreads();

  // the 16-, 8- or 4-byte pieces of a unit: rows * xpc of x, KS * vpc of
  // the values; thread lq0 of group lg copies pieces lq0, lq0 + TPG, ...
  constexpr int es = sizeof(T), ves = sizeof(V);
  const int xpb = min(16, KS * es), xpc = KS * es / xpb, xpe = xpb / es;
  const int vpb = min(16, NW * ves), vpc = NW * ves / vpb, vpe = vpb / ves;
  const int lxpc = 31 - __clz(xpc), lvpc = 31 - __clz(vpc);
  const int lnks = 31 - __clz(nks);
  const int nx = rows * xpc, per = nx + KS * vpc;
  const int lg = tid / TPG, lq0 = tid % TPG;
  const int lg_units = units_of(lg);
  const T* xm = x + (size_t)m0 * a.ldx;
  auto load = [&](int t) {
    char* dst = ring + (t % ns) * stage + lg * U * sub;
    for (int i = 0, u = t * U; i < U && u < lg_units; ++i, ++u, dst += sub) {
      const int l = lg * p.SW + (u >> lnks);   // slot within the chunk
      const int k0 = (u & (nks - 1)) * KS;
      const T* xs = xm + (size_t)skid[l] * bk + k0;
      const V* vs = vj + ((size_t)(slot0 + l) * bk + k0) * bn;
      T* xd = reinterpret_cast<T*>(dst);
      V* vd = reinterpret_cast<V*>(dst + xbytes);
      for (int q = lq0; q < per; q += TPG) {
        if (q < nx) {
          const int row = q >> lxpc, pc = q & (xpc - 1);
          cp_async_bytes<true>(xd + row * p.xp + pc * xpe,
                               xs + (size_t)row * a.ldx + pc * xpe, xpb);
        } else {
          const int q2 = q - nx, row = q2 >> lvpc, pc = q2 & (vpc - 1);
          cp_async_bytes<false>(vd + row * p.vp + pc * vpe,
                                vs + row * bn + pc * vpe, vpb);
        }
      }
    }
  };

  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
  // FMA path: a lane owns column lane % NW of rows r0 + i * rstep
  const int lognw = 31 - __clz(NW);
  const int fcol = lane & (NW - 1), r0 = lane >> lognw, rstep = 32 >> lognw;

  for (int t = 0; t < ns - 1; ++t) {
    load(t);
    cp_async_commit();
  }
  for (int t = 0; t < nsteps; ++t) {
    cp_async_wait_n(ns - 2);             // step t has landed
    __syncthreads();                     // ... and step t - 1 is consumed
    load(t + ns - 1);
    cp_async_commit();
    const char* us = ring + (t % ns) * stage + wk * U * sub;
    for (int ui = 0, u = t * U; ui < U && u < my_units;
         ++ui, ++u, us += sub) {
      const T* xs = reinterpret_cast<const T*>(us);
      const V* vs = reinterpret_cast<const V*>(us + xbytes);
      float sc = 1.f;                    // the unit's slot's scale
      if constexpr (kQ) sc = sscale[wk * p.SW + (u >> lnks)];
      if constexpr (MMA) {
        for (int k16 = 0; k16 < KS; k16 += 16) {
          unsigned af[FM][4];
#pragma unroll
          for (int f = 0; f < FM; ++f)
            ldsm_x4(af[f], xs + (wm * 16 * FM + f * 16 + (lane & 15)) * p.xp
                               + k16 + (lane >> 4) * 8);
          unsigned bf[NWT / 8][2];
          if constexpr (kQ) {
            // B fragment by hand (ldmatrix moves b16 only): lane holds
            // rows 2 * (lane % 4) + {0, 1, 8, 9} of column lane / 4
            const int kr = k16 + 2 * (lane & 3);
#pragma unroll
            for (int n = 0; n < NWT / 8; ++n) {
              const V* cn = vs + n * 8 + (lane >> 2);
              bf[n][0] = bf16_pair(cn[kr * p.vp], cn[(kr + 1) * p.vp]);
              bf[n][1] = bf16_pair(cn[(kr + 8) * p.vp], cn[(kr + 9) * p.vp]);
            }
          } else if constexpr (NWT == 8) {
            ldsm_x2_t(bf[0], vs + (k16 + (lane & 15)) * p.vp);
          } else {
#pragma unroll
            for (int np = 0; np < NWT / 16; ++np) {
              unsigned r4[4];
              ldsm_x4_t(r4, vs + (k16 + (lane & 15)) * p.vp + np * 16 +
                                (lane >> 4) * 8);
              bf[2 * np][0] = r4[0];
              bf[2 * np][1] = r4[1];
              bf[2 * np + 1][0] = r4[2];
              bf[2 * np + 1][1] = r4[3];
            }
          }
#pragma unroll
          for (int f = 0; f < FM; ++f)
#pragma unroll
            for (int n = 0; n < NWT / 8; ++n) {
              float* an = acc + (f * (NWT / 8) + n) * 4;
              if constexpr (kQ) {
                float part[4] = {0.f, 0.f, 0.f, 0.f};
                mma_bf16(part, af[f], bf[n]);
#pragma unroll
                for (int i = 0; i < 4; ++i) an[i] = fmaf(sc, part[i], an[i]);
              } else {
                mma_bf16(an, af[f], bf[n]);
              }
            }
        }
      } else {
        const T* xr = xs + (wm * 16 + r0) * p.xp;
        for (int kk = 0; kk < KS; ++kk) {
          float w = to_f32(vs[kk * p.vp + fcol]);
          if constexpr (kQ) w = w * sc;  // the reference's f32(q) * s
#pragma unroll
          for (int i = 0; i < kAcc; ++i)
            if (i < NW / 2)
              acc[i] = fmaf(to_f32(xr[i * rstep * p.xp + kk]), w, acc[i]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // each group's sums into a (WK, MT, NW) fp32 tile over the ring
  float* red = reinterpret_cast<float*>(ring) + wk * MT * NW;
  if constexpr (MMA) {
#pragma unroll
    for (int f = 0; f < FM; ++f)
#pragma unroll
      for (int n = 0; n < NWT / 8; ++n) {
        const float* q = acc + (f * (NWT / 8) + n) * 4;
        const int row = wm * 16 * FM + f * 16 + (lane >> 2);
        const int col = n * 8 + 2 * (lane & 3);
        red[row * NW + col] = q[0];
        red[row * NW + col + 1] = q[1];
        red[(row + 8) * NW + col] = q[2];
        red[(row + 8) * NW + col + 1] = q[3];
      }
  } else {
#pragma unroll
    for (int i = 0; i < kAcc; ++i)
      if (i < NW / 2) red[(wm * 16 + r0 + i * rstep) * NW + fcol] = acc[i];
  }
  __syncthreads();
  red = reinterpret_cast<float*>(ring);

  const int n_out = rows * NW;
  const int oc0 = __ldg(reinterpret_cast<const int*>(d.cols) + je) * bn +
                  s * NW;
  auto finish = [&](int e, float y) {
    const int row = e >> lognw, cc = e & (NW - 1);
    if (bias != nullptr) y += to_f32(bias[oc0 + cc]);
    store_out(out, a.out_dtype, o0 + (size_t)(m0 + row) * a.ldo + oc0 + cc,
              epilogue(y, a.act));
  };
  auto chunk_sum = [&](int e) {          // the WK sub-chunks, in order
    float y = red[e];
#pragma unroll
    for (int g = 1; g < WK; ++g) y += red[g * MT * NW + e];
    return y;
  };
  if (nch == 1) {
    for (int e = tid; e < n_out; e += kBsrThreads) finish(e, chunk_sum(e));
    return;
  }
  // a column cut into chunks: each chunk's sum to the workspace; the last
  // block to arrive adds them in chunk order and resets the counter
  float* wt = ws + ex * a.ws_e + d.ws0 + (size_t)tile * nch * MT * NW;
  for (int e = tid; e < n_out; e += kBsrThreads)
    wt[(size_t)c * MT * NW + e] = chunk_sum(e);
  __threadfence();
  __syncthreads();
  int* ctr = counters + ex * a.tiles_e + d.tile0 + tile;
  if (tid == 0) s_last = atomicAdd(ctr, 1) == nch - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  for (int e = tid; e < n_out; e += kBsrThreads) {
    float y = __ldcg(wt + e);
    for (int cc = 1; cc < nch; ++cc)
      y += __ldcg(wt + (size_t)cc * MT * NW + e);
    finish(e, y);
  }
  if (tid == 0) *ctr = 0;
}

template <typename T, typename V, bool MMA, int FM, int WM, int NWT>
cudaError_t bsr_launch_cfg(const void* x, const void* bias, void* out,
                           float* ws, int* counters, const BsrArgs& a,
                           int items, int n_exp, cudaStream_t stream) {
  static bool attr_set = false;          // once per instantiation
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        bsr_matmul_kernel<T, V, MMA, FM, WM, NWT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  bsr_matmul_kernel<T, V, MMA, FM, WM, NWT>
      <<<dim3(items, n_exp), kBsrThreads, a.p.smem, stream>>>(
          static_cast<const T*>(x), static_cast<const T*>(bias), out, ws,
          counters, a);
  return cudaGetLastError();
}

// (FM, WM) of the M tile: tensor cores (1, 1), (2, 1), (2, 2), (2, 4) for
// MT = 16, 32, 64, 128; FMAs (1, 1), (1, 2), (1, 4) for MT = 16, 32, 64
template <typename T, typename V, bool MMA, int NWT>
cudaError_t bsr_launch_tile(const void* x, const void* bias, void* out,
                            float* ws, int* counters, const BsrArgs& a,
                            int items, int n_exp, cudaStream_t stream) {
  const int fm = a.p.FM, wm = a.p.WM;
#define BSR_CFG(FM_, WM_)                                                    \
  if (fm == FM_ && wm == WM_)                                                \
  return bsr_launch_cfg<T, V, MMA, FM_, WM_, NWT>(x, bias, out, ws, counters, \
                                                  a, items, n_exp, stream)
  BSR_CFG(1, 1);
  if constexpr (MMA) {
    BSR_CFG(2, 1);
    BSR_CFG(2, 2);
    BSR_CFG(2, 4);
  } else {
    BSR_CFG(1, 2);
    BSR_CFG(1, 4);
  }
#undef BSR_CFG
  return cudaErrorInvalidConfiguration;
}

// quant: 0 float values of x's dtype, else int8 values (1 byte) with the
// chunk's scales staged after its k_idx
bool bad_shape(const BsrShape& p, int n_bins, int items, int dtype,
               int quant) {
  const int es = dtype == 0 ? 4 : 2, ves = quant ? 1 : es;
  const int MT = 16 * p.FM * p.WM;
  if (p.WM <= 0 || kBsrWarps % p.WM != 0) return true;
  const int WK = kBsrWarps / p.WM;
  const bool nw_ok = p.mma ? (p.NW == 8 || p.NW == 16 || p.NW == 32)
                           : (p.NW == 4 || p.NW == 8 || p.NW == 16 ||
                              p.NW == 32);
  const size_t ring = (size_t)p.stages * WK * p.U *
                      ((size_t)MT * p.xp * es + (size_t)p.KS * p.vp * ves);
  const size_t red = (size_t)WK * MT * p.NW * 4;
  const size_t head = (size_t)((p.S * 4 + 15) & ~15) * (quant ? 2 : 1);
  return n_bins <= 0 || n_bins > kMaxBins || items <= 0 || p.M <= 0 ||
         p.MT != MT || !nw_ok || p.bn % p.NW != 0 ||
         p.subcols != p.bn / p.NW || p.KS <= 0 || (p.KS & (p.KS - 1)) ||
         p.bk % p.KS != 0 || ((p.bk / p.KS) & (p.bk / p.KS - 1)) ||
         (p.mma && (dtype != 1 || p.KS % 16 != 0 || p.FM > 2)) ||
         (!p.mma && p.FM != 1) || (p.KS * es) % 4 != 0 ||
         (p.NW * ves) % 4 != 0 || (p.xp * es) % 16 != 0 ||
         (p.vp * ves) % 16 != 0 || p.xp < p.KS || p.vp < p.NW ||
         p.S != p.SW * WK || p.SW <= 0 || p.stages < 2 || p.U <= 0 ||
         p.stages > kMaxStages ||
         p.mtiles != (p.M + MT - 1) / MT || p.smem > kSmemMax ||
         (size_t)p.smem < head + (ring > red ? ring : red) + kFlagBytes;
}

template <typename T, typename V>
cudaError_t bsr_launch_typed(const void* x, const void* bias, void* out,
                             float* ws, int* counters, const BsrArgs& a,
                             int items, int n_exp, cudaStream_t stream) {
  if constexpr (sizeof(T) == 2) {
    if (a.p.mma) {
      switch (a.p.NW) {
        case 8:
          return bsr_launch_tile<T, V, true, 8>(x, bias, out, ws, counters,
                                                a, items, n_exp, stream);
        case 16:
          return bsr_launch_tile<T, V, true, 16>(x, bias, out, ws, counters,
                                                 a, items, n_exp, stream);
        case 32:
          return bsr_launch_tile<T, V, true, 32>(x, bias, out, ws, counters,
                                                 a, items, n_exp, stream);
        default:
          return cudaErrorInvalidConfiguration;
      }
    }
  }
  return bsr_launch_tile<T, V, false, 0>(x, bias, out, ws, counters, a,
                                         items, n_exp, stream);
}

// ---------------------------------------------------------------------------
// Kernel 3: the BCS conv from an input tile staged in shared memory.

constexpr int kConvThreads = 256;
constexpr int kConvWarps = kConvThreads / 32;

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

constexpr int kStages = 4;               // value pieces in flight per warp

// Block (tile): stage the window, then every warp walks its work items
// w = wc, wc + 8 / warps_pos, ... of n_cols, item w being subcolumn
// w % (bn / BN) of block column w / (bn / BN).  An item's values stream
// slot by slot, kp rows at a time, through the warp's own ring of kStages
// (kp, BN) pieces in shared memory (cp.async, kStages - 1 ahead); its
// slots' window offsets come 32 at a time from the per-geometry table, one
// register a lane, broadcast by a shuffle.  Per piece a lane reads R x kp
// staged inputs (float4) and the piece (broadcast float4 reads) and does
// R * kp * BN FMAs into its R x BN register tile.  V = float, or int8_t
// for a quantized layout: the pieces stream as int8 (a quarter of the
// ring's room), the slots' scales come with their offsets (scl, one per
// slot), and each value is dequantized at its read, w = (float)q * s, the
// reference's order.  kSplit false (a block of BN columns staged whole:
// bn == BN, kp == bk) compiles the piece and subcolumn bookkeeping away.
template <typename T, typename V, int BN, int R, bool kSplit>
__global__ void __launch_bounds__(kConvThreads, 2)
bsr_conv_kernel(const T* __restrict__ x, const V* __restrict__ vals,
                const float* __restrict__ scl,
                const int* __restrict__ soffs, const int4* __restrict__ meta,
                const T* __restrict__ bias, T* __restrict__ out, int ldo,
                int bk, int bn, int kp, int act, ConvTile g) {
  constexpr bool kQ = sizeof(V) == 1;
  constexpr int kVec = 16 / sizeof(V);   // values of a 16-byte copy
  // 16-byte copies a piece row holds when rows are strided (bn > BN,
  // which makes BN = 16)
  constexpr int kRowVec = BN >= kVec ? BN / kVec : 1;
  extern __shared__ float4 smem4[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int blk = bk * (kSplit ? bn : BN);  // values of a stored block
  const int rows = kSplit ? kp : bk;     // rows of a staged piece
  const int piece = rows * BN;           // values of a staged piece
  const int npc = kSplit ? bk / kp : 1;  // pieces of a slot
  const int subs = kSplit ? bn / BN : 1;  // subcolumns of a block column
  // the rings keep a float's room a value, whatever V
  V* ring = reinterpret_cast<V*>(reinterpret_cast<float*>(smem4) +
                                 warp * kStages * piece);
  float* xs =
      reinterpret_cast<float*>(smem4) + kConvWarps * kStages * piece;
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

  const int nvec = piece / kVec;         // 16-byte copies of a piece
  for (int w = wc; w < g.n_cols; w += warps_col) {
    const int j = w / subs, sub = w - j * subs;
    const int4 mt = __ldg(meta + j);     // first slot, slots, column
    const V* vj = vals + (size_t)mt.x * blk + sub * BN;
    const int* sj = soffs + mt.x;
    const int units = mt.y * npc;        // pieces of the item, in order
    // piece u: rows (u % npc) * rows ... of slot u / npc's block (u
    // itself unless kSplit), contiguous when the block is BN wide, else
    // rows of BN values bn apart; loads run kStages - 1 pieces ahead of
    // the FMAs
    auto load = [&](int u) {
      const int ql = u / npc;
      const V* src =
          vj + (size_t)ql * blk + (size_t)(u - ql * npc) * rows * bn;
      V* dst = ring + (u % kStages) * piece;
      if (!kSplit || bn == BN) {
        for (int v = lane; v < nvec; v += 32)
          cp_async16(dst + kVec * v, src + kVec * v, true);
      } else {
        for (int v = lane; v < nvec; v += 32) {
          const int r = v / kRowVec, c = v - r * kRowVec;
          cp_async16(dst + r * BN + kVec * c, src + (size_t)r * bn + kVec * c,
                     true);
        }
      }
    };
#pragma unroll
    for (int q = 0; q < kStages - 1; ++q) {
      if (q < units) load(q);
      cp_async_commit();
    }
    int soff_cur = lane < mt.y ? __ldg(sj + lane) : 0;
    int soff_nxt = 32 + lane < mt.y ? __ldg(sj + 32 + lane) : 0;
    float sc_cur = 0.f, sc_nxt = 0.f;    // the slots' scales (int8)
    if constexpr (kQ) {
      sc_cur = lane < mt.y ? __ldg(scl + mt.x + lane) : 0.f;
      sc_nxt = 32 + lane < mt.y ? __ldg(scl + mt.x + 32 + lane) : 0.f;
    }
    float acc[R][BN];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int c = 0; c < BN; ++c) acc[i][c] = 0.f;
    for (int u = 0; u < units; ++u) {
      const int l = u / npc, pc = u - l * npc;
      if (pc == 0 && (l & 31) == 0 && l > 0) {
        soff_cur = soff_nxt;
        soff_nxt = l + 32 + lane < mt.y ? __ldg(sj + l + 32 + lane) : 0;
        if constexpr (kQ) {
          sc_cur = sc_nxt;
          sc_nxt = l + 32 + lane < mt.y ? __ldg(scl + mt.x + l + 32 + lane)
                                        : 0.f;
        }
      }
      const int q = u + kStages - 1;     // refill the stage freed at u - 1
      if (q < units) load(q);
      cp_async_commit();
      cp_async_wait<kStages - 1>();      // piece u has landed
      __syncwarp();
      const int soff = __shfl_sync(0xffffffffu, soff_cur, l & 31) +
                       pc * rows;
      float sc = 1.f;
      if constexpr (kQ) sc = __shfl_sync(0xffffffffu, sc_cur, l & 31);
      const V* wl = ring + (u % kStages) * piece;
      for (int k0 = 0; k0 < rows; k0 += 4) {
        float4 xv[R];
#pragma unroll
        for (int i = 0; i < R; ++i)
          xv[i] = *reinterpret_cast<const float4*>(xs + poff[i] + soff + k0);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          float wr[BN];
#pragma unroll
          for (int c4 = 0; c4 < BN / 4; ++c4) {
            if constexpr (kQ) {
              const char4 v = reinterpret_cast<const char4*>(wl)[
                  (k0 + k) * (BN / 4) + c4];
              wr[4 * c4] = (float)v.x * sc;
              wr[4 * c4 + 1] = (float)v.y * sc;
              wr[4 * c4 + 2] = (float)v.z * sc;
              wr[4 * c4 + 3] = (float)v.w * sc;
            } else {
              const float4 v = reinterpret_cast<const float4*>(wl)[
                  (k0 + k) * (BN / 4) + c4];
              wr[4 * c4] = v.x;
              wr[4 * c4 + 1] = v.y;
              wr[4 * c4 + 2] = v.z;
              wr[4 * c4 + 3] = v.w;
            }
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
    const int oc0 = mt.z * bn + sub * BN;
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
          y = y < 0.f ? 0.f : y;   // NaN passes, as in epilogue()
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

template <typename T, typename V, int BN, int R, bool kSplit>
cudaError_t launch_conv_r(const void* x, const void* vals, const float* scl,
                          const int* soffs, const int4* meta,
                          const void* bias, void* out, int ldo, int bk,
                          int bn, int kp, int act, const ConvTile& g,
                          int smem, cudaStream_t stream) {
  static bool attr_set = false;          // once per instantiation
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        bsr_conv_kernel<T, V, BN, R, kSplit>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  const int grid = g.B * g.tiles_h * g.tiles_w;
  bsr_conv_kernel<T, V, BN, R, kSplit>
      <<<grid, kConvThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const V*>(vals), scl, soffs,
      meta, static_cast<const T*>(bias), static_cast<T*>(out), ldo, bk, bn,
      kp, act, g);
  return cudaGetLastError();
}

template <typename T, typename V, int BN, bool kSplit>
cudaError_t launch_conv_split(const void* x, const void* vals,
                              const float* scl, const int* soffs,
                              const int4* meta, const void* bias, void* out,
                              int ldo, int bk, int bn, int kp, int act,
                              const ConvTile& g, int smem,
                              cudaStream_t stream) {
  switch (g.R) {
    case 1:
      return launch_conv_r<T, V, BN, 1, kSplit>(x, vals, scl, soffs, meta,
                                                bias, out, ldo, bk, bn, kp,
                                                act, g, smem, stream);
    case 2:
      return launch_conv_r<T, V, BN, 2, kSplit>(x, vals, scl, soffs, meta,
                                                bias, out, ldo, bk, bn, kp,
                                                act, g, smem, stream);
    case 4:
      if constexpr (BN <= 8)
        return launch_conv_r<T, V, BN, 4, kSplit>(x, vals, scl, soffs, meta,
                                                  bias, out, ldo, bk, bn, kp,
                                                  act, g, smem, stream);
      [[fallthrough]];
    default:
      return cudaErrorInvalidConfiguration;
  }
}

template <typename T, typename V, int BN>
cudaError_t launch_conv_bn(const void* x, const void* vals, const float* scl,
                           const int* soffs, const int4* meta,
                           const void* bias, void* out, int ldo, int bk,
                           int bn, int kp, int act, const ConvTile& g,
                           int smem, cudaStream_t stream) {
  if (bn == BN && kp == bk)
    return launch_conv_split<T, V, BN, false>(x, vals, scl, soffs, meta,
                                              bias, out, ldo, bk, bn, kp,
                                              act, g, smem, stream);
  return launch_conv_split<T, V, BN, true>(x, vals, scl, soffs, meta, bias,
                                           out, ldo, bk, bn, kp, act, g,
                                           smem, stream);
}

// BN, the columns a lane holds: bn itself for bn in {4, 8, 16}, else 16
// (bn / 16 subcolumns of a block column).
template <typename T, typename V>
cudaError_t launch_conv(const void* x, const void* vals, const float* scl,
                        const int* soffs, const int4* meta, const void* bias,
                        void* out, int ldo, int bk, int bn, int kp, int act,
                        const ConvTile& g, int smem, cudaStream_t stream) {
  if (bn == 4)
    return launch_conv_bn<T, V, 4>(x, vals, scl, soffs, meta, bias, out, ldo,
                                   bk, bn, kp, act, g, smem, stream);
  if (bn == 8)
    return launch_conv_bn<T, V, 8>(x, vals, scl, soffs, meta, bias, out, ldo,
                                   bk, bn, kp, act, g, smem, stream);
  if (bn % 16 == 0)
    return launch_conv_bn<T, V, 16>(x, vals, scl, soffs, meta, bias, out,
                                    ldo, bk, bn, kp, act, g, smem, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// Kernel 1, one launch over every degree bin of a PackedLayout: x (M, K)
// with row stride ldx (16-byte aligned base and rows), bias None or (N,)
// in ORIGINAL column order, out (M, N) with row stride ldo.  shape: the
// BsrShape ints (host memory); bins: n_bins BinDesc rows of 10 int64
// (host memory, one expert's); items: blocks of the launch per expert.
// ws: the fp32 workspace of the chunked columns (None when no column is
// cut); counters: one int32 per tile, all 0 on entry and again on exit.
// dtype: 0 float32, 1 bfloat16 (x and bias share it); out_dtype the
// same codes for out (any of the two under either x).  quant: 0
// values of x's dtype; 1 int8 values with a scale per stored block (the
// bin's scales (nb, L) fp32), 2 with a scale per block column ((nb,)).
// n_exp experts (1 for an unstacked layout; the bins' leaves then carry a
// leading expert axis): x, out and bias of expert e start ldx_e, ldo_e
// and ldb_e elements after expert e - 1's, its counters tiles_e and its
// workspace ws_e floats after.  Returns the cudaError_t of the launch (0
// on success); the caller raises.
extern "C" int bsr_matmul_launch(const void* x, const void* bias, void* out,
                                 void* ws, void* counters, const void* shape,
                                 const void* bins, int n_bins, int items,
                                 int ldx, int ldo, int act, int dtype,
                                 int quant, int n_exp, int ldx_e, int ldo_e,
                                 int ldb_e, int tiles_e, int ws_e,
                                 int out_dtype, void* stream) {
  BsrArgs a;
  memset(&a, 0, sizeof(a));
  memcpy(&a.p, shape, sizeof(a.p));
  if (quant < 0 || quant > 2 || bad_shape(a.p, n_bins, items, dtype, quant) ||
      act < 0 || act > 2 || (dtype != 0 && dtype != 1) || n_exp < 1 ||
      n_exp > 65535 || ldx_e < 0 || ldo_e < 0 || ldb_e < 0 || tiles_e < 0 ||
      ws_e < 0 || (out_dtype != 0 && out_dtype != 1))
    return (int)cudaErrorInvalidValue;
  memcpy(a.bins, bins, sizeof(BinDesc) * n_bins);
  a.ldx = ldx;
  a.ldo = ldo;
  a.act = act;
  a.n_bins = n_bins;
  a.quant = quant;
  a.out_dtype = out_dtype;
  a.ldx_e = ldx_e;
  a.ldo_e = ldo_e;
  a.ldb_e = ldb_e;
  a.tiles_e = tiles_e;
  a.ws_e = ws_e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(ws);
  int* ctr = static_cast<int*>(counters);
  if (dtype == 0)
    return quant ? (int)bsr_launch_typed<float, int8_t>(x, bias, out, w, ctr,
                                                        a, items, n_exp, s)
                 : (int)bsr_launch_typed<float, float>(x, bias, out, w, ctr,
                                                       a, items, n_exp, s);
  return quant ? (int)bsr_launch_typed<__nv_bfloat16, int8_t>(
                     x, bias, out, w, ctr, a, items, n_exp, s)
               : (int)bsr_launch_typed<__nv_bfloat16, __nv_bfloat16>(
                     x, bias, out, w, ctr, a, items, n_exp, s);
}

// Kernel 3, one launch over every degree bin of a conv PackedLayout:
// x the unpadded NHWC input (B, H, W, C), vals the layout's values as fp32
// (slots, bk, bn) with the bins concatenated in layout order -- or, with
// quant (as kernel 1's) not 0, as int8 and scales their (slots,) fp32
// scales (a column's "out" scale repeated over its slots; else None) --
// soffs their (slots,) int32
// offsets in the staged window (K-block kb's tap (dy, dx, c0) under geom),
// meta (columns, 4) int32 (first slot, slots, original block column, 0)
// per layout column, bias None or (N,) in original order, out (B*Ho*Wo, N)
// rows in (b, ho, wo) order with row stride ldo.  geom: the ConvTile ints
// (host memory), its n_cols the work items (block columns times bn / BN
// subcolumns).  bk % 4 == 0, bk | C, bn in {4, 8} or a multiple of 16;
// kp (conv_piece's) divides bk, a multiple of 4; smem includes the 8
// warps' rings of kStages (kp, BN) pieces (a float's room a value).
extern "C" int bsr_conv_launch(const void* x, const void* vals,
                               const void* scales, const void* soffs,
                               const void* meta, const void* bias, void* out,
                               const void* geom, int ldo, int act, int dtype,
                               int quant, int bk, int bn, int kp, int smem,
                               void* stream) {
  ConvTile g;
  memcpy(&g, geom, sizeof(g));
  if (g.B * g.Ho * g.Wo <= 0) return 0;
  const int sb = bn < 16 ? bn : 16;      // launch_conv's BN
  if (bk <= 0 || bk % 4 != 0 || g.C % bk != 0 || g.C % 4 != 0 ||
      kp <= 0 || kp % 4 != 0 || bk % kp != 0 ||
      (bn != 4 && bn != 8 && bn % 16 != 0) ||
      act < 0 || act > 2 || quant < 0 || quant > 2 ||
      g.n_cols * sb != g.N || ldo % 4 != 0 ||
      g.chan_ld % 4 != 0 || g.x_floats % 4 != 0 || smem > kSmemMax ||
      g.warps_pos <= 0 || kConvWarps % g.warps_pos != 0 ||
      (size_t)smem < 4 * ((size_t)kConvWarps * kStages * kp * sb +
                          g.x_floats))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scales);
  const int* so = static_cast<const int*>(soffs);
  const int4* mt = static_cast<const int4*>(meta);
  if (dtype == 0)
    return quant ? (int)launch_conv<float, int8_t>(x, vals, sc, so, mt,
                                                   bias, out, ldo, bk, bn,
                                                   kp, act, g, smem, s)
                 : (int)launch_conv<float, float>(x, vals, sc, so, mt, bias,
                                                  out, ldo, bk, bn, kp, act,
                                                  g, smem, s);
  if (dtype == 1)
    return quant ? (int)launch_conv<__nv_bfloat16, int8_t>(
                       x, vals, sc, so, mt, bias, out, ldo, bk, bn, kp, act,
                       g, smem, s)
                 : (int)launch_conv<__nv_bfloat16, float>(
                       x, vals, sc, so, mt, bias, out, ldo, bk, bn, kp, act,
                       g, smem, s);
  return (int)cudaErrorInvalidValue;
}
