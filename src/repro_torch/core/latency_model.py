"""Offline latency model (paper §5.2.1), the reference's TPU-analytical
edition, ported verbatim: pure Python floats, so the mappers here rank
every layer exactly as the reference's do.

The paper measures a lookup table of layer latencies on the target phone
(512 settings, ~30 min).  The reference builds the same *interface* —
latency(layer setting) -> seconds — from a three-term roofline
parameterized by a TPU datasheet (``TPUTarget``), with scheme/block-size
dependent efficiency factors that encode the compiler/kernel behavior:

  t = max(flops_eff / (peak * util(scheme, block)),
          bytes(scheme, block) / hbm_bw) + grid_steps * step_overhead

  * util: matrix-unit tile utilization — blocks smaller than the 128x128
    MXU tile waste systolic lanes; unstructured sparsity cannot use the
    matrix unit at all (gather bound).
  * bytes: BCS values + hierarchical index metadata + activations.
  * step_overhead: per grid-step pipeline bubble — more/smaller blocks =
    more steps (the paper's branch-overhead analogue).

The constants are a TPU's, not an H100's: ``calibrate`` swaps in measured
rates (the card's own, from ``chip_smoke.py``), and ``build_table``
materializes the lookup-table form the rule-based mapper consumes."""
from __future__ import annotations

import itertools
from dataclasses import dataclass, replace


@dataclass(frozen=True)
class TPUTarget:
    name: str = "v5e"
    peak_flops: float = 197e12        # bf16
    hbm_bw: float = 819e9
    ici_bw: float = 50e9              # per link
    mxu: int = 128
    step_overhead: float = 1.5e-7     # per pallas grid step (pipeline bubble)
    gather_bw_frac: float = 0.08      # unstructured: effective HBM fraction
    vpu_frac: float = 0.02            # VPU-only compute as a peak fraction
                                      # (gather-fed paths that defeat MXU
                                      # tiling: unstructured CSR and the
                                      # pattern tap-gather kernel)


V4 = TPUTarget("v4", 275e12, 1228e9, 45e9)
V5E = TPUTarget()
V5P = TPUTarget("v5p", 459e12, 2765e9, 90e9)


def _util(scheme: str, block, mxu=128) -> float:
    if scheme in ("structured_row", "structured_col", "none"):
        return 1.0
    if scheme == "unstructured":
        return 0.0                     # handled as gather-bound
    if scheme in ("block", "block_row", "block_col", "block_punched"):
        bk, bn = block
        return min(bk, mxu) / mxu * min(bn, mxu) / mxu if bk < mxu or bn < mxu \
            else 1.0
    if scheme == "pattern":
        # 4-of-9 pattern compute maps to TPU as dense 3x3 with masked taps:
        # compute not skippable on MXU, only HBM traffic shrinks.
        return 1.0
    raise ValueError(scheme)


def pattern_executed_frac(connectivity=0.0, taps=4, positions=9) -> float:
    """Executed-tap fraction of the tap-gather kernel under a pattern
    scheme: ``taps``-of-``positions`` kernel patterns times the kernels
    that survive connectivity pruning.  This is the *executed* cost the
    mappers rank pattern picks by — when a real ``TapLayout`` exists, pass
    its measured ``1 - flops_saved`` (which also counts bin padding) as
    ``executed_frac`` instead."""
    return taps / positions * (1.0 - connectivity)


def im2col_x_frac(taps, implicit=True) -> float:
    """Activation-traffic multiplier on a conv-as-GEMM's x bytes (M*K).

    The memory-traffic term the mappers price the implicit path with: a
    conv lowered to an im2col GEMM nominally reads M*K activation bytes —
    a ``taps`` = Kh*Kw blow-up of the feature map.  The implicit-GEMM
    kernels (``kernels.bsr_matmul.bsr_conv2d_implicit`` /
    ``tap_gather_conv_implicit``) read the padded feature map once instead
    (frac 1/taps, the halo ignored as second-order); the MATERIALIZED path
    additionally writes the patch tensor to HBM and reads it back on top
    of the original feature-map read (2 + 1/taps).  FLOPs are identical —
    only DRAM bytes move, which is exactly what decides the conv layers
    of a memory-bound mobile/real-time deployment."""
    taps = max(1, int(taps))
    return 1.0 / taps if implicit else 2.0 + 1.0 / taps


def matmul_latency(M, K, N, *, scheme="none", block=(128, 128),
                   compression=1.0, target: TPUTarget = V5E,
                   dtype_bytes=2, value_bytes=None, executed_frac=None,
                   x_frac=None) -> float:
    """One FC/CONV-as-GEMM layer: y(M,N) = x(M,K) @ w(K,N) with the given
    pruning scheme at `compression` (param reduction factor).

    ``executed_frac`` overrides the raw density with the fraction of dense
    MACs the kernel actually executes under its padded layout (pattern
    scheme: measured tap savings from a ``core.packed.TapLayout``) — the
    executed-cost hook the mappers use so a pattern pick is ranked by what
    the tap-gather kernel runs, not by raw mask density.

    ``value_bytes`` is the stored bytes per surviving WEIGHT value (the
    quantized serving path of ``core.quant``: 1 for int8 values, while
    activations stay at ``dtype_bytes``).  None keeps ``dtype_bytes``.
    When it differs, the sparse branches add the fp32 scale traffic the
    dequantizing kernels actually read: one scale per surviving block
    ("block" granularity) for the block schemes, one per output filter
    for the pattern scheme (tap layouts quantize per-filter).  Compute
    terms are unchanged — the kernels dequantize into the same fp32
    accumulation, so quantization only moves the HBM term, which is
    exactly the post-implicit-GEMM bottleneck it attacks.

    ``x_frac`` scales the activation DRAM bytes (memory-traffic term) for
    conv-as-GEMM layers: pass ``im2col_x_frac(kh*kw)`` to price the
    implicit-GEMM path (feature map read once, no patch tensor) or
    ``im2col_x_frac(kh*kw, implicit=False)`` for the materialized patch
    write+read.  None (the default) keeps the plain GEMM accounting (and,
    on the pattern branch, the legacy alive-band estimate)."""
    density = 1.0 / max(compression, 1.0)
    dense_flops = 2.0 * M * K * N
    x_b = M * K * dtype_bytes
    y_b = M * N * dtype_bytes
    w_dense_b = K * N * dtype_bytes
    v_b = dtype_bytes if value_bytes is None else value_bytes

    if scheme == "none":
        t_c = dense_flops / target.peak_flops
        t_m = (x_b * (1.0 if x_frac is None else x_frac)
               + y_b + w_dense_b) / target.hbm_bw
        steps = max(1, (M // target.mxu) * (N // target.mxu))
        return max(t_c, t_m) + steps * target.step_overhead

    if scheme == "unstructured":
        # CSR gather: no MXU, index+value traffic at degraded bandwidth
        w_b = density * K * N * (v_b + 4)
        t_m = (x_b + y_b + w_b) / (target.hbm_bw * target.gather_bw_frac)
        t_c = density * dense_flops / (target.peak_flops * target.vpu_frac)
        return max(t_c, t_m)

    if scheme in ("structured_row", "structured_col"):
        # dense GEMM with a shrunk dimension
        if scheme == "structured_row":
            N2, K2 = N * density, K
        else:
            N2, K2 = N, K * density
        return matmul_latency(M, int(max(K2, 1)), int(max(N2, 1)),
                              scheme="none", target=target,
                              dtype_bytes=dtype_bytes)

    if scheme == "pattern":
        # tap-gather kernel (kernels.bsr_matmul.tap_gather_conv): only the
        # executed taps are gathered and multiplied — compute scales with
        # the executed-tap fraction at VPU efficiency (per-filter tap sets
        # defeat MXU tiling), HBM shrinks to surviving values + 4-byte tap
        # ids + the alive activation band.  One grid step per (M tile,
        # filter group) at group=1 — the serve-path layout.
        frac = executed_frac if executed_frac is not None else density
        t_c = frac * dense_flops / (target.peak_flops * target.vpu_frac)
        w_b = frac * K * N * (v_b + 4)
        if v_b != dtype_bytes:
            w_b += 4 * N               # per-filter fp32 scales ("out")
        # activation traffic: explicit x_frac (implicit kernel reads the
        # feature map, materialized pays the patch round-trip); the legacy
        # default approximates the alive-band read of the gathered path
        x_eff = x_frac if x_frac is not None else min(1.0, 9 * frac)
        t_m = (x_b * x_eff + y_b + w_b) / target.hbm_bw
        steps = max(1.0, max(1, M // 512) * N)
        return max(t_c, t_m) + steps * target.step_overhead

    # block / block_punched: skip zero blocks, pay utilization + per-step
    # overhead for sub-MXU tiles
    bk, bn = block
    util = _util(scheme, block, target.mxu)
    n_blocks_alive = density * (K // bk) * (N // bn)
    eff_flops = density * dense_flops
    t_c = eff_flops / (target.peak_flops * util)
    idx_b = 4 * n_blocks_alive + 4 * (K // bk)
    w_b = density * K * N * v_b + idx_b
    if v_b != dtype_bytes:
        w_b += 4 * n_blocks_alive      # per-block fp32 scales
    t_m = (x_b * (1.0 if x_frac is None else x_frac)
           + y_b + w_b) / target.hbm_bw
    # grid steps at the autotuned M-tile (512): each M-tile revisits every
    # surviving weight block (kernels/bsr_matmul.py grid structure)
    steps = max(1.0, n_blocks_alive * max(1, M // 512))
    return max(t_c, t_m) + steps * target.step_overhead


def structured_baseline(M, K, N, compression, target=V5E) -> float:
    return matmul_latency(M, K, N, scheme="structured_row",
                          compression=compression, target=target)


def conv_as_gemm(feat, in_ch, out_ch, kh, kw, batch=1):
    """im2col GEMM dims for a conv layer: M=B*H*W, K=Cin*kh*kw, N=Cout."""
    return batch * feat * feat, in_ch * kh * kw, out_ch


# ---------------------------------------------------------------------------
# The offline table (paper: 512 settings measured in ~30 min on-device)
# ---------------------------------------------------------------------------

def build_table(target: TPUTarget = V5E,
                feats=(7, 14, 28, 56), chans=(64, 128, 256, 512),
                schemes=("none", "unstructured", "structured_row", "pattern",
                         "block"),
                blocks=((4, 4), (8, 16), (16, 32), (32, 64), (64, 128),
                        (128, 128), (128, 256)),
                compressions=(1, 2, 4, 8, 12, 16)) -> dict:
    table = {}
    for f, c, s, comp in itertools.product(feats, chans, schemes,
                                           compressions):
        M, K, N = conv_as_gemm(f, c, c, 3, 3)
        blist = blocks if s.startswith("block") else ((0, 0),)
        for b in blist:
            if s.startswith("block") and (K % b[0] or N % b[1]):
                continue
            key = (f, c, s, b, comp)
            table[key] = matmul_latency(M, K, N, scheme=s, block=b,
                                        compression=comp, target=target)
    return table


def calibrate(target: TPUTarget, measured_flops_per_s=None,
              measured_bytes_per_s=None) -> TPUTarget:
    """Rescale datasheet constants to dry-run-derived effective rates."""
    kw = {}
    if measured_flops_per_s:
        kw["peak_flops"] = measured_flops_per_s
    if measured_bytes_per_s:
        kw["hbm_bw"] = measured_bytes_per_s
    return replace(target, **kw)
