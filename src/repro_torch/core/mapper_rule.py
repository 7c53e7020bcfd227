"""Rule-based pruning-scheme mapping (paper §5.2, Fig 8) — training-free,
the reference's rules on the ported latency model.

Workflow per layer:
  1. depthwise conv / conv1d / router / embedding / norms -> NO pruning
     (§5.2.4: cheap + sensitive; router/embed are the LM analogues).
  2. 3x3 CONV -> pattern-based when the task is "hard" (Remark 1), else
     block-punched; other convs -> block-punched.
  3. FC layers (all LM projections) -> block-based; block size = the
     SMALLEST legal block whose modeled latency is within (1+beta) of the
     structured-pruning baseline at equal compression (§5.2.2) — smallest
     because finer granularity = higher accuracy.
  4. Serving precision rides the same pricing: every packable pick is
     re-priced with int8 values (``matmul_latency(value_bytes=1)``), and
     the strictly cheaper precision wins the layer
     (``SchemeChoice.value_dtype``).

The picks are in the mapper's own coordinates: an FC layer's block is a
(K, N) block of its GEMM, a conv's of its lowered GEMM (K = Cin*kh*kw,
N = Cout), as the latency model prices them; the mask functions of
``core.reweighted`` read them as they read any rule's block.

``lm_layers`` copies the reference's rules in the reference's order,
including its cross-attention rule, which never matches: the
self-attention patterns come first and ``match`` searches, so
``attn/wq/w`` also takes ``xattn/wq/w`` (and the encoder's leaves take the
decoder's rules)."""
from __future__ import annotations

from dataclasses import dataclass, replace

from repro_torch.configs.base import ArchConfig
from repro_torch.core.latency_model import (TPUTarget, V5E, im2col_x_frac,
                                            matmul_latency,
                                            pattern_executed_frac,
                                            structured_baseline,
                                            conv_as_gemm)
from repro_torch.core.regularity import legal_blocks
from repro_torch.core.reweighted import SchemeChoice

@dataclass(frozen=True)
class LayerDesc:
    path: str            # regex into the param tree
    kind: str            # fc | conv3x3 | conv1x1 | convkxk | dw | frozen
    M: int               # GEMM dims (tokens x K x N)
    K: int
    N: int
    count: int = 1       # layers sharing this desc (scanned stacks)
    taps: int = 0        # Kh*Kw for conv-as-GEMM layers (0 = plain GEMM):
                         # prices activation traffic at the implicit-GEMM
                         # path's feature-map read (im2col_x_frac) instead
                         # of the full M*K patch bytes


def lm_layers(cfg: ArchConfig, tokens: int) -> list[LayerDesc]:
    """Enumerate the prunable GEMMs of an LM-family arch."""
    out = []
    D, F, hd = cfg.d_model, cfg.d_ff, cfg.hd
    L = cfg.n_layers
    if cfg.family in ("dense", "moe", "hybrid", "encdec", "vlm"):
        H, KV = cfg.n_heads, cfg.n_kv_heads
        out += [
            LayerDesc(r"attn/wq/w", "fc", tokens, D, H * hd, L),
            LayerDesc(r"attn/w[kv]/w", "fc", tokens, D, KV * hd, 2 * L),
            LayerDesc(r"attn/wo/w", "fc", tokens, H * hd, D, L),
        ]
    if cfg.family == "moe":
        tpe = max(1, tokens * cfg.top_k // cfg.n_experts)
        out += [
            LayerDesc(r"moe/(gate|up)/w", "fc", tpe, D, F, 2 * L),
            LayerDesc(r"moe/down/w", "fc", tpe, F, D, L),
            LayerDesc(r"moe/router", "frozen", tokens, D, cfg.n_experts, L),
        ]
    elif cfg.family in ("dense", "hybrid", "encdec", "vlm"):
        out += [
            LayerDesc(r"ffn/(gate|up)/w", "fc", tokens, D, F, 2 * L),
            LayerDesc(r"ffn/down/w", "fc", tokens, F, D, L),
        ]
    if cfg.family in ("ssm", "hybrid"):
        d_inner = cfg.ssm_expand * D
        proj = 2 * d_inner + 2 * cfg.ssm_state + d_inner // cfg.ssm_headdim
        out += [
            LayerDesc(r"ssm/in_proj/w", "fc", tokens, D, proj, L),
            LayerDesc(r"ssm/out_proj/w", "fc", tokens, d_inner, D, L),
            LayerDesc(r"ssm/conv", "dw", tokens, 4, d_inner, L),
        ]
    if cfg.family in ("encdec", "vlm"):
        # shadowed by the attn/* rules above (see the module docstring)
        out += [LayerDesc(r"xattn/wq/w|xattn/wo/w", "fc", tokens, D, H * hd,
                          2 * L)]
    out += [
        LayerDesc(r"head/table", "fc", tokens, D, cfg.vocab, 1),
        LayerDesc(r"embed/table", "frozen", tokens, cfg.vocab, D, 1),
    ]
    return out


def conv_layers(specs) -> list[LayerDesc]:
    """specs: list of (name, feat, in_ch, out_ch, kh, kw, depthwise)."""
    out = []
    for (name, feat, cin, cout, kh, kw, dw) in specs:
        M, K, N = conv_as_gemm(feat, cin, cout, kh, kw)
        kind = "dw" if dw else (
            "conv3x3" if (kh, kw) == (3, 3) else
            "conv1x1" if (kh, kw) == (1, 1) else "convkxk")
        out.append(LayerDesc(name, kind, M, K, N, taps=0 if dw else kh * kw))
    return out


def select_block_size(M, K, N, compression, beta, target: TPUTarget = V5E,
                      menu=None, x_frac=None):
    """§5.2.2: smallest block within (1+beta) of structured latency.
    ``x_frac`` forwards the conv activation-traffic multiplier (the
    implicit-GEMM feature-map read) into the block pricing."""
    base = structured_baseline(M, K, N, compression, target)
    cands = legal_blocks(K, N) if menu is None else \
        [b for b in menu if K % b[0] == 0 and N % b[1] == 0]
    cands = sorted(cands, key=lambda b: b[0] * b[1])
    for b in cands:
        t = matmul_latency(M, K, N, scheme="block", block=b,
                           compression=compression, target=target,
                           x_frac=x_frac)
        if t <= (1 + beta) * base:
            return b, t, base
    b = cands[-1] if cands else (min(K, 128), min(N, 128))
    t = matmul_latency(M, K, N, scheme="block", block=b,
                       compression=compression, target=target, x_frac=x_frac)
    return b, t, base


def _pick_precision(choice, t, *, M, K, N, compression, target,
                    executed_frac=None, x_frac=None):
    """Re-price a packable pick with int8 values (``value_bytes=1``) and
    return (choice, latency) of the cheaper precision — the mapper's
    per-layer precision action.  Strictly-better wins: a compute-bound
    layer whose modeled latency does not move keeps float values, so it
    never pays quantization error for nothing."""
    t_q = matmul_latency(M, K, N, scheme=choice.scheme, block=choice.block,
                         compression=compression, target=target,
                         value_bytes=1, executed_frac=executed_frac,
                         x_frac=x_frac)
    if t_q < t:
        return replace(choice, value_dtype="int8"), t_q
    return choice, t


def map_rules(layers: list[LayerDesc], *, dataset_hard=True, beta=0.2,
              compression=8.0, target: TPUTarget = V5E):
    """Returns (PruneSpec rules, per-layer report) — each rule's
    ``SchemeChoice`` carries the scheme, block, and the precision pick
    (``value_dtype``), all priced by the extended latency model."""
    spec, report = [], []
    for ld in layers:
        if ld.kind in ("dw", "frozen"):
            choice = SchemeChoice("none")
            t = t_base = 0.0
        elif ld.kind == "conv3x3":
            # conv-as-GEMM activation traffic is priced at the implicit
            # kernels' feature-map read (DRAM bytes, not MACs) — the
            # serving path never materializes the M*K patch tensor
            xf = im2col_x_frac(ld.taps or 9)
            if dataset_hard:
                conn = 1 - 4 / 9 / 1.0
                choice = SchemeChoice("pattern", connectivity=conn)
                # rank the pattern pick by what the tap-gather kernel
                # EXECUTES (4-of-9 taps x surviving kernels), not by the
                # raw 4/9 mask density it used to be priced at
                frac = pattern_executed_frac(conn)
                t = matmul_latency(ld.M, ld.K, ld.N, scheme="pattern",
                                   compression=1 / frac, target=target,
                                   executed_frac=frac, x_frac=xf)
                t_base = structured_baseline(ld.M, ld.K, ld.N, 1 / frac,
                                             target)
                choice, t = _pick_precision(
                    choice, t, M=ld.M, K=ld.K, N=ld.N,
                    compression=1 / frac, target=target,
                    executed_frac=frac, x_frac=xf)
            else:
                b, t, t_base = select_block_size(ld.M, ld.K, ld.N,
                                                 compression, beta, target,
                                                 x_frac=xf)
                choice = SchemeChoice("block_punched", block=b)
                choice, t = _pick_precision(
                    choice, t, M=ld.M, K=ld.K, N=ld.N,
                    compression=compression, target=target, x_frac=xf)
        elif ld.kind in ("fc", "conv1x1", "convkxk"):
            xf = im2col_x_frac(ld.taps) if ld.taps > 1 else None
            b, t, t_base = select_block_size(ld.M, ld.K, ld.N, compression,
                                             beta, target, x_frac=xf)
            t_dense = matmul_latency(ld.M, ld.K, ld.N, target=target,
                                     x_frac=xf)
            if t > t_dense:
                # pruning would SLOW this layer (MXU-unfriendly dims, e.g.
                # mamba2's 8512-wide in_proj): map no scheme — latency is
                # the rule method's first-class constraint (§5.2.2)
                choice = SchemeChoice("none")
                t = t_dense
            else:
                choice = SchemeChoice("block", block=b)
                choice, t = _pick_precision(
                    choice, t, M=ld.M, K=ld.K, N=ld.N,
                    compression=compression, target=target, x_frac=xf)
        else:
            raise ValueError(ld.kind)
        spec.append((ld.path, choice))
        report.append({"path": ld.path, "kind": ld.kind,
                       "scheme": choice.scheme, "block": choice.block,
                       "value_dtype": choice.value_dtype,
                       "latency_s": t, "structured_s": t_base,
                       "count": ld.count})
    return spec, report


def total_latency(report) -> float:
    return sum(r["latency_s"] * r["count"] for r in report)
