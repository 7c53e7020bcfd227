"""Dispatch over the sparse executor paths, and the host-side packing step.

``sparse_linear`` picks the execution strategy the compiler would emit for
a pruned layer:
  PackedLayout         -> the BCS kernel (skips pruned blocks; ragged M is
                          masked inside the kernel, so the packed path never
                          falls back to dense)
  dense weight (+mask) -> masked-dense plain version
``sparse_expert_linear`` runs an MoE expert stack's projections in one
launch of the same kernel.
``sparse_conv2d`` runs a block-punched conv through the BCS conv kernel
(over im2col patches, or implicit: staged from the image in the kernel)
and ``sparse_conv2d_pattern`` a pattern/connectivity conv through the
tap-gather kernels.  ``pack`` / ``pack_taps`` build the layouts, float
or int8 with fp32 scales (``core.quant``), unsharded or tensor parallel
(``n_shards``); every path above runs either, the kernels dequantizing on
the card.  A sharded conv layout runs materialized (im2col, then kernel 1
or 2), as the reference's does; an expert stack is never column-sharded.

On a mesh (``distributed.sharding``) x may be a placed ``DTensor`` and the
layout placed too: ``sparse_linear`` gathers x's features to every rank of
the layout's model axis (its batch rows stay where they are), runs the
rank's local launch (one per rank, plus one model-axis gather for a
column-sharded layout, ``bsr_matmul_sharded``) and places the result
like x; ``sparse_expert_linear`` runs each rank's local experts.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.core import bcs as BCS
from repro_torch.core import quant as QUANT
from repro_torch.core.packed import PackedLayout, TapLayout
from repro_torch.distributed import sharding as SH
from repro_torch.kernels import ref
from repro_torch.kernels.bsr_matmul import (bsr_conv2d_implicit,
                                            bsr_conv2d_patches,
                                            bsr_matmul_packed, conv_geometry,
                                            local_layout, pad_image,
                                            placed_layout,
                                            tap_gather_conv_implicit,
                                            tap_gather_conv_packed)

# Auto-selection of the implicit conv mode.  The reference picks it only
# for a patch tensor of at least 1 MiB and an image that fits one TPU core's
# fast memory.  On an H100 (``chip_smoke.py``'s floor sweep, VGG_TINY c2 and
# c3 under both mappings at B = 1, 4, 16, 64, patches of 0.28-36 MiB, and
# its per-layer rows at B = 256; PERF.md) the implicit kernels beat
# im2col + the same kernel (BCS) or + kernel 2 (tap) at every 3x3 and 5x5
# shape measured, the least margin 1.4x (BCS, B = 1): the kernels stage
# the image tile themselves, so the patch's bytes are never worth moving.
# So the port has no floor and no image cap: every conv with kh*kw > 1
# runs implicit.  A 1x1 conv (no patch blow-up) stays on the materialized
# route as in the reference; on the card both routes of a 1x1 run the same
# kernel (3 or 4): on the image, or on the patch matrix or alive band read
# as a 1 x M image.


def pack(w, mask, block=(128, 128), *, reorder=False, n_bins=4, conv=None,
         value_dtype=None, scale_granularity="block",
         n_shards=0) -> PackedLayout:
    """Pack a pruned (K, N) weight into the kernel layout on its device.
    With ``reorder`` the block columns are degree-sorted and split into
    ``n_bins`` bins (``core.bcs.pack_csc_reordered``); without it the layout
    is one bin in original column order.  ``conv=(kh, kw, cin)`` marks an
    im2col-lowered conv weight and attaches its ``conv_taps`` table.
    ``value_dtype="int8"`` quantizes the packed values at
    ``scale_granularity`` ("block" or "out"), as the reference's
    ``ops.pack`` does: the float pack first, then ``core.quant``.
    ``n_shards`` > 0 packs the tensor-parallel layout (degree-balanced
    column shards, ``core.bcs.shard_columns``), which implies the
    degree-sorted producer whatever ``reorder`` says."""
    if reorder or n_shards:
        out = BCS.pack_csc_reordered(w, mask, block, n_bins=n_bins,
                                     n_shards=n_shards)
    else:
        values, k_idx, nnz, _ = BCS.pack_csc(w, mask, block)
        out = PackedLayout(values=(values,), k_idx=(k_idx,), nnz=nnz,
                           block=tuple(block), shape=tuple(w.shape))
    if conv is not None:
        kh, kw, cin = conv
        out = dataclasses.replace(
            out, conv_taps=BCS.conv_tap_table(kh, kw, cin, block[0]))
    if value_dtype is not None:
        out = QUANT.quantize_layout(out, value_dtype=value_dtype,
                                    scale_granularity=scale_granularity)
    return out


def pack_taps(w, mask, *, group=1, reorder=True, n_bins=8,
              value_dtype=None, scale_granularity="block",
              n_shards=0) -> TapLayout:
    """Pack a pattern/connectivity-pruned (P, Q, Kh, Kw) conv weight into
    the tap-gather layout (``core.bcs.pattern_lower``), degree-sorted into
    ``n_bins`` bins when ``reorder`` is set.  ``value_dtype="int8"``
    quantizes the tap values (``core.quant``); "out" (a scale per filter)
    suits group = 1 layouts, where a per-slot scale costs 4 bytes per
    stored value.  ``n_shards`` > 0 packs the tensor-parallel layout
    (degree-balanced filter-group shards; implies ``reorder``)."""
    out = BCS.pattern_lower(w, mask, group=group, n_bins=n_bins,
                            reorder=reorder or bool(n_shards),
                            n_shards=n_shards)
    if value_dtype is not None:
        out = QUANT.quantize_layout(out, value_dtype=value_dtype,
                                    scale_granularity=scale_granularity)
    return out


def _on_mesh(fn, x, packed, placement):
    """``fn(local x)`` for a placed x: x redistributed to
    ``placement(mesh dim, x's placement there, the layout's model mesh
    dim)`` on each mesh dim, the rank's local tensor run, its result
    placed the same way."""
    mesh = x.device_mesh
    mdim = local_layout(packed)[2] if placed_layout(packed) else None
    want = tuple(placement(i, pl, mdim) for i, pl in enumerate(x.placements))
    xl = x.redistribute(mesh, want).to_local()
    return DTensor.from_local(fn(xl), mesh, want, run_check=False)


def sparse_linear(x, packed: PackedLayout | None = None, w=None, mask=None,
                  bias=None, act="none"):
    """x (..., K) -> (..., N) through whichever path applies.  With
    ``packed`` the BCS kernel always runs (one launch over all bins).  A
    placed x keeps its batch rows (dim 0) sharded over any mesh dim but
    the layout's model axis and is gathered over the rest."""
    if packed is not None and SH.is_placed(x):
        bias = SH.full(bias)
        return _on_mesh(
            lambda xl: sparse_linear(xl, packed, bias=bias, act=act), x,
            packed, lambda i, pl, mdim: pl if i != mdim and pl.is_shard(0)
            else Replicate())
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if packed is not None:
        y = bsr_matmul_packed(x2, packed, bias=bias, act=act)
    else:
        y = ref.masked_matmul_ref(
            x2, w, mask if mask is not None else w.new_ones(()),
            bias=bias, act=act)
    return y.reshape(*lead, y.shape[-1])


def sparse_expert_linear(x, packed: PackedLayout, bias=None, act="none"):
    """Batched per-expert sparse GEMM: x (E, M, K) -> (E, M, N).

    ``packed`` carries a leading expert axis on every leaf (values
    (E, nb_b, L_b, bk, bn), perm (E, Nb), ...), as ``serve.compile``
    packs MoE expert weights; bias None or (E, N).  One kernel launch
    covers every expert and every degree bin (the expert is a grid axis
    of the kernel, not a loop here); the plain version for CPU tensors
    runs expert by expert.  An expert stack is never column-sharded
    (``serve.compile`` exempts ``moe/`` paths from ``CompileSpec.tp``), so
    a sharded layout here raises."""
    if packed.n_shards:
        raise ValueError("sparse_expert_linear: MoE expert layouts shard "
                         "along the expert axis, not block columns; "
                         "serve.compile exempts moe/ paths from "
                         "CompileSpec.tp")
    if x.dim() != 3:
        raise ValueError(f"sparse_expert_linear: x {tuple(x.shape)} is not "
                         f"(E, M, K)")
    if SH.is_placed(x):
        # a stack placed by ``expert_layout_specs``: each rank its local
        # experts (x split on E over the same mesh dim), no collective
        bias = SH.full(bias)
        return _on_mesh(
            lambda xl: bsr_matmul_packed(xl, packed, bias=bias, act=act), x,
            packed, lambda i, pl, mdim: Shard(0) if i == mdim
            else Replicate())
    return bsr_matmul_packed(x, packed, bias=bias, act=act)


def im2col(x, kh, kw, stride=1, padding="SAME"):
    """x (B, H, W, C) -> patches (B, Ho, Wo, kh*kw*C), feature r =
    (i*kw + j)*C + c (``core.bcs.conv_lower``'s row order).  The
    MATERIALIZED path: it allocates the whole patch tensor."""
    xp, (Ho, Wo) = pad_image(x, kh, kw, stride, padding)
    taps = [xp[:, i:i + stride * (Ho - 1) + 1:stride,
               j:j + stride * (Wo - 1) + 1:stride, :]
            for i in range(kh) for j in range(kw)]
    return torch.cat(taps, dim=-1) if len(taps) > 1 else taps[0]


def patch_bytes(x, kh, kw, stride=1, padding="SAME"):
    """Bytes of the patch tensor the materialized path allocates."""
    B, H, W, C = x.shape
    _, _, Ho, Wo = conv_geometry(H, W, kh, kw, stride, padding)
    return B * Ho * Wo * kh * kw * C * x.element_size()


def _pick_implicit(implicit, x, kh, kw, stride, padding, bk=None,
                   n_shards=0):
    """Resolve the ``implicit=`` tri-state.  None picks the implicit mode
    for every conv whose patch tensor is a real blow-up (kh*kw > 1); the
    BCS path also needs its packing block inside one tap (bk | Cin),
    which an explicit ``implicit=True`` requires instead of falling
    back.  A sharded layout runs materialized; ``implicit=True`` on one
    raises.  (x, stride and padding: the signature of the reference's,
    whose patch-size floor the card's timings removed.)"""
    C = x.shape[-1]
    if n_shards:
        if implicit:
            raise ValueError("implicit conv does not take sharded layouts "
                             "(they run materialized)")
        return False
    if implicit is None:
        if bk is not None and C % bk:
            return False
        return kh * kw > 1
    if implicit and bk is not None and C % bk:
        raise ValueError(f"implicit conv needs bk={bk} | Cin={C} (K-blocks "
                         f"must not straddle kernel taps)")
    return bool(implicit)


def sparse_conv2d(x, packed: PackedLayout, *, kh, kw, stride=1,
                  padding="SAME", bias=None, act="none", implicit=None):
    """x (B, H, W, Cin) * packed im2col-lowered conv weight -> (B, Ho, Wo,
    Cout) through the BCS conv kernel, bias + activation fused.
    ``implicit`` picks its input (None = auto, ``_pick_implicit``): the
    image itself, or the im2col patch matrix read as a 1 x M image of K
    channels; bit-identical outputs either way.  A sharded layout runs
    the patch matrix through kernel 1 (``bsr_matmul_sharded``)."""
    B, H, W, C = x.shape
    if packed.shape[0] != kh * kw * C:
        raise ValueError(f"layout K={packed.shape[0]} != kh*kw*Cin="
                         f"{kh * kw * C}")
    if _pick_implicit(implicit, x, kh, kw, stride, padding,
                      bk=packed.block[0], n_shards=packed.n_shards):
        return bsr_conv2d_implicit(x.contiguous(), packed, kh=kh, kw=kw,
                                   stride=stride, padding=padding,
                                   bias=bias, act=act)
    patches = im2col(x, kh, kw, stride, padding)
    _, Ho, Wo, K = patches.shape
    run = bsr_matmul_packed if packed.n_shards else bsr_conv2d_patches
    y = run(patches.reshape(B * Ho * Wo, K).contiguous(), packed,
            bias=bias, act=act)
    return y.reshape(B, Ho, Wo, y.shape[-1])


def sparse_conv2d_pattern(x, tap: TapLayout, *, kh, kw, stride=1,
                          padding="SAME", bias=None, act="none",
                          implicit=None):
    """x (B, H, W, Cin) * tap-lowered conv weight -> (B, Ho, Wo, Cout).
    Materialized: im2col, the patch matrix gathered down to ``tap.alive``
    (rows pruned in every filter are dropped), then kernel 2.  Implicit
    (``implicit=True`` or auto by patch size): kernel 4 straight off the
    padded image.  Bit-identical outputs either way.  A sharded layout
    runs materialized (kernel 2, ``tap_gather_conv_sharded``)."""
    B, H, W, C = x.shape
    if tap.shape[0] != kh * kw * C:
        raise ValueError(f"layout K={tap.shape[0]} != kh*kw*Cin="
                         f"{kh * kw * C}")
    if _pick_implicit(implicit, x, kh, kw, stride, padding,
                      n_shards=tap.n_shards):
        return tap_gather_conv_implicit(x.contiguous(), tap, kh=kh, kw=kw,
                                        stride=stride, padding=padding,
                                        bias=bias, act=act)
    patches = im2col(x, kh, kw, stride, padding)
    _, Ho, Wo, K = patches.shape
    band = patches.reshape(B * Ho * Wo, K)
    if tap.n_alive < K:
        # alive is ascending, so a full-size alive index is arange(K):
        # gather only when rows are dead everywhere (a placed layout's
        # alive is replicated: every rank holds it whole)
        alive = local_layout(tap)[0].alive if placed_layout(tap) \
            else tap.alive
        band = band.index_select(1, alive.long())
    y = tap_gather_conv_packed(band, tap, bias=bias, act=act)
    return y.reshape(B, Ho, Wo, y.shape[-1])


def flops_saved(packed: PackedLayout) -> float:
    """Fraction of dense matmul FLOPs the kernel skips (padding counts)."""
    return packed.flops_saved


def padding_overhead(packed: PackedLayout) -> float:
    """Executed-block overhead of uniform padding vs ideal CSC."""
    return packed.padding_overhead
