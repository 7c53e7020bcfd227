"""Plain PyTorch versions of the sparse kernels: the oracles the kernels
are held against on the card, and what the kernel wrappers run for CPU
tensors.

Every version sums an output's products slot by slot in slot order and
applies the epilogue once over the whole output, so an output's value does
not depend on the binning (padding slots add exact zeros).  The implicit
conv versions gather their inputs from the padded image through the same
offset tables the kernels read (``conv_taps`` for the BCS conv, ``k_full``
for the tap conv), never through ``im2col``; they sum in the same order as
the materialized versions, so implicit and materialized agree bitwise.

On a quantized layout every version first dequantizes each slot's values,
``q.float() * s`` (the reference kernels' order), then multiplies in fp32:
the int8 kernels are held to the dequantized weight.

A tensor-parallel layout runs as the reference's shard launcher does: per
shard, per bin, then ``layout.merge_shards``; every column's sum is the
one it has unsharded, so sharded and unsharded outputs agree bitwise."""
from __future__ import annotations

import torch


def uniform_to_dense(values, k_idx, K):
    """(Nb, L, bk, bn) + (Nb, L) -> dense (K, Nb * bn).  Scatter-ADD so the
    zero-padding slots (k_idx 0, zero values) are harmless."""
    Nb, L, bk, bn = values.shape
    Kb = K // bk
    dense = torch.zeros((Kb, Nb, bk, bn), dtype=values.dtype,
                        device=values.device)
    jj = torch.arange(Nb, device=values.device)[:, None].expand(Nb, L)
    dense.index_put_((k_idx.reshape(-1).long(), jj.reshape(-1)),
                     values.reshape(Nb * L, bk, bn), accumulate=True)
    return dense.permute(0, 2, 1, 3).reshape(K, Nb * bn)


def _epilogue(y, bias, act):
    if bias is not None:
        y = y + bias.float()
    if act == "silu":
        y = y * torch.sigmoid(y)
    elif act == "relu":
        y = torch.clamp_min(y, 0.0)
    elif act != "none":
        raise ValueError(f"unknown activation {act!r}")
    return y


def _x_blocks(x, bk):
    """The K-block gather of a (M, K) matrix: kb (nb,) -> (nb, M, bk)."""
    M, K = x.shape
    xb = x.float().reshape(M, K // bk, bk).transpose(0, 1).contiguous()
    return lambda kb: xb[kb.long()]


def _bsr_sums(x_blocks, values, k_idx, M, scales=None):
    """fp32 (M, nb * bn) products of one bin, in layout column order,
    summed slot by slot in slot order (one batched (M, bk) @ (bk, bn)
    product per slot): like the kernel's, a column's sum does not depend
    on which bin it sits in, and padding slots add exact zeros.
    ``x_blocks(kb)`` gives the (nb, M, bk) x rows of K-blocks kb; int8
    values dequantize by ``scales``, (nb, L) per block or (nb,) per
    column."""
    nb, L, bk, bn = values.shape
    acc = torch.zeros((nb, M, bn), dtype=torch.float32,
                      device=values.device)
    for l in range(L):
        w = values[:, l].float()
        if scales is not None:
            s = scales[:, l] if scales.ndim == 2 else scales
            w = w * s[:, None, None]
        acc += torch.bmm(x_blocks(k_idx[:, l]), w)
    return acc.transpose(0, 1).reshape(M, nb * bn)


def bsr_matmul_ref(x, values, k_idx, bias=None, act="none", out_dtype=None,
                   scales=None):
    """x (M, K) @ one bin of BCS W -> (M, nb * bn) in layout column order:
    fp32 product (int8 values dequantized by ``scales``), bias +
    activation on the fp32 result, one rounding to ``out_dtype`` (default
    x.dtype)."""
    y = _epilogue(_bsr_sums(_x_blocks(x, values.shape[2]), values, k_idx,
                            x.shape[0], scales), bias, act)
    return y.to(out_dtype or x.dtype)


def bsr_matmul_packed_ref(x, layout, bias=None, act="none"):
    """x (M, K) @ PackedLayout W -> (M, N) in original column order.  The
    epilogue runs once over the whole output, so every element sits at the
    same place whatever the binning, and reordered and unreordered layouts
    give bit-identical outputs (vectorized CPU math otherwise treats the
    ragged tail of each bin differently)."""
    return _bsr_packed(_x_blocks(x, layout.block[0]), x.shape[0], layout,
                       bias, act).to(x.dtype)


def _bsr_packed(x_blocks, M, layout, bias, act):
    """fp32 (M, N) of every bin at its original columns, one epilogue."""
    bn = layout.block[1]
    acc = torch.empty((M, layout.shape[1]), dtype=torch.float32,
                      device=layout.nnz.device)
    for vals, kidx, cols, sc in zip(layout.values, layout.k_idx,
                                    layout.bin_cols, layout.bin_scales()):
        acc.view(M, -1, bn)[:, cols.long()] = _bsr_sums(
            x_blocks, vals, kidx, M, sc).view(M, -1, bn)
    return _epilogue(acc, bias, act)


def _shard_bins(layout, sums):
    """(S, M, N / S) fp32: each shard's bins summed by ``sums(values,
    index, scales)`` of its own leaves, concatenated in its layout
    order."""
    return torch.stack([
        torch.cat([sums(v[s], i[s], None if sc is None else sc[s])
                   for v, i, sc in zip(layout.values,
                                       layout.shard_index_leaves(),
                                       layout.bin_scales())], dim=1)
        for s in range(layout.n_shards)])


def _shard_epilogue(y, layout, bias, act, dtype):
    """The epilogue of per-shard sums (S, M, N / S) in layout order, the
    bias gathered into each shard's order: elementwise, so the same bits
    as one epilogue after ``merge_shards``."""
    b = layout.permute_bias(bias)
    return _epilogue(y, None if b is None else b[:, None, :], act).to(dtype)


def bsr_matmul_shard_parts(x, layout, bias=None, act="none"):
    """x (M, K) @ each shard of a tensor-parallel PackedLayout -> (S, M,
    N / S), each shard's columns in its layout order, epilogue applied:
    what one rank of a mesh computes over its local shards before the
    model-axis gather."""
    xb, M = _x_blocks(x, layout.block[0]), x.shape[0]
    return _shard_epilogue(_shard_bins(
        layout, lambda v, k, sc: _bsr_sums(xb, v, k, M, sc)), layout, bias,
        act, x.dtype)


def bsr_matmul_sharded_ref(x, layout, bias=None, act="none"):
    """x (M, K) @ a tensor-parallel PackedLayout -> (M, N) in original
    column order: per shard and bin, the epilogue, then
    ``merge_shards``."""
    return layout.merge_shards(bsr_matmul_shard_parts(x, layout, bias, act))


def bsr_matmul_experts_ref(x, layout, bias=None, act="none"):
    """x (E, M, K) @ an expert stack (``PackedLayout`` leaves with a
    leading E axis) -> (E, M, N): expert e's product with its own layout
    slice, expert by expert; bias None or (E, N)."""
    return torch.stack([
        bsr_matmul_packed_ref(x[e], layout.layer(e),
                              None if bias is None else bias[e], act)
        for e in range(x.shape[0])])


def _conv_rows(xp, Ho, Wo, stride):
    """(M,) flat offset of each output position's top-left input pixel in
    the padded image xp (B, Hp, Wp, C), positions in (b, ho, wo) order."""
    B, Hp, Wp, C = xp.shape
    dev = xp.device
    b = torch.arange(B, device=dev)[:, None, None]
    ho = torch.arange(Ho, device=dev)[None, :, None]
    wo = torch.arange(Wo, device=dev)[None, None, :]
    return ((b * Hp * Wp + ho * stride * Wp + wo * stride) * C).reshape(-1)


def bsr_conv2d_implicit_ref(xp, layout, taps, geom, bias=None, act="none"):
    """Padded image xp (B, Hp, Wp, C) * im2col-lowered PackedLayout ->
    (B*Ho*Wo, N): K-block kb of output position m reads channels
    [c0, c0 + bk) of tap (dy, dx) = ``taps[kb]`` at the position's pixel.
    geom = (Ho, Wo, stride)."""
    Ho, Wo, stride = geom
    _, _, Wp, C = xp.shape
    bk = layout.block[0]
    base = _conv_rows(xp, Ho, Wo, stride)
    tap_off = (taps[:, 0].long() * Wp + taps[:, 1].long()) * C + taps[:, 2]
    kk = torch.arange(bk, device=xp.device)
    xf = xp.reshape(-1).float()

    def x_blocks(kb):
        off = tap_off[kb.long()]
        return xf[base[None, :, None] + off[:, None, None] + kk]

    return _bsr_packed(x_blocks, base.numel(), layout, bias,
                       act).to(xp.dtype)


def _tap_sums(x_taps, values, slots, M, scales=None):
    """fp32 (M, G * group) of one bin in layout order: each output summed
    slot by slot in slot order.  ``x_taps(s)`` gives the (M, G) inputs of
    slot column s (one entry per group); int8 values dequantize by
    ``scales``, (G, L) per slot or (G, 1, group) per filter."""
    G, L, gp = values.shape
    acc = torch.zeros((M, G, gp), dtype=torch.float32, device=values.device)
    for l in range(L):
        w = values[:, l].float()
        if scales is not None:
            w = w * (scales[:, l][:, None] if scales.ndim == 2
                     else scales[:, 0])
        acc += x_taps(slots[:, l])[:, :, None] * w
    return acc.reshape(M, G * gp)


def _tap_packed(x_taps, M, layout, slot_tables, bias, act):
    """fp32 (M, P) of every bin at its original filter columns, one
    epilogue."""
    gp = layout.group
    acc = torch.empty((M, layout.shape[1]), dtype=torch.float32,
                      device=layout.nnz.device)
    for vals, slots, cols, sc in zip(layout.values, slot_tables,
                                     layout.bin_cols, layout.bin_scales()):
        acc.view(M, -1, gp)[:, cols.long()] = _tap_sums(
            x_taps, vals, slots, M, sc).view(M, -1, gp)
    return _epilogue(acc, bias, act)


def tap_gather_ref(x, values, t_idx, bias=None, act="none", scales=None):
    """x (M, R) alive band through one tap bin -> (M, G * group) in layout
    order; bias (G * group,) in layout order; int8 values dequantized by
    ``scales``."""
    xf = x.float()
    y = _tap_sums(lambda t: xf[:, t.long()], values, t_idx, x.shape[0],
                  scales)
    return _epilogue(y, bias, act).to(x.dtype)


def tap_gather_packed_ref(x, layout, bias=None, act="none"):
    """x (M, R) alive band @ TapLayout -> (M, P) in original filter
    order."""
    xf = x.float()
    return _tap_packed(lambda t: xf[:, t.long()], x.shape[0], layout,
                       layout.t_idx, bias, act).to(x.dtype)


def tap_gather_shard_parts(x, layout, bias=None, act="none"):
    """x (M, R) alive band @ each shard of a tensor-parallel TapLayout ->
    (S, M, P / S), each shard's filters in its layout order, epilogue
    applied (``bsr_matmul_shard_parts``'s sibling)."""
    xf, M = x.float(), x.shape[0]
    return _shard_epilogue(_shard_bins(
        layout, lambda v, t, sc: _tap_sums(lambda i: xf[:, i.long()], v, t,
                                           M, sc)), layout, bias, act,
        x.dtype)


def tap_gather_sharded_ref(x, layout, bias=None, act="none"):
    """x (M, R) alive band @ a tensor-parallel TapLayout -> (M, P) in
    original filter order: per shard and bin over the global band, the
    epilogue, then ``merge_shards``."""
    return layout.merge_shards(tap_gather_shard_parts(x, layout, bias, act))


def tap_gather_implicit_ref(xp, layout, kw, geom, bias=None, act="none"):
    """Padded image xp (B, Hp, Wp, C) * TapLayout -> (B*Ho*Wo, P): slot
    row k = ``k_full`` reads channel k % C of tap (dy, dx) =
    divmod(k // C, kw) at the output position's pixel.  geom = (Ho, Wo,
    stride)."""
    Ho, Wo, stride = geom
    _, _, Wp, C = xp.shape
    base = _conv_rows(xp, Ho, Wo, stride)
    xf = xp.reshape(-1).float()

    def x_taps(k):
        k = k.long()
        tap = k // C
        off = ((tap // kw) * Wp + tap % kw) * C + k % C
        return xf[base[:, None] + off[None, :]]

    return _tap_packed(x_taps, base.numel(), layout, layout.bin_k_full(),
                       bias, act).to(xp.dtype)


def masked_matmul_ref(x, w, mask, bias=None, act="none"):
    """x @ (w * mask) with the same fp32 epilogue and one rounding."""
    y = _epilogue(x.float() @ (w * mask.to(w.dtype)).float(), bias, act)
    return y.to(x.dtype)
