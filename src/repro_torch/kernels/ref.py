"""Plain PyTorch versions of the BCS block-sparse matmul: the oracle the
kernel is held against on the card, and what the kernel wrapper runs for
CPU tensors."""
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


def _bsr_sums(x, values, k_idx):
    """fp32 (M, nb * bn) products of one bin, in layout column order,
    summed slot by slot in slot order (one batched (M, bk) @ (bk, bn)
    product per slot): like the kernel's, a column's sum does not depend
    on which bin it sits in, and padding slots add exact zeros."""
    M, K = x.shape
    nb, L, bk, bn = values.shape
    xb = x.float().reshape(M, K // bk, bk).transpose(0, 1).contiguous()
    acc = torch.zeros((nb, M, bn), dtype=torch.float32, device=x.device)
    for l in range(L):
        acc += torch.bmm(xb[k_idx[:, l].long()], values[:, l].float())
    return acc.transpose(0, 1).reshape(M, nb * bn)


def bsr_matmul_ref(x, values, k_idx, bias=None, act="none", out_dtype=None):
    """x (M, K) @ one bin of BCS W -> (M, nb * bn) in layout column order:
    fp32 product, bias + activation on the fp32 result, one rounding to
    ``out_dtype`` (default x.dtype)."""
    y = _epilogue(_bsr_sums(x, values, k_idx), bias, act)
    return y.to(out_dtype or x.dtype)


def bsr_matmul_packed_ref(x, layout, bias=None, act="none"):
    """x (M, K) @ PackedLayout W -> (M, N) in original column order.  The
    epilogue runs once over the whole output, so every element sits at the
    same place whatever the binning, and reordered and unreordered layouts
    give bit-identical outputs (vectorized CPU math otherwise treats the
    ragged tail of each bin differently)."""
    M = x.shape[0]
    bn = layout.block[1]
    acc = torch.empty((M, layout.shape[1]), dtype=torch.float32,
                      device=x.device)
    for vals, kidx, cols in zip(layout.values, layout.k_idx,
                                layout.bin_cols):
        acc.view(M, -1, bn)[:, cols.long()] = _bsr_sums(
            x, vals, kidx).view(M, -1, bn)
    return _epilogue(acc, bias, act).to(x.dtype)


def masked_matmul_ref(x, w, mask, bias=None, act="none"):
    """x @ (w * mask) with the same fp32 epilogue and one rounding."""
    y = _epilogue(x.float() @ (w * mask.to(w.dtype)).float(), bias, act)
    return y.to(x.dtype)
