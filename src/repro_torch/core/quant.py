"""Symmetric int8 quantization of the packed layouts.

``quantize_layout`` turns a float ``PackedLayout`` or ``TapLayout`` into
the same layout with int8 values and a per-bin ``scales`` leaf tuple of
fp32; indices, bins, perm and geometry are untouched, so the quantized
layout runs through every consumer of the float one, and the kernels
dequantize ``q * s`` on the card before their fp32-accumulated products.

Scheme (the reference's, ``repro/core/quant.py``): ``s = maxabs(group) /
127`` and ``q = clip(rint(v / s), -127, 127)``, no zero point, so pruned
and padding slots stay exactly zero; an all-zero group stores scale 0.
Every step is one correctly rounded fp32 operation (division, round half
to even), so the card and the host give the same bits.

Granularity: ``"block"`` — one scale per stored unit, a (bk, bn) block
(``PackedLayout`` scales (..., nb_b, L_b)) or a tap slot (``TapLayout``
scales (G_b, L_b)); ``"out"`` — one per output column, a block column
((..., nb_b)) or a filter ((..., G_b, 1, group)).  The scale's rank
against the values' tells the two apart.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.packed import PackedLayout, TapLayout

QMAX = 127.0
GRANULARITIES = ("block", "out")


def _scale_and_cast(v, dims):
    """One bin's values quantized over ``dims`` (the reduced group axes):
    (int8 values, fp32 scales with ``dims`` dropped)."""
    v = v.float()
    maxabs = v.abs().amax(dim=dims)
    # a tensor divisor: CUDA divides by a Python scalar as a multiply by
    # its reciprocal, which is not the correctly rounded quotient
    scale = maxabs / torch.full_like(maxabs, QMAX)
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    for d in sorted(d % v.ndim for d in dims):
        safe = safe.unsqueeze(d)
    q = torch.clamp(torch.round(v / safe), -QMAX, QMAX).to(torch.int8)
    return q, scale


def quantize_layout(layout, *, value_dtype="int8",
                    scale_granularity="block"):
    """The layout with its values quantized to ``value_dtype`` (only
    "int8") and the per-bin fp32 ``scales`` attached, on the layout's
    device.  Stacked ``PackedLayout`` leaves (layers, experts) quantize
    slice by slice like any leading axis.  A layout that already carries
    scales is refused: quantizing twice would compound the error."""
    if value_dtype != "int8":
        raise ValueError(f"unsupported value_dtype {value_dtype!r} "
                         "(only 'int8')")
    if scale_granularity not in GRANULARITIES:
        raise ValueError(f"unsupported scale_granularity "
                         f"{scale_granularity!r} (one of {GRANULARITIES})")
    if isinstance(layout, PackedLayout):
        # values (..., nb_b, L_b, bk, bn): "block" reduces the block,
        # "out" also the column's slots
        dims = (-2, -1) if scale_granularity == "block" else (-3, -2, -1)
    elif isinstance(layout, TapLayout):
        # values (..., G_b, L_b, group): "block" reduces a slot's filters,
        # "out" a filter's slots, kept as a broadcastable (..., G_b, 1,
        # group) (a sharded layout's (S, G_b, 1, group))
        dims = (-1,) if scale_granularity == "block" else (-2,)
    else:
        raise TypeError(f"not a packable layout: {type(layout).__name__}")
    if layout.scales is not None:
        raise ValueError("layout is already quantized (scales present)")
    values, scales = [], []
    for v in layout.values:
        q, s = _scale_and_cast(v, dims)
        if isinstance(layout, TapLayout) and scale_granularity == "out":
            s = s.unsqueeze(-2)
        values.append(q)
        scales.append(s.contiguous())
    return dataclasses.replace(layout, values=tuple(values),
                               scales=tuple(scales))
