"""Parameters from numpy: turn a param or mask tree given as numpy nested
dicts (for example the reference's, flattened with ``np.asarray``) into the
port's tree of tensors on ``device``.

A packed layout crosses as a dict of its leaves plus ``block``/``shape``
(``values``/``k_idx`` lists per bin, ``nnz``, ``perm``/``inv_perm`` or
None, optionally ``conv_taps``) under a ``"packed"`` key; a dict carrying
``t_idx`` is a tap layout (``values``/``t_idx``/``k_full`` lists per bin,
``nnz``, ``alive``, ``perm``/``inv_perm``, ``group``, ``shape``); either
may carry ``scales`` (a list per bin, or None), the fp32 scales of int8
values (``core.quant``), so a quantized layout crosses whole, and
``n_shards`` (absent = 0), so a tensor-parallel one does too.  bf16
arrays arrive as ``ml_dtypes`` bfloat16, which ``torch.from_numpy``
rejects: they cross bit for bit as an int16 view, recognised by
``dtype.name``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.packed import PackedLayout, TapLayout


def tensor_from_numpy(a, device) -> torch.Tensor:
    """One numpy array (or scalar) -> tensor of the same shape (a 0-d
    array stays 0-d: the mask trees' sentinels), bf16 bits preserved."""
    a = np.array(a, order="C")
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(
            device)
    return torch.from_numpy(a).to(device)


def layout_from_numpy(d, device):
    """A layout dict (see module docstring) -> ``PackedLayout``, or
    ``TapLayout`` when it carries ``t_idx``."""
    def opt(k):
        return None if d.get(k) is None else tensor_from_numpy(d[k], device)

    def bins(k):
        return tuple(tensor_from_numpy(v, device) for v in d[k])
    scales = bins("scales") if d.get("scales") is not None else None
    if "t_idx" in d:
        return TapLayout(
            values=bins("values"), t_idx=bins("t_idx"),
            k_full=bins("k_full") if d.get("k_full") is not None else None,
            nnz=tensor_from_numpy(d["nnz"], device),
            alive=tensor_from_numpy(d["alive"], device), perm=opt("perm"),
            inv_perm=opt("inv_perm"), group=int(d["group"]),
            shape=tuple(d["shape"]), scales=scales,
            n_shards=int(d.get("n_shards", 0)))
    taps = d.get("conv_taps")
    return PackedLayout(
        values=bins("values"), k_idx=bins("k_idx"),
        nnz=tensor_from_numpy(d["nnz"], device), perm=opt("perm"),
        inv_perm=opt("inv_perm"), block=tuple(d["block"]),
        shape=tuple(d["shape"]),
        conv_taps=None if taps is None else tuple(
            tuple(int(v) for v in t) for t in taps), scales=scales,
        n_shards=int(d.get("n_shards", 0)))


def params_from_numpy(tree, device):
    """Nested dicts of numpy arrays -> the same structure of tensors on
    ``device``, with packed-layout dicts rebuilt as ``PackedLayout``."""
    if isinstance(tree, dict):
        return {k: (layout_from_numpy(v, device) if k == "packed"
                    else params_from_numpy(v, device))
                for k, v in tree.items()}
    return tensor_from_numpy(tree, device)
