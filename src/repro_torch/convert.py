"""Parameters from numpy: turn a param or mask tree given as numpy nested
dicts (for example the reference's, flattened with ``np.asarray``) into the
port's tree of tensors on ``device``.

A packed layout crosses as a dict of its leaves plus ``block``/``shape``
(``values``/``k_idx`` lists per bin, ``nnz``, ``perm``/``inv_perm`` or
None) under a ``"packed"`` key.  bf16 arrays arrive as ``ml_dtypes``
bfloat16, which ``torch.from_numpy`` rejects: they cross bit for bit as an
int16 view, recognised by ``dtype.name``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.packed import PackedLayout


def tensor_from_numpy(a, device) -> torch.Tensor:
    """One numpy array (or scalar) -> tensor, bf16 bits preserved."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.ascontiguousarray(a).copy()).to(device)


def layout_from_numpy(d, device) -> PackedLayout:
    """A packed-layout dict (see module docstring) -> ``PackedLayout``."""
    def opt(k):
        return None if d.get(k) is None else tensor_from_numpy(d[k], device)
    return PackedLayout(
        values=tuple(tensor_from_numpy(v, device) for v in d["values"]),
        k_idx=tuple(tensor_from_numpy(k, device) for k in d["k_idx"]),
        nnz=tensor_from_numpy(d["nnz"], device), perm=opt("perm"),
        inv_perm=opt("inv_perm"), block=tuple(d["block"]),
        shape=tuple(d["shape"]))


def params_from_numpy(tree, device):
    """Nested dicts of numpy arrays -> the same structure of tensors on
    ``device``, with packed-layout dicts rebuilt as ``PackedLayout``."""
    if isinstance(tree, dict):
        return {k: (layout_from_numpy(v, device) if k == "packed"
                    else params_from_numpy(v, device))
                for k, v in tree.items()}
    return tensor_from_numpy(tree, device)
