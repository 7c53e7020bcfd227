"""BCS block-sparse matmul ``y = x @ W_sparse`` — the wrapper around the
hand-written CUDA kernel ``csrc/bsr_matmul.cu``.

The kernel replaces the reference's Pallas TPU kernel ``bsr_matmul``
(``repro/kernels/bsr_matmul.py:63``/``:143``): it reads and multiplies only
the surviving weight blocks of one degree bin of a ``PackedLayout``,
accumulates in fp32, fuses bias + silu/relu into the epilogue with one
rounding, and writes each column tile straight to its ORIGINAL column
(``layout.perm``), so ``bsr_matmul_packed`` needs neither the per-bin
concat nor the un-permute gather of the reference.

The plain PyTorch version (``kernels.ref``) runs only for CPU tensors.
For a CUDA tensor the kernel launches or the call raises; nothing falls
back.  ``LAUNCHES`` counts kernel launches (CUDA only).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

LAUNCHES = {"bsr_matmul": 0}

_ACTS = {"none": 0, "silu": 1, "relu": 2}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_fn = None


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _kernel():
    """The ``bsr_matmul_launch`` C entry point, built on first use."""
    global _fn
    if _fn is None:
        f = _build.load("bsr_matmul").bsr_matmul_launch
        f.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 9
                      + [ctypes.c_void_p])
        f.restype = ctypes.c_int
        _fn = f
    return _fn


def _check_cuda(out, x, values, k_idx, cols, bias, act):
    """Everything the kernel assumes, checked before any pointer is
    passed."""
    dev = x.device
    tensors = [out, x, values, k_idx, cols] + ([bias] if bias is not None
                                               else [])
    if any(t.device != dev for t in tensors):
        raise ValueError("bsr_matmul: all tensors must be on one device, "
                         f"got {[str(t.device) for t in tensors]}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"bsr_matmul: dtype {x.dtype} not supported "
                        f"(float32, bfloat16)")
    for name, t in (("values", values), ("out", out), ("bias", bias)):
        if t is not None and t.dtype != x.dtype:
            raise TypeError(f"bsr_matmul: {name} dtype {t.dtype} != x dtype "
                            f"{x.dtype}")
    if k_idx.dtype != torch.int32 or cols.dtype != torch.int32:
        raise TypeError("bsr_matmul: k_idx and cols must be int32")
    if act not in _ACTS:
        raise ValueError(f"bsr_matmul: unknown activation {act!r}")
    M, K = x.shape
    nb, L, bk, bn = values.shape
    if x.stride(1) != 1 or out.stride(1) != 1:
        raise ValueError("bsr_matmul: x and out need unit column stride")
    if not (values.is_contiguous() and k_idx.is_contiguous()
            and cols.is_contiguous()):
        raise ValueError("bsr_matmul: values, k_idx, cols must be contiguous")
    if K % bk or tuple(k_idx.shape) != (nb, L) or tuple(cols.shape) != (nb,):
        raise ValueError(f"bsr_matmul: shapes disagree: x {tuple(x.shape)}, "
                         f"values {tuple(values.shape)}, k_idx "
                         f"{tuple(k_idx.shape)}, cols {tuple(cols.shape)}")
    if out.shape[0] != M or out.shape[1] % bn or nb > out.shape[1] // bn:
        raise ValueError(f"bsr_matmul: out {tuple(out.shape)} cannot hold "
                         f"{nb} column tiles of width {bn}")
    if bias is not None and (bias.shape != (out.shape[1],)
                             or not bias.is_contiguous()):
        raise ValueError(f"bsr_matmul: bias must be contiguous "
                         f"({out.shape[1]},), got {tuple(bias.shape)}")
    if 256 % bn or bk & (bk - 1):
        raise ValueError(f"bsr_matmul: block ({bk}, {bn}) not supported "
                         f"(bk a power of two, bn dividing 256)")


def _launch(out, x, values, k_idx, cols, bias, act):
    """One kernel launch over one degree bin: ``out[:, cols[j]*bn:
    (cols[j]+1)*bn] = act(x @ W_j + bias[...])`` for every layout column j.

    x (M, K); values (nb, L, bk, bn); k_idx (nb, L) int32; cols (nb,) int32
    original block column of each layout column; bias None or (N,) in
    ORIGINAL column order; out (M, N), written only at the bin's columns.
    """
    if x.device.type != "cuda":
        raise ValueError(f"bsr_matmul: unsupported device {x.device}")
    _check_cuda(out, x, values, k_idx, cols, bias, act)
    M, _ = x.shape
    nb, L, bk, bn = values.shape
    # launched on the calling thread's current device: a stream of another
    # device makes the launch fail, and the error code raises below
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _kernel()(x.data_ptr(), values.data_ptr(), k_idx.data_ptr(),
                    cols.data_ptr(),
                    None if bias is None else bias.data_ptr(),
                    out.data_ptr(), M, x.stride(0), nb, L, bk, bn,
                    out.stride(0), _ACTS[act], _DTYPES[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"bsr_matmul kernel launch failed: CUDA error "
                           f"{err} (M={M}, nb={nb}, L={L}, block=({bk}, "
                           f"{bn}), dtype={x.dtype})")
    LAUNCHES["bsr_matmul"] += 1
    return out


def bsr_matmul_packed(x, layout, bias=None, act="none"):
    """x (M, K) @ PackedLayout W (K, N) -> (M, N), one launch per degree
    bin.  Each bin writes its columns at their original positions, so the
    result is in original column order without a gather.  Per-column
    accumulation order is independent of the binning, so reordered and
    unreordered layouts give bit-identical results."""
    if x.shape[-1] != layout.shape[0]:
        raise ValueError(f"bsr_matmul: x has K={x.shape[-1]}, the layout "
                         f"K={layout.shape[0]}")
    if x.device.type == "cpu":
        return ref.bsr_matmul_packed_ref(x, layout, bias, act)
    out = torch.empty((x.shape[0], layout.shape[1]), dtype=x.dtype,
                      device=x.device)
    for vals_b, kidx_b, cols_b in zip(layout.values, layout.k_idx,
                                      layout.bin_cols):
        _launch(out, x, vals_b, kidx_b, cols_b, bias, act)
    return out
