"""The sparse kernels of the port — wrappers around hand-written CUDA:

1. ``bsr_matmul_packed``: BCS block-sparse matmul ``y = x @ W_sparse``
   (``csrc/bsr_matmul.cu``), below;
2. ``tap_gather_conv_packed``: pattern/connectivity conv over the alive
   im2col band (``csrc/tap_gather.cu``);
3. ``bsr_conv2d_implicit``: kernel 1 gathering its x rows straight from the
   padded image (``csrc/bsr_matmul.cu``);
4. ``tap_gather_conv_implicit``: kernel 2 gathering straight from the
   padded image (``csrc/tap_gather.cu``).

Kernel 1 in detail:

The kernel replaces the reference's Pallas TPU kernel ``bsr_matmul``
(``repro/kernels/bsr_matmul.py:63``/``:143``): it reads and multiplies only
the surviving weight blocks of one degree bin of a ``PackedLayout``,
accumulates in fp32, fuses bias + silu/relu into the epilogue with one
rounding, and writes each column tile straight to its ORIGINAL column
(``layout.perm``), so ``bsr_matmul_packed`` needs neither the per-bin
concat nor the un-permute gather of the reference.

Kernels 2-4 replace the reference's ``tap_gather_conv`` (:314),
``_conv_implicit_bin`` (:483) and ``_tap_implicit_bin`` (:613); each writes
its outputs at their original columns like kernel 1.  The implicit kernels
take the padded NHWC image (the halo is an ``F.pad`` here, as in the
reference) and never build the patch tensor; their output rows are the
output positions in (b, ho, wo) order.

The plain PyTorch versions (``kernels.ref``) run only for CPU tensors.
For a CUDA tensor the kernel launches or the call raises; nothing falls
back.  ``LAUNCHES`` counts kernel launches per kernel (CUDA only).
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from repro_torch.core import bcs as BCS
from repro_torch.kernels import _build, ref

LAUNCHES = {"bsr_matmul": 0, "tap_gather_conv": 0, "bsr_conv2d_implicit": 0,
            "tap_gather_conv_implicit": 0}

_ACTS = {"none": 0, "silu": 1, "relu": 2}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# C entry point -> (library, pointer args, int args); every entry ends
# with the stream pointer
_ENTRIES = {
    "bsr_matmul_launch": ("bsr_matmul", 6, 9),
    "bsr_conv2d_implicit_launch": ("bsr_matmul", 7, 14),
    "tap_gather_launch": ("tap_gather", 6, 9),
    "tap_gather_implicit_launch": ("tap_gather", 6, 14),
}
_fns: dict = {}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _kernel(entry="bsr_matmul_launch"):
    """A C entry point of the kernel libraries, built on first use."""
    f = _fns.get(entry)
    if f is None:
        lib, n_ptr, n_int = _ENTRIES[entry]
        f = getattr(_build.load(lib), entry)
        f.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                      + [ctypes.c_void_p])
        f.restype = ctypes.c_int
        _fns[entry] = f
    return f


def _same_pads(size, k, s):
    """XLA 'SAME' padding for one spatial dim: output ceil(size / s), the
    padding split ``pad // 2`` low and the rest high."""
    out = -(-size // s)
    pad = max((out - 1) * s + k - size, 0)
    return pad // 2, pad - pad // 2


def conv_geometry(H, W, kh, kw, stride=1, padding="SAME"):
    """Conv output/padding geometry shared by ``ops.im2col`` and the
    implicit kernels: ((ph0, ph1), (pw0, pw1), Ho, Wo)."""
    if padding == "SAME":
        ph, pw = _same_pads(H, kh, stride), _same_pads(W, kw, stride)
    elif padding == "VALID":
        ph = pw = (0, 0)
    else:
        raise ValueError(padding)
    Ho = (H + ph[0] + ph[1] - kh) // stride + 1
    Wo = (W + pw[0] + pw[1] - kw) // stride + 1
    if Ho < 1 or Wo < 1:
        raise ValueError(
            f"kernel ({kh}, {kw}) does not fit the ({H}, {W}) feature map "
            f"under {padding} padding (output would be {Ho}x{Wo})")
    return ph, pw, Ho, Wo


def pad_image(x, kh, kw, stride=1, padding="SAME"):
    """x (B, H, W, C) -> (padded image (B, Hp, Wp, C), (Ho, Wo)): the
    halo the implicit kernels read, with XLA's asymmetric SAME split."""
    _, H, W, _ = x.shape
    ph, pw, Ho, Wo = conv_geometry(H, W, kh, kw, stride, padding)
    return F.pad(x, (0, 0, pw[0], pw[1], ph[0], ph[1])).contiguous(), (Ho,
                                                                        Wo)


def _stream(t):
    # launched on the calling thread's current device: a stream of another
    # device makes the launch fail, and the error code raises
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_common(name, out, x, values, idx, cols, bias, act):
    """The checks every kernel shares: one device, dtypes, contiguity of
    the per-bin leaves and the bias."""
    tensors = [out, x, values, idx, cols] + ([bias] if bias is not None
                                             else [])
    if any(t.device != x.device for t in tensors):
        raise ValueError(f"{name}: all tensors must be on one device, "
                         f"got {[str(t.device) for t in tensors]}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"{name}: dtype {x.dtype} not supported "
                        f"(float32, bfloat16)")
    for label, t in (("values", values), ("out", out), ("bias", bias)):
        if t is not None and t.dtype != x.dtype:
            raise TypeError(f"{name}: {label} dtype {t.dtype} != x dtype "
                            f"{x.dtype}")
    if idx.dtype != torch.int32 or cols.dtype != torch.int32:
        raise TypeError(f"{name}: index tables and cols must be int32")
    if act not in _ACTS:
        raise ValueError(f"{name}: unknown activation {act!r}")
    if not (values.is_contiguous() and idx.is_contiguous()
            and cols.is_contiguous() and out.stride(1) == 1):
        raise ValueError(f"{name}: values, index tables and cols must be "
                         f"contiguous, out needs unit column stride")
    if bias is not None and (bias.shape != (out.shape[1],)
                             or not bias.is_contiguous()):
        raise ValueError(f"{name}: bias must be contiguous "
                         f"({out.shape[1]},), got {tuple(bias.shape)}")


def _raise_on(err, name, detail):
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} "
                           f"({detail})")


def _check_bsr(name, out, x, values, k_idx, cols, bias, act):
    """Everything the BCS kernels assume, checked before any pointer is
    passed (x is the (M, K) matrix or the padded image)."""
    _check_common(name, out, x, values, k_idx, cols, bias, act)
    nb, L, bk, bn = values.shape
    if tuple(k_idx.shape) != (nb, L) or tuple(cols.shape) != (nb,):
        raise ValueError(f"{name}: shapes disagree: values "
                         f"{tuple(values.shape)}, k_idx "
                         f"{tuple(k_idx.shape)}, cols {tuple(cols.shape)}")
    if out.shape[1] % bn or nb > out.shape[1] // bn:
        raise ValueError(f"{name}: out {tuple(out.shape)} cannot hold "
                         f"{nb} column tiles of width {bn}")
    if 256 % bn or bk & (bk - 1):
        raise ValueError(f"{name}: block ({bk}, {bn}) not supported "
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
    _check_bsr("bsr_matmul", out, x, values, k_idx, cols, bias, act)
    M, K = x.shape
    nb, L, bk, bn = values.shape
    if x.stride(1) != 1:
        raise ValueError("bsr_matmul: x needs unit column stride")
    if K % bk or out.shape[0] != M:
        raise ValueError(f"bsr_matmul: x {tuple(x.shape)}, out "
                         f"{tuple(out.shape)} and block ({bk}, {bn}) "
                         f"disagree")
    err = _kernel()(x.data_ptr(), values.data_ptr(), k_idx.data_ptr(),
                    cols.data_ptr(),
                    None if bias is None else bias.data_ptr(),
                    out.data_ptr(), M, x.stride(0), nb, L, bk, bn,
                    out.stride(0), _ACTS[act], _DTYPES[x.dtype], _stream(x))
    _raise_on(err, "bsr_matmul", f"M={M}, nb={nb}, L={L}, block=({bk}, "
                                 f"{bn}), dtype={x.dtype}")
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


@functools.lru_cache(maxsize=64)
def _tap_table(kh, kw, C, bk):
    return BCS.conv_tap_table(kh, kw, C, bk)


def _conv_taps(layout, kh, kw, C):
    """The layout's (Kb, 3) int32 tap table on its device, checked against
    the conv geometry (the kernel reads the image at these offsets);
    derived from the geometry for a layout packed without ``conv_taps``."""
    want = _tap_table(kh, kw, C, layout.block[0])
    if layout.conv_taps is None:
        return torch.tensor(want, dtype=torch.int32,
                            device=layout.nnz.device).reshape(-1, 3)
    if layout.conv_taps != want:
        raise ValueError(f"bsr_conv2d_implicit: the layout's conv_taps do "
                         f"not match a ({kh}, {kw}) conv over {C} channels")
    return layout.conv_taps_t


def bsr_conv2d_implicit(x, layout, *, kh, kw, stride=1, padding="SAME",
                        bias=None, act="none"):
    """x (B, H, W, C) * im2col-lowered PackedLayout -> (B, Ho, Wo, N)
    without the patch tensor: one launch per degree bin, each gathering
    its x rows from the padded image through the layout's ``conv_taps``.
    Bit-identical to ``bsr_matmul_packed`` over ``ops.im2col`` patches."""
    B, H, W, C = x.shape
    if layout.shape[0] != kh * kw * C:
        raise ValueError(f"bsr_conv2d_implicit: layout K={layout.shape[0]} "
                         f"!= kh*kw*Cin={kh * kw * C}")
    bk, bn = layout.block
    if C % bk:
        raise ValueError(f"bsr_conv2d_implicit: bk={bk} must divide "
                         f"Cin={C} (K-blocks must not straddle taps)")
    xp, (Ho, Wo) = pad_image(x, kh, kw, stride, padding)
    taps = _conv_taps(layout, kh, kw, C)
    N = layout.shape[1]
    if x.device.type == "cpu":
        y = ref.bsr_conv2d_implicit_ref(xp, layout, taps, (Ho, Wo, stride),
                                        bias, act)
        return y.reshape(B, Ho, Wo, N)
    if x.device.type != "cuda":
        raise ValueError(f"bsr_conv2d_implicit: unsupported device "
                         f"{x.device}")
    if taps.device != x.device:
        raise ValueError(f"bsr_conv2d_implicit: conv_taps on {taps.device}"
                         f", x on {x.device}")
    M = B * Ho * Wo
    _, Hp, Wp, _ = xp.shape
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    for vals, kidx, cols in zip(layout.values, layout.k_idx,
                                layout.bin_cols):
        _check_bsr("bsr_conv2d_implicit", out, xp, vals, kidx, cols, bias,
                   act)
        nb, L, _, _ = vals.shape
        err = _kernel("bsr_conv2d_implicit_launch")(
            xp.data_ptr(), vals.data_ptr(), kidx.data_ptr(), cols.data_ptr(),
            taps.data_ptr(), None if bias is None else bias.data_ptr(),
            out.data_ptr(), M, nb, L, bk, bn, out.stride(0), _ACTS[act],
            _DTYPES[x.dtype], C, Wp, Hp * Wp, Ho, Wo, stride, _stream(x))
        _raise_on(err, "bsr_conv2d_implicit",
                  f"x {tuple(x.shape)}, nb={nb}, L={L}, block=({bk}, {bn}), "
                  f"stride={stride}, dtype={x.dtype}")
        LAUNCHES["bsr_conv2d_implicit"] += 1
    return out.reshape(B, Ho, Wo, N)


def _check_tap(name, out, x, values, slots, cols, bias, act, group):
    _check_common(name, out, x, values, slots, cols, bias, act)
    ng, L, gp = values.shape
    if gp != group or tuple(slots.shape) != (ng, L) or \
            tuple(cols.shape) != (ng,):
        raise ValueError(f"{name}: shapes disagree: values "
                         f"{tuple(values.shape)}, slots "
                         f"{tuple(slots.shape)}, cols {tuple(cols.shape)}, "
                         f"group {group}")
    if out.shape[1] % group or ng > out.shape[1] // group:
        raise ValueError(f"{name}: out {tuple(out.shape)} cannot hold {ng} "
                         f"groups of {group} filters")


def tap_gather_conv_packed(x, layout, bias=None, act="none"):
    """x (M, R) alive im2col band @ TapLayout -> (M, P), original filter
    order: one launch per degree bin, each filter group contracting only
    its own surviving taps (slot order), written at its original columns.
    Bit-identical across bin counts and to the implicit mode."""
    if x.shape[-1] != layout.n_alive:
        raise ValueError(f"tap_gather_conv: x has {x.shape[-1]} band "
                         f"columns, the layout {layout.n_alive} alive rows")
    if x.device.type == "cpu":
        return ref.tap_gather_packed_ref(x, layout, bias, act)
    if x.device.type != "cuda":
        raise ValueError(f"tap_gather_conv: unsupported device {x.device}")
    if x.stride(1) != 1:
        raise ValueError("tap_gather_conv: x needs unit column stride")
    M, R = x.shape
    out = torch.empty((M, layout.shape[1]), dtype=x.dtype, device=x.device)
    for vals, tidx, cols in zip(layout.values, layout.t_idx,
                                layout.bin_cols):
        _check_tap("tap_gather_conv", out, x, vals, tidx, cols, bias, act,
                   layout.group)
        ng, L, _ = vals.shape
        err = _kernel("tap_gather_launch")(
            x.data_ptr(), vals.data_ptr(), tidx.data_ptr(), cols.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(), M,
            x.stride(0), R, ng, L, layout.group, out.stride(0), _ACTS[act],
            _DTYPES[x.dtype], _stream(x))
        _raise_on(err, "tap_gather_conv", f"M={M}, R={R}, groups={ng}, "
                                          f"L={L}, dtype={x.dtype}")
        LAUNCHES["tap_gather_conv"] += 1
    return out


def tap_gather_conv_implicit(x, layout, *, kh, kw, stride=1, padding="SAME",
                             bias=None, act="none"):
    """x (B, H, W, C) * TapLayout -> (B, Ho, Wo, P) with neither the patch
    tensor nor the alive band: one launch per degree bin, each slot's
    input offset derived in the kernel from its ``k_full`` row
    (tap = k // C, (dy, dx) = divmod(tap, kw), channel = k % C)."""
    B, H, W, C = x.shape
    if layout.shape[0] != kh * kw * C:
        raise ValueError(f"tap_gather_conv_implicit: layout "
                         f"K={layout.shape[0]} != kh*kw*Cin={kh * kw * C}")
    xp, (Ho, Wo) = pad_image(x, kh, kw, stride, padding)
    P = layout.shape[1]
    if x.device.type == "cpu":
        y = ref.tap_gather_implicit_ref(xp, layout, kw, (Ho, Wo, stride),
                                        bias, act)
        return y.reshape(B, Ho, Wo, P)
    if x.device.type != "cuda":
        raise ValueError(f"tap_gather_conv_implicit: unsupported device "
                         f"{x.device}")
    M = B * Ho * Wo
    _, Hp, Wp, _ = xp.shape
    out = torch.empty((M, P), dtype=x.dtype, device=x.device)
    for vals, kf, cols in zip(layout.values, layout.bin_k_full(),
                              layout.bin_cols):
        _check_tap("tap_gather_conv_implicit", out, xp, vals, kf, cols,
                   bias, act, layout.group)
        ng, L, _ = vals.shape
        err = _kernel("tap_gather_implicit_launch")(
            xp.data_ptr(), vals.data_ptr(), kf.data_ptr(), cols.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(), M, ng,
            L, layout.group, out.stride(0), _ACTS[act], _DTYPES[x.dtype], C,
            kw, Wp, Hp * Wp, Ho, Wo, stride, _stream(x))
        _raise_on(err, "tap_gather_conv_implicit",
                  f"x {tuple(x.shape)}, groups={ng}, L={L}, "
                  f"stride={stride}, dtype={x.dtype}")
        LAUNCHES["tap_gather_conv_implicit"] += 1
    return out.reshape(B, Ho, Wo, P)
