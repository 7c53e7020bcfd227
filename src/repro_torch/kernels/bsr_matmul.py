"""The sparse kernels of the port — wrappers around hand-written CUDA:

1. ``bsr_matmul_packed``: BCS block-sparse matmul ``y = x @ W_sparse``
   (``csrc/bsr_matmul.cu``), below;
2. ``tap_gather_conv_packed``: pattern/connectivity conv over the alive
   im2col band (``csrc/tap_gather.cu``);
3. ``bsr_conv2d_implicit``: the BCS conv, its input tile staged in shared
   memory straight from the NHWC image (``csrc/bsr_matmul.cu``,
   ``bsr_conv_kernel``); ``bsr_conv2d_patches`` runs the same kernel on
   the im2col patch matrix, read as a 1 x M image of K channels;
4. ``tap_gather_conv_implicit``: the tap-gather conv from an input tile
   staged in shared memory (``csrc/tap_gather.cu``, ``tap_conv_kernel``).

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
its outputs at their original columns like kernel 1.  Kernels 3 and 4 run
one launch per layer over all degree bins: a thread block stages a tile
of the unpadded NHWC input (the SAME halo zero-filled as it loads) in
shared memory and walks every output column of the layer against it.
``conv_plan`` chooses the tile; ``_bsr_tables`` / ``_tap_tables`` flatten
the bins into the per-column tables the kernels walk.

The plain PyTorch versions (``kernels.ref``) run only for CPU tensors.
For a CUDA tensor the kernel launches or the call raises; nothing falls
back.  ``LAUNCHES`` counts kernel launches per kernel (CUDA only).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import weakref

import torch
import torch.nn.functional as F

from repro_torch.core import bcs as BCS
from repro_torch.kernels import _build, ref

LAUNCHES = {"bsr_matmul": 0, "tap_gather_conv": 0, "bsr_conv2d_implicit": 0,
            "bsr_conv2d_materialized": 0, "tap_gather_conv_implicit": 0}

_ACTS = {"none": 0, "silu": 1, "relu": 2}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# C entry point -> (library, pointer args, int args); every entry ends
# with the stream pointer
_ENTRIES = {
    "bsr_matmul_launch": ("bsr_matmul", 6, 9),
    "bsr_conv_launch": ("bsr_matmul", 7, 6),
    "tap_gather_launch": ("tap_gather", 6, 9),
    "tap_conv_launch": ("tap_gather", 6, 4),
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


# the conv kernels' launch shape (csrc/bsr_matmul.cu, csrc/tap_gather.cu)
CONV_THREADS = 256
CONV_WARPS = CONV_THREADS // 32
SMEM_MAX = 232448          # bytes of shared memory a block may use (H100)
SMEM_SOFT = 113 * 1024     # a tile this small leaves room for two blocks
SMS = 132                  # streaming multiprocessors of an H100 SXM
TAP_SLOT_BYTES = CONV_WARPS * 32 * 8   # kernel 4's per-warp slot buffers
BCS_STAGES = 4             # kernel 3's value blocks in flight per warp


@dataclasses.dataclass(frozen=True, eq=False)
class ConvPlan:
    """One launch of a conv kernel (3: ``kind="bcs"``, 4: ``"tap"``): each
    thread block owns a tile of ``tr`` x ``tw`` output positions of one
    image and every output column of the layer.  It stages the input
    window under the tile — ``rows_in`` x ``cols_in`` pixels, the halo
    included, all ``C`` channels (no channel chunks: the tile shrinks
    instead) — in shared memory, its columns split into ``stride`` phases
    of ``nph`` (so that neighbouring outputs read neighbouring words):
    pixel-major with ``chan_ld`` floats per pixel for the BCS kernel
    (channels contiguous, vector loads), channel-major for the tap
    kernel, ``2**cg_log2`` channels side by side in a row of ``pitch``
    words and ``chan_ld`` words per plane of such a group.  Its 8
    warps are ``warps_pos`` along positions times ``8 // warps_pos``
    along columns; a lane owns ``R`` positions, ``p = lane + 32 * (wp +
    warps_pos * i)``, and a warp walks the columns ``wc, wc + 8 //
    warps_pos, ...`` of ``n_cols``.  The BCS kernel writes each lane's bn
    columns of a position from registers (``out_ld`` 0) and streams each
    warp's value blocks through a ring of ``BCS_STAGES``; the tap kernel
    gathers its results in a (tile, N) shared-memory tile of row pitch
    ``out_ld`` and writes it out row by row, and buffers each warp's slots
    (``TAP_SLOT_BYTES``).  Field order is the kernels' ``ConvTile`` up to
    ``x_floats``."""
    kind: str
    B: int
    H: int
    W: int
    C: int
    Ho: int
    Wo: int
    stride: int
    ph0: int
    pw0: int
    tr: int
    tw: int
    tiles_h: int
    tiles_w: int
    rows_in: int
    cols_in: int
    nph: int
    pitch: int
    chan_ld: int
    cg_log2: int
    R: int
    warps_pos: int
    n_cols: int
    N: int
    out_ld: int
    x_floats: int
    smem_bytes: int
    kh: int
    kw: int

    def args(self):
        """The ``ConvTile`` ints, in the kernels' field order."""
        names = [f.name for f in dataclasses.fields(self)]
        return [getattr(self, n) for n in names[1:names.index("x_floats")
                                                + 1]]

    @functools.cached_property
    def c_args(self):
        """``args()`` as the C array the launch entry points read."""
        vals = self.args()
        return (ctypes.c_int * len(vals))(*vals)

    @property
    def grid(self) -> int:
        """Thread blocks of the launch: one per tile."""
        return self.B * self.tiles_h * self.tiles_w


def _round_to(n, mod, rem):
    """The least value >= n that is ``rem`` modulo ``mod``."""
    return n + (rem - n) % mod


def _tap_row_layout(C, s, nph, tw):
    """(cg_log2, nph) of kernel 4's staged rows: 2**cg_log2 channels side
    by side, each ``s * nph`` words wide.  A warp's 32 lanes own 32
    consecutive positions, ``32 / tw`` tile rows of tw; their words differ
    by c + r * s * pitch, so when tw divides 32 a row step of s * pitch
    = tw (mod 32) puts them on 32 banks.  The narrowest such rows (fewest
    words in all) are taken; otherwise one channel a row."""
    if tw >= 32 or 32 % tw:
        return 0, nph
    best = None
    for cg in range(4):
        for n in range(nph, nph + 32):
            if (s * ((s * n) << cg)) % 32 == tw:
                words = -(-C >> cg) * ((s * n) << cg)
                if best is None or words < best[0]:
                    best = (words, cg, n)
                break
    return (0, nph) if best is None else best[1:]


@functools.lru_cache(maxsize=256)
def conv_plan(kind, x_shape, kh, kw, stride, padding, n_cols, N, bn=1,
              bk=1):
    """The tile, grid and shared-memory bytes of one conv-kernel launch.

    kind "bcs" (kernel 3; ``n_cols`` block columns of (bk, bn) blocks) or
    "tap" (kernel 4; ``n_cols`` = N filter columns); x_shape (B, H, W, C)
    the unpadded NHWC input; N the output width.  Warps go to columns
    first (up to 8), the rest to positions.  The tile spans the output
    width (halved while it does not fit) and as many rows as wastes the
    fewest lane positions over the launch (overhanging tiles and idle
    lanes alike; ties to the taller), within two blocks an SM
    (``SMEM_SOFT``), or, where that leaves lanes without a position, within
    the one-block limit ``SMEM_MAX``; a launch of fewer blocks than the
    card has SMs halves its tile while no lane idles.  Raises ValueError
    when not even one output position fits."""
    if kind not in ("bcs", "tap"):
        raise ValueError(f"conv_plan: unknown kind {kind!r}")
    B, H, W, C = (int(v) for v in x_shape)
    (ph0, _), (pw0, _), Ho, Wo = conv_geometry(H, W, kh, kw, stride,
                                              padding)
    s = stride
    wc = 1
    while wc * 2 <= min(CONV_WARPS, n_cols):
        wc *= 2
    warps_pos = CONV_WARPS // wc
    r_max = 8 if kind == "tap" else (4 if bn <= 8 else 2)
    cap = 32 * warps_pos * r_max

    def geom(tr, tw):
        rows_in = (tr - 1) * s + kh
        cols_in = (tw - 1) * s + kw
        nph = -(-cols_in // s)
        pitch = s * nph
        if kind == "bcs":
            # a pixel pitch of 4 mod 8 floats: 8 lanes' 16-byte loads at
            # neighbouring pixels hit 8 different bank quads; results go
            # straight from registers to the output (a lane's bn columns
            # of a position are one contiguous run)
            chan_ld = _round_to(C, 8, 4)
            x_floats = rows_in * pitch * chan_ld
            out_ld = 0
            cg_log2 = 0
        else:
            # 2**cg_log2 channels side by side in a staged row, so that
            # the 32 lanes' positions (tile rows of tw) hit 32 banks; an
            # odd plane per channel group; an odd out row
            cg_log2, nph = _tap_row_layout(C, s, nph, tw)
            pitch = (s * nph) << cg_log2
            chan_ld = _round_to(rows_in * pitch, 2, 1)
            x_floats = -(-C >> cg_log2) * chan_ld
            out_ld = _round_to(N, 2, 1)
        x_floats = _round_to(x_floats, 4, 0)
        smem = 4 * (x_floats + tr * tw * out_ld)
        if kind == "tap":
            smem += TAP_SLOT_BYTES
        else:
            smem += 4 * CONV_WARPS * BCS_STAGES * bk * bn
        return (rows_in, cols_in, nph, pitch, chan_ld, cg_log2, out_ld,
                x_floats, smem)

    def lanes(tr, tw):
        """R: positions a lane owns for a tr x tw tile."""
        R = 1
        while 32 * warps_pos * R < tr * tw:
            R *= 2
        return R

    def lane_slots(tr, tw):
        """Lane positions the launch spends: tiles x the lanes' capacity,
        so overhanging tiles and idle lanes both count."""
        return -(-Ho // tr) * -(-Wo // tw) * 32 * warps_pos * lanes(tr, tw)

    def fit(budget):
        tw = min(Wo, cap)
        while tw >= 1:
            best = None
            for tr in range(1, min(Ho, max(1, cap // tw)) + 1):
                if geom(tr, tw)[-1] > budget:
                    break
                key = (lane_slots(tr, tw), -tr)
                if best is None or key < best[0]:
                    best = (key, tr)
            if best is not None:
                return best[1], tw
            tw //= 2
        return None

    want = min(cap, Ho * Wo, 32 * warps_pos)
    best = fit(SMEM_SOFT)
    if best is None or best[0] * best[1] < want:
        hard = fit(SMEM_MAX)
        if hard is not None and (best is None
                                 or hard[0] * hard[1] > best[0] * best[1]):
            best = hard
    if best is None:
        raise ValueError(
            f"conv_plan: one output position of a ({kh}, {kw}) conv over "
            f"{C} channels into {N} columns needs more than {SMEM_MAX} "
            f"bytes of shared memory")
    tr, tw = best
    # fewer blocks than SMs: halve the tile while its lanes stay busy
    while lanes(tr, tw) > 1 and B * -(-Ho // tr) * -(-Wo // tw) < SMS:
        if tr > 1:
            tr = -(-tr // 2)
        else:
            tw = -(-tw // 2)
    R = lanes(tr, tw)
    (rows_in, cols_in, nph, pitch, chan_ld, cg_log2, out_ld, x_floats,
     smem) = geom(tr, tw)
    return ConvPlan(kind, B, H, W, C, Ho, Wo, s, ph0, pw0, tr, tw,
                    -(-Ho // tr), -(-Wo // tw), rows_in, cols_in, nph,
                    pitch, chan_ld, cg_log2, R, warps_pos, n_cols, N,
                    out_ld, x_floats, smem, kh, kw)


# per-layout flat tables of the conv kernels, built on first use
_TABLES: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _cached(layout, key, build):
    per = _TABLES.setdefault(layout, {})
    if key not in per:
        per[key] = build()
    return per[key]


def _column_meta(sizes, degrees, cols, width, dev):
    """(n_cols, 4) int32 (first slot, slots, original column, 0) of every
    column in layout order, bins concatenated; a bin column of ``width``
    > 1 outputs (a filter group) splits into ``width`` columns."""
    out, start = [], 0
    for n, L, c in zip(sizes, degrees, cols):
        k = torch.arange(n * width, device=dev, dtype=torch.int64)
        col = c.long().repeat_interleave(width) * width + k % width
        out.append(torch.stack([start + k * L, torch.full_like(k, L), col,
                                torch.zeros_like(k)], 1))
        start += n * width * L
    return torch.cat(out).to(torch.int32).contiguous()


def _bsr_tables(layout):
    """Kernel 3's tables, all bins flattened in layout order: values as
    fp32 (slots, bk, bn) (exact for bf16), k_idx (slots,) int32 and the
    column meta.  Cached per layout object."""
    def build():
        dev = layout.nnz.device
        vals = torch.cat([v.reshape(-1).float() for v in layout.values])
        kidx = torch.cat([k.reshape(-1) for k in layout.k_idx]).to(
            torch.int32)
        meta = _column_meta(layout.bin_sizes, layout.bin_degrees,
                            layout.bin_cols, 1, dev)
        return vals.contiguous(), kidx.contiguous(), meta
    return _cached(layout, "bcs", build)


def _tap_tables(layout, plan):
    """Kernel 4's tables for one tile geometry: (slots, 2) int32 of (the
    slot's input word in the staged tile, its value's fp32 bits) per
    output column of the layout, in slot order, and the column meta.  The
    word of k_full k (tap = k // C, (dy, dx) = divmod(tap, kw), channel ch
    = k % C) is ``(ch >> cg_log2) * chan_ld + (ch % 2**cg_log2) * s * nph
    + dy * pitch + (dx % s) * nph + dx // s``; adding a position's ``r * s
    * pitch + c`` gives its input."""
    C, kw, s, cg = plan.C, plan.kw, plan.stride, plan.cg_log2
    key = ("tap", C, kw, s, plan.chan_ld, plan.pitch, plan.nph, cg)

    def build():
        dev = layout.nnz.device
        g = layout.group
        ents = []
        for vals, kf in zip(layout.values, layout.bin_k_full()):
            G, L, _ = vals.shape
            k = kf.long()
            tap, ch = k // C, k % C
            dy, dx = tap // kw, tap % kw
            off = ((ch >> cg) * plan.chan_ld
                   + (ch & ((1 << cg) - 1)) * (s * plan.nph)
                   + dy * plan.pitch + (dx % s) * plan.nph + dx // s)
            off = off[:, None, :].expand(G, g, L).to(torch.int32)
            v = vals.float().permute(0, 2, 1).contiguous().view(torch.int32)
            ents.append(torch.stack([off, v], -1).reshape(-1, 2))
        meta = _column_meta(layout.bin_sizes, layout.bin_degrees,
                            layout.bin_cols, g, dev)
        return torch.cat(ents).contiguous(), meta
    return _cached(layout, key, build)


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
    def build():
        want = _tap_table(kh, kw, C, layout.block[0])
        if layout.conv_taps is None:
            return torch.tensor(want, dtype=torch.int32,
                                device=layout.nnz.device).reshape(-1, 3)
        if layout.conv_taps != want:
            raise ValueError(f"bsr_conv2d_implicit: the layout's conv_taps "
                             f"do not match a ({kh}, {kw}) conv over {C} "
                             f"channels")
        return layout.conv_taps_t
    return _cached(layout, ("taps", kh, kw, C), build)


def _check_conv_input(name, x, layout, bias, act):
    """What the conv kernels assume of their input, bias and layout."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"{name}: x must be a contiguous NHWC tensor on a "
                         f"16-byte boundary")
    if x.dtype not in _DTYPES:
        raise TypeError(f"{name}: dtype {x.dtype} not supported "
                        f"(float32, bfloat16)")
    tensors = list(layout.values) + ([bias] if bias is not None else [])
    if any(t.device != x.device for t in tensors):
        raise ValueError(f"{name}: the layout, bias and x must share one "
                         f"device")
    if any(t.dtype != x.dtype for t in tensors):
        raise TypeError(f"{name}: layout values and bias must have x's "
                        f"dtype {x.dtype}")
    if act not in _ACTS:
        raise ValueError(f"{name}: unknown activation {act!r}")
    if bias is not None and (bias.shape != (layout.shape[1],)
                             or not bias.is_contiguous()):
        raise ValueError(f"{name}: bias must be contiguous "
                         f"({layout.shape[1]},), got {tuple(bias.shape)}")


_CONV_BN = (4, 8, 16)


def _bsr_soffs(layout, plan, kh, kw, C):
    """Kernel 3's (slots,) int32 window offsets for one tile geometry, in
    the slot order of ``_bsr_tables``: K-block kb = tap (dy, dx, c0) of
    ``core.bcs.conv_tap_table`` sits at ``(dy * pitch + (dx % s) * nph +
    dx // s) * chan_ld + c0`` (adding a position's ``(r * s * pitch + c) *
    chan_ld`` gives its input).  Cached per layout and geometry."""
    s = plan.stride
    key = ("soff", kh, kw, C, s, plan.pitch, plan.nph, plan.chan_ld)

    def build():
        kidx = _bsr_tables(layout)[1]
        tab = torch.tensor(_tap_table(kh, kw, C, layout.block[0]),
                           dtype=torch.int64, device=kidx.device)
        dy, dx, c0 = tab.reshape(-1, 3).unbind(1)
        toff = ((dy * plan.pitch + (dx % s) * plan.nph + dx // s)
                * plan.chan_ld + c0)
        return toff[kidx.long()].to(torch.int32).contiguous()
    return _cached(layout, key, build)


def _bsr_conv(x, layout, plan, taps_of, bias, act, key):
    """One launch of kernel 3 over every bin of ``layout``: x is the
    (B, H, W, C) image ``plan`` tiles, ``taps_of`` = (kh, kw, C) of the tap
    table its K-blocks read; returns (B*Ho*Wo, N)."""
    bk, bn = layout.block
    if bk % 4 or bn not in _CONV_BN:
        raise ValueError(f"{key}: block ({bk}, {bn}) not supported by the "
                         f"conv kernel (bk a multiple of 4, bn in "
                         f"{_CONV_BN})")
    if sum(layout.bin_sizes) * bn != layout.shape[1]:
        raise ValueError(f"{key}: the bins cover {sum(layout.bin_sizes)} "
                         f"of {layout.shape[1] // bn} block columns")
    vals, _, meta = _bsr_tables(layout)
    soffs = _bsr_soffs(layout, plan, *taps_of)
    out = torch.empty((plan.B * plan.Ho * plan.Wo, plan.N), dtype=x.dtype,
                      device=x.device)
    err = _kernel("bsr_conv_launch")(
        x.data_ptr(), vals.data_ptr(), soffs.data_ptr(), meta.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(),
        ctypes.addressof(plan.c_args), out.stride(0), _ACTS[act],
        _DTYPES[x.dtype], bk, bn, plan.smem_bytes, _stream(x))
    _raise_on(err, key, f"x {tuple(x.shape)}, block ({bk}, {bn}), tile "
                        f"{plan.tr}x{plan.tw}, R={plan.R}, smem "
                        f"{plan.smem_bytes}, dtype={x.dtype}")
    LAUNCHES[key] += 1
    return out


def bsr_conv2d_implicit(x, layout, *, kh, kw, stride=1, padding="SAME",
                        bias=None, act="none"):
    """x (B, H, W, C) * im2col-lowered PackedLayout -> (B, Ho, Wo, N)
    without the patch tensor: one launch over all degree bins, each block
    staging an input tile (halo zero-filled) and reading K-block kb at
    the layout's ``conv_taps[kb]``.  Bit-identical to
    ``bsr_conv2d_patches`` over ``ops.im2col`` patches."""
    B, H, W, C = x.shape
    if layout.shape[0] != kh * kw * C:
        raise ValueError(f"bsr_conv2d_implicit: layout K={layout.shape[0]} "
                         f"!= kh*kw*Cin={kh * kw * C}")
    bk, bn = layout.block
    if C % bk:
        raise ValueError(f"bsr_conv2d_implicit: bk={bk} must divide "
                         f"Cin={C} (K-blocks must not straddle taps)")
    N = layout.shape[1]
    if x.device.type == "cpu":
        xp, (Ho, Wo) = pad_image(x, kh, kw, stride, padding)
        taps = _conv_taps(layout, kh, kw, C)
        y = ref.bsr_conv2d_implicit_ref(xp, layout, taps, (Ho, Wo, stride),
                                        bias, act)
        return y.reshape(B, Ho, Wo, N)
    _check_conv_input("bsr_conv2d_implicit", x, layout, bias, act)
    _conv_taps(layout, kh, kw, C)        # the layout's taps are this conv's
    plan = conv_plan("bcs", x.shape, kh, kw, stride, padding, layout.Nb, N,
                     bn, bk)
    y = _bsr_conv(x, layout, plan, (kh, kw, C), bias, act,
                  "bsr_conv2d_implicit")
    return y.reshape(B, plan.Ho, plan.Wo, N)


def bsr_conv2d_patches(x, layout, bias=None, act="none"):
    """x (M, K) im2col patch rows @ im2col-lowered PackedLayout -> (M, N):
    the materialized BCS conv.  On the card it runs kernel 3 with the
    patch matrix read as a 1 x M image of K channels (taps (0, 0, kb*bk)),
    so every output is the same FMA chain as in ``bsr_conv2d_implicit``
    and the two modes agree bitwise.  One launch over all bins."""
    M, K = x.shape
    if K != layout.shape[0]:
        raise ValueError(f"bsr_conv2d_patches: x has K={K}, the layout "
                         f"K={layout.shape[0]}")
    if x.device.type == "cpu":
        return ref.bsr_matmul_packed_ref(x, layout, bias, act)
    _check_conv_input("bsr_conv2d_patches", x, layout, bias, act)
    bk, bn = layout.block
    plan = conv_plan("bcs", (1, 1, M, K), 1, 1, 1, "VALID", layout.Nb,
                     layout.shape[1], bn, bk)
    return _bsr_conv(x, layout, plan, (1, 1, K), bias, act,
                     "bsr_conv2d_materialized")


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
    tensor nor the alive band: one launch over all degree bins, each block
    staging an input tile (halo zero-filled) and walking every filter's
    slots against it, a slot's input word taken from its ``k_full`` row
    (tap = k // C, (dy, dx) = divmod(tap, kw), channel = k % C)."""
    B, H, W, C = x.shape
    if layout.shape[0] != kh * kw * C:
        raise ValueError(f"tap_gather_conv_implicit: layout "
                         f"K={layout.shape[0]} != kh*kw*Cin={kh * kw * C}")
    P = layout.shape[1]
    if x.device.type == "cpu":
        xp, (Ho, Wo) = pad_image(x, kh, kw, stride, padding)
        y = ref.tap_gather_implicit_ref(xp, layout, kw, (Ho, Wo, stride),
                                        bias, act)
        return y.reshape(B, Ho, Wo, P)
    name = "tap_gather_conv_implicit"
    _check_conv_input(name, x, layout, bias, act)
    if sum(layout.bin_sizes) * layout.group != P:
        raise ValueError(f"{name}: the bins cover {sum(layout.bin_sizes)} "
                         f"of {layout.n_groups} filter groups")
    plan = conv_plan("tap", x.shape, kh, kw, stride, padding, P, P)
    slots, meta = _tap_tables(layout, plan)
    out = torch.empty((B * plan.Ho * plan.Wo, P), dtype=x.dtype,
                      device=x.device)
    err = _kernel("tap_conv_launch")(
        x.data_ptr(), slots.data_ptr(), meta.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(),
        ctypes.addressof(plan.c_args), out.stride(0), _ACTS[act],
        _DTYPES[x.dtype],
        plan.smem_bytes, _stream(x))
    _raise_on(err, name, f"x {tuple(x.shape)}, tile {plan.tr}x{plan.tw}, "
                         f"R={plan.R}, smem {plan.smem_bytes}, "
                         f"dtype={x.dtype}")
    LAUNCHES[name] += 1
    return out.reshape(B, plan.Ho, plan.Wo, P)
