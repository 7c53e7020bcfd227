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
the surviving weight blocks of a ``PackedLayout``, every degree bin in one
launch, accumulates in fp32 (bf16 on the tensor cores, ``mma.sync``),
fuses bias + silu/relu into the epilogue with one rounding, and writes
each column tile straight to its ORIGINAL column (``layout.perm``), so
``bsr_matmul_packed`` needs neither the per-bin concat nor the un-permute
gather of the reference.  ``bsr_plan`` decides the launch from the shapes
(path, M tile, warps, chunk of slots, shared memory); ``_bsr_bins`` lays
out the bins' descriptor table the kernel takes as an argument.  An MoE
expert stack (a layout whose leaves carry a leading expert axis E, x
(E, M, K)) runs in the same single launch, the expert on the grid's y
dimension (the reference vmaps its kernel over experts,
``repro/kernels/ops.py:437``).

``bsr_matmul`` and ``tap_gather_conv`` are the reference's raw entries
of kernels 1 and 2 (one uniform bin of raw tensors, as
``core.bcs.pad_to_uniform_csc`` gives them); on the card each runs its
kernel over the tensors as a one-bin layout, counted under its own
``LAUNCHES`` key.  Every kernel 1 and 2 wrapper takes ``out_dtype``.

Kernels 2-4 replace the reference's ``tap_gather_conv`` (:314),
``_conv_implicit_bin`` (:483) and ``_tap_implicit_bin`` (:613); each writes
its outputs at their original columns like kernel 1, in one launch per
layer over all degree bins: a thread block stages a tile of its input
(the unpadded NHWC image, the SAME halo zero-filled as it loads; or the
im2col patch matrix / alive band read as a 1 x M image) in shared memory
and walks every output column of the layer against it.  Kernel 2 is
kernel 4 run over the alive band.  ``conv_plan`` chooses the tile;
``_bsr_tables`` / ``_tap_tables`` flatten the bins into the per-column
tables the kernels walk.

Tensor-parallel layouts (``n_shards`` > 0) run through the shard
wrappers ``bsr_matmul_sharded`` and ``tap_gather_conv_sharded`` (the
reference's ``_sharded_launch`` :238, ``bsr_matmul_sharded`` :268 and
``tap_gather_conv_sharded`` :412, which vmap a launch over the shard axis
and merge the shards with one gather).  Kernels 1 and 2 already write each
column at its original position, so on one card a sharded layout needs no
merge: its shard axis is folded into each bin's columns
(``layout.folded``), and one launch of the same kernel covers every shard
and bin with x (or the alive band) read by all of them.

Int8 layouts (``core.quant``: int8 values, fp32 scales per block or
tap slot, or per output column) run through the same four kernels under
a bf16 or fp32 x: each kernel reads the int8 values (kernel 1 straight
from the layout; kernels 2-4 through their tables) and the scales, and
dequantizes ``q * s`` on the card before its fp32-accumulated products,
in the same launch; no dequantized copy of a weight is ever made.

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
from repro_torch.core.packed import PackedLayout, TapLayout
from repro_torch.distributed import sharding as SH
from repro_torch.kernels import _build, ref

LAUNCHES = {"bsr_matmul": 0, "tap_gather_conv": 0, "bsr_conv2d_implicit": 0,
            "bsr_conv2d_materialized": 0, "tap_gather_conv_implicit": 0,
            "bsr_matmul_sharded": 0, "tap_gather_conv_sharded": 0,
            "bsr_matmul_raw": 0, "tap_gather_conv_raw": 0}

_ACTS = {"none": 0, "silu": 1, "relu": 2}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the values, passed as ``quant`` to every C entry point: float (x's
# dtype), or int8 with a scale per stored block / tap slot ("block") or
# per output column ("out")
_QUANT = {None: 0, "block": 1, "out": 2}
# C entry point -> (library, pointer args, int args); every entry ends
# with the stream pointer
_ENTRIES = {
    "bsr_matmul_launch": ("bsr_matmul", 7, 14),
    "bsr_conv_launch": ("bsr_matmul", 8, 8),
    "tap_conv_launch": ("tap_gather", 6, 6),
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
BCS_STAGES = 4             # kernel 3's value pieces in flight per warp
BCS_PIECE = 512            # kernel 3: most values of one staged piece
BCS_REG_COLS = 16          # kernel 3: most block columns a lane holds


def conv_piece(bk, bn):
    """(sb, kp) of kernel 3 for (bk, bn) blocks: a lane holds ``sb`` =
    min(bn, 16) columns (a wider block column is walked as bn / sb
    subcolumns, each its own work item), and a warp stages the values of
    one slot ``kp`` rows at a time: the block's bk rows halved while a
    (kp, sb) piece holds more than ``BCS_PIECE`` values (and kp stays a
    multiple of 4)."""
    sb = min(bn, BCS_REG_COLS)
    kp = bk
    while kp * sb > BCS_PIECE and kp % 8 == 0:
        kp //= 2
    return sb, kp


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

    kind "bcs" (kernel 3; ``n_cols`` block columns of (bk, bn) blocks,
    walked as ``conv_piece``'s subcolumns: the plan's ``n_cols`` counts
    those) or "tap" (kernel 4; ``n_cols`` = N filter columns); x_shape
    (B, H, W, C) the unpadded NHWC input; N the output width.  Warps go to
    columns first (up to 8), the rest to positions.  The tile spans the output
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
    if kind == "bcs":
        sb, kp = conv_piece(bk, bn)
        n_cols *= bn // sb
    wc = 1
    while wc * 2 <= min(CONV_WARPS, n_cols):
        wc *= 2
    warps_pos = CONV_WARPS // wc
    r_max = 8 if kind == "tap" else (4 if sb <= 8 else 2)
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
            smem += 4 * CONV_WARPS * BCS_STAGES * kp * sb
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
    """Kernel 3's tables, all bins flattened in layout order: values
    (slots, bk, bn) as fp32 (exact for bf16), or as the layout's int8,
    k_idx (slots,) int32 and the column meta.  Cached per layout
    object."""
    def build():
        dev = layout.nnz.device
        q = layout.scales is not None
        vals = torch.cat([v.reshape(-1) if q else v.reshape(-1).float()
                          for v in layout.values])
        kidx = torch.cat([k.reshape(-1) for k in layout.k_idx]).to(
            torch.int32)
        meta = _column_meta(layout.bin_sizes, layout.bin_degrees,
                            layout.bin_cols, 1, dev)
        return vals.contiguous(), kidx.contiguous(), meta
    return _cached(layout, "bcs", build)


def _bsr_scales(layout):
    """Kernel 3's (slots,) fp32 scale of every slot of an int8 layout, in
    the slot order of ``_bsr_tables`` (a column's "out" scale repeated
    over its slots), or None for a float layout.  Cached per layout."""
    def build():
        if layout.scales is None:
            return None
        return torch.cat([
            (sc if sc.ndim == 2 else sc[:, None].expand(-1, L)).reshape(-1)
            for sc, L in zip(layout.scales, layout.bin_degrees)
        ]).float().contiguous()
    return _cached(layout, "bcs_scales", build)


# kernel 4's packed int8 slot: the input word in the low 16 bits, q above
TAP_WORD_BITS = 16


def _tap_tables(layout, plan, band=False):
    """Kernel 4's tables for one tile geometry: (slots, 2) int32 of (the
    slot's input word in the staged tile, its value's fp32 bits) per
    output column of the layout, in slot order, and the column meta; on
    an int8 layout (word + q * 2**16, the slot's fp32 scale bits), q in
    [-127, 127] and the word below 2**16.  The word of input row k (tap
    = k // C, (dy, dx) = divmod(tap, kw), channel ch = k % C) is ``(ch >>
    cg_log2) * chan_ld + (ch % 2**cg_log2) * s * nph + dy * pitch + (dx %
    s) * nph + dx // s``; adding a position's ``r * s * pitch + c`` gives
    its input.  k is the slot's ``k_full`` row of
    the image's im2col band, or with ``band`` its ``t_idx`` row of the
    alive band (a 1 x 1 conv over its ``n_alive`` channels: kernel 2)."""
    C, kw, s, cg = plan.C, plan.kw, plan.stride, plan.cg_log2
    key = ("tap", band, C, kw, s, plan.chan_ld, plan.pitch, plan.nph, cg)

    def build():
        dev = layout.nnz.device
        g = layout.group
        if (layout.scales is not None
                and plan.x_floats > 1 << TAP_WORD_BITS):
            raise ValueError(f"tap_gather_conv: an int8 slot addresses "
                             f"{1 << TAP_WORD_BITS} staged words, the tile "
                             f"stages {plan.x_floats}")
        ents = []
        rows = layout.t_idx if band else layout.bin_k_full()
        for vals, kf, sc in zip(layout.values, rows, layout.bin_scales()):
            G, L, _ = vals.shape
            k = kf.long()
            tap, ch = k // C, k % C
            dy, dx = tap // kw, tap % kw
            off = ((ch >> cg) * plan.chan_ld
                   + (ch & ((1 << cg) - 1)) * (s * plan.nph)
                   + dy * plan.pitch + (dx % s) * plan.nph + dx // s)
            off = off[:, None, :].expand(G, g, L)
            if sc is None:
                v = vals.float().permute(0, 2, 1)
            else:
                off = off + (vals.permute(0, 2, 1).long()
                             << TAP_WORD_BITS)
                v = (sc[:, None, :].expand(G, g, L) if sc.ndim == 2
                     else sc.permute(0, 2, 1).expand(G, g, L))
            v = v.float().contiguous().view(torch.int32)
            ents.append(torch.stack([off.to(torch.int32), v],
                                    -1).reshape(-1, 2))
        meta = _column_meta(layout.bin_sizes, layout.bin_degrees,
                            layout.bin_cols, g, dev)
        return torch.cat(ents).contiguous(), meta
    return _cached(layout, key, build)


def _stream(t):
    # launched on the calling thread's current device: a stream of another
    # device makes the launch fail, and the error code raises
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(err, name, detail):
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} "
                           f"({detail})")


# kernel 1's launch shape (csrc/bsr_matmul.cu)
BSR_WARPS = 4                # warps of a block (128 threads)
BSR_UNITS = (2, 1)           # units (slot pieces) a warp group moves a step
BSR_STAGES = (4, 3, 2)       # cp.async ring depths (steps in flight + 1)
BSR_CHUNK = 64               # slots of a chunk unless the card needs more
BSR_SMEM_TARGET = SMEM_MAX // 3   # leaves room for 3 blocks an SM
BSR_MAX_BINS = 16            # bins of one launch's descriptor table
BSR_TARGET_BLOCKS = 4 * SMS  # blocks a launch aims at (density unknown)


def _odd16(nbytes):
    """Bytes of a staged row of ``nbytes``: whole 16-byte units, an odd
    number of them, so 8 rows read at once (ldmatrix) hit 8 bank quads."""
    u = -(-nbytes // 16)
    return 16 * (u + 1 - u % 2)


@dataclasses.dataclass(frozen=True)
class BsrPlan:
    """One launch of kernel 1, from the shapes alone (never from a bin's
    degree or the bin count).  A thread block of 4 warps owns one work
    item: a layout column, a sub-column of ``NW`` of its ``bn`` outputs,
    an M tile of ``MT = 16 * FM * WM`` rows (``mtiles`` of them) and a
    chunk of ``S`` of the column's slots.  Warp w is (w % WM, w // WM): it
    owns ``16 * FM`` rows of the tile and a sub-chunk of ``SW = S // WK``
    slots (``WK = 4 // WM`` warp groups).  A pipeline step takes, for each
    group, ``U`` units, each one slot's ``KS``-deep piece: the gathered x
    tile (MT rows of ``xp`` elements in shared memory) and the value piece
    (KS rows of ``vp``), through a ring of ``stages``.  ``mma``: bf16 on
    the tensor cores; otherwise fp32 FMAs on CUDA cores (FM = 1).  ``E``
    experts run side by side (grid y).  ``ves``: bytes of a stored value
    (1 for int8 values, whose chunk's scales are staged beside its
    k_idx).  Field order up to ``smem`` is the kernel's ``BsrShape``."""
    M: int
    bk: int
    bn: int
    mma: int
    MT: int
    FM: int
    WM: int
    NW: int
    KS: int
    S: int
    SW: int
    subcols: int
    mtiles: int
    xp: int
    vp: int
    U: int
    stages: int
    smem: int
    WK: int
    K: int
    N: int
    dtype: torch.dtype
    E: int = 1
    ves: int = 4

    def args(self):
        """The ``BsrShape`` ints, in the kernel's field order."""
        names = [f.name for f in dataclasses.fields(self)]
        return [getattr(self, n) for n in names[:names.index("smem") + 1]]

    @functools.cached_property
    def c_args(self):
        vals = self.args()
        return (ctypes.c_int * len(vals))(*vals)

    def chunks(self, L):
        """Chunks of a column of ``L`` slots."""
        return -(-L // self.S)


@functools.lru_cache(maxsize=256)
def bsr_plan(M, K, N, dtype, bk, bn, E=1, ves=None):
    """Kernel 1's launch for x (M, K) @ a (K, N) layout of (bk, bn) blocks,
    or for ``E`` such products of an expert stack side by side; ``ves``
    bytes a stored value (None: x's; 1: int8 values with scales).

    Path: tensor cores for bf16 x with bk % 16 == 0 and bn % 8 == 0 (int8
    values too: their B fragments are built from the staged bytes), else
    FMAs.  M tile: the least power of two >= M between 16 and 128 (64 on
    the FMA path); warps along M as the tile needs, the rest split the
    chunk's slots.  Chunk: S = ``BSR_CHUNK`` slots (short enough that all
    WK warp groups stay busy on the short columns of a pruned layer), no
    more than a column of K // bk slots needs, halved (down to SW = 4)
    while a launch at full density (all E experts' tiles) has fewer than
    ``BSR_TARGET_BLOCKS`` blocks.  Step and ring: the most units a step
    (then the deepest ring) within ``BSR_SMEM_TARGET``, else one unit in
    the shallowest ring.
    Raises ValueError for a block the kernel does not take."""
    if dtype not in _DTYPES:
        raise TypeError(f"bsr_matmul: dtype {dtype} not supported "
                        f"(float32, bfloat16)")
    if (bk < 4 or bk & (bk - 1) or bn < 4 or bn > 256 or bn & (bn - 1)
            or K % bk or N % bn):
        raise ValueError(f"bsr_matmul: block ({bk}, {bn}) not supported "
                         f"for ({K}, {N}) (bk a power of two >= 4, bn one "
                         f"from 4 to 256)")
    es = 2 if dtype == torch.bfloat16 else 4
    ves = es if ves is None else ves
    if ves not in (es, 1):
        raise TypeError(f"bsr_matmul: {ves}-byte values under a {dtype} x "
                        f"(the values take x's dtype, or int8)")
    mma = int(es == 2 and bk % 16 == 0 and bn % 8 == 0)
    MT = 16
    while MT < min(M, 128 if mma else 64):
        MT *= 2
    FM = 2 if mma and MT > 16 else 1
    WM = MT // (16 * FM)
    WK = BSR_WARPS // WM
    NW = min(bn, 32)
    KS = min(bk, 64 if mma else 32)
    subcols, mtiles = bn // NW, -(-M // MT)
    Kb, tiles = K // bk, E * (N // bn) * subcols * mtiles
    SW = 4
    while WK * SW < min(Kb, BSR_CHUNK):
        SW *= 2
    while SW > 4 and tiles * -(-Kb // (WK * SW)) < BSR_TARGET_BLOCKS:
        SW //= 2
    xp, vp = _odd16(KS * es) // es, _odd16(NW * ves) // ves
    # the chunk's k_idx (and its scales, int8), ring or red tile, flag
    head = _round_to(4 * WK * SW, 16, 0) * (2 if ves == 1 else 1)

    def smem_of(U, stages):
        ring = stages * WK * U * (MT * xp * es + KS * vp * ves)
        red = WK * MT * NW * 4
        return head + max(ring, red) + 16
    U, stages = next(((u, st) for u in BSR_UNITS for st in BSR_STAGES
                      if smem_of(u, st) <= BSR_SMEM_TARGET),
                     (1, BSR_STAGES[-1]))
    return BsrPlan(M, bk, bn, mma, MT, FM, WM, NW, KS, WK * SW, SW,
                   subcols, mtiles, xp, vp, U, stages, smem_of(U, stages),
                   WK, K, N, dtype, E, ves)


@dataclasses.dataclass(frozen=True, eq=False)
class BsrBins:
    """The bin table of one (layout, plan): ``table`` the BinDesc rows
    (values, k_idx and cols pointers, first workspace float, columns,
    padded degree, chunks a column, first block, first tile, scales
    pointer or 0) as host int64 (an expert's scales at e times one
    expert's leaf, like its k_idx); ``items`` blocks, ``tiles`` counters
    and ``ws_floats`` of workspace of one expert (the whole launch for an
    unstacked layout; an expert stack's leaves are addressed by stride
    from expert 0's)."""
    table: ctypes.Array
    n_bins: int
    items: int
    tiles: int
    ws_floats: int


def _bsr_bins(layout, plan, device):
    """Kernel 1's bin table for ``plan``, checked against what the kernel
    assumes of each bin's tensors (an expert stack: ``plan.E`` experts on
    a leading axis of every leaf, each leaf contiguous).  Cached per
    layout and plan (the layout's tensors never change)."""
    def build():
        if layout.n_bins > BSR_MAX_BINS:
            raise ValueError(f"bsr_matmul: {layout.n_bins} bins, the kernel "
                             f"takes at most {BSR_MAX_BINS}")
        lead = _expert_dims(layout)
        if (lead[0] if lead else 1) != plan.E:
            raise ValueError(f"bsr_matmul: the layout stacks {lead} "
                             f"experts, the plan {plan.E}")
        gran = layout.scale_granularity
        if (plan.ves == 1) != (gran is not None):
            raise TypeError(f"bsr_matmul: the plan takes {plan.ves}-byte "
                            f"values, the layout {layout.value_dtype}")
        rows, item, tile, ws = [], 0, 0, 0
        for vals, kidx, cols, sc in zip(layout.values, layout.k_idx,
                                        layout.bin_cols,
                                        layout.bin_scales()):
            nb, L = kidx.shape[-2:]
            if any(t.device != device for t in (vals, kidx, cols)):
                raise ValueError(f"bsr_matmul: the layout and x must share "
                                 f"one device ({device})")
            if vals.dtype != (torch.int8 if gran else plan.dtype):
                raise TypeError(f"bsr_matmul: values dtype {vals.dtype} "
                                f"under x dtype {plan.dtype} (x's dtype, or "
                                f"int8 with scales)")
            if sc is not None and (
                    sc.dtype != torch.float32 or sc.device != device
                    or not sc.is_contiguous()
                    or tuple(sc.shape) != lead + ((nb, L) if gran == "block"
                                                  else (nb,))):
                raise ValueError(f"bsr_matmul: scales must be contiguous "
                                 f"float32 {lead + (nb, L)} (block) or "
                                 f"{lead + (nb,)} (out) on {device}, got "
                                 f"{sc.dtype} {tuple(sc.shape)}")
            if kidx.dtype != torch.int32 or cols.dtype != torch.int32:
                raise TypeError("bsr_matmul: k_idx and cols must be int32")
            if (tuple(vals.shape) != lead + (nb, L, plan.bk, plan.bn)
                    or tuple(kidx.shape) != lead + (nb, L)
                    or tuple(cols.shape) != lead + (nb,)):
                raise ValueError(f"bsr_matmul: shapes disagree: values "
                                 f"{tuple(vals.shape)}, k_idx "
                                 f"{tuple(kidx.shape)}, cols "
                                 f"{tuple(cols.shape)}")
            if not (vals.is_contiguous() and kidx.is_contiguous()
                    and cols.is_contiguous()) or vals.data_ptr() % 16:
                raise ValueError("bsr_matmul: values, k_idx and cols must "
                                 "be contiguous, values 16-byte aligned")
            nch = plan.chunks(L)
            tiles = nb * plan.subcols * plan.mtiles
            rows += [vals.data_ptr(), kidx.data_ptr(), cols.data_ptr(), ws,
                     nb, L, nch, item, tile,
                     0 if sc is None else sc.data_ptr()]
            item += tiles * nch
            tile += tiles
            if nch > 1:
                ws += tiles * nch * plan.MT * plan.NW
        if sum(layout.bin_sizes) * plan.bn != layout.shape[1]:
            raise ValueError(f"bsr_matmul: the bins cover "
                             f"{sum(layout.bin_sizes)} of {layout.Nb} block "
                             f"columns")
        table = (ctypes.c_longlong * len(rows))(*rows)
        return BsrBins(table, layout.n_bins, item, tile, ws)
    return _cached(layout, ("bins", plan), build)


def _expert_dims(layout):
    """() for an unstacked layout, (E,) for an expert stack; a layout with
    more stack dims (a layer axis) must be sliced first.  A sharded
    layout's (S,) is its shard axis, never an expert axis."""
    if layout.n_shards:
        raise ValueError("bsr_matmul: a sharded layout runs through "
                         "bsr_matmul_sharded (its shard axis is not an "
                         "expert axis)")
    lead = tuple(layout.nnz.shape[:-1])
    if len(lead) > 1:
        raise ValueError(f"bsr_matmul: the layout carries stack dims "
                         f"{lead}; slice its layer first (layout.layer(i))")
    return lead


# per device: kernel 1's per-tile arrival counters, all 0 between launches
# (the last block of a tile resets its own); launches on one device run
# on one stream at a time.  A CUDA graph keeps the address of the counters
# it was captured with, so a grown tensor never frees the one it replaces
# (``_RETIRED``): a graph captured before the growth replays on its own.
_COUNTERS: dict = {}
_RETIRED: list = []


def _counters(device, n):
    c = _COUNTERS.get(device)
    if c is None or c.numel() < n:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("bsr_matmul: the tile counters must grow "
                               "before a CUDA graph is captured (run the "
                               "call once uncaptured)")
        if c is not None:
            _RETIRED.append(c)
        size = max(n, 1 << 16, 0 if c is None else 2 * c.numel())
        c = torch.zeros(size, dtype=torch.int32, device=device)
        _COUNTERS[device] = c
    return c


# per (device, n, fill): the int32 tensors a raw entry's one-bin layout
# needs (its identity column map, its degree list), made once so that a
# raw call allocates nothing (and so captures into a CUDA graph whole)
_RAW_INDEX: dict = {}


def _raw_index(device, n, fill=None):
    """arange(n) (``fill`` None) or n copies of ``fill``, int32, on
    ``device``; cached."""
    key = (device, n, fill)
    t = _RAW_INDEX.get(key)
    if t is None:
        t = (torch.arange(n, dtype=torch.int32, device=device) if fill is None
             else torch.full((n,), fill, dtype=torch.int32, device=device))
        _RAW_INDEX[key] = t
    return t


def bsr_matmul(x, values, k_idx, bias=None, scales=None, *, act="none",
               out_dtype=None):
    """x (M, K) @ one uniform CSC layout (``core.bcs.pad_to_uniform_csc``)
    -> (M, Nb * bn): the reference's raw entry of kernel 1
    (``repro/kernels/bsr_matmul.py:143``).  ``values`` (Nb, L, bk, bn),
    ``k_idx`` (Nb, L) int32; every one of the L slots of a column is
    walked, padding slots (zero values) too, since the layout carries no
    degree list.  int8 values take fp32 ``scales``, (Nb, L) a block or
    (Nb,) a block column.  ``out_dtype`` as ``bsr_matmul_packed``'s.  On
    the card one launch of kernel 1 over the layout as one bin (counted
    under ``LAUNCHES["bsr_matmul_raw"]``); its sums equal those of a
    binned layout of the same weight wherever the two take the same
    chunks.  CPU tensors run ``kernels.ref.bsr_matmul_ref``.  The plan
    picks the M tile (the reference's ``bm`` has no counterpart)."""
    if values.dim() != 4 or tuple(k_idx.shape) != tuple(values.shape[:2]):
        raise ValueError(f"bsr_matmul: values {tuple(values.shape)} and "
                         f"k_idx {tuple(k_idx.shape)} are not (Nb, L, bk, "
                         f"bn) and (Nb, L)")
    Nb, L, bk, bn = values.shape
    if x.dim() != 2 or x.shape[1] % bk:
        raise ValueError(f"bsr_matmul: x {tuple(x.shape)} is not (M, K) "
                         f"with bk={bk} | K")
    if scales is not None and tuple(scales.shape) not in ((Nb, L), (Nb,)):
        raise ValueError(f"bsr_matmul: scales {tuple(scales.shape)} are "
                         f"neither ({Nb}, {L}) nor ({Nb},)")
    if x.device.type == "cpu":
        return ref.bsr_matmul_ref(x, values, k_idx, bias, act, out_dtype,
                                  scales)
    if x.device.type != "cuda":
        raise ValueError(f"bsr_matmul: unsupported device {x.device}")
    cols = _raw_index(values.device, Nb)
    layout = PackedLayout(values=(values,), k_idx=(k_idx,),
                          nnz=_raw_index(values.device, Nb, L), perm=cols,
                          inv_perm=cols, block=(bk, bn),
                          shape=(x.shape[1], Nb * bn),
                          scales=None if scales is None else (scales,))
    return _bsr_launch(x, layout, bias, act, "bsr_matmul_raw", out_dtype)


def bsr_matmul_packed(x, layout, bias=None, act="none", out_dtype=None):
    """x (M, K) @ PackedLayout W (K, N) -> (M, N): one launch over every
    degree bin, each column written at its original position, so the
    result is in original column order without a gather.  An output's
    sum order depends on its column's slot list and the shapes only, so
    reordered and unreordered layouts give bit-identical results.  x needs
    unit column stride and a 16-byte aligned base and row pitch.
    ``out_dtype`` (default x's; float32 or bfloat16) is the type the
    epilogue's fp32 value is stored as: float32 under a bf16 x keeps the
    fp32 sums.

    An expert stack (every leaf with a leading expert axis E, as
    ``serve.compile`` packs MoE experts) takes x (E, M, K) -> (E, M, N),
    bias None or (E, N): all experts in the same one launch, x's expert
    stride 16-byte aligned too.

    A tensor-parallel layout (``layout.n_shards`` > 0) goes to
    ``bsr_matmul_sharded``."""
    if layout.n_shards:
        return bsr_matmul_sharded(x, layout, bias, act, out_dtype)
    if placed_layout(layout):
        # replicated, or an expert stack split over the model axis: x is
        # this rank's (its local experts'), and so is the result
        layout = local_layout(layout)[0]
    lead = _expert_dims(layout)
    if x.dim() != 2 + len(lead) or tuple(x.shape[:-2]) != lead:
        raise ValueError(f"bsr_matmul: x {tuple(x.shape)} does not match a "
                         f"layout with expert dims {lead}")
    if x.shape[-1] != layout.shape[0]:
        raise ValueError(f"bsr_matmul: x has K={x.shape[-1]}, the layout "
                         f"K={layout.shape[0]}")
    if x.device.type == "cpu":
        if lead:
            return ref.bsr_matmul_experts_ref(x, layout, bias, act,
                                              out_dtype)
        return ref.bsr_matmul_packed_ref(x, layout, bias, act, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"bsr_matmul: unsupported device {x.device}")
    return _bsr_launch(x, layout, bias, act, "bsr_matmul", out_dtype)


def _out_dtype(x, out_dtype):
    """The output dtype of a launch: x's by default, float32 or bfloat16."""
    odt = x.dtype if out_dtype is None else out_dtype
    if odt not in _DTYPES:
        raise TypeError(f"out_dtype {odt} not supported (float32, "
                        f"bfloat16)")
    return odt


def _bsr_launch(x, layout, bias, act, key, out_dtype=None):
    """One launch of kernel 1 on the card over every bin (and expert) of
    an unsharded ``layout``, counted under ``LAUNCHES[key]``."""
    if act not in _ACTS:
        raise ValueError(f"bsr_matmul: unknown activation {act!r}")
    odt = _out_dtype(x, out_dtype)
    lead = _expert_dims(layout)
    E = lead[0] if lead else 1
    M, K = x.shape[-2:]
    N = layout.shape[1]
    es = x.element_size()
    ldx_e = x.stride(0) if lead else 0
    if (x.stride(-1) != 1 or x.data_ptr() % 16
            or (M > 1 and x.stride(-2) * es % 16) or ldx_e * es % 16
            or max(x.stride(-2), ldx_e) >= 2 ** 31):
        raise ValueError("bsr_matmul: x needs unit column stride and a "
                         "16-byte aligned base, row pitch and expert stride")
    if bias is not None and (bias.shape != lead + (N,)
                             or not bias.is_contiguous()
                             or bias.device != x.device
                             or bias.dtype != x.dtype):
        raise ValueError(f"bsr_matmul: bias must be a contiguous "
                         f"{lead + (N,)} {x.dtype} tensor on {x.device}")
    gran = layout.scale_granularity
    plan = bsr_plan(M, K, N, x.dtype, *layout.block, E,
                    1 if gran else es)
    bins = _bsr_bins(layout, plan, x.device)
    out = torch.empty(lead + (M, N), dtype=odt, device=x.device)
    if M == 0:
        return out
    ws = (torch.empty(E * bins.ws_floats, dtype=torch.float32,
                      device=x.device) if bins.ws_floats else None)
    err = _kernel()(x.data_ptr(), None if bias is None else bias.data_ptr(),
                    out.data_ptr(), None if ws is None else ws.data_ptr(),
                    _counters(x.device, E * bins.tiles).data_ptr(),
                    ctypes.addressof(plan.c_args),
                    ctypes.addressof(bins.table), bins.n_bins, bins.items,
                    x.stride(-2), out.stride(-2), _ACTS[act],
                    _DTYPES[x.dtype], _QUANT[gran], E, ldx_e,
                    out.stride(0) if lead else 0,
                    N if lead and bias is not None else 0, bins.tiles,
                    bins.ws_floats, _DTYPES[odt], _stream(x))
    _raise_on(err, "bsr_matmul", f"E={E}, M={M}, K={K}, N={N}, block="
                                 f"{layout.block}, dtype={x.dtype}, out="
                                 f"{odt}, values={layout.value_dtype}, plan="
                                 f"{plan.args()}")
    LAUNCHES[key] += 1
    return out


def placed_layout(layout) -> bool:
    """True when the layout's leaves are placed on a mesh (``DTensor``s,
    ``distributed.sharding.place_layout`` / ``shard_packed_tree``)."""
    return SH.is_placed(layout.nnz)


def local_layout(layout):
    """A placed layout as this rank holds it: ``(local layout, mesh,
    model mesh dim)``.  The local layout's leaves are the rank's own
    pieces (a column-sharded layout keeps S / tp of its S shards, an
    expert stack its E / tp experts; replicated leaves, ``inv_perm`` and
    ``alive`` among them, whole); the mesh dim is the one that splits the
    shard (or expert) axis, None when every leaf is replicated.  Built
    once per layout object."""
    def build():
        mesh = layout.nnz.device_mesh
        mdim = next((i for i, pl in enumerate(layout.values[0].placements)
                     if pl.is_shard()), None)

        def loc(t):
            if t is None:
                return None
            if isinstance(t, tuple):
                return tuple(loc(v) for v in t)
            return t.to_local() if SH.is_placed(t) else t
        kw = {f: loc(getattr(layout, f))
              for f in SH.layout_leaf_fields(layout)}
        n = layout.n_shards
        if n and mdim is not None:
            if n % mesh.size(mdim):
                raise ValueError(f"a layout of {n} shards does not split "
                                 f"over {mesh.size(mdim)} ranks")
            n //= mesh.size(mdim)
        return dataclasses.replace(layout, n_shards=n, **kw), mesh, mdim
    return _cached(layout, ("local",), build)


def _placed_launch(x, layout, bias, act, launch, parts, name,
                   out_dtype=None):
    """A column-sharded layout placed on a mesh, x (M, K) whole on every
    rank: ONE launch of the kernel per rank over its local shards
    (folded), then ONE all-gather over the model axis of each rank's
    (S / tp, M, N / S) columns, merged to original order through the
    replicated ``inv_perm``.  On the CPU the rank's part is ``parts`` (the
    plain version per shard and bin).  At one rank on the model axis the
    folded launch already wrote every column at its place: no collective,
    no merge, the unsharded code path of one card."""
    loc, mesh, mdim = local_layout(layout)
    bias = SH.full(bias)
    tp = 1 if mdim is None else mesh.size(mdim)
    if x.device.type == "cpu":
        y = parts(x, loc, bias, act, out_dtype)        # (S_loc, M, N / S)
    elif x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    else:
        out = launch(x, loc.folded, bias, act, name, out_dtype)   # (M, N)
        if tp == 1:
            return out
        width = loc.group if isinstance(loc, TapLayout) else loc.block[1]
        cols = loc.perm.reshape(-1).long()
        y = out.reshape(out.shape[0], -1, width).index_select(1, cols)
        y = y.reshape(out.shape[0], loc.n_shards, -1).movedim(1, 0)
    if tp > 1:
        # a functional collective (torch 2.11 and 2.13 both have this
        # one), so CommDebugMode counts it
        from torch.distributed import _functional_collectives as funcol
        y = funcol.wait_tensor(funcol.all_gather_tensor(
            y.contiguous(), 0, (mesh, mdim)))
    return loc.merge_shards(y)


def _sharded_launch(x, layout, bias, act, launch, plain, name, parts=None,
                    out_dtype=None):
    """The shard launcher of both wrappers: ``plain`` (per shard, per bin,
    then ``merge_shards``) for CPU tensors; on the card ``launch`` of the
    layout with its shard axis folded into its bins (``layout.folded``):
    x replicated to every shard, each column written at its original
    position, so no merge is needed.  Counted under ``LAUNCHES[name]``.
    A layout placed on a mesh runs ``_placed_launch``.  A stacked layout
    must be sliced first; an expert stack is never column-sharded."""
    if placed_layout(layout):
        return _placed_launch(x, layout, bias, act, launch, parts, name,
                              out_dtype)
    if layout.nnz.ndim != 2:
        raise ValueError(f"{name}: the layout carries stack dims "
                         f"{tuple(layout.nnz.shape[:-2])} beside its shard "
                         f"axis; slice its layer first (layout.layer(i))")
    if x.dim() != 2:
        raise ValueError(f"{name}: x {tuple(x.shape)} is not (M, K)")
    if x.device.type == "cpu":
        return plain(x, layout, bias, act, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    return launch(x, layout.folded, bias, act, name, out_dtype)


def bsr_matmul_sharded(x, layout, bias=None, act="none", out_dtype=None):
    """x (M, K) @ a tensor-parallel PackedLayout (K, N) -> (M, N), original
    column order (the reference's ``bsr_matmul_sharded`` :268): kernel 1
    over every (shard, bin) in one launch, each shard's degree-balanced
    columns against the replicated x.  Every column keeps its slot list,
    so the result equals the unsharded layout's wherever the two launches
    take the same chunks (padding slots add zeros)."""
    if x.shape[-1] != layout.shape[0]:
        raise ValueError(f"bsr_matmul_sharded: x has K={x.shape[-1]}, the "
                         f"layout K={layout.shape[0]}")
    return _sharded_launch(x, layout, bias, act, _bsr_launch,
                           ref.bsr_matmul_sharded_ref, "bsr_matmul_sharded",
                           ref.bsr_matmul_shard_parts, out_dtype)


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


def _refuse_shards(name, layout):
    """Kernels 3 and 4 take no tensor-parallel layout: a sharded conv runs
    materialized (``ops.sparse_conv2d`` / ``sparse_conv2d_pattern``), as
    the reference's does."""
    if layout.n_shards:
        raise ValueError(f"{name}: a sharded layout (n_shards="
                         f"{layout.n_shards}) runs materialized, through "
                         f"kernel 1 or 2 (the implicit kernels take no "
                         f"shards)")


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
    scales = list(layout.scales or ())
    tensors = (list(layout.values) + scales
               + ([bias] if bias is not None else []))
    if any(t.device != x.device for t in tensors):
        raise ValueError(f"{name}: the layout, bias and x must share one "
                         f"device")
    vdt = torch.int8 if scales else x.dtype
    if (any(t.dtype != vdt for t in layout.values)
            or any(t.dtype != torch.float32 for t in scales)
            or (bias is not None and bias.dtype != x.dtype)):
        raise TypeError(f"{name}: layout values must have x's dtype "
                        f"{x.dtype} (or be int8 with float32 scales), and "
                        f"bias x's dtype")
    if act not in _ACTS:
        raise ValueError(f"{name}: unknown activation {act!r}")
    if bias is not None and (bias.shape != (layout.shape[1],)
                             or not bias.is_contiguous()):
        raise ValueError(f"{name}: bias must be contiguous "
                         f"({layout.shape[1]},), got {tuple(bias.shape)}")




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
    if bk % 4 or bn not in (4, 8) and bn % BCS_REG_COLS:
        raise ValueError(f"{key}: block ({bk}, {bn}) not supported by the "
                         f"conv kernel (bk a multiple of 4, bn 4, 8 or a "
                         f"multiple of {BCS_REG_COLS})")
    if sum(layout.bin_sizes) * bn != layout.shape[1]:
        raise ValueError(f"{key}: the bins cover {sum(layout.bin_sizes)} "
                         f"of {layout.shape[1] // bn} block columns")
    vals, kidx, meta = _bsr_tables(layout)
    scales = _bsr_scales(layout)
    if scales is not None and scales.numel() != kidx.numel():
        raise ValueError(f"{key}: {scales.numel()} scales for "
                         f"{kidx.numel()} slots")
    soffs = _bsr_soffs(layout, plan, *taps_of)
    out = torch.empty((plan.B * plan.Ho * plan.Wo, plan.N), dtype=x.dtype,
                      device=x.device)
    err = _kernel("bsr_conv_launch")(
        x.data_ptr(), vals.data_ptr(),
        None if scales is None else scales.data_ptr(), soffs.data_ptr(),
        meta.data_ptr(), None if bias is None else bias.data_ptr(),
        out.data_ptr(), ctypes.addressof(plan.c_args), out.stride(0),
        _ACTS[act], _DTYPES[x.dtype], _QUANT[layout.scale_granularity], bk,
        bn, conv_piece(bk, bn)[1], plan.smem_bytes, _stream(x))
    _raise_on(err, key, f"x {tuple(x.shape)}, block ({bk}, {bn}), tile "
                        f"{plan.tr}x{plan.tw}, R={plan.R}, smem "
                        f"{plan.smem_bytes}, dtype={x.dtype}, values "
                        f"{layout.value_dtype}")
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
    _refuse_shards("bsr_conv2d_implicit", layout)
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
    _refuse_shards("bsr_conv2d_patches", layout)
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


def _tap_conv(x, layout, plan, band, bias, act, name, out_dtype=None):
    """One launch of kernel 4 over every bin of ``layout``: x is the
    (B, H, W, C) image ``plan`` tiles, whose channels are the layout's
    ``k_full`` rows, or (``band``) the 1 x M image of the alive band;
    returns (B*Ho*Wo, P)."""
    P = layout.shape[1]
    if sum(layout.bin_sizes) * layout.group != P:
        raise ValueError(f"{name}: the bins cover {sum(layout.bin_sizes)} "
                         f"of {layout.n_groups} filter groups")
    odt = _out_dtype(x, out_dtype)
    slots, meta = _tap_tables(layout, plan, band)
    out = torch.empty((plan.B * plan.Ho * plan.Wo, P), dtype=odt,
                      device=x.device)
    err = _kernel("tap_conv_launch")(
        x.data_ptr(), slots.data_ptr(), meta.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(),
        ctypes.addressof(plan.c_args), out.stride(0), _ACTS[act],
        _DTYPES[x.dtype], _QUANT[layout.scale_granularity], plan.smem_bytes,
        _DTYPES[odt], _stream(x))
    _raise_on(err, name, f"x {tuple(x.shape)}, tile {plan.tr}x{plan.tw}, "
                         f"R={plan.R}, smem {plan.smem_bytes}, "
                         f"dtype={x.dtype}, values {layout.value_dtype}")
    LAUNCHES[name] += 1
    return out


def tap_gather_conv(x, values, t_idx, bias=None, scales=None, *, act="none",
                    out_dtype=None):
    """x (M, R) alive im2col band @ one bin of filter-group tap lists ->
    (M, G * group): the reference's raw entry of kernel 2
    (``repro/kernels/bsr_matmul.py:314``).  ``values`` (G, L, group),
    ``t_idx`` (G, L) int32 band rows in [0, R); int8 values take fp32
    ``scales``, (G, L) a slot or (G, 1, group) a filter.  ``out_dtype``
    as ``bsr_matmul_packed``'s.  On the card one launch of kernel 2
    (kernel 4 over the band, as ``tap_gather_conv_packed`` runs it),
    counted under ``LAUNCHES["tap_gather_conv_raw"]``; its slot table is
    built on every call (the packed entry keeps it with the layout).  CPU
    tensors run ``kernels.ref.tap_gather_ref``."""
    if values.dim() != 3 or tuple(t_idx.shape) != tuple(values.shape[:2]):
        raise ValueError(f"tap_gather_conv: values {tuple(values.shape)} "
                         f"and t_idx {tuple(t_idx.shape)} are not (G, L, "
                         f"group) and (G, L)")
    G, L, gp = values.shape
    if x.dim() != 2:
        raise ValueError(f"tap_gather_conv: x {tuple(x.shape)} is not "
                         f"(M, R)")
    if scales is not None and tuple(scales.shape) not in ((G, L),
                                                          (G, 1, gp)):
        raise ValueError(f"tap_gather_conv: scales {tuple(scales.shape)} "
                         f"are neither ({G}, {L}) nor ({G}, 1, {gp})")
    if x.device.type == "cpu":
        return ref.tap_gather_ref(x, values, t_idx, bias, act, scales,
                                  out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"tap_gather_conv: unsupported device {x.device}")
    R = x.shape[1]
    cols = _raw_index(values.device, G)
    layout = TapLayout(values=(values,), t_idx=(t_idx,),
                       nnz=_raw_index(values.device, G, L),
                       alive=_raw_index(values.device, R), perm=cols,
                       inv_perm=cols, group=gp, shape=(R, G * gp),
                       scales=None if scales is None else (scales,))
    return _tap_band(x, layout, bias, act, "tap_gather_conv_raw", out_dtype)


def tap_gather_conv_packed(x, layout, bias=None, act="none",
                           out_dtype=None):
    """x (M, R) alive im2col band @ TapLayout -> (M, P), original filter
    order: kernel 4 over the band read as a 1 x M image of R channels
    (slot t_idx = channel), one launch over all degree bins, each filter
    group contracting only its own surviving taps in slot order, written
    at its original columns.  Bit-identical across bin counts and to the
    implicit mode.  A band with unit column stride but a wider row pitch
    is copied contiguous first.  ``out_dtype`` as ``bsr_matmul_packed``'s.
    A tensor-parallel layout goes to ``tap_gather_conv_sharded``."""
    if x.shape[-1] != layout.n_alive:
        raise ValueError(f"tap_gather_conv: x has {x.shape[-1]} band "
                         f"columns, the layout {layout.n_alive} alive rows")
    if layout.n_shards:
        return tap_gather_conv_sharded(x, layout, bias, act, out_dtype)
    if x.device.type == "cpu":
        return ref.tap_gather_packed_ref(x, layout, bias, act, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"tap_gather_conv: unsupported device {x.device}")
    return _tap_band(x, layout, bias, act, "tap_gather_conv", out_dtype)


def _tap_band(x, layout, bias, act, name, out_dtype=None):
    """One launch of kernel 2 (kernel 4 over the band) on the card."""
    if x.stride(1) != 1:
        raise ValueError(f"{name}: x needs unit column stride")
    x = x.contiguous()
    _check_conv_input(name, x, layout, bias, act)
    M, R = x.shape
    P = layout.shape[1]
    plan = conv_plan("tap", (1, 1, M, R), 1, 1, 1, "VALID", P, P)
    return _tap_conv(x, layout, plan, True, bias, act, name, out_dtype)


def tap_gather_conv_sharded(x, layout, bias=None, act="none",
                            out_dtype=None):
    """x (M, R) alive band @ a tensor-parallel TapLayout -> (M, P),
    original filter order (the reference's ``tap_gather_conv_sharded``
    :412): the band is global (``layout.alive`` is every shard's), each
    shard contracts its own filter groups; kernel 2 over every (shard,
    bin) in one launch."""
    if x.shape[-1] != layout.n_alive:
        raise ValueError(f"tap_gather_conv_sharded: x has {x.shape[-1]} "
                         f"band columns, the layout {layout.n_alive} alive "
                         f"rows")
    return _sharded_launch(x, layout, bias, act, _tap_band,
                           ref.tap_gather_sharded_ref,
                           "tap_gather_conv_sharded",
                           ref.tap_gather_shard_parts, out_dtype)


def tap_gather_conv_implicit(x, layout, *, kh, kw, stride=1, padding="SAME",
                             bias=None, act="none"):
    """x (B, H, W, C) * TapLayout -> (B, Ho, Wo, P) with neither the patch
    tensor nor the alive band: one launch over all degree bins, each block
    staging an input tile (halo zero-filled) and walking every filter's
    slots against it, a slot's input word taken from its ``k_full`` row
    (tap = k // C, (dy, dx) = divmod(tap, kw), channel = k % C)."""
    B, H, W, C = x.shape
    _refuse_shards("tap_gather_conv_implicit", layout)
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
    plan = conv_plan("tap", x.shape, kh, kw, stride, padding, P, P)
    out = _tap_conv(x, layout, plan, False, bias, act, name)
    return out.reshape(B, plan.Ho, plan.Wo, P)
