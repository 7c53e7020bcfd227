"""The tile plan of the two conv kernels (3: BCS, 4: tap gather) and their
flat tables, on the CPU.

``kernels.bsr_matmul.conv_plan`` decides each launch's tile, grid and
shared-memory bytes; the kernels take it as it is.  These tests check, at
every packed layer shape of ``VGG_TINY`` and ``MOBILE_TINY`` at B = 256 and
at the edge shapes, that the plan fits an H100 block's shared memory and
that its tiles, lanes and warps own every output position and column
exactly once.  They then emulate both kernels' addressing with torch —
the staged window in the kernels' shared-memory layout, the per-lane
position words and the per-slot words of the tables — and hold the result
against the plain versions: an index that disagrees between the plan, the
tables and the staging layout reads a NaN-poisoned or a wrong word here.
Int8 layouts go through the same emulation with their tables decoded as
the kernels decode them (kernel 3: int8 values and a scale a slot; kernel
4: the word and q packed in one int32 beside the slot's scale).  The
kernels themselves run on the card (``test_torch_cuda.py``)."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.core import bcs as BCS  # noqa: E402
from repro_torch.kernels import bsr_matmul as K  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import convnet as CN  # noqa: E402

B_SERVE = 256
TOL = 1e-5


def _layer_shapes(arch, hw, B):
    """(name, kh, kw, stride, (B, H, W, C), out) of each non-depthwise
    layer of a conv arch."""
    out, H, C = [], hw, 3
    for (name, cout, kh, kw, stride, dw) in arch:
        if not dw:
            out.append((name, kh, kw, stride, (B, H, H, C), cout))
        _, _, H, _ = K.conv_geometry(H, H, kh, kw, stride, "SAME")
        C = C if dw else cout
    return out


def _serve_plans():
    """Every plan the served nets (and the forced modes) can ask for, and
    MOBILE_TINY's 5x5 c4 at the 16x16 input the kernel phase times."""
    cases = []
    layers = [l for arch, hw in ((CN.VGG_TINY, 32), (CN.MOBILE_TINY, 16))
              for l in _layer_shapes(arch, hw, B_SERVE)]
    layers.append(("c4@16", 5, 5, 1, (B_SERVE, 16, 16, 128), 128))
    for name, kh, kw, s, shape, P in layers:
        cases.append(("tap", shape, kh, kw, s, P, P, 1))
        if shape[-1] % 8 == 0:
            cases.append(("bcs", shape, kh, kw, s, P // 8, P, 8))
            B, H, W, C = shape
            _, _, Ho, Wo = K.conv_geometry(H, W, kh, kw, s)
            M, Kd = B * Ho * Wo, kh * kw * C
            cases.append(("bcs", (1, 1, M, Kd), 1, 1, 1, P // 8, P, 8))
    # (kind, shape, kh, kw, stride, n_cols, N, bn); bk = bn (8, 8) blocks
    return cases


def _owners(plan):
    """(grid, warps_pos, 32, R) int64: the output row m = (b*Ho + ho)*Wo +
    wo each lane's position i stands for, -1 where the lane has none or
    the tile overhangs the image — the kernels' formulas (tile t = (b, ty,
    tx), p = lane + 32 * (wp + warps_pos * i), (r, c) = divmod(p, tw))."""
    t = torch.arange(plan.grid)
    tx = t % plan.tiles_w
    ty = (t // plan.tiles_w) % plan.tiles_h
    b = t // (plan.tiles_w * plan.tiles_h)
    wp = torch.arange(plan.warps_pos)
    lane = torch.arange(32)
    i = torch.arange(plan.R)
    p = (lane[None, :, None] + 32 * (wp[:, None, None]
                                     + plan.warps_pos * i[None, None]))
    r, c = p // plan.tw, p % plan.tw
    ho = ty[:, None, None, None] * plan.tr + r[None]
    wo = tx[:, None, None, None] * plan.tw + c[None]
    m = (b[:, None, None, None] * plan.Ho + ho) * plan.Wo + wo
    ok = (p[None] < plan.tr * plan.tw) & (ho < plan.Ho) & (wo < plan.Wo)
    return torch.where(ok, m, -1)


def _column_warps(plan):
    """(n_cols,) the column warp wc that walks each column: j = wc, wc +
    8 / warps_pos, ..."""
    return torch.arange(plan.n_cols) % (K.CONV_WARPS // plan.warps_pos)


def _check_plan(plan):
    assert plan.smem_bytes <= K.SMEM_MAX == 232448
    assert len(plan.args()) == 25            # the kernels' ConvTile
    assert 1 <= plan.R <= (8 if plan.kind == "tap" else 4)
    assert 32 * plan.warps_pos * plan.R >= plan.tr * plan.tw
    assert plan.rows_in == (plan.tr - 1) * plan.stride + plan.kh
    assert plan.pitch >= plan.cols_in
    own = _owners(plan)
    m = own[own >= 0]
    count = torch.bincount(m, minlength=plan.B * plan.Ho * plan.Wo)
    assert count.numel() == plan.B * plan.Ho * plan.Wo
    assert bool((count == 1).all()), "an output position is owned " \
        "by no lane or by two"
    cw = _column_warps(plan)
    assert cw.numel() == plan.n_cols
    assert int(cw.max()) < K.CONV_WARPS // plan.warps_pos


@pytest.mark.parametrize("case", _serve_plans(),
                         ids=lambda c: f"{c[0]}-{c[1]}-{c[2]}x{c[3]}s{c[4]}")
def test_plan_fits_and_covers_every_served_layer(case):
    kind, shape, kh, kw, s, n_cols, N, bn = case
    plan = K.conv_plan(kind, shape, kh, kw, s, "VALID" if kh == 1 and
                       shape[1] == 1 else "SAME", n_cols, N, bn, bn)
    _check_plan(plan)
    if shape[0] == B_SERVE:
        # the card fills: two blocks an SM on the served shapes
        assert plan.grid >= 256
        assert plan.smem_bytes <= K.SMEM_SOFT


@pytest.mark.parametrize("case", [c for c in _serve_plans()
                                  if c[0] == "tap"],
                         ids=lambda c: f"{c[1]}-{c[2]}x{c[3]}s{c[4]}")
def test_tap_lanes_hit_distinct_banks(case):
    """Kernel 4 reads one staged word per lane and FMA: where the tile
    width divides 32, a warp's 32 positions sit on 32 different banks."""
    kind, shape, kh, kw, s, n_cols, N, bn = case
    plan = K.conv_plan(kind, shape, kh, kw, s, "SAME", n_cols, N, bn)
    if 32 % plan.tw == 0:
        p, word = _lanes(plan)
        # one load instruction: the 32 lanes at one (wp, i)
        for w in word.reshape(plan.warps_pos, 32, plan.R).transpose(
                1, 2).reshape(-1, 32):
            assert len(set((w % 32).tolist())) == 32


def test_plan_edges_stride_two_pad_and_small_tiles():
    # stride 2 at an even input: XLA's (0, 1) SAME split, no low halo
    p = K.conv_plan("bcs", (3, 32, 32, 32), 3, 3, 2, "SAME", 8, 64, 8, 8)
    assert (p.ph0, p.pw0, p.Ho, p.Wo) == (0, 0, 16, 16)
    _check_plan(p)
    # C = 3: a 13 x 10 image is one tile whose 130 positions leave lanes
    # without one
    p = K.conv_plan("tap", (3, 13, 10, 3), 3, 3, 1, "SAME", 32, 32)
    assert p.tr * p.tw % (32 * p.warps_pos * p.R)
    _check_plan(p)
    # Ho not a multiple of the tile: the last tile overhangs the image
    p = K.conv_plan("bcs", (3, 13, 10, 32), 3, 3, 1, "SAME", 8, 64, 8, 8)
    assert p.tiles_h * p.tr > p.Ho
    _check_plan(p)
    # fewer columns than warps: the spare warps take positions
    p = K.conv_plan("bcs", (3, 13, 10, 16), 5, 5, 1, "SAME", 2, 16, 8, 8)
    assert p.warps_pos == 4
    _check_plan(p)
    # a K too deep for a 32-position tile still fits with fewer positions
    p = K.conv_plan("bcs", (1, 1, 500, 12800), 1, 1, 1, "VALID", 16, 128,
                    8, 8)
    assert p.tr * p.tw < 32
    _check_plan(p)
    with pytest.raises(ValueError, match="shared memory"):
        K.conv_plan("bcs", (1, 1, 5, 60000), 1, 1, 1, "VALID", 16, 128, 8,
                    8)


# -- the kernels' addressing, emulated -------------------------------------

def _tile_origin(plan, t):
    tx = t % plan.tiles_w
    ty = (t // plan.tiles_w) % plan.tiles_h
    b = t // (plan.tiles_w * plan.tiles_h)
    return b, ty * plan.tr, tx * plan.tw


def _stage(x, plan, t):
    """The block's shared-memory window as the kernels' loaders fill it;
    words no loader writes hold NaN."""
    b, ho0, wo0 = _tile_origin(plan, t)
    xs = torch.full((plan.x_floats,), float("nan"))
    s = plan.stride
    for row in range(plan.rows_in):
        hi = ho0 * s - plan.ph0 + row
        for col in range(plan.cols_in):
            wi = wo0 * s - plan.pw0 + col
            ok = 0 <= hi < plan.H and 0 <= wi < plan.W
            v = x[b, hi, wi].float() if ok else torch.zeros(plan.C)
            pc = (col % s) * plan.nph + col // s
            if plan.kind == "bcs":
                base = (row * plan.pitch + pc) * plan.chan_ld
                xs[base:base + plan.C] = v
            else:
                ch = torch.arange(plan.C)
                idx = ((ch >> plan.cg_log2) * plan.chan_ld
                       + (ch % 2 ** plan.cg_log2) * s * plan.nph
                       + row * plan.pitch + pc)
                xs[idx] = v
    return xs


def _lanes(plan):
    """Per (wp, lane, i): tile position p and its word (kernels' poff)."""
    wp = torch.arange(plan.warps_pos)[:, None, None]
    lane = torch.arange(32)[None, :, None]
    i = torch.arange(plan.R)[None, None, :]
    p = (lane + 32 * (wp + plan.warps_pos * i)).reshape(-1)
    pp = torch.where(p < plan.tr * plan.tw, p, 0)
    r, c = pp // plan.tw, pp % plan.tw
    word = r * plan.stride * plan.pitch + c
    if plan.kind == "bcs":
        word = word * plan.chan_ld
    return p, word


def _epilogue(acc, bias, act):
    return ref._epilogue(acc, None if bias is None else bias.float(), act)


def emulate_bcs(x, layout, taps_of, plan, bias, act):
    """Kernel 3 on ``plan`` with the tables it reads: the window offsets
    of the (kh, kw, C) = ``taps_of`` tap table; work item w is subcolumn
    w % (bn / sb) of block column w // (bn / sb), its slots read a (kp,
    sb) piece at a time (``conv_piece``)."""
    vals, _, meta = K._bsr_tables(layout)
    scales = K._bsr_scales(layout)
    soffs = K._bsr_soffs(layout, plan, *taps_of).long()
    bk, bn = layout.block
    sb, kp = K.conv_piece(bk, bn)
    assert plan.n_cols == layout.Nb * (bn // sb) and bk % kp == 0
    vals = vals.reshape(-1, bk, bn)
    out = torch.full((plan.B * plan.Ho * plan.Wo, plan.N), float("nan"))
    owners = _owners(plan)
    p, poff = _lanes(plan)
    for t in range(plan.grid):
        xs = _stage(x, plan, t)
        m = owners[t].reshape(-1)
        tile = torch.full((plan.tr * plan.tw, plan.N), float("nan"))
        for w in range(plan.n_cols):
            j, sub = divmod(w, bn // sb)
            start, L, col, _ = meta[j].tolist()
            sl = torch.arange(start, start + L)
            acc = torch.zeros(p.numel(), sb, dtype=torch.float64)
            for pc in range(bk // kp):
                kk = torch.arange(pc * kp, (pc + 1) * kp)
                xv = xs[poff[:, None, None] + soffs[sl][None, :, None]
                        + kk[None, None, :]]                # (lanes, L, kp)
                wv = vals[sl][:, kk, sub * sb:(sub + 1) * sb]  # (L, kp, sb)
                if scales is not None:                      # q * s, fp32
                    assert wv.dtype == torch.int8
                    wv = wv.float() * scales[sl][:, None, None]
                acc += torch.einsum("plk,lkc->pc", xv.double(), wv.double())
            keep = p < plan.tr * plan.tw
            c0 = col * bn + sub * sb
            tile[p[keep], c0:c0 + sb] = acc[keep].float()
        ok = m >= 0
        out[m[ok]] = tile[p[ok]]
    return _epilogue(out, bias, act).to(x.dtype)


def emulate_tap(x, layout, plan, bias, act, band=False):
    """Kernel 4 on ``plan`` with the tables it reads (``band``: kernel 2,
    the alive band as a 1 x M image)."""
    slots, meta = K._tap_tables(layout, plan, band)
    off, vbits = slots[:, 0].long(), slots[:, 1].contiguous()
    vals = vbits.view(torch.float32)
    if layout.scales is not None:         # (word + q * 2**16, scale bits)
        q = off >> K.TAP_WORD_BITS
        off = off & ((1 << K.TAP_WORD_BITS) - 1)
        assert bool((q.abs() <= 127).all()) and bool((off < plan.x_floats)
                                                     .all())
        vals = q.float() * vals
    out = torch.full((plan.B * plan.Ho * plan.Wo, plan.N), float("nan"))
    owners = _owners(plan)
    p, poff = _lanes(plan)
    for t in range(plan.grid):
        xs = _stage(x, plan, t)
        m = owners[t].reshape(-1)
        tile = torch.full((plan.tr * plan.tw, plan.N), float("nan"))
        for j in range(plan.n_cols):
            start, L, col, _ = meta[j].tolist()
            sl = torch.arange(start, start + L)
            xv = xs[poff[:, None] + off[sl][None, :]]       # (lanes, L)
            acc = (xv.double() * vals[sl].double()).sum(1)
            keep = p < plan.tr * plan.tw
            tile[p[keep], col] = acc[keep].float()
        ok = m >= 0
        out[m[ok]] = tile[p[ok]]
    return _epilogue(out, bias, act).to(x.dtype)


def _rand(seed, *shape):
    return torch.from_numpy(
        np.random.RandomState(seed).randn(*shape).astype(np.float32))


def _punched(P, Q, k, seed=0, rate=0.5):
    from repro_torch.core import regularity as R
    w = _rand(seed, P, Q, k, k) * 0.1
    mask = R.block_punched_mask(w, (8, 8), rate=rate)
    return w, mask


def _pattern(P, Q, k, seed=0):
    from repro_torch.core import regularity as R
    w = _rand(seed, P, Q, k, k) * 0.1
    mask = (R.pattern_mask(w, 0.5) if k == 3
            else R.connectivity_mask(w, rate=0.5))
    return w, mask


EDGE = [  # (P, Q, k, stride, B, H, W): C = 3 (tap only), stride 2 at an
    # even input ((0, 1) pad), Ho * Wo not a multiple of the tile, 5x5
    (32, 3, 3, 1, 3, 13, 10), (64, 32, 3, 2, 3, 12, 12),
    (32, 16, 5, 1, 3, 13, 10), (64, 64, 1, 1, 3, 7, 9),
    (64, 32, 3, 2, 3, 13, 10)]


@pytest.mark.parametrize("act", ["none", "relu"])
@pytest.mark.parametrize("P,Q,k,stride,B,H,W", [e for e in EDGE
                                                if e[1] % 8 == 0])
def test_bcs_kernel_addressing_matches_plain(P, Q, k, stride, B, H, W, act):
    w, mask = _punched(P, Q, k)
    lay = ops.pack(BCS.conv_lower(w), BCS.conv_lower(mask), (8, 8),
                   reorder=True, n_bins=4, conv=(k, k, Q))
    x = _rand(1, B, H, W, Q)
    bias = _rand(2, P) if act == "relu" else None
    want = K.bsr_conv2d_implicit(x, lay, kh=k, kw=k, stride=stride,
                                 bias=bias, act=act).reshape(-1, P)
    plan = K.conv_plan("bcs", x.shape, k, k, stride, "SAME", lay.Nb, P, 8,
                       8)
    _check_plan(plan)
    got = emulate_bcs(x, lay, (k, k, Q), plan, bias, act)
    torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)
    # the materialized mode: the patch matrix as a 1 x M image
    patches = ops.im2col(x, k, k, stride).reshape(-1, k * k * Q)
    pp = K.conv_plan("bcs", (1, 1) + tuple(patches.shape), 1, 1, 1,
                     "VALID", lay.Nb, P, 8, 8)
    _check_plan(pp)
    got = emulate_bcs(patches.reshape(1, 1, *patches.shape), lay,
                      (1, 1, k * k * Q), pp, bias, act)
    torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("values", [None, "int8"])
@pytest.mark.parametrize("P,Q,k,stride,kblock", [
    (64, 64, 3, 1, (32, 64)), (128, 128, 3, 2, (128, 128)),
    (64, 32, 3, 2, (64, 16))])
def test_bcs_kernel_addressing_at_wide_blocks(P, Q, k, stride, kblock,
                                              values):
    """The rule mapper's conv blocks (VGG_TINY's c3 at kernel block (32,
    64) = GEMM block (64, 32), c6 at (128, 128)) and a 16-wide block of 64
    rows: subcolumns of 16 and slots staged kp rows at a time, on the
    image and on its patch matrix."""
    from repro_torch.core import regularity as R
    w = _rand(5, P, Q, k, k) * 0.1
    mask = R.block_punched_mask(w, kblock, rate=0.5)
    gb, _ = BCS.conv_gemm_block(kblock, tuple(w.shape))
    lay = ops.pack(BCS.conv_lower(w), BCS.conv_lower(mask), gb, reorder=True,
                   n_bins=4, conv=(k, k, Q), value_dtype=values)
    sb, kp = K.conv_piece(*gb)
    assert kp * sb <= K.BCS_PIECE and (gb[1] > 16) == (sb < gb[1])
    x = _rand(6, 2, 9, 7, Q)
    bias = _rand(7, P)
    want = K.bsr_conv2d_implicit(x, lay, kh=k, kw=k, stride=stride,
                                 bias=bias, act="relu").reshape(-1, P)
    plan = K.conv_plan("bcs", x.shape, k, k, stride, "SAME", lay.Nb, P,
                       gb[1], gb[0])
    _check_plan(plan)
    got = emulate_bcs(x, lay, (k, k, Q), plan, bias, "relu")
    torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)
    patches = ops.im2col(x, k, k, stride).reshape(-1, k * k * Q)
    pp = K.conv_plan("bcs", (1, 1) + tuple(patches.shape), 1, 1, 1,
                     "VALID", lay.Nb, P, gb[1], gb[0])
    _check_plan(pp)
    got = emulate_bcs(patches.reshape(1, 1, *patches.shape), lay,
                      (1, 1, k * k * Q), pp, bias, "relu")
    torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("act", ["none", "relu"])
@pytest.mark.parametrize("P,Q,k,stride,B,H,W", EDGE)
def test_tap_kernel_addressing_matches_plain(P, Q, k, stride, B, H, W, act):
    w, mask = _pattern(P, Q, k)
    lay = ops.pack_taps(w, mask, reorder=True, n_bins=8)
    x = _rand(3, B, H, W, Q)
    bias = _rand(4, P) if act == "relu" else None
    want = K.tap_gather_conv_implicit(x, lay, kh=k, kw=k, stride=stride,
                                      bias=bias, act=act).reshape(-1, P)
    plan = K.conv_plan("tap", x.shape, k, k, stride, "SAME", P, P)
    _check_plan(plan)
    got = emulate_tap(x, lay, plan, bias, act)
    torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("gran", ["block", "out"])
@pytest.mark.parametrize("P,Q,k,stride,B,H,W", [EDGE[1], EDGE[4]])
def test_int8_bcs_kernel_addressing_matches_plain(P, Q, k, stride, B, H, W,
                                                  gran):
    """Kernel 3's int8 tables: values kept int8 (no dequantized copy) and
    one fp32 scale a slot, on the image and on its patch matrix."""
    w, mask = _punched(P, Q, k)
    lay = ops.pack(BCS.conv_lower(w), BCS.conv_lower(mask), (8, 8),
                   reorder=True, n_bins=4, conv=(k, k, Q),
                   value_dtype="int8", scale_granularity=gran)
    vals, kidx, _ = K._bsr_tables(lay)
    scales = K._bsr_scales(lay)
    assert vals.dtype == torch.int8 and scales.dtype == torch.float32
    assert scales.shape == kidx.shape
    x = _rand(1, B, H, W, Q)
    bias = _rand(2, P)
    want = K.bsr_conv2d_implicit(x, lay, kh=k, kw=k, stride=stride,
                                 bias=bias, act="relu").reshape(-1, P)
    plan = K.conv_plan("bcs", x.shape, k, k, stride, "SAME", lay.Nb, P, 8,
                       8)
    got = emulate_bcs(x, lay, (k, k, Q), plan, bias, "relu")
    torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)
    patches = ops.im2col(x, k, k, stride).reshape(-1, k * k * Q)
    pp = K.conv_plan("bcs", (1, 1) + tuple(patches.shape), 1, 1, 1,
                     "VALID", lay.Nb, P, 8, 8)
    got = emulate_bcs(patches.reshape(1, 1, *patches.shape), lay,
                      (1, 1, k * k * Q), pp, bias, "relu")
    torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("gran", ["block", "out"])
@pytest.mark.parametrize("P,Q,k,stride,B,H,W", [EDGE[0], EDGE[3]])
def test_int8_tap_kernel_addressing_matches_plain(P, Q, k, stride, B, H, W,
                                                  gran):
    """Kernel 4 (and 2, over the alive band) on int8 slots: the word in the
    low 16 bits, q above, the slot's scale (its filter's, "out") in the
    value word."""
    w, mask = _pattern(P, Q, k)
    lay = ops.pack_taps(w, mask, reorder=True, n_bins=8, value_dtype="int8",
                        scale_granularity=gran)
    x = _rand(3, B, H, W, Q)
    bias = _rand(4, P)
    want = K.tap_gather_conv_implicit(x, lay, kh=k, kw=k, stride=stride,
                                      bias=bias, act="relu").reshape(-1, P)
    plan = K.conv_plan("tap", x.shape, k, k, stride, "SAME", P, P)
    got = emulate_tap(x, lay, plan, bias, "relu")
    torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)
    band = ops.im2col(x, k, k, stride).reshape(-1, k * k * Q)
    band = band.index_select(1, lay.alive.long())
    bp = K.conv_plan("tap", (1, 1) + tuple(band.shape), 1, 1, 1, "VALID",
                     P, P)
    got = emulate_tap(band.reshape(1, 1, *band.shape), lay, bp, bias,
                      "relu", band=True)
    torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)


def test_int8_tap_slot_refuses_a_tile_past_its_word_bits():
    w, mask = _pattern(32, 16, 3)
    lay = ops.pack_taps(w, mask, value_dtype="int8",
                        scale_granularity="out")
    plan = K.conv_plan("tap", (2, 8, 8, 16), 3, 3, 1, "SAME", 32, 32)
    assert plan.x_floats <= 1 << K.TAP_WORD_BITS
    big = dataclasses.replace(plan, x_floats=(1 << K.TAP_WORD_BITS) + 4)
    with pytest.raises(ValueError, match="staged words"):
        K._tap_tables(lay, big)
    # every plan fits: the shared memory caps the staged words
    assert K.SMEM_MAX // 4 <= 1 << K.TAP_WORD_BITS


def test_bins_of_one_slot_and_fewer_columns_than_a_block():
    """A bin whose columns keep one K-block (L = 1) and bins with fewer
    columns than the block's column warps: the tables and the plan still
    give every output once."""
    Q, P, k = 16, 40, 3                       # 5 block columns, 4 bins
    w = _rand(5, P, Q, k, k)
    live = np.zeros((k * k * Q // 8, P // 8), bool)
    live[:, :2] = True                        # two dense columns
    live[3, 2:] = True                        # three of degree 1
    mask = torch.from_numpy(np.repeat(np.repeat(live, 8, 0), 8, 1))
    wl = BCS.conv_lower(w)
    lay = ops.pack(wl, mask, (8, 8), reorder=True, n_bins=4,
                   conv=(k, k, Q))
    assert 1 in lay.bin_degrees and min(lay.bin_sizes) < K.CONV_WARPS
    x = _rand(6, 2, 9, 7, Q)
    want = K.bsr_conv2d_implicit(x, lay, kh=k, kw=k, act="relu",
                                 bias=_rand(7, P)).reshape(-1, P)
    plan = K.conv_plan("bcs", x.shape, k, k, 1, "SAME", lay.Nb, P, 8, 8)
    _check_plan(plan)
    got = emulate_bcs(x, lay, (k, k, Q), plan, _rand(7, P), "relu")
    torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)
    # the tap layout of a net with one live tap per filter in some bins
    tmask = torch.zeros(P, Q, k, k)
    tmask[:8] = 1
    tmask[8:, 0, 1, 1] = 1
    tl = ops.pack_taps(w, tmask, reorder=True, n_bins=8)
    assert 1 in tl.bin_degrees
    want = K.tap_gather_conv_implicit(x, tl, kh=k, kw=k).reshape(-1, P)
    plan = K.conv_plan("tap", x.shape, k, k, 1, "SAME", P, P)
    got = emulate_tap(x, tl, plan, None, "none")
    torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)


def test_tables_are_cached_per_layout_and_geometry():
    w, mask = _pattern(32, 16, 3)
    lay = ops.pack_taps(w, mask)
    a = K.conv_plan("tap", (2, 8, 8, 16), 3, 3, 1, "SAME", 32, 32)
    b = K.conv_plan("tap", (2, 16, 16, 16), 3, 3, 1, "SAME", 32, 32)
    assert K._tap_tables(lay, a) is K._tap_tables(lay, a)
    assert K._tap_tables(lay, a)[0] is not K._tap_tables(lay, b)[0]
    # the columns are every filter once, each with its bin's degree
    meta = K._tap_tables(lay, a)[1]
    assert sorted(meta[:, 2].tolist()) == list(range(32))
    assert sorted(meta[:, 1].tolist()) == sorted(
        d for n, d in zip(lay.bin_sizes, lay.bin_degrees) for _ in range(n))


def test_entry_signatures_match_the_sources():
    """The ctypes table of each C entry point (pointers, then ints, then
    the stream) against its declaration in ``csrc/``: a mismatch passes
    garbage to the kernel on the card."""
    import re
    from repro_torch.kernels import _build
    declared = {m for lib in {v[0] for v in K._ENTRIES.values()}
                for m in re.findall(r'extern "C" int (\w+)\(',
                                    (_build.CSRC / f"{lib}.cu").read_text())}
    assert declared == set(K._ENTRIES)       # no entry left out or stale
    for entry, (lib, n_ptr, n_int) in K._ENTRIES.items():
        src = (_build.CSRC / f"{lib}.cu").read_text()
        m = re.search(r'extern "C" int ' + entry + r"\(([^)]*)\)", src)
        assert m, f"{entry} not declared in {lib}.cu"
        params = [p.strip() for p in m.group(1).split(",")]
        kinds = ["ptr" if "*" in p else "int" for p in params]
        assert kinds == ["ptr"] * n_ptr + ["int"] * n_int + ["ptr"], entry
        assert all(p.split()[0] in ("const", "void*", "int", "void")
                   for p in params), entry
