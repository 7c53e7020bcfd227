"""Kernel 1's launch plan, its bin table and its arithmetic, and kernel 2's
plan over the alive band, on the CPU.

``kernels.bsr_matmul.bsr_plan`` decides each launch of the BCS matmul
kernel (path, M tile, warps, chunk of slots, staged rows, shared memory)
from the shapes alone, and ``_bsr_bins`` lays out the per-bin table the
kernel takes as its argument.  These tests check the plan at the path
boundaries, then emulate the kernel with torch: the blocks' work items
decoded from the table as the kernel decodes them, each warp group's
sub-chunk in slot order, the groups added in order, the chunked columns
through the workspace and the arrival counters (blocks arriving in a
shuffled order), and the epilogue; an MoE expert stack's blocks
(the kernel's grid y) address their expert's leaves, x, out, counters and
workspace by the strides the wrapper passes.  The emulation must equal
itself bitwise on reordered and unreordered layouts and the plain version
within tolerance.  A last group emulates ``ldmatrix`` and ``mma.sync``
fragment by fragment on the kernel's shared-memory addresses.  Int8
layouts: the plan at 1-byte values, the bin table's scales pointer and
its expert stride, the emulated kernel dequantizing as the card does
(``q * s`` at the value read on the FMA path, ``s * (x @ q)`` a k16 step
on the tensor cores) and the hand-built B fragments of int8 values.  The
kernels themselves run on the card (``test_torch_cuda.py``)."""
import random

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.kernels import bsr_matmul as K  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.serve import compile as C  # noqa: E402

from test_torch_conv_plan import _check_plan, emulate_tap  # noqa: E402

CPU = torch.device("cpu")
BF16, FP32 = torch.bfloat16, torch.float32
# yi-9b's projections (K, N) and the block menu of core/regularity.py
YI = [(4096, 4096), (4096, 512), (4096, 11008), (11008, 4096)]
MENU = [(4, 4), (8, 16), (16, 16), (16, 32), (32, 64), (64, 128),
        (128, 32), (128, 64), (128, 128), (128, 256), (256, 256)]
M_EDGES = [1, 4, 15, 16, 17, 128, 129]


def _es(dtype):
    return 2 if dtype == BF16 else 4


# -- the plan ----------------------------------------------------------------

@pytest.mark.parametrize("dtype", [FP32, BF16])
@pytest.mark.parametrize("block", MENU)
@pytest.mark.parametrize("M", M_EDGES)
def test_plan_path_tile_and_shared_memory(M, block, dtype):
    bk, bn = block
    Kd, N = 2048, 4096
    p = K.bsr_plan(M, Kd, N, dtype, bk, bn)
    es = _es(dtype)
    assert p.mma == int(dtype == BF16 and bk % 16 == 0 and bn % 8 == 0)
    # the M tile: the least power of two >= M from 16, capped
    cap = 128 if p.mma else 64
    assert p.MT == min(max(16, 1 << (M - 1).bit_length()), cap)
    assert p.mtiles == -(-M // p.MT) and (p.mtiles - 1) * p.MT < M
    assert p.MT == 16 * p.FM * p.WM and p.WK * p.WM == K.BSR_WARPS
    assert p.FM == (2 if p.mma and p.MT > 16 else 1)
    # the sub-column and the k piece
    assert p.NW == min(bn, 32) and p.subcols * p.NW == bn
    assert bk % p.KS == 0 and (p.KS % 16 == 0 if p.mma else True)
    # staged rows: whole 16-byte units, an odd number of them
    for elems, width in ((p.xp, p.KS), (p.vp, p.NW)):
        assert elems >= width and elems * es % 16 == 0
        assert (elems * es // 16) % 2 == 1
    # the chunk: a whole number of warp sub-chunks
    assert p.S == p.WK * p.SW and p.SW >= 4 and p.SW & (p.SW - 1) == 0
    # step and ring: the most units a step, then the deepest ring, within
    # the target; else one unit in the shallowest ring
    def smem(u, st):               # k_idx of a chunk, ring or red, flag
        ring = st * p.WK * u * (p.MT * p.xp + p.KS * p.vp) * es
        return (-(-4 * p.S // 16) * 16 + max(ring, p.WK * p.MT * p.NW * 4)
                + 16)
    assert p.smem == smem(p.U, p.stages) <= K.SMEM_MAX == 232448
    better = [(u, st) for u in K.BSR_UNITS for st in K.BSR_STAGES
              if u > p.U or (u == p.U and st > p.stages)]
    assert all(smem(u, st) > K.BSR_SMEM_TARGET for u, st in better)
    assert p.smem <= K.BSR_SMEM_TARGET or (p.U, p.stages) == (
        1, K.BSR_STAGES[-1])
    assert len(p.args()) == 18                   # the kernel's BsrShape


def test_plan_decode_and_prefill_at_yi9b():
    """At yi-9b's shapes: tensor cores; decode in a 16-row tile with four
    warp groups splitting the slots, prefill in one 128-row tile; chunks
    short enough to fill the card where the columns alone do not."""
    for M, MT, WK in ((4, 16, 4), (128, 128, 1)):
        for Kd, N in YI:
            p = K.bsr_plan(M, Kd, N, BF16, 16, 16)
            assert p.mma and (p.MT, p.WK, p.mtiles) == (MT, WK, 1)
    assert [K.bsr_plan(4, Kd, N, BF16, 16, 16).S for Kd, N in YI] == [
        64, 16, 64, 64]
    assert [K.bsr_plan(128, Kd, N, BF16, 16, 16).S for Kd, N in YI] == [
        64, 8, 64, 64]


def test_plan_rejects_blocks_the_kernel_does_not_take():
    for block in ((2, 16), (16, 2), (12, 16), (16, 512)):
        with pytest.raises(ValueError, match="not supported"):
            K.bsr_plan(4, 1024, 1024, FP32, *block)
    with pytest.raises(TypeError):
        K.bsr_plan(4, 1024, 1024, torch.float16, 16, 16)


# -- the bin table -----------------------------------------------------------

def _layout(K_, N_, block, dtype, reorder, n_bins=4, seed=0, density=0.4,
            gran=None):
    rng = np.random.RandomState(seed)
    bk, bn = block
    live = rng.rand(K_ // bk, N_ // bn) < density
    live[:, -1] = True                       # one dense column
    live[:, 0] = False
    live[rng.randint(K_ // bk), 0] = True    # one of degree 1
    mask = torch.from_numpy(np.repeat(np.repeat(live, bk, 0), bn, 1))
    w = torch.from_numpy(rng.randn(K_, N_).astype(np.float32)).to(dtype)
    return ops.pack(w, mask, block, reorder=reorder, n_bins=n_bins,
                    value_dtype=gran and "int8",
                    scale_granularity=gran or "block")


@pytest.mark.parametrize("n_bins", [1, 2, 4, 8])
def test_bin_table_matches_the_layout(n_bins):
    lay = _layout(256, 384, (16, 16), BF16, True, n_bins)
    for M in (4, 128):
        p = K.bsr_plan(M, 256, 384, BF16, 16, 16)
        bins = K._bsr_bins(lay, p, CPU)
        assert K._bsr_bins(lay, p, CPU) is bins        # cached
        rows = torch.tensor(list(bins.table)).reshape(-1, 10)
        assert rows.shape[0] == bins.n_bins == lay.n_bins
        item = tile = ws = 0
        for r, vals, kidx, cols in zip(rows.tolist(), lay.values, lay.k_idx,
                                       lay.bin_cols):
            nb, L = kidx.shape
            nch = -(-L // p.S)
            assert r == [vals.data_ptr(), kidx.data_ptr(), cols.data_ptr(),
                         ws, nb, L, nch, item, tile, 0]
            tiles = nb * p.subcols * p.mtiles
            item += tiles * nch
            tile += tiles
            ws += tiles * nch * p.MT * p.NW if nch > 1 else 0
        assert (bins.items, bins.tiles, bins.ws_floats) == (item, tile, ws)


def test_chunks_do_not_depend_on_the_bin_count():
    """S comes from the shapes alone, so every column is cut at the same
    slots whatever bin it lands in: a column's chunks in a longer bin are
    its chunks in a shorter one plus all-padding ones."""
    layouts = [_layout(512, 256, (16, 16), BF16, True, n)
               for n in (1, 2, 4, 8)] + [_layout(512, 256, (16, 16), BF16,
                                                 False)]
    plans = {K.bsr_plan(4, 512, 256, BF16, 16, 16) for _ in layouts}
    assert len(plans) == 1
    p = plans.pop()
    for lay in layouts:
        rows = torch.tensor(list(K._bsr_bins(lay, p, CPU).table)).reshape(
            -1, 10)
        assert rows[:, 6].tolist() == [-(-L // p.S)
                                       for L in lay.bin_degrees]


# -- kernel 1 emulated -------------------------------------------------------

def _decode(p, bins, item):
    """The kernel's work-item decode: (bin row, b, j, s, mt, c, tile)."""
    rows = torch.tensor(list(bins.table)).reshape(-1, 10).tolist()
    b = 0
    while b + 1 < bins.n_bins and item >= rows[b + 1][7]:
        b += 1
    r = rows[b]
    nch = r[6]
    q = item - r[7]
    c, q = q % nch, q // nch
    mt, q = q % p.mtiles, q // p.mtiles
    s, j = q % p.subcols, q // p.subcols
    return r, b, j, s, mt, c, (j * p.subcols + s) * p.mtiles + mt


def _strided(t, offset, size, stride):
    """The elements of contiguous ``t`` the kernel reads at flat element
    ``offset`` (its pointer arithmetic), as a tensor of ``size``."""
    flat = t.reshape(-1)
    return flat.as_strided(size, stride, flat.storage_offset() + offset)


def emulate_bsr(x, layout, bias, act, seed=0):
    """Kernel 1 on its plan and bin table, blocks in a shuffled order.  An
    expert stack (x (E, M, K), leaves with a leading E axis) runs E copies
    of the grid (blockIdx.y = e): expert e's values, k_idx and cols at e
    times one expert's leaf from the bin's pointer, x / out / bias at e
    times their expert stride, counters and workspace at e times one
    expert's share, as the kernel addresses them."""
    lead = tuple(layout.nnz.shape[:-1])
    E = lead[0] if lead else 1
    M, Kd = x.shape[-2:]
    bk, bn = layout.block
    N = layout.shape[1]
    gran = layout.scale_granularity
    p = K.bsr_plan(M, Kd, N, x.dtype, bk, bn, E, 1 if gran else None)
    bins = K._bsr_bins(layout, p, CPU)
    MT, NW, KS = p.MT, p.NW, p.KS
    nks = bk // KS
    xe = x.reshape(E, M, Kd)
    be = None if bias is None else bias.reshape(E, N)
    out = torch.full((E, M, N), float("nan"))
    ws = torch.full((max(E * bins.ws_floats, 1),), float("nan"))
    counters = torch.zeros(E * bins.tiles, dtype=torch.int64)
    blocks = [(e, item) for e in range(E) for item in range(bins.items)]
    random.Random(seed).shuffle(blocks)
    seen = set()
    for e, item in blocks:
        r, b, j, s, mt, c, tile = _decode(p, bins, item)
        assert (e, b, j, s, mt, c) not in seen
        seen.add((e, b, j, s, mt, c))
        nb, L, nch = r[4], r[5], r[6]
        je = e * nb + j                        # column j of expert e
        vals, kidx = layout.values[b], layout.k_idx[b]
        col = int(layout.bin_cols[b].reshape(-1)[je])
        m0 = mt * MT
        rows = min(MT, M - m0)
        slot0 = c * p.S
        sums = []
        for g in range(p.WK):                  # warp groups
            n = min(max(L - (slot0 + g * p.SW), 0), p.SW) * nks
            acc = torch.zeros(MT, NW)
            for t in range(n):
                l = slot0 + g * p.SW + t // nks
                k0 = (t % nks) * KS
                kb = int(kidx.reshape(-1)[je * L + l])
                xt = torch.zeros(MT, KS)       # rows >= M stay zero
                xt[:rows] = xe[e, m0:m0 + rows,
                               kb * bk + k0:kb * bk + k0 + KS]
                vt = _strided(vals, (je * L + l) * bk * bn + k0 * bn
                              + s * NW, (KS, NW), (bn, 1)).float()
                if gran is None:
                    acc = acc + xt.float() @ vt
                    continue
                # the bin's scales pointer; expert e's at e times its leaf
                sc = layout.scales[b]
                assert r[9] == sc.data_ptr()
                sv = float(_strided(sc, je * L + l if gran == "block"
                                    else je, (1,), (1,))[0])
                if p.mma:                      # s * (x @ q), a k16 step
                    for k in range(0, KS, 16):
                        acc = acc + sv * (xt[:, k:k + 16].float()
                                          @ vt[k:k + 16])
                else:                          # q * s at the value read
                    acc = acc + xt.float() @ (vt * sv)
            sums.append(acc)
        y = sums[0]
        for a in sums[1:]:                     # the groups, in order
            y = y + a
        y = y[:rows].reshape(-1)

        def finish(v):
            oc = col * bn + s * NW
            o = ref._epilogue(v.reshape(rows, NW),
                              None if be is None else
                              be[e, oc:oc + NW].float(), act)
            dst = out[e, m0:m0 + rows, oc:oc + NW]
            assert bool(dst.isnan().all()), "an output written twice"
            out[e, m0:m0 + rows, oc:oc + NW] = o.to(x.dtype).float()

        if nch == 1:
            finish(y)
            continue
        base = e * bins.ws_floats + r[3] + tile * nch * MT * NW
        ws[base + c * MT * NW:base + c * MT * NW + y.numel()] = y
        t_id = e * bins.tiles + r[8] + tile
        counters[t_id] += 1
        if counters[t_id] == nch:              # the last to arrive
            v = ws[base:base + y.numel()].clone()
            for cc in range(1, nch):
                v = v + ws[base + cc * MT * NW:base + cc * MT * NW
                           + y.numel()]
            finish(v)
            counters[t_id] = 0
    assert len(seen) == E * bins.items
    assert bool((counters == 0).all()), "a counter left dirty"
    assert not bool(out.isnan().any()), "an output never written"
    return out.reshape(lead + (M, N)).to(x.dtype)


@pytest.mark.parametrize("dtype", [FP32, BF16])
@pytest.mark.parametrize("block", [(16, 16), (16, 32), (8, 16), (4, 4)])
@pytest.mark.parametrize("M", [1, 4, 17, 129])
def test_emulated_kernel_matches_plain_and_is_bitwise_reorder_stable(
        M, block, dtype):
    Kd, N = 2048, 128
    lays = [_layout(Kd, N, block, dtype, True, n) for n in (4, 8)]
    lays.append(_layout(Kd, N, block, dtype, False))
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(M, Kd).astype(np.float32)).to(dtype)
    b = torch.from_numpy(rng.randn(N).astype(np.float32)).to(dtype)
    p = K.bsr_plan(M, Kd, N, dtype, *block)
    # the case splits columns into several chunks and its bins differ in
    # their chunk counts
    nchs = {-(-L // p.S) for lay in lays for L in lay.bin_degrees}
    assert max(nchs) > 1 and len(nchs) > 1
    ys = [emulate_bsr(x, lay, b, "silu", seed=i)
          for i, lay in enumerate(lays)]
    for y in ys[1:]:
        assert torch.equal(y, ys[0])
    want = ref.bsr_matmul_packed_ref(x.float(), lays[0], b.float(), "silu")
    tol = 1e-4 if dtype == FP32 else 1e-2
    torch.testing.assert_close(ys[0].float(), want, rtol=tol, atol=tol)


# -- the encdec and vlm shapes ------------------------------------------------

# (K, N) of seamless-m4t-large-v2's and llama-3.2-vision-90b's projections
# at full width; M = 4096 is the encoder's and the cross wk / wv's rows
# (B = 4 x 1024 frontend tokens), 32 M tiles, where earlier paths never
# passed 8; K = 28672 (llama-vision's down, Kb = 1792) is the longest
# column yet
ENCDEC_VLM = [(1024, 1024), (1024, 8192), (8192, 1024), (8192, 8192),
              (8192, 28672), (28672, 8192)]


@pytest.mark.parametrize("Kd,N", ENCDEC_VLM)
@pytest.mark.parametrize("M", [4, 128, 4096])
def test_plan_at_the_encdec_and_vlm_shapes(M, Kd, N):
    """Tensor cores; the tile count, the chunk and the shared memory of
    each launch, and the workspace and counters its bin table asks for
    (the table's columns cut to 4, their slot lists kept: the sizes are
    per column, and the kernel takes ``tiles`` and ``ws_floats`` from the
    table)."""
    p = K.bsr_plan(M, Kd, N, BF16, 16, 16)
    assert p.mma and p.subcols == 1 and p.NW == 16
    assert (p.MT, p.mtiles) == ((16, 1) if M == 4 else (128, M // 128))
    assert p.WK == (4 if M == 4 else 1) and p.S == p.WK * p.SW
    tiles = (N // 16) * p.mtiles
    if M == 4096:
        # 32 M tiles: every column fills the card on its own, so the
        # chunk stays at BSR_CHUNK slots
        assert p.mtiles == 32 and p.S == K.BSR_CHUNK == 64
        assert tiles >= 2048 and tiles * p.chunks(Kd // 16) >= \
            K.BSR_TARGET_BLOCKS
    assert p.smem <= K.BSR_SMEM_TARGET
    lay = _layout(Kd, 64, (16, 16), BF16, True)
    q = K.bsr_plan(M, Kd, 64, BF16, 16, 16)
    assert (q.MT, q.mtiles, q.WK) == (p.MT, p.mtiles, p.WK)
    bins = K._bsr_bins(lay, q, CPU)
    want_ws = want_items = 0
    for kidx in lay.k_idx:
        nb, L = kidx.shape
        nch = q.chunks(L)
        want_items += nb * q.mtiles * nch
        if nch > 1:
            want_ws += nb * q.mtiles * nch * q.MT * q.NW
    assert bins.tiles == 4 * q.mtiles
    assert (bins.items, bins.ws_floats) == (want_items, want_ws)
    # the dense column holds every one of the K // 16 slots
    assert max(lay.bin_degrees) == Kd // 16
    # at the full N, were every column dense, the workspace stays under
    # 2**31 floats (8 GiB) and the tile counters inside int32
    assert tiles * q.chunks(Kd // 16) * q.MT * q.NW < 2 ** 31


@pytest.mark.parametrize("M,Kd,N", [(4096, 256, 32), (4, 28672, 32),
                                    (129, 28672, 32)])
def test_emulated_kernel_at_32_m_tiles_and_the_longest_column(M, Kd, N):
    """The emulated launch at M = 4096 (32 M tiles, chunked columns
    through the workspace and the counters) and at K = 28672 (a column of
    1792 slots in 28 chunks): equal to the plain version, bitwise across
    the reorder."""
    lays = [_layout(Kd, N, (16, 16), BF16, True),
            _layout(Kd, N, (16, 16), BF16, False)]
    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.randn(M, Kd).astype(np.float32)).to(BF16)
    b = torch.from_numpy(rng.randn(N).astype(np.float32)).to(BF16)
    p = K.bsr_plan(M, Kd, N, BF16, 16, 16)
    assert max(p.chunks(L) for L in lays[0].bin_degrees) > 1
    if M == 4096:
        assert p.mtiles == 32
    else:
        assert max(p.chunks(L) for L in lays[0].bin_degrees) == 1792 // p.S
    ys = [emulate_bsr(x, lay, b, "silu", seed=i)
          for i, lay in enumerate(lays)]
    assert torch.equal(ys[0], ys[1])
    want = ref.bsr_matmul_packed_ref(x.float(), lays[0], b.float(), "silu")
    torch.testing.assert_close(ys[0].float(), want, rtol=1e-2, atol=1e-2)


# -- kernel 1's expert axis (MoE) ---------------------------------------------

def _expert_stack(E, K_, N_, block, dtype, reorder, n_bins=4, seed=0,
                  gran=None):
    """An (E, K, N) expert stack packed as ``compile_model`` packs MoE
    experts (``_pack_stacked``): one dense column, one empty, per expert."""
    rng = np.random.RandomState(seed)
    bk, bn = block
    live = rng.rand(E, K_ // bk, N_ // bn) < 0.4
    live[:, :, -1] = True
    live[:, :, 0] = False
    mask = torch.from_numpy(np.repeat(np.repeat(live, bk, 1), bn, 2))
    w = torch.from_numpy(rng.randn(E, K_, N_).astype(np.float32)).to(dtype)
    lay, _ = C._pack_stacked(w * mask.to(dtype), mask, block,
                             reorder=reorder, n_bins=n_bins,
                             value_dtype=gran and "int8",
                             scale_granularity=gran or "block")
    return lay


def test_plan_counts_every_experts_tiles():
    """E = 1 is the unstacked plan; an expert stack fills the card with all
    experts' tiles, so its chunks are no shorter than one expert's."""
    for M in (1, 4, 40, 65):
        for Kd, N in ((4096, 14336), (14336, 4096), (512, 256)):
            one = K.bsr_plan(M, Kd, N, BF16, 16, 16)
            assert one == K.bsr_plan(M, Kd, N, BF16, 16, 16, 1)
            assert one.E == 1
            for E in (4, 8, 64, 384):
                p = K.bsr_plan(M, Kd, N, BF16, 16, 16, E)
                assert p.E == E and p.args() != [] and p.S >= one.S
                assert p.args()[:9] == one.args()[:9]   # path and tile
    # mixtral's experts at decode and prefill (M = capacity 40)
    for M, MT in ((4, 16), (40, 64)):
        for Kd, N in ((4096, 14336), (14336, 4096)):
            p = K.bsr_plan(M, Kd, N, BF16, 16, 16, 8)
            assert p.mma and p.MT == MT and p.mtiles == 1 and p.S == 64


@pytest.mark.parametrize("E", [4, 64, 384])
@pytest.mark.parametrize("n_bins", [4, 16])
def test_expert_bin_table_addresses_every_expert_by_stride(E, n_bins):
    """The table is one expert's, at most 16 bins whatever E: expert e's
    leaves sit e x (one expert's leaf) past the bin's pointers, its columns
    in the stacked ``bin_cols``."""
    lay = _expert_stack(E, 64, 256, (16, 16), BF16, True, n_bins)
    assert lay.n_bins == n_bins
    p = K.bsr_plan(4, 64, 256, BF16, 16, 16, E)
    bins = K._bsr_bins(lay, p, CPU)
    rows = torch.tensor(list(bins.table)).reshape(-1, 10).tolist()
    assert len(rows) == n_bins
    item = tile = 0
    for r, vals, kidx, cols in zip(rows, lay.values, lay.k_idx,
                                   lay.bin_cols):
        nb, L = kidx.shape[-2:]
        assert tuple(cols.shape) == (E, nb) and cols.is_contiguous()
        assert r[4:6] == [nb, L] and r[7:9] == [item, tile]
        for e in (0, 1, E - 1):
            assert vals[e].data_ptr() == r[0] + e * nb * L * 16 * 16 * 2
            assert kidx[e].data_ptr() == r[1] + e * nb * L * 4
            assert cols[e].data_ptr() == r[2] + e * nb * 4
        item += nb * p.subcols * p.mtiles * r[6]
        tile += nb * p.subcols * p.mtiles
    assert (bins.items, bins.tiles) == (item, tile)   # one expert's


def test_stacked_bin_cols_slice_the_last_dim():
    """bin_cols of an (E, Nb) and an (L, E, Nb) stack: contiguous
    (..., nb_b) slices of perm, and a layer's / an expert's slice of the
    stack has the slice's bin_cols."""
    lay = _expert_stack(3, 64, 512, (16, 16), FP32, True, 4)
    start = 0
    for b, cols in enumerate(lay.bin_cols):
        n = lay.bin_sizes[b]
        assert cols.is_contiguous() and tuple(cols.shape) == (3, n)
        assert torch.equal(cols, lay.perm[:, start:start + n])
        for e in range(3):
            assert torch.equal(lay.layer(e).bin_cols[b], cols[e])
        start += n
    unre = _expert_stack(3, 64, 512, (16, 16), FP32, False)
    assert torch.equal(unre.bin_cols[0],
                       torch.arange(32, dtype=torch.int32).expand(3, 32))
    rng = np.random.RandomState(0)
    w = torch.from_numpy(rng.randn(2, 3, 64, 128).astype(np.float32))
    mask = torch.from_numpy(rng.rand(2, 3, 64, 128) < 0.5)
    stack, _ = C._pack_stacked(w, mask, (16, 16), n_bins=4)
    for b, cols in enumerate(stack.bin_cols):
        assert tuple(cols.shape) == (2, 3, stack.bin_sizes[b])
        assert torch.equal(stack.layer(1).bin_cols[b], cols[1])
        assert stack.layer(1).bin_cols[b].is_contiguous()


@pytest.mark.parametrize("E,n_bins,M,dtype", [(4, 4, 17, FP32),
                                              (4, 16, 4, BF16),
                                              (64, 4, 4, BF16),
                                              (64, 16, 1, FP32)])
def test_emulated_expert_launch_matches_plain_and_is_reorder_stable(
        E, n_bins, M, dtype):
    """Every expert in one launch, blocks of all experts arriving in a
    shuffled order: columns cut into chunks meet through each expert's own
    workspace and counters; reordered == unreordered bitwise, and expert e
    equals the plain product with its own layout slice."""
    # E = 64: K = 68 blocks, so the dense column (68 slots) is cut at S = 64
    Kd, N = (512, 256) if E == 4 else (1088, 16 * n_bins)
    lays = [_expert_stack(E, Kd, N, (16, 16), dtype, True, n_bins),
            _expert_stack(E, Kd, N, (16, 16), dtype, False)]
    p = K.bsr_plan(M, Kd, N, dtype, 16, 16, E)
    assert max(p.chunks(L) for L in lays[0].bin_degrees) > 1
    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.randn(E, M, Kd).astype(np.float32)).to(dtype)
    b = torch.from_numpy(rng.randn(E, N).astype(np.float32)).to(dtype)
    ys = [emulate_bsr(x, lay, b, "silu", seed=i)
          for i, lay in enumerate(lays)]
    assert torch.equal(ys[0], ys[1])
    want = ref.bsr_matmul_experts_ref(x.float(), lays[0], b.float(), "silu")
    tol = 1e-4 if dtype == FP32 else 1e-2
    torch.testing.assert_close(ys[0].float(), want, rtol=tol, atol=tol)
    # the CPU wrapper runs the same plain version
    assert torch.equal(K.bsr_matmul_packed(x, lays[0], b, "silu"),
                       ref.bsr_matmul_experts_ref(x, lays[0], b, "silu"))


def test_wrapper_refuses_x_that_does_not_match_the_stack():
    lay = _expert_stack(4, 64, 128, (16, 16), FP32, True)
    with pytest.raises(ValueError, match="expert dims"):
        K.bsr_matmul_packed(torch.zeros(3, 2, 64), lay)
    with pytest.raises(ValueError, match="expert dims"):
        K.bsr_matmul_packed(torch.zeros(2, 64), lay)


# -- int8 values --------------------------------------------------------------

@pytest.mark.parametrize("dtype", [FP32, BF16])
@pytest.mark.parametrize("block", MENU)
@pytest.mark.parametrize("M", [4, 17, 128])
def test_plan_at_int8_values(M, block, dtype):
    """1-byte values: the float plan's path, tiles and chunk; value rows
    of odd 16-byte units; the chunk's scales staged after its k_idx; the
    ring counting x in x's bytes and the values in one byte each."""
    bk, bn = block
    fl = K.bsr_plan(M, 2048, 4096, dtype, bk, bn)
    p = K.bsr_plan(M, 2048, 4096, dtype, bk, bn, 1, 1)
    es = _es(dtype)
    assert p.ves == 1 and fl.ves == es
    assert p.args()[:9] == fl.args()[:9]
    assert (p.S, p.SW, p.WK, p.xp) == (fl.S, fl.SW, fl.WK, fl.xp)
    assert p.vp >= p.NW and p.vp % 16 == 0 and (p.vp // 16) % 2 == 1

    def smem(u, st):               # k_idx and scales, ring or red, flag
        ring = st * p.WK * u * (p.MT * p.xp * es + p.KS * p.vp)
        return (2 * -(-4 * p.S // 16) * 16
                + max(ring, p.WK * p.MT * p.NW * 4) + 16)
    assert p.smem == smem(p.U, p.stages) <= K.SMEM_MAX
    better = [(u, st) for u in K.BSR_UNITS for st in K.BSR_STAGES
              if u > p.U or (u == p.U and st > p.stages)]
    assert all(smem(u, st) > K.BSR_SMEM_TARGET for u, st in better)
    with pytest.raises(TypeError):
        K.bsr_plan(M, 2048, 4096, dtype, bk, bn, 1, 6 - es)


@pytest.mark.parametrize("gran", ["block", "out"])
@pytest.mark.parametrize("E", [1, 4, 64])
def test_int8_bin_table_carries_scales_by_expert_stride(E, gran):
    """Each bin's row ends with its scales pointer; the kernel's offset
    (je * L + slot for "block", je for "out", je = e * nb + j) reads
    expert e's scale of column j; a float plan refuses the int8 layout
    and an int8 plan a float one."""
    if E == 1:
        lay = _layout(64, 256, (16, 16), BF16, True, gran=gran)
    else:
        lay = _expert_stack(E, 64, 256, (16, 16), BF16, True, gran=gran)
    p = K.bsr_plan(4, 64, 256, BF16, 16, 16, E, 1)
    rows = torch.tensor(list(K._bsr_bins(lay, p, CPU).table)).reshape(
        -1, 10).tolist()
    for r, sc, kidx in zip(rows, lay.scales, lay.k_idx):
        nb, L = kidx.shape[-2:]
        assert r[9] == sc.data_ptr() and sc.is_contiguous()
        assert sc.dtype == torch.float32
        per_col = L if gran == "block" else 1
        sv = sc.reshape(E, nb, per_col)
        for e in {0, min(1, E - 1), E - 1}:
            for j in {0, nb - 1}:
                for l in {0, per_col - 1}:
                    off = (e * nb + j) * per_col + l
                    assert _strided(sc, off, (1,), (1,))[0] == sv[e, j, l]
    with pytest.raises(TypeError):
        K._bsr_bins(lay, K.bsr_plan(4, 64, 256, BF16, 16, 16, E), CPU)
    fl = _layout(64, 256, (16, 16), BF16, True)
    with pytest.raises(TypeError):
        K._bsr_bins(fl, K.bsr_plan(4, 64, 256, BF16, 16, 16, 1, 1), CPU)


@pytest.mark.parametrize("gran", ["block", "out"])
@pytest.mark.parametrize("dtype", [FP32, BF16])
@pytest.mark.parametrize("block", [(16, 16), (8, 16), (32, 64)])
@pytest.mark.parametrize("M", [4, 129])
def test_emulated_int8_kernel_matches_plain_and_is_bitwise_reorder_stable(
        M, block, dtype, gran):
    Kd, N = 512, 128
    lays = [_layout(Kd, N, block, dtype, True, n, gran=gran)
            for n in (4, 8)]
    lays.append(_layout(Kd, N, block, dtype, False, gran=gran))
    rng = np.random.RandomState(4)
    x = torch.from_numpy(rng.randn(M, Kd).astype(np.float32)).to(dtype)
    b = torch.from_numpy(rng.randn(N).astype(np.float32)).to(dtype)
    ys = [emulate_bsr(x, lay, b, "silu", seed=i)
          for i, lay in enumerate(lays)]
    for y in ys[1:]:
        assert torch.equal(y, ys[0])
    want = ref.bsr_matmul_packed_ref(x.float(), lays[0], b.float(), "silu")
    tol = 1e-4 if dtype == FP32 else 1e-2
    torch.testing.assert_close(ys[0].float(), want, rtol=tol, atol=tol)


@pytest.mark.parametrize("gran", ["block", "out"])
def test_emulated_int8_expert_launch_matches_plain(gran):
    E, Kd, N = 4, 1088, 64          # 68 K-blocks: the dense column chunked
    lays = [_expert_stack(E, Kd, N, (16, 16), BF16, True, gran=gran),
            _expert_stack(E, Kd, N, (16, 16), BF16, False, gran=gran)]
    rng = np.random.RandomState(6)
    x = torch.from_numpy(rng.randn(E, 4, Kd).astype(np.float32)).to(BF16)
    ys = [emulate_bsr(x, lay, None, "none", seed=i)
          for i, lay in enumerate(lays)]
    assert torch.equal(ys[0], ys[1])
    want = ref.bsr_matmul_experts_ref(x.float(), lays[0], None, "none")
    torch.testing.assert_close(ys[0].float(), want, rtol=1e-2, atol=1e-2)


# -- ldmatrix and mma.sync, fragment by fragment ------------------------------

def _ldmatrix(smem, addr, n, trans):
    """``ldmatrix.m8n8.x{n}[.trans].b16``: lanes 8i..8i+7 give the row
    addresses (elements) of matrix i, a row being 8 consecutive elements.
    Returns regs[lane][i] = the lane's two elements of matrix i."""
    regs = [[None] * n for _ in range(32)]
    for i in range(n):
        mat = torch.stack([smem[addr[8 * i + r]:addr[8 * i + r] + 8]
                           for r in range(8)])
        if trans:
            mat = mat.t()
        for lane in range(32):
            g, t = lane // 4, lane % 4
            regs[lane][i] = (mat[g, 2 * t], mat[g, 2 * t + 1])
    return regs


def _mma(a, bb):
    """``mma.m16n8k16.row.col``: rebuild A (16x16) and B (16x8) from the
    lanes' fragments as the PTX ISA lays them out; D = A @ B, returned as
    the lanes' c fragments."""
    A = torch.full((16, 16), float("nan"))
    B = torch.full((16, 8), float("nan"))
    for lane in range(32):
        g, t = lane // 4, lane % 4
        for i, (r, k) in enumerate(((g, 2 * t), (g + 8, 2 * t),
                                    (g, 2 * t + 8), (g + 8, 2 * t + 8))):
            A[r, k], A[r, k + 1] = a[lane][i]
        for i, k in enumerate((2 * t, 2 * t + 8)):
            B[k, g], B[k + 1, g] = bb[lane][i]
    D = A.double() @ B.double()
    return [(D[lane // 4, 2 * (lane % 4)], D[lane // 4, 2 * (lane % 4) + 1],
             D[lane // 4 + 8, 2 * (lane % 4)],
             D[lane // 4 + 8, 2 * (lane % 4) + 1]) for lane in range(32)]


@pytest.mark.parametrize("M,block", [(4, (16, 16)), (17, (16, 32)),
                                     (64, (32, 64)), (128, (16, 16)),
                                     (128, (128, 256)), (4, (16, 8))])
def test_fragments_of_the_tensor_core_path(M, block):
    """One pipeline step of every warp, on the kernel's staged layout
    (unstaged words NaN) and its lane addresses: the red tile the warps
    write equals x_tile @ value_piece, and every ldmatrix phase's 8 row
    addresses sit on 8 distinct 16-byte bank quads."""
    bk, bn = block
    p = K.bsr_plan(M, 4 * bk, 4 * bn, BF16, bk, bn)
    assert p.mma
    g = torch.Generator().manual_seed(0)
    xt = torch.randn(p.MT, p.KS, generator=g)
    vt = torch.randn(p.KS, p.NW, generator=g)
    xs = torch.full((p.MT * p.xp,), float("nan"))
    vs = torch.full((p.KS * p.vp,), float("nan"))
    for r in range(p.MT):
        xs[r * p.xp:r * p.xp + p.KS] = xt[r]
    for r in range(p.KS):
        vs[r * p.vp:r * p.vp + p.NW] = vt[r]

    def quads(addr):                       # bf16: 2 bytes an element
        for i in range(len(addr) // 8):
            q = {(2 * a // 16) % 8 for a in addr[8 * i:8 * i + 8]}
            assert len(q) == 8

    red = torch.full((p.MT, p.NW), float("nan"), dtype=torch.float64)
    for wm in range(p.WM):
        acc = {}
        for k16 in range(0, p.KS, 16):
            af = []
            for f in range(p.FM):
                addr = [(wm * 16 * p.FM + f * 16 + (ln & 15)) * p.xp + k16
                        + (ln >> 4) * 8 for ln in range(32)]
                quads(addr)
                af.append(_ldmatrix(xs, addr, 4, False))
            bf = []
            if p.NW == 8:
                addr = [(k16 + (ln & 15)) * p.vp for ln in range(32)]
                quads(addr[:16])
                r2 = _ldmatrix(vs, addr, 2, True)
                bf.append([(r2[ln][0], r2[ln][1]) for ln in range(32)])
            else:
                for np_ in range(p.NW // 16):
                    addr = [(k16 + (ln & 15)) * p.vp + np_ * 16
                            + (ln >> 4) * 8 for ln in range(32)]
                    quads(addr)
                    r4 = _ldmatrix(vs, addr, 4, True)
                    bf.append([(r4[ln][0], r4[ln][1]) for ln in range(32)])
                    bf.append([(r4[ln][2], r4[ln][3]) for ln in range(32)])
            for f in range(p.FM):
                for n in range(p.NW // 8):
                    d = _mma(af[f], bf[n])
                    for ln in range(32):
                        a0 = acc.get((f, n, ln), (0.0,) * 4)
                        acc[(f, n, ln)] = tuple(u + v for u, v in
                                                zip(a0, d[ln]))
        for (f, n, ln), q in acc.items():
            row = wm * 16 * p.FM + f * 16 + (ln >> 2)
            col = n * 8 + 2 * (ln & 3)
            red[row, col], red[row, col + 1] = q[0], q[1]
            red[row + 8, col], red[row + 8, col + 1] = q[2], q[3]
    torch.testing.assert_close(red, xt.double() @ vt.double())


@pytest.mark.parametrize("M,block", [(4, (16, 16)), (17, (16, 32)),
                                     (128, (16, 8)), (64, (32, 64))])
def test_int8_b_fragments_built_by_hand(M, block):
    """int8 values staged as bytes (rows of ``vp``): lane (g, t) = (lane /
    4, lane % 4) builds n-tile n's B fragment from rows k16 + 2t + {0, 1}
    and k16 + 2t + {8, 9} of column n * 8 + g — the layout mma.m16n8k16
    reads; the k16 steps' products scaled and summed give x @ (q * s)."""
    bk, bn = block
    p = K.bsr_plan(M, 4 * bk, 4 * bn, BF16, bk, bn, 1, 1)
    assert p.mma and p.ves == 1
    g = torch.Generator().manual_seed(1)
    xt = torch.randn(16, p.KS, generator=g).to(BF16).float()
    q = torch.randint(-127, 128, (p.KS, p.NW), generator=g).float()
    vs = torch.full((p.KS * p.vp,), float("nan"))
    for r in range(p.KS):
        vs[r * p.vp:r * p.vp + p.NW] = q[r]
    s = 0.0123
    acc = torch.zeros(16, p.NW, dtype=torch.float64)
    for k16 in range(0, p.KS, 16):
        a = [[None] * 4 for _ in range(32)]
        for lane in range(32):
            gg, t = lane // 4, lane % 4
            for i, (r, k) in enumerate(((gg, 2 * t), (gg + 8, 2 * t),
                                        (gg, 2 * t + 8),
                                        (gg + 8, 2 * t + 8))):
                a[lane][i] = (xt[r, k16 + k], xt[r, k16 + k + 1])
        for n in range(p.NW // 8):
            bb = []
            for lane in range(32):
                kr, col = k16 + 2 * (lane & 3), n * 8 + (lane >> 2)
                bb.append([(vs[kr * p.vp + col], vs[(kr + 1) * p.vp + col]),
                           (vs[(kr + 8) * p.vp + col],
                            vs[(kr + 9) * p.vp + col])])
            d = _mma(a, bb)
            for lane in range(32):
                row, col = lane >> 2, n * 8 + 2 * (lane & 3)
                for i, (dr, dc) in enumerate(((0, 0), (0, 1), (8, 0),
                                              (8, 1))):
                    acc[row + dr, col + dc] += s * float(d[lane][i])
    torch.testing.assert_close(acc, xt.double() @ (q.double() * s))


@pytest.mark.parametrize("NW", [4, 8, 16, 32])
def test_fma_path_lanes_own_their_warp_tile_once(NW):
    """The FMA path: lane owns column lane % NW of rows r0 + i * (32 /
    NW), i < NW / 2 — every (row, column) of a warp's 16 x NW tile once."""
    own = torch.zeros(16, NW, dtype=torch.int64)
    lognw = NW.bit_length() - 1
    for lane in range(32):
        col, r0, rstep = lane & (NW - 1), lane >> lognw, 32 >> lognw
        for i in range(NW // 2):
            own[r0 + i * rstep, col] += 1
    assert bool((own == 1).all())


# -- kernel 2: kernel 4 over the alive band ----------------------------------

def _pattern_layout(P, Q, k, n_bins=8, seed=0):
    from repro_torch.core import regularity as R
    w = torch.from_numpy(np.random.RandomState(seed).randn(P, Q, k, k)
                         .astype(np.float32)) * 0.1
    mask = (R.pattern_mask(w, 0.5) if k == 3
            else R.connectivity_mask(w, rate=0.5))
    return ops.pack_taps(w, mask, reorder=True, n_bins=n_bins)


@pytest.mark.parametrize("P,Q,k,B,H", [(64, 64, 1, 3, 7), (32, 16, 3, 2, 6),
                                       (128, 128, 1, 1, 5)])
def test_band_plan_and_tables_match_plain(P, Q, k, B, H):
    """Kernel 2 = kernel 4 on the band as a 1 x M image of R channels:
    its plan covers every band row once, and its tables (slot word = the
    slot's t_idx channel) give the plain version's outputs."""
    lay = _pattern_layout(P, Q, k)
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.randn(B, H, H, Q).astype(np.float32))
    band = ops.im2col(x, k, k).reshape(B * H * H, -1)
    if lay.n_alive < band.shape[1]:
        band = band.index_select(1, lay.alive.long())
    bias = torch.from_numpy(rng.randn(P).astype(np.float32))
    want = K.tap_gather_conv_packed(band, lay, bias, "relu")
    plan = K.conv_plan("tap", (1, 1) + tuple(band.shape), 1, 1, 1, "VALID",
                       P, P)
    _check_plan(plan)
    got = emulate_tap(band.reshape(1, 1, *band.shape), lay, plan, bias,
                      "relu", band=True)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    if k == 1:   # the band is the image: the implicit mode's input words
        imp = K.tap_gather_conv_implicit(x, lay, kh=1, kw=1, bias=bias,
                                         act="relu").reshape(-1, P)
        assert torch.equal(imp, want)


def test_band_plan_at_the_served_c5():
    """VGG_TINY's 1x1 c5 at B = 256 (16 x 16 x 128 into 128): one launch
    of two blocks an SM that fills the card."""
    M, R, P = 256 * 16 * 16, 128, 128
    plan = K.conv_plan("tap", (1, 1, M, R), 1, 1, 1, "VALID", P, P)
    _check_plan(plan)
    assert plan.grid >= 2 * K.SMS and plan.smem_bytes <= K.SMEM_SOFT
