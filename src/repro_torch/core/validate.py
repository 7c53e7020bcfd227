"""Structural validation of the packed layouts, before any kernel sees them.

Every invariant the sparse executors rely on is checked here.  The pack
path (``kernels.ops.pack`` / ``pack_taps``) builds layouts that satisfy
all of them; this module exists for layouts that arrive from outside the
process (the artifact store, ``serve.artifacts``) or are corrupted after
packing.  On the card an out-of-range ``k_idx`` is an illegal address, not
a wrong number, so a bad layout raises a structured ``LayoutError`` and
never reaches a launch.

Taxonomy (one subclass per failure class, ``code`` is the stable tag,
the reference's):

  ``LayoutStructureError``    bin tuples inconsistent, leaf shape/dtype or
                              stack-dim mismatches (a shard axis missing),
                              missing leaves
  ``LayoutGeometryError``     block does not divide shape, bin sizes do
                              not tile the column axis, bad group size,
                              a shard count that does not divide it
  ``LayoutIndexError``        ``k_idx``/``t_idx``/``alive`` out of range
  ``LayoutCountError``        ``nnz`` exceeds its bin's padded degree
  ``LayoutPermutationError``  ``perm``/``inv_perm`` not mutually inverse
                              (across shards too), or absent on a
                              sharded layout
  ``LayoutAuxError``          ``conv_taps``/``k_full`` inconsistent with
                              the geometry
  ``LayoutQuantError``        int values without ``scales`` (or scales on
                              float values), bad scale bins, negative or
                              non-finite scales
  ``LayoutNumericsError``     NaN/Inf in a float ``values`` bin

Layouts live on the card.  Only the small integer leaves (``k_idx``,
``t_idx``, ``nnz``, ``perm``, ``inv_perm``, ``alive``, ``k_full``) are
copied to the host and checked there with numpy, as the reference checks
them; the value and scale bins stay on their own device, each checked by
one ``torch.isfinite(...).all()`` read a bin.

``validate_layout`` checks one layout; ``validate_tree`` walks an
exec-param tree and checks every ``"packed"`` entry (``DegradedLayer``
markers are skipped: they carry no leaves).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.packed import (DegradedLayer, PackedLayout, TapLayout,
                                     dtype_name)


class LayoutError(ValueError):
    """Base of the taxonomy: the failure class (``code``), the offending
    ``field``, the degree ``bin`` when the failure is per bin, and the
    layer ``path`` when validated out of a tree."""

    code = "invalid"

    def __init__(self, detail, *, field=None, bin=None, path=None):
        self.detail = detail
        self.field = field
        self.bin = bin
        self.path = path
        where = field or "?"
        if bin is not None:
            where += f"[bin {bin}]"
        prefix = f"{path}: " if path else ""
        super().__init__(f"{prefix}[{self.code}] {where}: {detail}")


class LayoutStructureError(LayoutError):
    """Bin tuples / leaf shapes / stack dims are inconsistent."""

    code = "structure"


class LayoutGeometryError(LayoutError):
    """Block or group does not tile the declared dense shape."""

    code = "geometry"


class LayoutIndexError(LayoutError):
    """An index leaf points outside its addressable range."""

    code = "index_range"


class LayoutCountError(LayoutError):
    """``nnz`` exceeds its bin's padded degree or the physical max."""

    code = "count"


class LayoutPermutationError(LayoutError):
    """``perm``/``inv_perm`` are not mutually inverse permutations."""

    code = "permutation"


class LayoutAuxError(LayoutError):
    """Static aux (``conv_taps``/``k_full``) disagrees with geometry."""

    code = "aux"


class LayoutQuantError(LayoutError):
    """Quantized values and their ``scales`` leaves disagree."""

    code = "quant"


class LayoutNumericsError(LayoutError):
    """A float ``values`` bin carries NaN/Inf entries."""

    code = "non_finite"


def _as_host(x):
    """An integer leaf copied off the card as a numpy array."""
    return x.detach().cpu().numpy()


def _is_int(x) -> bool:
    return not (x.dtype.is_floating_point or x.dtype.is_complex
                or x.dtype == torch.bool)


def _check_perm_pair(perm, inv_perm, n, path):
    """perm/inv_perm: both absent, or mutually inverse permutations of
    ``range(n)`` on the trailing axis (leading stack dims allowed)."""
    if perm is None and inv_perm is None:
        return
    if perm is None or inv_perm is None:
        missing = "perm" if perm is None else "inv_perm"
        raise LayoutPermutationError(
            f"{missing} is None while its partner is present",
            field=missing, path=path)
    p = _as_host(perm)
    ip = _as_host(inv_perm)
    for name, a in (("perm", p), ("inv_perm", ip)):
        if a.shape[-1] != n:
            raise LayoutStructureError(
                f"trailing axis {a.shape[-1]} != {n} columns",
                field=name, path=path)
        if not np.issubdtype(a.dtype, np.integer):
            raise LayoutStructureError(
                f"dtype {a.dtype} is not integral", field=name, path=path)
    p2 = p.reshape(-1, n)
    ip2 = ip.reshape(-1, n)
    if p2.shape != ip2.shape:
        raise LayoutStructureError(
            f"perm stack dims {p.shape[:-1]} != inv_perm {ip.shape[:-1]}",
            field="inv_perm", path=path)
    ar = np.arange(n)
    if not (np.all(np.sort(p2, axis=1) == ar)
            and np.all(np.sort(ip2, axis=1) == ar)):
        raise LayoutPermutationError(
            f"not a permutation of range({n})", field="perm", path=path)
    if not np.all(np.take_along_axis(ip2, p2, axis=1) == ar):
        raise LayoutPermutationError(
            "inv_perm[perm] != identity (perm and inv_perm are not "
            "inverses)", field="inv_perm", path=path)


def _check_nnz(nnz, bin_bounds, bin_degrees, n_cols, hard_max, path):
    """nnz: int leaf, trailing axis ``n_cols`` in LAYOUT order, every true
    degree within [0, hard_max] and <= its own bin's padded degree."""
    a = _as_host(nnz)
    if not np.issubdtype(a.dtype, np.integer):
        raise LayoutStructureError(
            f"dtype {a.dtype} is not integral", field="nnz", path=path)
    if a.shape[-1] != n_cols:
        raise LayoutStructureError(
            f"trailing axis {a.shape[-1]} != {n_cols} columns",
            field="nnz", path=path)
    flat = a.reshape(-1, n_cols)
    if flat.size and int(flat.min()) < 0:
        raise LayoutCountError("negative degree", field="nnz", path=path)
    if flat.size and int(flat.max()) > hard_max:
        raise LayoutCountError(
            f"degree {int(flat.max())} exceeds physical max {hard_max}",
            field="nnz", path=path)
    for b, ((s, e), Lb) in enumerate(zip(bin_bounds, bin_degrees)):
        seg = flat[:, s:e]
        if seg.size and int(seg.max()) > Lb:
            raise LayoutCountError(
                f"true degree {int(seg.max())} exceeds the bin's padded "
                f"degree L={Lb} (bins swapped or padded arrays "
                "truncated?)", field="nnz", bin=b, path=path)


def _bounds_of(sizes):
    out, start = [], 0
    for s in sizes:
        out.append((start, start + s))
        start += s
    return out


def _check_scales(layout, allowed_shapes, path):
    """Integer values and ``scales`` come together; per bin the scale leaf
    is float, of one of the ``allowed_shapes(bin)`` forms (the rank is the
    granularity, ``core.quant``), finite and non-negative: both read on
    the scale's own device in one host read."""
    int_values = any(_is_int(v) for v in layout.values)
    if layout.scales is None:
        if int_values:
            raise LayoutQuantError(
                "integer values without scales (quantized layout missing "
                "its dequantization leaves)", field="scales", path=path)
        return
    if not int_values:
        raise LayoutQuantError(
            f"scales present on {dtype_name(layout.values[0])} "
            "values (only int values are quantized)", field="scales",
            path=path)
    if len(layout.scales) != len(layout.values):
        raise LayoutQuantError(
            f"{len(layout.scales)} scale bin(s) vs "
            f"{len(layout.values)} value bin(s)", field="scales", path=path)
    for b, s in enumerate(layout.scales):
        if not s.dtype.is_floating_point:
            raise LayoutQuantError(
                f"dtype {dtype_name(s)} is not floating", field="scales",
                bin=b, path=path)
        if tuple(s.shape) not in allowed_shapes(b):
            raise LayoutQuantError(
                f"shape {tuple(s.shape)} is none of the granularity "
                f"forms {allowed_shapes(b)}", field="scales", bin=b,
                path=path)
        if not s.numel():
            continue
        finite, non_neg = torch.stack(
            [torch.isfinite(s).all(), (s >= 0).all()]).tolist()
        if not finite:
            raise LayoutQuantError(
                "non-finite scale entries", field="scales", bin=b,
                path=path)
        if not non_neg:
            raise LayoutQuantError(
                f"negative scale {float(s.min())}", field="scales", bin=b,
                path=path)


def _check_values_finite(layout, path):
    """Every FLOAT ``values`` bin must be fully finite (integer bins are
    covered by the scale checks: int8 cannot encode a non-finite).  One
    ``isfinite(...).all()`` on the bin's own device; the count of bad
    entries is read only for the error."""
    for b, v in enumerate(layout.values):
        if _is_int(v):
            continue
        if v.numel() and not bool(torch.isfinite(v).all()):
            bad = int((~torch.isfinite(v)).sum())
            raise LayoutNumericsError(
                f"{bad} non-finite value entr{'y' if bad == 1 else 'ies'}",
                field="values", bin=b, path=path)


def _check_sharded(layout, n_cols, n_cols_name, path):
    """Cross-shard invariants of a layout with ``n_shards`` = S > 0: S
    tiles the column axis; ``nnz`` and ``perm`` end in the (S, cols / S)
    shard axes; ``perm`` and ``inv_perm`` are present (``merge_shards``
    gathers through them; the caller checks that ``perm`` flattened is a
    permutation, so no shard claims another's column).  Returns the
    columns per shard."""
    S = layout.n_shards
    if S < 1 or n_cols % S:
        raise LayoutGeometryError(
            f"n_shards={S} does not divide {n_cols_name}={n_cols}",
            field="n_shards", path=path)
    per = n_cols // S
    a = layout.nnz
    if a.ndim < 2 or tuple(a.shape[-2:]) != (S, per):
        raise LayoutStructureError(
            f"nnz shape {tuple(a.shape)} does not end in the shard axes "
            f"(S={S}, {n_cols_name}/S={per})", field="nnz", path=path)
    if layout.perm is None or layout.inv_perm is None:
        raise LayoutPermutationError(
            "sharded layout requires perm/inv_perm (merge_shards gathers "
            "through them)", field="perm", path=path)
    p = layout.perm
    if p.ndim < 2 or tuple(p.shape[-2:]) != (S, per):
        raise LayoutStructureError(
            f"perm shape {tuple(p.shape)} does not end in the shard axes "
            f"(S={S}, {n_cols_name}/S={per})", field="perm", path=path)
    return per


def _check_shard_perm(layout, n, path):
    """perm/inv_perm of a layout; a sharded ``perm`` (..., S, n / S) is
    checked with its shard axes flattened against the flat ``inv_perm``."""
    perm = layout.perm
    if layout.n_shards:
        perm = perm.reshape(tuple(perm.shape[:-2]) + (n,))
    _check_perm_pair(perm, layout.inv_perm, n, path)


def _validate_packed(layout: PackedLayout, path):
    bk, bn = layout.block
    K, N = layout.shape
    S = layout.n_shards
    if bk <= 0 or bn <= 0 or K <= 0 or N <= 0:
        raise LayoutGeometryError(
            f"non-positive geometry block={layout.block} "
            f"shape={layout.shape}", field="block", path=path)
    if K % bk or N % bn:
        raise LayoutGeometryError(
            f"block {layout.block} does not divide shape {layout.shape}",
            field="block", path=path)
    Kb, Nb = K // bk, N // bn
    cols = _check_sharded(layout, Nb, "Nb", path) if S else Nb
    if not layout.values or len(layout.values) != len(layout.k_idx):
        raise LayoutStructureError(
            f"{len(layout.values)} value bin(s) vs "
            f"{len(layout.k_idx)} k_idx bin(s)", field="values", path=path)
    lead = tuple(layout.values[0].shape[:-4])
    for b, (v, k) in enumerate(zip(layout.values, layout.k_idx)):
        vs, ks = tuple(v.shape), tuple(k.shape)
        if len(vs) < 4 or vs[-2:] != (bk, bn):
            raise LayoutStructureError(
                f"values shape {vs} does not end in block {(bk, bn)}",
                field="values", bin=b, path=path)
        if S and (len(vs) < 5 or vs[-5] != S):
            raise LayoutStructureError(
                f"values shape {vs} lacks the shard axis S={S} before the "
                f"per-bin (nb_b, L_b, bk, bn) dims", field="values", bin=b,
                path=path)
        if vs[:-4] != lead:
            raise LayoutStructureError(
                f"stack dims {vs[:-4]} != bin-0 stack dims {lead}",
                field="values", bin=b, path=path)
        if ks != vs[:-2]:
            raise LayoutStructureError(
                f"k_idx shape {ks} != values slot shape {vs[:-2]}",
                field="k_idx", bin=b, path=path)
        ka = _as_host(k)
        if not np.issubdtype(ka.dtype, np.integer):
            raise LayoutStructureError(
                f"dtype {ka.dtype} is not integral", field="k_idx", bin=b,
                path=path)
        if ka.size and (int(ka.min()) < 0 or int(ka.max()) >= Kb):
            raise LayoutIndexError(
                f"k_idx range [{int(ka.min())}, {int(ka.max())}] outside "
                f"[0, Kb={Kb})", field="k_idx", bin=b, path=path)
    if sum(layout.bin_sizes) != cols:
        raise LayoutGeometryError(
            f"bin sizes {layout.bin_sizes} sum to {sum(layout.bin_sizes)}, "
            f"not {'Nb/S' if S else 'Nb'}={cols}", field="values", path=path)
    _check_nnz(layout.nnz, _bounds_of(layout.bin_sizes),
               layout.bin_degrees, cols, Kb, path)
    _check_shard_perm(layout, Nb, path)
    if layout.conv_taps is not None:
        _check_conv_taps(layout.conv_taps, Kb, bk, path)
    # quantization: "block" granularity = one scale per stored block
    # (values shape minus the (bk, bn) block), "out" = one per block
    # column (additionally minus the degree axis)
    _check_scales(
        layout,
        lambda b: (tuple(layout.values[b].shape[:-2]),
                   tuple(layout.values[b].shape[:-3])),
        path)
    _check_values_finite(layout, path)


def _check_conv_taps(conv_taps, Kb, bk, path):
    """conv_taps must be exactly the ``core.bcs.conv_tap_table`` of SOME
    (kh, kw, C) geometry with Kb blocks of bk rows: reconstruct the
    implied geometry and compare table for table."""
    from repro_torch.core import bcs as BCS

    if len(conv_taps) != Kb:
        raise LayoutAuxError(
            f"{len(conv_taps)} tap entries for Kb={Kb} K-blocks",
            field="conv_taps", path=path)
    try:
        triples = [(int(dy), int(dx), int(c0)) for dy, dx, c0 in conv_taps]
    except (TypeError, ValueError) as e:
        raise LayoutAuxError(f"entries are not (dy, dx, c0) triples: {e}",
                             field="conv_taps", path=path) from e
    # channel count implied by how many K-blocks share tap (0, 0)
    c_blocks = sum(1 for dy, dx, _ in triples if (dy, dx) == (0, 0))
    kh = max(dy for dy, _, _ in triples) + 1
    kw = max(dx for _, dx, _ in triples) + 1
    C = c_blocks * bk
    if C == 0 or Kb * bk != kh * kw * C:
        raise LayoutAuxError(
            f"implied geometry (kh={kh}, kw={kw}, C={C}) does not tile "
            f"K={Kb * bk}", field="conv_taps", path=path)
    expect = BCS.conv_tap_table(kh, kw, C, bk)
    if tuple(triples) != expect:
        raise LayoutAuxError(
            f"table is not conv_tap_table(kh={kh}, kw={kw}, C={C}, "
            f"bk={bk})", field="conv_taps", path=path)


def _validate_tap(layout: TapLayout, path):
    K, P = layout.shape
    group = layout.group
    if group <= 0 or K <= 0 or P <= 0:
        raise LayoutGeometryError(
            f"non-positive geometry group={group} shape={layout.shape}",
            field="group", path=path)
    if P % group:
        raise LayoutGeometryError(
            f"group {group} does not divide P={P}", field="group",
            path=path)
    G = P // group
    S = layout.n_shards
    cols = _check_sharded(layout, G, "G", path) if S else G
    if not layout.values or len(layout.values) != len(layout.t_idx):
        raise LayoutStructureError(
            f"{len(layout.values)} value bin(s) vs "
            f"{len(layout.t_idx)} t_idx bin(s)", field="values", path=path)
    if layout.k_full is not None and len(layout.k_full) != len(layout.values):
        raise LayoutStructureError(
            f"{len(layout.k_full)} k_full bin(s) vs "
            f"{len(layout.values)} value bin(s)", field="k_full", path=path)
    alive = _as_host(layout.alive)
    if alive.ndim != 1 or alive.size == 0:
        raise LayoutStructureError(
            f"alive must be a non-empty 1-D index, got shape "
            f"{alive.shape}", field="alive", path=path)
    if not np.issubdtype(alive.dtype, np.integer):
        raise LayoutStructureError(
            f"dtype {alive.dtype} is not integral", field="alive",
            path=path)
    if int(alive.min()) < 0 or int(alive.max()) >= K:
        raise LayoutIndexError(
            f"alive range [{int(alive.min())}, {int(alive.max())}] "
            f"outside [0, K={K})", field="alive", path=path)
    if alive.size > 1 and not np.all(np.diff(alive) > 0):
        raise LayoutIndexError(
            "alive rows are not strictly increasing (band gather order "
            "broken)", field="alive", path=path)
    R = alive.size
    for b, (v, t) in enumerate(zip(layout.values, layout.t_idx)):
        vs, ts = tuple(v.shape), tuple(t.shape)
        if len(vs) != (4 if S else 3) or vs[-1] != group:
            raise LayoutStructureError(
                f"values shape {vs} is not "
                f"{'(S, G_b, L_b, group)' if S else '(G_b, L_b, group)'} "
                f"with group={group}", field="values", bin=b, path=path)
        if S and vs[0] != S:
            raise LayoutStructureError(
                f"values shape {vs} leading shard axis != S={S}",
                field="values", bin=b, path=path)
        if ts != vs[:-1]:
            raise LayoutStructureError(
                f"t_idx shape {ts} != values slot shape {vs[:-1]}",
                field="t_idx", bin=b, path=path)
        ta = _as_host(t)
        if not np.issubdtype(ta.dtype, np.integer):
            raise LayoutStructureError(
                f"dtype {ta.dtype} is not integral", field="t_idx", bin=b,
                path=path)
        if ta.size and (int(ta.min()) < 0 or int(ta.max()) >= R):
            raise LayoutIndexError(
                f"t_idx range [{int(ta.min())}, {int(ta.max())}] outside "
                f"the alive band [0, {R})", field="t_idx", bin=b, path=path)
        if layout.k_full is not None:
            kf = _as_host(layout.k_full[b])
            if kf.shape != ta.shape:
                raise LayoutStructureError(
                    f"k_full shape {kf.shape} != t_idx shape {ta.shape}",
                    field="k_full", bin=b, path=path)
            if not np.array_equal(kf, alive[ta]):
                raise LayoutAuxError(
                    "k_full != alive[t_idx] (precomputed full-band rows "
                    "disagree with the alive gather)", field="k_full",
                    bin=b, path=path)
    if sum(layout.bin_sizes) != cols:
        raise LayoutGeometryError(
            f"bin sizes {layout.bin_sizes} sum to {sum(layout.bin_sizes)}, "
            f"not {'G/S' if S else 'G'}={cols}", field="values", path=path)
    _check_nnz(layout.nnz, _bounds_of(layout.bin_sizes),
               layout.bin_degrees, cols, R, path)
    _check_shard_perm(layout, G, path)
    # quantization: "block" granularity = one scale per tap slot (..., G_b,
    # L_b); "out" = one per filter in the broadcastable (..., G_b, 1,
    # group), the shard axis leading on a sharded layout
    _check_scales(
        layout,
        lambda b: (tuple(layout.values[b].shape[:-1]),
                   tuple(layout.values[b].shape[:-2]) + (1, group)),
        path)
    _check_values_finite(layout, path)


def validate_layout(layout, *, path=None):
    """Check every structural invariant of one layout; raise the matching
    ``LayoutError`` subclass on the first violation.  ``path`` tags errors
    with the layer the layout belongs to.  Returns the layout."""
    if isinstance(layout, PackedLayout):
        _validate_packed(layout, path)
    elif isinstance(layout, TapLayout):
        _validate_tap(layout, path)
    else:
        raise LayoutStructureError(
            f"not a PackedLayout/TapLayout: {type(layout).__name__}",
            field="layout", path=path)
    return layout


def validate_tree(exec_params) -> int:
    """Validate every ``"packed"`` entry of an exec-param tree.  Returns
    the number of layouts checked; raises the first violation's
    ``LayoutError`` (tagged with the layer path).  ``DegradedLayer``
    markers are skipped."""
    count = 0

    def _walk(node, path):
        nonlocal count
        if not isinstance(node, dict):
            return
        packed = node.get("packed")
        if packed is not None and not isinstance(packed,
                                                 (dict, DegradedLayer)):
            validate_layout(packed, path=f"{path}/packed" if path
                            else "packed")
            count += 1
        for k, v in node.items():
            if k != "packed":
                _walk(v, f"{path}/{k}" if path else k)

    _walk(exec_params, "")
    return count
