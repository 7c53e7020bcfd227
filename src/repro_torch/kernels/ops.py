"""Dispatch over the sparse executor paths, and the host-side packing step.

``sparse_linear`` picks the execution strategy the compiler would emit for
a pruned layer:
  PackedLayout         -> the BCS kernel (skips pruned blocks; ragged M is
                          masked inside the kernel, so the packed path never
                          falls back to dense)
  dense weight (+mask) -> masked-dense plain version
``sparse_expert_linear`` runs an MoE expert stack's projections in one
launch of the same kernel.
``sparse_conv2d`` runs a block-punched conv through the BCS conv kernel
(over im2col patches, or implicit: staged from the image in the kernel)
and ``sparse_conv2d_pattern`` a pattern/connectivity conv through the
tap-gather kernels.  ``pack`` / ``pack_taps`` build the layouts, float
or int8 with fp32 scales (``core.quant``), unsharded or tensor parallel
(``n_shards``); every path above runs either, the kernels dequantizing on
the card.  A sharded conv layout runs materialized (im2col, then kernel 1
or 2), as the reference's does; an expert stack is never column-sharded.

``pack`` and ``pack_taps`` memoize their layouts in a content-keyed LRU
cache (the reference's, ``repro/kernels/ops.py:92-178``): the key is a
digest of every byte of the weight and the mask, computed on their own
device (``_digest``), and of every knob that changes the layout, the
device included; a hit hands back the same frozen layout object.  Bounds
(``configure_pack_cache``, ``REPRO_PACK_CACHE_MAX{,_BYTES}``, 256 entries
and 256 MiB by default), one log line per eviction, lifetime counters in
``pack_cache_stats``.

On a mesh (``distributed.sharding``) x may be a placed ``DTensor`` and the
layout placed too: ``sparse_linear`` gathers x's features to every rank of
the layout's model axis (its batch rows stay where they are), runs the
rank's local launch (one per rank, plus one model-axis gather for a
column-sharded layout, ``bsr_matmul_sharded``) and places the result
like x; ``sparse_expert_linear`` runs each rank's local experts.
"""
from __future__ import annotations

import dataclasses
import logging
import os
from collections import OrderedDict

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.core import bcs as BCS
from repro_torch.core import quant as QUANT
from repro_torch.core.packed import PackedLayout, TapLayout
from repro_torch.distributed import sharding as SH
from repro_torch.kernels import ref
from repro_torch.kernels.bsr_matmul import (bsr_conv2d_implicit,
                                            bsr_conv2d_patches,
                                            bsr_matmul_packed, conv_geometry,
                                            local_layout, pad_image,
                                            placed_layout,
                                            tap_gather_conv_implicit,
                                            tap_gather_conv_packed)
from repro_torch.models import module as M

# Auto-selection of the implicit conv mode.  The reference picks it only
# for a patch tensor of at least 1 MiB and an image that fits one TPU core's
# fast memory.  On an H100 (``chip_smoke.py``'s floor sweep, VGG_TINY c2 and
# c3 under both mappings at B = 1, 4, 16, 64, patches of 0.28-36 MiB, and
# its per-layer rows at B = 256; PERF.md) the implicit kernels beat
# im2col + the same kernel (BCS) or + kernel 2 (tap) at every 3x3 and 5x5
# shape measured, the least margin 1.4x (BCS, B = 1): the kernels stage
# the image tile themselves, so the patch's bytes are never worth moving.
# So the port has no floor and no image cap: every conv with kh*kw > 1
# runs implicit.  A 1x1 conv (no patch blow-up) stays on the materialized
# route as in the reference; on the card both routes of a 1x1 run the same
# kernel (3 or 4): on the image, or on the patch matrix or alive band read
# as a 1 x M image.


_log = logging.getLogger("repro_torch.kernels.ops")

_PACK_CACHE: OrderedDict = OrderedDict()
# entry cap and byte bound (every tensor leaf of the held layouts), evicted
# LRU, as the reference's; configurable by ``configure_pack_cache`` or the
# REPRO_PACK_CACHE_MAX{,_BYTES} environment variables
_PACK_CACHE_MAX = int(os.environ.get("REPRO_PACK_CACHE_MAX", "256"))
_PACK_CACHE_MAX_BYTES = int(
    os.environ.get("REPRO_PACK_CACHE_MAX_BYTES", str(256 << 20)))
_PACK_CACHE_BYTES = 0
_PACK_CACHE_STATS = {"hits": 0, "misses": 0, "evictions": 0}


def configure_pack_cache(max_entries=None, max_bytes=None) -> dict:
    """Set the pack cache's bounds (None keeps one), evicting down to them
    at once.  Returns the bounds merged with ``pack_cache_stats()``."""
    global _PACK_CACHE_MAX, _PACK_CACHE_MAX_BYTES
    if max_entries is not None:
        _PACK_CACHE_MAX = max(1, int(max_entries))
    if max_bytes is not None:
        _PACK_CACHE_MAX_BYTES = max(1, int(max_bytes))
    _evict_to_bounds()
    return {"max_entries": _PACK_CACHE_MAX,
            "max_bytes": _PACK_CACHE_MAX_BYTES, **pack_cache_stats()}


def pack_cache_stats() -> dict:
    """Occupancy (entries, bytes) and the lifetime hit, miss and eviction
    counters."""
    return {"entries": len(_PACK_CACHE), "bytes": _PACK_CACHE_BYTES,
            **_PACK_CACHE_STATS}


def clear_pack_cache():
    """Drop every held layout (the counters keep counting)."""
    global _PACK_CACHE_BYTES
    _PACK_CACHE.clear()
    _PACK_CACHE_BYTES = 0


def _evict_to_bounds():
    """Evict least recently used entries past the bounds (the newest one
    always stays), one log line each."""
    global _PACK_CACHE_BYTES
    while (len(_PACK_CACHE) > _PACK_CACHE_MAX
           or _PACK_CACHE_BYTES > _PACK_CACHE_MAX_BYTES) \
            and len(_PACK_CACHE) > 1:
        key, evicted = _PACK_CACHE.popitem(last=False)
        eb = M.tree_bytes(evicted)
        _PACK_CACHE_BYTES -= eb
        _PACK_CACHE_STATS["evictions"] += 1
        _log.info(
            "pack cache evict %s... (%.1f KiB) -> %d entr%s / %.1f MiB "
            "held (caps: %d entries / %.0f MiB)", key[:12], eb / 1024,
            len(_PACK_CACHE), "y" if len(_PACK_CACHE) == 1 else "ies",
            _PACK_CACHE_BYTES / 2**20, _PACK_CACHE_MAX,
            _PACK_CACHE_MAX_BYTES / 2**20)


def _cache_put(key, out):
    global _PACK_CACHE_BYTES
    _PACK_CACHE[key] = out
    _PACK_CACHE_BYTES += M.tree_bytes(out)
    _PACK_CACHE_STATS["misses"] += 1
    _evict_to_bounds()


def _cache_get(key):
    out = _PACK_CACHE.get(key)
    if out is not None:
        _PACK_CACHE.move_to_end(key)
        _PACK_CACHE_STATS["hits"] += 1
    return out


# the digest's rows of 32-bit words (see ``_lanes``)
_DIGEST_ROW = 4096
_DIGEST_CHUNK = 1024             # rows a pass (bounds the int64 temporaries)
_GAMMA = 0x9E3779B97F4A7C15
_DIGEST_KEYS: dict = {}


def _s64(v):
    """A 64-bit constant as the signed int64 torch holds."""
    return v - (1 << 64) if v >= 1 << 63 else v


def _splitmix64(seed, n, device):
    """(n,) int64: outputs 1..n of splitmix64 from ``seed`` (int64 ops wrap
    modulo 2**64; logical shifts masked out of arithmetic ones)."""
    z = (torch.arange(1, n + 1, dtype=torch.int64, device=device)
         * _s64(_GAMMA) + _s64(seed))
    z = (z ^ ((z >> 30) & ((1 << 34) - 1))) * _s64(0xBF58476D1CE4E5B9)
    z = (z ^ ((z >> 27) & ((1 << 37) - 1))) * _s64(0x94D049BB133111EB)
    return z ^ ((z >> 31) & ((1 << 33) - 1))


def _digest_keys(device, rows):
    """(word keys (2, _DIGEST_ROW), row keys (rows, 2, 2), final keys
    (2,)) of both lanes on ``device``, made once a device and grown (by
    doubling) as longer tensors come: key r never depends on the count."""
    keys = _DIGEST_KEYS.get(device)
    if keys is None or keys[1].shape[0] < rows:
        cap = max(rows, 1 << 10, 0 if keys is None else
                  2 * keys[1].shape[0])
        word = torch.stack([_splitmix64(seed, _DIGEST_ROW, device)
                            for seed in (1, 2)])
        row = torch.stack([_splitmix64(seed, 2 * cap, device)
                           for seed in (3, 4)], dim=1).reshape(cap, 2, 2)
        final = torch.stack([_splitmix64(seed, 1, device)[0]
                             for seed in (5, 6)])
        keys = _DIGEST_KEYS[device] = (word, row, final)
    return keys[0], keys[1][:rows], keys[2]


def _lanes(t):
    """(2,) int64 on ``t``'s device: the two lanes' digests (top 32 bits)
    of every byte of ``t``, read once, in passes of ``_DIGEST_CHUNK`` rows
    of ``_DIGEST_ROW`` 32-bit words; a last partial row is zero-padded
    (the byte length is in the key).

    Each lane is two-level multilinear hashing with 64-bit keys, each
    level keeping the top 32 bits of its sum modulo 2**64 (Lemire and
    Kaser's MULTILINEAR): level 1 hashes each row with the word keys and
    an additive key of its own, level 2 the row hashes with row keys and
    an additive key.  Collision bound: for two different byte strings of
    one length a level collides with probability at most 2**-32 over
    random keys, so a lane at most 2**-31 and the two independent lanes
    at most 2**-62.  The keys are fixed splitmix64 streams standing in
    for random ones: the bound holds for contents not built against
    them."""
    b = t.detach().contiguous().reshape(-1).view(torch.uint8)
    if b.data_ptr() % 4:
        b = b.clone()                          # an unaligned storage
    row = 4 * _DIGEST_ROW
    full = b.numel() // row * row
    parts = list(b[:full].view(torch.int32).view(-1, _DIGEST_ROW).split(
        _DIGEST_CHUNK))
    if full < b.numel():
        tail = torch.cat([b[full:], b.new_zeros(row - (b.numel() - full))])
        parts.append(tail.view(torch.int32).view(1, _DIGEST_ROW))
    rows = sum(x.shape[0] for x in parts)
    keys, row_keys, final = _digest_keys(b.device, rows)
    level1, r0 = [], 0
    for x in parts:
        s = (x.to(torch.int64)[:, None, :] * keys).sum(dim=-1)   # (r, 2)
        level1.append(s + row_keys[r0:r0 + x.shape[0], :, 0])
        r0 += x.shape[0]
    g = torch.cat(level1) >> 32                                  # (rows, 2)
    return ((g * row_keys[:, :, 1]).sum(dim=0) + final) >> 32


def _digest(w, mask, block, reorder, n_bins, kind="bcs", conv=None,
            quant=None, n_shards=0) -> str:
    """The cache key of a pack: the reference's knobs (kind, shape, dtype,
    block, reorder, n_bins, conv, quant, n_shards), the device and the
    mask's shape and dtype, and the digest of every byte of ``w`` and
    ``mask`` computed on their device (``_lanes``); only the four 32-bit
    lane values cross to the host."""
    mask = torch.as_tensor(mask, device=w.device)
    lanes = torch.cat([_lanes(w), _lanes(mask)]).tolist()
    knobs = (kind, tuple(w.shape), str(w.dtype), tuple(block),
             bool(reorder), int(n_bins), conv, quant, int(n_shards),
             str(w.device), tuple(mask.shape), str(mask.dtype))
    return "".join(f"{v & 0xFFFFFFFF:08x}" for v in lanes) + repr(knobs)


def _quant_spec(value_dtype, scale_granularity):
    """(value_dtype, scale_granularity) as the key holds it: None for a
    float pack."""
    if value_dtype is None:
        return None
    return (str(value_dtype), str(scale_granularity))


def pack(w, mask, block=(128, 128), *, reorder=False, n_bins=4, conv=None,
         value_dtype=None, scale_granularity="block",
         n_shards=0, use_cache=True) -> PackedLayout:
    """Pack a pruned (K, N) weight into the kernel layout on its device.
    With ``reorder`` the block columns are degree-sorted and split into
    ``n_bins`` bins (``core.bcs.pack_csc_reordered``); without it the layout
    is one bin in original column order.  ``conv=(kh, kw, cin)`` marks an
    im2col-lowered conv weight and attaches its ``conv_taps`` table.
    ``value_dtype="int8"`` quantizes the packed values at
    ``scale_granularity`` ("block" or "out"), as the reference's
    ``ops.pack`` does: the float pack first, then ``core.quant``.
    ``n_shards`` > 0 packs the tensor-parallel layout (degree-balanced
    column shards, ``core.bcs.shard_columns``), which implies the
    degree-sorted producer whatever ``reorder`` says.  ``use_cache``
    looks the pack up in (and adds it to) the pack cache; a quantized
    pack caches its float layout first, then itself under its own
    key."""
    key = (_digest(w, mask, block, reorder, n_bins, conv=conv,
                   quant=_quant_spec(value_dtype, scale_granularity),
                   n_shards=n_shards) if use_cache else None)
    if key is not None and (hit := _cache_get(key)) is not None:
        return hit
    if value_dtype is not None:
        out = QUANT.quantize_layout(
            pack(w, mask, block, reorder=reorder, n_bins=n_bins, conv=conv,
                 n_shards=n_shards, use_cache=use_cache),
            value_dtype=value_dtype, scale_granularity=scale_granularity)
    elif reorder or n_shards:
        out = BCS.pack_csc_reordered(w, mask, block, n_bins=n_bins,
                                     n_shards=n_shards)
    else:
        values, k_idx, nnz, _ = BCS.pack_csc(w, mask, block)
        out = PackedLayout(values=(values,), k_idx=(k_idx,), nnz=nnz,
                           block=tuple(block), shape=tuple(w.shape))
    if conv is not None and out.conv_taps is None:
        kh, kw, cin = conv
        out = dataclasses.replace(
            out, conv_taps=BCS.conv_tap_table(kh, kw, cin, block[0]))
    if key is not None:
        _cache_put(key, out)
    return out


def pack_taps(w, mask, *, group=1, reorder=True, n_bins=8,
              value_dtype=None, scale_granularity="block",
              n_shards=0, use_cache=True) -> TapLayout:
    """Pack a pattern/connectivity-pruned (P, Q, Kh, Kw) conv weight into
    the tap-gather layout (``core.bcs.pattern_lower``), degree-sorted into
    ``n_bins`` bins when ``reorder`` is set.  ``value_dtype="int8"``
    quantizes the tap values (``core.quant``); "out" (a scale per filter)
    suits group = 1 layouts, where a per-slot scale costs 4 bytes per
    stored value.  ``n_shards`` > 0 packs the tensor-parallel layout
    (degree-balanced filter-group shards; implies ``reorder``).
    ``use_cache`` as ``pack``'s (the layout kind is in the key, so a tap
    and a block layout of the same weights never collide)."""
    key = (_digest(w, mask, (1, int(group)), reorder, n_bins, kind="taps",
                   quant=_quant_spec(value_dtype, scale_granularity),
                   n_shards=n_shards) if use_cache else None)
    if key is not None and (hit := _cache_get(key)) is not None:
        return hit
    if value_dtype is not None:
        out = QUANT.quantize_layout(
            pack_taps(w, mask, group=group, reorder=reorder, n_bins=n_bins,
                      n_shards=n_shards, use_cache=use_cache),
            value_dtype=value_dtype, scale_granularity=scale_granularity)
    else:
        out = BCS.pattern_lower(w, mask, group=group, n_bins=n_bins,
                                reorder=reorder or bool(n_shards),
                                n_shards=n_shards)
    if key is not None:
        _cache_put(key, out)
    return out


def _on_mesh(fn, x, packed, placement):
    """``fn(local x)`` for a placed x: x redistributed to
    ``placement(mesh dim, x's placement there, the layout's model mesh
    dim)`` on each mesh dim, the rank's local tensor run, its result
    placed the same way."""
    mesh = x.device_mesh
    mdim = local_layout(packed)[2] if placed_layout(packed) else None
    want = tuple(placement(i, pl, mdim) for i, pl in enumerate(x.placements))
    xl = x.redistribute(mesh, want).to_local()
    return DTensor.from_local(fn(xl), mesh, want, run_check=False)


def sparse_linear(x, packed: PackedLayout | None = None, w=None, mask=None,
                  bias=None, act="none"):
    """x (..., K) -> (..., N) through whichever path applies.  With
    ``packed`` the BCS kernel always runs (one launch over all bins).  A
    placed x keeps its batch rows (dim 0) sharded over any mesh dim but
    the layout's model axis and is gathered over the rest."""
    if packed is not None and SH.is_placed(x):
        bias = SH.full(bias)
        return _on_mesh(
            lambda xl: sparse_linear(xl, packed, bias=bias, act=act), x,
            packed, lambda i, pl, mdim: pl if i != mdim and pl.is_shard(0)
            else Replicate())
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if packed is not None:
        y = bsr_matmul_packed(x2, packed, bias=bias, act=act)
    else:
        y = ref.masked_matmul_ref(
            x2, w, mask if mask is not None else w.new_ones(()),
            bias=bias, act=act)
    return y.reshape(*lead, y.shape[-1])


def sparse_expert_linear(x, packed: PackedLayout, bias=None, act="none"):
    """Batched per-expert sparse GEMM: x (E, M, K) -> (E, M, N).

    ``packed`` carries a leading expert axis on every leaf (values
    (E, nb_b, L_b, bk, bn), perm (E, Nb), ...), as ``serve.compile``
    packs MoE expert weights; bias None or (E, N).  One kernel launch
    covers every expert and every degree bin (the expert is a grid axis
    of the kernel, not a loop here); the plain version for CPU tensors
    runs expert by expert.  An expert stack is never column-sharded
    (``serve.compile`` exempts ``moe/`` paths from ``CompileSpec.tp``), so
    a sharded layout here raises."""
    if packed.n_shards:
        raise ValueError("sparse_expert_linear: MoE expert layouts shard "
                         "along the expert axis, not block columns; "
                         "serve.compile exempts moe/ paths from "
                         "CompileSpec.tp")
    if x.dim() != 3:
        raise ValueError(f"sparse_expert_linear: x {tuple(x.shape)} is not "
                         f"(E, M, K)")
    if SH.is_placed(x):
        # a stack placed by ``expert_layout_specs``: each rank its local
        # experts (x split on E over the same mesh dim), no collective
        bias = SH.full(bias)
        return _on_mesh(
            lambda xl: bsr_matmul_packed(xl, packed, bias=bias, act=act), x,
            packed, lambda i, pl, mdim: Shard(0) if i == mdim
            else Replicate())
    return bsr_matmul_packed(x, packed, bias=bias, act=act)


def im2col(x, kh, kw, stride=1, padding="SAME"):
    """x (B, H, W, C) -> patches (B, Ho, Wo, kh*kw*C), feature r =
    (i*kw + j)*C + c (``core.bcs.conv_lower``'s row order).  The
    MATERIALIZED path: it allocates the whole patch tensor."""
    xp, (Ho, Wo) = pad_image(x, kh, kw, stride, padding)
    taps = [xp[:, i:i + stride * (Ho - 1) + 1:stride,
               j:j + stride * (Wo - 1) + 1:stride, :]
            for i in range(kh) for j in range(kw)]
    return torch.cat(taps, dim=-1) if len(taps) > 1 else taps[0]


def patch_bytes(x, kh, kw, stride=1, padding="SAME"):
    """Bytes of the patch tensor the materialized path allocates."""
    B, H, W, C = x.shape
    _, _, Ho, Wo = conv_geometry(H, W, kh, kw, stride, padding)
    return B * Ho * Wo * kh * kw * C * x.element_size()


def _pick_implicit(implicit, x, kh, kw, stride, padding, bk=None,
                   n_shards=0):
    """Resolve the ``implicit=`` tri-state.  None picks the implicit mode
    for every conv whose patch tensor is a real blow-up (kh*kw > 1); the
    BCS path also needs its packing block inside one tap (bk | Cin),
    which an explicit ``implicit=True`` requires instead of falling
    back.  A sharded layout runs materialized; ``implicit=True`` on one
    raises.  (x, stride and padding: the signature of the reference's,
    whose patch-size floor the card's timings removed.)"""
    C = x.shape[-1]
    if n_shards:
        if implicit:
            raise ValueError("implicit conv does not take sharded layouts "
                             "(they run materialized)")
        return False
    if implicit is None:
        if bk is not None and C % bk:
            return False
        return kh * kw > 1
    if implicit and bk is not None and C % bk:
        raise ValueError(f"implicit conv needs bk={bk} | Cin={C} (K-blocks "
                         f"must not straddle kernel taps)")
    return bool(implicit)


def sparse_conv2d(x, packed: PackedLayout, *, kh, kw, stride=1,
                  padding="SAME", bias=None, act="none", implicit=None):
    """x (B, H, W, Cin) * packed im2col-lowered conv weight -> (B, Ho, Wo,
    Cout) through the BCS conv kernel, bias + activation fused.
    ``implicit`` picks its input (None = auto, ``_pick_implicit``): the
    image itself, or the im2col patch matrix read as a 1 x M image of K
    channels; bit-identical outputs either way.  A sharded layout runs
    the patch matrix through kernel 1 (``bsr_matmul_sharded``)."""
    B, H, W, C = x.shape
    if packed.shape[0] != kh * kw * C:
        raise ValueError(f"layout K={packed.shape[0]} != kh*kw*Cin="
                         f"{kh * kw * C}")
    if _pick_implicit(implicit, x, kh, kw, stride, padding,
                      bk=packed.block[0], n_shards=packed.n_shards):
        return bsr_conv2d_implicit(x.contiguous(), packed, kh=kh, kw=kw,
                                   stride=stride, padding=padding,
                                   bias=bias, act=act)
    patches = im2col(x, kh, kw, stride, padding)
    _, Ho, Wo, K = patches.shape
    run = bsr_matmul_packed if packed.n_shards else bsr_conv2d_patches
    y = run(patches.reshape(B * Ho * Wo, K).contiguous(), packed,
            bias=bias, act=act)
    return y.reshape(B, Ho, Wo, y.shape[-1])


def sparse_conv2d_pattern(x, tap: TapLayout, *, kh, kw, stride=1,
                          padding="SAME", bias=None, act="none",
                          implicit=None):
    """x (B, H, W, Cin) * tap-lowered conv weight -> (B, Ho, Wo, Cout).
    Materialized: im2col, the patch matrix gathered down to ``tap.alive``
    (rows pruned in every filter are dropped), then kernel 2.  Implicit
    (``implicit=True`` or auto by patch size): kernel 4 straight off the
    padded image.  Bit-identical outputs either way.  A sharded layout
    runs materialized (kernel 2, ``tap_gather_conv_sharded``)."""
    B, H, W, C = x.shape
    if tap.shape[0] != kh * kw * C:
        raise ValueError(f"layout K={tap.shape[0]} != kh*kw*Cin="
                         f"{kh * kw * C}")
    if _pick_implicit(implicit, x, kh, kw, stride, padding,
                      n_shards=tap.n_shards):
        return tap_gather_conv_implicit(x.contiguous(), tap, kh=kh, kw=kw,
                                        stride=stride, padding=padding,
                                        bias=bias, act=act)
    patches = im2col(x, kh, kw, stride, padding)
    _, Ho, Wo, K = patches.shape
    band = patches.reshape(B * Ho * Wo, K)
    if tap.n_alive < K:
        # alive is ascending, so a full-size alive index is arange(K):
        # gather only when rows are dead everywhere (a placed layout's
        # alive is replicated: every rank holds it whole)
        alive = local_layout(tap)[0].alive if placed_layout(tap) \
            else tap.alive
        band = band.index_select(1, alive.long())
    y = tap_gather_conv_packed(band, tap, bias=bias, act=act)
    return y.reshape(B, Ho, Wo, y.shape[-1])


def flops_saved(packed: PackedLayout) -> float:
    """Fraction of dense matmul FLOPs the kernel skips (padding counts)."""
    return packed.flops_saved


def padding_overhead(packed: PackedLayout) -> float:
    """Executed-block overhead of uniform padding vs ideal CSC."""
    return packed.padding_overhead
