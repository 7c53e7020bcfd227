"""``PackedLayout`` and ``TapLayout``: the sparse interchange formats, as
frozen dataclasses of tensors.

``PackedLayout`` is the block-sparse format (paper §4.3 Fig 4, CSC
orientation — see ``core.bcs``).

The dense weight is (K, N); each block COLUMN j (an output tile of width
bn) stores the list of its surviving K-block indices.  With row reordering
for load balance, block columns are sorted by degree and split into bins,
each padded only to its OWN max degree; ``perm``/``inv_perm`` carry the
permutation.  Per-column accumulation order is untouched by the reorder,
so reordered and unreordered layouts execute to bit-identical outputs.

Leaves may carry leading stack dims (the layer axis of a model's stacked
params); ``layer(i)`` slices one layer out.  An im2col-lowered conv weight
also carries ``conv_taps``, the static K-block -> (dy, dx, c0) table the
implicit conv kernel gathers through.

``TapLayout`` is the sibling for pattern/connectivity-pruned convolutions
(paper §2.1.1): per filter group, the list of surviving rows ("taps") of
the im2col band, degree-sorted and binned the same way.

Either layout may carry int8 values with a per-bin ``scales`` leaf tuple
of fp32 (``core.quant``); the scale's rank against the values' encodes
the granularity (one per stored block or tap slot, or one per output
column).  The kernels dequantize ``q * s`` on the card before their
fp32-accumulated products; ``to_dense`` of a quantized layout returns the
DEQUANTIZED weight, the oracle of the int8 paths.

Either layout may be tensor-parallel (``n_shards`` = S > 0): its block
columns (filter groups) are spread over S shards by degree
(``core.bcs.shard_columns``), each shard binned on its own and every bin
padded to the cross-shard max, so each per-bin leaf carries a shard axis
in front of its bin axes.  ``merge_shards`` gathers per-shard outputs back
to original column order; ``folded`` is the same layout with the shard
axis folded into each bin's columns, which is how the kernels run it on
one card.

``DegradedLayer`` is the marker ``serve.compile.degrade_invalid_layers``
leaves in place of a layout that failed ``core.validate``.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from functools import cached_property

import torch


def _dequant(values, scale):
    """One bin's values as fp32 times its scales, each scale broadcast over
    the trailing value axes it does not name (every granularity the same
    way); the values as they are when ``scale`` is None."""
    if scale is None:
        return values
    s = scale.reshape(tuple(scale.shape)
                      + (1,) * (values.ndim - scale.ndim))
    return values.float() * s


def dtype_name(t) -> str:
    """A tensor's dtype as numpy and JAX name it ("bfloat16", "int8")."""
    return str(t.dtype).removeprefix("torch.")


def _value_dtype(values) -> str:
    """The stored values' dtype name ("int8" on a quantized layout)."""
    return dtype_name(values[0])


def _bin_slices(t, sizes):
    """Consecutive slices of ``t``'s last dim of the given lengths (one per
    bin), each contiguous: a stacked (E, Nb) column table gives (E, nb_b)
    tensors."""
    out, start = [], 0
    for n in sizes:
        out.append(t[..., start:start + n].contiguous())
        start += n
    return tuple(out)


def _fold(layout, bin_leaves):
    """``layout`` with its shard axis folded into each bin's columns (see
    ``PackedLayout.folded``): each per-bin leaf named in ``bin_leaves``
    (S, n_b, ...) -> (S * n_b, ...), ``nnz`` and ``perm`` reordered bin by
    bin, ``inv_perm`` their inverse."""
    if not layout.n_shards:
        return layout
    if layout.nnz.ndim != 2:
        raise ValueError(f"folding shards needs an unstacked sharded layout "
                         f"(nnz {tuple(layout.nnz.shape)}); slice its layer "
                         f"first (layout.layer(i))")

    def fold(t):
        return t.reshape((-1,) + tuple(t.shape[2:]))
    sizes = layout.bin_sizes
    nnz = torch.cat([t.reshape(-1) for t in _bin_slices(layout.nnz, sizes)])
    perm = torch.cat([t.reshape(-1)
                      for t in _bin_slices(layout.perm, sizes)])
    inv = torch.empty_like(perm)
    inv[perm.long()] = torch.arange(perm.numel(), dtype=perm.dtype,
                                    device=perm.device)
    leaves = {name: None if getattr(layout, name) is None else tuple(
        fold(t) for t in getattr(layout, name)) for name in bin_leaves}
    return replace(layout, nnz=nnz, perm=perm, inv_perm=inv, n_shards=0,
                   **leaves)


@dataclass(frozen=True, eq=False)
class PackedLayout:
    """Uniform-padded BCS/CSC layout, optionally degree-sorted and binned.

    Tensor leaves (may carry leading stack dims ``...``):
      values   : tuple of per-bin tensors (..., nb_b, L_b, bk, bn)
      k_idx    : tuple of per-bin int32 tensors (..., nb_b, L_b)
      nnz      : (..., Nb) int32 live K-blocks per column, in LAYOUT order
      perm     : (..., Nb) int32 layout position -> original block column,
                 or None when the layout is in original column order
      inv_perm : (..., Nb) int32 original block column -> layout position,
                 or None (identity)
      scales   : None for float values; for int8 values a tuple of per-bin
                 fp32 tensors, (..., nb_b, L_b) — one scale per stored
                 block ("block") — or (..., nb_b) — one per block column
                 ("out").  All-zero blocks store scale 0.

    Static geometry: ``block`` (bk, bn) and ``shape`` (K, N) of one dense
    weight slice; ``conv_taps`` is None, or for an im2col-lowered conv
    weight a tuple of (dy, dx, c0) per K-block (``core.bcs.
    conv_tap_table``).  Padding slots (column degree below the bin max) carry
    ``k_idx`` 0 and all-zero values, so they multiply to nothing.

    ``n_shards`` = S > 0: tensor parallel over block columns.  The shard
    axis is the last stack dim of every per-bin leaf (``values[b]`` (...,
    S, nb_b, L_b, bk, bn)), ``nnz`` is (..., S, Nb_s) with Nb_s = Nb / S,
    ``perm`` (..., S, Nb_s) holds ORIGINAL column ids (its last two axes
    flattened are a permutation of range(Nb)) and ``inv_perm`` stays flat
    (..., Nb), original column -> shard-major layout position.
    """

    values: tuple
    k_idx: tuple
    nnz: torch.Tensor
    perm: torch.Tensor | None = None
    inv_perm: torch.Tensor | None = None
    block: tuple = (128, 128)
    shape: tuple = (0, 0)
    conv_taps: tuple | None = None
    scales: tuple | None = None
    n_shards: int = 0

    # -- static geometry ------------------------------------------------------

    @property
    def Kb(self) -> int:
        """Number of block rows (K // bk)."""
        return self.shape[0] // self.block[0]

    @property
    def Nb(self) -> int:
        """Number of block columns (N // bn)."""
        return self.shape[1] // self.block[1]

    @property
    def n_bins(self) -> int:
        """Number of degree bins (1 for an unreordered layout)."""
        return len(self.values)

    @property
    def Nb_shard(self) -> int:
        """Block columns per shard (Nb when unsharded)."""
        return self.Nb // max(1, self.n_shards)

    @property
    def bin_sizes(self) -> tuple:
        """Block columns per bin (per shard on a sharded layout)."""
        return tuple(v.shape[-4] for v in self.values)

    @property
    def bin_degrees(self) -> tuple:
        """Padded column degree L_b of each bin."""
        return tuple(v.shape[-3] for v in self.values)

    @property
    def L_max(self) -> int:
        """Worst padded column degree across bins."""
        return max(self.bin_degrees)

    @property
    def executed_blocks(self) -> int:
        """Blocks the kernel multiplies per dense-weight slice: sum over
        bins of nb_b * L_b, padding included, times the shard count on a
        sharded layout (each shard pads to the cross-shard bin max)."""
        return (sum(s * d for s, d in zip(self.bin_sizes, self.bin_degrees))
                * max(1, self.n_shards))

    @property
    def L_effective(self) -> float:
        """Mean executed column degree under the binned layout."""
        return self.executed_blocks / max(self.Nb, 1)

    @property
    def flops_saved(self) -> float:
        """Fraction of dense matmul FLOPs the kernel skips (padding blocks
        count as executed)."""
        return max(0.0, 1.0 - self.executed_blocks / (self.Kb * self.Nb))

    @property
    def value_dtype(self) -> str:
        """Dtype name of the stored values ("int8" on quantized layouts)."""
        return _value_dtype(self.values)

    @property
    def scale_granularity(self) -> str | None:
        """"block" (a scale per stored block), "out" (per block column) or
        None (float values), read from the scales' rank."""
        if self.scales is None:
            return None
        return ("block" if self.scales[0].ndim == self.values[0].ndim - 2
                else "out")

    def bin_scales(self) -> tuple:
        """Per-bin scale tensors, or Nones on a float layout — what the
        kernel wrappers zip alongside ``values``."""
        if self.scales is None:
            return (None,) * self.n_bins
        return self.scales

    def shard_index_leaves(self) -> tuple:
        """The per-bin index leaves a launch reads beside ``values``
        (``k_idx``; ``t_idx`` on a ``TapLayout``)."""
        return self.k_idx

    # -- data-dependent stats (host sync; report/test time only) -------------

    @property
    def shard_balance(self) -> float:
        """max / mean executed blocks per shard were each shard padded to
        its own bin maxima (``core.bcs.shard_balance``); 1.0 unsharded."""
        if not self.n_shards:
            return 1.0
        from repro_torch.core import bcs
        return bcs.shard_balance(self.nnz, self.bin_sizes)

    @property
    def nnzb(self) -> int:
        """Surviving blocks per dense-weight slice (mean over stack dims)."""
        per_slice = self.nnz.reshape(-1, self.Nb).sum(dim=1, dtype=torch.int64)
        return int(round(float(per_slice.double().mean())))

    @property
    def density(self) -> float:
        """Surviving-block fraction of the Kb x Nb block grid."""
        return self.nnzb / (self.Kb * self.Nb)

    @property
    def padding_overhead(self) -> float:
        """Executed-block overhead of padding vs ideal CSC."""
        return self.executed_blocks / max(self.nnzb, 1)

    # -- helpers -------------------------------------------------------------

    def layer(self, i: int) -> "PackedLayout":
        """The layout of stack slice ``i`` (the leading leaf dim) — what a
        loop over a stacked layer axis runs, with the stack's padded bin
        degrees, so every layer executes the same slots it was packed to.
        A sharded stack keeps its shard axis (the innermost stack dim)."""
        def take(t):
            return None if t is None else t[i]
        return replace(self, values=tuple(v[i] for v in self.values),
                       k_idx=tuple(k[i] for k in self.k_idx),
                       nnz=self.nnz[i], perm=take(self.perm),
                       inv_perm=take(self.inv_perm),
                       scales=None if self.scales is None else tuple(
                           s[i] for s in self.scales))

    @cached_property
    def bin_cols(self) -> tuple:
        """Per-bin (..., nb_b) int32 ORIGINAL block column of each layout
        column, contiguous, with the layout's leading stack dims (an
        expert stack's (E, nb_b), a sharded layout's (S, nb_b)) — where
        the kernel writes each column tile, which makes the un-permute
        gather unnecessary.  Computed once per layout object."""
        cols = (self.perm if self.perm is not None else
                torch.arange(self.Nb, dtype=torch.int32,
                             device=self.nnz.device).expand(self.nnz.shape))
        return _bin_slices(cols, self.bin_sizes)

    @cached_property
    def conv_taps_t(self) -> torch.Tensor:
        """``conv_taps`` as a (Kb, 3) int32 tensor on the layout's device
        — what the implicit conv kernel reads.  Computed once per layout
        object."""
        if self.conv_taps is None:
            raise ValueError("this layout carries no conv_taps (pack it "
                             "with ops.pack(..., conv=(kh, kw, cin)))")
        return torch.tensor(self.conv_taps, dtype=torch.int32,
                            device=self.nnz.device).reshape(-1, 3)

    def unpermute_cols(self, y):
        """Gather a (..., M, N) output from layout column order back to the
        original column order (identity when the layout is unreordered).
        A sharded layout's outputs merge through ``merge_shards``."""
        if self.n_shards:
            raise ValueError("a sharded layout merges via merge_shards")
        if self.inv_perm is None:
            return y
        bn = self.block[1]
        yb = y.reshape(y.shape[:-1] + (self.Nb, bn))
        yb = torch.index_select(yb, -2, self.inv_perm.long())
        return yb.reshape(y.shape)

    def merge_shards(self, y):
        """Per-shard outputs (S, ..., M, N / S) — shard axis leading, each
        shard's columns in its layout order — to (..., M, N) in original
        column order: one gather through the flat ``inv_perm`` is both the
        cross-shard concat and the un-reorder."""
        if not self.n_shards:
            raise ValueError("merge_shards needs a sharded layout")
        y = torch.movedim(y, 0, -2)                 # (..., M, S, N/S)
        yb = y.reshape(y.shape[:-2] + (self.Nb, self.block[1]))
        yb = torch.index_select(yb, -2, self.inv_perm.long())
        return yb.reshape(y.shape[:-2] + (self.shape[1],))

    def permute_bias(self, bias):
        """Gather a (N,) bias into layout column order: (N,) unsharded,
        (S, N / S) sharded."""
        if bias is None or self.perm is None:
            return bias
        pb = bias.reshape(self.Nb, self.block[1])[self.perm.long()]
        return pb.reshape(pb.shape[:-2] + (-1,))

    def bin_bias(self, bias):
        """Per-bin (nb_b * bn,) bias slices in layout order (or Nones);
        (S, nb_b * bn) on a sharded layout."""
        if bias is None:
            return (None,) * self.n_bins
        bn = self.block[1]
        pb = self.permute_bias(bias)
        pb = pb.reshape(pb.shape[:-1] + (-1, bn))
        out, start = [], 0
        for s in self.bin_sizes:
            sl = pb[..., start:start + s, :]
            out.append(sl.reshape(sl.shape[:-2] + (-1,)))
            start += s
        return tuple(out)

    @cached_property
    def folded(self) -> "PackedLayout":
        """A sharded layout as the kernels run it on one card: the shard
        axis folded into each bin's columns (bin b holds every shard's
        bin-b columns, shard by shard, padded to their common degree), an
        unsharded layout of the same bins; ``nnz`` and ``perm`` follow the
        folded order.  The leaves are views of this layout's.  Itself when
        unsharded; computed once per layout object."""
        return _fold(self, ("values", "k_idx", "scales"))

    def to_dense(self):
        """Reconstruct the dense (K, N) weight of a single-slice layout —
        the round-trip oracle; the DEQUANTIZED fp32 weight (values *
        scales) of a quantized layout."""
        if self.n_shards:
            return self.folded.to_dense()
        assert self.values[0].ndim == 4, "to_dense needs an unstacked layout"
        K, N = self.shape
        bk, bn = self.block
        Kb, Nb = self.Kb, self.Nb
        dev = self.values[0].device
        dense = torch.zeros((Kb, Nb, bk, bn), dtype=torch.float32
                            if self.scales is not None
                            else self.values[0].dtype, device=dev)
        start = 0
        for vals, kidx, cols, sc in zip(self.values, self.k_idx,
                                        self.bin_cols, self.bin_scales()):
            vals = _dequant(vals, sc)
            nb_b, L_b = kidx.shape
            deg = self.nnz[start:start + nb_b].long()     # layout order
            live = torch.arange(L_b, device=dev)[None, :] < deg[:, None]
            j = cols.long()[:, None].expand(nb_b, L_b)[live]
            dense.index_put_((kidx.long()[live], j), vals[live],
                             accumulate=True)
            start += nb_b
        return dense.permute(0, 2, 1, 3).reshape(K, N)


@dataclass(frozen=True, eq=False)
class TapLayout:
    """Per-filter tap lists over the im2col band — the pattern-conv layout
    (``core.bcs.pattern_lower`` builds it; ``kernels.ops.
    sparse_conv2d_pattern`` runs it).

    The dense object is the im2col-lowered conv weight (K, P), K =
    Kh*Kw*Q rows ("taps": input channel q at kernel position (i, j)).  Each
    GROUP of ``group`` consecutive filters stores the taps any of its
    filters survives at.

    Tensor leaves (single slice — conv layers are not stacked):
      values   : tuple of per-bin (G_b, L_b, group) tensors (zero on
                 padding slots and where a filter prunes the tap)
      t_idx    : tuple of per-bin (G_b, L_b) int32 — slot -> row of the
                 ALIVE band (position in ``alive``); padding slots 0
      k_full   : tuple of per-bin (G_b, L_b) int32 — slot -> row of the
                 FULL im2col band (``alive[t_idx]`` = tap*C + channel),
                 from which the implicit kernel derives its input offsets
      nnz      : (G,) int32 true tap degree per group, in LAYOUT order
      alive    : (R,) int32 rows of the full band live for at least one
                 group, ascending
      perm     : (G,) int32 layout position -> original group, or None
      inv_perm : (G,) int32 original group -> layout position, or None
      scales   : None for float values; for int8 values a tuple of per-bin
                 fp32 tensors, (G_b, L_b) — one per tap slot ("block") —
                 or (G_b, 1, group) — one per filter ("out").

    Static: ``group`` (filters per tap list) and ``shape`` (K, P).  Within
    a group the live slots are in ascending band-row order
    (``np.nonzero`` order) and the padding slots come last.

    ``n_shards`` = S > 0: the filter groups are tensor parallel like a
    ``PackedLayout``'s block columns: per-bin leaves gain a leading shard
    axis ((S, G_b, L_b, group) values, "out" scales (S, G_b, 1, group)),
    ``nnz`` and ``perm`` become (S, G_s), ``inv_perm`` stays flat (G,) and
    ``alive`` global (every shard gathers the same band).
    """

    values: tuple
    t_idx: tuple
    nnz: torch.Tensor
    alive: torch.Tensor
    perm: torch.Tensor | None = None
    inv_perm: torch.Tensor | None = None
    group: int = 1
    shape: tuple = (0, 0)
    k_full: tuple | None = None
    scales: tuple | None = None
    n_shards: int = 0

    # -- static geometry ------------------------------------------------------

    @property
    def n_groups(self) -> int:
        """Number of filter groups (P // group)."""
        return self.shape[1] // self.group

    @property
    def n_alive(self) -> int:
        """Rows of the im2col band live for at least one group."""
        return self.alive.shape[-1]

    @property
    def n_bins(self) -> int:
        """Number of degree bins (1 for an unreordered layout)."""
        return len(self.values)

    @property
    def n_groups_shard(self) -> int:
        """Filter groups per shard (n_groups when unsharded)."""
        return self.n_groups // max(1, self.n_shards)

    @property
    def bin_sizes(self) -> tuple:
        """Filter groups per bin (per shard on a sharded layout)."""
        return tuple(v.shape[-3] for v in self.values)

    @property
    def bin_degrees(self) -> tuple:
        """Padded tap degree L_b of each bin."""
        return tuple(v.shape[-2] for v in self.values)

    @property
    def L_max(self) -> int:
        """Worst padded tap degree across bins."""
        return max(self.bin_degrees)

    @property
    def executed_taps(self) -> int:
        """Tap slots the kernel gathers and multiplies (padding included):
        sum over bins of G_b * L_b, times the shard count on a sharded
        layout."""
        return (sum(s * d for s, d in zip(self.bin_sizes, self.bin_degrees))
                * max(1, self.n_shards))

    @property
    def L_effective(self) -> float:
        """Mean executed tap degree under the binned layout."""
        return self.executed_taps / max(self.n_groups, 1)

    @property
    def flops_saved(self) -> float:
        """Fraction of dense conv-GEMM FLOPs the tap kernel skips: 1 -
        executed / (K * n_groups), padding included."""
        K = self.shape[0]
        return max(0.0, 1.0 - self.executed_taps / (K * self.n_groups))

    @property
    def value_dtype(self) -> str:
        """Dtype name of the stored values ("int8" on quantized layouts)."""
        return _value_dtype(self.values)

    @property
    def scale_granularity(self) -> str | None:
        """"block" (a scale per tap slot), "out" (per filter) or None
        (float values), read from the scales' rank."""
        if self.scales is None:
            return None
        return ("block" if self.scales[0].ndim == self.values[0].ndim - 1
                else "out")

    def bin_scales(self) -> tuple:
        """Per-bin scale tensors, or Nones on a float layout."""
        if self.scales is None:
            return (None,) * self.n_bins
        return self.scales

    def shard_index_leaves(self) -> tuple:
        """The per-bin index leaves a launch reads beside ``values``."""
        return self.t_idx

    # -- data-dependent stats (host sync; report/test time only) -------------

    @property
    def nnz_taps(self) -> int:
        """True surviving tap-list entries (union over each group)."""
        return int(self.nnz.sum())

    @property
    def density(self) -> float:
        """Surviving tap-list fraction of the K x n_groups tap grid."""
        return self.nnz_taps / (self.shape[0] * self.n_groups)

    @property
    def padding_overhead(self) -> float:
        """Executed-tap overhead of bin padding vs exact tap lists."""
        return self.executed_taps / max(self.nnz_taps, 1)

    @property
    def shard_balance(self) -> float:
        """max / mean executed taps per shard were each shard padded to its
        own bin maxima; 1.0 unsharded (``PackedLayout.shard_balance``)."""
        if not self.n_shards:
            return 1.0
        from repro_torch.core import bcs
        return bcs.shard_balance(self.nnz, self.bin_sizes)

    # -- helpers -------------------------------------------------------------

    @cached_property
    def bin_cols(self) -> tuple:
        """Per-bin (G_b,) int32 ORIGINAL filter group of each layout group
        ((S, G_b) sharded) — where the tap kernels write each group's
        outputs, so no un-permute gather is needed.  Computed once per
        layout object."""
        groups = (self.perm if self.perm is not None else
                  torch.arange(self.n_groups, dtype=torch.int32,
                               device=self.nnz.device))
        return _bin_slices(groups, self.bin_sizes)

    def unpermute_cols(self, y):
        """Gather a (..., M, P) output from layout group order back to the
        original filter order (identity when unreordered).  A sharded
        layout's outputs merge through ``merge_shards``."""
        if self.n_shards:
            raise ValueError("a sharded layout merges via merge_shards")
        if self.inv_perm is None:
            return y
        yb = y.reshape(y.shape[:-1] + (self.n_groups, self.group))
        yb = torch.index_select(yb, -2, self.inv_perm.long())
        return yb.reshape(y.shape)

    def merge_shards(self, y):
        """Per-shard outputs (S, ..., M, P / S) — shard axis leading — to
        (..., M, P) in original filter order, one gather through the flat
        ``inv_perm`` (``PackedLayout.merge_shards``)."""
        if not self.n_shards:
            raise ValueError("merge_shards needs a sharded layout")
        y = torch.movedim(y, 0, -2)                 # (..., M, S, P/S)
        yb = y.reshape(y.shape[:-2] + (self.n_groups, self.group))
        yb = torch.index_select(yb, -2, self.inv_perm.long())
        return yb.reshape(y.shape[:-2] + (self.shape[1],))

    def permute_bias(self, bias):
        """Gather a (P,) bias into layout group order: (P,) unsharded,
        (S, P / S) sharded."""
        if bias is None or self.perm is None:
            return bias
        pb = bias.reshape(self.n_groups, self.group)[self.perm.long()]
        return pb.reshape(pb.shape[:-2] + (-1,))

    def bin_bias(self, bias):
        """Per-bin (G_b * group,) bias slices in layout order (or Nones);
        (S, G_b * group) on a sharded layout."""
        if bias is None:
            return (None,) * self.n_bins
        return _bin_slices(self.permute_bias(bias),
                           [n * self.group for n in self.bin_sizes])

    @cached_property
    def folded(self) -> "TapLayout":
        """The shard axis folded into each bin's groups, as the kernels run
        a sharded layout on one card (``PackedLayout.folded``); itself
        when unsharded."""
        return _fold(self, ("values", "t_idx", "k_full", "scales"))

    def bin_k_full(self) -> tuple:
        """Per-bin (G_b, L_b) FULL-band row ids (tap*C + channel): the
        stored ``k_full``, else ``alive[t_idx]``."""
        if self.k_full is not None:
            return self.k_full
        return tuple(self.alive[t.long()] for t in self.t_idx)

    def to_dense(self):
        """Reconstruct the dense lowered (K, P) weight — the round-trip
        oracle: equals ``core.bcs.conv_lower(w * mask)`` (the DEQUANTIZED
        fp32 weight of a quantized layout)."""
        if self.n_shards:
            return self.folded.to_dense()
        K, P = self.shape
        dev = self.values[0].device
        dense = torch.zeros((K, self.n_groups, self.group),
                            dtype=torch.float32 if self.scales is not None
                            else self.values[0].dtype, device=dev)
        start = 0
        for vals, tidx, cols, sc in zip(self.values, self.t_idx,
                                        self.bin_cols, self.bin_scales()):
            vals = _dequant(vals, sc)
            G_b, L_b = tidx.shape
            deg = self.nnz[start:start + G_b].long()
            live = torch.arange(L_b, device=dev)[None, :] < deg[:, None]
            rows = self.alive.long()[tidx.long()][live]
            g = cols.long()[:, None].expand(G_b, L_b)[live]
            dense.index_put_((rows, g), vals[live], accumulate=True)
            start += G_b
        return dense.reshape(K, P)


@dataclass(frozen=True)
class DegradedLayer:
    """Marker left by ``serve.compile.degrade_invalid_layers`` where a
    packed layout failed ``core.validate``: the layer runs masked-dense on
    its retained ``w`` (the pruning zeros are baked in) instead of the
    sparse kernel, so no kernel ever launches on the corrupt layout.

    ``path`` is the layer that degraded, ``code`` the ``LayoutError``
    failure class, ``detail`` the reason.  No tensors; hashable.  A
    stacked layout covers every layer of its stack, so one marker retires
    the whole stack: ``layer(i)`` returns the marker itself."""

    path: str
    code: str
    detail: str

    def layer(self, i: int) -> "DegradedLayer":
        """Every stack slice of a retired stack is retired."""
        return self
