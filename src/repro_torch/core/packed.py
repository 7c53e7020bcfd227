"""``PackedLayout``: the block-sparse interchange format (paper §4.3 Fig 4,
CSC orientation — see ``core.bcs``), as a frozen dataclass of tensors.

The dense weight is (K, N); each block COLUMN j (an output tile of width
bn) stores the list of its surviving K-block indices.  With row reordering
for load balance, block columns are sorted by degree and split into bins,
each padded only to its OWN max degree; ``perm``/``inv_perm`` carry the
permutation.  Per-column accumulation order is untouched by the reorder,
so reordered and unreordered layouts execute to bit-identical outputs.

Leaves may carry leading stack dims (the layer axis of a model's stacked
params); ``layer(i)`` slices one layer out.  This port holds float values
only: no int8 scales and no tensor-parallel shards yet.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from functools import cached_property

import torch


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

    Static geometry: ``block`` (bk, bn) and ``shape`` (K, N) of one dense
    weight slice.  Padding slots (column degree below the bin max) carry
    ``k_idx`` 0 and all-zero values, so they multiply to nothing.
    """

    values: tuple
    k_idx: tuple
    nnz: torch.Tensor
    perm: torch.Tensor | None = None
    inv_perm: torch.Tensor | None = None
    block: tuple = (128, 128)
    shape: tuple = (0, 0)

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
    def bin_sizes(self) -> tuple:
        """Block columns per bin."""
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
        bins of nb_b * L_b, padding included."""
        return sum(s * d for s, d in zip(self.bin_sizes, self.bin_degrees))

    @property
    def L_effective(self) -> float:
        """Mean executed column degree under the binned layout."""
        return self.executed_blocks / max(self.Nb, 1)

    @property
    def flops_saved(self) -> float:
        """Fraction of dense matmul FLOPs the kernel skips (padding blocks
        count as executed)."""
        return max(0.0, 1.0 - self.executed_blocks / (self.Kb * self.Nb))

    # -- data-dependent stats (host sync; report/test time only) -------------

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
        degrees, so every layer executes the same slots it was packed to."""
        def take(t):
            return None if t is None else t[i]
        return replace(self, values=tuple(v[i] for v in self.values),
                       k_idx=tuple(k[i] for k in self.k_idx),
                       nnz=self.nnz[i], perm=take(self.perm),
                       inv_perm=take(self.inv_perm))

    @cached_property
    def bin_cols(self) -> tuple:
        """Per-bin (nb_b,) int32 ORIGINAL block column of each layout
        column (single-slice layouts) — where the kernel writes each
        column tile, which makes the un-permute gather unnecessary.
        Computed once per layout object."""
        cols = (self.perm if self.perm is not None else
                torch.arange(self.Nb, dtype=torch.int32,
                             device=self.nnz.device))
        out, start = [], 0
        for s in self.bin_sizes:
            out.append(cols[start:start + s])
            start += s
        return tuple(out)

    def unpermute_cols(self, y):
        """Gather a (..., M, N) output from layout column order back to the
        original column order (identity when the layout is unreordered)."""
        if self.inv_perm is None:
            return y
        bn = self.block[1]
        yb = y.reshape(y.shape[:-1] + (self.Nb, bn))
        yb = torch.index_select(yb, -2, self.inv_perm.long())
        return yb.reshape(y.shape)

    def permute_bias(self, bias):
        """Gather a (N,) bias into layout column order."""
        if bias is None or self.perm is None:
            return bias
        bn = self.block[1]
        pb = torch.index_select(bias.reshape(self.Nb, bn), 0,
                                self.perm.long())
        return pb.reshape(-1)

    def bin_bias(self, bias):
        """Per-bin (nb_b * bn,) bias slices in layout order (or Nones)."""
        if bias is None:
            return (None,) * self.n_bins
        bn = self.block[1]
        pb = self.permute_bias(bias)
        out, start = [], 0
        for s in self.bin_sizes:
            out.append(pb[start * bn:(start + s) * bn])
            start += s
        return tuple(out)

    def to_dense(self):
        """Reconstruct the dense (K, N) weight of a single-slice layout —
        the round-trip oracle."""
        assert self.values[0].ndim == 4, "to_dense needs an unstacked layout"
        K, N = self.shape
        bk, bn = self.block
        Kb, Nb = self.Kb, self.Nb
        dev = self.values[0].device
        dense = torch.zeros((Kb, Nb, bk, bn), dtype=self.values[0].dtype,
                            device=dev)
        start = 0
        for vals, kidx, cols in zip(self.values, self.k_idx, self.bin_cols):
            nb_b, L_b = kidx.shape
            deg = self.nnz[start:start + nb_b].long()     # layout order
            live = torch.arange(L_b, device=dev)[None, :] < deg[:, None]
            j = cols.long()[:, None].expand(nb_b, L_b)[live]
            dense.index_put_((kidx.long()[live], j), vals[live],
                             accumulate=True)
            start += nb_b
        return dense.permute(0, 2, 1, 3).reshape(K, N)
