"""Dispatch over the sparse executor paths, and the host-side packing step.

``sparse_linear`` picks the execution strategy the compiler would emit for
a pruned layer:
  PackedLayout         -> the BCS kernel (skips pruned blocks; ragged M is
                          masked inside the kernel, so the packed path never
                          falls back to dense)
  dense weight (+mask) -> masked-dense plain version
``pack`` converts a pruned weight into a ``PackedLayout``, optionally
degree-sorted and binned (``reorder``).
"""
from __future__ import annotations

from repro_torch.core import bcs as BCS
from repro_torch.core.packed import PackedLayout
from repro_torch.kernels import ref
from repro_torch.kernels.bsr_matmul import bsr_matmul_packed


def pack(w, mask, block=(128, 128), *, reorder=False, n_bins=4
         ) -> PackedLayout:
    """Pack a pruned (K, N) weight into the kernel layout on its device.
    With ``reorder`` the block columns are degree-sorted and split into
    ``n_bins`` bins (``core.bcs.pack_csc_reordered``); without it the layout
    is one bin in original column order."""
    if reorder:
        return BCS.pack_csc_reordered(w, mask, block, n_bins=n_bins)
    values, k_idx, nnz, _ = BCS.pack_csc(w, mask, block)
    return PackedLayout(values=(values,), k_idx=(k_idx,), nnz=nnz,
                        block=tuple(block), shape=tuple(w.shape))


def sparse_linear(x, packed: PackedLayout | None = None, w=None, mask=None,
                  bias=None, act="none"):
    """x (..., K) -> (..., N) through whichever path applies.  With
    ``packed`` the BCS kernel always runs (one launch per degree bin)."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if packed is not None:
        y = bsr_matmul_packed(x2, packed, bias=bias, act=act)
    else:
        y = ref.masked_matmul_ref(
            x2, w, mask if mask is not None else w.new_ones(()),
            bias=bias, act=act)
    return y.reshape(*lead, y.shape[-1])


def flops_saved(packed: PackedLayout) -> float:
    """Fraction of dense matmul FLOPs the kernel skips (padding counts)."""
    return packed.flops_saved


def padding_overhead(packed: PackedLayout) -> float:
    """Executed-block overhead of uniform padding vs ideal CSC."""
    return packed.padding_overhead
