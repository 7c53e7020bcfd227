"""The port's layout validation (``core.validate``) against the reference's.

Each case of the reference's ``tests/test_validate.py`` is run on a
layout the reference packed and on the same layout crossed into the
port: the same corruption of the same leaf must raise the same class,
``code``, ``field`` and ``bin`` in both packages (and clean layouts pass
in both).  A few cases the reference's file leaves out (non-finite
values, the quantization checks, a sharded layout) are held the same way,
or to the port's own refusal."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import quant as ref_quant  # noqa: E402
from repro.core import regularity as ref_R  # noqa: E402
from repro.core import validate as ref_V  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro_torch.convert import layout_from_numpy, tensor_from_numpy  # noqa: E402,E501
from repro_torch.core import validate as V  # noqa: E402
from repro_torch.core.packed import DegradedLayer  # noqa: E402

from test_torch_reference import ref_to_numpy  # noqa: E402


def packed_case(reorder=True, n_bins=4, seed=0):
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    w = np.asarray(jax.random.normal(k1, (128, 256), jnp.float32))
    keep = np.asarray(jax.random.uniform(k2, (8, 16))) > 0.6
    mask = np.repeat(np.repeat(keep, 16, 0), 16, 1).astype(np.float32)
    return ref_ops.pack(w * mask, mask, (16, 16), reorder=reorder,
                        n_bins=n_bins, use_cache=False)


def conv_packed_case(seed=0):
    kh, kw, cin, cout = 3, 3, 16, 64
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    w = np.asarray(jax.random.normal(k1, (kh * kw * cin, cout), jnp.float32))
    keep = np.asarray(jax.random.uniform(k2, (kh * kw * cin // 8,
                                              cout // 8))) > 0.5
    mask = np.repeat(np.repeat(keep, 8, 0), 8, 1).astype(np.float32)
    return ref_ops.pack(w * mask, mask, (8, 8), reorder=True, n_bins=2,
                        conv=(kh, kw, cin), use_cache=False)


def tap_case(connectivity=0.5, n_bins=4, seed=0):
    w = np.asarray(jax.random.normal(jax.random.PRNGKey(seed),
                                     (16, 8, 3, 3), jnp.float32))
    mask = np.asarray(ref_R.pattern_mask(w, connectivity_rate=connectivity))
    return ref_ops.pack_taps(w * mask, mask, n_bins=n_bins, use_cache=False)


def int8_case():
    return ref_quant.quantize_layout(packed_case(), value_dtype="int8",
                                     scale_granularity="block")


def port_of(ref_layout):
    return layout_from_numpy(ref_to_numpy(ref_layout), "cpu")


class Side:
    """One package's view of a layout: numpy copies of its leaves, and
    ``replace`` that puts a numpy leaf back in that package's form
    (numpy for the reference, a tensor for the port)."""

    def __init__(self, layout, port):
        self.layout, self.port = layout, port

    def np(self, field, b=None):
        leaf = getattr(self.layout, field)
        if b is not None:
            leaf = leaf[b]
        if isinstance(leaf, torch.Tensor):
            if leaf.dtype == torch.bfloat16:
                return leaf.float().numpy()
            return leaf.numpy().copy()
        return np.array(leaf)

    def leaf(self, a):
        if a is None or not self.port:
            return a
        return tensor_from_numpy(a, "cpu")

    def replace(self, field, new, b=None):
        """The layout with ``field`` (bin ``b`` of it) set to ``new``."""
        if b is None:
            return dataclasses.replace(self.layout, **{field: new})
        old = getattr(self.layout, field)
        return dataclasses.replace(
            self.layout, **{field: old[:b] + (self.leaf(new),) + old[b + 1:]})

    def replace_leaf(self, field, new):
        return dataclasses.replace(self.layout, **{field: self.leaf(new)})


def _set(a, i, v):
    a = a.copy()
    a.flat[i] = v
    return a


def _swap01(a):
    a = a.copy()
    a[[0, 1]] = a[[1, 0]]
    return a


def _dup0(a):
    a = a.copy()
    a[0] = a[1]
    return a


def _bump0(s, deg):
    n = s.np("nnz")
    n[0] = deg
    return s.replace_leaf("nnz", n)


# name -> (case maker, corruption of one side, expected reference class)
CORRUPTIONS = {
    "packed_block_must_divide_shape": (
        packed_case, lambda s: s.replace("shape", (120, 256)),
        "LayoutGeometryError"),
    "packed_bin_sizes_must_tile_columns": (
        packed_case, lambda s: Side(
            s.replace("values", s.np("values", 0)[:-1], 0), s.port).replace(
                "k_idx", s.np("k_idx", 0)[:-1], 0),
        "LayoutGeometryError"),
    "packed_k_idx_out_of_range": (
        packed_case, lambda s: s.replace(
            "k_idx", _set(s.np("k_idx", 0), 0, s.layout.Kb), 0),
        "LayoutIndexError"),
    "packed_negative_k_idx": (
        packed_case, lambda s: s.replace(
            "k_idx", _set(s.np("k_idx", 0), 0, -1), 0), "LayoutIndexError"),
    "packed_nnz_exceeds_bin_degree": (
        packed_case, lambda s: _bump0(s, s.layout.bin_degrees[0] + 1),
        "LayoutCountError"),
    "packed_nnz_negative": (
        packed_case, lambda s: _bump0(s, -1), "LayoutCountError"),
    "packed_perm_not_inverse": (
        packed_case, lambda s: s.replace_leaf("inv_perm",
                                              _swap01(s.np("inv_perm"))),
        "LayoutPermutationError"),
    "packed_perm_not_a_permutation": (
        packed_case, lambda s: s.replace_leaf("perm", _dup0(s.np("perm"))),
        "LayoutPermutationError"),
    "packed_lone_perm_is_an_error": (
        packed_case, lambda s: s.replace("inv_perm", None),
        "LayoutPermutationError"),
    "packed_values_k_idx_shape_mismatch": (
        packed_case, lambda s: s.replace("k_idx",
                                         s.np("k_idx", 0)[..., :-1], 0),
        "LayoutStructureError"),
    "conv_taps_must_match_geometry": (
        conv_packed_case, lambda s: s.replace(
            "conv_taps", (s.layout.conv_taps[1], s.layout.conv_taps[0])
            + tuple(s.layout.conv_taps[2:])), "LayoutAuxError"),
    "conv_taps_wrong_arity": (
        conv_packed_case, lambda s: s.replace(
            "conv_taps", tuple(s.layout.conv_taps[:-1])), "LayoutAuxError"),
    "tap_t_idx_out_of_range": (
        tap_case, lambda s: s.replace(
            "t_idx", _set(s.np("t_idx", 0), 0, len(s.np("alive"))), 0),
        "LayoutIndexError"),
    "tap_alive_out_of_range": (
        tap_case, lambda s: s.replace_leaf(
            "alive", _set(s.np("alive"), -1, s.layout.shape[0])),
        "LayoutIndexError"),
    "tap_alive_must_be_sorted": (
        tap_case, lambda s: s.replace_leaf("alive", _swap01(s.np("alive"))),
        "LayoutIndexError"),
    "tap_k_full_must_match_alive_gather": (
        tap_case, lambda s: s.replace(
            "k_full", _set(s.np("k_full", 0), 0,
                           (s.np("k_full", 0).flat[0] + 1)
                           % s.layout.shape[0]), 0), "LayoutAuxError"),
    "tap_nnz_exceeds_bin_degree": (
        tap_case, lambda s: _bump0(s, s.layout.bin_degrees[0] + 1),
        "LayoutCountError"),
    "tap_group_must_divide": (
        tap_case, lambda s: s.replace("group", 3), "LayoutGeometryError"),
    # beyond the reference's file: the numerics and quantization checks
    "values_non_finite": (
        packed_case, lambda s: s.replace(
            "values", _set(s.np("values", 1), 5, np.inf), 1),
        "LayoutNumericsError"),
    "int8_values_without_scales": (
        int8_case, lambda s: s.replace("scales", None), "LayoutQuantError"),
    "int8_negative_scale": (
        int8_case, lambda s: s.replace(
            "scales", _set(s.np("scales", 0), 3, -1.0), 0),
        "LayoutQuantError"),
    "int8_non_finite_scale": (
        int8_case, lambda s: s.replace(
            "scales", _set(s.np("scales", 0), 3, np.nan), 0),
        "LayoutQuantError"),
}


def _failure(validate, layout, path):
    try:
        validate(layout, path=path)
    except Exception as e:  # noqa: BLE001 - compared class by class below
        return e
    raise AssertionError("the corrupt layout passed validation")


# -- clean layouts pass ---------------------------------------------------------

@pytest.mark.parametrize("make", [
    lambda: packed_case(reorder=True),
    lambda: packed_case(reorder=False, n_bins=1),
    conv_packed_case,
    tap_case,
    lambda: tap_case(connectivity=0.0, n_bins=1),
])
def test_fresh_layouts_validate_clean(make):
    ref = make()
    port = port_of(ref)
    assert ref_V.validate_layout(ref, path="t") is ref
    assert V.validate_layout(port, path="t") is port


def test_validate_rejects_non_layout():
    with pytest.raises(V.LayoutStructureError) as ei:
        V.validate_layout({"values": ()}, path="t")
    assert ei.value.field == "layout"
    with pytest.raises(ref_V.LayoutStructureError):
        ref_V.validate_layout({"values": ()}, path="t")


# -- every corruption: the same class, code, field and bin ---------------------

@pytest.mark.parametrize("name", sorted(CORRUPTIONS))
def test_corruption_raises_the_references_error(name):
    make, corrupt, cls = CORRUPTIONS[name]
    ref = make()
    bad_ref = corrupt(Side(ref, port=False))
    bad_port = corrupt(Side(port_of(ref), port=True))
    want = _failure(ref_V.validate_layout, bad_ref, "lyr")
    got = _failure(V.validate_layout, bad_port, "lyr")
    assert type(want).__name__ == cls
    assert isinstance(got, V.LayoutError), got
    assert type(got).__name__ == cls
    assert (got.code, got.field, got.bin, got.path) == \
        (want.code, want.field, want.bin, want.path)
    assert got.path == "lyr"


def test_sharded_layout_is_refused_naming_item_9():
    """An unsharded layout that claims ``n_shards`` = 2 (tensor-parallel
    layouts are ported, ``tests/test_torch_sharding.py``) is a structure
    error: its nnz leaf lacks the shard axes, as the reference says."""
    lay = port_of(packed_case())
    ref = packed_case()
    object.__setattr__(lay, "n_shards", 2)
    with pytest.raises(V.LayoutStructureError, match="shard axes") as ei:
        V.validate_layout(lay)
    with pytest.raises(ref_V.LayoutStructureError) as ri:
        ref_V.validate_layout(dataclasses.replace(ref, n_shards=2))
    assert ei.value.field == ri.value.field == "nnz"


def test_finite_check_reads_each_value_bin_once(monkeypatch):
    """The values stay where they are: one ``isfinite(...).all()`` a float
    bin, no copy of a value bin to the host."""
    lay = port_of(packed_case())
    seen = []
    real = torch.isfinite
    monkeypatch.setattr(torch, "isfinite",
                        lambda t: seen.append(tuple(t.shape)) or real(t))
    V.validate_layout(lay)
    assert seen == [tuple(v.shape) for v in lay.values]


# -- tree walk ------------------------------------------------------------------

def test_validate_tree_counts_and_tags_path():
    tree = {"blk": {"ffn": {"packed": port_of(packed_case())},
                    "conv": {"packed": port_of(tap_case()),
                             "b": torch.zeros(3)}},
            "head": {"w": torch.zeros((4, 4))},
            "gone": {"packed": DegradedLayer("gone", "non_finite", "x"),
                     "w": torch.zeros((4, 4))}}
    assert V.validate_tree(tree) == 2
    lay = tree["blk"]["ffn"]["packed"]
    k = lay.k_idx[0].clone()
    k.view(-1)[0] = -5
    tree["blk"]["ffn"]["packed"] = dataclasses.replace(
        lay, k_idx=(k,) + lay.k_idx[1:])
    with pytest.raises(V.LayoutIndexError) as ei:
        V.validate_tree(tree)
    assert "blk/ffn/packed" in str(ei.value)
    assert ei.value.path == "blk/ffn/packed"


def test_roundtrip_after_validation_is_lossless():
    """Validation is a pure check: the layout's dense form is unchanged."""
    layout = port_of(packed_case())
    before = layout.to_dense().clone()
    V.validate_layout(layout)
    assert torch.equal(before, layout.to_dense())
