"""Crossing parameters from the JAX reference into the PyTorch port.

Besides its own tests, this module holds the helpers the other
``test_torch_*`` files share: the jax-side flattening of reference trees
to numpy (the port's ``convert`` takes numpy only) and the seeded inputs
both packages are fed."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.core.packed import PackedLayout as RefLayout  # noqa: E402
from repro.core.packed import TapLayout as RefTapLayout  # noqa: E402
from repro.models import module as ref_module  # noqa: E402
from repro.models import transformer as ref_T  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.convert import params_from_numpy, tensor_from_numpy  # noqa: E402,E501
from repro_torch.models import transformer as T  # noqa: E402

# the serving CLI's prune spec (repro/launch/serve.py SPARSE_SPEC, FC part)
SPEC_RE = r"(attn/w[qkvo]|(ffn|moe)/(gate|up|down))/w"


# -- helpers shared by the test_torch_* files --------------------------------

def ref_to_numpy(tree):
    """A reference param/mask tree -> numpy nested dicts; a reference
    ``PackedLayout`` or ``TapLayout`` becomes the dict
    ``convert.layout_from_numpy`` reads."""
    if isinstance(tree, dict):
        return {k: ref_to_numpy(v) for k, v in tree.items()}

    def opt(a):
        return None if a is None else np.asarray(a)

    def opt_bins(t):
        return None if t is None else [np.asarray(a) for a in t]
    if isinstance(tree, RefLayout):
        return {"values": [np.asarray(v) for v in tree.values],
                "k_idx": [np.asarray(k) for k in tree.k_idx],
                "nnz": np.asarray(tree.nnz), "perm": opt(tree.perm),
                "inv_perm": opt(tree.inv_perm), "block": tree.block,
                "shape": tree.shape, "conv_taps": tree.conv_taps,
                "scales": opt_bins(tree.scales), "n_shards": tree.n_shards}
    if isinstance(tree, RefTapLayout):
        return {"values": [np.asarray(v) for v in tree.values],
                "t_idx": [np.asarray(t) for t in tree.t_idx],
                "k_full": (None if tree.k_full is None
                           else [np.asarray(k) for k in tree.k_full]),
                "nnz": np.asarray(tree.nnz), "alive": np.asarray(tree.alive),
                "perm": opt(tree.perm), "inv_perm": opt(tree.inv_perm),
                "group": tree.group, "shape": tree.shape,
                "scales": opt_bins(tree.scales), "n_shards": tree.n_shards}
    return np.asarray(tree)


def to_port(tree, device="cpu"):
    """A reference tree as the port's tree of tensors."""
    return params_from_numpy(ref_to_numpy(tree), device)


def ref_smoke_params(dtype=jnp.float32, seed=0, **over):
    """(reference cfg, port cfg, reference params) for yi-9b SMOKE."""
    rcfg = ref_configs.get("yi-9b", smoke=True).replace(**over)
    pcfg = configs.get("yi-9b", smoke=True).replace(**over)
    params = ref_module.cast_tree(
        ref_T.init_lm(jax.random.PRNGKey(seed), rcfg), dtype)
    return rcfg, pcfg, params


def block_case(K, N, block, dtype=np.float32, keep=0.45, seed=0):
    """Seeded (w, mask): whole dead blocks plus scattered zeros inside live
    blocks (a block is live iff ANY mask entry in it survives)."""
    rng = np.random.RandomState(seed)
    bk, bn = block
    w = rng.randn(K, N).astype(np.float32)
    live = rng.rand(K // bk, N // bn) < keep
    live[:, 0] = False                      # one empty column
    live[:, -1] = True                      # one full column
    mask = np.repeat(np.repeat(live, bk, 0), bn, 1)
    mask &= rng.rand(K, N) < 0.9
    return w.astype(dtype), mask.astype(np.float32)


def packed_nodes(tree, path=""):
    """{path: layout} of every ``packed`` entry of a param tree."""
    if not isinstance(tree, dict):
        return {}
    out = {}
    for k, v in tree.items():
        p = f"{path}/{k}" if path else k
        if k == "packed":
            out[path] = v
        else:
            out.update(packed_nodes(v, p))
    return out


def _assert_scales_equal(port, ref):
    """The fp32 scale leaves of two quantized layouts bit-equal (or both
    float layouts)."""
    assert (port.scales is None) == (ref.scales is None)
    for p, r in zip(port.scales or (), ref.scales or ()):
        r = np.asarray(r)
        assert p.dtype == torch.float32 and tuple(p.shape) == r.shape
        np.testing.assert_array_equal(p.cpu().numpy().view(np.int32),
                                      r.view(np.int32))


def assert_layout_equal(port, ref):
    """Leaf-for-leaf equality: integer leaves equal, values and scales
    bit-equal (and the same ``conv_taps``)."""
    assert port.block == tuple(ref.block) and port.shape == tuple(ref.shape)
    assert port.conv_taps == ref.conv_taps
    assert port.n_bins == ref.n_bins and port.n_shards == ref.n_shards
    assert (port.perm is None) == (ref.perm is None)
    pairs = [(port.nnz, ref.nnz)]
    pairs += list(zip(port.k_idx, ref.k_idx))
    if ref.perm is not None:
        pairs += [(port.perm, ref.perm), (port.inv_perm, ref.inv_perm)]
    for p, r in pairs:
        r = np.asarray(r)
        assert p.dtype == torch.int32
        np.testing.assert_array_equal(p.cpu().numpy(), r)
    for p, r in zip(port.values, ref.values):
        r = tensor_from_numpy(np.asarray(r), "cpu")
        assert p.dtype == r.dtype and p.shape == r.shape
        assert torch.equal(p.cpu(), r)
    _assert_scales_equal(port, ref)


def assert_tap_layout_equal(port, ref):
    """TapLayout leaf for leaf: integer leaves equal, values and scales
    bit-equal."""
    assert port.group == ref.group and port.shape == tuple(ref.shape)
    assert port.n_bins == ref.n_bins and port.n_shards == ref.n_shards
    assert (port.perm is None) == (ref.perm is None)
    pairs = [(port.nnz, ref.nnz), (port.alive, ref.alive)]
    pairs += list(zip(port.t_idx, ref.t_idx))
    pairs += list(zip(port.k_full, ref.k_full))
    if ref.perm is not None:
        pairs += [(port.perm, ref.perm), (port.inv_perm, ref.inv_perm)]
    for p, r in pairs:
        r = np.asarray(r)
        assert p.dtype == torch.int32
        np.testing.assert_array_equal(p.cpu().numpy(), r)
    for p, r in zip(port.values, ref.values):
        r = tensor_from_numpy(np.asarray(r), "cpu")
        assert p.dtype == r.dtype and p.shape == r.shape
        assert torch.equal(p.cpu(), r)
    _assert_scales_equal(port, ref)


# -- tests --------------------------------------------------------------------

def test_bf16_crosses_bit_exact():
    x = jax.random.normal(jax.random.PRNGKey(3), (5, 7), jnp.bfloat16)
    t = tensor_from_numpy(np.asarray(x), "cpu")
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        t.view(torch.int16).numpy(), np.asarray(x).view(np.int16))


def _flat_structure(t, path=()):
    """{path: (shape, dtype)} of every leaf of a port tree."""
    if isinstance(t, dict):
        return {k: v for kk, vv in t.items()
                for k, v in _flat_structure(vv, path + (kk,)).items()}
    return {"/".join(path): (tuple(t.shape), t.dtype)}


def test_params_tree_matches_port_init_structure():
    """The reference's tree crosses into exactly the structure, shapes and
    dtypes the port's own ``init_lm`` builds."""
    rcfg, pcfg, rparams = ref_smoke_params(jnp.bfloat16)
    crossed = to_port(rparams)
    own = T.init_lm(pcfg, seed=0, device="cpu")
    assert _flat_structure(crossed) == _flat_structure(own)


def test_moe_params_tree_matches_port_init_structure():
    """The MoE family: the reference's own init (bf16 weights, the router
    fp32) crosses into the structure, shapes and dtypes of the port's
    ``init_lm``, layers {ln1, attn, ln2, moe} with the experts stacked
    (layers, experts, ...)."""
    rcfg = ref_configs.get("mixtral-8x7b", smoke=True)
    pcfg = configs.get("mixtral-8x7b", smoke=True)
    crossed = _flat_structure(to_port(ref_T.init_lm(jax.random.PRNGKey(0),
                                                    rcfg)))
    own = _flat_structure(T.init_lm(pcfg, seed=0, device="cpu"))
    assert crossed == own
    assert own["layers/moe/router/w"] == ((2, 64, 4), torch.float32)
    assert own["layers/moe/gate/w"] == ((2, 4, 64, 128), torch.bfloat16)
    assert "layers/ffn/gate/w" not in own


def test_port_init_is_seeded_and_scaled():
    """Same seed, same weights; projections are fan-in scaled truncated
    normals, embeddings N(0, 0.02)."""
    cfg = configs.get("yi-9b", smoke=True)
    a = T.init_lm(cfg, seed=1, device="cpu")
    b = T.init_lm(cfg, seed=1, device="cpu")
    wq = a["layers"]["attn"]["wq"]["w"].float()
    assert torch.equal(wq, b["layers"]["attn"]["wq"]["w"].float())
    assert wq.abs().max() <= 2.0 * cfg.d_model ** -0.5 + 1e-3
    assert abs(wq.std().item() * cfg.d_model ** 0.5 - 0.88) < 0.1
    emb = a["embed"]["table"].float()
    assert abs(emb.std().item() - 0.02) < 0.003


def test_entry_points_refuse_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    cfg = configs.get("yi-9b", smoke=True)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        T.init_lm(cfg)
