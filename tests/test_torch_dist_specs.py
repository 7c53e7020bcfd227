"""The port's sharding policy (``distributed.sharding``, ``models.module.
spec_from_rules``, ``launch.mesh``) against the reference's, with no
process group: the spec functions read only ``mesh.shape``, so both
packages take the reference's own stand-in mesh (an object whose
``shape`` maps axis names to sizes, ``tests/test_distributed.py``).

- ``param_specs`` in "tp" and "fsdp" mode for all ten archs at full
  size, leaf for leaf, on {data 16, model 16}, {pod 2, data 16, model 16},
  {data 1, model 2} and {data 1, model 4}: the port's shapes come from
  ``init_lm(device="meta")``, the reference's from ``jax.eval_shape``;
- ``opt_state_specs`` (AdamW, Adafactor), ``fsdp_leaf_spec`` and
  ``make_dist``'s fields per arch, mesh and global batch;
- ``layout_partition_specs`` / ``expert_layout_specs`` on block and tap
  layouts at S = 2, 4, float and int8, built by the reference and
  crossed with ``convert``;
- ``P`` to DTensor placements, and ``make_production_mesh`` under a
  256- / 512-rank "fake" group, in a subprocess (no group is started in
  the test process).
"""
import dataclasses
import functools
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.distributed import sharding as ref_SH  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro.models import module as ref_M  # noqa: E402
from repro.models import transformer as ref_T  # noqa: E402
from repro.optim import adamw as ref_opt  # noqa: E402
from repro.serve.compile import _pack_stacked  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.convert import layout_from_numpy  # noqa: E402
from repro_torch.distributed import sharding as SH  # noqa: E402
from repro_torch.models import module as M  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.optim import adamw as opt  # noqa: E402

from test_torch_reference import ref_to_numpy  # noqa: E402

ARCHS = sorted(configs.ALIASES)
MESHES = {"16x16": {"data": 16, "model": 16},
          "pod2x16x16": {"pod": 2, "data": 16, "model": 16},
          "1x2": {"data": 1, "model": 2},
          "1x4": {"data": 1, "model": 4}}


class FakeMesh:
    """The reference's stand-in: only ``shape``, axis name -> size."""

    def __init__(self, shape):
        self.shape = dict(shape)


def _entries(spec):
    return None if spec is None else tuple(spec)


def _ref_flat(tree):
    """path -> spec entries of a reference spec tree."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {ref_M.path_str(p): _entries(s) for p, s in flat}


def _port_flat(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_port_flat(v, path + (k,)))
        return out
    return {M.path_str(path): _entries(tree)}


@functools.lru_cache(maxsize=None)
def _ref_abstract(arch):
    cfg = ref_configs.get(arch)
    return cfg, jax.eval_shape(lambda: ref_T.init_lm(jax.random.PRNGKey(0),
                                                     cfg))


@functools.lru_cache(maxsize=None)
def _port_meta(arch):
    cfg = configs.get(arch)
    return cfg, T.init_lm(cfg, device="meta")


# -- param specs ---------------------------------------------------------------

@pytest.mark.parametrize("mode", ["tp", "fsdp"])
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_reference(arch, mesh, mode):
    rcfg, rparams = _ref_abstract(arch)
    pcfg, pparams = _port_meta(arch)
    fm = FakeMesh(MESHES[mesh])
    want = _ref_flat(ref_SH.param_specs(rparams, rcfg, fm, mode=mode))
    got = _port_flat(SH.param_specs(pparams, pcfg, fm, mode=mode))
    assert got == want


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
@pytest.mark.parametrize("arch", ["yi-9b", "mixtral-8x7b", "kimi-k2-1t-a32b",
                                  "llama-3.2-vision-90b", "hymba-1.5b"])
def test_opt_state_specs_equal_reference(arch, kind):
    rcfg, rparams = _ref_abstract(arch)
    pcfg, pparams = _port_meta(arch)
    fm = FakeMesh(MESHES["16x16"])
    r_init = ref_opt.adamw_init if kind == "adamw" else ref_opt.adafactor_init
    p_init = opt.adamw_init if kind == "adamw" else opt.adafactor_init
    want = _ref_flat(ref_SH.opt_state_specs(
        jax.eval_shape(r_init, rparams),
        ref_SH.param_specs(rparams, rcfg, fm), kind))
    got = _port_flat(SH.opt_state_specs(
        p_init(pparams), SH.param_specs(pparams, pcfg, fm), kind))
    assert got == want


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_fsdp_leaf_spec_equal_reference(mesh):
    fm = FakeMesh(MESHES[mesh])
    shapes = [(7,), (64,), (4096, 4096), (4096, 11008), (11008, 4096),
              (2, 16), (3, 5), (384, 7168, 2048), (48, 4096, 512),
              (32001, 1600), (1, 1), (512, 3)]
    for shape in shapes:
        assert _entries(SH.fsdp_leaf_spec(shape, fm)) == \
            _entries(ref_SH.fsdp_leaf_spec(shape, fm)), shape


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_make_dist_fields_equal_reference(mesh):
    fm = FakeMesh(MESHES[mesh])
    fields = ("batch_axes", "model_axis", "kv_shardable", "expert_sharded",
              "vocab_shardable", "mode", "tp", "dp")
    for arch in ARCHS:
        for batch in (1, 2, 3, 4, 16, 32, 256):
            for mode in ("tp", "fsdp"):
                r = ref_SH.make_dist(fm, ref_configs.get(arch), batch,
                                     mode=mode)
                p = SH.make_dist(fm, configs.get(arch), batch, mode=mode)
                for f in fields:
                    assert getattr(p, f) == getattr(r, f), (arch, batch, f)
    for arch in ARCHS:
        r, p = ref_configs.get(arch), configs.get(arch)
        assert (p.attn_shard, p.train_shard_mode) == \
            (r.attn_shard, r.train_shard_mode)
        assert SH.needs_fsdp(p) == ref_SH.needs_fsdp(r)


# -- layout specs ----------------------------------------------------------------

def _layout_spec_fields(specs, fields):
    out = {}
    for f in fields:
        v = getattr(specs, f)
        is_bins = isinstance(v, tuple) and not isinstance(
            v, (M.P, jax.sharding.PartitionSpec))
        out[f] = tuple(_entries(s) for s in v) if is_bins else _entries(v)
    return out


PACKED = ("values", "k_idx", "nnz", "perm", "inv_perm", "scales")
TAP = ("values", "t_idx", "nnz", "alive", "perm", "inv_perm", "k_full",
       "scales")


def _block_fixture(seed, K=64, N=128, bk=8, bn=8):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((K, N)).astype(np.float32)
    mask = np.kron(rng.random((K // bk, N // bn)) < 0.5,
                   np.ones((bk, bn), bool))
    return w, mask, (bk, bn)


@pytest.mark.parametrize("value_dtype", [None, "int8"])
@pytest.mark.parametrize("S", [0, 2, 4])
def test_layout_partition_specs_equal_reference(S, value_dtype):
    w, mask, block = _block_fixture(S)
    ref = ref_ops.pack(w, mask, block, n_shards=S, reorder=True,
                       value_dtype=value_dtype, use_cache=False)
    port = layout_from_numpy(ref_to_numpy(ref), "cpu")
    want = _layout_spec_fields(ref_SH.layout_partition_specs(ref), PACKED)
    got = _layout_spec_fields(SH.layout_partition_specs(port), PACKED)
    assert got == want
    assert ("model" in want["nnz"]) == bool(S)


@pytest.mark.parametrize("value_dtype", [None, "int8"])
@pytest.mark.parametrize("S", [2, 4])
def test_tap_partition_specs_equal_reference(S, value_dtype):
    rng = np.random.default_rng(10 + S)
    w = rng.standard_normal((16, 8, 3, 3)).astype(np.float32)
    mask = rng.random((16, 8, 3, 3)) < 0.4
    mask[0] = True
    ref = ref_ops.pack_taps(w, mask, n_shards=S, value_dtype=value_dtype,
                            use_cache=False)
    port = layout_from_numpy(ref_to_numpy(ref), "cpu")
    want = _layout_spec_fields(ref_SH.layout_partition_specs(ref), TAP)
    got = _layout_spec_fields(SH.layout_partition_specs(port), TAP)
    assert got == want


@pytest.mark.parametrize("value_dtype", [None, "int8"])
def test_expert_layout_specs_equal_reference(value_dtype):
    rng = np.random.default_rng(8)
    E, din, dout, bk = 4, 32, 48, 8
    w = rng.standard_normal((E, din, dout)).astype(np.float32)
    mb = rng.random((E, din // bk, dout // bk)) < 0.5
    mask = np.kron(mb, np.ones((bk, bk), bool))
    ref, _ = _pack_stacked(w, mask, (bk, bk))
    if value_dtype:
        from repro.core import quant as ref_Q
        ref = ref_Q.quantize_layout(ref, value_dtype=value_dtype)
    port = layout_from_numpy(ref_to_numpy(ref), "cpu")
    want = _layout_spec_fields(ref_SH.expert_layout_specs(ref), PACKED)
    got = _layout_spec_fields(SH.expert_layout_specs(port), PACKED)
    assert got == want
    with pytest.raises(AssertionError):
        sharded = dataclasses.replace(port, n_shards=2)
        SH.expert_layout_specs(sharded)


# -- spec_from_rules and placements --------------------------------------------------

def test_spec_from_rules_right_aligns_and_trims_as_the_reference():
    rules = [(r"a/w", ("data", "model")), (r"b", ("model",)),
             (r"c", ("pod", "data", "model"))]
    shapes = {"a": {"w": (3, 4, 5)}, "b": {"x": (7,)}, "c": (2, 3),
              "d": (4, 4), "s": ()}
    port_rules = [(p, M.P(*s)) for p, s in rules]
    ref_rules = [(p, jax.sharding.PartitionSpec(*s)) for p, s in rules]
    got = _port_flat(M.spec_from_rules(
        M.tree_map(lambda s: torch.empty(s, device="meta"), shapes),
        port_rules))
    want = _ref_flat(ref_M.spec_from_rules(
        jax.tree_util.tree_map(lambda s: jax.ShapeDtypeStruct(s, np.float32),
                               shapes, is_leaf=lambda x: isinstance(x, tuple)),
        ref_rules))
    assert got == want


def test_p_placements_name_mesh_dims():
    from torch.distributed.tensor import Replicate, Shard

    class Mesh:
        mesh_dim_names = ("pod", "data", "model")

        def __init__(self, sizes=(2, 2, 2)):
            self.sizes = sizes

        def size(self, i):
            return self.sizes[i]

    assert M.P(None, "model").placements(Mesh()) == \
        (Replicate(), Replicate(), Shard(1))
    assert M.P(("pod", "data"), None).placements(Mesh()) == \
        (Shard(0), Shard(0), Replicate())
    assert M.P().placements(Mesh()) == (Replicate(),) * 3
    # a mesh dim of size 1 splits nothing
    assert M.P(("pod", "data"), "model").placements(Mesh((1, 2, 1))) == \
        (Replicate(), Shard(0), Replicate())
    with pytest.raises(ValueError):
        M.P("expert").placements(Mesh())


PROD_MESH = """
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.launch import mesh as MESH
from repro_torch.distributed import sharding as SH
from repro_torch import configs
dist.init_process_group("fake", store=FakeStore(), rank=3, world_size={n})
m = MESH.make_production_mesh(multi_pod={pod}, device="cpu")
print(m.mesh_dim_names, tuple(m.shape), SH.mesh_shape(m))
d = SH.make_dist(m, configs.get("yi-9b"), 256)
print(d.tp, d.dp, d.batch_axes)
try:
    MESH.make_local_mesh(tp=1024, device="cpu")
except ValueError as e:
    print("refused", e)
dist.destroy_process_group()
"""


@pytest.mark.parametrize("pod", [False, True])
def test_production_mesh_under_a_fake_group(pod):
    n = 512 if pod else 256
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(os.path.dirname(__file__), "..", "src")]
        + sys.path))
    out = subprocess.run([sys.executable, "-c",
                          PROD_MESH.format(n=n, pod=pod)],
                         capture_output=True, text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.splitlines()
    axes = ("pod", "data", "model") if pod else ("data", "model")
    shape = (2, 16, 16) if pod else (16, 16)
    assert lines[0] == f"{axes} {shape} {dict(zip(axes, shape))}"
    assert lines[1] == (f"16 {32 if pod else 16} "
                        f"{('pod', 'data') if pod else ('data',)}")
    assert lines[2].startswith("refused tp=1024")


def test_local_mesh_refuses_more_ranks_than_the_group_has():
    """No group is running here: above one rank make_local_mesh refuses
    (it never starts a group it cannot fill, nor falls back)."""
    from repro_torch.launch import mesh as MESH
    import torch.distributed as dist
    assert not dist.is_initialized()
    with pytest.raises(ValueError):
        MESH.make_local_mesh(tp=2, device="cpu")
    with pytest.raises(ValueError):
        MESH.make_local_mesh(tp=0, device="cpu")
    assert not dist.is_initialized()
