"""The port's dry run and roofline (``configs`` SHAPES / ``input_specs``,
``core.roofline``, ``launch.dryrun``, ``launch.roofline_report``) against
the reference's, with no process group in this process:

- (a) ``SHAPES``, ``ARCH_IDS``, ``supports_long``, ``cell_is_supported``
  (flag and text) of all 40 cells, and ``input_specs`` of all 10 archs x
  4 shapes at full size: names, shapes, dtypes, cache leaves by path;
- (b) ``param_counts`` at full size, ``model_flops``, ``analyze`` priced
  with ``V5E`` on hand-made records (the ``flops <= 0`` fallback, the
  ``flops_remat`` branch, the fixed ``N_DEVICES`` quirk), ``to_markdown``
  / ``load_and_analyze`` over a directory with a SKIP record, and the
  report CLI priced for the H100's datasheet;
- (c) ``_probe_cfgs`` and ``_batch_specs`` on the 16 x 16 and 2 x 16 x 16
  stand-in meshes;
- (d) in subprocesses with "fake" groups (8 and 256 ranks), checks
  that need no reference: the probe extrapolation equals the direct
  count at ``remat="none"`` on every family at SMOKE, a column-sharded
  linear counts 1/tp of its FLOPs per device, ``argument_bytes`` is the
  sum of the local shards worked out from the specs, yi-9b x decode_32k
  reaches OK at full size and long_500k gives the SKIP record;
- (e) the reference's ``collective_bytes`` of a hand-written HLO snippet
  equals the port's accounting of DTensor redistributes (and one
  all-to-all) of the same shapes; and the steps trace where DTensor's
  flatten of a non-first split dim, and a view that needs its input
  redistributed, are refused (the card's torch refuses both).

The collective counts of a real step against the dry run's are held on
gloo ranks (``testing.dist_ranks``' ``dryrun_decode``).
"""
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

# the reference's dry run sets XLA_FLAGS (512 host devices) when imported:
# start JAX's backend first and put the variable back afterwards
jax.devices()
_XLA_FLAGS = os.environ.get("XLA_FLAGS")
from repro.launch import dryrun as ref_DR  # noqa: E402
if _XLA_FLAGS is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _XLA_FLAGS

from repro import configs as ref_configs  # noqa: E402
from repro.configs import base as ref_base  # noqa: E402
from repro.core import roofline as ref_RL  # noqa: E402
from repro.distributed import sharding as ref_SH  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core import roofline as RL  # noqa: E402
from repro_torch.core.latency_model import V5E  # noqa: E402
from repro_torch.distributed import sharding as SH  # noqa: E402
from repro_torch.launch import dryrun as DR  # noqa: E402

from test_torch_dist_specs import FakeMesh, _port_flat, _ref_flat  # noqa: E402

ARCHS = sorted(configs.ALIASES)
SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")


# -- (a) configs -----------------------------------------------------------------

def test_shapes_and_arch_ids_equal_reference():
    assert configs.SHAPES == ref_configs.SHAPES
    assert configs.ARCH_IDS == ref_base.ARCH_IDS
    assert set(configs.__all__) == set(ref_configs.__all__)


@pytest.mark.parametrize("arch", ARCHS)
def test_cells_equal_reference(arch):
    p, r = configs.get(arch), ref_configs.get(arch)
    assert p.supports_long == r.supports_long
    assert p.unroll_layers == r.unroll_layers is False
    for shape in configs.SHAPES:
        assert configs.cell_is_supported(p, shape) == \
            ref_configs.cell_is_supported(r, shape)
    assert p.supports_long == (arch in ("mamba2-1.3b", "mixtral-8x7b",
                                        "hymba-1.5b"))


def _flat_specs(tree, path=()):
    """path -> (shape, dtype name) of a tree of meta tensors or
    ShapeDtypeStructs."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_specs(v, path + (k,)))
        return out
    return {"/".join(path): (tuple(tree.shape),
                             str(tree.dtype).replace("torch.", ""))}


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_equal_reference(arch):
    p, r = configs.get(arch), ref_configs.get(arch)
    for shape in configs.SHAPES:
        got = _flat_specs(configs.input_specs(p, shape))
        want = _flat_specs(ref_configs.input_specs(r, shape))
        assert got == want, shape
        assert all(t.is_meta for t in _leaves(configs.input_specs(p, shape)))


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def test_input_specs_batch_cut():
    cfg = configs.get("yi-9b")
    cut = configs.input_specs(cfg, "decode_32k", batch=2)
    assert tuple(cut["token"].shape) == (2, 1)
    assert tuple(cut["cache"]["kv"]["k"].shape) == (48, 2, 32768, 4, 128)


# -- (b) roofline ----------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_equal_reference(arch):
    assert RL.param_counts(configs.get(arch)) == \
        ref_RL.param_counts(ref_configs.get(arch))


def test_model_flops_equal_reference():
    for arch in ("yi-9b", "mixtral-8x7b", "kimi-k2-1t-a32b", "mamba2-1.3b"):
        for shape in configs.SHAPES.values():
            assert RL.model_flops(configs.get(arch), shape) == \
                ref_RL.model_flops(ref_configs.get(arch), shape)


def _records():
    """Hand-made records: plain, flops_remat, the flops <= 0 fallback, a
    512-device mesh (the fixed N_DEVICES quirk), no extrapolated costs."""
    ex = {"flops": 3.2e14, "bytes": 9.1e11, "coll": 4.4e9}
    return [
        ("yi-9b", "decode_32k", {"n_devices": 256, "extrapolated": ex}),
        ("yi-9b", "train_4k", {"n_devices": 256, "extrapolated": dict(
            ex, flops_remat=ex["flops"] * 4.0 / 3.0)}),
        ("mixtral-8x7b", "prefill_32k", {"n_devices": 256, "extrapolated":
                                         dict(ex, flops=-5.0)}),
        ("mamba2-1.3b", "long_500k", {"n_devices": 512, "extrapolated": dict(
            ex, coll=0.0)}),
        ("hymba-1.5b", "train_4k", {"n_devices": 256}),
    ]


def test_analyze_equal_reference_priced_v5e():
    for arch, shape, rec in _records():
        sh = configs.SHAPES[shape]
        got = RL.analyze(rec, configs.get(arch), sh, target=V5E)
        want = ref_RL.analyze(rec, ref_configs.get(arch), sh)
        assert got == want, (arch, shape)
    # the fallback prices MODEL_FLOPS per device; the quirk divides the
    # ideal time by 256 whatever the record's device count
    arch, shape, rec = _records()[2]
    cfg = configs.get(arch)
    mf = RL.model_flops(cfg, configs.SHAPES[shape])
    got = RL.analyze(rec, cfg, configs.SHAPES[shape], target=V5E)
    assert got["t_compute_s"] == mf / 256 / V5E.peak_flops
    arch, shape, rec = _records()[3]
    cfg = configs.get(arch)
    got = RL.analyze(rec, cfg, configs.SHAPES[shape], target=V5E)
    mf = RL.model_flops(cfg, configs.SHAPES[shape])
    assert RL.N_DEVICES == ref_RL.N_DEVICES == 256
    assert got["roofline_fraction"] == \
        mf / (256 * V5E.peak_flops) / got["step_time_bound_s"]
    assert got["hlo_flops_global"] == rec["extrapolated"]["flops"] * 512


def test_h100_target_is_the_datasheet():
    assert (RL.H100.peak_flops, RL.H100.hbm_bw, RL.H100.ici_bw) == \
        (989e12, 3.35e12, 50e9)
    arch, shape, rec = _records()[0]
    got = RL.analyze(rec, configs.get(arch), configs.SHAPES[shape])
    assert got["t_compute_s"] == rec["extrapolated"]["flops"] / 989e12
    assert got["t_collective_s"] == rec["extrapolated"]["coll"] / 50e9


def _write_records(d):
    # a single-mesh OK record without costs breaks the table's row
    # formatting in both packages (KeyError): it is left out here
    for arch, shape, rec in _records()[:4]:
        out = dict(rec, arch=arch, shape=shape, mesh="single", status="OK")
        (d / f"{arch}__{shape}__single.json").write_text(json.dumps(out))
    skip = {"arch": "yi-9b", "shape": "long_500k", "mesh": "single",
            "status": configs.cell_is_supported(configs.get("yi-9b"),
                                                "long_500k")[1]}
    (d / "yi-9b__long_500k__single.json").write_text(json.dumps(skip))
    (d / "yi-9b__decode_32k__multi.json").write_text(json.dumps(
        dict(_records()[0][2], arch="yi-9b", shape="decode_32k",
             mesh="multi", status="OK")))


def test_load_and_markdown_equal_reference(tmp_path, capsys):
    d = tmp_path / "dryrun"
    d.mkdir()
    _write_records(d)
    got = RL.load_and_analyze(d, target=V5E)
    want = ref_RL.load_and_analyze(d)
    assert got == want
    assert len(got) == 5 and any(r["status"].startswith("SKIP")
                                 for r in got)
    assert RL.to_markdown(got) == ref_RL.to_markdown(want)
    # the report CLI: priced for the H100, written beside the records
    from repro_torch.launch import roofline_report
    rows = roofline_report.main(["--dir", str(d)])
    out = capsys.readouterr().out
    assert "989 TFLOP/s" in out and "3.35 TB/s" in out and "50 GB/s" in out
    assert "datasheet" in out and "most collective-bound" in out
    assert rows == RL.load_and_analyze(d)
    assert (tmp_path / "roofline.md").read_text() == RL.to_markdown(rows)
    assert json.loads((tmp_path / "roofline.json").read_text())[0]["arch"] \
        == rows[0]["arch"]


# -- (c) probes and batch specs ----------------------------------------------------

MESHES = {"16x16": {"data": 16, "model": 16},
          "pod2x16x16": {"pod": 2, "data": 16, "model": 16}}


@pytest.mark.parametrize("arch", ARCHS)
def test_probe_cfgs_equal_reference(arch):
    got = DR._probe_cfgs(configs.get(arch))
    want = ref_DR._probe_cfgs(ref_configs.get(arch))
    assert got[2] == want[2]
    for p, r in zip(got[:2], want[:2]):
        assert {f: getattr(p, f) for f in p.__dataclass_fields__} == \
            {f: getattr(r, f) for f in r.__dataclass_fields__}


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_specs_equal_reference(arch, mesh):
    fm = FakeMesh(MESHES[mesh])
    p, r = configs.get(arch), ref_configs.get(arch)
    for shape, sh in configs.SHAPES.items():
        mode = p.train_shard_mode if sh["kind"] != "decode" else "tp"
        got = DR._batch_specs(p, shape, fm, SH.make_dist(
            fm, p, sh["batch"], mode=mode))
        want = ref_DR._batch_specs(r, shape, fm, ref_SH.make_dist(
            fm, r, sh["batch"], mode=mode))
        assert _port_flat(got) == _ref_flat(want), shape


# -- (d), (e): fake groups in subprocesses ---------------------------------------------

HEADER = r'''
import json, math, warnings, logging
warnings.filterwarnings("ignore"); logging.disable(logging.WARNING)
import torch, torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Partial, Replicate, Shard, DTensor
from repro_torch import configs
from repro_torch.distributed import sharding as SH
from repro_torch.launch import dryrun as DR, mesh as MESH
from repro_torch.models import module as M
from repro_torch.models.module import P
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
out = {}
mesh = MESH.make_mesh((2, 4), ("data", "model"), "cpu")
'''

PROBES = HEADER + r'''
FAMILY = {"dense": ("yi-9b", "train_4k"), "moe": ("mixtral-8x7b", "decode_32k"),
          "ssm": ("mamba2-1.3b", "decode_32k"), "hybrid": ("hymba-1.5b", "decode_32k"),
          "encdec": ("seamless-m4t-large-v2", "prefill_32k"),
          "vlm": ("llama-3.2-vision-90b", "decode_32k")}
for fam, (arch, shape) in FAMILY.items():
    cfg = configs.get(arch, smoke=True).replace(remat="none")
    if fam == "vlm":
        cfg = cfg.replace(n_layers=3 * cfg.cross_attn_interval)
    else:
        cfg = cfg.replace(n_layers=3, **({"n_enc_layers": 3}
                                         if fam == "encdec" else {}))
    direct = DR._costs(cfg, shape, mesh, "cpu")
    ex = DR.probe_extrapolated(cfg, shape, mesh, "cpu")
    out[f"probe_{fam}"] = {"direct": [direct["flops"], direct["bytes"]],
                           "probe": [ex["flops"], ex["bytes"]],
                           "units": ex["units"]}
print("RESULT " + json.dumps(out))
dist.destroy_process_group()
'''

ACCOUNTING = HEADER + r'''
# a column-sharded linear at (1, 4): ranks 0-3 of the group
m14 = DeviceMesh("cpu", torch.arange(4).reshape(1, 4),
                 mesh_dim_names=("data", "model"))
x = torch.empty(8, 64, device="meta")
w = torch.empty(64, 128, device="meta")
c = DR.trace(lambda x, w: x @ w, (x, w), (P(), P(None, "model")), m14, "cpu")
out["linear"] = {"flops": c["flops"], "full": 2 * 8 * 64 * 128,
                 "coll": c["coll"]}

# argument bytes against the local shards worked out from the specs
def local_bytes(meta, spec, shape):
    if isinstance(meta, dict):
        return sum(local_bytes(meta[k], spec[k], shape) for k in meta)
    dims = list(meta.shape)
    for d, entry in enumerate(tuple(spec)):
        names = entry if isinstance(entry, tuple) else (entry,)
        for n in names:
            if n is not None:
                dims[d] = -(-dims[d] // shape[n])
    return math.prod(dims) * meta.element_size()
for arch, shape in (("yi-9b", "train_4k"), ("kimi-k2-1t-a32b", "train_4k"),
                    ("yi-9b", "decode_32k")):
    cfg = configs.get(arch, smoke=True)
    fn, args, specs = DR.build_step(cfg, shape, mesh)
    c = DR.trace(fn, args, specs, mesh, "cpu")
    want = sum(local_bytes(a, s, SH.mesh_shape(mesh))
               for a, s in zip(args, specs))
    out[f"args_{arch}_{shape}"] = [c["memory"]["argument_bytes"], want,
                                   c["memory"]["peak_bytes"]]

# redistributes for the reference's HLO accounting, on (1, 4)
def redist(local_shape, dtype, src, dst):
    def f(t):
        d = DTensor.from_local(t, m14, src, run_check=False)
        return d.redistribute(m14, dst).to_local()
    t = torch.empty(local_shape, dtype=dtype, device="meta")
    return DR.trace(f, (t,), (None,), m14, "cpu")
res = {}
for name, args in {
        "all-gather": ((8, 32), torch.bfloat16, [Replicate(), Shard(1)],
                       [Replicate(), Replicate()]),
        "all-reduce": ((16, 64), torch.float32, [Replicate(), Partial()],
                       [Replicate(), Replicate()]),
        "reduce-scatter": ((16, 64), torch.float32, [Replicate(), Partial()],
                           [Replicate(), Shard(0)])}.items():
    c = redist(*args)
    res[name] = [c["coll_by_op"], c["coll_counts"]]
from torch.distributed import _functional_collectives as funcol
def a2a(t):
    return funcol.all_to_all_single(t, None, None, m14.get_group("model"))
c = DR.trace(a2a, (torch.empty(32, 32, dtype=torch.bfloat16, device="meta"),),
             (None,), m14, "cpu")
res["all-to-all"] = [c["coll_by_op"], c["coll_counts"]]
out["redistribute"] = res

# an older DTensor (the card's) refuses to flatten dims when a non-first
# one is split, where this one makes a _StridedShard, and refuses a view
# that needs its input redistributed: refuse both here too
import torch.distributed.tensor._ops._view_ops as VO
from torch.distributed.tensor.placement_types import _StridedShard
loose = VO.propagate_shape_and_sharding
def strict(placements, shape, rule, sizes, strict_view=False):
    tgt, outp = loose(placements, shape, rule, sizes, strict_view)
    if any(isinstance(p, _StridedShard) for p in outp) and \
            not any(isinstance(p, _StridedShard) for p in placements):
        raise RuntimeError("flattened a non-first split dim")
    if strict_view and tuple(tgt) != tuple(placements):
        raise RuntimeError("a view needs its input redistributed")
    return tgt, outp
VO.propagate_shape_and_sharding = strict
# mixtral's dispatch groups of 2048 tokens straddle this mesh's sequence
# split (1024 a rank), as 1024-token groups straddle (16, 16)'s (256)
for arch, shape, kw in (("yi-9b", "train_4k", {}),
                        ("mamba2-1.3b", "train_4k", {}),
                        ("mixtral-8x7b", "train_4k", {"moe_group": 2048}),
                        ("hymba-1.5b", "decode_32k", {}),
                        ("seamless-m4t-large-v2", "decode_32k", {})):
    c = DR._costs(configs.get(arch, smoke=True).replace(**kw), shape, mesh,
                  "cpu")
    out[f"strict_{arch}_{shape}"] = c["flops"]
VO.propagate_shape_and_sharding = loose
print("RESULT " + json.dumps(out))
dist.destroy_process_group()
'''

PROD_CHECKS = r'''
import json, warnings, logging
warnings.filterwarnings("ignore"); logging.disable(logging.WARNING)
import torch.distributed as dist
from repro_torch.launch import dryrun as DR
rec = DR.run_cell("yi-9b", "decode_32k", False, save=False, verbose=False,
                  probe=False, device="cpu")
skip = DR.run_cell("yi-9b", "long_500k", False, save=False, verbose=False,
                   device="cpu")
print("RESULT " + json.dumps({"ok": rec, "skip": skip,
                              "group_left": dist.is_initialized()}))
'''


@pytest.fixture(scope="module")
def fake_runs():
    """The three subprocesses, run at once: {name: parsed RESULT
    line}."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [SRC] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    procs = {name: subprocess.Popen(
        [sys.executable, "-c", code], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
        for name, code in (("probes", PROBES), ("accounting", ACCOUNTING),
                           ("prod", PROD_CHECKS))}
    done = {}
    try:
        for name, p in procs.items():
            so, se = p.communicate(timeout=400)
            assert p.returncode == 0, se[-4000:]
            line = next(x for x in so.splitlines()
                        if x.startswith("RESULT "))
            done[name] = json.loads(line[len("RESULT "):])
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
    return done


@pytest.mark.parametrize("family", ["dense", "moe", "ssm", "hybrid",
                                    "encdec", "vlm"])
def test_probe_extrapolation_equals_direct_count(fake_runs, family):
    r = fake_runs["probes"][f"probe_{family}"]
    assert r["units"] == 3
    assert r["probe"] == r["direct"], r
    assert r["direct"][0] > 0 and r["direct"][1] > 0


def test_column_sharded_linear_counts_its_shard(fake_runs):
    r = fake_runs["accounting"]["linear"]
    assert r["flops"] * 4 == r["full"]
    assert r["coll"] == 0


@pytest.mark.parametrize("cell", ["yi-9b_train_4k", "kimi-k2-1t-a32b_train_4k",
                                  "yi-9b_decode_32k"])
def test_argument_bytes_are_the_local_shards(fake_runs, cell):
    got, want, peak = fake_runs["accounting"][f"args_{cell}"]
    assert got == want
    assert peak >= got


def test_production_cell_and_skip_record(fake_runs):
    r = fake_runs["prod"]
    rec = r["ok"]
    assert rec["status"] == "OK" and rec["n_devices"] == 256
    assert rec["cost"]["flops"] > 0 and rec["cost"]["bytes accessed"] > 0
    assert set(rec["collectives"]) == set(ref_DR._COLLECTIVES) | {
        "total", "counts"}
    assert rec["collectives"]["total"] == sum(
        rec["collectives"][k] for k in ref_DR._COLLECTIVES)
    assert set(rec["memory"]) == {"argument_bytes", "output_bytes",
                                  "temp_bytes", "peak_bytes"}
    assert rec["memory"]["peak_bytes"] >= rec["memory"]["argument_bytes"]
    assert "trace_s" in rec and "extrapolated" not in rec
    want = {"arch": "yi-9b", "shape": "long_500k", "mesh": "single",
            "status": ref_configs.cell_is_supported(
                ref_configs.get("yi-9b"), "long_500k")[1]}
    assert r["skip"] == want
    assert not r["group_left"]


def test_collective_sites_split_the_total(fake_runs):
    """``collective_sites`` splits the collective bytes by the port's
    function that asked for them, to the byte; the full-size decode step
    gathers the most in its attention over the cache."""
    rec = fake_runs["prod"]["ok"]
    sites = rec["collective_sites"]
    assert sum(sites.values()) == rec["collectives"]["total"] > 0
    assert list(sites.values()) == sorted(sites.values(), reverse=True)
    assert next(iter(sites)).startswith("models/attention.py:")


@pytest.mark.parametrize("cell", ["yi-9b_train_4k", "mamba2-1.3b_train_4k",
                                  "mixtral-8x7b_train_4k",
                                  "hymba-1.5b_decode_32k",
                                  "seamless-m4t-large-v2_decode_32k"])
def test_steps_need_no_strided_flattening(fake_runs, cell):
    """The steps trace on a (2, 4) mesh with DTensor's flatten of a
    non-first split dim refused, and a view that needs its input
    redistributed, as an older DTensor refuses both (the gradient of a
    matmul's output or of the MoE regrouping, the SSM decode state, the
    cross cache): each such place runs per rank or brings its split
    back."""
    assert fake_runs["accounting"][f"strict_{cell}"] > 0


HLO = """
  %all-gather.1 = bf16[8,128]{1,0} all-gather(bf16[8,32]{1,0} %p0), channel_id=1, replica_groups={{0,1,2,3}}, dimensions={1}
  %all-reduce.2 = f32[16,64]{1,0} all-reduce(f32[16,64]{1,0} %p1), channel_id=2, replica_groups={{0,1,2,3}}, to_apply=%add
  %reduce-scatter.3 = f32[4,64]{1,0} reduce-scatter(f32[16,64]{1,0} %p2), channel_id=3, replica_groups={{0,1,2,3}}, dimensions={0}, to_apply=%add
  %all-to-all.4 = bf16[32,32]{1,0} all-to-all(bf16[32,32]{1,0} %p3), channel_id=4, replica_groups={{0,1,2,3}}, dimensions={0}
"""


def test_collective_accounting_equals_reference(fake_runs):
    res = fake_runs["accounting"]["redistribute"]
    for op in ("all-gather", "all-reduce", "reduce-scatter", "all-to-all"):
        lines = [x for x in HLO.splitlines() if f" {op}(" in x]
        want = ref_DR.collective_bytes("\n".join(lines))
        by_op, counts = res[op]
        assert by_op == {k: want[k] for k in ref_DR._COLLECTIVES}, op
        assert counts == want["counts"], op
    total = ref_DR.collective_bytes(HLO)
    assert total["total"] == sum(sum(v[0].values()) for v in res.values())


def test_importing_dryrun_starts_nothing():
    code = ("import os, sys\n"
            "before = dict(os.environ)\n"
            "import repro_torch.launch.dryrun, repro_torch.launch.roofline_report\n"
            "import torch.distributed as dist\n"
            "print(dist.is_initialized(), dict(os.environ) == before)\n")
    env = dict(os.environ, PYTHONPATH=SRC)
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split() == ["False", "True"]


def test_reference_import_left_xla_flags_alone():
    assert os.environ.get("XLA_FLAGS") == _XLA_FLAGS


def test_cli_writes_skip_record(tmp_path):
    DR.main(["--arch", "yi-9b", "--shape", "long_500k", "--mesh", "both",
             "--device", "cpu", "--out", str(tmp_path)])
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == ["yi-9b__long_500k__multi.json",
                     "yi-9b__long_500k__single.json"]
    rec = json.loads((tmp_path / names[1]).read_text())
    assert rec == {"arch": "yi-9b", "shape": "long_500k", "mesh": "single",
                   "status": configs.cell_is_supported(
                       configs.get("yi-9b"), "long_500k")[1]}
