"""The port's artifact store (``serve.artifacts``) and ``compile_model(
artifact_dir=)`` against the reference's.

- ``model_digest`` equals the reference's on the same (crossed) weights,
  masks and mapping: yi-9b SMOKE in fp32 and bf16, and with int8 values;
- a store written by the reference loads in the port, and one written by
  the port loads in the reference: integer leaves equal, values
  bit-equal, report rows equal;
- every case of the reference's ``tests/test_artifacts.py`` (its
  pack-cache case is in ``test_torch_surface.py``), each corruption applied
  to a store of each package and giving the reference's error ``code``
  in both, the port's warm or repacked tree identical to its cold one.
"""
import dataclasses
import json
import logging
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import regularity as ref_R  # noqa: E402
from repro.core import reweighted as ref_RW  # noqa: E402
from repro.core import validate as ref_V  # noqa: E402
from repro.launch.serve import SPARSE_SPEC as REF_SPEC  # noqa: E402
from repro.serve import artifacts as ref_ART  # noqa: E402
from repro.serve import compile as ref_C  # noqa: E402
from repro.train.trainer import apply_masks as ref_apply_masks  # noqa: E402
from repro_torch.core import reweighted as RW  # noqa: E402
from repro_torch.core import validate as V  # noqa: E402
from repro_torch.core.packed import PackedLayout  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch.serve import SPARSE_SPEC  # noqa: E402
from repro_torch.serve import artifacts as ART  # noqa: E402
from repro_torch.serve import compile as C  # noqa: E402

from test_torch_reference import (assert_layout_equal,  # noqa: E402
                                  assert_tap_layout_equal, ref_smoke_params,
                                  to_port)

SPEC = [(r"ffn/(gate|up)/w", RW.SchemeChoice("block", (16, 16))),
        (r"conv/w", RW.SchemeChoice("pattern", connectivity=0.5))]
REF_SMALL_SPEC = [(r"ffn/(gate|up)/w", ref_RW.SchemeChoice("block",
                                                           (16, 16))),
                  (r"conv/w", ref_RW.SchemeChoice("pattern",
                                                  connectivity=0.5))]


def small_model(seed=0, dtype=jnp.float32):
    """The reference test's model: two block-pruned FFN projections, a
    pattern conv and an unpruned head, built on the reference side."""
    key = jax.random.PRNGKey(seed)
    params = {
        "blk": {"ffn": {
            "gate": {"w": jax.random.normal(key, (64, 96), jnp.float32)},
            "up": {"w": jax.random.normal(jax.random.fold_in(key, 1),
                                          (64, 96), jnp.float32)}}},
        "conv": {"w": jax.random.normal(jax.random.fold_in(key, 2),
                                        (16, 8, 3, 3), jnp.float32)},
        "head": {"w": jax.random.normal(jax.random.fold_in(key, 3),
                                        (64, 32), jnp.float32)},
    }
    masks = ref_RW.random_block_masks(params, [REF_SMALL_SPEC[0]], (16, 16),
                                      keep_prob=0.4)
    masks["conv"] = {"w": ref_R.pattern_mask(params["conv"]["w"],
                                             connectivity_rate=0.5)}
    pm = jax.tree_util.tree_map(lambda x: x.astype(dtype),
                                ref_apply_masks(params, masks))
    return pm, masks


def _leaves(tree, path=""):
    """{path: leaf} of a port exec tree (a layout as one leaf)."""
    if not isinstance(tree, dict):
        return {path: tree}
    out = {}
    for k, v in tree.items():
        out.update(_leaves(v, f"{path}/{k}" if path else k))
    return out


def assert_trees_identical(a, b):
    """Two port exec trees: the same keys, tensors equal bit for bit,
    layouts leaf for leaf."""
    la, lb = _leaves(a), _leaves(b)
    assert list(la) == list(lb)
    for k, x in la.items():
        y = lb[k]
        assert type(x) is type(y), k
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y), k
            continue
        statics = ("block", "shape", "conv_taps") if isinstance(
            x, PackedLayout) else ("group", "shape")
        assert all(getattr(x, s) == getattr(y, s) for s in statics), k
        ax, ay = dict(ART._layout_leaves(x)), dict(ART._layout_leaves(y))
        assert list(ax) == list(ay), k
        for n, t in ax.items():
            u = ay[n]
            assert (t is None) == (u is None), (k, n)
            if t is not None:
                assert t.dtype == u.dtype and torch.equal(t, u), (k, n)


def _rows(report):
    return sorted(json.dumps(r.to_json(), sort_keys=True) for r in report)


@pytest.fixture
def stores(tmp_path):
    """The small model published by each package: (reference dir, port
    dir, port params, port masks, key, the port's cold exec tree)."""
    pm, masks = small_model()
    rdir, pdir = tmp_path / "ref", tmp_path / "port"
    ref_C.compile_model(pm, masks, REF_SMALL_SPEC, artifact_dir=rdir)
    ppm, pmasks = to_port(pm), to_port(masks)
    cold, _ = C.compile_model(ppm, pmasks, SPEC, device="cpu",
                              artifact_dir=pdir)
    key = ART.model_digest(ppm, pmasks, SPEC)
    assert key == ref_ART.model_digest(pm, masks, REF_SMALL_SPEC)
    for d in (rdir, pdir):
        assert (d / key / ART.MANIFEST_FILE).exists()
    return rdir, pdir, ppm, pmasks, key, cold


def warm_compile(d, ppm, pmasks):
    return C.compile_model(ppm, pmasks, SPEC, device="cpu", artifact_dir=d)


# -- the digest and the format, across the two packages -------------------------

@pytest.mark.parametrize("dtype,value_dtype", [
    ("float32", None), ("bfloat16", None), ("bfloat16", "int8")])
def test_model_digest_equals_references(dtype, value_dtype):
    """yi-9b SMOKE, the serving spec's masks at rate 0.6, SPARSE_SPEC."""
    _, _, rparams = ref_smoke_params(getattr(jnp, dtype))
    rmasks = ref_RW.magnitude_block_masks(rparams, REF_SPEC, None, rate=0.6)
    rpm = ref_apply_masks(rparams, rmasks)
    want = ref_ART.model_digest(
        rpm, rmasks, REF_SPEC, spec=ref_C.CompileSpec(value_dtype=value_dtype))
    got = ART.model_digest(to_port(rpm), to_port(rmasks), SPARSE_SPEC,
                           spec=C.CompileSpec(value_dtype=value_dtype))
    assert got == want
    assert C.CompileSpec(value_dtype=value_dtype).digest_fields() == \
        ref_C.CompileSpec(value_dtype=value_dtype).digest_fields()


def test_spec_and_report_json_are_the_references():
    spec = C.CompileSpec(n_bins=2, block_override=(8, 16),
                         value_dtype="int8", exclude=("head",))
    rspec = ref_C.CompileSpec(n_bins=2, block_override=(8, 16),
                              value_dtype="int8", exclude=("head",))
    assert spec.to_json() == rspec.to_json()
    assert list(spec.to_json()) == list(rspec.to_json())
    assert C.CompileSpec.from_json(rspec.to_json()) == spec
    assert ref_C.CompileSpec.from_json(spec.to_json()) == rspec
    tp2, rtp2 = (dataclasses.replace(spec, tp=2),
                 dataclasses.replace(rspec, tp=2))
    assert tp2.to_json() == rtp2.to_json()
    assert C.CompileSpec.from_json(rtp2.to_json()) == tp2
    assert tp2.digest_fields() == rtp2.digest_fields()


@pytest.mark.parametrize("value_dtype", [None, "int8"])
def test_stores_cross_between_the_packages(tmp_path, value_dtype):
    """yi-9b SMOKE in bf16 (values widened to fp32 on disk): the port loads
    the reference's store and the reference the port's, layouts leaf for
    leaf and the report rows equal."""
    _, _, rparams = ref_smoke_params(jnp.bfloat16)
    rmasks = ref_RW.magnitude_block_masks(rparams, REF_SPEC, None, rate=0.6)
    rpm = ref_apply_masks(rparams, rmasks)
    rspec = ref_C.CompileSpec(keep_dense=False, value_dtype=value_dtype)
    pspec = C.CompileSpec(keep_dense=False, value_dtype=value_dtype)
    rdir, pdir = tmp_path / "ref", tmp_path / "port"
    ref_C.compile_model(rpm, rmasks, REF_SPEC, spec=rspec,
                        artifact_dir=rdir)
    ppm, pmasks = to_port(rpm), to_port(rmasks)
    _, prep = C.compile_model(ppm, pmasks, SPARSE_SPEC, spec=pspec,
                              device="cpu", artifact_dir=pdir)
    key = ART.model_digest(ppm, pmasks, SPARSE_SPEC, spec=pspec)
    assert key == ref_ART.model_digest(rpm, rmasks, REF_SPEC, spec=rspec)
    for d in (rdir, pdir):
        port_layers, port_rep = ART.load_artifact(d, key, device="cpu")
        ref_layers, ref_rep = ref_ART.load_artifact(d, key)
        assert list(port_layers) == list(ref_layers) and len(port_layers) == 7
        for lpath, lay in port_layers.items():
            assert_layout_equal(lay, ref_layers[lpath])
            assert lay.values[0].dtype == (torch.int8 if value_dtype
                                           else torch.bfloat16)
        assert _rows(port_rep) == _rows(ref_rep) == _rows(prep)
        assert port_rep.spec == pspec


def test_tap_layouts_cross_between_the_packages(stores):
    rdir, pdir, _, _, key, cold = stores
    for d in (rdir, pdir):
        port_layers, _ = ART.load_artifact(d, key, device="cpu")
        ref_layers, _ = ref_ART.load_artifact(d, key)
        assert sorted(port_layers) == ["blk/ffn/gate", "blk/ffn/up", "conv"]
        assert_tap_layout_equal(port_layers["conv"], ref_layers["conv"])
        for lpath in ("blk/ffn/gate", "blk/ffn/up"):
            assert_layout_equal(port_layers[lpath], ref_layers[lpath])


# -- the reference's cases: the happy path --------------------------------------

def test_warm_load_bit_identical_to_cold(stores, monkeypatch):
    rdir, pdir, ppm, pmasks, key, cold = stores
    # the load really came from disk: nothing is packed
    for name in ("pack", "pack_taps"):
        monkeypatch.setattr(ops, name, lambda *a, **k: pytest.fail("packed"))
    for d in (rdir, pdir):
        warm, _ = warm_compile(d, ppm, pmasks)
        assert_trees_identical(cold, warm)


def test_load_artifact_validates_layouts(stores):
    _, pdir, _, _, key, _ = stores
    layers, report = ART.load_artifact(pdir, key, device="cpu")
    assert layers and all(
        V.validate_layout(lo) is lo for lo in layers.values())
    assert any(r.packed for r in report)


def test_digest_covers_weights_and_options(stores):
    _, _, ppm, pmasks, key, _ = stores
    bumped = dict(ppm, head={"w": ppm["head"]["w"] + 1.0})
    assert ART.model_digest(bumped, pmasks, SPEC) != key
    assert ART.model_digest(ppm, pmasks, SPEC,
                            spec=C.CompileSpec(n_bins=2)) != key
    assert ART.model_digest(ppm, pmasks, SPEC) == key     # deterministic
    # serving-only knobs stay out of the key
    assert ART.model_digest(ppm, pmasks, SPEC, spec=C.CompileSpec(
        keep_dense=False, implicit=True)) == key


# -- the reference's cases: corruption classes ------------------------------------

def flip_bit(path, offset=100):
    raw = bytearray(path.read_bytes())
    raw[offset] ^= 0x40
    path.write_bytes(bytes(raw))


def _truncate(path):
    path.write_bytes(path.read_bytes()[:64])


def _edit_manifest(d, **changes):
    mpath = d / ART.MANIFEST_FILE
    man = json.loads(mpath.read_text())
    man.update(changes)
    mpath.write_text(json.dumps(man))


def _invariant_violation(d):
    """An out-of-range k_idx written back WITH fresh manifest checksums, so
    only layout validation can catch it."""
    apath = d / ART.ARRAYS_FILE
    data = dict(np.load(apath))
    kname = next(k for k in data if "::k_idx." in k)
    data[kname] = data[kname].copy()
    data[kname].flat[0] = 10_000
    np.savez(apath, **data)
    _edit_manifest(d, files={ART.ARRAYS_FILE: {
        "sha256": ART.file_checksum(apath), "bytes": apath.stat().st_size}})


CORRUPTIONS = {
    "bitflip_in_arrays": (lambda d: flip_bit(d / ART.ARRAYS_FILE),
                          "checksum"),
    "truncated_arrays": (lambda d: _truncate(d / ART.ARRAYS_FILE),
                         "checksum"),
    "tampered_pack_key": (lambda d: _edit_manifest(d, pack_key="0" * 32),
                          "digest_mismatch"),
    "version_skew": (lambda d: _edit_manifest(
        d, format_version=ART.FORMAT_VERSION + 1), "version_skew"),
    "unreadable_manifest": (lambda d: (d / ART.MANIFEST_FILE).write_text(
        "{not json"), "corrupt"),
    "missing_manifest": (lambda d: (d / ART.MANIFEST_FILE).unlink(),
                         "corrupt"),
    "invariant_violation_with_valid_checksums": (_invariant_violation,
                                                 "index_range"),
}


@pytest.mark.parametrize("name", sorted(CORRUPTIONS))
def test_corruption_detected_with_the_references_code_and_repacks(
        stores, name, caplog):
    """Each corruption of each package's store: the reference's loader and
    the port's raise the same code, and the port's compile logs it and
    repacks a tree identical to the cold one."""
    rdir, pdir, ppm, pmasks, key, cold = stores
    corrupt, code = CORRUPTIONS[name]
    for d in (rdir, pdir):
        corrupt(d / key)
        with pytest.raises((ref_ART.ArtifactError, ref_V.LayoutError)) as ref_e:
            ref_ART.load_artifact(d, key)
        with pytest.raises((ART.ArtifactError, V.LayoutError)) as port_e:
            ART.load_artifact(d, key, device="cpu")
        assert ref_e.value.code == port_e.value.code == code
        assert type(port_e.value).__name__ == type(ref_e.value).__name__
        caplog.clear()
        with caplog.at_level(logging.WARNING, "repro_torch.serve.artifacts"):
            repacked, _ = warm_compile(d, ppm, pmasks)
        assert "fresh pack" in caplog.text and f"[{code}]" in caplog.text
        assert_trees_identical(cold, repacked)


def test_stale_digest_changed_weights_is_a_miss(stores, caplog):
    """Weights changed since publish: another digest, a clean miss and a
    fresh pack, the stale artifact simply not selected."""
    _, pdir, ppm, pmasks, _, _ = stores
    pm2 = dict(ppm, head={"w": ppm["head"]["w"] * 2.0})
    with caplog.at_level(logging.INFO, "repro_torch.serve.artifacts"):
        fresh, _ = C.compile_model(pm2, pmasks, SPEC, device="cpu",
                                   artifact_dir=pdir)
    assert "[missing]" in caplog.text and "stale" in caplog.text
    cold2, _ = C.compile_model(pm2, pmasks, SPEC, device="cpu")
    assert_trees_identical(fresh, cold2)


def test_crashed_writer_husk_is_ignored(stores):
    """A dead writer's .tmp_* staging dir shadows nothing."""
    _, pdir, ppm, pmasks, key, cold = stores
    husk = pdir / f".tmp_{key}_dead"
    husk.mkdir()
    (husk / ART.ARRAYS_FILE).write_bytes(b"partial")
    warm, _ = warm_compile(pdir, ppm, pmasks)
    assert_trees_identical(cold, warm)


def test_concurrent_publish_race_keeps_existing(stores):
    """save_artifact into an already-published digest is a no-op."""
    _, pdir, _, _, key, cold = stores
    before = (pdir / key / ART.MANIFEST_FILE).read_bytes()
    _, report = ART.load_artifact(pdir, key, device="cpu")
    ART.save_artifact(pdir, key, cold, report)
    assert (pdir / key / ART.MANIFEST_FILE).read_bytes() == before


def test_save_refuses_invalid_layout(stores, tmp_path_factory):
    """A corrupt in-memory layout never reaches the disk."""
    _, pdir, _, _, key, cold = stores
    _, report = ART.load_artifact(pdir, key, device="cpu")
    lay = cold["blk"]["ffn"]["gate"]["packed"]
    k = lay.k_idx[0].clone()
    k.view(-1)[0] = -3
    broken = dict(cold, blk={"ffn": dict(cold["blk"]["ffn"], gate=dict(
        cold["blk"]["ffn"]["gate"], packed=dataclasses.replace(
            lay, k_idx=(k,) + lay.k_idx[1:])))})
    out = tmp_path_factory.mktemp("resave")
    with pytest.raises(V.LayoutError):
        ART.save_artifact(out, key, broken, report)
    assert not (out / key).exists()


def test_bf16_roundtrip_exact(tmp_path):
    """bf16 layouts widen to fp32 on disk and cast back on load."""
    pm, masks = small_model(seed=3, dtype=jnp.bfloat16)
    ppm, pmasks = to_port(pm), to_port(masks)
    cold, _ = C.compile_model(ppm, pmasks, SPEC, device="cpu",
                              artifact_dir=tmp_path)
    warm, _ = C.compile_model(ppm, pmasks, SPEC, device="cpu",
                              artifact_dir=tmp_path)
    assert_trees_identical(cold, warm)
    layers, _ = ART.load_artifact(tmp_path, ART.model_digest(ppm, pmasks,
                                                             SPEC),
                                  device="cpu")
    assert layers and all(lo.values[0].dtype == torch.bfloat16
                          for lo in layers.values())
    data = np.load(next(tmp_path.glob("*/arrays.npz")))
    assert all(data[k].dtype == np.float32 for k in data if "::values." in k)


def test_sharded_layout_in_a_store_falls_back(stores, caplog):
    """A store whose manifest claims ``n_shards`` = 2 for a layout whose
    leaves carry no shard axis is refused as a structure error (the nnz
    leaf lacks its shard axes) and the port packs afresh; stores of real
    tensor-parallel layouts load (``tests/test_torch_sharding.py``)."""
    _, pdir, ppm, pmasks, key, cold = stores
    mpath = pdir / key / ART.MANIFEST_FILE
    man = json.loads(mpath.read_text())
    man["layers"]["blk/ffn/gate"]["n_shards"] = 2
    mpath.write_text(json.dumps(man))
    with pytest.raises(V.LayoutStructureError, match="shard axes"):
        ART.load_artifact(pdir, key, device="cpu")
    with caplog.at_level(logging.WARNING, "repro_torch.serve.artifacts"):
        repacked, _ = warm_compile(pdir, ppm, pmasks)
    assert "[structure]" in caplog.text
    assert_trees_identical(cold, repacked)


# -- the serve CLI's --artifacts ---------------------------------------------------

def test_cli_second_run_warm_starts_with_the_same_tokens(tmp_path):
    """``--artifacts DIR`` at yi-9b SMOKE: the first run packs and
    publishes, the second loads the store, and both print the same
    tokens."""
    root = Path(__file__).resolve().parents[1]
    runs = []
    for _ in range(2):
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
             "yi-9b", "--smoke", "--sparse", "--new-tokens", "6",
             "--device", "cpu", "--artifacts", str(tmp_path)],
            cwd=root, env={"PYTHONPATH": str(root / "src"),
                           "PATH": "/usr/bin:/bin"},
            capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr[-2000:]
        runs.append(proc)
    assert "published artifact" in runs[0].stderr
    assert "warm start: 7 packed layer(s)" in runs[1].stderr
    assert "published artifact" not in runs[1].stderr
    samples = [[ln for ln in r.stdout.splitlines() if ln.startswith(
        "sample:")] for r in runs]
    assert samples[0] and samples[0] == samples[1]
    assert f"(artifact store: {tmp_path})" in runs[1].stdout
