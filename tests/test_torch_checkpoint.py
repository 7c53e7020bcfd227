"""The port's checkpoints (``distributed.checkpoint``), replica restart
(``distributed.elastic``) and the train CLI's resume against the
reference's, on the CPU.

- the cases of the reference's ``TestCheckpoint`` (not its resharding
  case, which takes a mesh) and ``TestCheckpointFaults`` (each fault
  giving the reference's ``code``, on a checkpoint of either package);
- checkpoints cross both ways: a ``{"params", "opt"}`` tree of the port's
  AdamW state flattens to the reference's key paths, so whole training
  states cross, not only params;
- ``choose_mesh_shape`` equals the reference's; ``replica_restore`` warm
  starts from the artifact store (no ``pack_csc_reordered`` call), at
  tp = 1 and 2, and survives a corrupt newest checkpoint together with a
  torn artifact, as the reference's ``TestElastic`` does;
- the train CLI at yi-9b SMOKE: 6 steps against 4 + ``--resume`` to 6,
  the losses after the resume equal to the uninterrupted run's, and both
  within the train tests' step tolerance of the reference's CLI on the same
  numpy batches; two faults of the reference's resume pinned (it runs the
  saved step again; it restores neither masks nor alphas).
"""
import types

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.core import reweighted as ref_RW  # noqa: E402
from repro.data import pipeline as ref_data  # noqa: E402
from repro.distributed import checkpoint as ref_CKPT  # noqa: E402
from repro.distributed import elastic as ref_elastic  # noqa: E402
from repro.launch import train as ref_train_cli  # noqa: E402
from repro.models import transformer as ref_T  # noqa: E402
from repro.optim import adamw as ref_adamw  # noqa: E402
from repro.train.trainer import apply_masks as ref_apply_masks  # noqa: E402
from repro_torch.core import bcs as BCS  # noqa: E402
from repro_torch.core import reweighted as RW  # noqa: E402
from repro_torch.distributed import checkpoint as CKPT  # noqa: E402
from repro_torch.distributed import elastic  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.serve import compile as C  # noqa: E402
from repro_torch.testing import faults as F  # noqa: E402

from test_torch_reference import to_port  # noqa: E402

STEP_LOSS_TOL = 1e-4     # whole train steps' losses, as tests/test_torch_train


def _ref_tree():
    return {"a": jnp.arange(6.0).reshape(2, 3),
            "b": {"c": jnp.ones((4,), jnp.int32)}}


def _port_tree():
    return {"a": torch.arange(6.0).reshape(2, 3),
            "b": {"c": torch.ones(4, dtype=torch.int32)}}


# the two packages behind one interface: (save, restore, tree, error class)
SIDES = {
    "port": (CKPT.save, CKPT.restore, _port_tree, CKPT.CheckpointError),
    "reference": (ref_CKPT.save, ref_CKPT.restore, _ref_tree,
                  ref_CKPT.CheckpointError),
}


def _np(tree):
    """{path: numpy} of either package's tree."""
    if isinstance(tree, dict):
        return {f"{k}/{p}" if p else k: v for k, sub in tree.items()
                for p, v in _np(sub).items()}
    if isinstance(tree, torch.Tensor):
        return {"": tree.float().numpy() if tree.dtype == torch.bfloat16
                else tree.numpy()}
    return {"": np.asarray(tree, np.float32) if tree.dtype == jnp.bfloat16
            else np.asarray(tree)}


class TestCheckpoint:
    def test_roundtrip(self, tmp_path):
        CKPT.save(tmp_path, 7, _port_tree())
        restored, step = CKPT.restore(tmp_path, _port_tree())
        assert step == 7
        assert restored["b"]["c"].dtype == torch.int32
        assert torch.equal(restored["a"], _port_tree()["a"])

    def test_latest_complete_wins(self, tmp_path):
        CKPT.save(tmp_path, 5, {"a": torch.zeros(2)})
        CKPT.save(tmp_path, 9, {"a": torch.ones(2)})
        (tmp_path / "step_00000011").mkdir()          # torn: no manifest
        assert CKPT.available_steps(tmp_path) == [9, 5]
        restored, step = CKPT.restore(tmp_path, {"a": torch.zeros(2)})
        assert step == 9 and float(restored["a"][0]) == 1.0

    def test_empty_dir(self, tmp_path):
        assert CKPT.restore(tmp_path / "nope", {"a": torch.zeros(1)}) == \
            (None, None)
        assert CKPT.latest_step(tmp_path / "nope") is None

    def test_bf16_roundtrip_recasts(self, tmp_path):
        tree = {"w": torch.linspace(-2, 2, 8).to(torch.bfloat16)}
        CKPT.save(tmp_path, 1, tree)
        data = np.load(tmp_path / "step_00000001" / "shard_0.npz")
        assert data["w"].dtype == np.float32
        restored, _ = CKPT.restore(tmp_path, tree)
        assert restored["w"].dtype == torch.bfloat16
        assert torch.equal(restored["w"], tree["w"])

    @pytest.mark.parametrize("writer", ["port", "reference"])
    def test_checkpoints_cross_both_ways(self, tmp_path, writer):
        """A yi-9b SMOKE training state {"params" (bf16), "opt" (fp32
        moments, int32 step)} written by either package restores in the
        other, leaf for leaf."""
        cfg = ref_configs.get("yi-9b", smoke=True)
        rp = ref_T.init_lm(jax.random.PRNGKey(0), cfg)
        rstate = {"params": rp, "opt": ref_adamw.adamw_init(rp)}
        rstate["opt"]["step"] = jnp.asarray(3, jnp.int32)
        pp = to_port(rp)
        pstate = {"params": pp, "opt": adamw.adamw_init(pp)}
        pstate["opt"]["step"] = torch.tensor(3, dtype=torch.int32)
        if writer == "port":
            CKPT.save(tmp_path, 2, pstate)
        else:
            ref_CKPT.save(tmp_path, 2, rstate)
        got, s1 = CKPT.restore(tmp_path, pstate)
        want, s2 = ref_CKPT.restore(tmp_path, rstate)
        assert s1 == s2 == 2
        g, w = _np(got), _np(want)
        assert sorted(g) == sorted(w) and "opt/m/layers/attn/wq/w" in g
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
        assert got["params"]["embed"]["table"].dtype == torch.bfloat16


class TestCheckpointFaults:
    """Each fault raises the reference's ``code`` in both packages,
    whichever package wrote the checkpoint."""

    def _saved(self, tmp_path, writer):
        SIDES[writer][0](tmp_path, 3, SIDES[writer][2]())
        return tmp_path / "step_00000003"

    def _codes(self, tmp_path, make_port, make_ref):
        out = []
        for restore, tree, err in ((CKPT.restore, make_port, CKPT.
                                    CheckpointError),
                                   (ref_CKPT.restore, make_ref,
                                    ref_CKPT.CheckpointError)):
            with pytest.raises(err) as ei:
                restore(tmp_path, tree())
            out.append((ei.value.code, str(ei.value)))
        assert out[0][0] == out[1][0]
        return out[0]

    @pytest.mark.parametrize("writer", list(SIDES))
    def test_restore_into_bigger_tree_names_missing_param(self, tmp_path,
                                                          writer):
        self._saved(tmp_path, writer)
        code, msg = self._codes(
            tmp_path,
            lambda: {**_port_tree(), "extra": {"w": torch.zeros(2, 2),
                                               "v": torch.zeros(3)}},
            lambda: {**_ref_tree(), "extra": {"w": jnp.zeros((2, 2)),
                                              "v": jnp.zeros(3)}})
        assert code == "missing_key"
        assert "extra/v" in msg and "+1 more" in msg

    @pytest.mark.parametrize("writer", list(SIDES))
    def test_restore_into_smaller_tree_names_unexpected_param(
            self, tmp_path, writer):
        self._saved(tmp_path, writer)
        code, msg = self._codes(tmp_path, lambda: {"a": _port_tree()["a"]},
                                lambda: {"a": _ref_tree()["a"]})
        assert code == "unexpected_key" and "b/c" in msg

    @pytest.mark.parametrize("writer", list(SIDES))
    def test_restore_wrong_shape_names_param(self, tmp_path, writer):
        self._saved(tmp_path, writer)
        code, msg = self._codes(
            tmp_path,
            lambda: {"a": torch.zeros(3, 2), "b": _port_tree()["b"]},
            lambda: {"a": jnp.zeros((3, 2)), "b": _ref_tree()["b"]})
        assert code == "shape" and "'a'" in msg

    @pytest.mark.parametrize("writer", list(SIDES))
    def test_restore_wrong_dtype_kind_names_param(self, tmp_path, writer):
        self._saved(tmp_path, writer)
        code, msg = self._codes(
            tmp_path,
            lambda: {"a": _port_tree()["a"], "b": {"c": torch.ones(4)}},
            lambda: {"a": _ref_tree()["a"], "b": {"c": jnp.ones((4,))}})
        assert code == "dtype" and "b/c" in msg

    @pytest.mark.parametrize("writer", list(SIDES))
    @pytest.mark.parametrize("fault,want", [("bitflip", "checksum"),
                                            ("truncate", "checksum"),
                                            ("unlink", "missing_file")])
    def test_shard_faults(self, tmp_path, writer, fault, want):
        d = self._saved(tmp_path, writer)
        shard = d / "shard_0.npz"
        if fault == "bitflip":
            raw = bytearray(shard.read_bytes())
            raw[len(raw) // 2] ^= 0xFF
            shard.write_bytes(bytes(raw))
        elif fault == "truncate":
            shard.write_bytes(shard.read_bytes()[:-16])
        else:
            shard.unlink()
        code, msg = self._codes(tmp_path, _port_tree, _ref_tree)
        assert code == want
        if fault == "truncate":
            assert "truncated" in msg


# -- elastic restarts --------------------------------------------------------

SPEC = [(r"ffn/(gate|up)/w", RW.SchemeChoice("block", (16, 16)))]


def _small_model():
    """The reference test's two block-pruned FFN projections, crossed."""
    params = {"blk": {"ffn": {
        "gate": {"w": jax.random.normal(jax.random.PRNGKey(0), (64, 96),
                                        jnp.float32)},
        "up": {"w": jax.random.normal(jax.random.PRNGKey(1), (64, 96),
                                      jnp.float32)}}}}
    masks = ref_RW.random_block_masks(
        params, [(r"ffn/(gate|up)/w", ref_RW.SchemeChoice("block",
                                                          (16, 16)))],
        (16, 16), keep_prob=0.4)
    return to_port(ref_apply_masks(params, masks))


def _count_packs(monkeypatch):
    calls = []
    real = BCS.pack_csc_reordered
    monkeypatch.setattr(BCS, "pack_csc_reordered",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    return calls


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _leaves(v, f"{path}/{k}").items()}
    if isinstance(tree, torch.Tensor):
        return {path: tree}
    from repro_torch.serve import artifacts as ART
    return {f"{path}:{n}": t for n, t in ART._layout_leaves(tree)
            if t is not None}


def _assert_same(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert list(la) == list(lb)
    for k in la:
        assert la[k].dtype == lb[k].dtype and torch.equal(la[k], lb[k]), k


class TestElastic:
    @pytest.mark.parametrize("n,mp,pods", [(512, 16, 2), (256, 16, 1),
                                           (24, 16, 1), (1, 4, 1),
                                           (8, 4, 2), (6, 4, 3)])
    def test_choose_mesh_shape_matches_reference(self, n, mp, pods):
        assert elastic.choose_mesh_shape(n, mp, pods) == \
            ref_elastic.choose_mesh_shape(n, mp, pods)

    @pytest.mark.parametrize("tp", [1, 2])
    def test_replica_restore_warm_starts_from_artifacts(self, tmp_path,
                                                        monkeypatch, tp):
        """A restarted replica restores the step and warm-starts the same
        exec tree with no packing; at tp = 2 its layouts carry 2
        shards."""
        pm = _small_model()
        ckpt, store = tmp_path / "ckpt", tmp_path / "art"
        CKPT.save(ckpt, 12, pm)
        spec = C.CompileSpec(tp=tp)
        calls = _count_packs(monkeypatch)
        ex1, rep1, s1 = elastic.replica_restore(
            ckpt, pm, mapping=SPEC, artifact_dir=store, spec=spec,
            device="cpu")
        cold_packs = len(calls)
        ex2, rep2, s2 = elastic.replica_restore(
            ckpt, pm, mapping=SPEC, artifact_dir=store, spec=spec,
            device="cpu")
        assert s1 == s2 == 12 and cold_packs > 0
        assert len(calls) == cold_packs              # warm: no repack
        assert [r.shards for r in rep1.packed] == [tp if tp > 1 else None] * 2
        assert ex2["blk"]["ffn"]["gate"]["packed"].n_shards == (
            tp if tp > 1 else 0)
        _assert_same(ex1, ex2)

    def test_replica_restore_empty_dir(self, tmp_path):
        assert elastic.replica_restore(tmp_path / "none",
                                       {"a": torch.zeros(1)},
                                       device="cpu") == (None, None, None)

    def test_replica_restore_survives_double_fault(self, tmp_path,
                                                   monkeypatch):
        """A corrupt newest checkpoint and a torn artifact in one start:
        the replica falls back to the older step, repacks, and serves the
        tree of a cold compile of that step; a pinned corrupt step
        raises."""
        pm = _small_model()
        ckpt, store = tmp_path / "ckpt", tmp_path / "art"
        CKPT.save(ckpt, 10, pm)
        CKPT.save(ckpt, 12, pm)
        _, _, s0 = elastic.replica_restore(ckpt, pm, mapping=SPEC,
                                           artifact_dir=store, device="cpu")
        assert s0 == 12
        shard = ckpt / "step_00000012" / "shard_0.npz"
        raw = bytearray(shard.read_bytes())
        raw[len(raw) // 2] ^= 0xFF
        shard.write_bytes(bytes(raw))
        keys = [d.name for d in store.iterdir() if not d.name.startswith(".")]
        assert len(keys) == 1
        F.crash_publish(store, keys[0], stage="torn")
        calls = _count_packs(monkeypatch)
        ex, rep, step = elastic.replica_restore(ckpt, pm, mapping=SPEC,
                                                artifact_dir=store,
                                                device="cpu")
        assert step == 10 and calls and any(r.packed for r in rep)
        restored, _ = CKPT.restore(ckpt, pm, step=10)
        cold, _ = C.compile_model(restored, None, SPEC, device="cpu")
        _assert_same(ex, cold)
        with pytest.raises(CKPT.CheckpointError):
            elastic.replica_restore(ckpt, pm, mapping=SPEC, step=12,
                                    artifact_dir=store, device="cpu")


# -- the train CLI's checkpoints and resume ----------------------------------

B, S = 4, 32
BASE = ["--arch", "yi-9b", "--smoke", "--batch", str(B), "--seq", str(S),
        "--lr", "3e-3"]


def _ref_params():
    cfg = ref_configs.get("yi-9b", smoke=True)
    return jax.tree_util.tree_map(lambda a: a.astype(jnp.float32),
                                  ref_T.init_lm(jax.random.PRNGKey(0), cfg))


def _batch(step):
    """The reference's batch of ``step``, as numpy: both CLIs train on
    it."""
    cfg = ref_configs.get("yi-9b", smoke=True)
    b = ref_data.synthetic_batch(0, step, B, S, cfg.vocab)
    return {k: np.asarray(v) for k, v in b.items()}


@pytest.fixture
def port_cli(monkeypatch):
    """The port's CLI on the CPU with the reference's fp32 init and
    batches; returns run(argv) -> (losses of the steps run, result)."""
    rp = _ref_params()
    monkeypatch.setattr(train_cli, "T", types.SimpleNamespace(
        init_lm=lambda cfg, seed, device: to_port(rp)))
    monkeypatch.setattr(train_cli, "synthetic_batch",
                        lambda seed, step, *a, **k: {
                            n: torch.tensor(v)
                            for n, v in _batch(step).items()})
    losses = []
    real = train_cli.make_train_step

    def recording(*a, **k):
        init, step = real(*a, **k)

        def run(*args):
            out = step(*args)
            losses.append(float(out[2]["loss"]))
            return out
        return init, run
    monkeypatch.setattr(train_cli, "make_train_step", recording)

    def run(argv):
        losses.clear()
        out = train_cli.main(BASE + ["--device", "cpu"] + argv)
        return list(losses), out
    return run


@pytest.fixture
def ref_cli(monkeypatch):
    """The reference's CLI (``repro.launch.train``) with its placement
    stubbed (its mesh path is red on this CPU, ROADMAP queue 3), jit left
    to the step, the same init and batches; returns run(argv)."""
    rp = _ref_params()
    monkeypatch.setattr(ref_train_cli, "SH", types.SimpleNamespace(
        make_dist=lambda *a, **k: None,
        param_shardings=lambda *a, **k: None))
    monkeypatch.setattr(ref_train_cli, "T", types.SimpleNamespace(
        init_lm=lambda key, cfg: rp))
    monkeypatch.setattr(ref_train_cli, "jax", types.SimpleNamespace(
        jit=lambda f: f, random=jax.random, device_put=jax.device_put))
    monkeypatch.setattr(ref_train_cli, "synthetic_batch",
                        lambda seed, step, *a, **k: {
                            n: jnp.asarray(v)
                            for n, v in _batch(step).items()})
    losses = []
    real = ref_train_cli.make_train_step

    def recording(*a, **k):
        init, step = real(*a, **k)
        jstep = jax.jit(step)

        def run(*args):
            out = jstep(*args)
            losses.append(float(out[2]["loss"]))
            return out
        return init, run
    monkeypatch.setattr(ref_train_cli, "make_train_step", recording)

    def run(argv):
        losses.clear()
        out = ref_train_cli.main(BASE + argv)
        return list(losses), out
    return run


def test_train_cli_resume_equals_uninterrupted(tmp_path, port_cli, ref_cli,
                                               capsys):
    """6 steps against 4 (saving every 2) + ``--resume`` to 6: the resumed
    steps 3-5 give the uninterrupted losses bit for bit, and both runs
    are within 1e-4 of the reference CLI on the same batches.  The
    reference's resume runs its saved step 2 again (4 steps where 3
    remain), so its loss after the resume is not its uninterrupted one;
    its checkpoint restores in the port's CLI state."""
    full, _ = port_cli(["--steps", "6", "--ckpt-dir", str(tmp_path / "a"),
                        "--ckpt-every", "2"])
    assert CKPT.available_steps(tmp_path / "a") == [4, 2]
    first, _ = port_cli(["--steps", "4", "--ckpt-dir", str(tmp_path / "b"),
                         "--ckpt-every", "2"])
    resumed, _ = port_cli(["--steps", "6", "--ckpt-dir",
                           str(tmp_path / "b"), "--ckpt-every", "2",
                           "--resume"])
    assert "resumed from step 2" in capsys.readouterr().out
    assert first == full[:4] and resumed == full[3:]
    ref_full, _ = ref_cli(["--steps", "6", "--ckpt-dir",
                           str(tmp_path / "r"), "--ckpt-every", "2"])
    np.testing.assert_allclose(full, ref_full, rtol=0, atol=STEP_LOSS_TOL)
    ref_cli(["--steps", "4", "--ckpt-dir", str(tmp_path / "rb"),
             "--ckpt-every", "2"])
    ref_resumed, _ = ref_cli(["--steps", "6", "--ckpt-dir",
                              str(tmp_path / "rb"), "--ckpt-every", "2",
                              "--resume"])
    assert len(ref_resumed) == 4                  # steps 2, 3, 4, 5
    assert abs(ref_resumed[0] - ref_full[2]) > 10 * STEP_LOSS_TOL
    # the reference CLI's {"params", "opt"} step restores in the port's
    pp = to_port(_ref_params())
    state, step = CKPT.restore(tmp_path / "r", {"params": pp,
                                                "opt": adamw.adamw_init(pp)})
    assert step == 4 and int(state["opt"]["step"]) == 5


def test_train_cli_resume_after_prune_trains_unmasked(tmp_path, port_cli,
                                                      ref_cli):
    """A fault of the reference the port copies (ROADMAP queue 3): masks
    and alphas are not checkpointed and the masks are set only at the
    prune step, so a run resumed after it trains unmasked — both CLIs
    return no masks, and the port's pruned weights come back nonzero."""
    argv = ["--prune", "--ckpt-every", "4"]
    _, (params, masks) = port_cli(["--steps", "6", "--ckpt-dir",
                                   str(tmp_path / "a")] + argv)
    port_cli(["--steps", "5", "--ckpt-dir", str(tmp_path / "b")] + argv)
    _, (params_r, masks_r) = port_cli(["--steps", "6", "--ckpt-dir",
                                       str(tmp_path / "b"), "--resume"]
                                      + argv)
    assert masks is not None and masks_r is None
    m = masks["layers"]["ffn"]["gate"]["w"]
    w_r = params_r["layers"]["ffn"]["gate"]["w"]
    assert (params["layers"]["ffn"]["gate"]["w"][m == 0] == 0).all()
    assert (w_r[m == 0] != 0).any()
    ref_cli(["--steps", "5", "--ckpt-dir", str(tmp_path / "r")] + argv)
    _, (_, ref_masks) = ref_cli(["--steps", "6", "--ckpt-dir",
                                 str(tmp_path / "r"), "--resume"] + argv)
    assert ref_masks is None
