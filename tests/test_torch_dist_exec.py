"""The port's mesh path executed across processes on the CPU: gloo ranks
over a ``file://`` store (no TCP port), spawned once per tensor-parallel
degree (tp = 2, 4) as separate interpreters, so this process never starts
a process group.  Every check runs inside the ranks
(``repro_torch.testing.dist_ranks``, which imports no JAX); the
reference's outputs (SMOKE ``init_lm`` params, ``forward`` logits at
``dist=None``, greedy ``generate`` tokens) are computed here and handed to
the ranks as numpy arrays.  Each check is one test case, passing when it
passed on every rank; the checkpoint the ranks saved at tp is then
restored here at tp = 1 (no mesh) and by the reference.

The checks: placed column-sharded ``sparse_linear`` (float, int8) and the
tap path bit-equal to unsharded, one plain-version call per rank and one
model-axis all-gather (``CommDebugMode`` counts, not wall time); an
expert stack over its local experts with no collective; yi-9b, mixtral
and hymba SMOKE ``forward(dist=)`` within 1e-5 of the port unsharded and
of the reference, greedy tokens equal; yi-9b compiled at tp = 4, placed
by ``shard_packed_tree``, ``generate`` and ``ServingEngine(dist=)``
tokens; a decode step's collectives; train steps in "tp" and "fsdp"
mode; ``launch.train --model-parallel``; checkpoints.
"""
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.distributed import checkpoint as ref_CKPT  # noqa: E402
from repro.models import module as ref_module  # noqa: E402
from repro.models import transformer as ref_T  # noqa: E402
from repro.serve import engine as ref_engine  # noqa: E402
from repro_torch.distributed import checkpoint as CKPT  # noqa: E402

from test_torch_reference import ref_to_numpy  # noqa: E402

ARCHS = ("yi-9b", "mixtral-8x7b", "hymba-1.5b")
CHECKS = ("linear", "linear_int8", "tap", "expert",
          "forward_yi-9b", "forward_mixtral-8x7b", "forward_hymba-1.5b",
          "generate_yi-9b", "generate_mixtral-8x7b", "generate_hymba-1.5b",
          "packed_generate", "engine", "comm_decode", "train_tp",
          "train_fsdp", "checkpoint", "train_cli")
SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")


def _flatten(tree, prefix, out):
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(v, f"{prefix}{k}/" if isinstance(v, dict)
                     else f"{prefix}{k}", out)
    else:
        out[prefix] = np.asarray(tree)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The reference side: SMOKE fp32 params, a (2, 16) prompt, the
    ``dist=None`` logits and 4 greedy tokens of each arch."""
    out = {}
    for i, arch in enumerate(ARCHS):
        cfg = ref_configs.get(arch, smoke=True)
        params = ref_module.cast_tree(
            ref_T.init_lm(jax.random.PRNGKey(i), cfg), jnp.float32)
        tokens = np.random.default_rng(i).integers(
            0, cfg.vocab, (2, 16)).astype(np.int32)
        logits, _ = ref_T.forward(params, cfg, jnp.asarray(tokens))
        # the hybrid's decode tokens are not held to the reference's (its
        # prefill state fault, ROADMAP queue 3): none are drawn for it
        toks = (np.zeros((2, 4), np.int32) if cfg.family == "hybrid" else
                ref_engine.generate(params, cfg, jnp.asarray(tokens), 4))
        _flatten(ref_to_numpy(params), f"{arch}|params|", out)
        out[f"{arch}|tokens"] = tokens
        out[f"{arch}|logits"] = np.asarray(logits, np.float32)
        out[f"{arch}|tokens_out"] = np.asarray(toks)
    path = tmp_path_factory.mktemp("dist_inputs") / "inputs.npz"
    np.savez(path, **out)
    return path, out


WORLDS = (2, 4)


@pytest.fixture(scope="module")
def groups(inputs, tmp_path_factory):
    """Both groups (tp = 2 and 4, separate stores), run at once to their
    end: {world: (return codes, logs, output directory)}."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [SRC] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    runs = {}
    for world in WORLDS:
        out = tmp_path_factory.mktemp(f"dist_tp{world}")
        runs[world] = (out, [subprocess.Popen(
            [sys.executable, "-m", "repro_torch.testing.dist_ranks", str(r),
             str(world), str(out / "store"), str(inputs[0]), str(out)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for r in range(world)])
    done = {}
    try:
        for world, (out, procs) in runs.items():
            logs = [p.communicate(timeout=300)[0] for p in procs]
            done[world] = ([p.returncode for p in procs], logs, out)
    finally:
        for _, procs in runs.values():
            for p in procs:
                if p.poll() is None:
                    p.kill()
    return done


@pytest.fixture(params=WORLDS, ids=lambda w: f"tp{w}")
def ranks(request, groups):
    """One group's outcome: (world, per-rank results, the ranks' output
    directory); every rank must have run to its end."""
    world = request.param
    rcs, logs, out = groups[world]
    for r, rc in enumerate(rcs):
        assert rc == 0, f"rank {r}:\n{logs[r][-4000:]}"
    results = [json.loads((out / f"rank{r}.json").read_text())
               for r in range(world)]
    return world, results, out


@pytest.mark.parametrize("check", CHECKS)
def test_rank_check(ranks, check):
    world, results, _ = ranks
    for r, res in enumerate(results):
        assert res[check]["ok"], f"rank {r} of {world}: {res[check]}"


def test_ranks_agree(ranks):
    """Every rank reports the same tokens, losses and collective counts."""
    world, results, _ = ranks
    for check in ("generate_yi-9b", "packed_generate", "engine",
                  "train_tp", "train_fsdp", "linear", "comm_decode"):
        details = [json.dumps(r[check]["detail"], sort_keys=True)
                   for r in results]
        assert len(set(details)) == 1, (check, details)


def _tree_like(flat):
    like = {}
    for key, arr in flat.items():
        node = like
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr
    return like


def test_checkpoint_restores_at_tp1_and_in_the_reference(ranks, inputs):
    """The ranks saved yi-9b's params placed at tp: every rank wrote its
    shard and rank 0 the manifest; restored here with no mesh (the port)
    and by the reference, each leaf equals the params the ranks got."""
    world, _, out = ranks
    prefix = "yi-9b|params|"
    want = {k[len(prefix):]: v for k, v in inputs[1].items()
            if k.startswith(prefix)}
    ckpt = out / "ckpt"
    step_dir = ckpt / "step_00000005"
    assert sorted(f.name for f in step_dir.glob("shard_*.npz")) == \
        [f"shard_{r}.npz" for r in range(world)]
    manifest = json.loads((step_dir / "MANIFEST.json").read_text())
    assert manifest["n_hosts"] == world
    like = _tree_like(want)
    port, step = CKPT.restore(
        ckpt, {k: v for k, v in _torch_tree(like).items()})
    assert step == 5
    ref, rstep = ref_CKPT.restore(ckpt, jax.tree_util.tree_map(
        jnp.asarray, like))
    assert rstep == 5
    flat_p, flat_r = {}, {}
    _flatten(_numpy_tree(port), "", flat_p)
    _flatten(ref_to_numpy(ref), "", flat_r)
    for k, v in want.items():
        np.testing.assert_array_equal(flat_p[k], v)
        np.testing.assert_array_equal(flat_r[k], v)


def _torch_tree(t):
    if isinstance(t, dict):
        return {k: _torch_tree(v) for k, v in t.items()}
    return torch.from_numpy(np.ascontiguousarray(t))


def _numpy_tree(t):
    if isinstance(t, dict):
        return {k: _numpy_tree(v) for k, v in t.items()}
    return t.numpy()


def test_train_cli_checkpoint_restores_in_the_reference(ranks):
    """The train CLI at ``--model-parallel`` tp saved steps 1 (every rank
    its shard); the reference restores its params."""
    world, _, out = ranks
    ckpt = out / "ckpt_cli"
    step_dir = ckpt / "step_00000001"
    assert (step_dir / "MANIFEST.json").exists()
    with np.load(step_dir / "shard_0.npz") as f:
        flat = {k: f[k] for k in f.files}
    like = _tree_like(flat)
    ref, step = ref_CKPT.restore(ckpt, jax.tree_util.tree_map(
        jnp.asarray, like))
    assert step == 1
    got = {}
    _flatten(ref_to_numpy(ref), "", got)
    for k, v in flat.items():
        np.testing.assert_array_equal(got[k], v)
