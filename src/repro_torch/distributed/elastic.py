"""Elastic restarts and straggler mitigation (the reference's
``repro.distributed.elastic``).

* ``choose_mesh_shape``: given the live device count after failures, the
  largest power-of-two (data, model) split that keeps the requested
  model-parallel degree (a pure function of the counts).
* ``rebuild_mesh``: that shape over the ranks of the process group, as a
  ``DeviceMesh`` (``launch.mesh.make_mesh``).
* ``replica_restore``: a replica's cold start — the newest complete
  checkpoint (``distributed.checkpoint``), then the packed layouts through
  the artifact store (``compile_model(artifact_dir=)``), so a replica
  started under load serves already-packed layouts; a stale or corrupt
  artifact (digest, checksums, layout validation) costs a fresh pack, and
  a corrupt newest checkpoint a fallback to the next older one.
* Straggler mitigation is structural: the data pipeline is a pure function
  of (seed, step, shard) (``data.pipeline``), so a backup host can
  recompute any shard with no coordination; ``StragglerMonitor`` is the
  'launch a backup after k x the median step' policy hook.
"""
from __future__ import annotations

import logging


def choose_mesh_shape(n_devices: int, model_parallel: int = 16,
                      want_pods: int = 1):
    """The largest power-of-two mesh within ``n_devices`` that keeps
    ``model_parallel`` (halved until it divides the count): ((dp, mp),
    ("data", "model")), or with ``want_pods`` > 1 dividing the rest
    ((pods, dp, mp), ("pod", "data", "model"))."""
    mp = model_parallel
    while mp > 1 and n_devices % mp:
        mp //= 2
    rest = n_devices // mp
    if want_pods > 1 and rest % want_pods == 0:
        return (want_pods, rest // want_pods, mp), ("pod", "data", "model")
    dp = 1
    while dp * 2 <= rest:
        dp *= 2
    return (dp, mp), ("data", "model")


def replica_restore(ckpt_dir, tree_like, *, mapping=(), masks=None,
                    artifact_dir=None, step=None, spec=None, device="cuda"):
    """A replica's start: restore the newest complete checkpoint onto
    ``device``, then load or compile the packed params through the same
    artifact front door as ``launch.serve --artifacts``.

    ``masks=None`` derives the masks from the zeros in the restored
    weights (checkpoints hold masked params), so a replica needs only the
    checkpoint and the store.  ``spec`` is the ``serve.compile.
    CompileSpec`` (``CompileSpec(tp=4)`` packs tensor-parallel layouts).
    Returns ``(exec_params, report, step)``, or ``(None, None, None)``
    when no checkpoint exists yet.

    With ``step=None`` a step that fails its checks (``CheckpointError``:
    checksum, truncation, a missing file) logs its code and falls back to
    the next older complete step; a pinned ``step`` raises instead.  The
    tree then passes ``serve.compile.degrade_invalid_layers``, so a layout
    corrupted after the store's own checks serves masked-dense, never
    wrong."""
    from repro_torch.distributed import checkpoint as CKPT
    from repro_torch.serve.compile import (compile_model,
                                           degrade_invalid_layers)

    log = logging.getLogger("repro_torch.distributed.elastic")
    steps = [step] if step is not None else CKPT.available_steps(ckpt_dir)
    params = restored = None
    for s in steps:
        try:
            params, restored = CKPT.restore(ckpt_dir, tree_like, step=s,
                                            device=device)
            break
        except CKPT.CheckpointError as e:
            if step is not None:
                raise          # a pinned step is never substituted
            log.warning("checkpoint step %d failed its checks [%s], "
                        "falling back to the next older step: %s",
                        s, e.code, e)
    if params is None:
        return None, None, None
    exec_params, report = compile_model(params, masks, mapping, spec=spec,
                                        device=device,
                                        artifact_dir=artifact_dir)
    exec_params, report, _ = degrade_invalid_layers(exec_params, report)
    return exec_params, report, restored


def rebuild_mesh(model_parallel=16, want_pods=1, device=None):
    """The mesh ``choose_mesh_shape`` picks for the process group's world
    size (one rank a device); the card unless ``device`` says the CPU."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh
    if not dist.is_initialized():
        raise RuntimeError("rebuild_mesh needs a started process group "
                           "(one rank per device)")
    shape, axes = choose_mesh_shape(dist.get_world_size(), model_parallel,
                                    want_pods)
    return make_mesh(shape, axes, device)


class StragglerMonitor:
    """Track per-step durations; signal when a step exceeds k x median —
    the driver then re-issues the step's shards to backup hosts (the data
    pipeline determinism makes the recompute exact)."""

    def __init__(self, k: float = 3.0, window: int = 50):
        self.k = k
        self.window = window
        self.durations = []

    def observe(self, seconds: float) -> bool:
        self.durations.append(seconds)
        hist = self.durations[-self.window:]
        if len(hist) < 5:
            return False
        med = sorted(hist)[len(hist) // 2]
        return seconds > self.k * med
