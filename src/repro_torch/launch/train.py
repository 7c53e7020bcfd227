"""Training driver: seeded init -> (optional pruning schedule) -> train
loop with checkpoints and resume, straggler monitoring and deterministic
data shards, on the card.

  PYTHONPATH=src python -m repro_torch.launch.train --arch yi-9b --smoke \\
      --steps 50 --prune --target-rate 0.6

With ``--prune`` the rule mapper picks each layer's scheme (training-free,
``dataset_hard=False``, compression 1 / (1 - target rate)), every block
snapped to at most (8, 16); the reweighted penalty (lam = 1e-3) trains
until 60 % of the steps, where one global threshold sets the masks that
the remaining steps train under.  ``--device cpu`` runs the plain PyTorch
versions (for small configs).

Every ``--ckpt-every`` steps the state after that step, ``{"params",
"opt"}``, is saved to ``--ckpt-dir`` (``distributed.checkpoint``, the
reference's format); ``--resume`` restores the newest complete step and
goes on with the step after it, so a resumed run trains on the batches and
takes the losses of an uninterrupted one.  (The reference's resume runs
the saved step once more.)  As in the reference, the masks and alphas are
not checkpointed: a run resumed after the prune step trains unmasked.

The run is always on a mesh, as the reference's: ``--model-parallel`` 1
is ``launch.mesh.make_local_mesh()`` (a one-rank group the CLI starts and
ends when none is running), more is ``elastic.rebuild_mesh`` over the
ranks of a group the caller started (one process per device, e.g. under
``torchrun``).  The params are placed by ``sharding.param_shardings``,
the step runs with ``make_dist``'s ``Dist``, checkpoints hold whole
arrays (every rank writes its shard) and a resume places them again.
The pruning schedule's threshold, masks and alphas are computed on the
gathered params.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import configs
from repro_torch.core import reweighted as RW
from repro_torch.core.mapper_rule import lm_layers, map_rules
from repro_torch.data.pipeline import synthetic_batch
from repro_torch.distributed import checkpoint as CKPT
from repro_torch.distributed import sharding as SH
from repro_torch.distributed.elastic import StragglerMonitor, rebuild_mesh
from repro_torch.launch import mesh as MESH
from repro_torch.models import module as M
from repro_torch.models import transformer as T
from repro_torch.train.trainer import apply_masks, make_train_step


def snapped_spec(cfg, tokens, target_rate):
    """``map_rules``' spec for ``cfg`` at ``tokens`` tokens, each pruned
    rule's block cut to at most (8, 16) (so it tiles SMOKE widths)."""
    spec, _ = map_rules(lm_layers(cfg, tokens=tokens), dataset_hard=False,
                        compression=1 / (1 - target_rate))
    return [(p, RW.SchemeChoice(c.scheme, (min(c.block[0], 8),
                                           min(c.block[1], 16)))
             if c.scheme != "none" else c) for p, c in spec]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-9b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--prune", action="store_true")
    ap.add_argument("--target-rate", type=float, default=0.6)
    ap.add_argument("--ckpt-dir", default="build/ckpt")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = M.resolve_device(args.device)
    mesh = (MESH.make_local_mesh(device=dev) if args.model_parallel == 1
            else rebuild_mesh(model_parallel=args.model_parallel,
                              device=dev))
    try:
        return _train(args, dev, mesh)
    finally:
        MESH.close_local_mesh()


def _train(args, dev, mesh):
    cfg = configs.get(args.arch, smoke=args.smoke)
    dist = SH.make_dist(mesh, cfg, args.batch)
    params = T.init_lm(cfg, seed=0, device=dev)
    p_shard = SH.param_shardings(params, cfg, mesh)
    params = SH.distribute(params, p_shard)

    reweighted = None
    masks, alphas = None, None
    spec = None
    if args.prune:
        spec = snapped_spec(cfg, args.batch * args.seq, args.target_rate)
        reweighted = RW.ReweightedConfig(spec=tuple(spec), lam=1e-3)
        alphas = RW.init_alphas(SH.full_tree(params), spec)

    opt_init, train_step = make_train_step(cfg, lr=args.lr,
                                           reweighted=reweighted, dist=dist)
    opt_state = opt_init(params)

    start, metrics = 0, None
    if args.resume:
        o_specs = SH.opt_state_specs(opt_state, SH.param_specs(
            params, cfg, mesh), cfg.optimizer)
        shardings = {"params": p_shard,
                     "opt": M.tree_map(lambda s: SH.NamedSharding(mesh, s),
                                       o_specs)}
        restored, saved = CKPT.restore(args.ckpt_dir,
                                       {"params": params, "opt": opt_state},
                                       device=dev, shardings=shardings)
        if restored is not None:
            params, opt_state = restored["params"], restored["opt"]
            start = saved + 1
            print(f"resumed from step {saved}")

    mon = StragglerMonitor()
    prune_at = int(args.steps * 0.6) if args.prune else None
    for step in range(start, args.steps):
        if reweighted and step and step % reweighted.reweight_every == 0 \
                and (prune_at is None or step < prune_at):
            alphas = RW.update_alphas(SH.full_tree(params), reweighted)
        if prune_at is not None and step == prune_at:
            whole = SH.full_tree(params)
            tau = RW.global_threshold(whole, spec, args.target_rate)
            masks = RW.masks_for_spec(whole, spec, threshold=tau)
            alphas = None
            rep = RW.sparsity_report(whole, masks)["__overall__"]
            print(f"step {step}: pruned -> density {rep['density']:.3f} "
                  f"(compression {rep['compression']:.2f}x)")
        batch = synthetic_batch(
            0, step, args.batch, args.seq, cfg.vocab,
            frontend_tokens=cfg.n_frontend_tokens
            if cfg.family in ("encdec", "vlm") else 0, d_model=cfg.d_model,
            device=dev)
        t0 = time.perf_counter()
        params, opt_state, metrics = train_step(params, opt_state, batch,
                                                masks, alphas)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if mon.observe(dt):
            print(f"step {step}: straggler detected ({dt:.2f}s) — backup "
                  f"shard recompute would trigger here")
        if step % 10 == 0:
            print(f"step {step}: loss {float(metrics['loss']):.4f} "
                  f"({dt*1e3:.0f} ms)")
        if step and step % args.ckpt_every == 0:
            CKPT.save(args.ckpt_dir, step,
                      {"params": params, "opt": opt_state})
    if metrics is not None:
        print(f"final loss {float(metrics['loss']):.4f}")
    # the weights the masks pruned are zero in what is returned
    return apply_masks(SH.full_tree(params), masks), masks


if __name__ == "__main__":
    main()
