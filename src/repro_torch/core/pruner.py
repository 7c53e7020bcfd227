"""Pruning orchestration: the end-to-end compress pipeline (paper Fig 2).

  prune(model) =
    1. map schemes        (rule-based or search-based -> PruneSpec)
    2. reweighted train   (loss + lam * R(alpha, W), alphas re-estimated)
    3. threshold          (global tau -> per-layer/per-block auto rates)
    4. finetune masked    (regain accuracy)

One-shot mode (magnitude -> mask -> short retrain) is the fast proxy the
search-based mapper uses for reward evaluation (§5.1)."""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core import reweighted as RW
from repro_torch.train.trainer import apply_masks


@dataclass
class PruneResult:
    params: dict
    masks: dict
    report: dict


def one_shot(params, spec, rate) -> dict:
    """Magnitude one-shot masks at a uniform per-layer group rate."""
    return RW.masks_for_spec(params, spec, default_rate=rate)


def reweighted_prune(params, opt_state, spec, train_step_fn, batch_fn, *,
                     lam=1e-4, eps=1e-4, steps=100, reweight_every=20,
                     target_rate=0.8, finetune_steps=50,
                     verbose=False) -> PruneResult:
    """Full pipeline on an already-built train step (taking (params,
    opt_state, batch, masks, alphas)); ``batch_fn(step) -> batch``.
    Alphas are re-estimated at every ``reweight_every``-th step after the
    first; the fine-tune runs with the masks and no alphas, and the
    result's params are masked."""
    cfg = RW.ReweightedConfig(spec=tuple(spec), lam=lam, eps=eps,
                              reweight_every=reweight_every)
    alphas = RW.init_alphas(params, spec)
    # phase 1: reweighted regularization training
    for step in range(steps):
        if step % reweight_every == 0 and step > 0:
            alphas = RW.update_alphas(params, cfg)
        params, opt_state, metrics = train_step_fn(
            params, opt_state, batch_fn(step), None, alphas)
        if verbose and step % 20 == 0:
            print(f"  reweighted step {step}: loss "
                  f"{float(metrics['loss']):.4f}")
    # phase 2: automatic thresholds -> masks
    tau = RW.global_threshold(params, spec, target_rate)
    masks = RW.masks_for_spec(params, spec, threshold=tau)
    # phase 3: masked finetune
    for step in range(finetune_steps):
        params, opt_state, metrics = train_step_fn(
            params, opt_state, batch_fn(steps + step), masks, None)
        if verbose and step % 20 == 0:
            print(f"  finetune step {step}: loss "
                  f"{float(metrics['loss']):.4f}")
    params = apply_masks(params, masks)
    return PruneResult(params=params, masks=masks,
                       report=RW.sparsity_report(params, masks))
