"""Training step factory: loss (+ MoE aux, + the paper's reweighted
group-lasso penalty when pruning is active), global-norm clip, optimizer
update.

Masked-dense semantics: pruning masks multiply the params before the
forward pass, so the gradients of pruned weights are exactly zero; the
products stay ``torch.matmul`` under autograd (the reference leaves them
to XLA).  The BCS kernel is the serving path: it runs once
``serve.compile.compile_model`` packs the trained, masked params.

With ``dist`` (``distributed.sharding.Dist``) the step runs on its mesh:
the params (and the optimizer state, which follows them) are placed by
the caller (``sharding.param_shardings``, "tp" or "fsdp" specs), the
batch by the batch spec, and the loss and grad norm come back whole.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import reweighted as RW
from repro_torch.distributed import sharding as SH
from repro_torch.models import layers as L
from repro_torch.models import module as M
from repro_torch.models import transformer as T
from repro_torch.optim.adamw import (clip_by_global_norm, cosine_schedule,
                                     make_optimizer)


def apply_masks(params, masks):
    """masks is a full-structure tree: {0,1} tensors for prunable leaves,
    scalar sentinels elsewhere (see ``core.reweighted``)."""
    if masks is None:
        return params
    return M.tree_map(
        lambda p, m: p if m.ndim == 0 else
        p * L.replicated_like(m.to(p.dtype), p), params, masks)


def make_loss_fn(cfg: ArchConfig, aux_weight=0.01, reweighted=None,
                 dist=None):
    """``loss_fn(params, batch, masks=None, alphas=None) -> (total, ce)``:
    total = ce + aux_weight * aux, plus ``reweighted.lam`` times the
    penalty on the UNMASKED params when ``reweighted`` (a
    ``core.reweighted.ReweightedConfig``) and alphas are given."""

    def loss_fn(params, batch, masks=None, alphas=None):
        logits, aux = T.forward_aux(apply_masks(params, masks), cfg,
                                    batch["tokens"],
                                    frontend=batch.get("frontend"),
                                    dist=dist)
        if dist is None:
            ce = L.cross_entropy(logits, batch["labels"])
        else:
            # the gold-logit gather has no DTensor rule: the loss runs on
            # whole logits (``Dist.replicated``)
            ce = dist.replicated(L.cross_entropy)(logits, batch["labels"])
        total = ce + aux_weight * aux
        if reweighted is not None and alphas is not None:
            # the group norms run on the gathered params, and their sum
            # joins the placed loss as a replicated value (differentiably)
            whole = params if dist is None else SH.full_tree(params)
            pen = L.replicated_like(RW.penalty(whole, alphas, reweighted),
                                    total)
            total = total + reweighted.lam * pen
        return total, ce

    return loss_fn


def value_and_grad(loss_fn):
    """``f(params, *args) -> ((total, aux), grads)``, ``loss_fn(params,
    *args)`` returning (total, aux) and the grads of total a tree of the
    params' structure (each in its leaf's dtype), by autograd."""

    def f(params, *args):
        leaves = []

        def track(p):
            leaves.append(p.detach().requires_grad_(True))
            return leaves[-1]
        total, aux = loss_fn(M.tree_map(track, params), *args)
        grads = iter(torch.autograd.grad(total, leaves))
        return ((total.detach(), aux.detach()),
                M.tree_map(lambda _: next(grads), params))

    return f


def make_train_step(cfg: ArchConfig, lr=3e-4, reweighted=None, grad_accum=1,
                    dist=None, compress_cross_pod=False):
    """(opt_init, train_step) for ``cfg.optimizer``.  ``dist`` runs it on
    a mesh; ``compress_cross_pod`` is accepted and unused, as in the
    reference (``sharding.compressed_allreduce`` is the hook).

    ``train_step(params, opt_state, batch, masks=None, alphas=None) ->
    (params, opt_state, {"loss": ce, "grad_norm"})``: the grads (averaged
    in fp32 over ``grad_accum`` micro-batches of the batch's leading dim,
    when > 1) clipped to global norm 1, then one optimizer step at the
    cosine schedule's lr for the state's step count."""
    opt_init, opt_update = make_optimizer(cfg.optimizer)
    grad_fn = value_and_grad(make_loss_fn(cfg, reweighted=reweighted,
                                          dist=dist))

    def train_step(params, opt_state, batch, masks=None, alphas=None):
        if dist is None:
            return step(params, opt_state, batch, masks, alphas)
        with dist.region():
            batch = {k: dist.place_batch(v) for k, v in batch.items()}
            params, opt_state, m = step(params, opt_state, batch, masks,
                                        alphas)
        return params, opt_state, {k: dist.gather(v) for k, v in m.items()}

    def step(params, opt_state, batch, masks, alphas):
        if grad_accum > 1:
            n = batch["tokens"].shape[0] // grad_accum
            grads, ce = None, 0.0
            for i in range(grad_accum):
                mb = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
                (_, ce_i), g = grad_fn(params, mb, masks, alphas)
                ce = ce + ce_i
                grads = (M.tree_map(lambda x: x.float(), g) if grads is None
                         else M.tree_map(lambda a, b: a + b, grads, g))
            grads = M.tree_map(lambda g: g / grad_accum, grads)
            ce = ce / grad_accum
        else:
            (_, ce), grads = grad_fn(params, batch, masks, alphas)
        grads, gnorm = clip_by_global_norm(grads)
        lr_t = cosine_schedule(opt_state["step"], lr)
        params, opt_state = opt_update(grads, opt_state, params, lr_t)
        return params, opt_state, {"loss": ce, "grad_norm": gnorm}

    return opt_init, train_step
