"""Optimizers over the port's nested-dict param trees: AdamW with fp32
state, and Adafactor (factored second moment, no first moment) for the
>= 70B archs whose Adam state cannot fit; the cosine LR schedule and
global-norm clipping (the reference's ``repro.optim.adamw``).

Every update is computed in fp32 and the params come back in their own
dtype.  AdamW's ``m`` / ``v`` are updated in place (at full width the
fp32 pair takes four times the bf16 params: a second copy would not fit
beside it) and returned in the new state; the params are new tensors.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models import module as M


def cosine_schedule(step, base_lr, warmup=100, total=10000, min_frac=0.1):
    """Linear warmup over ``warmup`` steps, then cosine decay to
    ``min_frac`` of ``base_lr`` at ``total``; an fp32 tensor on ``step``'s
    device, computed in fp32 with the reference's operation order."""
    step = torch.as_tensor(step).float()
    warm = base_lr * (step + 1) / max(warmup, 1)
    prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0, 1)
    cos = base_lr * (min_frac + (1 - min_frac) * 0.5 * (
        1 + torch.cos(torch.tensor(math.pi, dtype=torch.float32,
                                   device=step.device) * prog)))
    return torch.where(step < warmup, warm, cos)


def _flat(tree):
    """The leaves of a nested dict, in the tree's own order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _flat(v)]
    return [tree]


def clip_by_global_norm(grads, max_norm=1.0):
    """(grads scaled to global L2 norm <= ``max_norm``, each cast back to
    its own dtype; the fp32 global norm before scaling)."""
    gn = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                        for g in _flat(grads)))
    scale = torch.clamp(max_norm / torch.clamp_min(gn, 1e-12), max=1.0)
    return M.tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), gn


# -- AdamW -------------------------------------------------------------------

def adamw_init(params):
    def z(p):
        # zeros_like: a placed param's moments take its placement
        return torch.zeros_like(p, dtype=torch.float32)
    dev = _flat(params)[0].device
    return {"m": M.tree_map(z, params), "v": M.tree_map(z, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def adamw_update(grads, state, params, lr, b1=0.9, b2=0.95, eps=1e-8, wd=0.1):
    """One AdamW step with bias correction and decoupled weight decay:
    returns (params, state).  ``state``'s ``m`` / ``v`` tensors are updated
    in place."""
    step = state["step"] + 1
    t = step.float()
    c1, c2 = 1 - b1 ** t, 1 - b2 ** t

    def upd(g, m, v, p):
        g = g.float()
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * torch.square(g))
        delta = (m / c1) / (torch.sqrt(v / c2) + eps) + wd * p.float()
        return (p.float() - lr * delta).to(p.dtype)

    new_p = M.tree_map(upd, grads, state["m"], state["v"], params)
    return new_p, {"m": state["m"], "v": state["v"], "step": step}


# -- Adafactor ----------------------------------------------------------------

def adafactor_init(params):
    def st(p):
        kw = dict(dtype=torch.float32, device=p.device)
        if p.ndim >= 2:
            return {"vr": torch.zeros(p.shape[:-1], **kw),
                    "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], **kw)}
        return {"v": torch.zeros(p.shape, **kw)}
    dev = _flat(params)[0].device
    return {"f": M.tree_map(st, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def _map_params(fn, grads, fstate, params):
    """``fn(g, f, p) -> (new p, new f)`` over the params' leaves, ``f``
    the per-param state dict beside each: (params tree, state tree)."""
    if isinstance(grads, dict):
        outs = {k: _map_params(fn, grads[k], fstate[k], params[k])
                for k in grads}
        return ({k: o[0] for k, o in outs.items()},
                {k: o[1] for k, o in outs.items()})
    return fn(grads, fstate, params)


def adafactor_apply(grads, state, params, lr, decay=0.99, eps=1e-30,
                    clip_thresh=1.0):
    """One Adafactor step (row / column second-moment factors for >= 2-D
    leaves, a full one otherwise; update RMS clipped to ``clip_thresh``):
    returns (params, state)."""
    step = state["step"] + 1

    def upd(g, f, p):
        g = g.float()
        g2 = g * g + eps
        if p.ndim >= 2:
            vr = decay * f["vr"] + (1 - decay) * torch.mean(g2, dim=-1)
            vc = decay * f["vc"] + (1 - decay) * torch.mean(g2, dim=-2)
            r = vr / torch.clamp_min(torch.mean(vr, dim=-1, keepdim=True),
                                     eps)
            u = g / (torch.sqrt(r)[..., None] * torch.sqrt(vc)[..., None, :]
                     + 1e-12)
            nf = {"vr": vr, "vc": vc}
        else:
            v = decay * f["v"] + (1 - decay) * g2
            u = g / (torch.sqrt(v) + 1e-12)
            nf = {"v": v}
        rms_u = torch.sqrt(torch.mean(u * u) + 1e-12)
        u = u / torch.clamp_min(rms_u / clip_thresh, 1.0)
        return (p.float() - lr * u).to(p.dtype), nf

    new_p, new_f = _map_params(upd, grads, state["f"], params)
    return new_p, {"f": new_f, "step": step}


def make_optimizer(kind: str):
    """(init, update) of ``kind``: "adamw" or "adafactor"."""
    if kind == "adamw":
        return adamw_init, adamw_update
    if kind == "adafactor":
        return adafactor_init, adafactor_apply
    raise ValueError(kind)
