"""Search-based pruning-scheme mapping (paper §5.1) — REINFORCE over a
seq2seq policy, the reference's search with its LSTM policy in torch.

State per layer (paper: {layer type, kernel size, in_ch, out_ch}): a feature
vector [kind-onehot, log M/K/N].  Action per layer (paper: {regularity,
block size}, extended with serving precision): a triple of categoricals —
scheme (masked to the applicable set), block size, and value precision
(PRECISION_MENU: float vs int8 quantized values, priced by
``matmul_latency(value_bytes=1)``).  Policy: LSTM decoder over the layer
sequence; policy gradient with a moving baseline B (Eq. 6); reward =
accuracy-proxy - w * modeled latency, the latency from the offline latency
model (§5.2.1).

The policy is a dict of fp32 tensors in the reference's names and shapes,
so the reference's weights cross as they are.  Actions are drawn from an
explicit ``torch.Generator``: the same seed does not give the reference's
draws (torch's RNG is not JAX's PRNG)."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.latency_model import (V5E, im2col_x_frac,
                                            matmul_latency,
                                            pattern_executed_frac)
from repro_torch.core.mapper_rule import LayerDesc
from repro_torch.core.reweighted import SchemeChoice

KINDS = ("fc", "conv3x3", "conv1x1", "convkxk", "dw", "frozen")
SCHEME_MENU = ("none", "unstructured", "structured_row", "pattern", "block",
               "block_punched")
BLOCK_MENU = ((4, 4), (8, 16), (16, 32), (32, 64), (64, 128), (128, 128))
# serving precision of the packed values (None = float; "int8" = the
# quantized layouts of core.quant, priced at value_bytes=1)
PRECISION_MENU = (None, "int8")
# schemes whose packed layouts can carry quantized values — precision
# picks on other schemes are inert (actions_to_spec drops them)
_QUANTIZABLE = ("pattern", "block", "block_row", "block_col",
                "block_punched")
_MASKED = -1e9          # logit of a scheme the layer cannot take


def applicable(kind: str) -> np.ndarray:
    """Boolean mask over SCHEME_MENU per layer kind (paper constraints:
    pattern is 3x3-only; dw/frozen layers are never pruned)."""
    m = np.zeros(len(SCHEME_MENU), bool)
    if kind in ("dw", "frozen"):
        m[0] = True
        return m
    m[:] = True
    if kind != "conv3x3":
        m[SCHEME_MENU.index("pattern")] = False
        m[SCHEME_MENU.index("block_punched")] = kind == "convkxk"
    return m


def layer_features(layers: list[LayerDesc]) -> np.ndarray:
    f = np.zeros((len(layers), len(KINDS) + 3), np.float32)
    for i, ld in enumerate(layers):
        f[i, KINDS.index(ld.kind)] = 1.0
        f[i, -3:] = np.log([ld.M, ld.K, ld.N])
    return f


# -- tiny LSTM policy ---------------------------------------------------------

def policy_init(generator: torch.Generator, in_dim, hidden=64):
    """The policy's weights: N(0, 0.1^2) matrices, a zero LSTM bias."""
    def s(*shape):
        return torch.randn(shape, generator=generator) * 0.1
    return {"wx": s(in_dim, 4 * hidden),
            "wh": s(hidden, 4 * hidden),
            "b": torch.zeros(4 * hidden),
            "head_s": s(hidden, len(SCHEME_MENU)),
            "head_b": s(hidden, len(BLOCK_MENU)),
            "head_p": s(hidden, len(PRECISION_MENU))}


def _lstm_step(p, carry, x):
    """One LSTM step; the gates split i, f, g, o (``jnp.split``'s order)."""
    h, c = carry
    z = x @ p["wx"] + h @ p["wh"] + p["b"]
    i, f, g, o = torch.chunk(z, 4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h = torch.sigmoid(o) * torch.tanh(c)
    return (h, c), h


def _heads(p, hc, x, mask):
    """The LSTM step and the three heads' log-probabilities (schemes the
    layer cannot take at ``_MASKED``)."""
    hc, h = _lstm_step(p, hc, x)
    ls = torch.where(mask, h @ p["head_s"],
                     torch.tensor(_MASKED, dtype=h.dtype))
    return hc, (torch.log_softmax(ls, -1), torch.log_softmax(h @ p["head_b"],
                                                             -1),
                torch.log_softmax(h @ p["head_p"], -1))


def _start(p):
    hidden = p["wh"].shape[0]
    return (torch.zeros(hidden), torch.zeros(hidden))


def _as_tensors(feats, app_masks):
    return (torch.as_tensor(np.asarray(feats), dtype=torch.float32),
            torch.as_tensor(np.asarray(app_masks), dtype=torch.bool))


def sample_mapping(p, feats, app_masks, generator: torch.Generator):
    """Returns (scheme_idx (L,), block_idx (L,), precision_idx (L,),
    logp scalar), each action drawn from ``generator``."""
    feats, app_masks = _as_tensors(feats, app_masks)
    hc, logp, acts = _start(p), torch.zeros(()), []
    for x, mask in zip(feats, app_masks):
        hc, heads = _heads(p, hc, x, mask)
        a = [torch.multinomial(lp.exp(), 1, generator=generator)[0]
             for lp in heads]
        logp = logp + sum(lp[ai] for lp, ai in zip(heads, a))
        acts.append(a)
    a_s, a_b, a_p = (torch.stack(col) for col in zip(*acts))
    return a_s, a_b, a_p, logp


def mapping_logp(p, feats, app_masks, a_s, a_b, a_p):
    """Log-probability of the given actions under the policy ``p``."""
    feats, app_masks = _as_tensors(feats, app_masks)
    hc, logp = _start(p), torch.zeros(())
    for x, mask, s, b, pr in zip(feats, app_masks, np.asarray(a_s),
                                 np.asarray(a_b), np.asarray(a_p)):
        hc, (ls, lb, lp) = _heads(p, hc, x, mask)
        logp = logp + ls[int(s)] + lb[int(b)] + lp[int(pr)]
    return logp


def _precision(scheme, a_p, i):
    """Resolve layer i's precision action: the picked value dtype on a
    quantizable scheme, None otherwise (or when no a_p was sampled)."""
    if a_p is None or scheme not in _QUANTIZABLE:
        return None
    return PRECISION_MENU[int(np.asarray(a_p)[i])]


def actions_to_spec(layers, a_s, a_b, a_p=None, rate=None) -> list:
    """Decode sampled action indices into a PruneSpec; ``a_p`` (the
    precision head, optional) becomes each choice's ``value_dtype`` on
    quantizable schemes."""
    spec = []
    for i, (ld, s, b) in enumerate(zip(layers, np.asarray(a_s),
                                       np.asarray(a_b))):
        scheme = SCHEME_MENU[int(s)]
        block = BLOCK_MENU[int(b)]
        # snap block to layer divisibility
        bk = max(1, np.gcd(block[0], ld.K))
        bn = max(1, np.gcd(block[1], ld.N))
        spec.append((ld.path, SchemeChoice(
            scheme, (int(bk), int(bn)), rate=rate,
            value_dtype=_precision(scheme, a_p, i))))
    return spec


def mapping_latency(layers, a_s, a_b, a_p=None, compression=8.0,
                    target=V5E) -> float:
    """Modeled total latency of a sampled mapping — the reward's latency
    term.  Pattern picks are priced at the tap kernel's executed-tap
    fraction (``pattern_executed_frac``); conv-as-GEMM layers
    (``LayerDesc.taps`` > 1) at the implicit-GEMM path's activation
    traffic (``im2col_x_frac``); int8 precision picks at 1 byte per stored
    value plus the kernels' fp32 scale traffic."""
    t = 0.0
    for i, (ld, s, b) in enumerate(zip(layers, np.asarray(a_s),
                                       np.asarray(a_b))):
        scheme = SCHEME_MENU[int(s)]
        taps = getattr(ld, "taps", 0)
        xf = im2col_x_frac(taps) if taps > 1 else None
        frac = None
        if scheme == "none":
            comp = 1.0
        elif scheme == "pattern":
            frac = pattern_executed_frac()
            comp = 1 / frac
        else:
            comp = compression
        vb = 1 if _precision(scheme, a_p, i) == "int8" else None
        t += ld.count * matmul_latency(
            ld.M, ld.K, ld.N, scheme=scheme, block=BLOCK_MENU[int(b)],
            compression=comp, target=target, value_bytes=vb,
            executed_frac=frac, x_frac=xf)
    return t


def search(layers, evaluate_fn, *, generator=None, iters=20, samples=4,
           lr=5e-2, latency_weight=1.0, hidden=32, verbose=False):
    """REINFORCE loop (Eq. 5-6).  evaluate_fn(spec) -> accuracy-proxy in
    [0,1] (e.g. exp(-finetuned loss)).  The policy's init and every sample
    draw from ``generator`` (default: seeded 0).  Each iteration sums the
    gradients of -advantage * logp over its samples and steps
    ``w - lr * g / samples``; the baseline moves 0.1 of the way to the
    iteration's mean reward.  Returns (best_spec, history)."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    feats = layer_features(layers)
    app = np.stack([applicable(ld.kind) for ld in layers])
    p = policy_init(generator, feats.shape[1], hidden)
    baseline = 0.0
    best = (None, -np.inf)
    history = []
    for it in range(iters):
        grads = {k: torch.zeros_like(v) for k, v in p.items()}
        rewards = []
        for _ in range(samples):
            with torch.no_grad():
                a_s, a_b, a_p, _ = sample_mapping(p, feats, app, generator)
            spec = actions_to_spec(layers, a_s, a_b, a_p)
            acc = evaluate_fn(spec)
            lat = mapping_latency(layers, a_s, a_b, a_p)
            r = acc - latency_weight * lat
            rewards.append(r)
            if r > best[1]:
                best = (spec, r)
            adv = r - baseline
            leaves = {k: v.detach().requires_grad_(True)
                      for k, v in p.items()}
            loss = -adv * mapping_logp(leaves, feats, app, a_s, a_b, a_p)
            g = torch.autograd.grad(loss, list(leaves.values()))
            for k, gk in zip(leaves, g):
                grads[k] += gk
        baseline = 0.9 * baseline + 0.1 * float(np.mean(rewards))
        p = {k: w - lr * grads[k] / samples for k, w in p.items()}
        history.append(float(np.mean(rewards)))
        if verbose:
            print(f"  search iter {it}: mean reward {history[-1]:.4f}")
    return best[0], history
