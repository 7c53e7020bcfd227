"""What decides ``correct``: the served tokens against the plain reference.

Once the window has closed and the program's state is freed, a sample of
the finished requests, drawn from the seed and holding the one that served
the most tokens, goes through the configuration's reference (float32, TF32
off) on weights drawn again from the same seed: one forward over each
prompt with its served tokens.  At every served token the gap is the
reference's best logit minus the reference's logit of the served token (0
where the served token is the reference's argmax).  The configuration's
``check.quantile`` of the sample's gaps is held to its ``check.limit``;
the widest gap, the mean, the 96th and 98th percentiles and the number of
flipped tokens are reported beside it.

Why a high quantile and not the widest gap: the bf16 program flips
(serves a token that is not the reference's argmax) a few % of the
tokens, at gaps of its rounding; the int8 control (the port's own int8
value path, the precision below) flips about twice as many, at wider
gaps.  The widest gap reads the two too close to hold a limit between
them (PERF.md gives the readings).  A quantile just above the program's
flips and inside the control's separates them; each configuration states
its own, as flip shares differ from model to model.
"""
from __future__ import annotations

import numpy as np
import torch

from perfbench import weights


def sample(served, rng, k):
    """Up to ``k`` request ids of ``served`` (rid -> tokens): the one with
    the most tokens, and others drawn by ``rng``."""
    if not served:
        return []
    rids = sorted(served)
    longest = max(rids, key=lambda r: (len(served[r]), -r))
    rest = [r for r in rids if r != longest]
    pick = rng.choice(len(rest), size=min(k - 1, len(rest)), replace=False)
    return [longest] + [rest[i] for i in sorted(pick)]


def gaps(bench, conf, seed, dev, served, prompts, rids):
    """The gap of every served token of ``rids``, one array a request."""
    params, masks, _ = weights.draw(conf, seed, dev)
    del masks
    seqs = []
    for r in rids:
        toks = np.concatenate([prompts[r], np.asarray(served[r][:-1],
                                                      np.int64)])
        seqs.append((torch.as_tensor(toks, dtype=torch.long, device=dev),
                     len(prompts[r])))
    ref = bench.reference(conf["reference"]).logits(params, conf["model"],
                                                    seqs)
    out = []
    for r, lg in zip(rids, ref):
        t = torch.as_tensor(served[r], dtype=torch.long, device=dev)
        chosen = lg.gather(1, t[:, None])[:, 0]
        out.append((lg.max(-1).values - chosen).cpu().numpy())
    del params, ref
    return out


def run(bench, conf, seed, dev, served, prompts, k):
    """{"correct", "numbers": {name: {"value", "limit"}}, "sample": ...,
    "gaps": every gap read}"""
    q, limit = float(conf["check"]["quantile"]), float(conf["check"]["limit"])
    name = f"gap_p{round(q * 100)}"
    rids = sample(served, np.random.default_rng(seed + 2), k)
    if not rids:
        return {"correct": False, "sample": {"requests": 0}, "gaps": None,
                "numbers": {name: {"value": None, "limit": limit}}}
    g = np.concatenate(gaps(bench, conf, seed, dev, served, prompts, rids))
    value = float(np.quantile(g, q))
    return {"correct": bool(value <= limit), "gaps": g,
            "sample": {"requests": len(rids), "tokens": int(g.size),
                       "flipped": int((g > 0).sum()),
                       "gap_max": float(g.max()),
                       "gap_mean": float(g.mean()),
                       "gap_p96": float(np.quantile(g, 0.96)),
                       "gap_p98": float(np.quantile(g, 0.98))},
            "numbers": {name: {"value": value, "limit": limit}}}
