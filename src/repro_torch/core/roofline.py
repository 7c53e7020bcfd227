"""Roofline analysis over the dry-run records (the reference's
``repro.core.roofline``, priced for a target instead of fixed constants).

Three terms per (arch x shape) on the single-pod 16x16 mesh, from the
extrapolated per-device costs (``launch.dryrun``'s probe pass):

    compute    = flops_per_device / peak_flops
    memory     = bytes_per_device / hbm_bw
    collective = collective_bytes_per_device / ici_bw

plus MODEL_FLOPS = 6*N*D (train) / 2*N*D (inference), N = active params,
and the usefulness ratio MODEL_FLOPS / (flops * n_devices).

The rates come from a ``core.latency_model.TPUTarget`` (its
``peak_flops``, ``hbm_bw`` and ``ici_bw``).  The default, ``H100``, is the
H100 SXM's datasheet, not a measurement: 989 TFLOP/s dense bf16 and 3.35
TB/s HBM3.  Its collective link is 50 GB/s a card: the 400 Gb/s NIC each
card has, because the production mesh's 16-wide model axis spans two
8-card NVLink nodes, so a model-axis collective runs at the NIC's rate,
not NVLink's.  ``latency_model.V5E`` (197 TFLOP/s, 819 GB/s, ICI 50
GB/s) prices a record as the reference does.  A port record's bytes are unfused (an
upper bound on HBM traffic, ``launch.dryrun``), so its memory term is an
upper bound too.
"""
from __future__ import annotations

import json
import pathlib

from repro_torch.core.latency_model import TPUTarget

H100 = TPUTarget("h100-sxm", 989e12, 3.35e12, 50e9)
N_DEVICES = 256


def param_counts(cfg):
    """(total params, active params) — active discounts MoE experts to
    top_k/n_experts (the 6*N_active*D convention)."""
    from repro_torch.models import transformer as T
    from repro_torch.models.module import tree_map_with_path
    counts = []
    tree_map_with_path(lambda p, leaf: counts.append((p, leaf.numel())),
                       T.init_lm(cfg, device="meta"))
    total, expert = 0, 0
    for path, n in counts:
        total += n
        if "moe/gate" in path or "moe/up" in path or "moe/down" in path:
            expert += n
    active = total - expert
    if cfg.n_experts:
        active += expert * cfg.top_k / cfg.n_experts
    return total, int(active)


def model_flops(cfg, shape):
    """6*N_active*D for training, 2*N_active*D for inference steps."""
    _, active = param_counts(cfg)
    tokens = shape["batch"] * (shape["seq"] if shape["kind"] != "decode"
                               else 1)
    mult = 6 if shape["kind"] == "train" else 2
    return mult * active * tokens


def analyze(rec, cfg, shape, target: TPUTarget = H100) -> dict:
    ex = rec.get("extrapolated") or {}
    flops = ex.get("flops_remat", ex.get("flops"))
    if not flops:
        return {"error": "no extrapolated costs"}
    if flops <= 0:
        # L2-L1 probe artifact: fall back to the analytic MODEL_FLOPS per
        # device (footnoted)
        flops = model_flops(cfg, shape) / rec.get("n_devices", N_DEVICES)
    t_compute = flops / target.peak_flops
    t_memory = ex["bytes"] / target.hbm_bw
    t_coll = ex["coll"] / target.ici_bw
    terms = {"compute": t_compute, "memory": t_memory,
             "collective": t_coll}
    dominant = max(terms, key=terms.get)
    mf = model_flops(cfg, shape)
    hlo_global = flops * rec.get("n_devices", N_DEVICES)
    useful = mf / hlo_global if hlo_global else 0.0
    bound = max(terms.values())
    # roofline fraction: useful model flops over the time the dominant
    # term pins us to, relative to pure-compute peak.  N_DEVICES stays
    # the reference's fixed 256 whatever the record's mesh (its quirk,
    # kept and pinned by the tests)
    t_model_ideal = mf / (N_DEVICES * target.peak_flops)
    frac = t_model_ideal / bound if bound else 0.0
    return {"t_compute_s": t_compute, "t_memory_s": t_memory,
            "t_collective_s": t_coll, "dominant": dominant,
            "model_flops": mf, "hlo_flops_global": hlo_global,
            "useful_ratio": useful, "roofline_fraction": frac,
            "step_time_bound_s": bound}


def load_and_analyze(dryrun_dir, target: TPUTarget = H100) -> list[dict]:
    from repro_torch import configs
    from repro_torch.configs.base import SHAPES
    out = []
    for f in sorted(pathlib.Path(dryrun_dir).glob("*__single.json")):
        rec = json.loads(f.read_text())
        if rec.get("status") != "OK":
            out.append({"arch": rec["arch"], "shape": rec["shape"],
                        "status": rec.get("status", "?")})
            continue
        cfg = configs.get(rec["arch"])
        row = {"arch": rec["arch"], "shape": rec["shape"], "status": "OK"}
        row.update(analyze(rec, cfg, SHAPES[rec["shape"]], target))
        out.append(row)
    return out


def to_markdown(rows) -> str:
    hdr = ("| arch | shape | compute (s) | memory (s) | collective (s) | "
           "dominant | MODEL_FLOPS | useful | roofline frac |\n"
           "|---|---|---|---|---|---|---|---|---|\n")
    lines = []
    for r in rows:
        if r.get("status") != "OK":
            lines.append(f"| {r['arch']} | {r['shape']} | — | — | — | "
                         f"{r.get('status','?')[:40]} | — | — | — |")
            continue
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['t_compute_s']:.4f} | "
            f"{r['t_memory_s']:.4f} | {r['t_collective_s']:.4f} | "
            f"**{r['dominant']}** | {r['model_flops']:.3g} | "
            f"{r['useful_ratio']:.2f} | {r['roofline_fraction']:.2f} |")
    return hdr + "\n".join(lines)
