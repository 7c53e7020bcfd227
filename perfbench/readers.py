"""Arithmetic the metric readers share.  A reader returns None where its
run has nothing to read, and the harness then leaves the metric out."""
from __future__ import annotations

import numpy as np

from perfbench.costs import PEAK_FLOPS


def wall(s):
    return s.t1 - s.t0


def base_step_s(run):
    """The median decode-only step: what an admitting step would have
    taken without its admissions."""
    steps = run.decode_only()
    return float(np.median([wall(s) for s in steps])) if steps else None


def admissions(run):
    """(seconds the admitting steps spent beyond a decode step, requests
    admitted, their prompt lengths)."""
    base = base_step_s(run)
    steps = run.admitting()
    if base is None or not steps:
        return None
    extra = sum(wall(s) - (base if s.rings else 0.0) for s in steps)
    lens = [p for s in steps for p in s.admitted]
    return extra, len(lens), lens


def admit_ms(run):
    a = admissions(run)
    return None if a is None else a[0] / a[1] * 1e3


def mfu(flops, seconds):
    return 100.0 * flops / (seconds * PEAK_FLOPS) if seconds > 0 else None


def k1_roofline(run, phase):
    """Kernel 1's bound over its traced time in ``phase`` ("decode": the
    captured steps, rows = the live slots the step ran; "admit": the
    admissions' prefills, rows = each prompt), in %.  A step whose launch
    count is not the model's is left out."""
    tr = run.trace
    if tr is None:
        return None
    per_layer = len(run.model.projections()) * run.model.n
    bound = seconds = 0.0
    for i, rec in tr["per_step"].items():
        s = run.slice_steps[i]
        if phase == "decode":
            times, want = rec["decode_us"], per_layer if s.active else 0
            b = run.model.k1_bound(s.active) if s.active else 0.0
        else:
            times, want = rec["admit_us"], per_layer * len(s.admitted)
            b = sum(run.model.k1_bound(p) for p in s.admitted)
        if not want or len(times) != want:
            continue
        bound += b
        seconds += sum(times) / 1e6
    return 100.0 * bound / seconds if seconds > 0 else None


def idle_share(run):
    tr = run.trace
    if tr is None or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
