"""Arithmetic on the port's own spans (``repro_torch.serve.trace``), read
over the untraced window of a run.

The port records its spans in a ring in the run's process.  A reader takes
those that start at or after the window's opening and end by its close
(so neither set-up nor a traced slice after the window), and returns None
where there is nothing to read: a program without the recorder, a
recorder switched off, or a ring that dropped a span which may have
started inside the window.  Walls are in ms."""
from __future__ import annotations

import numpy as np


def held():
    """(the port's spans, the count its ring dropped), or None where the
    program has no recorder."""
    try:
        from repro_torch.serve import trace
    except ImportError:
        return None
    return trace.spans()


def within(spans, dropped, t0, t1):
    """The closed spans of ``spans`` (oldest first) inside [t0, t1], or
    None if the ring may have dropped one of them: it drops the oldest
    first, so a drop reaches the window only where the oldest span held
    starts inside it."""
    if dropped and (not spans or spans[0].t0 >= t0):
        return None
    return [s for s in spans if s.t1 is not None and s.t0 >= t0
            and s.t1 <= t1]


def window(run):
    rec = held()
    if rec is None:
        return None
    return within(*rec, run.t_open, run.t_open + run.window)


def wall_ms(s):
    return (s.t1 - s.t0) * 1e3


def named(spans, name):
    return [s for s in spans if s.name == name]


def admit_ms(run):
    """Mean ``engine.admit`` wall per admitted request."""
    spans = window(run)
    admits = named(spans or [], "engine.admit")
    return float(np.mean([wall_ms(s) for s in admits])) if admits else None


def first_token_ms(run):
    """Mean ``admit.first_token`` wall per admitted request: the host
    blocked until the prefill's kernels finish."""
    spans = window(run)
    admits = named(spans or [], "engine.admit")
    if not admits:
        return None
    return sum(wall_ms(s) for s in named(spans, "admit.first_token")) / len(
        admits)


def launches_per_admit(run):
    """Kernel-1 launches over the ``engine.admit`` spans, per admission."""
    admits = named(window(run) or [], "engine.admit")
    return sum(s.launches for s in admits) / len(admits) if admits else None


def decode_steps(spans):
    """(``engine.step`` wall, ``graph_ms``) of each decode-only step (one
    that decoded and admitted nothing) whose replay was timed on the
    card."""
    steps = {s.index: s for s in named(spans, "engine.step")
             if s.attrs.get("active") and not s.attrs.get("admitted")}
    out = []
    for r in named(spans, "engine.replay"):
        g = r.attrs.get("graph_ms")
        if r.parent in steps and g is not None:
            out.append((wall_ms(steps[r.parent]), g))
    return out


def graph_ms(run):
    """Median ``graph_ms`` of the decode-only steps."""
    steps = decode_steps(window(run) or [])
    return float(np.median([g for _, g in steps])) if steps else None


def step_host_ms(run):
    """Median over the decode-only steps of the step's wall less its
    ``graph_ms``: the time in ``step()`` the card does not run the step's
    graph."""
    steps = decode_steps(window(run) or [])
    return float(np.median([w - g for w, g in steps])) if steps else None
