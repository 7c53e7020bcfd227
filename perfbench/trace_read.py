"""Reading a ``torch.profiler`` trace of a slice of the window.

The harness marks the slice (``perfbench.window``) and each engine step
(``perfbench.step#<i>``) and each submission (``perfbench.submit``) with
``record_function``.  The
device's busy time is the union of the intervals of every kernel, copy and
set it ran inside the slice (the arithmetic of ``device_time`` in the
repository's ``chip_smoke.py``).

A step's device work splits at its ``cudaGraphLaunch``: the admission's
prefill ends in a host sync (its first token's argmax), so every kernel
that starts before the launch is the admission's, and every kernel from it
to the step's end the captured decode step's.
"""
from __future__ import annotations

from collections import defaultdict

PREFIX = "perfbench."
K1 = "bsr_matmul_kernel"


def _merge(spans):
    """Sorted (start, end) pairs -> disjoint merged intervals."""
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _events(prof):
    """(name, is a device event, start us, end us) of every event of the
    stopped profiler, read from the raw kineto results: ``prof.events()``
    would build a tree of every host operation first, which takes tens of
    seconds for a slice of eager prefills."""
    from torch.autograd import DeviceType
    res = prof.profiler.kineto_results
    t0 = res.trace_start_ns()
    for e in res.events():
        a = e.start_ns() - t0
        yield (e.name(), e.device_type() == DeviceType.CUDA, a / 1e3,
               (a + e.duration_ns()) / 1e3)


def read(prof):
    """The slice as plain lists (times in microseconds): ``window`` (start,
    end), ``host`` [(name, start, end)] of the harness's marks,
    ``launches`` [start] of ``cudaGraphLaunch`` calls, ``device`` [(name,
    start, end)] of the device's operations, clipped to the window."""
    w0 = w1 = None
    host, launches, device = [], [], []
    for name, on_device, a, b in _events(prof):
        if on_device:
            if not name.startswith(PREFIX):
                device.append((name, a, b))
        elif name == PREFIX + "window":
            w0, w1 = a, b
        elif name.startswith(PREFIX):
            host.append((name[len(PREFIX):], a, b))
        elif name == "cudaGraphLaunch":
            launches.append(a)
    if w0 is None:
        return None
    device = [(n, max(a, w0), min(b, w1)) for n, a, b in device
              if b > w0 and a < w1]
    return {"window": (w0, w1), "host": host, "launches": sorted(launches),
            "device": device}


def summarize(tr):
    """busy and window seconds, per-step kernel-1 times split into the
    admission and the decode step, the ``breakdown`` (device operations by
    time, idle gaps by the harness's mark open at the time)."""
    w0, w1 = tr["window"]
    busy = _merge((a, b) for _, a, b in tr["device"])
    busy_us = sum(b - a for a, b in busy)
    steps = sorted((n, a, b) for n, a, b in tr["host"]
                   if n.startswith("step#"))
    launches = tr["launches"]
    # each step's [start, graph launch, end]; no launch: all admission
    cuts = []
    for name, a, b in steps:
        g = next((t for t in launches if a <= t <= b), b)
        cuts.append((int(name[5:]), a, g, b))
    k1 = sorted((a, b) for n, a, b in tr["device"] if K1 in n)
    per_step = {}
    j = 0
    for i, a, g, b in sorted(cuts, key=lambda c: c[1]):
        adm, dec = [], []
        while j < len(k1) and k1[j][0] < a:
            j += 1
        while j < len(k1) and k1[j][0] <= b:
            (adm if k1[j][0] < g else dec).append(k1[j][1] - k1[j][0])
            j += 1
        per_step[i] = {"admit_us": adm, "decode_us": dec}
    ops = defaultdict(float)
    for n, a, b in tr["device"]:
        ops[n] += (b - a) / 1e6
    gaps = []
    edge = w0
    for a, b in busy + [[w1, w1]]:
        if a > edge:
            gaps.append((edge, a))
        edge = max(edge, b)
    named = []
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:10]:
        mid = (a + b) / 2
        what = "harness"
        for n, s0, s1 in tr["host"]:
            if s0 <= mid <= s1 and n != "window":
                what = n.split("#")[0]
                if what == "step":
                    g = next((c[2] for c in cuts if c[1] <= mid <= c[3]), s1)
                    what = "admit" if mid < g else "step"
                break
        named.append([what, (b - a) / 1e6])
    return {
        "busy_s": busy_us / 1e6, "window_s": (w1 - w0) / 1e6,
        "per_step": per_step,
        "breakdown": {
            "device_ops": [[n, s] for n, s in sorted(
                ops.items(), key=lambda kv: -kv[1])[:10]],
            "idle_gaps": named}}
