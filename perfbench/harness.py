"""One run of one cell: set-up, the measured window, the check, the result.

Set-up draws the weights and masks from the seed (``weights``), packs them
with the port's ``serve.compile.compile_model(keep_dense=False)``, builds
the port's ``serve.engine.ServingEngine`` (which captures its decode step
as a CUDA graph), admits one request at the mix's longest prompt through
the engine and runs one prefill at its shortest.  The port builds its
kernels once (nvcc) and compiles nothing per shape, so a prompt length
set-up did not see costs the window no more than one it did.

The window drives the engine through its public ``submit`` and ``step``
for ``--seconds`` seconds, from one thread, untraced, keeping the engine's
queue filled from the mix's backlog, so a slot is refilled the step it
frees; a ``--trace 1`` run then profiles a short slice after it
(``drive``), so that the window's host clock reads nothing the profiler
slowed.  Each step ends in a host sync (the engine reads its tokens back),
so the host clock after ``step`` is when its tokens exist.

Then the peak memory is read, the program's state freed, the weights
drawn again from the seed, and the plain reference run over a sample of
the finished requests (``check``).
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import subprocess
import sys
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from perfbench import check, costs, draw, spec, weights

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
FAILED = ("rejected", "expired", "evicted", "quarantined")


@dataclass
class Req:
    prompt_len: int
    max_new: int
    rid: int = -1
    times: list = field(default_factory=list)   # host clock of each token


@dataclass
class Step:
    t0: float
    t1: float
    active: int                 # slots the decode step ran for
    admitted: list              # prompt lengths admitted, in order
    rings: list                 # ring lengths of the slots decoded
    launches: int               # kernel-1 launches counted by the port


class Run:
    """What a run recorded; the metric readers read it."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    def decode_only(self):
        """Window steps that decoded and admitted nothing."""
        return [s for s in self.steps if not s.admitted and s.active]

    def admitting(self):
        return [s for s in self.steps if s.admitted]


def arch_config(conf):
    """The port's ``ArchConfig`` of the configuration file's ``model``."""
    from repro_torch.configs.base import ArchConfig
    m = conf["model"]
    E = m.get("num_local_experts", 0)
    return ArchConfig(
        name=conf["name"], family="moe" if E else "dense",
        n_layers=m["num_hidden_layers"], d_model=m["hidden_size"],
        n_heads=m["num_attention_heads"],
        n_kv_heads=m["num_key_value_heads"], d_ff=m["intermediate_size"],
        vocab=m["vocab_size"], head_dim=m["head_dim"], n_experts=E,
        top_k=m.get("num_experts_per_tok", 0),
        moe_group=m.get("moe_group", 1024),
        sliding_window=m.get("sliding_window") or 0,
        rope_theta=float(m["rope_theta"]), remat="none")


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def build(conf, seed, dev, value_dtype=None):
    """(exec params, live block counts, compile seconds)."""
    from repro_torch.core.reweighted import SchemeChoice
    from repro_torch.serve.compile import CompileSpec, compile_model
    params, masks, live = weights.draw(conf, seed, dev)
    sch = conf["scheme"]
    mapping = [(sch["targets"], SchemeChoice("block", tuple(sch["block"])))]
    sync(dev)
    t0 = time.perf_counter()
    exec_p, _ = compile_model(params, masks, mapping, device=dev,
                              spec=CompileSpec(keep_dense=False,
                                               value_dtype=value_dtype))
    sync(dev)
    return exec_p, live, time.perf_counter() - t0


def warm(eng, exec_p, cfg, mix, dev, rng):
    """One admission at the longest prompt through the engine (its decode
    step too), then one prefill at the shortest."""
    from repro_torch.serve.engine import prefill
    lens = draw.shapes(mix["prompt"], int(mix["block"]))
    eng.submit(rng.integers(0, cfg.vocab, lens[-1]).tolist(), 2)
    while eng.sched.has_work():
        eng.step()
    with torch.no_grad():
        toks = torch.as_tensor(rng.integers(0, cfg.vocab, (1, lens[0])),
                               dtype=torch.int32, device=dev)
        prefill(exec_p, cfg, toks)
    sync(dev)


class _Mark:
    """A ``record_function`` mark while tracing, nothing otherwise."""

    def __init__(self):
        self.on = False

    def __call__(self, name):
        if not self.on:
            return contextlib.nullcontext()
        return torch.profiler.record_function("perfbench." + name)


def drive(eng, reqs, seconds, dev, profile=False):
    """Serve the backlog ``reqs`` for ``seconds``, the engine's queue kept
    filled.  Returns (steps, records, opening time, window seconds,
    trace): the window runs from its opening to the end of the step that
    was running at its close.

    The window runs untraced.  With ``profile`` this is the traced slice
    that follows it: the profiler starts before the slice opens (its
    first start sets up the device tracer, which takes seconds, and a
    profiler once started leaves the host slower, so the window never
    sees one), and the slice serves the next requests as the window
    did."""
    from repro_torch.kernels import bsr_matmul as K
    mark = _Mark()
    prof = win = tr = None
    if profile:
        prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
        prof.start()
        win = torch.profiler.record_function("perfbench.window")
        win.__enter__()
        mark.on = True
    recs = [Req(len(r.prompt), r.max_new) for r in reqs]
    live, nxt, steps = {}, 0, []
    n_slots = eng.n_slots
    t_open = time.perf_counter()
    close = t_open + seconds
    while True:
        now = time.perf_counter()
        if now >= close:
            window = max(now, steps[-1].t1 if steps else now) - t_open
            break
        with mark("submit"):
            while nxt < len(reqs) and eng.sched.queued() < n_slots:
                rec = recs[nxt]
                rec.rid = eng.submit(reqs[nxt].prompt.tolist(),
                                     reqs[nxt].max_new)
                live[rec.rid] = rec
                nxt += 1
        if not eng.sched.has_work():          # the backlog ran out
            time.sleep(max(0.0, close - now))
            continue
        i = len(steps)
        l0 = K.LAUNCHES["bsr_matmul"]
        with mark(f"step#{i}"):
            t0 = time.perf_counter()
            active = eng.step()
            t1 = time.perf_counter()
        admitted, rings = [], []
        for rid in list(live):
            rec = live[rid]
            req = eng.requests[rid]
            old, new = len(rec.times), len(req.tokens)
            if new > old:
                if old == 0:
                    admitted.append(rec.prompt_len)
                if new - old - (old == 0) > 0:
                    rings.append(rec.prompt_len)
                rec.times.extend([t1] * (new - old))
            if req.status not in ("queued", "running", "deferred"):
                del live[rid]
        steps.append(Step(t0, t1, active, admitted, rings,
                          K.LAUNCHES["bsr_matmul"] - l0))
    if prof is not None:
        sync(dev)
        win.__exit__(None, None, None)
        prof.stop()
        from perfbench import trace_read
        tr = trace_read.read(prof)
    return steps, recs[:nxt], t_open, window, tr


def device_info(dev, chips):
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev))}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
             "-i", str(dev.index or 0)], capture_output=True, text=True,
            timeout=20)
        info["power_limit"] = out.stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        info["power_limit"] = "not read"
    return info


def run_cell(bench, cell_name, seed, seconds, trace, *, t_start=None,
             device="cuda", conf=None, mix=None, value_dtype=None,
             tamper=None):
    """One run of ``cell_name``.  Returns (the result line's dict, the
    ``Run``).  ``conf`` / ``mix`` replace the files' (tests);
    ``value_dtype`` packs the int8 control; ``tamper(engine)`` breaks the
    timed path (``perfbench.faults``)."""
    t_start = time.perf_counter() if t_start is None else t_start
    cell = bench.cell(cell_name)
    conf = conf or bench.config(cell["config"])
    mix = mix or bench.mix(cell["traffic"])
    gen = bench.generator(mix["kind"])
    dev = torch.device(device)
    from repro_torch.serve.engine import ServingEngine
    cfg = arch_config(conf)
    reqs = gen.requests(mix, seed, cfg.vocab)
    exec_p, live, compile_s = build(conf, seed, dev, value_dtype)
    model = costs.Model(conf["model"], live)
    seq_cap = max(draw.shapes(mix["prompt"], int(mix["block"])))
    eng = ServingEngine(exec_p, cfg, n_slots=int(mix["n_slots"]),
                        seq_cap=seq_cap, device=dev)
    warm(eng, exec_p, cfg, mix, dev, np.random.default_rng(seed + 1))
    if tamper is not None:
        tamper(eng)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.perf_counter() - t_start
    steps, recs, t_open, window, _ = drive(eng, reqs, seconds, dev)
    sync(dev)
    t_closed = time.perf_counter()
    tr = slice_steps = None
    if trace:
        slice_steps, _, _, _, tr = drive(
            eng, reqs[len(recs):], float(mix.get("trace_seconds", 2.0)),
            dev, profile=True)
    dev_info = device_info(dev, int(cell["chips"]))
    statuses = {rec.rid: eng.requests[rec.rid].status for rec in recs}
    served = {rec.rid: list(eng.requests[rec.rid].tokens) for rec in recs
              if statuses[rec.rid] == "finished"}
    prompts = {rec.rid: reqs[i].prompt for i, rec in enumerate(recs)}
    del eng, exec_p
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    run = Run(cell=cell, conf=conf, mix=mix, seconds=seconds,
              setup_s=setup_s, compile_s=compile_s, window=window,
              steps=steps, recs=recs, model=model, trace=None,
              t_open=t_open, slice_steps=slice_steps)
    if tr is not None:
        from perfbench import trace_read
        run.trace = trace_read.summarize(tr)
    t_read = time.perf_counter()
    # the backlog still queued at the close was never attempted
    recs = [rec for rec in recs if rec.times]
    failed = sum(1 for rec in recs if statuses[rec.rid] in FAILED)
    verdict = check.run(bench, conf, seed, dev, served, prompts,
                        int(mix.get("check_requests", 6)))
    run.gaps = verdict["gaps"]
    t_checked = time.perf_counter()
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in bench.metrics(cell_name, kind):
        v = bench.reader(m["name"], kind).read(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    if trace and run.trace is not None:
        dev_info["busy_s"] = run.trace["busy_s"]
        dev_info["window_s"] = run.trace["window_s"]
    result = {"correct": verdict["correct"], "attempted": len(recs),
              "failed": failed, "metrics": metrics, "device": dev_info}
    if trace and run.trace is not None:
        result["breakdown"] = run.trace["breakdown"]
    result["phases_s"] = {"setup": setup_s, "window": window,
                          "trace": t_read - t_closed,
                          "check": t_checked - t_read}
    result["sample"] = verdict["sample"]
    result["check"] = verdict["numbers"]
    return result, run


def loaded_forbidden():
    return sorted({name.split(".")[0] for name in sys.modules
                   if name.split(".")[0] in FORBIDDEN})


def main(argv, t_start):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = spec.Bench()
    cell = bench.cell(args.workload)
    if not torch.cuda.is_available():
        print("perfbench: no CUDA device; a run needs the card",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < int(cell["chips"]):
        print(f"perfbench: {args.workload} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    result, _ = run_cell(bench, args.workload, args.seed, args.seconds,
                         args.trace, t_start=t_start, device="cuda:0")
    bad = loaded_forbidden()
    if bad:
        print(f"perfbench: modules loaded in the run's process: {bad}",
              file=sys.stderr)
        return 3
    for name, num in result["check"].items():
        print(f"check {name} {num['value']!r} limit {num['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0
