#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card, end to end.

  python3 chip_smoke.py [--layers 8]

1. Print the card (nvidia-smi name and power limit) and build every CUDA
   kernel of the main path from ``src/repro_torch/kernels/csrc``.
2. Hold each kernel against its plain PyTorch version on the card, at the
   shapes the main path gives it (yi-9b full width, (16, 16) blocks, decode
   M = 4 and prefill M = 128, bf16 and fp32, reordered into 4 bins and not,
   bias with silu / relu / none), and time kernel, plain version, the one
   PyTorch call computing the same product (``torch.matmul`` on the
   masked dense weight, a yardstick the port never calls) and the bound.
3. Serve block-pruned yi-9b at full width (depth cut to ``--layers``):
   seeded init, magnitude block masks at rate 0.6, ``compile_model``,
   then greedy ``generate`` of 4 prompts of 32 tokens, counting kernel
   launches over exactly that run; time it warm, trace one prefill and one
   ``generate`` with ``torch.profiler`` for the card's busy share, and hold
   the packed prefill logits against the same weights run masked-dense,
   with planted faults showing that the bound catches a broken packed
   path.

No phase is caught: any failure exits non-zero.  The last two lines are
the kernels JSON and ``{"ok": true, "device": {...}}``.  Full detail goes
to ``build/chip_smoke.json`` (``build/`` is not versioned).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# H100 SXM published peaks (NVIDIA data sheet): HBM bytes/s, dense bf16
# tensor-core FLOP/s (the timed calls are bf16)
HBM_BYTES_PER_S = 3.35e12
BF16_PEAK_FLOPS = 989e12

# (name, K, N, epilogue activation) of the 7 projections of a yi-9b layer
D, DKV, DFF = 4096, 512, 11008
PROJECTIONS = [("wq", D, D, "none"), ("wk", D, DKV, "none"),
               ("wv", D, DKV, "none"), ("wo", D, D, "none"),
               ("gate", D, DFF, "silu"), ("up", D, DFF, "none"),
               ("down", DFF, D, "none")]
BLOCK = (16, 16)
PRUNE_RATE = 0.6
N_BINS = 4
FP32_TOL = 1e-4          # rtol = atol for fp32 outputs vs the plain version
# bf16 prefill logits, packed vs masked-dense on the card: the two round
# at different places (fused silu, fp32 sum order before each rounding).
# On an H100 the sound path reads about 0.008 on both and every fault of
# ``planted_faults`` 0.28 or more (PERF.md); the limits sit between.
LOGIT_MAX_REL = 0.05     # max |diff| <= this * max |dense logit|
LOGIT_MEAN_REL = 0.02    # mean |diff| <= this * mean |dense logit|
B, S, N_NEW = 4, 32, 16  # prompts, prompt length, new tokens


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def sync():
    torch.cuda.synchronize()


def time_ms(fn, iters, flush, graph=True):
    """Median milliseconds of ``fn`` by CUDA events, L2 flushed before
    each run (in the served model every projection's weights arrive cold:
    the other layers' weights pass through L2 in between).  With ``graph``
    the work is captured once in a CUDA graph and replayed, so the events
    time the device work alone; without it they also time the gaps in
    which the card waits for the host to send the next launch."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    run = fn
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            fn()
        run = g.replay
    events = []
    for _ in range(iters):
        flush.zero_()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        run()
        e.record()
        events.append((s, e))
    sync()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def bf16_ulp(p):
    """One bf16 ulp at the magnitude of each fp32 value."""
    _, e = torch.frexp(p.abs().clamp_min(2.0 ** -126))
    return torch.ldexp(torch.ones_like(p), (e - 8).to(torch.int32))


def weight_and_mask(RW, K, N, gen, dtype):
    w = (torch.randn(K, N, generator=gen, device="cuda") * K ** -0.5).to(
        dtype)
    spec = [(r"w$", RW.SchemeChoice("block", BLOCK))]
    mask = RW.magnitude_block_masks({"w": w}, spec, None,
                                    rate=PRUNE_RATE)["w"]
    return w, mask


def kernel_phase(mods, flush):
    """Kernel vs plain at every main-path shape; timings in bf16."""
    RW, ops, ref, K = mods["RW"], mods["ops"], mods["ref"], mods["K"]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    checks, max_err = 0, 0.0
    shapes = sorted({(k, n) for _, k, n, _ in PROJECTIONS})
    for dtype in (torch.float32, torch.bfloat16):
        for (Kd, Nd) in shapes:
            w, mask = weight_and_mask(RW, Kd, Nd, gen, dtype)
            plain_lay = ops.pack(w, mask, BLOCK)
            reord = ops.pack(w, mask, BLOCK, reorder=True, n_bins=N_BINS)
            for M in (4, 128):
                x = torch.randn(M, Kd, generator=gen, device="cuda").to(dtype)
                b = (torch.randn(Nd, generator=gen, device="cuda")
                     * 0.1).to(dtype)
                for act, bias in (("none", None), ("none", b), ("silu", b),
                                  ("relu", b)):
                    want = ref.bsr_matmul_packed_ref(
                        x.float(), reord,
                        None if bias is None else bias.float(), act)
                    y_re = K.bsr_matmul_packed(x, reord, bias, act)
                    y_un = K.bsr_matmul_packed(x, plain_lay, bias, act)
                    sync()
                    if not torch.equal(y_re, y_un):
                        raise AssertionError(
                            f"reordered != unreordered bitwise at K={Kd} "
                            f"N={Nd} M={M} {dtype} act={act}")
                    err = (y_re.float() - want).abs()
                    if dtype == torch.float32:
                        tol = FP32_TOL + FP32_TOL * want.abs()
                    else:    # 1 bf16 ulp, plus the fp32 bound near zero
                        tol = bf16_ulp(want) + FP32_TOL * (1 + want.abs())
                    bad = err > tol
                    if bad.any():
                        i = int(bad.flatten().nonzero()[0])
                        raise AssertionError(
                            f"kernel vs plain at K={Kd} N={Nd} M={M} "
                            f"{dtype} act={act} bias={bias is not None}: "
                            f"{int(bad.sum())} elements out of tolerance, "
                            f"first {err.flatten()[i].item()} > "
                            f"{tol.flatten()[i].item()}")
                    max_err = max(max_err, err.max().item())
                    checks += 1
            del w, mask, plain_lay, reord
    print(f"kernel vs plain: {checks} cases at {len(shapes)} (K, N) shapes, "
          f"M in (4, 128), bf16 + fp32, bias with none/silu/relu, "
          f"reordered == unreordered bitwise; max abs err {max_err:.3e}")

    rows = []
    for name, Kd, Nd, act in PROJECTIONS:
        w, mask = weight_and_mask(RW, Kd, Nd, gen, torch.bfloat16)
        lay = ops.pack(w, mask, BLOCK, reorder=True, n_bins=N_BINS)
        dense = w * mask.to(w.dtype)
        nnzb = int(lay.nnz.sum())
        for M in (4, 128):
            x = torch.randn(M, Kd, generator=gen, device="cuda").to(
                torch.bfloat16)
            ms = time_ms(lambda: K.bsr_matmul_packed(x, lay, None, act),
                         30, flush)
            eager_ms = time_ms(
                lambda: K.bsr_matmul_packed(x, lay, None, act), 30, flush,
                graph=False)
            plain_ms = time_ms(
                lambda: ref.bsr_matmul_packed_ref(x, lay, None, act), 3,
                flush)
            lib_ms = time_ms(lambda: torch.matmul(x, dense), 30, flush)
            es = 2
            nbytes = (nnzb * (BLOCK[0] * BLOCK[1] * es + 4)
                      + M * Kd * es + M * Nd * es)
            flops = 2 * M * nnzb * BLOCK[0] * BLOCK[1]
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = flops / BF16_PEAK_FLOPS * 1e3
            rows.append({
                "proj": name, "M": M, "K": Kd, "N": Nd, "act": act,
                "dtype": "bfloat16", "density": lay.density,
                "executed_frac": 1 - lay.flops_saved,
                "bins": lay.n_bins, "ms": ms, "eager_ms": eager_ms,
                "plain_ms": plain_ms,
                "library_ms": lib_ms, "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "bytes_ms": t_bytes, "ops_ms": t_ops, "bytes": nbytes,
                "flops": flops})
        del w, mask, lay, dense
    print("main-path timings (bf16, L2 flushed, median ms; device time "
          "by CUDA-graph replay, and the kernel's eager call for the host's "
          "share):")
    print(f"  {'proj':5s} {'M':>4s} {'kernel':>9s} {'eager':>9s} "
          f"{'bound':>9s} {'plain':>9s} {'matmul':>9s}  bound_by")
    for r in rows:
        print(f"  {r['proj']:5s} {r['M']:4d} {r['ms']:9.4f} "
              f"{r['eager_ms']:9.4f} {r['bound_ms']:9.4f} "
              f"{r['plain_ms']:9.4f} {r['library_ms']:9.4f}  "
              f"{r['bound_by']}")
    return rows, max_err


def logit_gap(dense, packed):
    """(max |diff| / max |dense|, mean |diff| / mean |dense|) of two logit
    tensors."""
    d, s = dense.float(), packed.float()
    diff = (d - s).abs()
    return (diff.max().item() / d.abs().max().item(),
            diff.mean().item() / d.abs().mean().item())


def within_bound(gap):
    return gap[0] <= LOGIT_MAX_REL and gap[1] <= LOGIT_MEAN_REL


def with_layout(params, group, name, layout):
    """``params`` with the packed layout of one projection replaced (the
    other leaves shared, not copied)."""
    layers = dict(params["layers"])
    layers[group] = dict(layers[group])
    layers[group][name] = dict(layers[group][name], packed=layout)
    return dict(params, layers=layers)


def planted_faults(params):
    """(name, params) pairs, each the compiled model with one fault a broken
    packer or launch loop could make."""
    down = params["layers"]["ffn"]["down"]["packed"]
    wo = params["layers"]["attn"]["wo"]["packed"]
    no_last = down.values[:-1] + (torch.zeros_like(down.values[-1]),)
    first_only = down.values[-1].clone()
    first_only[0] = 0
    perm = wo.perm.clone()
    perm[:, [0, 1]] = perm[:, [1, 0]]
    return [
        ("down: last bin dropped, every layer",
         with_layout(params, "ffn", "down",
                     dataclasses.replace(down, values=no_last))),
        ("down: last bin dropped, layer 0 only",
         with_layout(params, "ffn", "down", dataclasses.replace(
             down, values=down.values[:-1] + (first_only,)))),
        ("wo: two block columns swapped, every layer",
         with_layout(params, "attn", "wo",
                     dataclasses.replace(wo, perm=perm))),
    ]


def device_time(fn):
    """Trace ``fn`` with ``torch.profiler``: the card's busy milliseconds
    (union of the intervals of every kernel and copy it ran), the share of
    them in ``bsr_matmul`` kernels, and the number of device events; None
    when the profiler saw no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        sync()
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    if not spans:
        return None
    busy, lo, hi = 0.0, spans[0][0], spans[0][1]
    for a, b, _ in spans[1:]:
        if a > hi:
            busy += hi - lo
            lo = a
        hi = max(hi, b)
    busy += hi - lo
    bsr = sum(b - a for a, b, n in spans if "bsr_matmul" in n)
    return {"busy_ms": busy / 1e3, "bsr_ms": bsr / 1e3,
            "events": len(spans)}


def serve_phase(mods, args):
    """Full-width yi-9b through the port's entry points."""
    T, RW, C, E, K = mods["T"], mods["RW"], mods["C"], mods["E"], mods["K"]
    from repro_torch import configs
    from repro_torch.launch.serve import SPARSE_SPEC
    from repro_torch.train.trainer import apply_masks
    full = configs.get("yi-9b")
    cfg = full.replace(n_layers=args.layers)
    print(f"yi-9b at full width (d_model {cfg.d_model}, heads {cfg.n_heads}"
          f"/{cfg.n_kv_heads}, d_ff {cfg.d_ff}, vocab {cfg.vocab}); depth "
          f"cut to {cfg.n_layers} of {full.n_layers} layers")
    t0 = time.perf_counter()
    params = T.init_lm(cfg, seed=0, device="cuda")
    masks = RW.magnitude_block_masks(params, SPARSE_SPEC, None,
                                     rate=PRUNE_RATE)
    pm = apply_masks(params, masks)
    del params
    sync()
    init_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    exec_p, report = C.compile_model(
        pm, masks, SPARSE_SPEC, spec=C.CompileSpec(keep_dense=False),
        device="cuda")
    sync()
    compile_s = time.perf_counter() - t0
    del masks
    print(f"init + masks {init_s:.2f}s; compile_model {compile_s:.2f}s:")
    print(C.compiled_summary(report))
    layer = exec_p["layers"]
    n_bins = {layer[g][n]["packed"].n_bins
              for g, names in (("attn", ("wq", "wk", "wv", "wo")),
                               ("ffn", ("gate", "up", "down")))
              for n in names}
    if len(report.packed) != 7 or n_bins != {N_BINS}:
        raise AssertionError(f"expected 7 packed projections of {N_BINS} "
                             f"bins, got {len(report.packed)}, {n_bins}")

    prompts = np.random.RandomState(0).randint(0, cfg.vocab, size=(B, S))
    tokens = torch.as_tensor(prompts, device="cuda")

    # the main path, counted: counts to 0 just before, read just after
    K.reset_launches()
    sync()
    t0 = time.perf_counter()
    with torch.no_grad():
        out = E.generate(exec_p, cfg, prompts, N_NEW, device="cuda")
    sync()
    gen_s = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    want = cfg.n_layers * 7 * N_BINS * (1 + N_NEW)
    print(f"generate {tuple(out.shape)}: bsr_matmul launches "
          f"{launches['bsr_matmul']} (expected layers {cfg.n_layers} x 7 "
          f"projections x {N_BINS} bins x (1 + {N_NEW}) forwards = {want})")
    if launches["bsr_matmul"] != want:
        raise AssertionError("the main path did not go through the kernel "
                             "the expected number of times")
    if tuple(out.shape) != (B, N_NEW) or not (
            (out >= 0) & (out < cfg.vocab)).all():
        raise AssertionError(f"bad generate output {out}")

    with torch.no_grad():
        for _ in range(2):
            E.prefill(exec_p, cfg, tokens)
        sync()
        t0 = time.perf_counter()
        E.prefill(exec_p, cfg, tokens)
        sync()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        E.generate(exec_p, cfg, prompts, N_NEW, device="cuda")
        sync()
        gen_warm_s = time.perf_counter() - t0
        dev_prefill = device_time(lambda: E.prefill(exec_p, cfg, tokens))
        dev_gen = device_time(lambda: E.generate(exec_p, cfg, prompts, N_NEW,
                                                 device="cuda"))
    decode_ms = (gen_warm_s * 1e3 - prefill_ms) / N_NEW
    e2e = {"layers": cfg.n_layers, "of_layers": full.n_layers, "batch": B,
           "prompt": S, "new_tokens": N_NEW, "compile_s": compile_s,
           "first_generate_s": gen_s, "generate_s": gen_warm_s,
           "prefill_ms": prefill_ms, "decode_ms_per_token": decode_ms,
           "tok_per_s": B * N_NEW / gen_warm_s, "launches": launches,
           "sample": out[0].tolist()}
    print(f"prefill {prefill_ms:.2f} ms (B {B} x {S}); decode "
          f"{decode_ms:.3f} ms/token step; generate {gen_warm_s:.3f}s = "
          f"{e2e['tok_per_s']:.1f} tok/s (warm; first call {gen_s:.3f}s)")
    print("sample:", out[0].tolist())
    if dev_prefill is None or dev_gen is None:
        print("device busy share: not measured (the profiler saw no "
              "device activity)")
    else:
        step_busy = (dev_gen["busy_ms"] - dev_prefill["busy_ms"]) / N_NEW
        step_bsr = (dev_gen["bsr_ms"] - dev_prefill["bsr_ms"]) / N_NEW
        e2e["device"] = {
            "prefill": dev_prefill, "generate": dev_gen,
            "prefill_busy_share": dev_prefill["busy_ms"] / prefill_ms,
            "decode_step_busy_ms": step_busy,
            "decode_step_bsr_ms": step_bsr,
            "decode_busy_share": step_busy / decode_ms}
        print(f"device busy (torch.profiler, against the unprofiled wall "
              f"times above): prefill {dev_prefill['busy_ms']:.3f} ms "
              f"({dev_prefill['bsr_ms']:.3f} in bsr_matmul) = "
              f"{e2e['device']['prefill_busy_share']:.3f} of its wall time; "
              f"decode step {step_busy:.3f} ms ({step_bsr:.3f} in "
              f"bsr_matmul) = {e2e['device']['decode_busy_share']:.3f}; "
              f"{dev_gen['events']} device events per generate")

    with torch.no_grad():
        dense_logits, _ = E.prefill(pm, cfg, tokens)
        sparse_logits, _ = E.prefill(exec_p, cfg, tokens)
        gap = logit_gap(dense_logits, sparse_logits)
        faults = [(name, logit_gap(dense_logits, E.prefill(p, cfg,
                                                          tokens)[0]))
                  for name, p in planted_faults(exec_p)]
    sync()
    d, s = dense_logits.float(), sparse_logits.float()
    print(f"prefill logits packed vs masked-dense (bf16): max|diff| "
          f"{gap[0]:.4f} of max|logit|, mean |diff| {gap[1]:.4f} of mean "
          f"|logit| (bound {LOGIT_MAX_REL} / {LOGIT_MEAN_REL}); argmax "
          f"agree {(d.argmax(-1) == s.argmax(-1)).float().mean():.2f}")
    for name, g in faults:
        print(f"  planted fault, {name}: {g[0]:.4f} / {g[1]:.4f}"
              f"{'' if not within_bound(g) else '  (NOT CAUGHT)'}")
    e2e["logits_gap"] = gap
    e2e["planted_faults"] = dict(faults)
    if not (torch.isfinite(s).all() and within_bound(gap)):
        raise AssertionError("packed prefill logits disagree with the "
                             "masked-dense ones beyond the stated bound")
    missed = [name for name, g in faults if within_bound(g)]
    if missed:
        raise AssertionError(f"the logit bound does not catch: {missed}")
    return e2e, launches


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=8,
                    help="depth cut of yi-9b (width is never cut)")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is "
              "False); this script runs only on the card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.core import reweighted as RW
        from repro_torch.kernels import _build, ops, ref
        from repro_torch.kernels import bsr_matmul as K
        from repro_torch.models import transformer as T
        from repro_torch.serve import compile as C
        from repro_torch.serve import engine as E
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 2
    mods = dict(RW=RW, ops=ops, ref=ref, K=K, T=T, C=C, E=E)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = smi_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    _build.load("bsr_matmul")
    info = _build.BUILD_INFO["bsr_matmul"]
    print(f"built bsr_matmul.cu for sm_90a in {time.perf_counter() - t0:.2f}s"
          f" (nvcc {info['seconds']:.2f}s)")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())

    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    rows, max_err = kernel_phase(mods, flush)
    del flush
    torch.cuda.empty_cache()
    e2e, launches = serve_phase(mods, args)

    decode_rows = [r for r in rows if r["M"] == 4]
    t_bytes = sum(r["bytes_ms"] for r in decode_rows)
    t_ops = sum(r["ops_ms"] for r in decode_rows)
    entry = {
        "name": "bsr_matmul", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/bsr_matmul.cu",
        "replaces": "src/repro/kernels/bsr_matmul.py:143",
        "launches": launches["bsr_matmul"], "max_abs_err": max_err,
        # one decode step's 7 projections of one layer (M = 4), summed
        "ms": sum(r["ms"] for r in decode_rows),
        "plain_ms": sum(r["plain_ms"] for r in decode_rows),
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": sum(r["library_ms"] for r in decode_rows),
        "measured_at": "sum over one yi-9b layer's 7 projections at decode "
                       "M=4, bf16, (16,16) blocks, rate 0.6, 4 bins",
    }
    out_dir = ROOT / "build"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "torch": torch.__version__,
         "cuda": torch.version.cuda, "build": info["seconds"],
         "ptxas": info["log"], "kernels": [dict(entry, shapes=rows)],
         "serve": e2e},
        indent=1))
    print(f"card: {card}")
    print(json.dumps({"kernels": [entry]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
