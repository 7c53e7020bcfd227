"""Serving CLI: seeded init -> one-shot block masks -> compile_model
(BCS packing) -> greedy generate, on the card.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-9b --sparse \\
      --layers 8
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-1.3b \\
      --sparse

With ``--batch-size`` / ``--arrival-rate`` the continuous-batching engine
replaces the one-shot ``generate``: ``--requests`` prompts of three
lengths arrive at ``--arrival-rate`` a step (default: all at step 0) and
stream through ``serve.engine.ServingEngine``, with a log line every
``--log-every`` steps (occupancy, admitted / evicted / queued, tokens):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-9b --sparse \\
      --layers 8 --batch-size 8 --arrival-rate 1 --requests 16

``--artifacts DIR`` (with ``--sparse``) turns on INFO logging and gives
``compile_model`` the artifact store: the first run packs and publishes,
a later run on the same weights, masks and spec loads the packed layouts
from DIR (checksummed and validated) instead of packing:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-9b --sparse \\
      --layers 8 --artifacts /path/to/store

encdec and vlm models (seamless-m4t-large-v2, llama-3.2-vision-90b) are
served by ``generate`` with the data pipeline's seeded frontend
embeddings; the engine serves the decoder-only families.  ``--layers``
cuts depth only, never width (vlm: whole groups of
``cross_attn_interval`` layers).  ``--smoke`` takes the reduced
test config instead of the published one; ``--device cpu`` runs the plain
PyTorch versions of the kernels (for small configs).
"""
from __future__ import annotations

import argparse
import logging
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.core import reweighted as RW
from repro_torch.data.pipeline import synthetic_batch
from repro_torch.models import transformer as T
from repro_torch.serve.compile import (CompileSpec, compile_model,
                                       compiled_summary)
from repro_torch.serve.engine import ServingEngine, generate
from repro_torch.train.trainer import apply_masks

SPARSE_SPEC = [(r"(attn/w[qkvo]|(ffn|moe)/(gate|up|down))/w",
                RW.SchemeChoice("block", (16, 16))),
               # the SSM in/out projections, as the reference's spec: the
               # narrower (16, 8) block tiles SMOKE mamba2's in_proj
               # (proj dim 296 = 37 x 8)
               (r"ssm/(in_proj|out_proj)/w",
                RW.SchemeChoice("block", (16, 8)))]


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-9b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut depth to this many layers (0 = all)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--sparse", action="store_true",
                    help="block-prune, compile to BCS, serve on the sparse "
                         "kernel")
    ap.add_argument("--prune-rate", type=float, default=0.6)
    ap.add_argument("--artifacts", default=None, metavar="DIR",
                    help="artifact store: load the packed layouts from DIR "
                         "when the model digest matches (checksummed and "
                         "validated), else pack and publish them there")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch-size", type=int, default=0, metavar="SLOTS",
                    help="continuous-batching engine slot count; > 0 "
                         "switches from one-shot generate to the "
                         "ServingEngine workload")
    ap.add_argument("--arrival-rate", type=float, default=0.0,
                    help="open-loop arrivals per engine step (default: "
                         "saturate, everything arrives at step 0); implies "
                         "the engine path")
    ap.add_argument("--requests", type=int, default=16,
                    help="engine path: number of requests")
    ap.add_argument("--seq-cap", type=int, default=128,
                    help="engine path: per-slot KV ring capacity")
    ap.add_argument("--log-every", type=int, default=8,
                    help="engine path: steps between log lines")
    args = ap.parse_args(argv)

    if args.artifacts:
        # show the store's warm-start / fallback reasons
        logging.basicConfig(level=logging.INFO)
    cfg = configs.get(args.arch, smoke=args.smoke)
    if args.layers:
        cfg = cfg.replace(n_layers=args.layers)
    params = T.init_lm(cfg, seed=0, device=args.device)
    prompts = np.random.RandomState(0).randint(
        0, cfg.vocab, size=(args.batch, args.prompt_len))
    frontend = None
    if cfg.family in ("encdec", "vlm"):
        # encdec's audio frames and vlm's image patches: the data
        # pipeline's seeded stand-in embeddings
        frontend = synthetic_batch(
            0, 0, args.batch, args.prompt_len, cfg.vocab,
            frontend_tokens=cfg.n_frontend_tokens, d_model=cfg.d_model,
            device=args.device)["frontend"]
    if args.sparse:
        masks = RW.magnitude_block_masks(params, SPARSE_SPEC, None,
                                         rate=args.prune_rate)
        params = apply_masks(params, masks)
        _sync(args.device)
        t0 = time.perf_counter()
        params, report = compile_model(params, masks, SPARSE_SPEC,
                                       spec=CompileSpec(keep_dense=False),
                                       device=args.device,
                                       artifact_dir=args.artifacts)
        _sync(args.device)
        print(f"compile_model in {time.perf_counter() - t0:.2f}s"
              + (f" (artifact store: {args.artifacts})"
                 if args.artifacts else "") + ":")
        print(compiled_summary(report))
        del masks

    mode = "sparse" if args.sparse else "dense"
    if args.batch_size or args.arrival_rate:
        _run_engine(params, cfg, args, mode)
        return
    t0 = time.perf_counter()
    out = generate(params, cfg, prompts, args.new_tokens, device=args.device,
                   frontend=frontend)
    _sync(args.device)
    dt = time.perf_counter() - t0
    print(f"{args.arch} [{mode}, {cfg.n_layers} layers]: generated "
          f"{tuple(out.shape)} in {dt:.2f}s "
          f"({args.batch * args.new_tokens / dt:.1f} tok/s incl. prefill "
          f"and first-use kernel build)")
    print("sample:", out[0][:16].tolist())


def _run_engine(params, cfg, args, mode):
    """``--requests`` prompts of three lengths (``--prompt-len``, half and
    three quarters of it) arriving at ``--arrival-rate`` a step through
    the continuous-batching engine, ``--new-tokens`` each."""
    n_slots = args.batch_size or 8
    eng = ServingEngine(params, cfg, n_slots=n_slots, seq_cap=args.seq_cap,
                        device=args.device)
    rng = np.random.RandomState(0)
    rate = args.arrival_rate
    lengths = (args.prompt_len, max(2, args.prompt_len // 2),
               max(2, 3 * args.prompt_len // 4))
    for i in range(args.requests):
        prompt = rng.randint(1, cfg.vocab,
                             size=lengths[i % len(lengths)]).tolist()
        eng.submit(prompt, args.new_tokens,
                   arrival=int(i / rate) if rate else 0)

    _sync(args.device)
    t0 = time.perf_counter()
    while eng.sched.has_work():
        eng.step()
        if eng.stats["steps"] % args.log_every == 0:
            s = eng.stats
            print(f"step {s['steps']:>4}: occupancy "
                  f"{eng.mean_occupancy():.2f} admitted {s['admitted']} "
                  f"evicted {s['evicted']} queued {eng.sched.queued()} "
                  f"tokens {s['tokens']}")
    _sync(args.device)
    dt = time.perf_counter() - t0
    s = eng.stats
    print(f"{args.arch} [{mode}, {cfg.n_layers} layers, engine B={n_slots}"
          + (f", rate={rate}/step" if rate else ", saturated")
          + f", {s['graph_captures']} graph capture(s)]: {s['finished']}/"
          f"{args.requests} requests, {s['tokens']} tokens in {dt:.2f}s "
          f"({s['tokens'] / dt:.1f} tok/s incl. prefills), mean occupancy "
          f"{eng.mean_occupancy():.2f}")


if __name__ == "__main__":
    main()
