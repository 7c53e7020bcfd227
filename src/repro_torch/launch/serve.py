"""Serving CLI: seeded init -> one-shot block masks -> compile_model
(BCS packing) -> greedy generate, on the card.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-9b --sparse \\
      --layers 8
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-1.3b \\
      --sparse

``--layers`` cuts depth only, never width.  ``--smoke`` takes the reduced
test config instead of the published one; ``--device cpu`` runs the plain
PyTorch versions of the kernels (for small configs).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.core import reweighted as RW
from repro_torch.models import transformer as T
from repro_torch.serve.compile import (CompileSpec, compile_model,
                                       compiled_summary)
from repro_torch.serve.engine import generate
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
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = configs.get(args.arch, smoke=args.smoke)
    if args.layers:
        cfg = cfg.replace(n_layers=args.layers)
    params = T.init_lm(cfg, seed=0, device=args.device)
    prompts = np.random.RandomState(0).randint(
        0, cfg.vocab, size=(args.batch, args.prompt_len))
    if args.sparse:
        masks = RW.magnitude_block_masks(params, SPARSE_SPEC, None,
                                         rate=args.prune_rate)
        params = apply_masks(params, masks)
        _sync(args.device)
        t0 = time.perf_counter()
        params, report = compile_model(params, masks, SPARSE_SPEC,
                                       spec=CompileSpec(keep_dense=False),
                                       device=args.device)
        _sync(args.device)
        print(f"compile_model in {time.perf_counter() - t0:.2f}s:")
        print(compiled_summary(report))
        del masks

    mode = "sparse" if args.sparse else "dense"
    t0 = time.perf_counter()
    out = generate(params, cfg, prompts, args.new_tokens, device=args.device)
    _sync(args.device)
    dt = time.perf_counter() - t0
    print(f"{args.arch} [{mode}, {cfg.n_layers} layers]: generated "
          f"{tuple(out.shape)} in {dt:.2f}s "
          f"({args.batch * args.new_tokens / dt:.1f} tok/s incl. prefill "
          f"and first-use kernel build)")
    print("sample:", out[0][:16].tolist())


if __name__ == "__main__":
    main()
