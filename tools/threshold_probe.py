#!/usr/bin/env python3
"""Time ``core.reweighted.global_threshold`` on the card against the host
version it replaced (every group norm copied to the CPU, sorted there).

  PYTHONPATH=src python3 tools/threshold_probe.py [--layers 8]

yi-9b at full width (depth ``--layers``), seeded bf16 params, the train
CLI's spec (``launch.train.snapped_spec``: the rule mapper's picks at
8 x 128 tokens snapped to (8, 16) blocks, target rate 0.6).  Prints the
card's name and power limit, both times (median of 3, synchronised) and
both thresholds, which must be equal: the sort is exact wherever it runs.
"""
import argparse
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch import configs  # noqa: E402
from repro_torch.core import regularity as R  # noqa: E402
from repro_torch.core import reweighted as RW  # noqa: E402
from repro_torch.launch.train import snapped_spec  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

RATE = 0.6


def host_threshold(params, spec, rate):
    """The former ``global_threshold``: the normalised norms moved to the
    host and sorted there."""
    return float(R.quantile(RW.normalised_groups(params, spec).cpu(), rate))


def timed(fn):
    times, out = [], None
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=8)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("threshold_probe: no CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    cfg = configs.get("yi-9b").replace(n_layers=args.layers)
    spec = snapped_spec(cfg, 8 * 128, RATE)
    params = T.init_lm(cfg, seed=0, dtype=torch.bfloat16, device="cuda")
    n = RW.normalised_groups(params, spec).numel()
    card_ms, tau = timed(lambda: RW.global_threshold(params, spec, RATE))
    host_ms, host_tau = timed(lambda: host_threshold(params, spec, RATE))
    print(f"card: {smi}")
    print(f"global_threshold over {n} group norms (yi-9b, {args.layers} "
          f"layers, rate {RATE}): on the card {card_ms:.1f} ms, tau "
          f"{tau!r}; on the host {host_ms:.1f} ms, tau {host_tau!r}")
    if tau != host_tau:
        print("threshold_probe: the card's threshold differs from the "
              "host's", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
