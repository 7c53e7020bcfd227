"""Runs of one cell at several seeds in one process, for setting a limit:
the program as the benchmark runs it, the control (the port's own int8
value path, ``CompileSpec(value_dtype="int8")``), and the program with a
fault of ``perfbench.faults`` planted under its timed path.  Each line of
the output is one run's result with its ``seed``, ``control`` and
``fault``; every run's gaps are saved beside it (``<out>.<seed>.<what>.npy``).

    python3 perfbench/tools/calibrate.py --workload yi9b-batch \
        --seconds 20 --seeds 11,12 --control-seeds 21,22 \
        --fault-seeds 31 --out FILE
"""
import argparse
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
sys.path[:] = [str(ROOT), str(ROOT / "src")] + [
    p for p in sys.path if Path(p or ".").resolve() != Path(__file__).parent]

from perfbench import faults, harness, spec  # noqa: E402


def _seeds(text):
    return [int(s) for s in text.split(",") if s]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="",
                    help="each fault of perfbench.faults at each seed")
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    bench = spec.Bench()
    runs = [(s, None, None) for s in _seeds(args.seeds)]
    runs += [(s, "int8", None) for s in _seeds(args.control_seeds)]
    runs += [(s, None, f) for s in _seeds(args.fault_seeds)
             for f in faults.ALL]
    with open(args.out, "a") as out:
        for seed, vdt, fault in runs:
            r, run = harness.run_cell(bench, args.workload, seed, args.seconds,
                                      0, device="cuda:0", value_dtype=vdt,
                                      tamper=fault)
            what = fault.__name__ if fault else (vdt or "bf16")
            r.update(seed=seed, control=vdt, fault=what if fault else None,
                     steps=len(run.steps))
            if run.gaps is not None:
                np.save(f"{args.out}.{seed}.{what}.npy", run.gaps)
            line = json.dumps(r)
            out.write(line + "\n")
            out.flush()
            print(line[:600], flush=True)


if __name__ == "__main__":
    main()
