"""Generate the roofline table from ``build/dryrun/*.json`` (the
reference's ``repro.launch.roofline_report``), priced for the H100 SXM's
datasheet rates (``core.roofline.H100``).

  PYTHONPATH=src python -m repro_torch.launch.roofline_report [--dir DIR]
writes DIR/../roofline.md + roofline.json (``build/`` by default) and
prints the table."""
from __future__ import annotations

import argparse
import json
import pathlib

from repro_torch.core import roofline as RL

BASE = pathlib.Path(__file__).resolve().parents[3] / "build"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=str(BASE / "dryrun"),
                    help="the dry-run records; the report lands beside it")
    args = ap.parse_args(argv)
    src = pathlib.Path(args.dir)
    target = RL.H100
    rows = RL.load_and_analyze(src, target)
    md = RL.to_markdown(rows)
    (src.parent / "roofline.md").write_text(md)
    (src.parent / "roofline.json").write_text(json.dumps(rows, indent=1,
                                                         default=float))
    print(f"priced for {target.name} (datasheet, not measured): "
          f"{target.peak_flops / 1e12:g} TFLOP/s dense bf16, "
          f"{target.hbm_bw / 1e12:g} TB/s HBM, "
          f"{target.ici_bw / 1e9:g} GB/s collective link a card")
    print(md)
    ok = [r for r in rows if r.get("status") == "OK"]
    if ok:
        worst = min(ok, key=lambda r: r["roofline_fraction"])
        coll = max(ok, key=lambda r: r["t_collective_s"] /
                   max(r["step_time_bound_s"], 1e-12))
        print(f"\nworst roofline fraction: {worst['arch']} × "
              f"{worst['shape']} ({worst['roofline_fraction']:.2f})")
        print(f"most collective-bound:  {coll['arch']} × {coll['shape']}")
    return rows


if __name__ == "__main__":
    main()
