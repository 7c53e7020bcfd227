"""Finding a cell's pieces by name.

``BENCHMARK.json`` names a cell's configuration and traffic mix and lists
its metrics; each of them is a file under ``perfbench/``, found here by
that name alone, so adding a configuration, a mix, a generator kind or a
metric adds files and edits none:

- the configuration's ``file`` (``configs/<config>.json``): the model and
  its pruning scheme as run; its ``reference`` names the plain reference
  ``reference/<name>.py``;
- ``traffic/<mix>.json``: the mix's parameters; its ``kind`` names the
  generator ``gen/<kind>.py``;
- ``e2e/<metric>.py`` and ``metrics/<metric>.py``: one reader a metric
  (``UNIT``, ``SOURCE``, ``read(run)``; a per-layer one also ``LAYER`` and
  ``MOVES``).

Modules are loaded from their paths under ``root``, so a copy of the
benchmark elsewhere (the tests') resolves its own files.
"""
from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def load_json(path):
    with open(path) as f:
        return json.load(f)


class Bench:
    """``BENCHMARK.json`` under ``root`` and the files it names."""

    def __init__(self, root=ROOT):
        self.root = Path(root)
        self.here = self.root / "perfbench"
        self.data = load_json(self.root / "BENCHMARK.json")

    def cell(self, name):
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have "
                       f"{[w['name'] for w in self.data['workloads']]})")

    def config(self, name):
        for c in self.data["configs"]:
            if c["name"] == name:
                return load_json(self.root / c["file"])
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    def mix(self, name):
        return load_json(self.here / "traffic" / f"{name}.json")

    def module(self, *parts):
        """The module of file ``perfbench/<parts>.py`` (a name may hold
        dots, so it is loaded by its path)."""
        path = self.here.joinpath(*parts[:-1], parts[-1] + ".py")
        if not path.exists():
            raise FileNotFoundError(f"{'/'.join(parts)}: no file {path}")
        modname = "perfbench_" + "_".join(parts).replace(".", "_").replace(
            "-", "_")
        mod = sys.modules.get(modname)
        if mod is not None and getattr(mod, "__file__", None) == str(path):
            return mod
        spec = importlib.util.spec_from_file_location(modname, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[modname] = mod
        spec.loader.exec_module(mod)
        return mod

    def generator(self, kind):
        return self.module("gen", kind)

    def reference(self, name):
        return self.module("reference", name)

    def reader(self, metric, kind):
        return self.module("e2e" if kind == "end_to_end" else "metrics",
                           metric)

    def metrics(self, cell_name, kind):
        """The entries of ``kind`` ("end_to_end" or "per_layer") that cell
        ``cell_name`` reports: those listing it under ``workloads``, and
        those without the key (a per-layer one then goes with every cell
        that reports the end-to-end metric it moves)."""
        e2e = [m for m in self.data["end_to_end"]
               if cell_name in m.get("workloads", [cell_name])]
        if kind == "end_to_end":
            return e2e
        names = {m["name"] for m in e2e}
        return [m for m in self.data["per_layer"]
                if (cell_name in m["workloads"] if "workloads" in m
                    else m["moves"] in names)]
