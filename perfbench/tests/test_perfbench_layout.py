"""BENCHMARK.json keeps to the contract's form, every name it gives has its
file, and a new configuration, mix, generator kind and metric are found by
their names alone: the test adds files to a copy and edits none."""
import json
import re
import shutil

import pytest

from perfbench import harness, spec

from conftest import ROOT, TINY, tiny_mix

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_names_and_units(bench):
    d = bench.data
    assert d["command"] == ["python3", "perfbench/run.py"]
    assert d["paths"] == ["perfbench"]
    names = [c["name"] for c in d["configs"]] + [
        w["name"] for w in d["workloads"]] + [
        m["name"] for m in d["end_to_end"] + d["per_layer"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in d["end_to_end"] + d["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in d["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    used = {w["config"] for w in d["workloads"]}
    assert used == {c["name"] for c in d["configs"]}
    for w in d["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200


def test_every_name_has_its_file(bench):
    d = bench.data
    for c in d["configs"]:
        conf = bench.config(c["name"])
        assert conf["name"] == c["name"]
        assert conf["reduced"] == c["reduced"]
        bench.reference(conf["reference"])
    for w in d["workloads"]:
        bench.generator(bench.mix(w["traffic"])["kind"])
        e2e = [m["name"] for m in bench.metrics(w["name"], "end_to_end")]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert bench.metrics(w["name"], "per_layer")
    for m in d["end_to_end"]:
        r = bench.reader(m["name"], "end_to_end")
        assert (r.UNIT, r.SOURCE) == (m["unit"], m["source"])
    for m in d["per_layer"]:
        r = bench.reader(m["name"], "per_layer")
        assert (r.UNIT, r.SOURCE, r.LAYER, r.MOVES) == (
            m["unit"], m["source"], m["layer"], m["moves"])


NEW_METRIC = '''"""A metric a later change adds: decode steps in the window."""
LAYER, UNIT, SOURCE, MOVES = ("model step", "steps", "program_span",
                              "out_tok_s")


def read(run):
    return float(sum(1 for s in run.steps if s.active))
'''

NEW_GEN = '''"""A generator kind a later change adds: the backlog, reversed."""
from perfbench.gen import batch


def requests(mix, seed, vocab):
    return batch.requests(mix, seed, vocab)[::-1]
'''


def test_new_files_are_found_by_name(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "perfbench", root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    d = json.loads((ROOT / "BENCHMARK.json").read_text())
    before = {p.relative_to(root): p.read_bytes()
              for p in (root / "perfbench").rglob("*") if p.is_file()}
    # a configuration, a mix with a generator kind of its own, a metric
    conf = json.loads((root / "perfbench/configs/yi-9b.json").read_text())
    conf["name"] = "tiny-dense"
    conf["model"].update(TINY)
    conf["check"]["limit"] = 1.0
    (root / "perfbench/configs/tiny-dense.json").write_text(json.dumps(conf))
    mix = tiny_mix(spec.Bench(), "decode-batch", kind="backlog")
    (root / "perfbench/traffic/tiny-backlog.json").write_text(json.dumps(mix))
    (root / "perfbench/gen/backlog.py").write_text(NEW_GEN)
    (root / "perfbench/metrics/decode_steps.batch.py").write_text(NEW_METRIC)
    d["configs"].append({"name": "tiny-dense", "source": "test",
                         "file": "perfbench/configs/tiny-dense.json",
                         "reduced": conf["reduced"], "why": "test"})
    d["workloads"].append({"name": "tiny-cell", "config": "tiny-dense",
                           "traffic": "tiny-backlog", "chips": 1,
                           "why": "test"})
    d["per_layer"].append({"name": "decode_steps.batch", "unit": "steps",
                           "better": "higher", "source": "program_span",
                           "layer": "model step", "moves": "out_tok_s",
                           "workloads": ["tiny-cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(d))
    after = {p.relative_to(root): p.read_bytes()
             for p in (root / "perfbench").rglob("*")
             if p.is_file() and p.relative_to(root) in before}
    assert after == before                       # nothing was edited
    bench = spec.Bench(root)
    for trace in (0, 1):
        r, _ = harness.run_cell(bench, "tiny-cell", 2**31 + 11, 4.0, trace,
                             device="cpu")
        names = set(r["metrics"])
        if trace:
            assert "decode_steps.batch" in names
            assert r["metrics"]["decode_steps.batch"]["value"] > 0
        else:
            assert names == {"out_tok_s", "setup_s"}
        assert r["correct"] is True
    assert bench.generator("backlog").__file__.startswith(str(root))


@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
@pytest.mark.parametrize("cell", ["yi9b-batch"])
def test_cell_reports_its_metrics_on_cpu(bench, cell, moe):
    from conftest import tiny_conf
    w = bench.cell(cell)
    conf = tiny_conf(bench, w["config"], moe=moe)
    mix = tiny_mix(bench, w["traffic"])
    for trace in (0, 1):
        r, _ = harness.run_cell(bench, cell, 1234567890123, 2.0, trace,
                             device="cpu", conf=conf, mix=mix)
        want = {m["name"] for m in bench.metrics(
            cell, "per_layer" if trace else "end_to_end")}
        got = set(r["metrics"])
        # what only a card's trace gives is absent on the CPU
        assert got <= want
        assert "setup_s" in got or trace
        assert r["attempted"] > 0 and r["failed"] == 0
        assert list(r)[-1] == "check"
