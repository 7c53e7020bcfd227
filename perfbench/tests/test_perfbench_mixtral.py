"""The ``mixtral-8x7b`` configuration and its ``mixtral-batch`` cell: the
file keeps every published width and cuts depth alone; the cell runs on
the CPU at tiny widths with the file's own expert keys (8 experts, top-2,
capacity 1.25), correct, reporting only the metrics it lists; the plain
reference it names follows the port's engine token for token, and the
port's RMSNorm epsilon, which that reference states, is shown to matter;
and the two readers of the port's MoE counters and spans on made-up
spans, None on a program without them."""
import copy
import re
import types

import pytest
import torch

from perfbench import harness, spans, weights

from conftest import tiny_conf, tiny_mix
from test_perfbench_reference import PROMPTS, _f32, _reference, _served

CELL, CONFIG = "mixtral-batch", "mixtral-8x7b"
PUBLISHED = dict(hidden_size=4096, intermediate_size=14336,
                 num_attention_heads=32, num_key_value_heads=8, head_dim=128,
                 vocab_size=32000, num_local_experts=8, num_experts_per_tok=2,
                 rope_theta=1e6, rms_norm_eps=1e-5, sliding_window=None)
METRICS = {"moe_drop_share.mixtral", "moe_dispatch_ms.mixtral",
           "admit_span_ms.mixtral", "step_ms.mixtral", "mfu.mixtral",
           "k1_roofline.mixtral", "idle_share.mixtral"}


def test_configuration_keeps_the_published_widths(bench):
    conf = bench.config(CONFIG)
    m = conf["model"]
    for key, value in PUBLISHED.items():
        assert m[key] == value, key
    assert (m["moe_group"], m["capacity_factor"]) == (1024, 1.25)
    assert m["num_hidden_layers"] == 8
    assert conf["reduced"] == ["num_hidden_layers"]
    assert conf["published"]["num_hidden_layers"] == 32
    assert "8 of 32 layers" in conf["cut"]
    entry, = [c for c in bench.data["configs"] if c["name"] == CONFIG]
    assert entry["reduced"] == conf["reduced"]
    assert entry["source"] == conf["source"]
    cell = bench.cell(CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        CONFIG, "decode-batch", 1)
    assert {m["name"] for m in bench.metrics(CELL, "end_to_end")} == {
        "out_tok_s", "setup_s"}
    listed = {m["name"] for m in bench.data["per_layer"]
              if CELL in m.get("workloads", ())}
    assert listed == METRICS
    # the scheme prunes the expert stacks and leaves the router dense
    pat = re.compile(conf["scheme"]["targets"])
    assert pat.search("layers/moe/gate/w") and pat.search("layers/moe/down/w")
    assert not pat.search("layers/moe/router/w")


def test_cell_reports_its_metrics_on_cpu(bench):
    conf = tiny_conf(bench, CONFIG)
    m = conf["model"]
    assert (m["num_local_experts"], m["num_experts_per_tok"],
            m["capacity_factor"]) == (8, 2, 1.25)
    mix = tiny_mix(bench, bench.cell(CELL)["traffic"])
    for trace in (0, 1):
        r, _ = harness.run_cell(bench, CELL, 2**31 + 3101, 2.0, trace,
                                device="cpu", conf=conf, mix=mix)
        want = {m["name"] for m in bench.metrics(
            CELL, "per_layer" if trace else "end_to_end")}
        got = set(r["metrics"])
        assert got <= want
        if trace:
            # the program's counters and spans; a CPU trace has no device
            for name in ("moe_drop_share.mixtral", "moe_dispatch_ms.mixtral",
                         "admit_span_ms.mixtral", "step_ms.mixtral",
                         "mfu.mixtral"):
                assert name in got, name
            assert r["metrics"]["moe_dispatch_ms.mixtral"]["value"] > 0
            assert 0 <= r["metrics"]["moe_drop_share.mixtral"]["value"] < 100
        else:
            assert got == {"out_tok_s", "setup_s"}
        assert r["correct"] is True
        assert r["attempted"] > 0 and r["failed"] == 0


def _setup(bench):
    """The tiny model of the configuration file's own keys (its experts,
    routing, capacity, epsilon and rope), float32."""
    conf = tiny_conf(bench, CONFIG)
    params, masks, _ = weights.draw(conf, 2**31 + 3199, "cpu")
    return conf, _f32(params), masks


def test_reference_follows_the_served_path(bench):
    conf, params, masks = _setup(bench)
    cfg, exec_p, prompts, served = _served(conf, params, masks, 11)
    ref = _reference(bench, conf, params, prompts, served)
    from repro_torch.models import transformer as T
    for p, s, lg in zip(prompts, served, ref):
        full = T.forward(exec_p, cfg, torch.as_tensor(p[None]))[0, -1]
        assert torch.allclose(lg[0], full.float(), atol=2e-4, rtol=1e-4)
        t = torch.as_tensor(s)
        gap = lg.max(-1).values - lg.gather(1, t[:, None])[:, 0]
        assert float(gap.max()) < 1e-4
    assert [len(p) for p in prompts] == list(PROMPTS)


def test_the_epsilon_rule_matters(bench):
    """The plain decoder at the published epsilon (1e-5) leaves the
    port's prompt logits: the reference the configuration names holds
    the port's 1e-6, a departure the file states."""
    conf, params, masks = _setup(bench)
    cfg, exec_p, prompts, served = _served(conf, params, masks, 12)
    published = copy.deepcopy(conf)
    published["reference"] = "decoder"
    ref = _reference(bench, conf, params, prompts, served)
    off = _reference(bench, published, params, prompts, served)
    from repro_torch.models import transformer as T
    worst = 0.0
    for p, lg, lp in zip(prompts, ref, off):
        full = T.forward(exec_p, cfg, torch.as_tensor(p[None]))[0, -1]
        assert torch.allclose(lg[0], full.float(), atol=2e-4, rtol=1e-4)
        worst = max(worst, float((lp[0] - full.float()).abs().max()))
    # past the tolerance above by several times
    assert worst > 5 * 2e-4


def _span(index, name, t0, t1, parent=None, **attrs):
    return types.SimpleNamespace(index=index, name=name, t0=t0, t1=t1,
                                 parent=parent, rid=None, launches=0,
                                 attrs=attrs)


def _recorded(counted=True):
    """The window is [10, 20].  Two admissions inside it (three layers'
    dispatches each: 1 + 2 + 3 ms and 2 + 2 + 2 ms; 100 pairs, 5 and 3
    dropped), one before it, and a decode step whose eager dispatches
    (none on the card) lie outside any admission."""
    out = []

    def add(name, t0, t1, parent=None, **kw):
        out.append(_span(len(out), name, t0, t1, parent, **kw))
        return len(out) - 1

    moe = (lambda p, d: {"moe_pairs": p, "moe_dropped": d}) if counted \
        else (lambda p, d: {})
    s = add("engine.step", 5.0, 5.5, active=1, admitted=1)
    a = add("engine.admit", 5.0, 5.4, s, **moe(100, 50))
    add("moe.dispatch", 5.0, 5.1, add("admit.prefill", 5.0, 5.3, a))
    s = add("engine.step", 10.0, 10.5, active=2, admitted=2)
    for t, walls, dropped in ((10.0, (1, 2, 3), 5), (10.2, (2, 2, 2), 3)):
        a = add("engine.admit", t, t + 0.15, s, **moe(100, dropped))
        pf = add("admit.prefill", t, t + 0.1, a)
        at = t
        for w in walls:
            if counted:
                add("moe.dispatch", at, at + w / 1e3, pf)
            at += 0.02
    s = add("engine.step", 11.0, 11.03, active=2, admitted=0)
    r = add("engine.replay", 11.0, 11.03, s)
    add("moe.dispatch", 11.0, 11.02, r)
    return out


@pytest.fixture
def reader(bench, monkeypatch):
    def read(name, counted=True):
        rec = _recorded(counted)
        monkeypatch.setattr(spans, "held", lambda: (rec, 0))
        run = types.SimpleNamespace(t_open=10.0, window=10.0)
        return bench.reader(name, "per_layer").read(run)
    return read


def test_moe_readers_on_made_up_spans(reader):
    assert reader("moe_drop_share.mixtral") == pytest.approx(4.0)
    assert reader("moe_dispatch_ms.mixtral") == pytest.approx(6.0)
    assert reader("admit_span_ms.mixtral") == pytest.approx(150.0)


def test_moe_readers_none_without_the_counters(reader, monkeypatch):
    """A program without the counters and the span (the parent of this
    cell's program) reads None, and a program without the recorder too."""
    assert reader("moe_drop_share.mixtral", counted=False) is None
    assert reader("moe_dispatch_ms.mixtral", counted=False) is None
    monkeypatch.setattr(spans, "held", lambda: None)
    run = types.SimpleNamespace(t_open=10.0, window=10.0)
    from perfbench import spec
    bench = spec.Bench()
    for name in ("moe_drop_share.mixtral", "moe_dispatch_ms.mixtral"):
        assert bench.reader(name, "per_layer").read(run) is None
