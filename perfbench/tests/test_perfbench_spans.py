"""The five readers of the port's spans on made-up span lists: the window
filter (neither set-up nor the traced slice), the decode-only selection,
None on a ring that dropped spans of the window and on a program without
the recorder; then the readers over a CPU run of the harness."""
import sys
import types

import pytest

from perfbench import harness, spans

from conftest import tiny_conf, tiny_mix

READERS = ("admit_span_ms.batch", "prefill_wait_ms.batch",
           "k1_launches_per_admit", "graph_ms.batch", "step_host_ms.batch")


def _span(index, name, t0, t1, parent=None, launches=0, **attrs):
    return types.SimpleNamespace(index=index, name=name, t0=t0, t1=t1,
                                 parent=parent, rid=None, launches=launches,
                                 attrs=attrs)


def _recorded():
    """Times in s.  The window is [10, 20]: set-up before it, a traced
    slice after it.  Inside: one admitting step (two admissions, 0.2 s
    and 0.1 s, first tokens 0.05 s and 0.02 s), decode-only steps of
    0.03 s with graphs of 0.02, 0.018 and 0.022 s, and an idle tick."""
    out = []

    def add(name, t0, t1, parent=None, **kw):
        out.append(_span(len(out), name, t0, t1, parent, **kw))
        return len(out) - 1

    add("engine.step", 5.0, 5.5, active=1, admitted=1)         # set-up
    add("engine.admit", 5.0, 5.4, 0, launches=336)
    s = add("engine.step", 10.0, 10.33, active=2, admitted=2)
    a = add("engine.admit", 10.0, 10.2, s, launches=336)
    add("admit.first_token", 10.15, 10.2, a)
    a = add("engine.admit", 10.2, 10.3, s, launches=336)
    add("admit.first_token", 10.28, 10.3, a)
    add("engine.replay", 10.3, 10.33, s, graph_ms=25.0)
    for i, g in enumerate((20.0, 18.0, 22.0)):
        t = 11.0 + i
        s = add("engine.step", t, t + 0.03, active=2, admitted=0)
        add("engine.replay", t + 0.005, t + 0.029, s, graph_ms=g)
    add("engine.step", 15.0, 15.001, active=0, admitted=0)
    add("queue", 12.0, None)                                   # still open
    s = add("engine.step", 21.0, 21.5, active=2, admitted=1)   # traced slice
    add("engine.admit", 21.0, 21.4, s, launches=336)
    add("engine.replay", 21.4, 21.5, s, graph_ms=1.0)
    return out


@pytest.fixture
def run(monkeypatch):
    rec = _recorded()
    monkeypatch.setattr(spans, "held", lambda: (rec, 0))
    return types.SimpleNamespace(t_open=10.0, window=10.0)


def test_window_leaves_out_set_up_and_the_slice(run):
    got = spans.window(run)
    assert {s.t0 for s in got} >= {10.0, 11.0, 15.0}
    assert all(10.0 <= s.t0 and s.t1 <= 20.0 for s in got)
    assert not any(s.name == "queue" for s in got)            # open


def test_readers_on_made_up_spans(run, bench):
    got = {m: bench.reader(m, "per_layer").read(run) for m in READERS}
    assert got["admit_span_ms.batch"] == pytest.approx(150.0)
    assert got["prefill_wait_ms.batch"] == pytest.approx(35.0)
    assert got["k1_launches_per_admit"] == 336
    # decode-only: not the admitting step, not the idle tick
    assert got["graph_ms.batch"] == pytest.approx(20.0)
    assert got["step_host_ms.batch"] == pytest.approx(10.0)


def test_none_where_the_ring_dropped_into_the_window(monkeypatch):
    rec = _recorded()
    win = types.SimpleNamespace(t_open=10.0, window=10.0)
    assert spans.within(rec[2:], 2, 10.0, 20.0) is None   # starts at 10.0
    assert spans.within(rec[1:], 1, 10.0, 20.0) is not None
    assert spans.within([], 5, 10.0, 20.0) is None
    monkeypatch.setattr(spans, "held", lambda: (rec[3:], 3))
    for name in (spans.admit_ms, spans.first_token_ms,
                 spans.launches_per_admit, spans.graph_ms,
                 spans.step_host_ms):
        assert name(win) is None


def test_none_without_the_recorder(monkeypatch):
    import repro_torch.serve
    monkeypatch.delattr(repro_torch.serve, "trace", raising=False)
    monkeypatch.setitem(sys.modules, "repro_torch.serve.trace", None)
    assert spans.held() is None
    win = types.SimpleNamespace(t_open=0.0, window=1e9)
    assert spans.admit_ms(win) is None and spans.graph_ms(win) is None


def test_none_where_nothing_decoded_on_the_card(run):
    rec = [s for s in _recorded() if s.name != "engine.replay"]
    assert spans.decode_steps(rec) == []
    rec = _recorded()
    for s in rec:
        s.attrs.pop("graph_ms", None)           # the CPU: no graph
    assert spans.decode_steps(rec) == []


def test_readers_over_a_cpu_run(bench):
    from repro_torch.serve import trace
    trace.reset()
    conf = tiny_conf(bench, "yi-9b")
    mix = tiny_mix(bench, "decode-batch")
    r, run = harness.run_cell(bench, "yi9b-batch", 2**31 + 77, 2.0, 1,
                              device="cpu", conf=conf, mix=mix)
    m = r["metrics"]
    n = sum(len(s.admitted) for s in run.steps)
    assert n > 0
    assert m["k1_launches_per_admit"]["value"] == 0       # no card
    assert 0 < m["prefill_wait_ms.batch"]["value"] < m[
        "admit_span_ms.batch"]["value"]
    assert len(spans.named(spans.window(run), "engine.admit")) == n
    # no captured graph on the CPU
    assert "graph_ms.batch" not in m and "step_host_ms.batch" not in m
