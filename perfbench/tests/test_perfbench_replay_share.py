"""The reader of ``admit_replay_share.batch`` on made-up span lists: the
share of the window's ``engine.admit`` spans whose ``bucket`` is set,
with set-up and the traced slice left out; None on a program whose
admissions carry no ``bucket`` (no captured prefill), on a window with
no admission and on a program without the recorder; then over a CPU run
of the harness, where every admission is eager."""
import sys
import types

import pytest

from perfbench import harness, spans

from conftest import tiny_conf, tiny_mix

NAME = "admit_replay_share.batch"


def _admit(t0, **attrs):
    return types.SimpleNamespace(index=0, name="engine.admit", t0=t0,
                                 t1=t0 + 0.1, parent=None, rid=None,
                                 launches=336, attrs=attrs)


def _recorded(buckets):
    """One admission of each bucket in the window [10, 20], and one
    replayed admission in set-up and one in the traced slice after it."""
    out = [_admit(5.0, bucket=1024)]
    out += [_admit(11.0 + i, **b) for i, b in enumerate(buckets)]
    out.append(_admit(21.0, bucket=16))
    return out


def _read(bench, monkeypatch, rec):
    monkeypatch.setattr(spans, "held", lambda: (rec, 0))
    run = types.SimpleNamespace(t_open=10.0, window=10.0)
    return bench.reader(NAME, "per_layer").read(run)


@pytest.mark.parametrize("buckets,want", [
    ([{"bucket": 16}, {"bucket": 128}, {"bucket": 1024}], 100.0),
    ([{"bucket": 32}, {"bucket": None}, {"bucket": 64},
      {"bucket": None}], 50.0),
    ([{"bucket": None}, {"bucket": 256}, {"bucket": 256}], 200.0 / 3),
    ([{"bucket": None}, {"bucket": None}], 0.0),
    ([{"prompt_len": 9}, {"prompt_len": 70}], None),
    ([], None)])
def test_share_of_replayed_admissions(bench, monkeypatch, buckets, want):
    got = _read(bench, monkeypatch, _recorded(buckets))
    assert got == (None if want is None else pytest.approx(want))


def test_none_without_the_recorder(bench, monkeypatch):
    import repro_torch.serve
    monkeypatch.delattr(repro_torch.serve, "trace", raising=False)
    monkeypatch.setitem(sys.modules, "repro_torch.serve.trace", None)
    run = types.SimpleNamespace(t_open=0.0, window=1e9)
    assert bench.reader(NAME, "per_layer").read(run) is None


def test_zero_over_a_cpu_run(bench):
    from repro_torch.serve import trace
    trace.reset()
    conf = tiny_conf(bench, "yi-9b")
    mix = tiny_mix(bench, "decode-batch")
    r, run = harness.run_cell(bench, "yi9b-batch", 2**31 + 91, 2.0, 1,
                              device="cpu", conf=conf, mix=mix)
    assert sum(len(s.admitted) for s in run.steps) > 0
    assert r["metrics"][NAME]["value"] == 0.0
