"""The trace arithmetic on a made-up trace: busy time as the union of the
device's intervals, each step split at its graph launch into the
admission and the decode step, kernel 1's roofline share per phase, and
the idle gaps named by the harness's marks."""
import types

import pytest

from perfbench import readers, trace_read
from perfbench.harness import Step

from test_perfbench_costs import _one_layer_model

K1 = "void bsr_matmul_kernel<bf16>"


def _trace():
    # step 0 (0-400 us): one admission (7 kernel-1 launches before the
    # graph launch at 200), then the decode step (7 after it); step 1
    # (500-900 us): the decode step alone, launched at 550
    dev = [(K1, 10 + 10 * j, 18 + 10 * j) for j in range(7)]
    dev += [("copy", 100, 150)]
    dev += [(K1, 210 + 20 * j, 225 + 20 * j) for j in range(7)]
    dev += [(K1, 560 + 20 * j, 570 + 20 * j) for j in range(7)]
    return {"window": (0.0, 1000.0),
            "host": [("step#0", 0.0, 400.0), ("step#1", 500.0, 900.0),
                     ("submit", 400.0, 500.0)],
            "launches": [200.0, 550.0], "device": dev}


def test_busy_phases_and_gaps():
    s = trace_read.summarize(_trace())
    busy = 7 * 8 + 50 + 7 * 15 + 7 * 10
    assert s["busy_s"] == pytest.approx(busy / 1e6)
    assert s["window_s"] == pytest.approx(1e-3)
    assert s["per_step"][0]["admit_us"] == [8.0] * 7
    assert s["per_step"][0]["decode_us"] == [15.0] * 7
    assert s["per_step"][1] == {"admit_us": [], "decode_us": [10.0] * 7}
    gaps = dict((round(g * 1e6), n) for n, g in s["breakdown"]["idle_gaps"])
    assert gaps[215] == "submit"            # 345 to 560 us, between steps
    assert gaps[310] == "step"            # 690 to 1000, after step 1's launch
    assert gaps[60] == "admit"            # 150 to 210, before step 0's launch
    ops = dict(s["breakdown"]["device_ops"])
    assert ops[K1] == pytest.approx((7 * 8 + 7 * 15 + 7 * 10) / 1e6)


def test_k1_roofline_per_phase():
    model = _one_layer_model(False)
    run = types.SimpleNamespace(
        model=model, trace=trace_read.summarize(_trace()),
        slice_steps=[Step(0, 1, 3, [6], [], 14),
                     Step(2, 3, 4, [], [], 7)])
    dec = model.k1_bound(3) + model.k1_bound(4)
    assert readers.k1_roofline(run, "decode") == pytest.approx(
        100 * dec / ((7 * 15 + 7 * 10) / 1e6))
    assert readers.k1_roofline(run, "admit") == pytest.approx(
        100 * model.k1_bound(6) / (7 * 8 / 1e6))
    assert readers.idle_share(run) == pytest.approx(
        100 * (1 - run.trace["busy_s"] / run.trace["window_s"]))
    # a step whose launch count is not the model's is left out
    run.slice_steps[0] = Step(0, 1, 3, [6, 6], [], 21)
    assert readers.k1_roofline(run, "admit") is None
