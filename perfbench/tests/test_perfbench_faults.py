"""The check catches a broken timed path.  A run is driven as the harness
drives it (the look for a card skipped, at CPU widths), with the engine
broken underneath, and ``correct`` must come out false; the same run
unbroken comes out true.  The faults are ``perfbench.faults``' (their readings at the
cell's own size on the card are in PERF.md)."""
import numpy as np
import pytest
import torch

from perfbench import faults, harness

from conftest import tiny_conf, tiny_mix

LIMIT = 0.05     # the sound runs below read 0 to 0.003 at these widths


@pytest.mark.parametrize("fault", (None,) + faults.ALL,
                         ids=lambda f: getattr(f, "__name__", str(f)))
def test_fault_is_caught(bench, fault):
    cell = "yi9b-batch"
    w = bench.cell(cell)
    conf = tiny_conf(bench, w["config"], limit=LIMIT)
    mix = tiny_mix(bench, w["traffic"], check_requests=64)
    torch.manual_seed(0)
    r, run = harness.run_cell(bench, cell, 2**31 + 77, 4.0, 0,
                            device="cpu", conf=conf, mix=mix,
                            tamper=fault)
    assert r["sample"]["requests"] > 0, (len(run.steps), r["attempted"],
                                         r["phases_s"])
    assert r["correct"] is (fault is None), r["check"]
    if fault is not None:
        (num,) = r["check"].values()
        assert num["value"] > LIMIT


def test_altered_token_reads_its_gap(bench):
    """The gap of a served token the reference would not pick is its
    logit's distance below the reference's best, and 0 for its argmax."""
    from perfbench import check
    served = {0: [3, 1]}
    lg = torch.tensor([[0.0, 1.0, 5.0, 2.0], [0.5, 4.0, 1.0, 0.0]])
    t = torch.as_tensor(served[0])
    gap = lg.max(-1).values - lg.gather(1, t[:, None])[:, 0]
    assert gap.tolist() == [3.0, 0.0]
    assert check.sample({5: [1] * 9, 6: [1] * 3, 7: [1]},
                        np.random.default_rng(0), 2)[0] == 5
