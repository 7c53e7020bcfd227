"""The control comes out not correct: the port's own int8 value path
(``CompileSpec(value_dtype="int8")``, the precision below the bf16 the
configurations state) served at each cell's own size and load, on three
seeds, fails the check that the bf16 program passes.  At the CPU's widths
the two precisions are too close to tell apart, so this runs on the card
only (``python -m pytest perfbench/tests -m card`` there)."""
import pytest
import torch

from perfbench import harness

CELLS = ("yi9b-batch",)
SECONDS = 25.0


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the control runs at the cell's "
                    "own widths")


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(bench, cell):
    _card()
    for seed in (2**31 + 301, 2**31 + 302, 2**31 + 303):
        r, _ = harness.run_cell(bench, cell, seed, SECONDS, 0,
                                device="cuda:0", value_dtype="int8")
        assert r["correct"] is False, (seed, r["check"])


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_program_is_correct(bench, cell):
    _card()
    r, _ = harness.run_cell(bench, cell, 2**31 + 401, SECONDS, 0,
                            device="cuda:0")
    assert r["correct"] is True, r["check"]
