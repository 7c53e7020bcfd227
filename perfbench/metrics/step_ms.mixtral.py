"""Model step: the median host time of the window's decode-only steps
(the replay of the engine's captured ``decode_step_ragged``: attention,
router, the one-hot dispatch and kernel 1's expert launches at 16 slots,
its inputs copied in and its tokens read back)."""
from perfbench.readers import base_step_s

LAYER, UNIT, SOURCE, MOVES = "model step", "ms", "program_span", "out_tok_s"


def read(run):
    s = base_step_s(run)
    return None if s is None else s * 1e3
