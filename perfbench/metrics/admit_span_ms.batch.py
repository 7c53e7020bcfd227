"""Serve entry: the mean wall of the port's ``engine.admit`` span per
admitted request (the eager B = 1 prefill's dispatch, the wait for its
first token, the slot write), over the untraced window."""
from perfbench.spans import admit_ms

LAYER, UNIT, SOURCE, MOVES = "serve entry", "ms", "program_span", "out_tok_s"


def read(run):
    return admit_ms(run)
