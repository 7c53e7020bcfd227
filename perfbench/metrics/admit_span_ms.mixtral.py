"""Serve entry: the mean wall of the port's ``engine.admit`` span per
admitted request (the moe family's eager B = 1 prefill: its dispatch, the
wait for its first token, the slot write), over the untraced window."""
from perfbench.spans import admit_ms

LAYER, UNIT, SOURCE, MOVES = "serve entry", "ms", "program_span", "out_tok_s"


def read(run):
    return admit_ms(run)
