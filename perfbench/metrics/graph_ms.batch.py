"""Model step: the median ``graph_ms`` of the untraced window's
decode-only steps, the card's time from just before the captured step's
graph launch to its last kernel (a pair of CUDA events the port records
around each replay, on its ``engine.replay`` span)."""
from perfbench.spans import graph_ms

LAYER, UNIT, SOURCE, MOVES = "model step", "ms", "program_span", "out_tok_s"


def read(run):
    return graph_ms(run)
