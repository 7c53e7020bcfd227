"""Serve entry: the median over the untraced window's decode-only steps of
the port's ``engine.step`` wall less its ``graph_ms``: the time in
``step()`` when the card does not run the step's graph."""
from perfbench.spans import step_host_ms

LAYER, UNIT, SOURCE, MOVES = "serve entry", "ms", "program_span", "out_tok_s"


def read(run):
    return step_host_ms(run)
