"""Serve entry: the wall time that steps which admitted spent beyond the
median decode-only step, per request admitted (the eager B = 1 prefill,
the slot write, the first token read back), from the harness's spans
around ``ServingEngine.step`` and the engine's admitted count."""
from perfbench.readers import admit_ms

LAYER, UNIT, SOURCE, MOVES = "serve entry", "ms", "program_span", "out_tok_s"


def read(run):
    return admit_ms(run)
