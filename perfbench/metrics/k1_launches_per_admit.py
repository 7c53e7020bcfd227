"""Dispatch: kernel-1 launches per admission, the delta of the port's
``LAUNCHES["bsr_matmul"]`` over its ``engine.admit`` spans in the
untraced window: an exact count."""
from perfbench.spans import launches_per_admit

LAYER, UNIT, SOURCE, MOVES = ("dispatch", "launches", "program_counter",
                              "out_tok_s")


def read(run):
    return launches_per_admit(run)
