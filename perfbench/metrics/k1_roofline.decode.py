"""Kernel: kernel 1's roofline bound (``costs``) over its traced time in
the captured decode steps, in %."""
from perfbench.readers import k1_roofline

LAYER, UNIT, SOURCE, MOVES = "kernel", "%", "device_trace", "out_tok_s"


def read(run):
    return k1_roofline(run, "decode")
