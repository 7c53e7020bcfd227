"""Kernel: kernel 1's roofline bound (``costs``: each expert launch at
its picked pairs, every expert's live blocks read once) over its traced
time in the captured decode steps, in %.  The moe engine admits eagerly,
so a step's first ``cudaGraphLaunch`` is its decode graph's."""
from perfbench.readers import k1_roofline

LAYER, UNIT, SOURCE, MOVES = "kernel", "%", "device_trace", "out_tok_s"


def read(run):
    return k1_roofline(run, "decode")
