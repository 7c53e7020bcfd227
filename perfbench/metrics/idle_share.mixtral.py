"""Device: the share of the traced slice in which no kernel, copy or set
ran on the card, in %."""
from perfbench.readers import idle_share

LAYER, UNIT, SOURCE, MOVES = "device", "%", "device_trace", "out_tok_s"


def read(run):
    return idle_share(run)
