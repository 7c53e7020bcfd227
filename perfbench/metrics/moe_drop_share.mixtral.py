"""Model step: the share of the routed (token, expert) pairs that the
prefill's capacity rule dropped, in %: 100 x the sum of the port's
``moe_dropped`` over the sum of its ``moe_pairs``, attributes of the
untraced window's ``engine.admit`` spans (the moe family's eager
admission).  None where no admission carries them: a program without the
counters, or a recorder switched off."""
from perfbench.spans import named, window

LAYER, UNIT, SOURCE, MOVES = ("model step", "%", "program_counter",
                              "out_tok_s")


def read(run):
    admits = [s for s in named(window(run) or [], "engine.admit")
              if "moe_pairs" in s.attrs]
    pairs = sum(s.attrs["moe_pairs"] for s in admits)
    if not pairs:
        return None
    return 100.0 * sum(s.attrs["moe_dropped"] for s in admits) / pairs
