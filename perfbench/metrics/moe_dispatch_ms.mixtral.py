"""Model step: the host's wall in the MoE layers' routing and dispatch
per admission, in ms: the walls of the port's ``moe.dispatch`` spans (one
a layer of an eager prefill: router, top-k, capacity and dispatch einsum)
inside the untraced window's ``engine.admit`` spans, summed, over those
admissions.  None where no admission holds one (a program without the
span)."""
from perfbench.spans import named, wall_ms, window

LAYER, UNIT, SOURCE, MOVES = "model step", "ms", "program_span", "out_tok_s"


def read(run):
    spans = window(run) or []
    by = {s.index: s for s in spans}
    admits = named(spans, "engine.admit")
    total, found = 0.0, False
    for s in named(spans, "moe.dispatch"):
        p = by.get(s.parent)
        while p is not None and p.name != "engine.admit":
            p = by.get(p.parent)
        if p is not None:
            total += wall_ms(s)
            found = True
    return total / len(admits) if found else None
