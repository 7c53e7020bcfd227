"""Serve entry: the share of the window's admissions that replayed a
captured prefill graph, in %: the port's ``engine.admit`` spans whose
``bucket`` attribute is set, over all of them, in the untraced window.
None where the program records no ``bucket`` (it has no captured
prefill) or admitted nothing."""
from perfbench.spans import named, window

LAYER, UNIT, SOURCE, MOVES = "serve entry", "%", "program_span", "out_tok_s"


def read(run):
    admits = named(window(run) or [], "engine.admit")
    if not admits or not any("bucket" in s.attrs for s in admits):
        return None
    replayed = sum(1 for s in admits if s.attrs.get("bucket") is not None)
    return 100.0 * replayed / len(admits)
