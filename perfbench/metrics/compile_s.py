"""Compile: host clock around ``serve.compile.compile_model`` (the packing
of every pruned projection), ending in a device sync."""
LAYER, UNIT, SOURCE, MOVES = "compile", "s", "host_clock", "setup_s"


def read(run):
    return run.compile_s
