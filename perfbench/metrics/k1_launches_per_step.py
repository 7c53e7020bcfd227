"""Dispatch: kernel-1 launches a decode-only step, from the port's own
count (``kernels.bsr_matmul.LAUNCHES``, which the engine advances by its
captured step's launches at each replay): an exact count."""
LAYER, UNIT, SOURCE, MOVES = ("dispatch", "launches", "program_counter",
                              "out_tok_s")


def read(run):
    steps = run.decode_only()
    return sum(s.launches for s in steps) / len(steps) if steps else None
