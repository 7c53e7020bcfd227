"""Process start to the window's opening: weights and masks drawn, the
compile, the engine and its captured step, the warm-up."""
UNIT, SOURCE = "s", "host_clock"


def read(run):
    return run.setup_s
