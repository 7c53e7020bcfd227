"""Every output token the engine emitted inside the window, over the
window's seconds (its opening to the end of the step that was running at
its close)."""
UNIT, SOURCE = "tokens/s", "host_clock"


def read(run):
    end = run.t_open + run.window
    n = sum(1 for rec in run.recs for t in rec.times if t <= end)
    return n / run.window if run.window > 0 else None
