"""Model step: the mean wall of the port's ``admit.first_token`` span per
admitted request, over the untraced window: the host blocked on the first
token until the prefill's kernels finish, the prefill's device time that
its dispatch did not hide."""
from perfbench.spans import first_token_ms

LAYER, UNIT, SOURCE, MOVES = "model step", "ms", "program_span", "out_tok_s"


def read(run):
    return first_token_ms(run)
