"""Model step: the decode-only steps' model FLOPs (``costs.Model
.decode_flops``: live weights of the picked experts, router, attention
over each ring, head) over their wall seconds at the bf16 peak, in %: the
share of the whole step's peak."""
from perfbench.readers import mfu, wall

LAYER, UNIT, SOURCE, MOVES = "model step", "%", "program_span", "out_tok_s"


def read(run):
    steps = run.decode_only()
    if not steps:
        return None
    return mfu(sum(run.model.decode_flops(s.rings) for s in steps),
               sum(wall(s) for s in steps))
