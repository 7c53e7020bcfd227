"""Operations and bytes the served model needs, worked out from the masks
the benchmark drew (``weights.draw``'s live block counts) and the shapes.
Nothing here reads the port's layouts, padding or bins.

The peaks are NVIDIA's data sheet for the H100 SXM at its 700 W limit:
989 TFLOP/s dense bf16 and 3.35 TB/s of HBM.

Kernel 1's bound for one launch is the larger of its live FLOPs at the
bf16 peak and its needed bytes at the HBM peak: each live block's values
(bf16) and its one int32 index, read once; x's rows and the output's rows
once each.  For an expert stack the rows are the (token, expert) pairs the
router picks (top-k a token: dropped pairs are counted as picked), the
FLOPs those pairs times the layer's mean live blocks an expert, and the
bytes every expert's live blocks (at 16 live slots each of 8 experts is
picked with probability 0.99 under uniform routing).
"""
from __future__ import annotations

PEAK_FLOPS = 989e12          # bf16 dense, H100 SXM, 700 W
PEAK_BYTES = 3.35e12         # HBM3, H100 SXM
VALUE_BYTES = 2              # bf16 values and activations
INDEX_BYTES = 4              # one int32 k index a live block

ATTN = ("wq", "wk", "wv", "wo")
FFN = ("gate", "up", "down")


class Model:
    """The cost tables of one drawn model: ``live`` from ``weights.draw``
    and the configuration's ``model`` entry."""

    def __init__(self, model, live):
        self.m = model
        self.n = model["num_hidden_layers"]
        self.d = model["hidden_size"]
        self.E = model.get("num_local_experts", 0)
        self.top_k = model.get("num_experts_per_tok", 0)
        self.heads = model["num_attention_heads"]
        self.hd = model["head_dim"]
        self.V = model["vocab_size"]
        self.live = live
        self.ffn = "moe" if self.E else "ffn"

    def projections(self):
        """(path, is_expert) of each kernel-1 launch of a layer, in the
        order a layer runs them."""
        return ([(f"layers/attn/{p}/w", False) for p in ATTN]
                + [(f"layers/{self.ffn}/{p}/w", bool(self.E)) for p in FFN])

    def launch(self, path, layer, rows):
        """(FLOPs, bytes) kernel 1 needs for ``rows`` rows (expert stack:
        picked pairs) of ``path`` at ``layer``."""
        ent = self.live[path]
        K, N = ent["shape"]
        bk, bn = ent["block"]
        blocks = ent["blocks"][layer]
        blk = bk * bn
        if blocks.dim():                      # an expert stack
            total = float(blocks.sum())
            per_row = total / blocks.numel()
        else:
            total = per_row = float(blocks)
        flops = 2.0 * rows * per_row * blk
        nbytes = (total * (blk * VALUE_BYTES + INDEX_BYTES)
                  + rows * (K + N) * VALUE_BYTES)
        return flops, nbytes

    def k1_bound(self, rows):
        """Seconds kernel 1's launches of one pass over every layer need
        at least, ``rows`` tokens a launch (an expert launch takes top_k
        pairs a token)."""
        s = 0.0
        for layer in range(self.n):
            for path, expert in self.projections():
                f, b = self.launch(path, layer,
                                   rows * self.top_k if expert else rows)
                s += max(f / PEAK_FLOPS, b / PEAK_BYTES)
        return s

    def k1_flops(self, rows):
        return sum(self.launch(path, layer,
                               rows * self.top_k if expert else rows)[0]
                   for layer in range(self.n)
                   for path, expert in self.projections())

    def decode_flops(self, rings):
        """Model FLOPs of one decode step over the live slots whose rings
        hold ``rings`` positions each: the live weights, the router, the
        attention over each ring, the head."""
        a = len(rings)
        f = self.k1_flops(a)
        f += self.n * 4.0 * self.heads * self.hd * sum(rings)
        f += self.n * 2.0 * a * self.d * self.E
        return f + 2.0 * a * self.d * self.V

    def prefill_flops(self, P):
        """Model FLOPs of a prompt of ``P`` tokens: the live weights at P
        rows, the router, causal attention, the head's one row."""
        f = self.k1_flops(P)
        f += self.n * 4.0 * self.heads * self.hd * P * (P + 1) / 2.0
        f += self.n * 2.0 * P * self.d * self.E
        return f + 2.0 * self.d * self.V
