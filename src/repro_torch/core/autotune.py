"""Auto-tuning (paper Appendix A.2), ported from the reference for parity.

The paper tunes tiling/unroll/data-placement with a genetic algorithm for
OpenCL.  The reference's tunable space is its TPU kernel's (bm, bk, bn)
tile shape — multiples of the (8, 128) vector-register tile bounded by a
TPU v5e's VMEM — swept exhaustively against the latency model, and these
functions keep exactly that pricing (V5E, ``VMEM_BYTES``).  On the H100
the job is done elsewhere: ``kernels.bsr_matmul.bsr_plan`` picks kernel
1's M tile, chunking and warp layout from the card's own shared memory
and tile rules, and nothing here feeds it."""
from __future__ import annotations

import itertools

from repro_torch.core.latency_model import V5E, TPUTarget

VMEM_BYTES = 64 * 1024 * 1024   # usable VMEM budget: half of a v5e's 128MB


def tile_candidates(M, K, N, dtype_bytes=2):
    ms = [m for m in (128, 256, 512) if M % m == 0 or m >= M]
    ks = [k for k in (128, 256, 512) if K % k == 0]
    ns = [n for n in (128, 256, 512) if N % n == 0]
    for bm, bk, bn in itertools.product(ms, ks, ns):
        vmem = (bm * bk + bk * bn + bm * bn * 2) * dtype_bytes * 2  # dbl buf
        if vmem <= VMEM_BYTES:
            yield (min(bm, M), bk, bn)


def tune_tiles(M, K, N, density=1.0, target: TPUTarget = V5E,
               dtype_bytes=2):
    """Pick (bm, bk, bn) minimizing modeled time: MXU-aligned compute +
    HBM streaming + per-step overhead, weights streamed once per M-tile."""
    best, best_t = None, float("inf")
    for bm, bk, bn in tile_candidates(M, K, N, dtype_bytes):
        steps = max(1, M // bm) * max(1, N // bn) * max(
            1, int(K // bk * density))
        flops = 2 * M * K * N * density
        t_c = flops / target.peak_flops
        w_bytes = K * N * density * dtype_bytes * max(1, M // bm)
        x_bytes = M * K * dtype_bytes * max(1, N // bn)
        t_m = (w_bytes + x_bytes) / target.hbm_bw
        t = max(t_c, t_m) + steps * target.step_overhead
        if t < best_t:
            best, best_t = (bm, bk, bn), t
    return best, best_t
