#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card, end to end.

  python3 chip_smoke.py [--layers 8]

1. Print the card (nvidia-smi name and power limit) and build every CUDA
   kernel from ``src/repro_torch/kernels/csrc`` (one ``nvcc`` per source,
   all started together).
2. Hold each kernel against its plain PyTorch version on the card, at the
   shapes the main path gives it (yi-9b full width, (16, 16) blocks, decode
   M = 4 and prefill M = 128 and the plan's path boundaries M = 1, 15, 16,
   17, 129, bf16 and fp32, reordered into 4 bins and not, bias with silu /
   relu / none), and time kernel, plain version, the one PyTorch call
   computing the same product (``torch.matmul`` on the masked dense
   weight, a yardstick the port never calls) and the bound, summed per
   layer at decode and at prefill.
3. Serve block-pruned yi-9b at full width (depth cut to ``--layers``):
   seeded init, magnitude block masks at rate 0.6, ``compile_model``,
   then greedy ``generate`` of 4 prompts of 32 tokens, counting kernel
   launches over exactly that run; time it warm, trace one prefill and one
   ``generate`` with ``torch.profiler`` for the card's busy share, and hold
   the packed prefill logits against the same weights run masked-dense,
   with planted faults showing that the bound catches a broken packed
   path.
4. Conv kernels: every packed layer of ``VGG_TINY`` under the
   block-punched and the pattern mapping at B = 256, 32x32, and
   ``MOBILE_TINY``'s 5x5 ``c4``, in fp32 and bf16, reordered and not, bias
   + relu and none, implicit and materialized forced: kernel vs plain
   version, implicit == materialized and reordered == unreordered
   bitwise; times of each mode, the plain version, ``F.conv2d`` on the
   masked dense weight (TF32 off; a yardstick the port never calls) and
   the bound; then both modes of c2 and c3 at small batches, the rows
   behind ``ops._pick_implicit``'s rule (no patch-size floor).
5. Serve ``VGG_TINY`` at its published widths (fp32, seed 0, B = 256
   synthetic 32x32x3 images, 10 classes) under both mappings through
   ``compile_model`` and ``convnet_apply``: the launches of one forward
   per kernel equal what the layouts imply, the logits agree with the
   masked-dense run on the card (TF32 off), a planted fault breaks that
   bound; ms per forward, images/s and the card's busy share.
6. The MoE path: kernel 1 over mixtral-8x7b's expert stacks (8 experts,
   (K, N) of 4096 x 14336 and 14336 x 4096, M = 1, 4, 15, 16, 17, 40,
   64, 65, bf16 and fp32, reordered into 4 bins and not, silu / none) in
   one launch a call vs the plain version expert by expert, reordered ==
   unreordered bitwise; one MoE layer's three projections timed at decode
   (M = 4) and prefill (M = 40, the capacity of the 128-token group)
   beside ``torch.bmm`` of the masked dense stack, the bound and a plain
   read of the same bytes.  Then mixtral-8x7b served at full width (depth
   cut to MOE_LAYERS, bf16, seed 0, rate 0.6, 4 bins, B = 4 x 32,
   16 new tokens): launches counted over the ``generate``, warm prefill
   and decode times, the busy share; every layer's ``moe()`` packed vs
   masked-dense on the same input (bf16, yi-9b's bounds), whole-model
   bf16 logits and routing flips printed, the fp32 whole model at 2
   layers gated on its logits (TF32 off) and greedy tokens, two planted
   expert-layout faults breaking both gated bounds, and the phase's peak
   device memory.

7. int8 values, the reference's ``CompileSpec(value_dtype="int8")``,
   after each path's float phase and on its masked params: quantization
   on the card == on the host bitwise; kernel 1 at yi-9b's shapes
   (CHECK_M) and over mixtral's 8-expert stacks (MOE_CHECK_M), kernels
   2-4 at VGG_TINY's layers, each vs its plain version in bf16 and fp32
   under both scale granularities (a scale per block or tap slot, or per
   output column), reordered == unreordered and implicit == materialized
   bitwise (c5 under the pattern mapping: kernel 2 == kernel 4); one
   CUDA-graph replay of a chunked int8 expert launch; planted scale
   faults (a block's scale doubled, a column's zeroed) on kernel 1 and on
   a tap layout, each breaking the kernel-vs-plain bound; the value bytes
   of a yi-9b layer in bf16 and in int8 + scales, and int8 timings beside
   the int8 byte bound, the plain version, the library call on the bf16
   masked dense weight and a stream read of the int8 bytes.  yi-9b,
   mixtral-8x7b and VGG_TINY served int8: launches counted over the main
   path (952 and 476 kernel-1 launches a ``generate``, as float), logits
   against masked-dense on the dequantized weights (``to_dense``) within
   each path's bound, the fp32 LMs at 2 layers gated on logits and greedy
   tokens, prefill / decode / forward times, busy shares and mixtral's
   int8 peak memory.  Each kernel's JSON entry carries an ``int8`` branch.
8. The SSM and hybrid families, after the MoE state is freed: kernel 1
   vs its plain version at every projection shape of mamba2-1.3b and
   hymba-1.5b ((16, 8) blocks on the mixers' in/out_proj, (16, 16) on
   hymba's attention and FFN; CHECK_M, bf16 and fp32, float and int8,
   reordered == unreordered bitwise), one layer of each timed at decode
   (M = 4) and prefill (M = 128); then each model served at full width,
   depth cut to SSM_LAYERS (12 of 48 and 8 of 32 layers; bf16, seed 0,
   rate 0.6, 4 bins, B = 4 x 32, 16 new tokens): 408 and 1224 kernel-1
   launches a ``generate`` asserted, warm times and busy shares, every layer's mixer
   packed vs masked-dense on one input (yi-9b's bounds), whole-model
   logits held to the bf16 noise floor (BF16_NOISE_FACTOR times the
   masked-dense bf16 model's distance to the fp32 one), a dropped bin
   of ssm/in_proj (mamba2) or ssm/out_proj (hymba) breaking both; at 2
   fp32 layers (TF32 off) logits and greedy tokens packed vs
   masked-dense, and ``decode_step`` after ``prefill`` of S - 1 tokens vs
   ``forward`` of S at position S - 1, each with a planted fault (a
   dropped bin; a zeroed SSM state, or hymba's state taken from the
   layer output as the reference's prefill takes it); peak memory.
   Kernel 1's JSON entry carries an ``ssm`` branch.
9. The paper's scheme mapping (after the VGG_TINY phases): yi-9b at full
   width (depth ``--layers``) mapped by ``map_rules`` (B x S tokens,
   dataset_hard, compression 1 / (1 - 0.6), V5E) and served under those
   picks: magnitude block masks at each rule's own block on the rules
   ``compile_model`` packs, every layer quantized as picked, the
   ``generate`` counted; bf16 prefill logits against masked-dense on the
   dequantized weights and the fp32 model at 2 layers (logits, greedy
   tokens), each with a dropped bin breaking its bound.  Kernel 1 vs its
   plain version at each mapped block and projection shape (CHECK_M,
   float and int8, bitwise across the reorder), and timed at decode and
   prefill.  VGG_TINY mapped with dataset_hard True (pattern) and False
   (block-punched), masks built as the reference's serving callers build
   them, served and gated as in step 5, each packed layer's kernel vs
   plain at its block and precision and timed.  Then the latency model
   against the card (modelled V5E ms beside measured ms for every served
   layer) and the picks of a target calibrated to this run's rates,
   printed.  Kernels' JSON entries carry a ``mapped`` branch.  Each
   phase's start is stamped (seconds into the run).
10. The continuous-batching engine (``serve.engine.ServingEngine``,
   ``[engine]`` lines), run inside the yi-9b, mixtral-8x7b and hymba-1.5b
   serve phases on the params each already holds: ENGINE_SLOTS = 8
   slots, rings of 64, ENGINE_REQUESTS = 16 prompts of 32 and 16 tokens
   in turn, N_NEW tokens each, the step captured once an engine as a
   CUDA graph (one capture asserted).  Gates, each with a planted fault
   on yi-9b that must break it: the first step replayed from the graph
   == the eager ``decode_step_ragged`` on a copy of the same cache,
   bitwise (a cache rebound instead of written in place); each slot's
   first-step bf16 logits within LOGIT_MAX_REL / LOGIT_MEAN_REL of a
   B = 1 ``decode_step`` of its request (the prefill written into the
   neighbour's row); kernel-1 launches of an eager step == layers x
   packed projections (``down`` served dense); a slot poisoned with NaN
   quarantined alone, every other request's tokens unchanged (a second
   slot poisoned); at 2 fp32 layers (TF32 off; yi-9b's the int8 gate's
   compile) the engine's tokens == one B = 1 ``generate`` per request
   (keys and values written one ring index late).  Then the counted
   saturated run (all 16 at step 0; launches == (warm-up + replayed
   steps) x the step's + admissions' prefills: a capture records the
   step's launches without running them, and the engine counts them once
   a replay, where they run), a decode-only step's wall
   ms, tok/s, mean occupancy, the busy share of one traced replayed step
   beside ``generate``'s B = 4 step, the admission ms, and for yi-9b the
   open-loop run at one arrival a step.  Kernel 1's JSON entry carries an
   ``engine`` branch (M = 8: a yi-9b layer's time, bound and library
   call, each engine's launches a step and step ms).
11. The paper's prune-and-train pipeline (``[train]`` lines, after the
   yi-9b serve phase frees its state): yi-9b at full width (depth
   ``--layers``), bf16 params, fp32 AdamW state, every layer
   checkpointed, trained by ``core.pruner.reweighted_prune`` on the
   port's synthetic batches (TRAIN_B x TRAIN_S tokens; the train CLI's
   spec: ``map_rules`` snapped to (8, 16) blocks; TRAIN_STEPS reweighted
   steps, alphas every TRAIN_REWEIGHT_EVERY, one global threshold at
   TRAIN_RATE, TRAIN_FINETUNE masked steps), then compiled and served
   through kernel 1 at the trained masks.  Printed: each stage's first
   and last loss, a warm step's median ms and tokens/s, the busy share
   of one traced step, the ms of ``update_alphas``, ``global_threshold``
   and ``masks_for_spec(threshold=)``, density and compression, the
   packed projections, prefill and decode ms, peak memory.  Gates, each
   with a planted fault that must break it: every loss finite; no pruned
   weight nonzero (a step without masks); the share of normalised groups
   below tau within THRESHOLD_SHARE_TOL of TRAIN_RATE (tau halved); a
   packed projection with a dead block in every layer (layer 0's blocks
   all live); kernel-1 launches of the counted ``generate`` (wo served
   dense); bf16 prefill logits and each layer's attention and FFN packed
   vs masked-dense (a dropped bin); at 2 fp32 layers the same and the
   greedy tokens (a dropped bin); the loss and grads of yi-9b and
   mixtral-8x7b SMOKE on the card vs the CPU (the penalty dropped).
   Kernel 1 vs plain at (8, 16) on yi-9b's shapes, and timed on the
   trained layouts; its JSON entry carries a ``trained`` branch.
12. Robustness (``[robustness]`` lines, right after the yi-9b serve
   phase, on its masked bf16 params compiled again with
   ``keep_dense=True``, which shares their dense tensors): the ms of
   ``core.validate.validate_tree`` over the 7 packed stacks; a validated
   ``ServingEngine`` on the clean tree retires nothing;
   ``testing.faults.bitflip_packed_leaf(seed=0)`` saturates one bf16
   value of ffn/down and the validated engine retires that stack to
   masked-dense: 1 degraded layer, kernel-1 launches a step (eager and
   replayed) = layers x 6, each slot's first-step logits within
   LOGIT_MAX_REL / LOGIT_MEAN_REL of the clean engine's, the corrupt
   tree served with ``validate=False`` breaking that bound (NaN reaches
   the logits); the counted saturated run of the degraded engine (its
   launches asserted) and its step ms beside the clean engine's; at 2
   fp32 layers the degraded engine's tokens == one B = 1 ``generate``
   over its own degraded tree.  The artifact store in a temporary
   directory: ``compile_model(artifact_dir=)`` cold (packs, publishes)
   and warm (loads, checksums, validates, grafts; no pack) timed with
   the digest's share and the MiB on disk, warm layouts == cold leaf for
   leaf, greedy ``generate`` of the B x S prompts identical with equal
   kernel-1 launches, then ``crash_publish(stage="torn")`` and the next
   compile logs its ``[corrupt]`` fallback and repacks.  Last VGG_TINY
   punched (B = CONV_B, fp32) with its seed-0 bit-flipped layer (c6)
   retired: logits within CONV_LOGIT_REL of masked-dense, kernel 3
   launched once fewer a forward than the clean layouts imply, the
   unvalidated corrupt tree breaking the bound with non-finite logits
   (the kernels' fused relu passes NaN on, as torch's does).  Kernel 1's
   ``launches_by_path`` gains "yi-9b degraded engine" and "yi-9b
   warm-start generate", the conv kernels' the retired forward; the
   numbers go under ``"robustness"`` in ``build/chip_smoke.json``.
13. Tensor-parallel layouts on one card (``[tensor_parallel]`` lines,
   right after robustness, on the serve phase's masked yi-9b): kernel 1
   through the shard wrapper ``bsr_matmul_sharded`` at yi-9b's 7
   projection shapes, S = 2, 4, 8, M = 4 and 128, bf16 x with float and
   int8 values (fp32 at S = 4, M = 4), bias + silu, against its sharded
   plain version at the kernel bounds and against the unsharded kernel
   on the same weights (bitwise where the two take a column's slots in
   the same chunks); kernel 2 through ``tap_gather_conv_sharded`` at
   VGG_TINY c5 (pattern), S = 2 and 4, float and int8; a planted fault
   (shard 0's column table shifted) breaking each bound.  A yi-9b layer
   timed at S = TP against unsharded (decode and prefill, L2 flushed),
   each projection's executed blocks, L_effective and shard_balance;
   kernel 2 at c5 timed beside ``F.conv2d``.  yi-9b served at
   ``CompileSpec(tp=4)``: every row 4 shards, the counted ``generate``
   (952 sharded kernel-1 launches, none unsharded) giving the unsharded
   tree's tokens, prefill logits within 5 % / 2 % of masked-dense (a
   shifted shard of ffn/down breaking it), a validated ``ServingEngine``
   (one capture, replay == eager bitwise, 56 launches a step, the
   counted saturated run and its step ms).  VGG_TINY at tp = 2, both
   mappings: the punched forward through im2col + kernel 1, the pattern
   forward through kernel 2, launches from the layouts, logits within
   CONV_LOGIT_REL of the unsharded forward.  A replica restart in a
   temporary directory (yi-9b at full width, TP_CKPT_LAYERS layers):
   ``checkpoint.save`` / ``restore`` timed with the MiB on disk, then
   ``replica_restore(spec=CompileSpec(tp=4), artifact_dir=)`` cold and
   warm (no pack), warm == cold leaf for leaf, equal greedy tokens.  The
   train CLI at yi-9b SMOKE on the card: 6 steps against 4 (saving every
   2) + ``--resume``, the resumed losses within TP_RESUME_REL of the
   uninterrupted ones (a resume that runs the saved step again, as the
   reference's does, breaking it).  The two shard wrappers join the
   kernels line (``launches_by_path``: "yi-9b tp=4 generate", "yi-9b
   tp=4 engine", the VGG forwards); the numbers go under
   ``"tensor_parallel"`` in ``build/chip_smoke.json``.
14. The dry run (``[dryrun]`` lines, last): the production cells of
   ``launch/dryrun.py`` (DRYRUN_CELLS: yi-9b train_4k / prefill_32k /
   decode_32k on the (16, 16) mesh and decode_32k on (2, 16, 16),
   long_500k's SKIP, mixtral-8x7b decode_32k, mamba2-1.3b long_500k),
   each a ``python -m repro_torch.launch.dryrun`` process of its own,
   all started together (a fake group of 256 / 512 ranks cannot share a
   process with a NCCL group): each record OK (or the reference's SKIP),
   its per-device FLOPs, bytes, collective bytes by op and by the site
   that asked for them, peak memory and trace seconds printed, then
   ``launch.roofline_report``'s table priced for the H100's datasheet.
   Then (not meanwhile: each of those processes opens a CUDA context,
   which fails while a one-card cell holds the card), on a one-rank mesh
   (``make_local_mesh``), CARD_CELLS at sizes one card holds (yi-9b at
   full width with 2 of 48 layers: decode_32k at B = 128 over a 32768
   cache, prefill_32k at B = 1 of 32, train_4k at B = 8 of 256;
   mamba2-1.3b at full width and depth, long_500k) run under fake
   tensors and for real: the fake FLOP count must equal the real run's
   ``FlopCounterMode`` count exactly and the warm step time must be at
   least the roofline's compute term; measured / memory term and the
   dry run's peak against ``max_memory_allocated`` are printed.

15. The rest of the reference's surface (right after the mesh phase, on
   the serve phase's masked yi-9b, ``surface_phase``): ``core.bcs``'s
   BCS format on the card for each of layer 0's 7 projections
   (``to_dense`` == the masked weight and ``pad_to_uniform_csc`` == its
   host loop, bitwise; nnzb, density, hierarchical index bytes against
   plain CSR's, ``load_imbalance``, L_max against the 4-bin layout's
   per-bin L), and the same for the trained (8, 16) masks inside the
   train phase (layers 0 and last); kernel 1's raw entry
   (``kernels.bsr_matmul.bsr_matmul``) over ``pad_to_uniform_csc`` vs
   plain at CHECK_M (bf16, fp32) and bitwise vs the reordered layout,
   int8 a block and a column, ``out_dtype=float32``; its counted run (the
   layer at decode, 7 launches) and its time at SURFACE_M beside the
   reordered layout (the paper's Fig 4 claim on the card),
   ``torch.matmul`` and the bound; kernel 2's raw entry at VGG_TINY c5
   (pattern) vs plain and bitwise vs the packed entry, counted, timed;
   the pack cache over two 8-layer ``compile_model`` calls (the byte
   bound set to hold the first, printed; the second all hits on the same
   layout objects, equal trees and greedy tokens, its ``generate``
   counted: 952 launches; the digests' ms beside the packs'; the default
   bounds restored and their evictions; a fault injected on a cached
   layout caught while the cache's copy validates); ``generate`` and
   ``generate_python`` at temperature 0.7 on generators seeded 0, the
   same tokens.  Two rows join the kernels line: ``bsr_matmul_raw`` and
   ``tap_gather_conv_raw``.

No phase is caught: any failure exits non-zero.  The last two lines are
the kernels JSON and ``{"ok": true, "device": {...}}``.  Full detail goes
to ``build/chip_smoke.json`` (``build/`` is not versioned).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import logging
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# H100 SXM published peaks (NVIDIA data sheet): HBM bytes/s, dense bf16
# tensor-core FLOP/s (the timed yi-9b calls are bf16), fp32 outside the
# tensor cores (the conv kernels' fp32 FMAs)
HBM_BYTES_PER_S = 3.35e12
BF16_PEAK_FLOPS = 989e12
FP32_PEAK_FLOPS = 67e12

# (name, K, N, epilogue activation) of the 7 projections of a yi-9b layer
D, DKV, DFF = 4096, 512, 11008
PROJECTIONS = [("wq", D, D, "none"), ("wk", D, DKV, "none"),
               ("wv", D, DKV, "none"), ("wo", D, D, "none"),
               ("gate", D, DFF, "silu"), ("up", D, DFF, "none"),
               ("down", DFF, D, "none")]
BLOCK = (16, 16)
PRUNE_RATE = 0.6
N_BINS = 4
FP32_TOL = 1e-4          # rtol = atol for fp32 outputs vs the plain version
# bf16 prefill logits, packed vs masked-dense on the card: the two round
# at different places (fused silu, fp32 sum order before each rounding).
# On an H100 the sound path reads about 0.008 on both and every fault of
# ``planted_faults`` 0.28 or more (PERF.md); the limits sit between.
LOGIT_MAX_REL = 0.05     # max |diff| <= this * max |dense logit|
LOGIT_MEAN_REL = 0.02    # mean |diff| <= this * mean |dense logit|
B, S, N_NEW = 4, 32, 16  # prompts, prompt length, new tokens
# kernel 1's M cases: decode, the engine's step (ENGINE_SLOTS rows) and
# prefill, and the edges of bsr_plan's M tiles (16, 32, 128 rows; two
# tiles past 128)
CHECK_M = (1, 4, 8, 15, 16, 17, 128, 129)

# the CNN path: VGG_TINY on CIFAR-10-shaped images
CONV_RE = r"(^|/)(c|pw|dw)\d+/w"
CONV_B, CONV_HW = 256, 32
# fp32 logits, packed vs masked-dense on the card (TF32 off on both): the
# two differ only in the fp32 summation order; a fault (a dropped bin of
# c6) moves them by a sizeable share of max |logit| (PERF.md)
CONV_LOGIT_REL = 1e-3    # max |diff| <= this * max |dense logit|
KERNEL_FILES = {"bsr_matmul": "bsr_matmul.cu", "tap_gather": "tap_gather.cu"}
# the MoE path: mixtral-8x7b's expert stacks.  Kernel 1's M cases over the
# experts: decode (4), the engine's step (8 slots x capacity 1 at
# group=1), prefill (40 = the capacity of one 128-token group), and
# bsr_plan's M-tile edges around them
MOE_CHECK_M = (1, 4, 8, 15, 16, 17, 40, 64, 65)
MOE_LAYERS = 4           # depth cut of the bf16 serve (width is never cut)
MOE_FP32_LAYERS = 2
# fp32 logits, packed vs masked-dense on the card (TF32 off): the two
# differ in fp32 sum order only, far too little to flip a router choice
# short of a near-exact tie; a fault moves the logits by a sizeable share
# of max |logit| (PERF.md)
MOE_FP32_LOGIT_REL = 1e-3
DEV = "cuda"             # the conv phases' device
# the continuous-batching engine: slots (kernel 1 runs every packed
# projection of its step at M = ENGINE_SLOTS), each slot's ring capacity,
# and the workload: ENGINE_REQUESTS prompts of ENGINE_PROMPTS tokens in
# turn (the reference CLI's long and short buckets), N_NEW tokens each
ENGINE_SLOTS, ENGINE_SEQ_CAP, ENGINE_REQUESTS = 8, 64, 16
ENGINE_PROMPTS = (32, 16)
# when the run started and when each phase began (``stamp``)
RUN = {"t0": time.perf_counter(), "phase_s": {}}


def stamp(phase):
    """Record and print when ``phase`` starts (seconds into the run)."""
    RUN["phase_s"][phase] = time.perf_counter() - RUN["t0"]
    print(f"[{RUN['phase_s'][phase]:.1f} s] {phase}", flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def sync():
    torch.cuda.synchronize()


def time_ms(fn, iters, flush, graph=True):
    """Median milliseconds of ``fn`` by CUDA events, L2 flushed before
    each run (in the served model every projection's weights arrive cold:
    the other layers' weights pass through L2 in between); ``flush`` None
    leaves L2 as the previous run left it (warm).  With ``graph``
    the work is captured once in a CUDA graph and replayed, so the events
    time the device work alone; without it they also time the gaps in
    which the card waits for the host to send the next launch."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    run = fn
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            fn()
        run = g.replay
    events = []
    for _ in range(iters):
        if flush is not None:
            flush.zero_()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        run()
        e.record()
        events.append((s, e))
    sync()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def bf16_ulp(p):
    """One bf16 ulp at the magnitude of each fp32 value."""
    _, e = torch.frexp(p.abs().clamp_min(2.0 ** -126))
    return torch.ldexp(torch.ones_like(p), (e - 8).to(torch.int32))


def out_of_tol(y, want, dtype):
    """(elements out of the kernel-vs-plain bound, max abs error, first
    offender's error, its tolerance): rtol = atol = FP32_TOL in fp32, 1
    bf16 ulp (+ FP32_TOL near zero) in bf16."""
    err = (y.float() - want).abs()
    if dtype == torch.float32:
        tol = FP32_TOL + FP32_TOL * want.abs()
    else:
        tol = bf16_ulp(want) + FP32_TOL * (1 + want.abs())
    bad = (err > tol).flatten()
    i = int(bad.nonzero()[0]) if bad.any() else 0
    return (int(bad.sum()), err.max().item(), err.flatten()[i].item(),
            tol.flatten()[i].item())


def check_close(y, want, dtype, what):
    """Kernel output against its fp32 plain version within ``out_of_tol``'s
    bound.  Returns the max abs error."""
    n, err, first, tol = out_of_tol(y, want, dtype)
    if n:
        raise AssertionError(f"{what}: {n} elements out of tolerance, "
                             f"first {first} > {tol}")
    return err


def weight_and_mask(RW, K, N, gen, dtype, block=BLOCK):
    w = (torch.randn(K, N, generator=gen, device=DEV) * K ** -0.5).to(
        dtype)
    spec = [(r"w$", RW.SchemeChoice("block", block))]
    mask = RW.magnitude_block_masks({"w": w}, spec, None,
                                    rate=PRUNE_RATE)["w"]
    return w, mask


def kernel1_cases(mods, gen, shapes, layouts, acts, block=BLOCK,
                  Ms=CHECK_M):
    """Kernel 1 vs its plain version at every (K, N) of ``shapes`` and M of
    ``Ms``, fp32 and bf16, weights masked in ``block`` blocks:
    ``layouts(w, mask)`` gives the (label, reordered, unreordered) layouts
    of a weight, ``acts`` the (activation, with bias) cases; reordered ==
    unreordered bitwise.  Returns (cases, max abs error)."""
    RW, ref, K = mods["RW"], mods["ref"], mods["K"]
    checks, max_err = 0, 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for (Kd, Nd) in shapes:
            w, mask = weight_and_mask(RW, Kd, Nd, gen, dtype, block)
            for label, reord, unre in layouts(w, mask):
                for M in Ms:
                    x = torch.randn(M, Kd, generator=gen, device=DEV).to(
                        dtype)
                    b = (torch.randn(Nd, generator=gen, device=DEV)
                         * 0.1).to(dtype)
                    for act, with_bias in acts:
                        bias = b if with_bias else None
                        want = ref.bsr_matmul_packed_ref(
                            x.float(), reord,
                            None if bias is None else bias.float(), act)
                        y_re = K.bsr_matmul_packed(x, reord, bias, act)
                        y_un = K.bsr_matmul_packed(x, unre, bias, act)
                        sync()
                        what = (f"K={Kd} N={Nd} M={M} {dtype} {label} "
                                f"act={act} bias={with_bias}")
                        if not torch.equal(y_re, y_un):
                            raise AssertionError(f"reordered != unreordered "
                                                 f"bitwise at {what}")
                        max_err = max(max_err, check_close(
                            y_re, want, dtype, f"kernel vs plain at {what}"))
                        checks += 1
            del w, mask
    return checks, max_err


def kernel1_shapes():
    """The (K, N) kernel 1 is checked at outside the expert stacks: yi-9b's
    projections and mixtral-8x7b's attention (its experts are checked in
    the MoE phases)."""
    return sorted({(k, n) for _, k, n, _ in PROJECTIONS}
                  | attention_shapes(moe_config()))


def kernel_phase(mods, flush):
    """Kernel vs plain at every main-path shape; timings in bf16."""
    RW, ops = mods["RW"], mods["ops"]
    gen = torch.Generator(device=DEV)
    gen.manual_seed(0)
    shapes = kernel1_shapes()
    checks, max_err = kernel1_cases(
        mods, gen, shapes,
        lambda w, mask: [("float", ops.pack(w, mask, BLOCK, reorder=True,
                                            n_bins=N_BINS),
                          ops.pack(w, mask, BLOCK))],
        (("none", False), ("none", True), ("silu", True), ("relu", True)))
    print(f"kernel vs plain: {checks} cases at (K, N) in {shapes} (yi-9b's "
          f"projections, mixtral-8x7b's attention), M in {CHECK_M}, bf16 + "
          f"fp32, bias with none/silu/relu, reordered == unreordered "
          f"bitwise; max abs err {max_err:.3e}")

    def make(name, Kd, Nd):
        w, mask = weight_and_mask(RW, Kd, Nd, gen, torch.bfloat16)
        return (ops.pack(w, mask, BLOCK, reorder=True, n_bins=N_BINS),
                w * mask.to(w.dtype))
    rows = kernel1_timings(mods, gen, flush, PROJECTIONS,
                           (4, ENGINE_SLOTS, 128), make)
    print_timings("main-path timings (bf16, L2 flushed, median ms; device "
                  "time by CUDA-graph replay, and the kernel's eager call "
                  "for the host's share; stream = one torch sum over the "
                  "bound's bytes, same flush):", rows,
                  "torch.matmul", "yi-9b layer (7 projections)",
                  ((4, "decode"), (ENGINE_SLOTS, "the engine's step"),
                   (128, "prefill")))
    return rows, max_err


def kernel1_bytes(lay):
    """Bytes kernel 1 must read of a layout's weights: each live block's
    values and k_idx, and with int8 values its scale ("block") or each
    block column's ("out")."""
    bk, bn = lay.block
    nnzb = int(lay.nnz.sum())
    es = lay.values[0].element_size()
    gran = lay.scale_granularity
    return (nnzb * (bk * bn * es + 4 + (4 if gran == "block" else 0))
            + (4 * lay.nnz.numel() if gran == "out" else 0))


def kernel1_timings(mods, gen, flush, projs, Ms, make, E=None):
    """Kernel 1 timed at each (name, K, N, act) of ``projs`` and M of
    ``Ms``, bf16 x: ``make(name, K, N)`` gives (layout, masked dense
    weight), an (E, K, N) expert stack (one launch a projection, beside
    ``torch.bmm``) when E is given, else one projection (beside
    ``torch.matmul``).  The bound from ``kernel1_bytes`` and the x and
    out bytes; stream = one torch sum over as many bytes."""
    ops, ref, K = mods["ops"], mods["ref"], mods["K"]
    rows, stream_buf = [], None
    for name, Kd, Nd, act in projs:
        lay, dense = make(name, Kd, Nd)
        nnzb = int(lay.nnz.sum())
        for M in Ms:
            x = torch.randn((M, Kd) if E is None else (E, M, Kd),
                            generator=gen, device=DEV).to(torch.bfloat16)
            nbytes = kernel1_bytes(lay) + (E or 1) * M * (Kd + Nd) * 2
            if stream_buf is None or stream_buf.numel() < nbytes // 2:
                stream_buf = torch.ones(nbytes // 2, dtype=torch.bfloat16,
                                        device=DEV)
            stream_ms = time_ms(lambda: stream_buf[:nbytes // 2].sum(), 30,
                                flush)
            plain = (ref.bsr_matmul_sharded_ref if lay.n_shards
                     else ref.bsr_matmul_packed_ref)
            if E is None:
                fns = (lambda: K.bsr_matmul_packed(x, lay, None, act),
                       lambda: plain(x, lay, None, act),
                       lambda: torch.matmul(x, dense))
            else:
                fns = (lambda: ops.sparse_expert_linear(x, lay, act=act),
                       lambda: ref.bsr_matmul_experts_ref(x, lay, None, act),
                       lambda: torch.bmm(x, dense))
            rows.append(timed_row(
                *fns, stream_ms, nbytes, 2 * M * nnzb * math.prod(lay.block),
                flush, proj=name, M=M, K=Kd, N=Nd, act=act,
                dtype="bfloat16", values=lay.value_dtype,
                density=lay.density, executed_frac=1 - lay.flops_saved,
                bins=lay.n_bins, shards=lay.n_shards,
                **({} if E is None else {"E": E})))
        del lay, dense
    del stream_buf
    return rows


def timed_row(kernel_fn, plain_fn, lib_fn, stream_ms, nbytes, flops, flush,
              **meta):
    """One projection's timing row (median ms, L2 flushed): the kernel by
    CUDA-graph replay (device time) and eager (with the host's share), its
    plain version, the library call, and the bound from ``nbytes`` at the
    HBM rate and ``flops`` at the bf16 peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_PEAK_FLOPS * 1e3
    return dict(meta, ms=time_ms(kernel_fn, 30, flush),
                eager_ms=time_ms(kernel_fn, 30, flush, graph=False),
                plain_ms=time_ms(plain_fn, 3, flush),
                library_ms=time_ms(lib_fn, 30, flush), stream_ms=stream_ms,
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes_ms=t_bytes, ops_ms=t_ops, bytes=nbytes, flops=flops)


def print_timings(title, rows, lib, layer, Ms):
    """The timing rows as a table, then their sums over a layer at each
    M of ``Ms`` ((M, what) pairs)."""
    print(title)
    print(f"  {'proj':8s} {'M':>4s} {'kernel':>9s} {'eager':>9s} "
          f"{'bound':>9s} {'stream':>9s} {'plain':>9s} {lib:>12s}  "
          f"bound_by")
    for r in rows:
        print(f"  {r['proj']:8s} {r['M']:4d} {r['ms']:9.4f} "
              f"{r['eager_ms']:9.4f} {r['bound_ms']:9.4f} "
              f"{r['stream_ms']:9.4f} {r['plain_ms']:9.4f} "
              f"{r['library_ms']:12.4f}  {r['bound_by']}")
    for M, what in Ms:
        t = layer_sum(rows, M)
        print(f"  one {layer} at {what} (M = {M}): kernel {t['ms']:.4f} ms, "
              f"{lib} {t['library_ms']:.4f}, bound {t['bound_ms']:.4f} "
              f"({t['bound_by']}), stream {t['stream_ms']:.4f}, plain "
              f"{t['plain_ms']:.3f}")


def layer_sum(rows, M):
    """Kernel 1's timing rows at one M summed over a layer's projections;
    the bound from the summed bytes and operations."""
    sel = [r for r in rows if r["M"] == M]
    t_bytes = sum(r["bytes_ms"] for r in sel)
    t_ops = sum(r["ops_ms"] for r in sel)
    return {"ms": sum(r["ms"] for r in sel),
            "eager_ms": sum(r["eager_ms"] for r in sel),
            "plain_ms": sum(r["plain_ms"] for r in sel),
            "library_ms": sum(r["library_ms"] for r in sel),
            "stream_ms": sum(r["stream_ms"] for r in sel),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def logit_gap(dense, packed):
    """(max |diff| / max |dense|, mean |diff| / mean |dense|) of two logit
    tensors."""
    d, s = dense.float(), packed.float()
    diff = (d - s).abs()
    return (diff.max().item() / d.abs().max().item(),
            diff.mean().item() / d.abs().mean().item())


def within_bound(gap):
    return gap[0] <= LOGIT_MAX_REL and gap[1] <= LOGIT_MEAN_REL


def with_layout(params, group, name, layout):
    """``params`` with the packed layout of one projection replaced (the
    other leaves shared, not copied)."""
    layers = dict(params["layers"])
    layers[group] = dict(layers[group])
    layers[group][name] = dict(layers[group][name], packed=layout)
    return dict(params, layers=layers)


def planted_faults(params):
    """(name, params) pairs, each the compiled model with one fault a broken
    packer or launch loop could make."""
    down = params["layers"]["ffn"]["down"]["packed"]
    wo = params["layers"]["attn"]["wo"]["packed"]
    no_last = down.values[:-1] + (torch.zeros_like(down.values[-1]),)
    first_only = down.values[-1].clone()
    first_only[0] = 0
    perm = wo.perm.clone()
    perm[:, [0, 1]] = perm[:, [1, 0]]
    return [
        ("down: last bin dropped, every layer",
         with_layout(params, "ffn", "down",
                     dataclasses.replace(down, values=no_last))),
        ("down: last bin dropped, layer 0 only",
         with_layout(params, "ffn", "down", dataclasses.replace(
             down, values=down.values[:-1] + (first_only,)))),
        ("wo: two block columns swapped, every layer",
         with_layout(params, "attn", "wo",
                     dataclasses.replace(wo, perm=perm))),
    ]


def device_time(fn, warm=None):
    """Trace ``fn`` with ``torch.profiler``: the card's busy milliseconds
    (union of the intervals of every kernel and copy it ran), the share of
    them in the BCS kernels (``bsr_matmul_kernel``, ``bsr_conv_kernel``:
    kernels 1 and 3) and in the tap kernel (``tap_conv_kernel``: kernels
    2 and 4), each kernel's own time and traced
    launches, and the number of device events; None when the profiler saw
    no device activity.  ``warm`` (default ``fn``) runs first in the same
    trace and only the device events of ``fn``'s run after it are read: a
    trace can lose the first device events after the profiler starts."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        (warm or fn)()
        sync()
        with record_function("device_time: read"):
            fn()
            sync()
    events = prof.events()
    t0 = min(e.time_range.start for e in events
             if e.name == "device_time: read")
    # the mark's own device-side range spans the whole run, gaps included
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in events
                   if e.device_type == DeviceType.CUDA
                   and e.time_range.start >= t0
                   and e.name != "device_time: read")
    if not spans:
        return None
    busy, lo, hi = 0.0, spans[0][0], spans[0][1]
    for a, b, _ in spans[1:]:
        if a > hi:
            busy += hi - lo
            lo = a
        hi = max(hi, b)
    busy += hi - lo
    bsr = sum(b - a for a, b, n in spans if "bsr_" in n)
    tap = sum(b - a for a, b, n in spans if "tap_" in n)
    names = ("bsr_matmul_kernel", "bsr_conv_kernel", "tap_conv_kernel")
    by_kernel = {k: [b - a for a, b, n in spans if k in n] for k in names}
    return {"busy_ms": busy / 1e3, "bsr_ms": bsr / 1e3, "tap_ms": tap / 1e3,
            "by_kernel_ms": {k: sum(v) / 1e3 for k, v in by_kernel.items()
                             if v},
            "by_kernel_events": {k: len(v) for k, v in by_kernel.items()
                                 if v},
            "events": len(spans)}


def build_masked(mods, cfg, dtype, rules=None):
    """Seeded init at ``cfg`` on the card and magnitude block masks at
    PRUNE_RATE, each rule at its own block (``rules``, default the serving
    CLI's): (masked-dense params, masks, seconds)."""
    T, RW = mods["T"], mods["RW"]
    from repro_torch.launch.serve import SPARSE_SPEC
    from repro_torch.train.trainer import apply_masks
    t0 = time.perf_counter()
    params = T.init_lm(cfg, seed=0, dtype=dtype, device=DEV)
    masks = RW.magnitude_block_masks(params, rules or SPARSE_SPEC, None,
                                     rate=PRUNE_RATE)
    pm = apply_masks(params, masks)
    del params
    sync()
    return pm, masks, time.perf_counter() - t0


def compile_timed(mods, pm, masks, rules, **spec):
    """``compile_model(keep_dense=False, **spec)`` on the card: (compiled
    params, report, seconds)."""
    C = mods["C"]
    sync()
    t0 = time.perf_counter()
    exec_p, report = C.compile_model(
        pm, masks, rules, spec=C.CompileSpec(keep_dense=False, **spec),
        device=DEV)
    sync()
    return exec_p, report, time.perf_counter() - t0


def build_served(mods, cfg, dtype):
    """``build_masked``, then ``compile_model(keep_dense=False)``:
    (masked-dense params, compiled params, report, init + masks s,
    compile s, masks)."""
    from repro_torch.launch.serve import SPARSE_SPEC
    pm, masks, init_s = build_masked(mods, cfg, dtype)
    exec_p, report, compile_s = compile_timed(mods, pm, masks, SPARSE_SPEC)
    return pm, exec_p, report, init_s, compile_s, masks


def serve_counted(mods, exec_p, cfg, full, compile_s, how, per_layer=7,
                  frontend=None, want=None):
    """The main path: greedy ``generate`` of B prompts of S tokens (and
    the encdec / vlm ``frontend``), the kernel counts set to 0 just before
    and read just after, kernel 1 held to ``want`` launches (default
    layers x ``per_layer`` packed projections x (1 + N_NEW) forwards);
    then warm prefill and generate wall times and one traced prefill and
    ``generate`` (the card's busy share).  Returns (e2e, launches, prompts,
    tokens)."""
    E, K = mods["E"], mods["K"]
    prompts = np.random.RandomState(0).randint(0, cfg.vocab, size=(B, S))
    tokens = torch.as_tensor(prompts, device=DEV)
    K.reset_launches()
    sync()
    t0 = time.perf_counter()
    with torch.no_grad():
        out = E.generate(exec_p, cfg, prompts, N_NEW, device=DEV,
                         frontend=frontend)
    sync()
    gen_s = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    if want is None:
        want = cfg.n_layers * per_layer * (1 + N_NEW)
        how = (f"layers {cfg.n_layers} x {per_layer} projections x "
               f"(1 + {N_NEW}) forwards = {want}, {how}")
    print(f"generate {tuple(out.shape)}: bsr_matmul launches "
          f"{launches['bsr_matmul']} (expected {how})")
    if launches["bsr_matmul"] != want:
        raise AssertionError("the main path did not go through the kernel "
                             "the expected number of times")
    if tuple(out.shape) != (B, N_NEW) or not (
            (out >= 0) & (out < cfg.vocab)).all():
        raise AssertionError(f"bad generate output {out}")

    def prefill():
        return E.prefill(exec_p, cfg, tokens, frontend)

    def generate():
        return E.generate(exec_p, cfg, prompts, N_NEW, device=DEV,
                          frontend=frontend)
    with torch.no_grad():
        for _ in range(2):
            prefill()
        sync()
        t0 = time.perf_counter()
        prefill()
        sync()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        generate()
        sync()
        gen_warm_s = time.perf_counter() - t0
        dev_prefill = device_time(prefill)
        # warmed by a prefill: a second generate doubles a long trace
        dev_gen = device_time(generate, warm=prefill)
    decode_ms = (gen_warm_s * 1e3 - prefill_ms) / N_NEW
    e2e = {"layers": cfg.n_layers, "of_layers": full.n_layers, "batch": B,
           "prompt": S, "new_tokens": N_NEW, "compile_s": compile_s,
           "first_generate_s": gen_s, "generate_s": gen_warm_s,
           "prefill_ms": prefill_ms, "decode_ms_per_token": decode_ms,
           "tok_per_s": B * N_NEW / gen_warm_s, "launches": launches,
           "sample": out[0].tolist(), "tokens": out.tolist()}
    print(f"prefill {prefill_ms:.2f} ms (B {B} x {S}); decode "
          f"{decode_ms:.3f} ms/token step; generate {gen_warm_s:.3f}s = "
          f"{e2e['tok_per_s']:.1f} tok/s (warm; first call {gen_s:.3f}s)")
    print("sample:", out[0].tolist())
    if dev_prefill is None or dev_gen is None:
        print("device busy share: not measured (the profiler saw no "
              "device activity)")
    else:
        step_busy = (dev_gen["busy_ms"] - dev_prefill["busy_ms"]) / N_NEW
        step_bsr = (dev_gen["bsr_ms"] - dev_prefill["bsr_ms"]) / N_NEW
        e2e["device"] = {
            "prefill": dev_prefill, "generate": dev_gen,
            "prefill_busy_share": dev_prefill["busy_ms"] / prefill_ms,
            "decode_step_busy_ms": step_busy,
            "decode_step_bsr_ms": step_bsr,
            "decode_busy_share": step_busy / decode_ms}
        print(f"device busy (torch.profiler, against the unprofiled wall "
              f"times above): prefill {dev_prefill['busy_ms']:.3f} ms "
              f"({dev_prefill['bsr_ms']:.3f} in bsr_matmul) = "
              f"{e2e['device']['prefill_busy_share']:.3f} of its wall time; "
              f"decode step {step_busy:.3f} ms ({step_bsr:.3f} in "
              f"bsr_matmul) = {e2e['device']['decode_busy_share']:.3f}; "
              f"{dev_gen['events']} device events per generate")
    return e2e, launches, prompts, tokens


def serve_phase(mods, args):
    """Full-width yi-9b through the port's entry points.  Returns (e2e,
    launches, int8 launches, (masked params, masks, cfg, full cfg) for
    the robustness phase)."""
    C, E = mods["C"], mods["E"]
    from repro_torch import configs
    full = configs.get("yi-9b")
    cfg = full.replace(n_layers=args.layers)
    print(f"yi-9b at full width (d_model {cfg.d_model}, heads {cfg.n_heads}"
          f"/{cfg.n_kv_heads}, d_ff {cfg.d_ff}, vocab {cfg.vocab}); depth "
          f"cut to {cfg.n_layers} of {full.n_layers} layers")
    pm, exec_p, report, init_s, compile_s, masks = build_served(
        mods, cfg, torch.bfloat16)
    print(f"init + masks {init_s:.2f}s; compile_model {compile_s:.2f}s:")
    print(C.compiled_summary(report))
    layer = exec_p["layers"]
    n_bins = {layer[g][n]["packed"].n_bins
              for g, names in (("attn", ("wq", "wk", "wv", "wo")),
                               ("ffn", ("gate", "up", "down")))
              for n in names}
    if len(report.packed) != 7 or n_bins != {N_BINS}:
        raise AssertionError(f"expected 7 packed projections of {N_BINS} "
                             f"bins, got {len(report.packed)}, {n_bins}")
    e2e, launches, _, tokens = serve_counted(
        mods, exec_p, cfg, full, compile_s, f"one launch over the {N_BINS} "
        f"bins")

    with torch.no_grad():
        dense_logits, _ = E.prefill(pm, cfg, tokens)
        sparse_logits, _ = E.prefill(exec_p, cfg, tokens)
        gap = logit_gap(dense_logits, sparse_logits)
        faults = [(name, logit_gap(dense_logits, E.prefill(p, cfg,
                                                          tokens)[0]))
                  for name, p in planted_faults(exec_p)]
    sync()
    d, s = dense_logits.float(), sparse_logits.float()
    print(f"prefill logits packed vs masked-dense (bf16): max|diff| "
          f"{gap[0]:.4f} of max|logit|, mean |diff| {gap[1]:.4f} of mean "
          f"|logit| (bound {LOGIT_MAX_REL} / {LOGIT_MEAN_REL}); argmax "
          f"agree {(d.argmax(-1) == s.argmax(-1)).float().mean():.2f}")
    for name, g in faults:
        print(f"  planted fault, {name}: {g[0]:.4f} / {g[1]:.4f}"
              f"{'' if not within_bound(g) else '  (NOT CAUGHT)'}")
    e2e["logits_gap"] = gap
    e2e["planted_faults"] = dict(faults)
    if not (torch.isfinite(s).all() and within_bound(gap)):
        raise AssertionError("packed prefill logits disagree with the "
                             "masked-dense ones beyond the stated bound")
    missed = [name for name, g in faults if within_bound(g)]
    if missed:
        raise AssertionError(f"the logit bound does not catch: {missed}")
    del faults
    e2e["engine"] = engine_phase(
        mods, exec_p, cfg, "yi-9b", 7, dense_p=pm,
        generate_busy_share=e2e.get("device", {}).get("decode_busy_share"))
    del exec_p
    torch.cuda.empty_cache()
    e2e["int8"], launches8 = lm_int8_phase(mods, pm, masks, cfg, full,
                                           tokens)
    e2e["engine"]["fp32"] = e2e["int8"].pop("engine_fp32")
    return e2e, launches, launches8, (pm, masks, cfg, full)

# -- the CNN path: kernels 2-4 (kernel 3 also on im2col patches) ------------

def conv_mappings(RW):
    """(name, prune spec) of the two mappings of the CNN path."""
    return [
        ("punched", [(CONV_RE, RW.SchemeChoice("block_punched", (8, 8)))]),
        ("pattern", [(CONV_RE, RW.SchemeChoice("pattern",
                                               connectivity=0.5))])]


def conv_masks(RW, name, params, spec):
    if name == "punched":
        return RW.punched_conv_masks(params, spec, (8, 8), rate=0.5)
    return RW.masks_for_spec(params, spec)


def layer_inputs(arch, hw, B, C=3):
    """(name, kh, kw, stride, input shape (B, H, W, C)) of each layer of a
    conv arch at an hw x hw input."""
    from repro_torch.kernels.bsr_matmul import conv_geometry
    out, H = [], hw
    for (name, cout, kh, kw, stride, dw) in arch:
        out.append((name, kh, kw, stride, (B, H, H, C)))
        _, _, H, _ = conv_geometry(H, H, kh, kw, stride, "SAME")
        C = C if dw else cout
    return out


def conv_kernel_keys(layout):
    """(implicit kernel, materialized kernel) launch keys of a packed conv
    layout."""
    from repro_torch.core.packed import TapLayout
    if isinstance(layout, TapLayout):
        return "tap_gather_conv_implicit", "tap_gather_conv"
    return "bsr_conv2d_implicit", "bsr_conv2d_materialized"


def conv_cases(mods):
    """Every packed conv layer of the CNN path: (label, weight * mask,
    mask, kh, kw, stride, input shape, scheme) for VGG_TINY under both
    mappings and MOBILE_TINY's 5x5 c4 (connectivity 0.5)."""
    RW, CN = mods["RW"], mods["CN"]
    from repro_torch.train.trainer import apply_masks
    cases = []
    params = CN.convnet_init(CN.VGG_TINY, seed=0, device=DEV)
    for name, spec in conv_mappings(RW):
        masks = conv_masks(RW, name, params, spec)
        pm = apply_masks(params, masks)
        for lname, kh, kw, stride, shape in layer_inputs(CN.VGG_TINY,
                                                          CONV_HW, CONV_B):
            if masks[lname]["w"].ndim:
                cases.append((f"vgg/{lname}/{name}", pm[lname]["w"],
                              masks[lname]["w"], kh, kw, stride, shape,
                              name))
    mob = CN.convnet_init(CN.MOBILE_TINY, seed=0, device=DEV)
    spec = conv_mappings(RW)[1][1]
    masks = conv_masks(RW, "pattern", mob, spec)
    lname, kh, kw, stride, shape = layer_inputs(CN.MOBILE_TINY, 16,
                                                CONV_B)[-1]
    cases.append((f"mobile/{lname}/pattern", mob[lname]["w"] *
                  masks[lname]["w"], masks[lname]["w"], kh, kw, stride,
                  (CONV_B, 16, 16, 128), "pattern"))
    return cases


def conv_layouts(ops, BCS, wm, mask, kh, kw, scheme, reorder, dtype):
    w = wm.to(dtype)
    if scheme == "pattern":
        return ops.pack_taps(w, mask, reorder=reorder)
    P, Q = w.shape[:2]
    return ops.pack(BCS.conv_lower(w), BCS.conv_lower(mask), (8, 8),
                    reorder=reorder, n_bins=4, conv=(kh, kw, Q))


def conv_plain(ref, K, x, lay, kh, kw, stride, bias, act):
    """The plain (implicit) version on the card, fp32 inputs, NHWC out."""
    from repro_torch.core.packed import TapLayout
    xp, (Ho, Wo) = K.pad_image(x.float(), kh, kw, stride)
    b = None if bias is None else bias.float()
    if isinstance(lay, TapLayout):
        y = ref.tap_gather_implicit_ref(xp, lay, kw, (Ho, Wo, stride), b,
                                        act)
    else:
        y = ref.bsr_conv2d_implicit_ref(xp, lay, lay.conv_taps_t,
                                        (Ho, Wo, stride), b, act)
    return y.reshape(x.shape[0], Ho, Wo, -1)


def layout_bytes(lay):
    """Bytes of a layout's stored leaves the kernels read: values (their
    own dtype), the slot index (k_idx / t_idx) and any int8 scales."""
    idx = lay.t_idx if hasattr(lay, "t_idx") else lay.k_idx
    return (sum(v.numel() * v.element_size() for v in lay.values)
            + sum(t.numel() * 4 for t in idx)
            + sum(sc.numel() * 4 for sc in lay.scales or ()))


def conv_timing(mods, label, lay, x, b32, dense, kh, kw, stride, conv,
                flush):
    """One conv layer's timing row (fp32, bias + relu, L2 flushed, median
    ms by CUDA-graph replay): the implicit kernel (also warm), the
    materialized kernel on a prebuilt patch band and the call with its
    im2col, the plain version, ``F.conv2d`` on the masked dense weight
    ``dense`` (TF32 off) and the bounds."""
    ops, ref, K = mods["ops"], mods["ref"], mods["K"]
    import torch.nn.functional as F
    from repro_torch.core.packed import TapLayout
    k_imp, k_mat = conv_kernel_keys(lay)
    B_, H, W, _ = x.shape
    P = dense.shape[0]
    _, _, Ho, Wo = K.conv_geometry(H, W, kh, kw, stride)
    M = B_ * Ho * Wo
    band = ops.im2col(x, kh, kw, stride).reshape(M, -1)
    if isinstance(lay, TapLayout):
        imp_fn = (lambda: K.tap_gather_conv_implicit(
            x, lay, kh=kh, kw=kw, stride=stride, bias=b32, act="relu"))
        if lay.n_alive < band.shape[1]:
            band = band.index_select(1, lay.alive.long()).contiguous()
        mat_fn = (lambda: K.tap_gather_conv_packed(band, lay, b32, "relu"))
        live = lay.nnz_taps * lay.group
        executed = lay.executed_taps * lay.group
    else:
        imp_fn = (lambda: K.bsr_conv2d_implicit(
            x, lay, kh=kh, kw=kw, stride=stride, bias=b32, act="relu"))
        mat_fn = (lambda: K.bsr_conv2d_patches(band, lay, b32, "relu"))
        bk, bn = lay.block
        live = lay.nnzb * bk * bn
        executed = lay.executed_blocks * bk * bn
    w_bytes = layout_bytes(lay)
    call_fn = (lambda: conv(x, lay, kh=kh, kw=kw, stride=stride, bias=b32,
                            act="relu", implicit=False))
    plain_fn = (lambda: conv_plain(ref, K, x, lay, kh, kw, stride, b32,
                                   "relu"))
    dense = dense.float()
    xp, _ = K.pad_image(x, kh, kw, stride)
    xn = xp.permute(0, 3, 1, 2).contiguous()
    lib_fn = (lambda: torch.relu(F.conv2d(xn, dense, b32, stride=stride)))
    imp_ms = time_ms(imp_fn, 20, flush)
    # as the served forward meets it: the input still in L2 from the
    # layer that wrote it
    warm_ms = time_ms(imp_fn, 20, None)
    mat_ms = time_ms(mat_fn, 20, flush)
    call_ms = time_ms(call_fn, 20, flush)
    plain_ms = time_ms(plain_fn, 3, flush)
    lib_ms = time_ms(lib_fn, 20, flush)
    img_bytes = xp.numel() * 4
    out_bytes = M * P * 4
    flops = 2 * M * live
    t_ops = flops / FP32_PEAK_FLOPS * 1e3
    b_imp = (img_bytes + w_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
    b_mat = (band.numel() * 4 + w_bytes + out_bytes) / \
        HBM_BYTES_PER_S * 1e3
    return {
        "layer": label, "kernel_implicit": k_imp,
        "kernel_materialized": k_mat, "M": M, "K": lay.shape[0],
        "N": P, "bins": lay.n_bins, "L_max": lay.L_max,
        "values": lay.value_dtype, "layout_bytes": w_bytes,
        "executed_frac": 1 - lay.flops_saved,
        "live_flops": flops, "executed_flops": 2 * M * executed,
        "implicit_ms": imp_ms, "implicit_warm_ms": warm_ms,
        "materialized_ms": mat_ms,
        "materialized_call_ms": call_ms, "plain_ms": plain_ms,
        "library_ms": lib_ms,
        "bound_implicit_ms": max(b_imp, t_ops),
        "bound_materialized_ms": max(b_mat, t_ops),
        "bound_by_implicit": "bytes" if b_imp >= t_ops else "operations",
        "bound_by_materialized": ("bytes" if b_mat >= t_ops
                                  else "operations"),
        "ops_ms": t_ops, "bytes_implicit_ms": b_imp,
        "bytes_materialized_ms": b_mat,
        "patch_bytes": band.numel() * 4, "image_bytes": img_bytes}


def conv_check(mods, what, conv, lays, x, bias, act, kh, kw, stride,
               max_err):
    """One conv case: ``conv`` on each layout of ``lays`` (reordered and
    not), implicit and materialized, all bitwise equal, and within
    ``check_close`` of the plain version; fp32 errors go into ``max_err``
    by kernel."""
    ref, K = mods["ref"], mods["K"]
    ys = [conv(x, lay, kh=kh, kw=kw, stride=stride, bias=bias, act=act,
               implicit=imp) for lay in lays for imp in (True, False)]
    sync()
    if any(not torch.equal(y, ys[0]) for y in ys[1:]):
        raise AssertionError(f"{what}: implicit / materialized / reordered "
                             f"/ unreordered outputs differ bitwise")
    want = conv_plain(ref, K, x, lays[0], kh, kw, stride, bias, act)
    e = check_close(ys[0], want, x.dtype, f"conv kernel vs plain at {what}")
    if x.dtype == torch.float32:
        for k in conv_kernel_keys(lays[0]):
            max_err[k] = max(max_err[k], e)


def conv_kernel_phase(mods, flush):
    """Kernels 2-4 on the CNN path's shapes vs their plain versions, the
    bitwise identities, and timings (fp32, reordered, bias + relu)."""
    ops, K, BCS = mods["ops"], mods["K"], mods["BCS"]
    gen = torch.Generator(device=DEV)
    gen.manual_seed(1)
    max_err = {k: 0.0 for k in K.LAUNCHES}
    checks = 0
    rows = []
    for (label, wm, mask, kh, kw, stride, shape,
         scheme) in conv_cases(mods):
        conv = (ops.sparse_conv2d_pattern if scheme == "pattern"
                else ops.sparse_conv2d)
        P = wm.shape[0]
        x32 = torch.randn(shape, generator=gen, device=DEV)
        b32 = torch.randn(P, generator=gen, device=DEV) * 0.1
        for dtype in (torch.float32, torch.bfloat16):
            lays = [conv_layouts(ops, BCS, wm, mask, kh, kw, scheme, r,
                                 dtype) for r in (True, False)]
            x, b = x32.to(dtype), b32.to(dtype)
            for act, bias in (("none", None), ("relu", b)):
                conv_check(mods, f"{label} {dtype} act={act}", conv, lays,
                           x, bias, act, kh, kw, stride, max_err)
                checks += 1

        # timings: fp32, the reordered layout, bias + relu (the served
        # configuration), L2 flushed before each run
        lay = conv_layouts(ops, BCS, wm, mask, kh, kw, scheme, True,
                           torch.float32)
        rows.append(conv_timing(mods, label, lay, x32, b32, wm * mask, kh,
                                kw, stride, conv, flush))
        del lay
    print(f"conv kernels vs plain: {checks} cases over "
          f"{len(rows)} layers (VGG_TINY punched + pattern at B={CONV_B} "
          f"{CONV_HW}x{CONV_HW}, MOBILE_TINY c4 5x5), fp32 + bf16, bias + "
          f"relu and none; implicit == materialized and reordered == "
          f"unreordered bitwise; max abs err (fp32) " + ", ".join(
              f"{k} {v:.2e}" for k, v in max_err.items() if v))
    print_conv_timings("conv timings (fp32, reordered, bias + relu, L2 "
                       "flushed, median ms by CUDA-graph replay; warm = "
                       "implicit without the flush; materialized = kernel "
                       "on a prebuilt patch band, call = im2col + kernel):",
                       rows)
    return rows, max_err


def print_conv_timings(title, rows):
    print(title)
    print(f"  {'layer':24s} {'M':>7s} {'K':>5s} {'N':>4s} {'implicit':>9s} "
          f"{'warm':>9s} {'mat':>9s} {'call':>9s} {'bound':>9s} "
          f"{'plain':>9s} {'conv2d':>9s}  bound_by")
    for r in rows:
        print(f"  {r['layer']:24s} {r['M']:7d} {r['K']:5d} {r['N']:4d} "
              f"{r['implicit_ms']:9.4f} {r['implicit_warm_ms']:9.4f} "
              f"{r['materialized_ms']:9.4f} "
              f"{r['materialized_call_ms']:9.4f} "
              f"{r['bound_implicit_ms']:9.4f} {r['plain_ms']:9.4f} "
              f"{r['library_ms']:9.4f}  {r['bound_by_implicit']}")


FLOOR_LAYERS = ("vgg/c2/punched", "vgg/c3/punched", "vgg/c2/pattern",
                "vgg/c3/pattern")
FLOOR_BATCHES = (1, 4, 16, 64)


def floor_phase(mods, flush):
    """Both modes of VGG_TINY's c2 and c3 (punched and pattern; fp32,
    reordered, bias + relu) through ``ops`` at small batches: the
    implicit kernel against im2col + kernel, the rows behind
    ``_pick_implicit``'s rule."""
    ops, BCS = mods["ops"], mods["BCS"]
    gen = torch.Generator(device=DEV)
    gen.manual_seed(2)
    rows = []
    for (label, wm, mask, kh, kw, stride, shape,
         scheme) in conv_cases(mods):
        if label not in FLOOR_LAYERS:
            continue
        conv = (ops.sparse_conv2d_pattern if scheme == "pattern"
                else ops.sparse_conv2d)
        lay = conv_layouts(ops, BCS, wm, mask, kh, kw, scheme, True,
                           torch.float32)
        b = torch.randn(wm.shape[0], generator=gen, device=DEV) * 0.1
        for nb in FLOOR_BATCHES:
            x = torch.randn((nb,) + tuple(shape[1:]), generator=gen,
                            device=DEV)
            ms = {imp: time_ms(lambda: conv(x, lay, kh=kh, kw=kw,
                                            stride=stride, bias=b,
                                            act="relu", implicit=imp),
                               20, flush)
                  for imp in (True, False)}
            rows.append({"layer": label, "B": nb,
                         "patch_bytes": ops.patch_bytes(x, kh, kw, stride),
                         "implicit_ms": ms[True],
                         "materialized_call_ms": ms[False]})
    print("implicit vs im2col + kernel at small batches (fp32, ms, "
          "CUDA-graph replay):")
    for r in rows:
        print(f"  {r['layer']:16s} B={r['B']:3d} patch "
              f"{r['patch_bytes'] / 2 ** 20:8.3f} MiB  implicit "
              f"{r['implicit_ms']:8.4f}  materialized "
              f"{r['materialized_call_ms']:8.4f}")
    return rows


def expected_conv_launches(ops, arch, exec_p, hw, B):
    """Launches of one ``convnet_apply`` per kernel, from the layouts: a
    packed layer launches the implicit or the materialized kernel as
    ``ops._pick_implicit`` picks at its input, once over all bins; a
    sharded layer its shard wrapper (kernel 1 over the patches, kernel 2
    over the band)."""
    want = {}
    for name, kh, kw, stride, shape in layer_inputs(arch, hw, B):
        lay = exec_p[name].get("packed")
        if lay is None:
            continue
        k_imp, k_mat = conv_kernel_keys(lay)
        if lay.n_shards:
            key = ("tap_gather_conv_sharded" if k_mat == "tap_gather_conv"
                   else "bsr_matmul_sharded")
            want[key] = want.get(key, 0) + 1
            continue
        x = torch.empty(shape, dtype=torch.float32, device="meta")
        bk = None if k_imp == "tap_gather_conv_implicit" else lay.block[0]
        key = (k_imp if ops._pick_implicit(None, x, kh, kw, stride, "SAME",
                                           bk=bk) else k_mat)
        want[key] = want.get(key, 0) + 1
    return want


def conv_logit_gap(dense, packed):
    return ((dense - packed).abs().max() / dense.abs().max()).item()


def conv_serve_phase(mods):
    """VGG_TINY at its published widths through the port's entry points,
    under both mappings."""
    RW, CN, C, K, ops = (mods["RW"], mods["CN"], mods["C"], mods["K"],
                         mods["ops"])
    from repro_torch.train.trainer import apply_masks
    params = CN.convnet_init(CN.VGG_TINY, seed=0, device=DEV)
    gen = torch.Generator(device=DEV)
    gen.manual_seed(0)
    x, labels = CN.synthetic_images(gen, CONV_B, size=CONV_HW)
    print(f"VGG_TINY at its published widths (32-64-64-128-128-128), fp32, "
          f"seed 0; B = {CONV_B} synthetic {CONV_HW}x{CONV_HW}x3 images, 10 "
          f"classes")
    out, launches_all, launches8 = {}, {}, {}
    for name, spec in conv_mappings(RW):
        masks = conv_masks(RW, name, params, spec)
        pm = apply_masks(params, masks)
        sync()
        t0 = time.perf_counter()
        exec_p, report = C.compile_model(
            pm, masks, spec, spec=C.CompileSpec(keep_dense=False),
            device=DEV)
        sync()
        compile_s = time.perf_counter() - t0
        print(f"[{name}] compile_model {compile_s:.2f}s:")
        print(C.compiled_summary(report))
        want = expected_conv_launches(ops, CN.VGG_TINY, exec_p, CONV_HW,
                                      CONV_B)
        # the main path, counted: counts to 0 just before, read just after
        K.reset_launches()
        sync()
        with torch.no_grad():
            logits = CN.convnet_apply(exec_p, x, CN.VGG_TINY)
        sync()
        launches = {k: v for k, v in K.LAUNCHES.items() if v}
        print(f"[{name}] one forward: launches {launches} (from the "
              f"layouts: {want})")
        if launches != want:
            raise AssertionError(f"[{name}] the forward did not go through "
                                 f"the kernels the layouts imply")
        for k, v in launches.items():
            launches_all[k] = launches_all.get(k, 0) + v
        with torch.no_grad():
            dense = CN.convnet_apply(pm, x, CN.VGG_TINY)   # TF32 off
            gap = conv_logit_gap(dense, logits)
            agree = (dense.argmax(-1) == logits.argmax(-1)).float().mean()
            c6 = exec_p["c6"]["packed"]
            broken = dataclasses.replace(
                c6, values=c6.values[:-1] + (torch.zeros_like(c6.values[-1]),))
            fault = conv_logit_gap(dense, CN.convnet_apply(
                dict(exec_p, c6=dict(exec_p["c6"], packed=broken)), x,
                CN.VGG_TINY))
            for _ in range(2):
                CN.convnet_apply(exec_p, x, CN.VGG_TINY)
            sync()
            n_fw = 10
            t0 = time.perf_counter()
            for _ in range(n_fw):
                CN.convnet_apply(exec_p, x, CN.VGG_TINY)
            sync()
            fw_ms = (time.perf_counter() - t0) * 1e3 / n_fw
            # the card's time for one forward with the host taken out
            graph_ms = time_ms(lambda: CN.convnet_apply(exec_p, x,
                                                        CN.VGG_TINY), 10,
                               None)
            dev = device_time(lambda: CN.convnet_apply(exec_p, x,
                                                       CN.VGG_TINY))
        acc = (logits.argmax(-1) == labels).float().mean().item()
        print(f"[{name}] logits packed vs masked-dense (fp32, TF32 off): "
              f"max|diff| {gap:.2e} of max|logit| (bound {CONV_LOGIT_REL});"
              f" argmax agree {agree.item():.3f}; planted fault (c6's last "
              f"bin dropped): {fault:.3f}; accuracy of the random-weight "
              f"net {acc:.3f}")
        print(f"[{name}] forward {fw_ms:.3f} ms warm (mean of {n_fw}) = "
              f"{CONV_B / fw_ms * 1e3:.0f} images/s; its device work "
              f"replayed as a CUDA graph {graph_ms:.3f} ms = "
              f"{graph_ms / fw_ms:.3f} of the wall time")
        busy = None
        if dev is None:
            print(f"[{name}] device busy share: not measured (the profiler "
                  f"saw no device activity)")
        else:
            busy = dev["busy_ms"] / fw_ms
            traced = {"bsr_conv2d_implicit": "bsr_conv_kernel",
                      "bsr_conv2d_materialized": "bsr_conv_kernel",
                      "tap_gather_conv_implicit": "tap_conv_kernel",
                      "tap_gather_conv": "tap_conv_kernel"}
            want_ev = {}
            for k, v in launches.items():
                want_ev[traced[k]] = want_ev.get(traced[k], 0) + v
            print(f"[{name}] traced forward (torch.profiler): device busy "
                  f"{dev['busy_ms']:.3f} ms ({dev['bsr_ms']:.3f} in BCS "
                  f"kernels, {dev['tap_ms']:.3f} in tap kernels) = "
                  f"{busy:.3f} of the wall time; by kernel (ms, traced / "
                  f"launched) " + ", ".join(
                      f"{k} {v:.3f} ({dev['by_kernel_events'][k]} / "
                      f"{want_ev.get(k, 0)})"
                      for k, v in dev["by_kernel_ms"].items()))
        if not (torch.isfinite(logits).all()
                and tuple(logits.shape) == (CONV_B, 10)
                and gap <= CONV_LOGIT_REL and agree.item() == 1.0):
            raise AssertionError(f"[{name}] packed logits disagree with the "
                                 f"masked-dense ones beyond the bound")
        if fault <= CONV_LOGIT_REL:
            raise AssertionError(f"[{name}] the logit bound does not catch "
                                 f"a dropped bin of c6")
        out[name] = {"compile_s": compile_s, "launches": launches,
                     "logit_gap": gap, "argmax_agree": agree.item(),
                     "fault_gap": fault, "forward_ms": fw_ms,
                     "images_per_s": CONV_B / fw_ms * 1e3,
                     "graph_ms": graph_ms,
                     "device": dev, "busy_share": busy,
                     "report": C.compiled_summary(report)}
        del exec_p
        out[name]["int8"], l8 = vgg_int8_serve(mods, name, spec, pm, masks,
                                               x)
        for k, v in l8.items():
            launches8[k] = launches8.get(k, 0) + v
    return out, launches_all, launches8


def conv_shape_row(r, mode):
    """One conv layer's row for the kernels JSON line (ms)."""
    return {"layer": r["layer"], "M": r["M"], "K": r["K"], "N": r["N"],
            "mode": mode, "ms": r[f"{mode}_ms"],
            "bound_ms": r[f"bound_{mode}_ms"],
            "bound_by": r[f"bound_by_{mode}"], "plain_ms": r["plain_ms"],
            "library_ms": r["library_ms"]}


def conv_sums(rows, pick, mode):
    """The rows ``pick`` selects and their times summed, the bound from
    the summed bytes and operations."""
    sel = [r for r in rows if pick(r)]
    t_ops = sum(r["ops_ms"] for r in sel)
    t_bytes = sum(r[f"bytes_{mode}_ms"] for r in sel)
    return sel, {
        "ms": sum(r[f"{mode}_ms"] for r in sel),
        "plain_ms": sum(r["plain_ms"] for r in sel),
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": sum(r["library_ms"] for r in sel)}


def conv_entries(rows, max_err, launches, rows8, err8, launches8):
    """The JSON entries of kernels 2-4 and of kernel 3 on patches: their
    work in one VGG_TINY forward (the layers that run them on the served
    path), summed; each with its int8 branch (the int8 forward's launches
    and layouts)."""
    spec = [
        ("bsr_conv2d_materialized", "bsr_matmul.cu",
         "src/repro/kernels/bsr_matmul.py:143",
         lambda r: r["layer"] == "vgg/c5/punched", "materialized"),
        ("tap_gather_conv", "tap_gather.cu",
         "src/repro/kernels/bsr_matmul.py:314",
         lambda r: r["layer"] == "vgg/c5/pattern", "materialized"),
        ("bsr_conv2d_implicit", "bsr_matmul.cu",
         "src/repro/kernels/bsr_matmul.py:483",
         lambda r: r["layer"].startswith("vgg/") and
         r["layer"].endswith("/punched") and r["layer"] != "vgg/c5/punched",
         "implicit"),
        ("tap_gather_conv_implicit", "tap_gather.cu",
         "src/repro/kernels/bsr_matmul.py:613",
         lambda r: r["layer"].startswith("vgg/") and
         r["layer"].endswith("/pattern") and r["layer"] != "vgg/c5/pattern",
         "implicit"),
    ]
    out = []
    for name, src, replaces, pick, mode in spec:
        sel, t = conv_sums(rows, pick, mode)
        sel8, t8 = conv_sums(rows8, pick, mode)
        out.append(dict({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": replaces, "launches": launches.get(name, 0),
            "max_abs_err": max_err[name]}, **t,
            shapes=[conv_shape_row(r, mode) for r in sel],
            measured_at=f"sum over VGG_TINY layers "
                        f"{[r['layer'] for r in sel]} at B={CONV_B} "
                        f"{CONV_HW}x{CONV_HW}, fp32, {mode} mode, bias "
                        f"+ relu; library = F.conv2d + relu on the "
                        f"masked dense weight, TF32 off",
            int8=int8_entry(
                launches8.get(name, 0), err8[name], **t8,
                shapes=[conv_shape_row(r, mode) for r in sel8],
                measured_at="the same layers, int8 values (a scale per "
                            "block punched, per filter pattern), fp32 x")))
    return out


# -- the MoE path: kernel 1 over mixtral-8x7b's expert stacks -----------------

def moe_config():
    """mixtral-8x7b at its published widths (the rehearsal on the CPU
    swaps in the SMOKE config)."""
    from repro_torch import configs
    return configs.get("mixtral-8x7b")


def prefill_capacity(cfg):
    """Rows an expert gets at prefill: the capacity ``models.moe.moe``
    gives one dispatch group of the B x S prompt tokens (40 at mixtral,
    B x S = 128)."""
    Sg = min(cfg.moe_group, B * S)
    return min(Sg, max(4, int(Sg * cfg.top_k / cfg.n_experts * 1.25)))


def attention_shapes(cfg):
    """The (K, N) of a transformer config's four attention projections."""
    d, q, kv = cfg.d_model, cfg.n_heads * cfg.head_dim, \
        cfg.n_kv_heads * cfg.head_dim
    return {(d, q), (d, kv), (q, d)}


def moe_projections(cfg):
    """(name, K, N, epilogue) of an MoE layer's three expert projections."""
    d, f = cfg.d_model, cfg.d_ff
    return [("gate", d, f, "silu"), ("up", d, f, "none"),
            ("down", f, d, "none")]


def expert_stack(mods, E, Kd, Nd, gen, dtype, reorder, gran=None):
    """An (E, K, N) expert stack at the served scale (fan-in scaled normal
    weights, magnitude block masks at PRUNE_RATE over the whole stack),
    packed as ``compile_model`` packs experts, reordered into N_BINS bins
    or not as each of ``reorder`` says, int8 with scales at ``gran`` if
    given; returns (the layouts, the masked dense weights)."""
    RW, C = mods["RW"], mods["C"]
    w = (torch.randn(E, Kd, Nd, generator=gen, device=DEV)
         * Kd ** -0.5).to(dtype)
    spec = [(r"w$", RW.SchemeChoice("block", BLOCK))]
    mask = RW.magnitude_block_masks({"w": w}, spec, None,
                                    rate=PRUNE_RATE)["w"]
    dense = w * mask.to(dtype)
    del w
    lays = [C._pack_stacked(dense, mask, BLOCK, reorder=r, n_bins=N_BINS,
                            value_dtype=gran and "int8",
                            scale_granularity=gran or "block")[0]
            for r in reorder]
    return lays, dense


def stack_maker(mods, E, gen, gran=None):
    """``kernel1_timings``' ``make`` over reordered E-expert bf16 stacks
    (int8 at ``gran`` if given)."""
    def make(name, Kd, Nd):
        (lay,), dense = expert_stack(mods, E, Kd, Nd, gen, torch.bfloat16,
                                     (True,), gran)
        return lay, dense
    return make


def expert_cases(mods, gen, E, shapes, grans, acts, after=None):
    """Kernel 1 over E-expert stacks (one launch a call) vs the plain
    version expert by expert at every (K, N) of ``shapes`` and M of
    MOE_CHECK_M, fp32 and bf16, float values (gran None) or int8 at each
    of ``grans``, each activation of ``acts``; reordered == unreordered
    bitwise.  ``after(dtype, K, N, gran, layout)`` runs on each reordered
    stack.  Returns (cases, max abs error)."""
    ops, ref, K = mods["ops"], mods["ref"], mods["K"]
    checks, max_err = 0, 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for Kd, Nd in shapes:
            for gran in grans:
                (reord, unre), dense = expert_stack(
                    mods, E, Kd, Nd, gen, dtype, (True, False), gran)
                del dense
                for M in MOE_CHECK_M:
                    x = torch.randn(E, M, Kd, generator=gen, device=DEV).to(
                        dtype)
                    for act in acts:
                        before = K.LAUNCHES["bsr_matmul"]
                        y_re = ops.sparse_expert_linear(x, reord, act=act)
                        y_un = ops.sparse_expert_linear(x, unre, act=act)
                        sync()
                        what = (f"E={E} K={Kd} N={Nd} M={M} {dtype} "
                                f"values={gran or 'float'} act={act}")
                        if K.LAUNCHES["bsr_matmul"] - before != 2:
                            raise AssertionError(f"an expert projection did "
                                                 f"not take one launch at "
                                                 f"{what}")
                        if not torch.equal(y_re, y_un):
                            raise AssertionError(f"experts: reordered != "
                                                 f"unreordered at {what}")
                        want = ref.bsr_matmul_experts_ref(x.float(), reord,
                                                          None, act)
                        max_err = max(max_err, check_close(
                            y_re, want, dtype, f"experts: kernel vs plain "
                            f"at {what}"))
                        checks += 1
                        del y_re, y_un, want
                if after is not None:
                    after(dtype, Kd, Nd, gran, reord)
                del reord, unre
    return checks, max_err


def moe_kernel_phase(mods, flush):
    """Kernel 1 over an expert stack (one launch for all E experts) vs the
    plain version, expert by expert, at mixtral's expert shapes; then one
    MoE layer's three projections timed at decode (M = 4) and prefill
    (M = the capacity of the prefill's dispatch group) beside
    ``torch.bmm`` of the masked dense stack, the byte bound and a plain
    read of the same bytes."""
    cfg = moe_config()
    E = cfg.n_experts
    gen = torch.Generator(device=DEV)
    gen.manual_seed(2)
    shapes = sorted({(k, n) for _, k, n, _ in moe_projections(cfg)})
    checks, max_err = expert_cases(mods, gen, E, shapes, (None,),
                                   ("silu", "none"))
    print(f"experts: kernel vs plain, {checks} cases (E = {E}, (K, N) in "
          f"{shapes}, M in {MOE_CHECK_M}, bf16 + fp32, silu/none), one "
          f"launch per call, reordered == unreordered bitwise; max abs err "
          f"{max_err:.3e}")

    rows = kernel1_timings(mods, gen, flush, moe_projections(cfg),
                           (4, prefill_capacity(cfg)),
                           stack_maker(mods, E, gen), E)
    print_timings(f"experts timed (bf16, E = {E}, one launch per "
                  f"projection, L2 flushed, median ms by CUDA-graph replay; "
                  f"torch.bmm of the masked dense (E, K, N) stack; stream = "
                  f"one torch sum over the bound's bytes; M = rows an "
                  f"expert):", rows, "torch.bmm",
                  "MoE layer's experts (3 projections)",
                  ((4, "decode"), (prefill_capacity(cfg), "prefill")))
    return rows, max_err


def moe_inputs(T, fwd):
    """The input of every layer's ``moe()`` in one run of ``fwd`` (the
    port's own forward), in layer order."""
    seen = []
    orig = T.moe

    def spy(p, h, **kw):
        seen.append(h)
        return orig(p, h, **kw)
    T.moe = spy
    try:
        out = fwd()
    finally:
        T.moe = orig
    return out, seen


def routes(layers, inputs, top_k):
    """Per layer, each token's top-k expert choice (sorted) from its input
    by the port's routing rule (fp32 logits of the fp32 router), and the
    fp32 margin of that choice: the gap between the k-th and the
    (k+1)-th router logit."""
    out = []
    for lp, h in zip(layers, inputs):
        logits = h.reshape(-1, h.shape[-1]).float() @ lp["moe"]["router"][
            "w"].float()
        top = torch.topk(logits, top_k + 1)
        out.append((top.indices[:, :top_k].sort(-1).values,
                    top.values[:, top_k - 1] - top.values[:, top_k]))
    return out


def expert_faults(params):
    """(name, params) pairs: the compiled model with one fault in an expert
    stack (every layer), as a broken packer could make."""
    moe_p = params["layers"]["moe"]
    gate, down = moe_p["gate"]["packed"], moe_p["down"]["packed"]

    def shift(k):                 # leaves (layers, experts, ...)
        k = k.clone()
        k[:, 3] = (k[:, 3] + 1) % gate.Kb
        return k

    def swap(v):
        v = v.clone()
        v[:, [0, 1]] = v[:, [1, 0]]
        return v
    shifted = tuple(shift(k) for k in gate.k_idx)
    swapped = tuple(swap(v) for v in down.values)
    return [
        ("gate: expert 3's k_idx shifted by one block",
         with_layout(params, "moe", "gate",
                     dataclasses.replace(gate, k_idx=shifted))),
        ("down: experts 0 and 1 values swapped",
         with_layout(params, "moe", "down",
                     dataclasses.replace(down, values=swapped))),
    ]


def moe_layer_gaps(mods, exec_p, dense_p, cfg, inputs):
    """Per layer: moe() with the packed and the masked-dense params on the
    same input (the packed run's): (max, mean) relative gaps."""
    MOE, T = mods["MOE"], mods["T"]
    gaps = []
    for lp_x, lp_d, h in zip(T.layer_params(exec_p), T.layer_params(dense_p),
                             inputs):
        a, _ = MOE.moe(lp_x["moe"], h, top_k=cfg.top_k, group=cfg.moe_group)
        b, _ = MOE.moe(lp_d["moe"], h, top_k=cfg.top_k, group=cfg.moe_group)
        gaps.append(logit_gap(b, a))
    return gaps


def moe_serve_phase(mods):
    """mixtral-8x7b at full width through the port's entry points (bf16,
    depth cut to MOE_LAYERS), its gates, then the fp32 whole-model gate at
    MOE_FP32_LAYERS layers."""
    T, C, E = mods["T"], mods["C"], mods["E"]
    full = moe_config()
    cfg = full.replace(n_layers=MOE_LAYERS)
    if DEV == "cuda":
        torch.cuda.reset_peak_memory_stats()
    print(f"mixtral-8x7b at full width (d_model {cfg.d_model}, heads "
          f"{cfg.n_heads}/{cfg.n_kv_heads}, d_ff {cfg.d_ff}, {cfg.n_experts} "
          f"experts top-{cfg.top_k}, vocab {cfg.vocab}); depth cut to "
          f"{cfg.n_layers} of {full.n_layers} layers")
    pm, exec_p, report, init_s, compile_s, masks = build_served(
        mods, cfg, torch.bfloat16)
    print(f"init + masks {init_s:.2f}s; compile_model {compile_s:.2f}s:")
    print(C.compiled_summary(report))
    moe_p = exec_p["layers"]["moe"]
    n_bins = {moe_p[n]["packed"].n_bins for n in ("gate", "up", "down")}
    routers = [r for r in report if r.path == "layers/moe/router/w"]
    if (len(report.packed) != 7 or n_bins != {N_BINS}
            or [r.reason for r in routers] != ["excluded"]):
        raise AssertionError(f"expected 4 attention + 3 expert packed "
                             f"projections of {N_BINS} bins and the router "
                             f"excluded: {C.compiled_summary(report)}")
    e2e, launches, prompts, tokens = serve_counted(
        mods, exec_p, cfg, full, compile_s, f"4 attention + 3 expert "
        f"projections, one launch each over all {cfg.n_experts} experts and "
        f"{N_BINS} bins")

    # bf16 gates, layer by layer: the same input into moe() with packed and
    # masked-dense params routes the same way, so the experts are compared
    # and not the routing (a near-tie of router scores flips with the
    # attention's rounding and moves whole-model logits far more)
    with torch.no_grad():
        s_logits, s_in = moe_inputs(T, lambda: T.forward(exec_p, cfg,
                                                         tokens))
        d_logits, d_in = moe_inputs(T, lambda: T.forward(pm, cfg, tokens))
        gaps = moe_layer_gaps(mods, exec_p, pm, cfg, s_in)
        fault_gaps = [(name, moe_layer_gaps(mods, p, pm, cfg, s_in))
                      for name, p in expert_faults(exec_p)]
        s_routes = routes(T.layer_params(exec_p), s_in, cfg.top_k)
        d_routes = routes(T.layer_params(exec_p), d_in, cfg.top_k)
    # the (token, layer) pairs whose choice differs, each with its router
    # margin on the packed run's input (all tokens' median beside it), and
    # the whole-model gap over the sequences that no flip touched
    flipped = [(a != b).any(-1) for (a, _), (b, _) in zip(s_routes,
                                                          d_routes)]
    flips = sum(int(f.sum()) for f in flipped)
    margins = [(layer, int(t), m[t].item())
               for layer, (f, (_, m)) in enumerate(zip(flipped, s_routes))
               for t in f.nonzero().flatten()]
    median_margin = torch.cat([m for _, m in s_routes]).median().item()
    seq_flipped = torch.stack(flipped).reshape(len(flipped), B, S).any(
        0).any(-1)
    clean = ~seq_flipped
    clean_gap = (logit_gap(d_logits[clean], s_logits[clean])
                 if clean.any() else None)
    whole = logit_gap(d_logits, s_logits)
    print(f"per-layer moe() packed vs masked-dense on the packed run's "
          f"input (bf16): " + ", ".join(f"layer {i} {g[0]:.4f} / {g[1]:.4f}"
                                        for i, g in enumerate(gaps))
          + f" (bound {LOGIT_MAX_REL} / {LOGIT_MEAN_REL})")
    for name, fg in fault_gaps:
        worst = max(fg, key=lambda g: g[1])
        missed = "  (NOT CAUGHT)" if all(map(within_bound, fg)) else ""
        print(f"  planted fault, {name}: worst layer {worst[0]:.4f} / "
              f"{worst[1]:.4f}{missed}")
    print(f"whole-model bf16 logits packed vs masked-dense (not gated): "
          f"{whole[0]:.4f} of max|logit| / {whole[1]:.4f} of mean|logit|; "
          f"routing choices that differ: {flips} of "
          f"{len(s_routes) * B * S} (token, layer) pairs")
    print(f"  router margin (fp32 gap of the router logits ranked "
          f"{cfg.top_k} and {cfg.top_k + 1}) at each flip, (layer, token, "
          f"margin): "
          + ", ".join(f"({i}, {t}, {m:.2e})" for i, t, m in margins)
          + f"; median over all tokens {median_margin:.2e}")
    if clean_gap is None:
        print("  every sequence had a flipped route")
    else:
        print(f"  whole-model bf16 logits over the {int(clean.sum())} of {B} "
              f"sequences with no flipped route: {clean_gap[0]:.4f} / "
              f"{clean_gap[1]:.4f} (within {LOGIT_MAX_REL} / "
              f"{LOGIT_MEAN_REL}: {within_bound(clean_gap)})")
    e2e.update(layer_gaps=gaps, fault_layer_gaps=dict(fault_gaps),
               whole_logit_gap_bf16=whole, routing_flips=flips,
               flip_margins=margins, median_router_margin=median_margin,
               unflipped_sequences=int(clean.sum()),
               unflipped_logit_gap_bf16=clean_gap)
    if not (torch.isfinite(s_logits).all()
            and all(map(within_bound, gaps))):
        raise AssertionError("packed moe() disagrees with masked-dense "
                             "beyond the stated bound")
    missed = [n for n, fg in fault_gaps if all(map(within_bound, fg))]
    if missed:
        raise AssertionError(f"the per-layer bound does not catch: {missed}")
    del s_logits, d_logits, s_in, d_in, fault_gaps
    e2e["engine"] = engine_phase(
        mods, exec_p, cfg, "mixtral-8x7b", 7,
        generate_busy_share=e2e.get("device", {}).get("decode_busy_share"))
    del exec_p
    if DEV == "cuda":
        torch.cuda.empty_cache()
    # int8: the same masked params compiled again, int8 values
    int8, launches8 = moe_int8_phase(mods, pm, masks, cfg, full, tokens)
    del pm, masks
    if DEV == "cuda":
        torch.cuda.empty_cache()

    # fp32, whole model at MOE_FP32_LAYERS layers: the routing does not
    # flip, so logits and greedy tokens are gated directly
    cfg32 = full.replace(n_layers=MOE_FP32_LAYERS)
    pm, exec_p, _, _, _, masks = build_served(mods, cfg32, torch.float32)
    with torch.no_grad():
        d32 = T.forward(pm, cfg32, tokens)
        s32 = T.forward(exec_p, cfg32, tokens)
        gap32 = logit_gap(d32, s32)[0]
        faults32 = [(name, logit_gap(d32, T.forward(p, cfg32, tokens))[0])
                    for name, p in expert_faults(exec_p)]
        tok_d = E.generate(pm, cfg32, prompts, N_NEW, device=DEV)
        tok_s = E.generate(exec_p, cfg32, prompts, N_NEW, device=DEV)
    same = bool(torch.equal(tok_d, tok_s))
    print(f"fp32 ({cfg32.n_layers} layers, TF32 off): logits packed vs "
          f"masked-dense {gap32:.2e} of max|logit| (bound "
          f"{MOE_FP32_LOGIT_REL}); greedy tokens identical: {same}; "
          + "; ".join(f"planted fault, {n}: {g:.3f}" for n, g in faults32))
    e2e.update(fp32_logit_gap=gap32, fp32_tokens_identical=same,
               fp32_faults=dict(faults32))
    if not (torch.isfinite(s32).all() and gap32 <= MOE_FP32_LOGIT_REL
            and same):
        raise AssertionError("fp32 packed mixtral disagrees with "
                             "masked-dense")
    missed = [n for n, g in faults32 if g <= MOE_FP32_LOGIT_REL]
    if missed:
        raise AssertionError(f"the fp32 logit bound does not catch: "
                             f"{missed}")
    e2e["engine"]["fp32"] = engine_fp32_gate(mods, exec_p, cfg32,
                                             "mixtral-8x7b")
    del exec_p
    int8.update(fp32_int8_gate(mods, pm, masks, cfg32, tokens, prompts,
                               "mixtral-8x7b"))
    del pm, masks
    if DEV == "cuda":
        # the int8 part reset the peak: the float bf16 part's is kept apart
        e2e["peak_mem_gb"] = max(int8["float_bf16_peak_mem_gb"],
                                 torch.cuda.max_memory_allocated() / 1e9)
        print(f"MoE phase peak device memory "
              f"{e2e['peak_mem_gb']:.2f} GB (torch.cuda."
              f"max_memory_allocated; float and int8 parts)")
    e2e["int8"] = int8
    return e2e, launches, launches8


# -- int8 values: the dequant branch of every kernel -------------------------

INT8_GRANS = ("block", "out")


def layout_to(layout, dev):
    """The layout with every tensor leaf moved to ``dev``."""
    out = {}
    for f in dataclasses.fields(layout):
        v = getattr(layout, f.name)
        if isinstance(v, torch.Tensor):
            v = v.to(dev)
        elif isinstance(v, tuple) and v and isinstance(v[0], torch.Tensor):
            v = tuple(t.to(dev) for t in v)
        out[f.name] = v
    return type(layout)(**out)


def quant_on_card_check(mods, lay):
    """``core.quant`` on the card gives the host's bits: int8 values and
    fp32 scales of ``lay`` quantized on both, at both granularities."""
    from repro_torch.core import quant as Q
    host = layout_to(lay, "cpu")
    for gran in INT8_GRANS:
        a = Q.quantize_layout(lay, scale_granularity=gran)
        b = Q.quantize_layout(host, scale_granularity=gran)
        same = all(torch.equal(u.cpu(), v) for u, v in zip(a.values,
                                                           b.values))
        same &= all(torch.equal(u.cpu().view(torch.int32),
                                v.view(torch.int32))
                    for u, v in zip(a.scales, b.scales))
        if not same:
            raise AssertionError(f"quantize_layout ({gran}) on the card "
                                 f"differs from the host's")
    print(f"core.quant on the card == on the host, bit for bit (values and "
          f"scales, {' and '.join(INT8_GRANS)}, a {lay.shape} layout)")


def scale_faults(lay_block, lay_out):
    """(name, broken layout, true layout): an int8 layout ("block") with
    one live block's (or tap slot's) scale doubled, and one ("out") with
    one column's (or filter's) scales zeroed — column 0 of the last bin,
    whose slot 0 is live."""
    b = lay_block.n_bins - 1
    doubled = [s.clone() for s in lay_block.scales]
    doubled[b][0, 0] *= 2
    zeroed = [s.clone() for s in lay_out.scales]
    zeroed[b][0] = 0
    return [("a block's (slot's) scale doubled", dataclasses.replace(
                lay_block, scales=tuple(doubled)), lay_block),
            ("a column's (filter's) scales zeroed", dataclasses.replace(
                lay_out, scales=tuple(zeroed)), lay_out)]


def faults_caught(what, lay_block, lay_out, kernel, plain, dtype):
    """Each fault of ``scale_faults`` run by ``kernel(layout)`` must break
    the kernel-vs-plain bound against ``plain(true layout)``."""
    out = []
    for name, broken, true in scale_faults(lay_block, lay_out):
        y, want = kernel(broken), plain(true)
        sync()
        n = out_of_tol(y, want, dtype)[0]
        out.append((name, n))
        print(f"  planted fault, {what}, {name}: {n} of {y.numel()} "
              f"outputs out of the bound{'' if n else '  (NOT CAUGHT)'}")
    missed = [name for name, n in out if n == 0]
    if missed:
        raise AssertionError(f"the kernel-vs-plain bound does not catch "
                             f"{missed} at {what}")
    return dict(out)


def int8_pack(ops, w, mask, gran, reorder, block=BLOCK):
    return ops.pack(w, mask, block, reorder=reorder, n_bins=N_BINS,
                    value_dtype="int8", scale_granularity=gran)


def int8_kernel_phase(mods, flush):
    """Kernel 1's int8 branch: quantization on the card == on the host;
    kernel vs plain at ``kernel1_shapes`` (yi-9b's projections, mixtral's
    attention) and CHECK_M, bf16 and fp32, both granularities, reordered
    == unreordered bitwise; planted scale faults; the value bytes and the
    timings of one yi-9b layer at decode and prefill (the served
    granularity, "block")."""
    RW, ops, ref, K = mods["RW"], mods["ops"], mods["ref"], mods["K"]
    gen = torch.Generator(device=DEV)
    gen.manual_seed(3)
    w, mask = weight_and_mask(RW, D, D, gen, torch.bfloat16)
    quant_on_card_check(mods, ops.pack(w, mask, BLOCK, reorder=True,
                                       n_bins=N_BINS))
    shapes = kernel1_shapes()
    checks, max_err = kernel1_cases(
        mods, gen, shapes,
        lambda w, mask: [(gran, int8_pack(ops, w, mask, gran, True),
                          int8_pack(ops, w, mask, gran, False))
                         for gran in INT8_GRANS],
        (("none", False), ("silu", True)))
    print(f"[int8] kernel 1 vs plain: {checks} cases at (K, N) in {shapes} "
          f"(yi-9b's projections, mixtral-8x7b's attention), M in "
          f"{CHECK_M}, bf16 + fp32, scales per block and per column, bias + "
          f"silu and none, reordered == unreordered bitwise; max abs err "
          f"{max_err:.3e}")
    x = torch.randn(4, D, generator=gen, device=DEV).to(torch.bfloat16)
    faults = faults_caught(
        f"kernel 1 ({D} x {D}, M = 4, bf16)",
        int8_pack(ops, w, mask, "block", True),
        int8_pack(ops, w, mask, "out", True),
        lambda lay: K.bsr_matmul_packed(x, lay),
        lambda lay: ref.bsr_matmul_packed_ref(x.float(), lay),
        torch.bfloat16)
    del w, mask

    print("[int8] stored value bytes of one yi-9b layer (rate 0.6, 4 bins, "
          "padding slots included): bf16 vs int8 + fp32 scales per block")
    tot = [0, 0]

    def make(name, Kd, Nd):
        w, mask = weight_and_mask(RW, Kd, Nd, gen, torch.bfloat16)
        lay = int8_pack(ops, w, mask, "block", True)
        n_vals = sum(v.numel() for v in lay.values)
        b16 = 2 * n_vals
        b8 = n_vals + sum(sc.numel() * 4 for sc in lay.scales)
        tot[0], tot[1] = tot[0] + b16, tot[1] + b8
        print(f"  {name:5s} bf16 {b16 / 2**20:8.2f} MiB  int8 + scales "
              f"{b8 / 2**20:8.2f} MiB ({b8 / b16:.3f})")
        return lay, w * mask.to(w.dtype)
    rows = kernel1_timings(mods, gen, flush, PROJECTIONS, (4, 128), make)
    tot16, tot8 = tot
    print(f"  layer bf16 {tot16 / 2**20:.2f} MiB, int8 + scales "
          f"{tot8 / 2**20:.2f} MiB ({tot8 / tot16:.3f})")
    print_timings("[int8] kernel 1 timings (bf16 x, int8 values, a scale "
                  "per block; L2 flushed, median ms by CUDA-graph replay; "
                  "bound and stream from the int8 bytes; torch.matmul on "
                  "the bf16 masked dense weight):", rows, "torch.matmul",
                  "yi-9b layer (7 projections)",
                  ((4, "decode"), (128, "prefill")))
    return rows, max_err, faults, (tot16, tot8)


def int8_moe_kernel_phase(mods, flush):
    """Kernel 1's int8 branch over mixtral's 8-expert stacks: vs the plain
    version expert by expert at MOE_CHECK_M, bf16 and fp32, both
    granularities, reordered == unreordered bitwise, one launch a call;
    one CUDA-graph replay of a chunked int8 expert launch; one MoE
    layer's three projections timed at decode and prefill."""
    ops, K = mods["ops"], mods["K"]
    cfg = moe_config()
    E = cfg.n_experts
    gen = torch.Generator(device=DEV)
    gen.manual_seed(4)
    shapes = sorted({(k, n) for _, k, n, _ in moe_projections(cfg)})

    def replay(dtype, Kd, Nd, gran, lay):
        if dtype == torch.bfloat16 and Kd > Nd and gran == "block":
            replay_check(ops, K, lay, gen, E, Kd)
    checks, max_err = expert_cases(mods, gen, E, shapes, INT8_GRANS,
                                   ("silu",), replay)
    print(f"[int8] experts: kernel vs plain, {checks} cases (E = {E}, (K, N) "
          f"in {shapes}, M in {MOE_CHECK_M}, bf16 + fp32, both "
          f"granularities), one launch per call, reordered == unreordered "
          f"bitwise; max abs err {max_err:.3e}")

    rows = kernel1_timings(mods, gen, flush, moe_projections(cfg),
                           (4, prefill_capacity(cfg)),
                           stack_maker(mods, E, gen, "block"), E)
    print_timings(f"[int8] experts timed (bf16 x, int8 values, a scale per "
                  f"block, E = {E}, one launch per projection, L2 flushed, "
                  f"median ms by CUDA-graph replay; torch.bmm of the bf16 "
                  f"masked dense stack; bound and stream from the int8 "
                  f"bytes):", rows, "torch.bmm",
                  "MoE layer's experts (3 projections)",
                  ((4, "decode"), (prefill_capacity(cfg), "prefill")))
    return rows, max_err


def replay_check(ops, K, lay, gen, E, Kd):
    """One int8 expert launch with chunked columns captured in a CUDA
    graph: replays give the eager bits and leave the tile counters 0."""
    x = torch.randn(E, 4, Kd, generator=gen, device=DEV).to(torch.bfloat16)
    want = ops.sparse_expert_linear(x, lay, act="silu")
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        y = ops.sparse_expert_linear(x, lay, act="silu")
    for _ in range(2):
        g.replay()
        sync()
        if not torch.equal(y, want) or int(
                K._COUNTERS[x.device].abs().sum()):
            raise AssertionError("an int8 expert launch replayed from a "
                                 "CUDA graph differs or left a counter set")
    print(f"[int8] a chunked int8 expert launch (E = {E}, K = {Kd}, M = 4) "
          f"replayed from a CUDA graph: the eager bits, counters 0")


def int8_conv_layouts(ops, BCS, wm, mask, kh, kw, scheme, reorder, dtype,
                      gran):
    w = wm.to(dtype)
    if scheme == "pattern":
        return ops.pack_taps(w, mask, reorder=reorder, value_dtype="int8",
                             scale_granularity=gran)
    Q = w.shape[1]
    return ops.pack(BCS.conv_lower(w), BCS.conv_lower(mask), (8, 8),
                    reorder=reorder, n_bins=4, conv=(kh, kw, Q),
                    value_dtype="int8", scale_granularity=gran)


def int8_conv_kernel_phase(mods, flush):
    """Kernels 2-4's int8 branch at every packed VGG_TINY layer under both
    mappings: vs plain, bf16 and fp32, both granularities, implicit ==
    materialized and reordered == unreordered bitwise (c5, the 1x1: kernel
    2 == kernel 4 under the pattern mapping, kernel 3 on its patches ==
    on the image); planted scale faults on a tap layout; timings at the
    served granularity (per block for punched, per filter for taps)."""
    ops, ref, K, BCS = mods["ops"], mods["ref"], mods["K"], mods["BCS"]
    gen = torch.Generator(device=DEV)
    gen.manual_seed(5)
    max_err = {k: 0.0 for k in K.LAUNCHES}
    checks, rows, faults = 0, [], {}
    for (label, wm, mask, kh, kw, stride, shape,
         scheme) in conv_cases(mods):
        if not label.startswith("vgg/"):
            continue
        conv = (ops.sparse_conv2d_pattern if scheme == "pattern"
                else ops.sparse_conv2d)
        x32 = torch.randn(shape, generator=gen, device=DEV)
        b32 = torch.randn(wm.shape[0], generator=gen, device=DEV) * 0.1
        for dtype in (torch.float32, torch.bfloat16):
            x, b = x32.to(dtype), b32.to(dtype)
            for gran in INT8_GRANS:
                lays = [int8_conv_layouts(ops, BCS, wm, mask, kh, kw,
                                          scheme, r, dtype, gran)
                        for r in (True, False)]
                conv_check(mods, f"int8 {label} {dtype} {gran}", conv, lays,
                           x, b, "relu", kh, kw, stride, max_err)
                checks += 1
                del lays
        if label == "vgg/c2/pattern":
            faults = faults_caught(
                f"kernel 4 ({label}, fp32)",
                *(int8_conv_layouts(ops, BCS, wm, mask, kh, kw, scheme,
                                    True, torch.float32, g)
                  for g in INT8_GRANS),
                lambda lay: K.tap_gather_conv_implicit(
                    x32, lay, kh=kh, kw=kw, stride=stride),
                lambda lay: conv_plain(ref, K, x32, lay, kh, kw, stride,
                                       None, "none"),
                torch.float32)
        served = "out" if scheme == "pattern" else "block"
        lay = int8_conv_layouts(ops, BCS, wm, mask, kh, kw, scheme, True,
                                torch.float32, served)
        rows.append(conv_timing(mods, label, lay, x32, b32, wm * mask, kh,
                                kw, stride, conv, flush))
        del lay
    print(f"[int8] conv kernels vs plain: {checks} cases over {len(rows)} "
          f"VGG_TINY layers (punched + pattern, B={CONV_B}), fp32 + bf16, "
          f"both granularities, bias + relu; implicit == materialized "
          f"(c5 pattern: kernel 2 == kernel 4) and reordered == "
          f"unreordered bitwise; max abs err (fp32) " + ", ".join(
              f"{k} {v:.2e}" for k, v in max_err.items() if v))
    print_conv_timings("[int8] conv timings (fp32 x, int8 values: a scale "
                       "per block (punched) or per filter (pattern); as "
                       "above):", rows)
    return rows, max_err, faults


def dense_of(lay, w):
    """The dequantized dense weight of a layer's int8 layout, in the shape
    and dtype of its weight ``w``: a linear stack slice by slice; a conv
    from its im2col-lowered (kh*kw*Q, P) form."""
    if getattr(lay, "conv_taps", None) is not None or hasattr(lay,
                                                                "t_idx"):
        P, Q, kh, kw = w.shape
        d = lay.to_dense().reshape(kh, kw, Q, P).permute(3, 2, 0, 1)
        return d.to(w.dtype).contiguous()

    def rec(lay_, lead):
        if not lead:
            return lay_.to_dense().to(w.dtype)
        return torch.stack([rec(lay_.layer(i), lead[1:])
                            for i in range(lead[0])])
    return rec(lay, tuple(w.shape[:-2]))


def dequantized(params, exec_p):
    """``params`` (masked dense) with every packed layer's weight replaced
    by its int8 layout's dequantized weight: the oracle of the int8
    path."""
    if not isinstance(params, dict):
        return params
    out = {k: dequantized(v, exec_p.get(k, {})) for k, v in params.items()}
    lay = exec_p.get("packed")
    if lay is not None and "w" in params:
        out["w"] = dense_of(lay, params["w"])
    return out


def check_int8_report(C, report, n_packed):
    print(C.compiled_summary(report))
    got = [r for r in report.packed if r.value_dtype == "int8"]
    if len(report.packed) != n_packed or len(got) != n_packed:
        raise AssertionError(f"expected {n_packed} int8 packed layers: "
                             f"{C.compiled_summary(report)}")


def lm_int8_phase(mods, pm, masks, cfg, full, tokens):
    """yi-9b's masked params compiled again with int8 values: the main
    path counted (kernel 1 still one launch a projection), bf16 prefill
    logits against masked-dense on the dequantized weights, then the fp32
    model at 2 layers against its dequantized weights, and the engine's
    fp32 token gate on that compile."""
    C, E = mods["C"], mods["E"]
    from repro_torch.launch.serve import SPARSE_SPEC
    exec8, report, compile_s = compile_timed(mods, pm, masks, SPARSE_SPEC,
                                             value_dtype="int8")
    print(f"[int8] yi-9b compile_model(value_dtype='int8') "
          f"{compile_s:.2f}s:")
    check_int8_report(C, report, 7)
    e2e, launches, prompts, _ = serve_counted(
        mods, exec8, cfg, full, compile_s, f"int8 values, one launch over "
        f"the {N_BINS} bins")
    with torch.no_grad():
        deq = dequantized(pm, exec8)
        d = E.prefill(deq, cfg, tokens)[0]
        s8 = E.prefill(exec8, cfg, tokens)[0]
    gap = logit_gap(d, s8)
    agree = (d.argmax(-1) == s8.argmax(-1)).float().mean().item()
    print(f"[int8] yi-9b prefill logits packed vs masked-dense on the "
          f"dequantized weights (bf16): max|diff| {gap[0]:.4f} of "
          f"max|logit|, mean |diff| {gap[1]:.4f} of mean |logit| (bound "
          f"{LOGIT_MAX_REL} / {LOGIT_MEAN_REL}); argmax agree {agree:.2f}")
    if not (torch.isfinite(s8).all() and within_bound(gap)):
        raise AssertionError("int8 prefill logits disagree with the "
                             "dequantized masked-dense ones beyond the "
                             "bound")
    e2e["logits_gap"] = gap
    del deq, exec8, d, s8
    torch.cuda.empty_cache()
    cfg2 = full.replace(n_layers=2)
    pm32, masks32, _ = build_masked(mods, cfg2, torch.float32)
    e2e.update(fp32_int8_gate(mods, pm32, masks32, cfg2, tokens, prompts,
                              "yi-9b", engine=True))
    return e2e, launches


def fp32_int8_gate(mods, pm, masks, cfg, tokens, prompts, arch,
                   engine=False):
    """An fp32 model compiled int8 (TF32 off): its logits within
    MOE_FP32_LOGIT_REL of max |logit| of the masked-dense run on the
    dequantized weights, and identical greedy tokens.  With ``engine``,
    the engine's fp32 token gate on the same compiled params, its ring
    fault planted (``engine_fp32``)."""
    T, E = mods["T"], mods["E"]
    from repro_torch.launch.serve import SPARSE_SPEC
    exec8, _, _ = compile_timed(mods, pm, masks, SPARSE_SPEC,
                                value_dtype="int8")
    with torch.no_grad():
        deq = dequantized(pm, exec8)
        gap = logit_gap(T.forward(deq, cfg, tokens),
                        T.forward(exec8, cfg, tokens))[0]
        tok_d = E.generate(deq, cfg, prompts, N_NEW, device=DEV)
        tok_s = E.generate(exec8, cfg, prompts, N_NEW, device=DEV)
    same = bool(torch.equal(tok_d, tok_s))
    print(f"[int8] {arch} fp32 ({cfg.n_layers} layers, TF32 off): logits "
          f"packed vs masked-dense on the dequantized weights {gap:.2e} of "
          f"max|logit| (bound {MOE_FP32_LOGIT_REL}); greedy tokens "
          f"identical: {same}")
    if not (gap <= MOE_FP32_LOGIT_REL and same):
        raise AssertionError(f"int8 fp32 {arch} disagrees with its "
                             f"dequantized masked-dense run")
    out = {"fp32_logit_gap": gap, "fp32_tokens_identical": same}
    if engine:
        out["engine_fp32"] = engine_fp32_gate(
            mods, exec8, cfg, f"{arch} (int8 values)", fault=True)
    return out


def moe_int8_phase(mods, pm, masks, cfg, full, tokens):
    """mixtral's masked bf16 params compiled again with int8 values: the
    main path counted, every layer's ``moe()`` against masked-dense on the
    dequantized weights (same input), the phase's peak memory."""
    T, C = mods["T"], mods["C"]
    from repro_torch.launch.serve import SPARSE_SPEC
    float_peak = None
    if DEV == "cuda":
        float_peak = torch.cuda.max_memory_allocated() / 1e9
        torch.cuda.reset_peak_memory_stats()
    exec8, report, compile_s = compile_timed(mods, pm, masks, SPARSE_SPEC,
                                             value_dtype="int8")
    print(f"[int8] mixtral-8x7b compile_model(value_dtype='int8') "
          f"{compile_s:.2f}s:")
    check_int8_report(C, report, 7)
    e2e, launches, _, _ = serve_counted(
        mods, exec8, cfg, full, compile_s, f"int8 values; 4 attention + 3 "
        f"expert projections, one launch each over all {cfg.n_experts} "
        f"experts and {N_BINS} bins")
    with torch.no_grad():
        deq = dequantized(pm, exec8)
        _, s_in = moe_inputs(T, lambda: T.forward(exec8, cfg, tokens))
        gaps = moe_layer_gaps(mods, exec8, deq, cfg, s_in)
    print(f"[int8] per-layer moe() packed vs masked-dense on the dequantized "
          f"weights, same input (bf16): " + ", ".join(
              f"layer {i} {g[0]:.4f} / {g[1]:.4f}"
              for i, g in enumerate(gaps))
          + f" (bound {LOGIT_MAX_REL} / {LOGIT_MEAN_REL})")
    if not all(map(within_bound, gaps)):
        raise AssertionError("int8 moe() disagrees with the dequantized "
                             "masked-dense one beyond the bound")
    e2e["layer_gaps"] = gaps
    del deq, exec8, s_in
    if DEV == "cuda":
        e2e["float_bf16_peak_mem_gb"] = float_peak
        e2e["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        print(f"[int8] mixtral int8 part peak device memory "
              f"{e2e['peak_mem_gb']:.2f} GB (the masked bf16 params, their "
              f"int8 compile and the dequantized oracle; the float bf16 "
              f"part before it {float_peak:.2f} GB)")
        torch.cuda.empty_cache()
    return e2e, launches


def vgg_int8_serve(mods, name, spec, pm, masks, x):
    """VGG_TINY's masked params compiled again with int8 values (per-block
    scales punched, per-filter taps): one forward counted, its fp32 logits
    against masked-dense on the dequantized weights, ms per forward and
    the card's busy share."""
    CN, C, K, ops = mods["CN"], mods["C"], mods["K"], mods["ops"]
    exec8, report, compile_s = compile_timed(mods, pm, masks, spec,
                                             value_dtype="int8")
    print(f"[{name}, int8] compile_model {compile_s:.2f}s:")
    check_int8_report(C, report, len(report.packed))
    want = expected_conv_launches(ops, CN.VGG_TINY, exec8, CONV_HW, CONV_B)
    K.reset_launches()
    sync()
    with torch.no_grad():
        logits = CN.convnet_apply(exec8, x, CN.VGG_TINY)
    sync()
    launches = {k: v for k, v in K.LAUNCHES.items() if v}
    print(f"[{name}, int8] one forward: launches {launches} (from the "
          f"layouts: {want})")
    if launches != want:
        raise AssertionError(f"[{name}, int8] the forward did not go "
                             f"through the kernels the layouts imply")
    with torch.no_grad():
        dense = CN.convnet_apply(dequantized(pm, exec8), x, CN.VGG_TINY)
        gap = conv_logit_gap(dense, logits)
        agree = (dense.argmax(-1) == logits.argmax(-1)).float().mean().item()
        for _ in range(2):
            CN.convnet_apply(exec8, x, CN.VGG_TINY)
        sync()
        n_fw = 10
        t0 = time.perf_counter()
        for _ in range(n_fw):
            CN.convnet_apply(exec8, x, CN.VGG_TINY)
        sync()
        fw_ms = (time.perf_counter() - t0) * 1e3 / n_fw
        graph_ms = time_ms(lambda: CN.convnet_apply(exec8, x, CN.VGG_TINY),
                           10, None)
        dev = device_time(lambda: CN.convnet_apply(exec8, x, CN.VGG_TINY))
    busy = None if dev is None else dev["busy_ms"] / fw_ms
    print(f"[{name}, int8] logits packed vs masked-dense on the dequantized "
          f"weights (fp32, TF32 off): max|diff| {gap:.2e} of max|logit| "
          f"(bound {CONV_LOGIT_REL}); argmax agree {agree:.3f}; forward "
          f"{fw_ms:.3f} ms warm = {CONV_B / fw_ms * 1e3:.0f} images/s; "
          f"device work by graph replay {graph_ms:.3f} ms; busy share "
          + ("not measured (the profiler saw no device activity)"
             if busy is None else f"{busy:.3f}"))
    if not (torch.isfinite(logits).all() and gap <= CONV_LOGIT_REL
            and agree == 1.0):
        raise AssertionError(f"[{name}, int8] packed logits disagree with "
                             f"the dequantized masked-dense ones")
    return ({"compile_s": compile_s, "launches": launches, "logit_gap": gap,
             "argmax_agree": agree, "forward_ms": fw_ms,
             "images_per_s": CONV_B / fw_ms * 1e3, "graph_ms": graph_ms,
             "device": dev, "busy_share": busy}, launches)


# -- the paper's scheme mapping: the rule mapper's own picks, served ---------

# yi-9b is mapped at the compression its masks give (rate 0.6) and priced at
# the served prompt (B x S tokens); VGG_TINY at rate 0.5
MAP_COMPRESSION = 1 / (1 - PRUNE_RATE)
VGG_MAP_RATE = 0.5
VGG_MAP_COMPRESSION = 1 / (1 - VGG_MAP_RATE)


def lm_config():
    """yi-9b at its published widths (the rehearsal on the CPU swaps in
    the SMOKE config)."""
    from repro_torch import configs
    return configs.get("yi-9b")


def lm_mapping(mods, cfg, target):
    """``map_rules`` over ``cfg``'s GEMMs at B x S tokens, dataset_hard,
    on ``target``: (spec, report)."""
    MR = mods["MR"]
    return MR.map_rules(MR.lm_layers(cfg, tokens=B * S), dataset_hard=True,
                        compression=MAP_COMPRESSION, target=target)


def vgg_specs(CN):
    """VGG_TINY as ``conv_layers`` takes it at a CONV_HW input: (name,
    feat, Cin, Cout, kh, kw, depthwise), feat the output side (halved at
    each stride-2 layer)."""
    out, feat, cin = [], CONV_HW, 3
    for (name, cout, kh, kw, stride, dw) in CN.VGG_TINY:
        feat //= stride
        out.append((name, feat, cin, cout, kh, kw, dw))
        cin = cout
    return out


def vgg_mapping(mods, hard, target):
    MR = mods["MR"]
    return MR.map_rules(MR.conv_layers(vgg_specs(mods["CN"])),
                        dataset_hard=hard, compression=VGG_MAP_COMPRESSION,
                        target=target)


def mapping_rows(report):
    """The mapper's report as printable rows."""
    return [f"  {r['path']:18s} {r['kind']:8s} {r['scheme']:14s} "
            f"{str(r['block']):11s} {str(r['value_dtype']):5s} "
            f"{r['latency_s']:11.4e} x{r['count']}" for r in report]


def served_rules(C, spec):
    """The rules of the layers ``compile_model`` packs (a packable scheme,
    a path its spec does not exclude: embed / head, §5.2.4), and the
    paths of the others.  The others stay out of the masks too:
    ``magnitude_block_masks`` prunes every leaf a rule matches whose block
    tiles it, a "none" rule's too (yi-9b's embed table at full width)."""
    excl = C.CompileSpec().exclude
    rules = [(p, c) for p, c in spec if c.scheme in C.PACKABLE_SCHEMES
             and not any(e in p for e in excl)]
    return rules, [p for p, c in spec if (p, c) not in rules]


def mapped_lm_serve(mods, args):
    """yi-9b at full width (depth ``--layers``) served under the rule
    mapper's picks on V5E: magnitude block masks at each rule's own block,
    ``compile_model`` quantizing each layer by its pick, the main path
    counted; bf16 prefill logits against masked-dense on the dequantized
    weights and the fp32 model at 2 layers, each with a dropped bin of
    ``down`` breaking its bound."""
    C, E, T = mods["C"], mods["E"], mods["T"]
    from repro_torch.core import latency_model as LM
    full = lm_config()
    cfg = full.replace(n_layers=args.layers)
    spec, mreport = lm_mapping(mods, cfg, LM.V5E)
    print(f"[mapped] map_rules(lm_layers(yi-9b, tokens={B * S}), "
          f"dataset_hard=True, compression={MAP_COMPRESSION:.2f}, V5E): "
          f"path, kind, scheme, block, values, modelled latency_s, count")
    print("\n".join(mapping_rows(mreport)))
    rules, dropped = served_rules(C, spec)
    print(f"[mapped] served rules: {[p for p, _ in rules]}; not masked or "
          f"packed: {dropped}")
    pm, masks, init_s = build_masked(mods, cfg, torch.bfloat16, rules)
    exec_p, report, compile_s = compile_timed(mods, pm, masks, rules)
    print(f"[mapped] init + masks {init_s:.2f}s; compile_model "
          f"{compile_s:.2f}s:")
    print(C.compiled_summary(report))
    for r in report.packed:
        choice = mods["RW"].match(rules, r.path)
        if (r.block, r.value_dtype) != (tuple(choice.block),
                                        choice.value_dtype):
            raise AssertionError(f"[mapped] {r.path} packed at {r.block} "
                                 f"{r.value_dtype}, mapped {choice}")
    per_layer = len(report.packed)
    if not per_layer:
        raise AssertionError("[mapped] compile_model packed no layer")
    # the fault: the last packed projection's last bin dropped, every layer
    _, group, fault_proj, _ = report.packed[-1].path.split("/")
    e2e, launches, prompts, tokens = serve_counted(
        mods, exec_p, cfg, full, compile_s, "the mapper's blocks and "
        "values, one launch each", per_layer=per_layer)
    with torch.no_grad():
        deq = dequantized(pm, exec_p)
        d = E.prefill(deq, cfg, tokens)[0]
        s8 = E.prefill(exec_p, cfg, tokens)[0]
        broken = dropped_last_bin(exec_p, fault_proj, group)
        fault = logit_gap(d, E.prefill(broken, cfg, tokens)[0])
    gap = logit_gap(d, s8)
    agree = (d.argmax(-1) == s8.argmax(-1)).float().mean().item()
    print(f"[mapped] prefill logits packed vs masked-dense on the "
          f"dequantized weights (bf16): {gap[0]:.4f} / {gap[1]:.4f} of max "
          f"/ mean |logit| (bound {LOGIT_MAX_REL} / {LOGIT_MEAN_REL}); "
          f"argmax agree {agree:.2f}; planted fault ({fault_proj}'s last "
          f"bin dropped): {fault[0]:.4f} / {fault[1]:.4f}")
    if not (torch.isfinite(s8).all() and within_bound(gap)):
        raise AssertionError("[mapped] packed prefill logits disagree with "
                             "the dequantized masked-dense ones")
    if within_bound(fault):
        raise AssertionError("[mapped] the logit bound does not catch a "
                             "dropped bin")
    e2e.update(logits_gap=gap, fault_gap=fault, mapping=mreport,
               report=C.compiled_summary(report))
    del deq, exec_p, broken, d, s8, pm, masks
    torch.cuda.empty_cache()

    cfg2 = full.replace(n_layers=2)
    pm32, masks32, _ = build_masked(mods, cfg2, torch.float32, rules)
    exec32, _, _ = compile_timed(mods, pm32, masks32, rules)
    with torch.no_grad():
        deq = dequantized(pm32, exec32)
        want = T.forward(deq, cfg2, tokens)
        gap32 = logit_gap(want, T.forward(exec32, cfg2, tokens))[0]
        fault32 = logit_gap(want, T.forward(
            dropped_last_bin(exec32, fault_proj, group), cfg2, tokens))[0]
        tok_d = E.generate(deq, cfg2, prompts, N_NEW, device=DEV)
        tok_s = E.generate(exec32, cfg2, prompts, N_NEW, device=DEV)
    same = bool(torch.equal(tok_d, tok_s))
    print(f"[mapped] yi-9b fp32 (2 layers, TF32 off): logits packed vs "
          f"masked-dense on the dequantized weights {gap32:.2e} of "
          f"max|logit| (bound {MOE_FP32_LOGIT_REL}), planted fault "
          f"{fault32:.3f}; greedy tokens identical: {same}")
    if not (gap32 <= MOE_FP32_LOGIT_REL and same
            and fault32 > MOE_FP32_LOGIT_REL):
        raise AssertionError("[mapped] fp32 yi-9b disagrees with its "
                             "dequantized masked-dense run, or the bound "
                             "misses the fault")
    e2e.update(fp32_logit_gap=gap32, fp32_fault_gap=fault32,
               fp32_tokens_identical=same)
    del deq, exec32, pm32, masks32
    torch.cuda.empty_cache()
    return e2e, launches, rules


def mapped_projections(mods, rules):
    """(name, K, N, act, block, values) of each yi-9b projection a rule
    serves, at its mapped block and precision."""
    RW = mods["RW"]
    out = []
    for name, Kd, Nd, act in PROJECTIONS:
        group = "attn" if name.startswith("w") else "ffn"
        c = RW.match(rules, f"layers/{group}/{name}/w")
        if c is not None:
            out.append((name, Kd, Nd, act, tuple(c.block), c.value_dtype))
    return out


def mapped_kernel1_phase(mods, flush, rules):
    """Kernel 1 at each served projection's mapped block: vs its plain
    version at CHECK_M, float and int8, bf16 and fp32, reordered ==
    unreordered bitwise; each projection timed at decode (M = 4) and
    prefill (M = B x S), int8 (the served precision) and float."""
    RW, ops = mods["RW"], mods["ops"]
    gen = torch.Generator(device=DEV)
    gen.manual_seed(6)
    projs = mapped_projections(mods, rules)
    checks, max_err = 0, 0.0
    for block in sorted({p[4] for p in projs}):
        shapes = sorted({(k, n) for _, k, n, _, b, _ in projs if b == block})
        n, err = kernel1_cases(
            mods, gen, shapes,
            lambda w, mask, block=block: [
                ("float", ops.pack(w, mask, block, reorder=True,
                                   n_bins=N_BINS), ops.pack(w, mask, block)),
                ("int8", int8_pack(ops, w, mask, "block", True, block),
                 int8_pack(ops, w, mask, "block", False, block))],
            (("none", False), ("silu", True)), block=block)
        checks, max_err = checks + n, max(max_err, err)
        print(f"[mapped] kernel 1 vs plain at block {block}: {n} cases at "
              f"(K, N) in {shapes}, M in {CHECK_M}, bf16 + fp32, float and "
              f"int8 (a scale per block), bias + silu and none, reordered "
              f"== unreordered bitwise; max abs err {err:.3e}")
    blocks = {p[0]: p[4] for p in projs}

    def make(int8):
        def mk(name, Kd, Nd):
            w, mask = weight_and_mask(RW, Kd, Nd, gen, torch.bfloat16,
                                      blocks[name])
            lay = (int8_pack(ops, w, mask, "block", True, blocks[name])
                   if int8 else ops.pack(w, mask, blocks[name], reorder=True,
                                         n_bins=N_BINS))
            return lay, w * mask.to(w.dtype)
        return mk
    plain = [p[:4] for p in projs]
    rows = {}
    for values in ("int8", "float"):
        rows[values] = kernel1_timings(mods, gen, flush, plain, (4, B * S),
                                       make(values == "int8"))
        for r in rows[values]:
            r["block"] = blocks[r["proj"]]
        print_timings(f"[mapped] kernel 1 timings at the mapped blocks "
                      f"({sorted(set(blocks.values()))}), {values} values, "
                      f"bf16 x (L2 flushed, median ms by CUDA-graph replay; "
                      f"torch.matmul on the bf16 masked dense weight):",
                      rows[values], "torch.matmul",
                      f"yi-9b layer ({len(plain)} projections)",
                      ((4, "decode"), (B * S, "prefill")))
    return rows, checks, max_err


def vgg_mapped_masks(mods, params, spec):
    """The masks the reference's serving callers build for a mapped
    VGG_TINY: its pattern rules through ``masks_for_spec``, its
    block-punched rules through ``punched_conv_masks`` at each rule's own
    block.  A layer neither mask function tiles stays unpruned: a block that
    does not divide (filters, channels), an FC block on the 1x1 c5."""
    RW = mods["RW"]
    pat = RW.masks_for_spec(params, [r for r in spec
                                     if r[1].scheme == "pattern"])
    pun = RW.punched_conv_masks(params, [r for r in spec
                                         if r[1].scheme == "block_punched"],
                                None, rate=VGG_MAP_RATE)
    return {name: {k: (pat[name][k] if pat[name][k].ndim else pun[name][k])
                   for k in node} for name, node in params.items()}


def vgg_mapped_serve(mods, flush):
    """VGG_TINY served under the rule mapper's picks on V5E, dataset_hard
    True (pattern) and False (block-punched): masks as ``vgg_mapped_masks``
    builds them, ``compile_model`` under the whole mapping, one forward
    counted, fp32 logits against masked-dense on the dequantized weights
    (TF32 off) with a dropped bin of the last packed layer; then each
    packed layer's kernel vs its plain version at its block and precision
    (reordered == unreordered, implicit == materialized bitwise) and
    timed."""
    CN, C, K, ops, RW = (mods["CN"], mods["C"], mods["K"], mods["ops"],
                         mods["RW"])
    from repro_torch.core import latency_model as LM
    from repro_torch.core.packed import TapLayout
    from repro_torch.train.trainer import apply_masks
    params = CN.convnet_init(CN.VGG_TINY, seed=0, device=DEV)
    gen = torch.Generator(device=DEV)
    gen.manual_seed(0)
    x, _ = CN.synthetic_images(gen, CONV_B, size=CONV_HW)
    out, launches_all = {}, {}
    max_err = {k: 0.0 for k in K.LAUNCHES}
    for hard in (True, False):
        tag = f"dataset_hard={hard}"
        spec, mreport = vgg_mapping(mods, hard, LM.V5E)
        print(f"[mapped VGG_TINY, {tag}] map_rules(conv_layers(...), "
              f"compression={VGG_MAP_COMPRESSION}, V5E):")
        print("\n".join(mapping_rows(mreport)))
        masks = vgg_mapped_masks(mods, params, spec)
        unpruned = [n for n, *_ in CN.VGG_TINY if masks[n]["w"].ndim == 0]
        pm = apply_masks(params, masks)
        exec_p, report, compile_s = compile_timed(mods, pm, masks, spec)
        # the same compile without the reorder: the bitwise reference
        unre_p, _, _ = compile_timed(mods, pm, masks, spec, reorder=False)
        print(f"[mapped VGG_TINY, {tag}] unpruned (no mask function tiles "
              f"them): {unpruned}; compile_model {compile_s:.2f}s:")
        print(C.compiled_summary(report))
        want = expected_conv_launches(ops, CN.VGG_TINY, exec_p, CONV_HW,
                                      CONV_B)
        K.reset_launches()
        sync()
        with torch.no_grad():
            logits = CN.convnet_apply(exec_p, x, CN.VGG_TINY)
        sync()
        launches = {k: v for k, v in K.LAUNCHES.items() if v}
        print(f"[mapped VGG_TINY, {tag}] one forward: launches {launches} "
              f"(from the layouts: {want})")
        if launches != want:
            raise AssertionError(f"[mapped VGG_TINY, {tag}] the forward did "
                                 f"not go through the kernels the layouts "
                                 f"imply")
        for k, v in launches.items():
            launches_all[k] = launches_all.get(k, 0) + v
        packed = [n for n, *_ in CN.VGG_TINY if "packed" in exec_p[n]]
        last = exec_p[packed[-1]]["packed"]
        broken = dict(exec_p, **{packed[-1]: dict(
            exec_p[packed[-1]], packed=dataclasses.replace(
                last, values=last.values[:-1]
                + (torch.zeros_like(last.values[-1]),)))})
        with torch.no_grad():
            dense = CN.convnet_apply(dequantized(pm, exec_p), x, CN.VGG_TINY)
            gap = conv_logit_gap(dense, logits)
            agree = (dense.argmax(-1) == logits.argmax(-1)).float().mean()
            fault = conv_logit_gap(dense, CN.convnet_apply(broken, x,
                                                           CN.VGG_TINY))
            for _ in range(2):
                CN.convnet_apply(exec_p, x, CN.VGG_TINY)
            sync()
            n_fw = 10
            t0 = time.perf_counter()
            for _ in range(n_fw):
                CN.convnet_apply(exec_p, x, CN.VGG_TINY)
            sync()
            fw_ms = (time.perf_counter() - t0) * 1e3 / n_fw
            graph_ms = time_ms(lambda: CN.convnet_apply(exec_p, x,
                                                        CN.VGG_TINY), 10,
                               None)
        print(f"[mapped VGG_TINY, {tag}] logits packed vs masked-dense on "
              f"the dequantized weights (fp32, TF32 off): {gap:.2e} of "
              f"max|logit| (bound {CONV_LOGIT_REL}); argmax agree "
              f"{agree.item():.3f}; planted fault ({packed[-1]}'s last bin "
              f"dropped): {fault:.3f}; forward {fw_ms:.3f} ms warm = "
              f"{CONV_B / fw_ms * 1e3:.0f} images/s, device work by graph "
              f"replay {graph_ms:.3f} ms")
        if not (torch.isfinite(logits).all() and gap <= CONV_LOGIT_REL
                and agree.item() == 1.0):
            raise AssertionError(f"[mapped VGG_TINY, {tag}] packed logits "
                                 f"disagree with the masked-dense ones")
        if fault <= CONV_LOGIT_REL:
            raise AssertionError(f"[mapped VGG_TINY, {tag}] the logit bound "
                                 f"does not catch a dropped bin")
        rows = []
        for lname, kh, kw, stride, shape in layer_inputs(CN.VGG_TINY,
                                                         CONV_HW, CONV_B):
            lay = exec_p[lname].get("packed")
            if lay is None:
                continue
            choice = RW.match(spec, f"{lname}/w")
            wm = pm[lname]["w"]
            conv = (ops.sparse_conv2d_pattern if isinstance(lay, TapLayout)
                    else ops.sparse_conv2d)
            xin = torch.randn(shape, generator=gen, device=DEV)
            b = torch.randn(wm.shape[0], generator=gen, device=DEV) * 0.1
            conv_check(mods, f"[mapped {tag}] {lname} {choice.scheme} "
                       f"{tuple(choice.block)} {choice.value_dtype}", conv,
                       [lay, unre_p[lname]["packed"]], xin, b, "relu", kh,
                       kw, stride, max_err)
            row = conv_timing(mods, f"vgg/{lname}/{choice.scheme}", lay,
                              xin, b, wm, kh, kw, stride, conv, flush)
            # the pick's block (none for a pattern pick) in the mapper's
            # coordinates; the layout's GEMM block is lay.block
            row.update(block=(None if choice.scheme == "pattern"
                              else tuple(choice.block)),
                       mapped_values=choice.value_dtype, kh=kh, kw=kw,
                       Q=wm.shape[1], stride=stride, choice=choice)
            rows.append(row)
        print(f"[mapped VGG_TINY, {tag}] each packed layer's kernel vs "
              f"plain at its block and precision (fp32, bias + relu, "
              f"implicit == materialized, reordered == unreordered "
              f"bitwise): max abs err " + ", ".join(
                  f"{k} {v:.2e}" for k, v in max_err.items() if v))
        print_conv_timings(f"[mapped VGG_TINY, {tag}] timings (as the conv "
                           f"phase's):", rows)
        out[tag] = {"mapping": mreport, "unpruned": unpruned,
                    "report": C.compiled_summary(report),
                    "launches": launches, "logit_gap": gap,
                    "argmax_agree": agree.item(), "fault_gap": fault,
                    "forward_ms": fw_ms, "graph_ms": graph_ms,
                    "images_per_s": CONV_B / fw_ms * 1e3, "rows": rows}
        del exec_p, unre_p, broken, pm, masks
    return out, launches_all, max_err


def modelled_ms(LM, target, M, K, N, choice, compression, taps=0):
    """``matmul_latency`` of one served layer under its pick, in ms, priced
    as ``map_rules`` prices it (conv: the implicit path's x traffic; a
    pattern pick at its executed-tap fraction)."""
    vb = 1 if choice.value_dtype == "int8" else None
    xf = LM.im2col_x_frac(taps) if taps > 1 else None
    if choice.scheme == "pattern":
        frac = LM.pattern_executed_frac(choice.connectivity)
        return 1e3 * LM.matmul_latency(
            M, K, N, scheme="pattern", compression=1 / frac, target=target,
            value_bytes=vb, executed_frac=frac, x_frac=xf)
    return 1e3 * LM.matmul_latency(
        M, K, N, scheme=choice.scheme, block=tuple(choice.block),
        compression=compression, target=target, value_bytes=vb, x_frac=xf)


def latency_model_check(mods, args, lm_rows, rules, vgg):
    """The latency model against the card: every served (layer, block,
    values) modelled on V5E beside its measured kernel time (the LM at
    decode and prefill, the convs at the served batch); then one target
    calibrated to this run's rates (``torch.matmul``'s dense bf16 FLOP
    rate at yi-9b's gate at M = B x S, kernel 1's live-byte rate over a
    mapped layer at decode) and its picks beside V5E's, printed only."""
    RW = mods["RW"]
    from repro_torch.core import latency_model as LM
    rows = []
    for r in lm_rows["int8"]:
        group = "attn" if r["proj"].startswith("w") else "ffn"
        c = RW.match(rules, f"layers/{group}/{r['proj']}/w")
        rows.append((f"yi-9b/{r['proj']} M={r['M']}", c,
                     modelled_ms(LM, LM.V5E, r["M"], r["K"], r["N"], c,
                                 MAP_COMPRESSION), r["ms"]))
    for tag, v in vgg.items():
        for r in v["rows"]:
            rows.append((f"{r['layer']} ({tag})", r["choice"], modelled_ms(
                LM, LM.V5E, r["M"], r["kh"] * r["kw"] * r["Q"], r["N"],
                r["choice"], VGG_MAP_COMPRESSION, r["kh"] * r["kw"]),
                r["implicit_ms"]))
    print("[mapped] latency model (V5E) against the card: layer, scheme, "
          "block, values, modelled ms, measured kernel ms, measured / "
          "modelled")
    out = []
    for name, c, mod, meas in rows:
        block = "-" if c.scheme == "pattern" else str(tuple(c.block))
        print(f"  {name:42s} {c.scheme:13s} {block:11s} "
              f"{str(c.value_dtype):5s} {mod:9.4f} {meas:9.4f} "
              f"{meas / mod:7.2f}")
        out.append({"layer": name, "scheme": c.scheme,
                    "block": None if c.scheme == "pattern" else tuple(
                        c.block), "values": c.value_dtype,
                    "modelled_ms": mod, "measured_ms": meas,
                    "ratio": meas / mod})
    gate = next(r for r in lm_rows["float"]
                if r["proj"] == "gate" and r["M"] == B * S)
    flops = 2 * gate["M"] * gate["K"] * gate["N"] / (gate["library_ms"]
                                                     / 1e3)
    dec = [r for r in lm_rows["int8"] if r["M"] == 4]
    bytes_rate = sum(r["bytes"] for r in dec) / (sum(r["ms"] for r in dec)
                                                 / 1e3)
    card = LM.calibrate(LM.V5E, measured_flops_per_s=flops,
                        measured_bytes_per_s=bytes_rate)
    print(f"[mapped] calibrate(V5E, measured_flops_per_s={flops:.4g} "
          f"(torch.matmul, bf16, {gate['M']} x {gate['K']} x {gate['N']}), "
          f"measured_bytes_per_s={bytes_rate:.4g} (kernel 1's live bytes "
          f"over a mapped yi-9b layer at decode)); picks, V5E | "
          f"calibrated:")
    picks = {}
    cfg = lm_config().replace(n_layers=args.layers)
    for what, fn in [("yi-9b", lambda t: lm_mapping(mods, cfg, t)[1])] + [
            (f"VGG_TINY dataset_hard={h}",
             lambda t, h=h: vgg_mapping(mods, h, t)[1]) for h in (True,
                                                                 False)]:
        v5e, cal = fn(LM.V5E), fn(card)
        picks[what] = {"v5e": v5e, "calibrated": cal}
        for a, b in zip(v5e, cal):
            print(f"  {what:26s} {a['path']:16s} {a['scheme']:13s} "
                  f"{str(a['block']):11s} {str(a['value_dtype']):5s} | "
                  f"{b['scheme']:13s} {str(b['block']):11s} "
                  f"{b['value_dtype']}")
    return {"rows": out, "flops_per_s": flops, "bytes_per_s": bytes_rate,
            "picks": picks}


# -- the SSM and hybrid families: kernel 1 on mamba2 and hymba ---------------

SSM_ARCHS = ("mamba2-1.3b", "hymba-1.5b")
# the served depth cuts (width is never cut): 12 of 48 and 8 of 32 layers,
# which keep the script in its time limit
SSM_LAYERS = {"mamba2-1.3b": 12, "hymba-1.5b": 8}
SSM_BLOCK = (16, 8)      # the serving spec's block on ssm in/out_proj
# bf16 whole-model logits of mamba2 / hymba against the fp32
# masked-dense model: at full depth the masked-dense bf16 model itself
# drifts 0.13 / 0.094 (mamba2, 48 layers) and 0.050 / 0.050 (hymba, 32
# layers) of
# max / mean |logit| through the roundings of its depth, beyond yi-9b's
# 5 % / 2 %, and the packed bf16 model 0.118 / 0.094 and 0.052 / 0.050
# (H100, PERF.md); a dropped bin moves it 1.3 of max |logit|
BF16_NOISE_FACTOR = 1.5
# fp32 decode step after a prefill of S - 1 tokens against ``forward`` at
# position S - 1 (TF32 off): the chunked SSD scan and the O(1) step sum in
# other orders, and kernel 1 runs at other M; about 1e-7 of max |logit|
# on the CPU at SMOKE size.  A state taken from the wrong input moves the
# logits by a large share of max |logit| (the reference's hybrid prefill:
# 0.56 against 0.45 at hymba SMOKE on the CPU)
DECODE_FORWARD_REL = 1e-4


def ssm_config(arch):
    """mamba2-1.3b or hymba-1.5b at its published widths (the rehearsal
    on the CPU swaps in the SMOKE configs)."""
    from repro_torch import configs
    return configs.get(arch)


def ssm_projections(cfg):
    """(name, K, N, epilogue, block) of every packed projection of one
    layer: the mixer's in/out_proj at SSM_BLOCK; hymba's attention and
    FFN at BLOCK, as the serving spec maps them."""
    d, di = cfg.d_model, cfg.ssm_expand * cfg.d_model
    heads = di // cfg.ssm_headdim
    mixer = [("in_proj", d, 2 * di + 2 * cfg.ssm_state + heads, "none",
              SSM_BLOCK), ("out_proj", di, d, "none", SSM_BLOCK)]
    if cfg.family == "ssm":
        return mixer
    q, kv = cfg.n_heads * cfg.hd, cfg.n_kv_heads * cfg.hd
    return ([("wq", d, q, "none", BLOCK), ("wk", d, kv, "none", BLOCK),
             ("wv", d, kv, "none", BLOCK), ("wo", q, d, "none", BLOCK)]
            + mixer
            + [("gate", d, cfg.d_ff, "silu", BLOCK),
               ("up", d, cfg.d_ff, "none", BLOCK),
               ("down", cfg.d_ff, d, "none", BLOCK)])


def ssm_shapes():
    """{block: sorted (K, N)} of every packed projection of both archs."""
    out = {}
    for arch in SSM_ARCHS:
        for _, k, n, _, blk in ssm_projections(ssm_config(arch)):
            out.setdefault(blk, set()).add((k, n))
    return {blk: sorted(v) for blk, v in out.items()}


def ssm_kernel_phase(mods, flush):
    """Kernel 1 at the SSM and hybrid shapes: vs the plain version at
    CHECK_M, bf16 and fp32, reordered == unreordered bitwise, float and
    int8 (both granularities), (16, 8) blocks on the mixers' in/out_proj
    and (16, 16) on hymba's attention and FFN; then one mamba2 layer and
    one hymba layer timed at decode (M = B = 4) and prefill (M = B x S =
    128)."""
    RW, ops = mods["RW"], mods["ops"]
    gen = torch.Generator(device=DEV)
    gen.manual_seed(5)
    checks, max_err, checks8, err8 = 0, 0.0, 0, 0.0
    for blk, shapes in ssm_shapes().items():
        n, err = kernel1_cases(
            mods, gen, shapes,
            lambda w, mask: [("float", ops.pack(w, mask, blk, reorder=True,
                                                n_bins=N_BINS),
                              ops.pack(w, mask, blk))],
            (("none", False), ("none", True), ("silu", True)), blk)
        checks, max_err = checks + n, max(max_err, err)
        n, err = kernel1_cases(
            mods, gen, shapes,
            lambda w, mask: [(gran, int8_pack(ops, w, mask, gran, True, blk),
                              int8_pack(ops, w, mask, gran, False, blk))
                             for gran in INT8_GRANS],
            (("none", False), ("silu", True)), blk)
        checks8, err8 = checks8 + n, max(err8, err)
        print(f"[ssm] kernel 1 vs plain at {blk} blocks, (K, N) in {shapes}:"
              f" M in {CHECK_M}, bf16 + fp32, reordered == unreordered "
              f"bitwise; float (bias with none/silu) and int8 (scales per "
              f"block and per column)")
    print(f"[ssm] kernel 1 vs plain: {checks} float cases, max abs err "
          f"{max_err:.3e}; {checks8} int8 cases, max abs err {err8:.3e}")

    rows = {}
    for arch in SSM_ARCHS:
        projs = ssm_projections(ssm_config(arch))
        blocks = {name: blk for name, _, _, _, blk in projs}

        def make(name, Kd, Nd):
            w, mask = weight_and_mask(RW, Kd, Nd, gen, torch.bfloat16,
                                      blocks[name])
            return (ops.pack(w, mask, blocks[name], reorder=True,
                             n_bins=N_BINS), w * mask.to(w.dtype))
        rows[arch] = kernel1_timings(
            mods, gen, flush, [p[:4] for p in projs], (4, B * S), make)
        print_timings(f"[ssm] {arch} timings (bf16, L2 flushed, median ms "
                      f"by CUDA-graph replay; stream = one torch sum over "
                      f"the bound's bytes):", rows[arch], "torch.matmul",
                      f"{arch} layer ({len(projs)} projections)",
                      ((4, "decode"), (B * S, "prefill")))
    return rows, (checks, max_err, checks8, err8)


def dropped_last_bin(params, name, group="ssm"):
    """``params`` with the projection ``group``/``name``'s last degree bin
    zeroed in every layer."""
    lay = params["layers"][group][name]["packed"]
    values = lay.values[:-1] + (torch.zeros_like(lay.values[-1]),)
    return with_layout(params, group, name,
                       dataclasses.replace(lay, values=values))


def grow_ring(cache, pos):
    """A prefill cache whose KV ring (if any) has one more, free slot: the
    next decode step, at ``pos``, evicts no position."""
    kv = cache.get("kv")
    if kv is not None:
        pad = torch.zeros_like(kv["k"][:, :, :1])
        kv["k"] = torch.cat([kv["k"], pad], 2)
        kv["v"] = torch.cat([kv["v"], pad], 2)
        kv["pos"] = torch.cat([kv["pos"],
                               torch.full_like(kv["pos"][:, :1], pos)], 1)
    return cache


def cast_tree(tree, dtype):
    """A param tree with every bf16 leaf cast to ``dtype``."""
    if isinstance(tree, dict):
        return {k: cast_tree(v, dtype) for k, v in tree.items()}
    return tree.to(dtype) if tree.dtype == torch.bfloat16 else tree


def layer_chain(mods, params, cfg, tokens):
    """``forward`` layer by layer: (the residual entering each layer and
    the last layer's output, n_layers + 1 of them; logits (B, S, V))."""
    T, L = mods["T"], mods["L"]
    positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                             device=tokens.device)
    xs = [L.embed(params["embed"], tokens)]
    for lp in T.layer_params(params):
        xs.append(T._layer_fwd(lp, xs[-1], positions, cfg)[0])
    return xs, L.unembed(params["head"], L.rmsnorm(params["norm_f"], xs[-1]))


def mixer_gaps(mods, exec_p, dense_p, xs):
    """Per layer: the mixer (``ssm``) with packed and with masked-dense
    params on the same normed input (from the layer inputs ``xs``):
    (max, mean) relative gaps."""
    T, L, SSM = mods["T"], mods["L"], mods["SSM"]
    gaps = []
    for lp_x, lp_d, x in zip(T.layer_params(exec_p), T.layer_params(dense_p),
                             xs):
        h = L.rmsnorm(lp_x["ln1"], x)
        gaps.append(logit_gap(SSM.ssm(lp_d["ssm"], h)[0],
                              SSM.ssm(lp_x["ssm"], h)[0]))
    return gaps


def state_on_layer_output(mods, params, cfg, tokens):
    """Each layer's mixer state on its normed OUTPUT: what the reference's
    hybrid prefill caches (a planted fault of the port's decode)."""
    T, L, SSM = mods["T"], mods["L"], mods["SSM"]
    xs, _ = layer_chain(mods, params, cfg, tokens)
    states = [SSM.ssm(lp["ssm"], L.rmsnorm(lp["ln1"], x))[1]
              for lp, x in zip(T.layer_params(params), xs[1:])]
    return {k: torch.stack([st[k] for st in states]) for k in states[0]}


def decode_forward_gap(mods, params, cfg, tokens, fault=None):
    """max |decode_step at S - 1 after prefill(S - 1) - forward(S) at
    S - 1| / max |forward|; ``fault(cache)`` edits the prefill cache
    first."""
    T, E = mods["T"], mods["E"]
    Sq = tokens.shape[1]
    want = T.forward(params, cfg, tokens)[:, -1]
    _, cache = E.prefill(params, cfg, tokens[:, :-1])
    cache = grow_ring(cache, Sq - 1)
    if fault is not None:
        fault(cache)
    pos = torch.full((tokens.shape[0], 1), Sq - 1, dtype=torch.int32,
                     device=tokens.device)
    got, _ = T.decode_step(params, cfg, tokens[:, -1:], cache, pos)
    return ((got[:, 0].float() - want.float()).abs().max()
            / want.float().abs().max()).item()


def ssm_serve_phase(mods, arch):
    """``arch`` (mamba2-1.3b or hymba-1.5b) at full width, depth cut to
    SSM_LAYERS, through the port's entry points: bf16, seed 0, rate 0.6, 4 bins,
    B = 4 x 32, 16 new tokens; kernel 1's launches over the ``generate``
    asserted; bf16 prefill logits vs masked-dense and a planted fault;
    then fp32 at 2 layers (TF32 off): logits and greedy tokens packed vs
    masked-dense, and ``decode_step`` after ``prefill`` vs ``forward``,
    each with a planted fault; compile seconds and peak memory."""
    T, C, E = mods["T"], mods["C"], mods["E"]
    full = ssm_config(arch)
    cfg = full.replace(n_layers=min(SSM_LAYERS[arch], full.n_layers))
    projs = ssm_projections(cfg)
    if DEV == "cuda":
        torch.cuda.reset_peak_memory_stats()
    print(f"[ssm] {arch} at full width, depth cut to {cfg.n_layers} of "
          f"{full.n_layers} layers ("
          f"d_model {cfg.d_model}, d_inner {cfg.ssm_expand * cfg.d_model}, "
          f"SSD heads {cfg.ssm_expand * cfg.d_model // cfg.ssm_headdim} x "
          f"{cfg.ssm_headdim}, state {cfg.ssm_state}"
          + (f", attention {cfg.n_heads}/{cfg.n_kv_heads} x {cfg.hd} "
             f"window {cfg.sliding_window}, d_ff {cfg.d_ff}"
             if cfg.family == "hybrid" else "")
          + f", vocab {cfg.vocab})")
    pm, exec_p, report, init_s, compile_s, masks = build_served(
        mods, cfg, torch.bfloat16)
    del masks
    print(f"init + masks {init_s:.2f}s; compile_model {compile_s:.2f}s:")
    print(C.compiled_summary(report))
    lays = {name: node["packed"] for g in exec_p["layers"].values()
            if isinstance(g, dict) for name, node in g.items()
            if isinstance(node, dict) and "packed" in node}
    want_blocks = {name: blk for name, _, _, _, blk in projs}
    if ({n: lay.block for n, lay in lays.items()} != want_blocks
            or any(lay.n_bins != min(N_BINS, lay.Nb)
                   for lay in lays.values())):
        raise AssertionError(f"expected {want_blocks} packed in {N_BINS} "
                             f"bins: {C.compiled_summary(report)}")
    e2e, launches, prompts, tokens = serve_counted(
        mods, exec_p, cfg, full, compile_s, f"{arch}: one launch a packed "
        f"projection over the {N_BINS} bins, the hybrid state from the "
        f"mixer's one run", per_layer=len(projs))

    if DEV == "cuda":
        e2e["serve_peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    if cfg.family == "hybrid":
        e2e["engine"] = engine_phase(
            mods, exec_p, cfg, arch, len(projs),
            generate_busy_share=e2e.get("device", {}).get(
                "decode_busy_share"))

    # bf16 gates.  Each layer's mixer, packed vs masked-dense on one input
    # (the packed run's), within yi-9b's bounds.  The whole model is held
    # to the bf16 noise floor instead: its logits drift from the fp32
    # masked-dense model's through the depth's roundings (masked-dense
    # bf16 drifts as far), so the packed bf16 model must stay within
    # BF16_NOISE_FACTOR of the masked-dense bf16 model's distance to it
    fault_name = "in_proj" if cfg.family == "ssm" else "out_proj"
    faulty = dropped_last_bin(exec_p, fault_name)
    with torch.no_grad():
        xs, s_logits = layer_chain(mods, exec_p, cfg, tokens)
        layer_gaps = mixer_gaps(mods, exec_p, pm, xs[:-1])
        fault_gaps = mixer_gaps(mods, faulty, pm, xs[:-1])
        del xs
        d_logits = layer_chain(mods, pm, cfg, tokens)[1]
        f_logits = layer_chain(mods, faulty, cfg, tokens)[1]
        pm32 = cast_tree(pm, torch.float32)
        del pm, faulty
        d32 = layer_chain(mods, pm32, cfg, tokens)[1]
        del pm32
        gap = logit_gap(d_logits, s_logits)
        floor = logit_gap(d32, d_logits)
        packed32 = logit_gap(d32, s_logits)
        fault32 = logit_gap(d32, f_logits)
    sync()
    agree = (d32.argmax(-1) == s_logits.argmax(-1)).float().mean().item()
    agree_d = (d32.argmax(-1) == d_logits.argmax(-1)).float().mean().item()

    def near_floor(g):
        return all(a <= BF16_NOISE_FACTOR * b for a, b in zip(g, floor))
    worst = max(layer_gaps, key=lambda g: g[0])
    worst_f = max(fault_gaps, key=lambda g: g[0])
    print(f"[ssm] {arch} per-layer ssm() packed vs masked-dense on the "
          f"packed run's input (bf16): worst layer {worst[0]:.4f} / "
          f"{worst[1]:.4f} (bound {LOGIT_MAX_REL} / {LOGIT_MEAN_REL}); "
          f"planted fault, ssm/{fault_name}: last bin dropped, every layer: "
          f"worst layer {worst_f[0]:.4f} / {worst_f[1]:.4f}"
          f"{'  (NOT CAUGHT)' if all(map(within_bound, fault_gaps)) else ''}")
    print(f"[ssm] {arch} whole-model logits (B x S positions) against the "
          f"fp32 masked-dense model: masked-dense bf16 {floor[0]:.4f} / "
          f"{floor[1]:.4f} (argmax agree {agree_d:.3f}), packed bf16 "
          f"{packed32[0]:.4f} / {packed32[1]:.4f} (argmax agree {agree:.3f};"
          f" bound {BF16_NOISE_FACTOR} x the masked-dense bf16 gap), planted "
          f"fault {fault32[0]:.4f} / {fault32[1]:.4f}"
          f"{'  (NOT CAUGHT)' if near_floor(fault32) else ''}; packed vs "
          f"masked-dense bf16 {gap[0]:.4f} / {gap[1]:.4f} (printed, not "
          f"gated)")
    e2e.update(layer_gaps=layer_gaps, fault_layer_gaps=fault_gaps,
               logits_gap_bf16=gap, bf16_vs_fp32_dense=floor,
               bf16_vs_fp32_packed=packed32, bf16_vs_fp32_fault=fault32,
               argmax_agree_fp32_packed=agree,
               argmax_agree_fp32_dense=agree_d)
    if not (torch.isfinite(s_logits).all()
            and all(map(within_bound, layer_gaps))
            and near_floor(packed32)):
        raise AssertionError(f"{arch}: packed bf16 disagrees with "
                             f"masked-dense beyond the stated bounds")
    if all(map(within_bound, fault_gaps)) or near_floor(fault32):
        raise AssertionError(f"{arch}: a bf16 bound does not catch the "
                             f"dropped ssm/{fault_name} bin")
    del exec_p, s_logits, d_logits, f_logits, d32
    if DEV == "cuda":
        e2e["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        print(f"[ssm] {arch} peak device memory: serve "
              f"{e2e['serve_peak_mem_gb']:.2f} GB, with the bf16 gates' "
              f"fp32 oracle {e2e['peak_mem_gb']:.2f} GB (torch.cuda."
              f"max_memory_allocated)")
        torch.cuda.empty_cache()

    cfg32 = full.replace(n_layers=2)
    pm, exec_p, _, _, _, _ = build_served(mods, cfg32, torch.float32)
    with torch.no_grad():
        d32 = T.forward(pm, cfg32, tokens)
        gap32 = logit_gap(d32, T.forward(exec_p, cfg32, tokens))[0]
        fault32 = logit_gap(d32, T.forward(
            dropped_last_bin(exec_p, fault_name), cfg32, tokens))[0]
        tok_d = E.generate(pm, cfg32, prompts, N_NEW, device=DEV)
        tok_s = E.generate(exec_p, cfg32, prompts, N_NEW, device=DEV)
        dec = decode_forward_gap(mods, exec_p, cfg32, tokens)
        if cfg.family == "ssm":
            bad_name = "h zeroed"

            def bad(cache):
                cache["ssm"]["h"].zero_()
        else:
            bad_name = "the reference's state (mixer on the layer output)"
            wrong = state_on_layer_output(mods, exec_p, cfg32,
                                          tokens[:, :-1])

            def bad(cache):
                cache["ssm"] = wrong
        dec_fault = decode_forward_gap(mods, exec_p, cfg32, tokens, bad)
    same = bool(torch.equal(tok_d, tok_s))
    print(f"[ssm] {arch} fp32 (2 layers, TF32 off): logits packed vs "
          f"masked-dense {gap32:.2e} of max|logit| (bound "
          f"{MOE_FP32_LOGIT_REL}), planted fault {fault32:.3f}; greedy "
          f"tokens identical: {same}; decode_step after prefill({S - 1}) "
          f"vs forward({S}) at position {S - 1}: {dec:.2e} of max|logit| "
          f"(bound {DECODE_FORWARD_REL}), planted fault ({bad_name}) "
          f"{dec_fault:.3f}")
    e2e.update(fp32_logit_gap=gap32, fp32_fault=fault32,
               fp32_tokens_identical=same, decode_vs_forward=dec,
               decode_vs_forward_fault=dec_fault, compile_s=compile_s)
    if not (gap32 <= MOE_FP32_LOGIT_REL and same
            and dec <= DECODE_FORWARD_REL):
        raise AssertionError(f"{arch}: an fp32 gate failed")
    if fault32 <= MOE_FP32_LOGIT_REL or dec_fault <= DECODE_FORWARD_REL:
        raise AssertionError(f"{arch}: an fp32 gate does not catch its "
                             f"planted fault")
    if cfg.family == "hybrid":
        e2e["engine"]["fp32"] = engine_fp32_gate(mods, exec_p, cfg32, arch)
    del exec_p, pm
    if DEV == "cuda":
        torch.cuda.empty_cache()
    return e2e, launches


def ssm_entry(rows, launches, checks):
    """Kernel 1's ``ssm`` branch: the launches of each serve, the checks,
    and the timing rows and per-layer sums of both archs."""
    n, err, n8, err8 = checks
    out = {"launches_by_path": {f"{a} generate": launches[a]["bsr_matmul"]
                                for a in SSM_ARCHS},
           "float_cases": n, "max_abs_err": err, "int8_cases": n8,
           "int8_max_abs_err": err8,
           "measured_at": f"sum over one layer's packed projections, bf16, "
                          f"rate 0.6, 4 bins, {SSM_BLOCK} blocks on ssm "
                          f"in/out_proj and {BLOCK} on attention and FFN; "
                          f"decode M=4, prefill M={B * S}; library = "
                          f"torch.matmul on the masked dense weight"}
    for arch in SSM_ARCHS:
        out[arch] = {
            "decode": layer_sum(rows[arch], 4),
            "prefill": layer_sum(rows[arch], B * S),
            "shapes": [{"layer": f"{arch}/{r['proj']}", "M": r["M"],
                        "K": r["K"], "N": r["N"], "ms": r["ms"],
                        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                        "plain_ms": r["plain_ms"],
                        "library_ms": r["library_ms"],
                        "stream_ms": r["stream_ms"]} for r in rows[arch]]}
    return out


def mapped_entry(rows, launches, checks, max_err, e2e):
    """Kernel 1's ``mapped`` branch: the mapped yi-9b generate's launches,
    the checks at the mapped blocks, and a layer's sums at decode and
    prefill with int8 values (served) and float."""
    return {"launches": launches["bsr_matmul"], "cases": checks,
            "max_abs_err": max_err,
            "blocks": sorted({str(r["block"]) for r in rows["int8"]}),
            **{v: {"decode": layer_sum(rows[v], 4),
                   "prefill": layer_sum(rows[v], B * S)} for v in rows},
            "shapes": [{"layer": f"yi-9b/{r['proj']}", "block": r["block"],
                        "values": v, "M": r["M"], "K": r["K"], "N": r["N"],
                        "ms": r["ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "plain_ms": r["plain_ms"],
                        "library_ms": r["library_ms"],
                        "stream_ms": r["stream_ms"]}
                       for v in rows for r in rows[v]],
            "serve": {k: e2e[k] for k in ("prefill_ms", "decode_ms_per_token",
                                          "tok_per_s", "logits_gap",
                                          "fp32_logit_gap") if k in e2e},
            "measured_at": f"yi-9b under map_rules' picks on V5E (tokens "
                           f"{B * S}, compression {MAP_COMPRESSION:.2f}), "
                           f"rate 0.6, 4 bins; a layer's projections "
                           f"summed at decode M=4 and prefill M={B * S}, "
                           f"bf16 x; library = torch.matmul on the bf16 "
                           f"masked dense weight"}


def int8_entry(launches, max_err, ms, plain_ms, bound_ms, bound_by,
               library_ms, **extra):
    """The ``int8`` branch of a kernel's JSON entry."""
    return dict({"launches": launches, "max_abs_err": max_err, "ms": ms,
                 "plain_ms": plain_ms, "bound_ms": bound_ms,
                 "bound_by": bound_by, "library_ms": library_ms}, **extra)


# -- the continuous-batching engine (serve.engine.ServingEngine) -------------

def engine_prompts(cfg):
    """ENGINE_REQUESTS seeded prompts, ENGINE_PROMPTS tokens in turn."""
    rng = np.random.RandomState(1)
    return [rng.randint(1, cfg.vocab, size=ENGINE_PROMPTS[i % 2]).tolist()
            for i in range(ENGINE_REQUESTS)]


def new_engine(mods, exec_p, cfg, **kw):
    """A ServingEngine of ENGINE_SLOTS slots (``kw``: its other options):
    its step captured once on the card (eager on the CPU rehearsal)."""
    eng = mods["E"].ServingEngine(exec_p, cfg, n_slots=ENGINE_SLOTS,
                                  seq_cap=ENGINE_SEQ_CAP, device=DEV, **kw)
    want = 1 if DEV == "cuda" else 0
    if eng.stats["graph_captures"] != want:
        raise AssertionError(f"expected {want} graph capture per engine, "
                             f"got {eng.stats['graph_captures']}")
    return eng


def warm_ups(eng):
    """The uncaptured forwards an engine ran while it captured: on the card
    the step's warm-up, and a dense engine's prefill warm-up at its
    largest bucket (a capture records launches without running them, and
    the engine counts a replay's launches where it runs); the CPU
    rehearsal captures nothing and runs every step eagerly."""
    if DEV != "cuda":
        return 0
    return 1 + bool(eng.stats["prefill_captures"])


def engine_serve(mods, exec_p, cfg, prompts, rate=0, poison=(), **kw):
    """``prompts`` through a new engine, N_NEW tokens each, arriving at
    ``rate`` a step (0: all at step 0); the slots in ``poison`` get NaN
    rows after the second step; ``kw`` goes to the engine.  Returns (engine, each request's tokens,
    wall seconds of the run, ms of each decode-only step: every slot
    that ran was already live, the number of steps that ran the decode
    step)."""
    KV = mods["KV"]
    eng = new_engine(mods, exec_p, cfg, **kw)
    rids = [eng.submit(p, N_NEW, arrival=int(i / rate) if rate else 0)
            for i, p in enumerate(prompts)]
    step_ms, runs = [], 0
    sync()
    t0 = time.perf_counter()
    while eng.sched.has_work():
        admitted, t = eng.stats["admitted"], time.perf_counter()
        ran = eng.step() > 0
        runs += ran
        if ran and eng.stats["admitted"] == admitted:
            step_ms.append((time.perf_counter() - t) * 1e3)
        if eng.stats["steps"] == 2:
            for slot in poison:
                KV.poison_slot(eng.cache, slot)
    sync()
    return (eng, [eng.requests[r].tokens for r in rids],
            time.perf_counter() - t0, step_ms, runs)


def copy_cache(cache):
    return {g: {k: t.clone() for k, t in d.items()}
            for g, d in cache.items()}


def step_gate(mods, exec_p, cfg, prompts):
    """A new engine, the first ENGINE_SLOTS prompts admitted, then its
    first step replayed from the graph against the eager
    ``decode_step_ragged`` on a copy of the same cache.  Returns (engine,
    bitwise equal: logits, next tokens, finite probe and the written
    cache)."""
    T = mods["T"]
    eng = new_engine(mods, exec_p, cfg)
    for p in prompts[:ENGINE_SLOTS]:
        eng.submit(p, N_NEW)
    eng._admit()
    copy = copy_cache(eng.cache)
    ops = torch.as_tensor(eng._ops, device=DEV)
    with torch.no_grad():
        want, _ = T.decode_step_ragged(exec_p, cfg, ops[0][:, None], copy,
                                       ops[1][:, None], ops[2])
    nxt, ok = eng._run()
    sync()
    last = want[:, -1].float()
    same = (torch.equal(eng.logits, want)
            and (nxt == last.argmax(-1).int().cpu().numpy()).all()
            and (ok == torch.isfinite(last).all(-1).int().cpu().numpy()).all()
            and all(torch.equal(t, copy[g][k]) for g, d in eng.cache.items()
                    for k, t in d.items()))
    return eng, bool(same)


def slot_references(mods, exec_p, cfg, prompts):
    """Each of the first ENGINE_SLOTS requests' first-step logits by a
    B = 1 ``prefill`` and ``decode_step``: what its slot must give."""
    T, E = mods["T"], mods["E"]
    out = []
    with torch.no_grad():
        for p in prompts[:ENGINE_SLOTS]:
            logits, cache = E.prefill(exec_p, cfg, torch.tensor([p],
                                                                device=DEV))
            tok = logits[:, -1].argmax(-1)[:, None].to(torch.int32)
            pos = torch.full((1, 1), len(p), dtype=torch.int32, device=DEV)
            out.append(T.decode_step(exec_p, cfg, tok, cache, pos)[0][0])
    return out


def slot_gaps(logits, refs):
    """(max, mean) relative gap of each slot's logits to its B = 1
    reference, and how many argmaxes agree."""
    gaps = [logit_gap(r, logits[i]) for i, r in enumerate(refs)]
    agree = sum(int(logits[i, -1].argmax() == r[-1].argmax())
                for i, r in enumerate(refs))
    return gaps, agree


def eager_step_launches(mods, params, cfg, key="bsr_matmul"):
    """Kernel-1 launches (``LAUNCHES[key]``) of one eager
    ``decode_step_ragged`` over an all-free slot cache."""
    T, K, KV = mods["T"], mods["K"], mods["KV"]
    cache = KV.init_slots(params, cfg, ENGINE_SLOTS, ENGINE_SEQ_CAP,
                          dtype=params["embed"]["table"].dtype)
    zero = torch.zeros((ENGINE_SLOTS, 1), dtype=torch.int32, device=DEV)
    one = torch.ones((ENGINE_SLOTS,), dtype=torch.int32, device=DEV)
    before = K.LAUNCHES[key]
    with torch.no_grad():
        T.decode_step_ragged(params, cfg, zero, cache, zero, one)
    sync()
    return K.LAUNCHES[key] - before


def neighbour_write(real):
    """A planted fault: the prefill written into the next slot's row."""
    def write(cache, slot, rc):
        return real(cache, (slot + 1) % ENGINE_SLOTS, rc)
    return write


def rebinding_write(real):
    """A planted fault: the slot cache copied and the copy written (its
    tensors rebound), so a captured graph reads the stale ones."""
    def write(cache, slot, rc):
        return real(copy_cache(cache), slot, rc)
    return write


def ring_shifted_write(real):
    """A planted fault: the prefill's keys and values written one ring
    index late (positions in place)."""
    def write(cache, slot, rc):
        real(cache, slot, rc)
        for name in ("k", "v"):
            row = cache["kv"][name][:, slot]
            row.copy_(torch.roll(row, 1, dims=1))
        return cache
    return write


def quarantine_gate(toks, clean, eng, slots):
    """The request admitted into each of ``slots`` is quarantined with
    its first 3 tokens, every other request finishes with the tokens of
    the clean run."""
    reqs = [eng.requests[r] for r in sorted(eng.requests)]
    bad = [i for i, r in enumerate(reqs) if r.status == "quarantined"]
    return (bad == list(slots)
            and all(toks[i] == clean[i][:3] for i in slots)
            and all(r.status == "finished" and toks[i] == clean[i]
                    for i, r in enumerate(reqs) if i not in slots))


def engine_phase(mods, exec_p, cfg, arch, per_layer, dense_p=None,
                 generate_busy_share=None):
    """The continuous-batching engine on a phase's compiled bf16 params.

    Gates: the first step replayed from the graph == the eager step
    bitwise; each slot's first-step logits within the bf16 bound of a
    B = 1 ``decode_step`` of its request; launches of an eager step ==
    layers x ``per_layer``; one capture an engine; a poisoned slot
    quarantined alone.  Then the counted saturated run (ENGINE_REQUESTS
    requests at step 0; kernel 1 counted over construction, admissions
    and the run), the device busy share of one traced replayed step (its
    kernel-1 events held to the step's launches), the
    admission time, and (yi-9b, ``dense_p`` given) the open-loop run at
    one arrival a step and a planted fault breaking each gate (a rebound
    cache, the prefill in the neighbour's row, a dense ``down``, a second
    poisoned slot)."""
    K = mods["K"]
    stamp(f"engine: {arch}")
    t_phase = time.perf_counter()
    prompts = engine_prompts(cfg)
    per_step = cfg.n_layers * per_layer
    out = {"n_slots": ENGINE_SLOTS, "seq_cap": ENGINE_SEQ_CAP,
           "requests": ENGINE_REQUESTS, "prompts": ENGINE_PROMPTS,
           "new_tokens": N_NEW, "per_step_launches": per_step}
    refs = slot_references(mods, exec_p, cfg, prompts)

    eng, same = step_gate(mods, exec_p, cfg, prompts)
    gaps, agree = slot_gaps(eng.logits, refs)
    launches = eager_step_launches(mods, exec_p, cfg)
    trace = device_time(eng.step)
    del eng
    worst = max(gaps, key=lambda g: g[0])
    print(f"[engine] {arch}: graph replay == eager decode_step_ragged "
          f"bitwise: {same}; first-step logits of each slot vs a B = 1 "
          f"decode_step (bf16): worst {worst[0]:.4f} / {worst[1]:.4f} (bound "
          f"{LOGIT_MAX_REL} / {LOGIT_MEAN_REL}), argmax agree {agree} of "
          f"{ENGINE_SLOTS} (printed, not gated: M = {ENGINE_SLOTS} and "
          f"M = 1 take different kernel-1 paths); kernel-1 launches of an "
          f"eager step {launches} (expected {cfg.n_layers} layers x "
          f"{per_layer} = {per_step})")
    out.update(graph_equals_eager=same, first_step_gaps=gaps,
               first_step_argmax_agree=agree, eager_step_launches=launches)
    if not (same and all(map(within_bound, gaps)) and launches == per_step):
        raise AssertionError(f"{arch}: an engine step gate failed")

    # the main path: construction (warm-up + capture), admissions, run
    K.reset_launches()
    eng, clean, wall, step_ms, runs = engine_serve(mods, exec_p, cfg,
                                                   prompts)
    counted = dict(K.LAUNCHES)
    n_adm = eng.stats["admitted"]
    warm = warm_ups(eng)
    want = per_step * (warm + runs) + n_adm * per_step
    step = statistics.median(step_ms)
    sat = {"wall_s": wall, "tokens": eng.stats["tokens"],
           "tok_per_s": eng.stats["tokens"] / wall, "step_ms": step,
           "steps": eng.stats["steps"], "decode_steps": len(step_ms),
           "mean_occupancy": eng.mean_occupancy(), "launches": counted,
           "expected_launches": want, "decode_steps_run": runs}
    print(f"[engine] {arch} saturated ({ENGINE_REQUESTS} requests at step "
          f"0, {ENGINE_SLOTS} slots): {eng.stats['finished']} finished, "
          f"{eng.stats['tokens']} tokens in {wall:.3f} s = "
          f"{sat['tok_per_s']:.1f} tok/s (incl. {n_adm} admissions); "
          f"{eng.stats['steps']} steps, decode-only step {step:.3f} ms "
          f"(median of {len(step_ms)}); mean occupancy "
          f"{eng.mean_occupancy():.3f}; kernel-1 launches "
          f"{counted['bsr_matmul']} (expected ({warm} warm-up + {runs} "
          f"decode steps) x {per_step} + {n_adm} prefills x {per_step} "
          f"= {want})")
    if (counted["bsr_matmul"] != want
            or eng.stats["finished"] != ENGINE_REQUESTS
            or any(len(t) != N_NEW for t in clean)):
        raise AssertionError(f"{arch}: the saturated engine run is off")
    # one admission of each prompt length, timed (prefill + slot write)
    adm = {}
    for p in (prompts[0], prompts[1]):
        eng.submit(p, N_NEW)
        sync()
        t0 = time.perf_counter()
        eng._admit()
        sync()
        adm[len(p)] = (time.perf_counter() - t0) * 1e3
    del eng
    sat["admission_ms"] = adm
    if trace is None:
        print(f"[engine] {arch} busy share: not measured (the profiler saw "
              f"no device activity)")
    else:
        sat["device"] = trace
        sat["busy_share"] = trace["busy_ms"] / step
        traced = trace["by_kernel_events"].get("bsr_matmul_kernel", 0)
        print(f"[engine] {arch} one traced replayed step: device busy "
              f"{trace['busy_ms']:.3f} ms ({trace['bsr_ms']:.3f} in "
              f"bsr_matmul, {traced} kernel-1 events traced of {per_step} "
              f"launched) = {sat['busy_share']:.3f} of the unprofiled step "
              f"(generate's B = {B} decode step in this run: "
              + (f"{generate_busy_share:.3f})" if generate_busy_share
                 is not None else "not measured)"))
        sat["traced_kernel1_events"] = traced
        if traced != per_step:
            raise AssertionError(f"{arch}: a traced replayed step ran "
                                 f"{traced} kernel-1 kernels, not "
                                 f"{per_step}")
    print(f"[engine] {arch} admission (B = 1 prefill + slot write): "
          + ", ".join(f"{n} tokens {ms:.2f} ms" for n, ms in adm.items()))
    sat["generate_decode_busy_share"] = generate_busy_share
    out["saturated"] = sat

    # quarantine: a poisoned live slot is evicted alone
    eng, toks, *_ = engine_serve(mods, exec_p, cfg, prompts, poison=(3,))
    q_ok = quarantine_gate(toks, clean, eng, (3,))
    print(f"[engine] {arch} slot 3 poisoned after step 2: quarantined "
          f"{eng.stats['quarantined']}, every other request's tokens "
          f"unchanged: {q_ok}")
    out["quarantine"] = q_ok
    if not q_ok:
        raise AssertionError(f"{arch}: the quarantine gate failed")
    del eng

    if dense_p is not None:
        # open loop: one arrival a step
        eng, _, wall, step_ms, _ = engine_serve(mods, exec_p, cfg, prompts,
                                                rate=1)
        out["open_loop"] = {
            "rate_per_step": 1, "wall_s": wall,
            "tokens": eng.stats["tokens"],
            "tok_per_s": eng.stats["tokens"] / wall,
            "step_ms": statistics.median(step_ms) if step_ms else None,
            "steps": eng.stats["steps"],
            "mean_occupancy": eng.mean_occupancy()}
        ol = out["open_loop"]
        print(f"[engine] {arch} open loop (1 arrival a step): "
              f"{eng.stats['finished']} finished, {ol['tokens']} tokens in "
              f"{wall:.3f} s = {ol['tok_per_s']:.1f} tok/s; "
              f"{ol['steps']} steps, decode-only step "
              f"{ol['step_ms'] or float('nan'):.3f} ms (median of "
              f"{len(step_ms)}), mean occupancy "
              f"{ol['mean_occupancy']:.3f}")
        if eng.stats["finished"] != ENGINE_REQUESTS:
            raise AssertionError(f"{arch}: the open-loop run is off")
        del eng
        out["faults"] = engine_faults(mods, exec_p, dense_p, cfg, prompts,
                                      refs, clean, per_step)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"[engine] {arch} phase {out['phase_s']:.1f} s")
    return out


def engine_faults(mods, exec_p, dense_p, cfg, prompts, refs, clean,
                  per_step):
    """A planted fault for each engine gate, each of which must break it."""
    KV = mods["KV"]
    faults = {}
    with mock.patch.object(KV, "write_prefill",
                           rebinding_write(KV.write_prefill)):
        eng, same = step_gate(mods, exec_p, cfg, prompts)
    faults["cache rebound, not written in place: graph == eager"] = same
    # on the CPU rehearsal the step is eager, and the rebound cache is
    # read as it should be: no graph to catch
    caught = {"rebound": not same or DEV != "cuda"}
    with mock.patch.object(KV, "write_prefill",
                           neighbour_write(KV.write_prefill)):
        eng, _ = step_gate(mods, exec_p, cfg, prompts)
        gaps, _ = slot_gaps(eng.logits, refs)
    worst = max(gaps, key=lambda g: g[0])
    faults["prefill in the neighbour's row: worst first-step gap"] = worst
    caught["neighbour"] = not all(map(within_bound, gaps))
    layers = dict(exec_p["layers"], ffn=dict(exec_p["layers"]["ffn"]))
    layers["ffn"]["down"] = {"w": dense_p["layers"]["ffn"]["down"]["w"]}
    n = eager_step_launches(mods, dict(exec_p, layers=layers), cfg)
    faults["ffn/down served dense: eager-step launches"] = n
    caught["launches"] = n != per_step
    eng, toks, *_ = engine_serve(mods, exec_p, cfg, prompts,
                                 poison=(3, 4))
    q = quarantine_gate(toks, clean, eng, (3,))
    faults["slots 3 and 4 poisoned: slot 3's gate holds"] = q
    caught["quarantine"] = not q
    del eng
    for name, v in faults.items():
        print(f"  [engine] planted fault, {name}: {v}")
    if not all(caught.values()):
        raise AssertionError(f"an engine gate misses its planted fault: "
                             f"{caught}")
    return {"readings": faults, "caught": caught}


def engine_fp32_gate(mods, exec32, cfg32, arch, fault=False):
    """The fp32 model at 2 layers (TF32 off): the engine's tokens (the
    saturated workload) equal one B = 1 ``generate`` per request; with
    ``fault``, the prefill's keys and values written one ring index late
    must change some request's tokens."""
    E, KV = mods["E"], mods["KV"]
    prompts = engine_prompts(cfg32)
    with torch.no_grad():
        want = [E.generate(exec32, cfg32, np.asarray([p]), N_NEW,
                           device=DEV)[0].tolist() for p in prompts]
    _, toks, *_ = engine_serve(mods, exec32, cfg32, prompts)
    same = toks == want
    out = {"fp32_tokens_equal_generate": same}
    msg = ""
    if fault:
        with mock.patch.object(KV, "write_prefill",
                               ring_shifted_write(KV.write_prefill)):
            _, bad, *_ = engine_serve(mods, exec32, cfg32, prompts)
        n_diff = sum(a != b for a, b in zip(bad, want))
        out["ring_shift_fault_requests_differing"] = n_diff
        msg = (f"; planted fault (keys and values one ring index late): "
               f"{n_diff} of {len(prompts)} requests differ")
    print(f"[engine] {arch} fp32 ({cfg32.n_layers} layers, TF32 off): "
          f"engine tokens == one B = 1 generate per request for all "
          f"{len(prompts)}: {same}{msg}")
    if not same:
        raise AssertionError(f"{arch}: fp32 engine tokens differ from "
                             f"generate")
    if fault and not out["ring_shift_fault_requests_differing"]:
        raise AssertionError(f"{arch}: the fp32 token gate misses the "
                             f"ring-shift fault")
    return out


# -- robustness: validation, degraded mode, the artifact store ----------------

def first_step_logits(mods, params, cfg, prompts, **kw):
    """A new engine (``kw``: its options) with the first ENGINE_SLOTS
    prompts admitted and one step run: (engine, the step's logits)."""
    eng = new_engine(mods, params, cfg, **kw)
    for p in prompts[:ENGINE_SLOTS]:
        eng.submit(p, N_NEW)
    eng._admit()
    eng._run()
    sync()
    return eng, eng.logits.clone()


def layouts_equal(ART, a, b):
    """Two exec trees hold the same layouts at the same nodes, leaf for
    leaf (``torch.equal``), and the same other keys."""
    if isinstance(a, dict) != isinstance(b, dict):
        return False
    if not isinstance(a, dict):
        return True
    if list(a) != list(b):
        return False
    for k in a:
        if k == "packed":
            la, lb = dict(ART._layout_leaves(a[k])), dict(
                ART._layout_leaves(b[k]))
            if list(la) != list(lb) or a[k].shape != b[k].shape:
                return False
            for n, t in la.items():
                u = lb[n]
                if (t is None) != (u is None) or (
                        t is not None and not (t.dtype == u.dtype
                                               and torch.equal(t, u))):
                    return False
        elif not layouts_equal(ART, a[k], b[k]):
            return False
    return True


@contextlib.contextmanager
def log_messages(name):
    """The messages logger ``name`` emits at INFO and above meanwhile."""
    logger, messages = logging.getLogger(name), []
    handler = logging.Handler(logging.INFO)
    handler.emit = lambda r: messages.append(r.getMessage())
    level = logger.level
    logger.setLevel(logging.INFO)
    logger.addHandler(handler)
    try:
        yield messages
    finally:
        logger.removeHandler(handler)
        logger.setLevel(level)


def artifact_round_trip(mods, pm, masks, cfg):
    """``compile_model(artifact_dir=)`` cold (packs and publishes) and warm
    (loads and grafts, no pack) into a temporary store: times, MiB on
    disk, the warm layouts == the cold ones, greedy tokens and kernel-1
    launches equal; then a torn store (``crash_publish``) logs its
    fallback and repacks."""
    import tempfile
    C, E, K, ops, ART, F = (mods["C"], mods["E"], mods["K"], mods["ops"],
                            mods["ART"], mods["F"])
    from repro_torch.launch.serve import SPARSE_SPEC
    spec = C.CompileSpec(keep_dense=False)
    prompts = np.random.RandomState(0).randint(0, cfg.vocab, size=(B, S))
    out = {}

    digests = []           # (key, seconds) of each compile's digest
    real_digest = ART.model_digest

    def timed_digest(*a, **k):
        t0 = time.perf_counter()
        key = real_digest(*a, **k)
        digests.append((key, time.perf_counter() - t0))
        return key

    def compile_into(d):
        ops.clear_pack_cache()           # each start a fresh process's
        sync()
        t0 = time.perf_counter()
        with mock.patch.object(ops, "pack", wraps=ops.pack) as packs, \
                mock.patch.object(ART, "model_digest", timed_digest):
            ex, rep = C.compile_model(pm, masks, SPARSE_SPEC, spec=spec,
                                      device=DEV, artifact_dir=d)
        sync()
        return ex, rep, time.perf_counter() - t0, packs.call_count

    def counted_generate(ex):
        K.reset_launches()
        with torch.no_grad():
            toks = E.generate(ex, cfg, prompts, N_NEW, device=DEV)
        sync()
        return toks, K.LAUNCHES["bsr_matmul"]

    with tempfile.TemporaryDirectory() as d:
        with log_messages("repro_torch.serve.artifacts") as log:
            cold, cold_rep, cold_s, cold_packs = compile_into(d)
            mib = sum(f.stat().st_size for f in Path(d).rglob("*")
                      if f.is_file()) / 2**20
            warm, warm_rep, warm_s, warm_packs = compile_into(d)
        same = layouts_equal(ART, cold, warm)
        toks_c, n_c = counted_generate(cold)
        toks_w, n_w = counted_generate(warm)
        del warm
        warm_ok = any("warm start" in m for m in log)
        key = digests[0][0]
        rec = F.crash_publish(d, key, stage="torn")
        with log_messages("repro_torch.serve.artifacts") as log2:
            torn, _, torn_s, torn_packs = compile_into(d)
        fell_back = any("fresh pack [corrupt]" in m for m in log2)
        republished = (Path(d) / key / ART.MANIFEST_FILE).exists()
        torn_same = layouts_equal(ART, cold, torn)
        del torn, cold
    tok_same = bool(torch.equal(toks_c, toks_w))
    digest_s = [t for _, t in digests]
    out.update(digest_s=digest_s, cold_s=cold_s, warm_s=warm_s,
               torn_s=torn_s, mib_on_disk=mib, cold_packs=cold_packs,
               warm_packs=warm_packs, torn_packs=torn_packs,
               warm_layouts_equal=same, warm_start_logged=warm_ok,
               tokens_equal=tok_same, launches_cold=n_c, launches_warm=n_w,
               torn=dict(vars(rec)), torn_fell_back=fell_back,
               torn_republished=republished, torn_layouts_equal=torn_same,
               report_rows_equal=(cold_rep.to_json()["layers"]
                                  == warm_rep.to_json()["layers"]))
    print(f"[robustness] artifact store ({cfg.n_layers} layers): cold "
          f"compile_model(artifact_dir=) {cold_s:.2f} s ({cold_packs} packs, "
          f"publish incl.); warm {warm_s:.2f} s ({warm_packs} packs, load + "
          f"checksum + validate incl.); the model digest in each "
          f"(cold, warm, torn) {', '.join(f'{t:.2f}' for t in digest_s)} s; "
          f"{mib:.1f} MiB on disk; warm layouts == cold leaf for leaf: "
          f"{same}; greedy tokens equal: {tok_same}, kernel-1 launches "
          f"{n_c} / {n_w}; torn store ({rec.detail}): fallback logged "
          f"{fell_back}, repacked ({torn_packs} packs) in {torn_s:.2f} s, "
          f"republished {republished}")
    if not (same and warm_ok and warm_packs == 0 and cold_packs > 0
            and len({k for k, _ in digests}) == 1
            and tok_same and n_c == n_w > 0 and out["report_rows_equal"]
            and fell_back and torn_packs > 0 and republished and torn_same):
        raise AssertionError(f"the artifact round trip failed: {out}")
    return out, n_w


def vgg_degraded(mods):
    """VGG_TINY punched (B = CONV_B, fp32) with one bit-flipped conv layout
    retired to dense: logits within CONV_LOGIT_REL of masked-dense, the
    retired layer's kernel launched once fewer a forward than the clean
    layouts imply; the corrupt tree run unvalidated breaks the bound, its
    logits non-finite."""
    RW, CN, C, K, ops, F = (mods["RW"], mods["CN"], mods["C"], mods["K"],
                            mods["ops"], mods["F"])
    from repro_torch.train.trainer import apply_masks
    name, spec = conv_mappings(RW)[0]
    params = CN.convnet_init(CN.VGG_TINY, seed=0, device=DEV)
    gen = torch.Generator(device=DEV)
    gen.manual_seed(0)
    x, _ = CN.synthetic_images(gen, CONV_B, size=CONV_HW)
    masks = conv_masks(RW, name, params, spec)
    pm = apply_masks(params, masks)
    exec_p, _ = C.compile_model(pm, masks, spec,
                                spec=C.CompileSpec(keep_dense=True),
                                device=DEV)
    bad, rec = F.bitflip_packed_leaf(exec_p, seed=0)
    tree, _, degraded = C.degrade_invalid_layers(bad)
    clean = expected_conv_launches(ops, CN.VGG_TINY, exec_p, CONV_HW, CONV_B)
    want = expected_conv_launches(
        ops, CN.VGG_TINY, dict(exec_p, **{rec.target: pm[rec.target]}),
        CONV_HW, CONV_B)
    K.reset_launches()
    sync()
    with torch.no_grad():
        logits = CN.convnet_apply(tree, x, CN.VGG_TINY)
    sync()
    launches = {k: v for k, v in K.LAUNCHES.items() if v}
    with torch.no_grad():
        dense = CN.convnet_apply(pm, x, CN.VGG_TINY)
        gap = conv_logit_gap(dense, logits)
        bad_logits = CN.convnet_apply(bad, x, CN.VGG_TINY)
        fault = conv_logit_gap(dense, bad_logits)
        fault_finite = bool(torch.isfinite(bad_logits).all())
    agree = (dense.argmax(-1) == logits.argmax(-1)).float().mean().item()
    fewer = {k: clean[k] - want.get(k, 0) for k in clean
             if clean[k] != want.get(k, 0)}
    print(f"[robustness] VGG_TINY {name} ({rec.target} bit-flipped: "
          f"{rec.detail}): {len(degraded)} layer retired; launches "
          f"{launches} (clean layouts {clean}, the retired layer's kernel "
          f"once fewer: {fewer}); logits vs masked-dense {gap:.2e} of "
          f"max|logit| (bound {CONV_LOGIT_REL}), argmax agree {agree:.3f}; "
          f"planted fault (the corrupt tree unvalidated): {fault}, logits "
          f"finite {fault_finite}")
    out = {"target": rec.target, "detail": rec.detail, "launches": launches,
           "clean_launches": clean, "logit_gap": gap, "argmax_agree": agree,
           "fault_gap": fault, "fault_logits_finite": fault_finite}
    if not (len(degraded) == 1 and launches == want
            and sum(fewer.values()) == 1 and gap <= CONV_LOGIT_REL
            and agree == 1.0 and torch.isfinite(logits).all()):
        raise AssertionError(f"VGG_TINY with a retired layer failed: {out}")
    if fault <= CONV_LOGIT_REL:      # NaN compares False: caught
        raise AssertionError("the conv bound misses the unvalidated "
                             "corrupt layout")
    if fault_finite:                 # the fused relu must pass NaN on
        raise AssertionError("the unvalidated corrupt layout gave finite "
                             "logits: a kernel lost its non-finite value")
    return out, launches


def robustness_phase(mods, pm, masks, cfg, full):
    """Layout validation, degraded mode and the artifact store on the
    serve phase's masked yi-9b (``pm``, bf16, full width), then VGG_TINY.

    ``validate_tree`` timed over the ``keep_dense=True`` compile; a clean
    validated engine retires nothing; ``bitflip_packed_leaf(seed=0)``
    (ffn/down) retires one stack: 1 degraded layer, kernel 1 at layers x
    6 a step, each slot's first-step bf16 logits within the engine's
    bound of the clean engine's, and the counted degraded run; the same
    tree served unvalidated must break that bound.  At 2 fp32 layers the
    degraded engine's tokens == a B = 1 ``generate`` over its own
    (degraded) tree.  Then the artifact round trip and VGG_TINY."""
    C, E, K, V, F = mods["C"], mods["E"], mods["K"], mods["V"], mods["F"]
    from repro_torch.core.packed import DegradedLayer
    from repro_torch.launch.serve import SPARSE_SPEC
    t_phase = time.perf_counter()
    exec_d, _ = C.compile_model(pm, masks, SPARSE_SPEC,
                                spec=C.CompileSpec(keep_dense=True),
                                device=DEV)
    sync()
    val_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        n_val = V.validate_tree(exec_d)
        sync()
        val_ms.append((time.perf_counter() - t0) * 1e3)
    prompts = engine_prompts(cfg)
    per_step = cfg.n_layers * 7
    eng, clean = first_step_logits(mods, exec_d, cfg, prompts)
    clean_degraded = eng.stats["degraded_layers"]
    del eng
    bad, rec = F.bitflip_packed_leaf(exec_d, seed=0)
    eng, deg = first_step_logits(mods, bad, cfg, prompts)
    n_deg = eng.stats["degraded_layers"]
    retired = sum(isinstance(lp.get("packed"), DegradedLayer)
                  for g in eng.params["layers"].values()
                  if isinstance(g, dict) for lp in g.values()
                  if isinstance(lp, dict))
    step_launches = eager_step_launches(mods, eng.params, cfg)
    replay_launches = (eng._replay_launches.get("bsr_matmul")
                       if DEV == "cuda" else step_launches)
    del eng
    _, unvalidated = first_step_logits(mods, bad, cfg, prompts,
                                       validate=False)
    gaps = [logit_gap(clean[i], deg[i]) for i in range(ENGINE_SLOTS)]
    fault_gaps = [logit_gap(clean[i], unvalidated[i])
                  for i in range(ENGINE_SLOTS)]
    worst = max(gaps, key=lambda g: g[0])
    print(f"[robustness] yi-9b ({cfg.n_layers} layers, bf16): "
          f"validate_tree of {n_val} layouts {val_ms[0]:.2f} ms first, "
          f"{statistics.median(val_ms[1:]):.2f} ms warm; a clean "
          f"validated engine retires {clean_degraded}; {rec.target} "
          f"bit-flipped ({rec.detail}): degraded_layers {n_deg}, kernel-1 "
          f"launches an eager step {step_launches} / a replayed step "
          f"{replay_launches} (expected {per_step} - {cfg.n_layers}); "
          f"first-step logits vs the clean engine's: worst "
          f"{worst[0]:.4f} / {worst[1]:.4f} (bound {LOGIT_MAX_REL} / "
          f"{LOGIT_MEAN_REL}); planted fault (served with validate=False): "
          f"{'caught' if not all(map(within_bound, fault_gaps)) else 'NOT CAUGHT'}"
          f" ({fault_gaps[0][0]} / {fault_gaps[0][1]} on slot 0)")
    want_step = per_step - cfg.n_layers
    if not (clean_degraded == 0 and n_deg == 1 and retired == 1
            and step_launches == replay_launches == want_step
            and all(map(within_bound, gaps))):
        raise AssertionError("the degraded engine's gates failed")
    if all(map(within_bound, fault_gaps)):
        raise AssertionError("the slot gate misses the unvalidated corrupt "
                             "layout")
    del deg, unvalidated

    # the main path with one retired stack, counted, and its step beside
    # the clean engine's
    _, _, _, clean_ms, _ = engine_serve(mods, exec_d, cfg, prompts)
    K.reset_launches()
    eng, toks, wall, deg_ms, runs = engine_serve(mods, bad, cfg, prompts)
    counted = K.LAUNCHES["bsr_matmul"]
    warm_up = warm_ups(eng)
    n_adm = eng.stats["admitted"]
    want = want_step * (warm_up + runs) + n_adm * want_step
    step_clean, step_deg = (statistics.median(clean_ms),
                            statistics.median(deg_ms))
    print(f"[robustness] yi-9b degraded engine (saturated, "
          f"{ENGINE_REQUESTS} requests): {eng.stats['finished']} finished, "
          f"decode-only step {step_deg:.3f} ms against the clean engine's "
          f"{step_clean:.3f} ms; kernel-1 launches {counted} (expected "
          f"({warm_up} warm-up + {runs} steps) x {want_step} + {n_adm} "
          f"prefills x {want_step} = {want})")
    if (counted != want or eng.stats["finished"] != ENGINE_REQUESTS
            or any(len(t) != N_NEW for t in toks)):
        raise AssertionError("the degraded engine run is off")
    del eng, bad, exec_d
    torch.cuda.empty_cache()

    # fp32 at 2 layers: the degraded engine == generate over its own tree
    cfg2 = full.replace(n_layers=2)
    pm32, masks32, _ = build_masked(mods, cfg2, torch.float32)
    ex32, _ = C.compile_model(pm32, masks32, SPARSE_SPEC,
                              spec=C.CompileSpec(keep_dense=True),
                              device=DEV)
    bad32, rec32 = F.bitflip_packed_leaf(ex32, seed=0)
    prompts32 = engine_prompts(cfg2)
    eng32, toks32, *_ = engine_serve(mods, bad32, cfg2, prompts32)
    with torch.no_grad():
        want32 = [E.generate(eng32.params, cfg2, np.asarray([p]), N_NEW,
                             device=DEV)[0].tolist() for p in prompts32]
    fp32_same = toks32 == want32
    fp32_deg = eng32.stats["degraded_layers"]
    print(f"[robustness] fp32 ({cfg2.n_layers} layers, TF32 off, "
          f"{rec32.target} retired): degraded engine tokens == one B = 1 "
          f"generate over the degraded tree for all {len(prompts32)}: "
          f"{fp32_same} (degraded_layers {fp32_deg})")
    if not (fp32_same and fp32_deg == 1):
        raise AssertionError("the fp32 degraded engine disagrees with "
                             "generate over its tree")
    del eng32, bad32, ex32, pm32, masks32
    torch.cuda.empty_cache()

    store, warm_launches = artifact_round_trip(mods, pm, masks, cfg)
    torch.cuda.empty_cache()
    vgg, vgg_launches = vgg_degraded(mods)
    out = {"validate_ms": val_ms, "validated_layouts": n_val,
           "target": rec.target, "detail": rec.detail,
           "degraded_layers": n_deg, "step_launches": step_launches,
           "replay_step_launches": replay_launches,
           "first_step_gaps": gaps, "fault_first_step_gaps": fault_gaps,
           "step_ms": step_deg, "clean_step_ms": step_clean,
           "degraded_engine_launches": counted, "fp32_tokens_equal":
           fp32_same, "artifacts": store, "vgg": vgg,
           "phase_s": time.perf_counter() - t_phase}
    print(f"[robustness] phase {out['phase_s']:.1f} s")
    return out, {"yi-9b degraded engine": counted,
                 "yi-9b warm-start generate": warm_launches,
                 "vgg": vgg_launches}


# -- tensor-parallel layouts on one card: the shard wrappers ------------------

TP = 4                   # yi-9b's degree: divides every projection's Nb
TP_SHARDS = (2, 4, 8)    # kernel 1's shard counts checked against plain
TP_CHECK_M = (4, 128)    # decode and prefill rows
TP_CONV = 2              # VGG_TINY's degree (kernel 2 also at 4)
TP_CKPT_LAYERS = 2       # the replica restart's depth (full width)
# the train CLI's resume at SMOKE: steps run through, the interrupted
# run's steps, the checkpoint interval; losses of the same step agree to
# this (relative) after the resume
TP_TRAIN = (6, 4, 2)
TP_RESUME_REL = 1e-5


def shard_fault(lay):
    """A planted fault: shard 0's column table shifted by one column (its
    ``perm`` rolled, ``inv_perm`` kept its inverse), so shard 0 writes each
    column's outputs into its neighbour's place.  Works on a stacked
    layout too (every layer's shard 0)."""
    perm = lay.perm.clone()
    perm[..., 0, :] = torch.roll(perm[..., 0, :], 1, dims=-1)
    flat = perm.reshape(tuple(perm.shape[:-2]) + (-1,)).long()
    inv = torch.empty_like(lay.inv_perm)
    inv.scatter_(-1, flat, torch.arange(flat.shape[-1], dtype=inv.dtype,
                                        device=inv.device).expand_as(flat))
    return dataclasses.replace(lay, perm=perm, inv_perm=inv)


def tp_kernel1_checks(mods, gen):
    """Kernel 1 through ``bsr_matmul_sharded`` at yi-9b's 7 projection
    shapes, S in TP_SHARDS, M in TP_CHECK_M, bf16 x with float and int8
    (a scale per block) values (fp32 x at S = TP, M = 4), bias + silu:
    against the sharded plain version at the kernel bounds, and against
    the unsharded kernel on the same weights (bitwise where both launches
    take a column's slots in the same chunks, else within the bound).
    Returns (cases, max abs err, bitwise cases, a planted fault's
    out-of-bound elements)."""
    RW, ops, ref, K = mods["RW"], mods["ops"], mods["ref"], mods["K"]
    cases, max_err, bitwise, fault = 0, 0.0, 0, None
    for name, Kd, Nd, _ in PROJECTIONS:
        for dtype in (torch.bfloat16, torch.float32):
            w, mask = weight_and_mask(RW, Kd, Nd, gen, dtype)
            b = (torch.randn(Nd, generator=gen, device=DEV) * 0.1).to(dtype)
            for gran in ((None, "block") if dtype == torch.bfloat16
                         else (None,)):
                kw = dict(value_dtype=gran and "int8",
                          scale_granularity=gran or "block")
                un = ops.pack(w, mask, BLOCK, reorder=True, n_bins=N_BINS,
                              **kw)
                for S in (TP_SHARDS if dtype == torch.bfloat16 else (TP,)):
                    sh = ops.pack(w, mask, BLOCK, n_bins=N_BINS, n_shards=S,
                                  **kw)
                    for M in (TP_CHECK_M if dtype == torch.bfloat16
                              else (4,)):
                        x = torch.randn(M, Kd, generator=gen,
                                        device=DEV).to(dtype)
                        want = ref.bsr_matmul_sharded_ref(
                            x.float(), sh, b.float(), "silu")
                        y = K.bsr_matmul_packed(x, sh, b, "silu")
                        y_un = K.bsr_matmul_packed(x, un, b, "silu")
                        sync()
                        what = (f"{name} S={S} M={M} {dtype} values="
                                f"{sh.value_dtype}")
                        max_err = max(max_err, check_close(
                            y, want, dtype, f"sharded kernel 1 vs plain at "
                                            f"{what}"))
                        same = bool(torch.equal(y, y_un))
                        if not same:
                            check_close(y, y_un.float(), dtype,
                                        f"sharded vs unsharded kernel 1 at "
                                        f"{what}")
                        bitwise += same
                        cases += 1
                        if fault is None and S == TP:
                            bad = K.bsr_matmul_packed(x, shard_fault(sh), b,
                                                      "silu")
                            fault = out_of_tol(bad, want, dtype)[0]
            del w, mask
    return cases, max_err, bitwise, fault


def tp_kernel2_phase(mods, flush):
    """Kernel 2 through ``tap_gather_conv_sharded`` at VGG_TINY c5 under
    the pattern mapping (B = CONV_B, its 8 x 8 x 128 input as the alive
    band), S in (2, 4), float and int8 ("out" scales), bias + relu: vs
    the sharded plain version and bitwise vs the unsharded launch, a
    planted shard fault breaking the bound; then S = TP_CONV timed beside
    the unsharded kernel, the plain version, ``F.conv2d`` and the
    bound."""
    RW, CN, ops, ref, K = (mods["RW"], mods["CN"], mods["ops"], mods["ref"],
                           mods["K"])
    import torch.nn.functional as F
    params = CN.convnet_init(CN.VGG_TINY, seed=0, device=DEV)
    name, spec = conv_mappings(RW)[1]
    mask = conv_masks(RW, name, params, spec)["c5"]["w"]
    wm = params["c5"]["w"] * mask
    gen = torch.Generator(device=DEV)
    gen.manual_seed(5)
    x = torch.randn(CONV_B, 8, 8, wm.shape[1], generator=gen, device=DEV)
    b = torch.randn(wm.shape[0], generator=gen, device=DEV) * 0.1
    band_full = x.reshape(-1, wm.shape[1])
    cases, max_err, bitwise, fault = 0, 0.0, 0, None
    for gran in (None, "out"):
        kw = dict(value_dtype=gran and "int8",
                  scale_granularity=gran or "block")
        un = ops.pack_taps(wm, mask, **kw)
        for S in (2, 4):
            sh = ops.pack_taps(wm, mask, n_shards=S, **kw)
            band = band_full.index_select(1, sh.alive.long()).contiguous()
            want = ref.tap_gather_sharded_ref(band, sh, b, "relu")
            y = K.tap_gather_conv_packed(band, sh, b, "relu")
            y_un = K.tap_gather_conv_packed(band, un, b, "relu")
            sync()
            what = f"c5 S={S} values={sh.value_dtype}"
            max_err = max(max_err, check_close(
                y, want, torch.float32, f"sharded kernel 2 vs plain at "
                                        f"{what}"))
            same = bool(torch.equal(y, y_un))
            if not same:
                check_close(y, y_un, torch.float32, f"sharded vs unsharded "
                                                    f"kernel 2 at {what}")
            bitwise += same
            cases += 1
            if fault is None:
                bad = K.tap_gather_conv_packed(band, shard_fault(sh), b,
                                               "relu")
                fault = out_of_tol(bad, want, torch.float32)[0]
    sh = ops.pack_taps(wm, mask, n_shards=TP_CONV)
    un = ops.pack_taps(wm, mask)
    band = band_full.index_select(1, sh.alive.long()).contiguous()
    xn = x.permute(0, 3, 1, 2).contiguous()
    w_bytes = layout_bytes(sh)
    M, P = band.shape[0], wm.shape[0]
    t_bytes = (band.numel() * 4 + w_bytes + M * P * 4) / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * M * sh.nnz_taps * sh.group / FP32_PEAK_FLOPS * 1e3
    row = {"layer": "vgg/c5/pattern", "M": M, "R": band.shape[1], "P": P,
           "shards": TP_CONV,
           "ms": time_ms(lambda: K.tap_gather_conv_packed(band, sh, b,
                                                          "relu"), 20, flush),
           "unsharded_ms": time_ms(lambda: K.tap_gather_conv_packed(
               band, un, b, "relu"), 20, flush),
           "plain_ms": time_ms(lambda: ref.tap_gather_sharded_ref(
               band, sh, b, "relu"), 3, flush),
           "library_ms": time_ms(lambda: torch.relu(F.conv2d(
               xn, wm.float(), b)), 20, flush),
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "executed_taps": sh.executed_taps,
           "executed_taps_unsharded": un.executed_taps,
           "shard_balance": sh.shard_balance}
    print(f"[tensor_parallel] kernel 2 (tap_gather_conv_sharded) vs plain: "
          f"{cases} cases at VGG_TINY c5 (pattern), S in (2, 4), float and "
          f"int8, bias + relu; max abs err {max_err:.3e}; == the unsharded "
          f"launch bitwise in {bitwise} of {cases}; planted fault (shard "
          f"0's column table shifted): {fault} elements out of bound")
    print(f"[tensor_parallel] kernel 2 at c5, S = {TP_CONV} (L2 flushed, "
          f"median): {row['ms']:.4f} ms, unsharded {row['unsharded_ms']:.4f}"
          f", plain {row['plain_ms']:.3f}, F.conv2d {row['library_ms']:.4f},"
          f" bound {row['bound_ms']:.4f} ({row['bound_by']}); executed "
          f"taps {sh.executed_taps} (unsharded {un.executed_taps}), "
          f"shard_balance {sh.shard_balance:.3f}")
    if not fault:
        raise AssertionError("the kernel-2 bound misses a shifted shard")
    return {"checks": cases, "max_abs_err": max_err, "bitwise": bitwise,
            "fault_out_of_bound": fault, "timing": row}


def tp_timings(mods, gen, flush):
    """A yi-9b layer's 7 projections, S = TP against unsharded on the same
    weights (bf16, L2 flushed): rows of ``kernel1_timings``, and each
    projection's executed blocks, L_effective and shard_balance."""
    RW, ops = mods["RW"], mods["ops"]
    weights, geo = {}, []

    def make(sharded):
        def build(name, Kd, Nd):
            if name not in weights:
                weights[name] = weight_and_mask(RW, Kd, Nd, gen,
                                                torch.bfloat16)
            w, mask = weights[name]
            lay = ops.pack(w, mask, BLOCK, reorder=True, n_bins=N_BINS,
                           n_shards=TP if sharded else 0)
            if sharded:
                geo.append({"proj": name, "executed_blocks":
                            lay.executed_blocks, "L_effective":
                            lay.L_effective, "shard_balance":
                            lay.shard_balance})
            else:
                geo_row = next(g for g in geo if g["proj"] == name)
                geo_row.update(executed_blocks_unsharded=lay.executed_blocks,
                               L_effective_unsharded=lay.L_effective)
            return lay, w * mask.to(w.dtype)
        return build
    rows = kernel1_timings(mods, gen, flush, PROJECTIONS, TP_CHECK_M,
                           make(True))
    rows_un = kernel1_timings(mods, gen, flush, PROJECTIONS, TP_CHECK_M,
                              make(False))
    weights.clear()
    print_timings(f"[tensor_parallel] kernel 1 over S = {TP} shards (bf16, "
                  f"L2 flushed, median ms):", rows, "torch.matmul",
                  "yi-9b layer (7 projections)",
                  ((4, "decode"), (128, "prefill")))
    for M in TP_CHECK_M:
        a, u = layer_sum(rows, M), layer_sum(rows_un, M)
        print(f"  M = {M}: sharded {a['ms']:.4f} ms against unsharded "
              f"{u['ms']:.4f} on the same weights ({a['ms'] / u['ms']:.3f}x)")
    for g in geo:
        print(f"  {g['proj']:5s} executed blocks {g['executed_blocks']} "
              f"(unsharded {g['executed_blocks_unsharded']}), L_effective "
              f"{g['L_effective']:.2f} ({g['L_effective_unsharded']:.2f}), "
              f"shard_balance {g['shard_balance']:.4f}")
    return rows, rows_un, geo


def tp_serve(mods, pm, masks, cfg, serve_tokens, unsharded_step_ms):
    """yi-9b at full width (``cfg``'s depth, bf16) compiled with
    ``CompileSpec(tp=TP)``: every report row sharded; the counted greedy
    ``generate`` (B x S prompts): its tokens == the unsharded tree's, one
    sharded kernel-1 launch a projection and forward; prefill logits
    within the bf16 bound of masked-dense, a shifted shard breaking it;
    then a validated ``ServingEngine``: one capture, the replayed step ==
    eager bitwise, TP's launches a step, the counted saturated run and
    its step ms beside ``unsharded_step_ms``, the serve phase's."""
    C, E, K = mods["C"], mods["E"], mods["K"]
    from repro_torch.launch.serve import SPARSE_SPEC
    exec_p, report, compile_s = compile_timed(mods, pm, masks, SPARSE_SPEC,
                                              tp=TP)
    print(f"[tensor_parallel] yi-9b ({cfg.n_layers} layers, "
          f"{pm['embed']['table'].dtype}) compile_model(tp={TP}) "
          f"{compile_s:.2f} s:")
    print(C.compiled_summary(report))
    shards = [r.shards for r in report.packed]
    if len(shards) != 7 or set(shards) != {TP}:
        raise AssertionError(f"expected 7 projections of {TP} shards, got "
                             f"{shards}")
    prompts = np.random.RandomState(0).randint(0, cfg.vocab, size=(B, S))
    tokens = torch.as_tensor(prompts, device=DEV)
    K.reset_launches()
    sync()
    t0 = time.perf_counter()
    with torch.no_grad():
        out = E.generate(exec_p, cfg, prompts, N_NEW, device=DEV)
    sync()
    gen_s = time.perf_counter() - t0
    launches = {k: v for k, v in K.LAUNCHES.items() if v}
    want = cfg.n_layers * 7 * (1 + N_NEW)
    same = out.tolist() == serve_tokens
    with torch.no_grad():
        t0 = time.perf_counter()
        E.generate(exec_p, cfg, prompts, N_NEW, device=DEV)
        sync()
        gen_warm_s = time.perf_counter() - t0
        dense, _ = E.prefill(pm, cfg, tokens)
        logits, _ = E.prefill(exec_p, cfg, tokens)
        gap = logit_gap(dense, logits)
        down = exec_p["layers"]["ffn"]["down"]["packed"]
        fault = logit_gap(dense, E.prefill(with_layout(
            exec_p, "ffn", "down", shard_fault(down)), cfg, tokens)[0])
    print(f"[tensor_parallel] generate {tuple(out.shape)}: launches "
          f"{launches} (expected bsr_matmul_sharded {want}: one a "
          f"projection and forward); tokens == the unsharded tree's: {same};"
          f" first {gen_s:.3f} s, warm {gen_warm_s:.3f} s; prefill logits "
          f"vs masked-dense {gap[0]:.4f} / {gap[1]:.4f} (bound "
          f"{LOGIT_MAX_REL} / {LOGIT_MEAN_REL}); planted fault (down's "
          f"shard 0 shifted, every layer) {fault[0]:.4f} / {fault[1]:.4f}")
    if launches != {"bsr_matmul_sharded": want}:
        raise AssertionError("the tp generate did not go through the shard "
                             "wrapper once a projection and forward")
    if not (same and within_bound(gap) and torch.isfinite(logits).all()):
        raise AssertionError("the tp=4 tree disagrees with the unsharded "
                             "one or with masked-dense")
    if within_bound(fault):
        raise AssertionError("the logit bound misses a shifted shard")
    del dense, logits

    prompts_e = engine_prompts(cfg)
    eng, replay_same = step_gate(mods, exec_p, cfg, prompts_e)
    eager = eager_step_launches(mods, exec_p, cfg, "bsr_matmul_sharded")
    per_step = (eng._replay_launches.get("bsr_matmul_sharded")
                if DEV == "cuda" else eager)
    del eng
    K.reset_launches()
    eng, toks, wall, step_ms, runs = engine_serve(mods, exec_p, cfg,
                                                  prompts_e)
    counted = dict(K.LAUNCHES)
    n_adm = eng.stats["admitted"]
    warm_up = warm_ups(eng)
    want_e = cfg.n_layers * 7 * (warm_up + runs + n_adm)
    med = statistics.median(step_ms)
    print(f"[tensor_parallel] ServingEngine (validate=True, "
          f"{ENGINE_SLOTS} slots): {eng.stats['graph_captures']} capture, "
          f"replayed step == eager bitwise: {replay_same}; sharded kernel-1 "
          f"launches a step {per_step} replayed / {eager} eager; saturated "
          f"run of {ENGINE_REQUESTS} requests: {eng.stats['finished']} "
          f"finished, decode-only step {med:.3f} ms (the unsharded "
          f"engine's {unsharded_step_ms:.3f} in this run), launches {counted['bsr_matmul_sharded']} (expected "
          f"({warm_up} warm-up + {runs} steps + {n_adm} prefills) x "
          f"{cfg.n_layers * 7} = {want_e}), {wall:.2f} s")
    if not (replay_same and per_step == eager == cfg.n_layers * 7
            and counted["bsr_matmul_sharded"] == want_e
            and counted["bsr_matmul"] == 0
            and eng.stats["finished"] == ENGINE_REQUESTS
            and eng.stats["degraded_layers"] == 0):
        raise AssertionError("the tp engine's gates failed")
    return ({"compile_s": compile_s, "launches": launches,
             "tokens_equal": same, "first_generate_s": gen_s,
             "generate_s": gen_warm_s, "logits_gap": gap,
             "fault_gap": fault, "engine_replay_bitwise": replay_same,
             "engine_launches_per_step": per_step, "engine_step_ms": med,
             "engine_step_ms_all": step_ms,
             "engine_launches": counted["bsr_matmul_sharded"],
             "report": C.compiled_summary(report)},
            {"yi-9b tp=4 generate": launches["bsr_matmul_sharded"],
             "yi-9b tp=4 engine": counted["bsr_matmul_sharded"]})


def tp_vgg(mods):
    """VGG_TINY (B = CONV_B, fp32) compiled with ``CompileSpec(tp=TP_CONV)``
    under both mappings: the punched forward runs im2col + kernel 1, the
    pattern forward kernel 2, each sharded layer once a forward (launches
    from the layouts); logits within CONV_LOGIT_REL of the unsharded
    forward's."""
    RW, CN, C, K, ops = (mods["RW"], mods["CN"], mods["C"], mods["K"],
                         mods["ops"])
    from repro_torch.train.trainer import apply_masks
    params = CN.convnet_init(CN.VGG_TINY, seed=0, device=DEV)
    gen = torch.Generator(device=DEV)
    gen.manual_seed(0)
    x, _ = CN.synthetic_images(gen, CONV_B, size=CONV_HW)
    out, all_launches = {}, {}
    for name, spec in conv_mappings(RW):
        masks = conv_masks(RW, name, params, spec)
        pm = apply_masks(params, masks)
        plain_p, _ = C.compile_model(pm, masks, spec,
                                     spec=C.CompileSpec(keep_dense=False),
                                     device=DEV)
        tp_p, report = C.compile_model(
            pm, masks, spec, spec=C.CompileSpec(keep_dense=False,
                                                tp=TP_CONV), device=DEV)
        want = expected_conv_launches(ops, CN.VGG_TINY, tp_p, CONV_HW,
                                      CONV_B)
        K.reset_launches()
        sync()
        with torch.no_grad():
            logits = CN.convnet_apply(tp_p, x, CN.VGG_TINY)
        sync()
        launches = {k: v for k, v in K.LAUNCHES.items() if v}
        with torch.no_grad():
            ref_logits = CN.convnet_apply(plain_p, x, CN.VGG_TINY)
            gap = conv_logit_gap(ref_logits, logits)
            for _ in range(2):
                CN.convnet_apply(tp_p, x, CN.VGG_TINY)
            fw_ms = time_ms(lambda: CN.convnet_apply(tp_p, x, CN.VGG_TINY),
                            10, None)
            un_ms = time_ms(lambda: CN.convnet_apply(plain_p, x,
                                                     CN.VGG_TINY), 10, None)
        shards = {r.path: r.shards for r in report.packed}
        print(f"[tensor_parallel] VGG_TINY {name}, tp={TP_CONV}: shards "
              f"{shards}; one forward: launches {launches} (from the "
              f"layouts: {want}); logits vs the unsharded forward "
              f"{gap:.2e} of max|logit| (bound {CONV_LOGIT_REL}); forward "
              f"(CUDA-graph replay) {fw_ms:.3f} ms, unsharded {un_ms:.3f}")
        if launches != want or not any(shards.values()):
            raise AssertionError(f"[{name}] the tp forward did not go "
                                 f"through the shard wrappers")
        if not (gap <= CONV_LOGIT_REL and torch.isfinite(logits).all()):
            raise AssertionError(f"[{name}] tp logits disagree with the "
                                 f"unsharded forward")
        for k, v in launches.items():
            all_launches[k] = all_launches.get(k, 0) + v
        out[name] = {"launches": launches, "shards": shards,
                     "logit_gap": gap, "forward_ms": fw_ms,
                     "unsharded_forward_ms": un_ms}
        del plain_p, tp_p
    return out, all_launches


def tp_replica_restart(mods, full):
    """A replica's restart at yi-9b's full width, TP_CKPT_LAYERS layers,
    bf16, in a temporary directory: ``checkpoint.save`` and ``restore``
    timed (fp32 on disk, restored leaf for leaf), then
    ``replica_restore(spec=CompileSpec(tp=TP), artifact_dir=)`` cold and
    warm (no pack), the warm layouts == the cold ones leaf for leaf, the
    greedy tokens equal; seconds and MiB."""
    import tempfile
    from repro_torch.core import bcs as BCS
    from repro_torch.distributed import checkpoint as CKPT
    from repro_torch.distributed import elastic as EL
    from repro_torch.launch.serve import SPARSE_SPEC
    C, E, ART = mods["C"], mods["E"], mods["ART"]
    cfg = full.replace(n_layers=TP_CKPT_LAYERS)
    pm, _, _ = build_masked(mods, cfg, torch.bfloat16)
    n_params = sum(t.numel() for t in _tensor_leaves(pm))
    spec = C.CompileSpec(keep_dense=False, tp=TP)
    prompts = np.random.RandomState(0).randint(0, cfg.vocab, size=(B, S))
    with tempfile.TemporaryDirectory() as d:
        ckpt, store = Path(d) / "ckpt", Path(d) / "art"
        sync()
        t0 = time.perf_counter()
        CKPT.save(ckpt, 100, pm)
        save_s = time.perf_counter() - t0
        ckpt_mib = sum(f.stat().st_size for f in ckpt.rglob("*")
                       if f.is_file()) / 2**20
        t0 = time.perf_counter()
        restored, step = CKPT.restore(ckpt, pm)
        sync()
        restore_s = time.perf_counter() - t0
        exact = all(torch.equal(a, b) for a, b in
                    zip(_tensor_leaves(restored), _tensor_leaves(pm)))
        del restored

        def start():
            mods["ops"].clear_pack_cache()   # a restart: a fresh process
            sync()
            t0 = time.perf_counter()
            with mock.patch.object(BCS, "pack_csc_reordered",
                                   wraps=BCS.pack_csc_reordered) as packs:
                ex, rep, s = EL.replica_restore(
                    ckpt, pm, mapping=SPARSE_SPEC, artifact_dir=store,
                    spec=spec, device=DEV)
            sync()
            return ex, rep, s, time.perf_counter() - t0, packs.call_count
        cold, cold_rep, s1, cold_s, cold_packs = start()
        store_mib = sum(f.stat().st_size for f in store.rglob("*")
                        if f.is_file()) / 2**20
        warm, warm_rep, s2, warm_s, warm_packs = start()
        same = layouts_equal(ART, cold, warm)
        with torch.no_grad():
            toks_c = E.generate(cold, cfg, prompts, N_NEW, device=DEV)
            toks_w = E.generate(warm, cfg, prompts, N_NEW, device=DEV)
        tok_same = bool(torch.equal(toks_c, toks_w))
        shards = {r.shards for r in warm_rep.packed}
        del cold, warm
    out = {"layers": cfg.n_layers, "params": n_params, "save_s": save_s,
           "restore_s": restore_s, "checkpoint_mib": ckpt_mib,
           "restored_exact": exact, "cold_s": cold_s, "warm_s": warm_s,
           "cold_packs": cold_packs, "warm_packs": warm_packs,
           "store_mib": store_mib, "warm_layouts_equal": same,
           "tokens_equal": tok_same, "shards": sorted(shards)}
    print(f"[tensor_parallel] replica restart (yi-9b {cfg.n_layers} layers "
          f"at full width, {n_params / 1e9:.3f} B params, bf16): "
          f"checkpoint.save {save_s:.2f} s, {ckpt_mib:.1f} MiB on disk "
          f"(fp32); restore {restore_s:.2f} s, leaf for leaf {exact}; "
          f"replica_restore(tp={TP}) cold {cold_s:.2f} s ({cold_packs} "
          f"packs, store {store_mib:.1f} MiB), warm {warm_s:.2f} s "
          f"({warm_packs} packs); warm layouts == cold {same}; greedy "
          f"tokens equal {tok_same}; shards {sorted(shards)}")
    if not (exact and s1 == s2 == step == 100 and cold_packs > 0
            and warm_packs == 0 and same and tok_same and shards == {TP}):
        raise AssertionError(f"the replica restart failed: {out}")
    return out


def _tensor_leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _tensor_leaves(tree[k])
    elif isinstance(tree, torch.Tensor):
        yield tree


def tp_train_resume(fault=False):
    """The train CLI at yi-9b SMOKE on the card, in a temporary directory:
    TP_TRAIN[0] steps through; TP_TRAIN[1] steps saving every TP_TRAIN[2],
    then ``--resume`` to TP_TRAIN[0].  Returns ({step: loss} of the
    uninterrupted run, of the resumed run, the worst relative gap over
    the steps both ran after the resume, bitwise equal).  ``fault``
    resumes as the reference does (the saved step run again)."""
    import tempfile
    from repro_torch.distributed import checkpoint as CKPT
    from repro_torch.launch import train as TR
    total, first, every = TP_TRAIN
    runs, start = {}, [0]
    real_make, real_restore = TR.make_train_step, CKPT.restore

    def recording(*a, **k):
        init, step = real_make(*a, **k)

        def run(params, opt, *rest):
            idx = start[0] + len(runs[key])
            out = step(params, opt, *rest)
            runs[key][idx] = float(out[2]["loss"])
            return out
        return init, run

    def restore(*a, **k):
        tree, saved = real_restore(*a, **k)
        if tree is not None:
            start[0] = saved + (0 if fault else 1)
            if fault:
                saved -= 1
        return tree, saved
    base = ["--arch", "yi-9b", "--smoke", "--device", DEV,
            "--ckpt-every", str(every)]
    with tempfile.TemporaryDirectory() as d, \
            mock.patch.object(TR, "make_train_step", recording), \
            mock.patch.object(TR.CKPT, "restore", restore), \
            contextlib.redirect_stdout(io.StringIO()):
        for key, argv in (("full", ["--steps", str(total), "--ckpt-dir",
                                    f"{d}/a"]),
                          ("first", ["--steps", str(first), "--ckpt-dir",
                                     f"{d}/b"]),
                          ("resumed", ["--steps", str(total), "--ckpt-dir",
                                       f"{d}/b", "--resume"])):
            runs[key], start[0] = {}, 0
            TR.main(base + argv)
    after = sorted(runs["resumed"])
    gaps = [abs(runs["resumed"][i] - runs["full"][i])
            / abs(runs["full"][i]) for i in after]
    bitwise = all(runs["resumed"][i] == runs["full"][i] for i in after)
    return runs, max(gaps), bitwise


def tensor_parallel_phase(mods, pm, masks, cfg, full, serve_tokens,
                          unsharded_step_ms):
    """The shard wrappers on one card (``[tensor_parallel]`` lines):
    kernel 1 and 2 over sharded layouts vs their plain versions, a planted
    shard fault breaking each bound; a yi-9b layer timed at S = TP against
    unsharded; yi-9b served at ``CompileSpec(tp=TP)`` (tokens == the
    unsharded tree's ``serve_tokens``, 952 launches, the engine's step
    beside ``unsharded_step_ms``);
    VGG_TINY at tp = TP_CONV; a replica restart from a checkpoint and the
    store; the train CLI's resume.  Returns (numbers, launches by path
    for each shard wrapper)."""
    t_phase = time.perf_counter()
    gen = torch.Generator(device=DEV)
    gen.manual_seed(22)
    cases, max_err, bitwise, fault = tp_kernel1_checks(mods, gen)
    print(f"[tensor_parallel] kernel 1 (bsr_matmul_sharded) vs plain: "
          f"{cases} cases at yi-9b's 7 projections, S in {TP_SHARDS}, M in "
          f"{TP_CHECK_M}, bf16 float / int8 (fp32 at S = {TP}, M = 4), bias "
          f"+ silu; max abs err {max_err:.3e}; == the unsharded kernel "
          f"bitwise in {bitwise} of {cases}; planted fault (shard 0's "
          f"column table shifted): {fault} elements out of bound")
    if not fault:
        raise AssertionError("the kernel-1 bound misses a shifted shard")
    torch.cuda.empty_cache()
    flush = torch.empty(64 << 20, dtype=torch.float32, device=DEV)
    k2 = tp_kernel2_phase(mods, flush)
    rows, rows_un, geo = tp_timings(mods, gen, flush)
    del flush
    torch.cuda.empty_cache()
    serve, yi_launches = tp_serve(mods, pm, masks, cfg, serve_tokens,
                                  unsharded_step_ms)
    torch.cuda.empty_cache()
    vgg, vgg_launches = tp_vgg(mods)
    torch.cuda.empty_cache()
    restart = tp_replica_restart(mods, full)
    torch.cuda.empty_cache()
    runs, gap, bitwise_losses = tp_train_resume()
    _, fault_gap, _ = tp_train_resume(fault=True)
    print(f"[tensor_parallel] train CLI (yi-9b SMOKE, card): {TP_TRAIN[0]} "
          f"steps against {TP_TRAIN[1]} + --resume: losses after the resume "
          f"{[round(runs['resumed'][i], 6) for i in sorted(runs['resumed'])]}"
          f" vs {[round(runs['full'][i], 6) for i in sorted(runs['resumed'])]}"
          f", worst relative gap {gap:.2e} (bound {TP_RESUME_REL}), bitwise "
          f"{bitwise_losses}; planted fault (the saved step run again, as "
          f"the reference resumes) {fault_gap:.2e}")
    if not (gap <= TP_RESUME_REL and sorted(runs["resumed"])
            == list(range(TP_TRAIN[1] - 1, TP_TRAIN[0]))):
        raise AssertionError("the resumed losses disagree with the "
                             "uninterrupted run's")
    if fault_gap <= TP_RESUME_REL:
        raise AssertionError("the resume gate misses a re-run step")
    out = {"kernel1": {"checks": cases, "max_abs_err": max_err,
                       "bitwise": bitwise, "fault_out_of_bound": fault},
           "kernel2": k2, "timings": rows, "timings_unsharded": rows_un,
           "geometry": geo, "serve": serve, "vgg": vgg,
           "replica_restart": restart,
           "train_resume": {"losses": runs, "worst_gap": gap,
                            "bitwise": bitwise_losses,
                            "fault_gap": fault_gap},
           "phase_s": time.perf_counter() - t_phase}
    print(f"[tensor_parallel] phase {out['phase_s']:.1f} s")
    launches = {"bsr_matmul_sharded": {
        **yi_launches, "VGG_TINY punched tp=2 forward":
            vgg_launches.get("bsr_matmul_sharded", 0)},
        "tap_gather_conv_sharded": {
            "VGG_TINY pattern tp=2 forward":
                vgg_launches.get("tap_gather_conv_sharded", 0)}}
    return out, launches


def tp_entries(out, launches):
    """The kernels JSON entries of the two shard wrappers."""
    rows = out["timings"]
    d, p = layer_sum(rows, 4), layer_sum(rows, 128)
    du, pu = (layer_sum(out["timings_unsharded"], 4),
              layer_sum(out["timings_unsharded"], 128))
    k1 = {"name": "bsr_matmul_sharded", "route": "cuda",
          "source": "src/repro_torch/kernels/csrc/bsr_matmul.cu",
          "replaces": "src/repro/kernels/bsr_matmul.py:268",
          "launches": sum(launches["bsr_matmul_sharded"].values()),
          "launches_by_path": launches["bsr_matmul_sharded"],
          "max_abs_err": out["kernel1"]["max_abs_err"],
          "ms": d["ms"], "plain_ms": d["plain_ms"], "bound_ms": d["bound_ms"],
          "bound_by": d["bound_by"], "library_ms": d["library_ms"],
          "prefill": p, "unsharded": {"decode": du, "prefill": pu},
          "also_replaces": "src/repro/kernels/bsr_matmul.py:238 "
                           "(_sharded_launch)",
          "measured_at": f"sum over one yi-9b layer's 7 projections at S="
                         f"{TP} shards, decode M=4 (prefill: M=128), bf16, "
                         f"(16,16) blocks, rate 0.6, 4 bins a shard; "
                         f"unsharded: the same weights in 4 bins"}
    r = out["kernel2"]["timing"]
    k2 = {"name": "tap_gather_conv_sharded", "route": "cuda",
          "source": "src/repro_torch/kernels/csrc/tap_gather.cu",
          "replaces": "src/repro/kernels/bsr_matmul.py:412",
          "launches": sum(launches["tap_gather_conv_sharded"].values()),
          "launches_by_path": launches["tap_gather_conv_sharded"],
          "max_abs_err": out["kernel2"]["max_abs_err"], "ms": r["ms"],
          "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
          "bound_by": r["bound_by"], "library_ms": r["library_ms"],
          "unsharded_ms": r["unsharded_ms"],
          "also_replaces": "src/repro/kernels/bsr_matmul.py:238 "
                           "(_sharded_launch)",
          "measured_at": f"VGG_TINY c5 (pattern, connectivity 0.5) at S="
                         f"{TP_CONV}, B={CONV_B}: its 8x8x128 input as the "
                         f"alive band, fp32, bias + relu; library = "
                         f"F.conv2d on the masked dense weight"}
    return [k1, k2]


# -- the mesh path: a one-rank NCCL DeviceMesh ---------------------------------

MESH_TRAIN_LAYERS, MESH_TRAIN_STEPS = 2, 3   # full width, TRAIN_B x TRAIN_S
MESH_LOSS_TOL = 1e-5     # meshed train losses vs un-meshed (absolute)
MESH_ITERS = 5           # timed calls (after one warm call)


def wall_ms(fn, iters=MESH_ITERS):
    """Median synchronised wall ms of ``fn`` over ``iters`` calls, after
    one warm call (eager: DTensor's dispatch runs on the host)."""
    with torch.no_grad():
        fn()
        sync()
        out = []
        for _ in range(iters):
            t0 = time.perf_counter()
            fn()
            sync()
            out.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(out)


def mesh_serve(mods, pm, masks, cfg, serve_tokens, mesh, SH):
    """yi-9b compiled at ``CompileSpec(tp=TP)``, placed on the mesh by
    ``shard_packed_tree``, served with ``make_dist``'s ``Dist``: the
    counted ``generate`` (its tokens == ``serve_tokens``, TP's 952
    sharded launches), bf16 prefill logits against the un-meshed tree's
    (bitwise expected) and masked-dense, warm prefill and decode-step
    ms meshed vs un-meshed; then ``ServingEngine(dist=)``, its step
    captured once: tokens == the un-meshed engine's, launches a step,
    step ms beside the un-meshed engine's."""
    E, K, T = mods["E"], mods["K"], mods["T"]
    from repro_torch.launch.serve import SPARSE_SPEC
    exec_p, _, compile_s = compile_timed(mods, pm, masks, SPARSE_SPEC, tp=TP)
    placed = SH.shard_packed_tree(exec_p, mesh)
    d = SH.make_dist(mesh, cfg, B)
    prompts = np.random.RandomState(0).randint(0, cfg.vocab, size=(B, S))
    tokens = torch.as_tensor(prompts, device=DEV)
    K.reset_launches()
    sync()
    t0 = time.perf_counter()
    with torch.no_grad():
        out = E.generate(placed, cfg, prompts, N_NEW, device=DEV, dist=d)
    sync()
    gen_s = time.perf_counter() - t0
    launches = {k: v for k, v in K.LAUNCHES.items() if v}
    want = cfg.n_layers * 7 * (1 + N_NEW)
    same = out.tolist() == serve_tokens
    with torch.no_grad():
        plain, cache_p = E.prefill(exec_p, cfg, tokens)
        meshed, cache_m = E.prefill(placed, cfg, tokens, dist=d)
        dense, _ = E.prefill(pm, cfg, tokens)
    bitwise = torch.equal(plain, meshed)
    gap, dgap = logit_gap(plain, meshed), logit_gap(dense, meshed)
    tok = plain[:, -1].argmax(-1)[:, None].to(torch.int32)
    pos = torch.full((B, 1), S, dtype=torch.int32, device=DEV)
    lay_p, lay_m = T.decode_layers(exec_p, cfg), T.decode_layers(placed, cfg)
    ms = {"prefill": wall_ms(lambda: E.prefill(exec_p, cfg, tokens)),
          "prefill_mesh": wall_ms(lambda: E.prefill(placed, cfg, tokens,
                                                    dist=d)),
          "decode_step": wall_ms(lambda: T.decode_step(
              exec_p, cfg, tok, cache_p, pos, lay_p)),
          "decode_step_mesh": wall_ms(lambda: T.decode_step(
              placed, cfg, tok, cache_m, pos, lay_m, d))}
    print(f"[mesh] yi-9b ({cfg.n_layers} layers, bf16) at tp={TP}, placed "
          f"by shard_packed_tree on the one-rank mesh: generate "
          f"{tuple(out.shape)} in {gen_s:.3f} s, launches {launches} "
          f"(expected bsr_matmul_sharded {want}); tokens == the un-meshed "
          f"tree's: {same}; prefill logits vs un-meshed: bitwise {bitwise}, "
          f"{gap[0]:.2e} / {gap[1]:.2e}; vs masked-dense {dgap[0]:.4f} / "
          f"{dgap[1]:.4f} (bound {LOGIT_MAX_REL} / {LOGIT_MEAN_REL})")
    print(f"[mesh] warm prefill {ms['prefill_mesh']:.3f} ms meshed vs "
          f"{ms['prefill']:.3f} un-meshed; decode step "
          f"{ms['decode_step_mesh']:.3f} ms vs {ms['decode_step']:.3f} "
          f"(eager; x{ms['decode_step_mesh'] / ms['decode_step']:.2f})")
    if launches != {"bsr_matmul_sharded": want}:
        raise AssertionError("the meshed generate did not launch kernel 1 "
                             "once a projection and forward")
    if not (same and within_bound(gap) and within_bound(dgap)
            and torch.isfinite(meshed).all()):
        raise AssertionError("the meshed tree disagrees with the un-meshed "
                             "one or with masked-dense")
    del plain, meshed, dense, cache_p, cache_m

    prompts_e = engine_prompts(cfg)
    K.reset_launches()
    eng, toks_m, wall, step_m, runs = engine_serve(mods, placed, cfg,
                                                   prompts_e, dist=d)
    counted = dict(K.LAUNCHES)
    per_step = eng._replay_launches.get("bsr_matmul_sharded")
    n_adm, captures = eng.stats["admitted"], eng.stats["graph_captures"]
    warm_up = warm_ups(eng)          # a mesh's engine admits eagerly
    del eng
    _, toks_p, _, step_p, _ = engine_serve(mods, exec_p, cfg, prompts_e)
    want_e = cfg.n_layers * 7 * (warm_up + runs + n_adm)
    eng_ms = (statistics.median(step_m), statistics.median(step_p))
    print(f"[mesh] ServingEngine(dist=): {captures} capture, sharded "
          f"kernel-1 launches a replayed step {per_step}; {len(prompts_e)} "
          f"requests, tokens == the un-meshed engine's: {toks_m == toks_p}; "
          f"launches {counted.get('bsr_matmul_sharded')} (expected "
          f"({warm_up} warm-up + {runs} steps + {n_adm} prefills) x "
          f"{cfg.n_layers * 7} = {want_e}); decode-only step "
          f"{eng_ms[0]:.3f} ms meshed vs {eng_ms[1]:.3f} un-meshed, "
          f"{wall:.2f} s")
    if not (toks_m == toks_p and captures == 1
            and per_step == cfg.n_layers * 7
            and counted.get("bsr_matmul_sharded") == want_e):
        raise AssertionError("the meshed engine's gates failed")
    del exec_p, placed
    return ({"compile_s": compile_s, "launches": launches,
             "tokens_equal": same, "generate_s": gen_s,
             "prefill_bitwise": bitwise, "logits_gap": gap,
             "dense_gap": dgap, "ms": ms,
             "engine": {"tokens_equal": toks_m == toks_p,
                        "captures": captures,
                        "launches_per_step": per_step,
                        "launches": counted.get("bsr_matmul_sharded"),
                        "step_ms": eng_ms[0], "unmeshed_step_ms": eng_ms[1],
                        "step_ms_all": step_m}},
            {"yi-9b mesh generate": launches["bsr_matmul_sharded"],
             "yi-9b mesh engine": counted["bsr_matmul_sharded"]})


def mesh_train(mods, mesh, SH):
    """yi-9b at full width, MESH_TRAIN_LAYERS layers, bf16 params, fp32
    AdamW state: MESH_TRAIN_STEPS steps of TRAIN_B x TRAIN_S from the same
    init, un-meshed and then with the params placed by
    ``param_shardings`` in ``cfg.train_shard_mode`` and ``make_dist``'s
    ``Dist``: the losses within MESH_LOSS_TOL, warm step ms of each."""
    from repro_torch.data.pipeline import synthetic_batch
    from repro_torch.train import trainer
    T = mods["T"]
    cfg = lm_config().replace(n_layers=MESH_TRAIN_LAYERS)
    mode = cfg.train_shard_mode
    losses, ms = {}, {}
    for name in ("plain", "mesh"):
        params = T.init_lm(cfg, seed=0, dtype=torch.bfloat16, device=DEV)
        d = None
        if name == "mesh":
            d = SH.make_dist(mesh, cfg, TRAIN_B, mode=mode)
            params = SH.distribute(params, SH.param_shardings(
                params, cfg, mesh, mode))
        init, step = trainer.make_train_step(cfg, lr=TRAIN_LR, dist=d)
        state = init(params)
        losses[name], ms[name] = [], []
        for s in range(MESH_TRAIN_STEPS):
            batch = synthetic_batch(0, s, TRAIN_B, TRAIN_S, cfg.vocab,
                                    device=DEV)
            sync()
            t0 = time.perf_counter()
            params, state, m = step(params, state, batch)
            sync()
            ms[name].append((time.perf_counter() - t0) * 1e3)
            losses[name].append(float(m["loss"]))
        del params, state
        torch.cuda.empty_cache()
    gap = max(abs(a - b) for a, b in zip(losses["plain"], losses["mesh"]))
    print(f"[mesh] train yi-9b ({MESH_TRAIN_LAYERS} layers, full width, "
          f"{mode!r}, B = {TRAIN_B} x {TRAIN_S}): losses meshed "
          f"{losses['mesh']} vs {losses['plain']}, worst gap {gap:.2e} "
          f"(bound {MESH_LOSS_TOL}); step ms meshed {ms['mesh']} vs "
          f"{ms['plain']}")
    if not (gap <= MESH_LOSS_TOL and all(map(math.isfinite,
                                             losses["mesh"]))):
        raise AssertionError("the meshed train steps disagree with the "
                             "un-meshed ones")
    return {"mode": mode, "losses": losses, "gap": gap, "step_ms": ms}


def mesh_vgg(mods, mesh, SH):
    """VGG_TINY under the pattern mapping at tp = TP_CONV, placed by
    ``shard_packed_tree``: one forward (fp32, B = CONV_B) through kernel 2
    per rank, launches from the layouts, logits bitwise the un-meshed
    tp = TP_CONV forward's."""
    RW, CN, C, K, ops = (mods["RW"], mods["CN"], mods["C"], mods["K"],
                         mods["ops"])
    from repro_torch.train.trainer import apply_masks
    params = CN.convnet_init(CN.VGG_TINY, seed=0, device=DEV)
    gen = torch.Generator(device=DEV)
    gen.manual_seed(0)
    x, _ = CN.synthetic_images(gen, CONV_B, size=CONV_HW)
    name, spec = conv_mappings(RW)[1]
    masks = conv_masks(RW, name, params, spec)
    tp_p, _ = C.compile_model(apply_masks(params, masks), masks, spec,
                              spec=C.CompileSpec(keep_dense=False,
                                                 tp=TP_CONV), device=DEV)
    placed = SH.shard_packed_tree(tp_p, mesh)
    want = expected_conv_launches(ops, CN.VGG_TINY, tp_p, CONV_HW, CONV_B)
    K.reset_launches()
    sync()
    with torch.no_grad():
        got = CN.convnet_apply(placed, x, CN.VGG_TINY)
    sync()
    launches = {k: v for k, v in K.LAUNCHES.items() if v}
    with torch.no_grad():
        plain = CN.convnet_apply(tp_p, x, CN.VGG_TINY)
    bitwise = torch.equal(got, plain)
    print(f"[mesh] VGG_TINY {name} at tp={TP_CONV}, placed: one forward's "
          f"launches {launches} (from the layouts: {want}); logits == the "
          f"un-meshed tp={TP_CONV} forward's bitwise: {bitwise}")
    if not (launches == want and bitwise
            and launches.get("tap_gather_conv_sharded")):
        raise AssertionError("the meshed VGG_TINY forward failed its gates")
    return {"launches": launches, "bitwise": bitwise}


def mesh_compression(mesh, SH):
    """``compressed_allreduce`` of a yi-9b ffn/down-sized fp32 gradient
    (DFF x D) over the model axis's one-rank NCCL group: the error within
    one quantization step (the scale), and its ms."""
    gen = torch.Generator(device=DEV)
    gen.manual_seed(5)
    g = torch.randn(DFF, D, generator=gen, device=DEV)
    out = SH.compressed_allreduce(g, gen, mesh, "model")
    sync()
    scale = float(g.abs().max()) / 127.0
    err = float((out - g).abs().max())
    ms = wall_ms(lambda: SH.compressed_allreduce(g, gen, mesh, "model"))
    print(f"[mesh] compressed_allreduce of a ({DFF}, {D}) fp32 gradient: max "
          f"error {err:.3e} vs the scale {scale:.3e}; {ms:.3f} ms")
    if not err <= scale * (1 + 1e-6):
        raise AssertionError("the int8 all-reduce is off by more than a "
                             "quantization step")
    return {"max_abs_err": err, "scale": scale, "ms": ms}


def mesh_phase(mods, pm, masks, cfg, serve_tokens):
    """The mesh path on one card (``[mesh]`` lines): a one-rank NCCL group
    and ``make_local_mesh()``, the reference's (1, 1) mesh; yi-9b served
    and its engine run through it (``mesh_serve``), trained
    (``mesh_train``), VGG_TINY's pattern forward (``mesh_vgg``) and the
    int8 gradient all-reduce (``mesh_compression``).  The group ends with
    the phase.  Returns (numbers, launches by path for each shard
    wrapper)."""
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch import mesh as MESH
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    mesh = MESH.make_local_mesh()
    print(f"[mesh] make_local_mesh(): {mesh.mesh_dim_names} "
          f"{tuple(mesh.shape)} on {mesh.device_type}, backend "
          f"{torch.distributed.get_backend()}, {time.perf_counter() - t0:.2f}"
          f" s")
    try:
        serve, launches = mesh_serve(mods, pm, masks, cfg, serve_tokens,
                                     mesh, SH)
        torch.cuda.empty_cache()
        train = mesh_train(mods, mesh, SH)
        vgg = mesh_vgg(mods, mesh, SH)
        comp = mesh_compression(mesh, SH)
    finally:
        MESH.close_local_mesh()
    out = {"serve": serve, "train": train, "vgg": vgg, "compression": comp,
           "phase_s": time.perf_counter() - t_phase}
    print(f"[mesh] phase {out['phase_s']:.1f} s")
    return out, {"bsr_matmul_sharded": launches,
                 "tap_gather_conv_sharded": {
                     "VGG_TINY pattern tp=2 mesh forward":
                         vgg["launches"]["tap_gather_conv_sharded"]}}


# -- the paper's prune-and-train pipeline on yi-9b ----------------------------

TRAIN_B, TRAIN_S = 8, 128        # the training batch: B sequences of S
TRAIN_STEPS, TRAIN_FINETUNE = 40, 20
TRAIN_REWEIGHT_EVERY = 10
TRAIN_RATE, TRAIN_LAM, TRAIN_LR = 0.6, 1e-3, 3e-3
# the share of normalised groups below tau: the quantile puts TRAIN_RATE
# of them there, up to the groups tied at tau
THRESHOLD_SHARE_TOL = 0.01
# loss and grads of SMOKE configs, card vs CPU (fp32, TF32 off)
TRAIN_GRAD_ARCHS = ("yi-9b", "mixtral-8x7b")
TRAIN_GRAD_TOL = 1e-5            # loss (relative), grads (of max |g|)


def masked_out_nonzero(RW, params, masks):
    """How many weights the masks prune are not exactly 0."""
    flat = dict(RW._leaves(params))
    return sum(int(((m == 0) & (flat[p] != 0)).sum())
               for p, m in RW._leaves(masks) if m.ndim)


def timed(record, name, fn):
    """``fn`` with each call's synchronised wall ms appended to
    ``record[name]``."""
    def f(*a, **kw):
        sync()
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        sync()
        record.setdefault(name, []).append((time.perf_counter() - t0) * 1e3)
        return out
    return f


def first_layers(tree, n):
    """A param or mask tree cut to its first ``n`` layers."""
    from repro_torch.models.module import tree_map
    return dict(tree, layers=tree_map(lambda t: t[:n] if t.ndim else t,
                                      tree["layers"]))


def sublayer_gaps(mods, exec_p, dense_p, cfg, tokens):
    """Per layer, the attention and the FFN with packed and with
    masked-dense params on the same normed inputs (the masked-dense run's
    residual stream): the worst (max, mean) relative gaps of the
    attention outputs and of the FFN outputs.  The trained projections
    keep few weights and move the logits little, so these hold the
    packed products where the logits cannot.  An output that is 0 on
    both paths (every product of a SwiGLU pruned away) gaps by 0."""

    def gap(d, p):
        if d.abs().max() == 0:
            return (0.0, 0.0) if p.abs().max() == 0 else (math.inf,) * 2
        return logit_gap(d, p)
    from repro_torch.models import attention as A
    T, L = mods["T"], mods["L"]
    positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                             device=tokens.device)
    x = L.embed(dense_p["embed"], tokens)
    gaps = {"attn": [], "ffn": []}
    for lp_x, lp_d in zip(T.layer_params(exec_p), T.layer_params(dense_p)):
        h = L.rmsnorm(lp_d["ln1"], x)
        outs = [A.mha(lp["attn"], h, positions, cfg.n_heads, cfg.n_kv_heads,
                      cfg.hd, window=cfg.sliding_window,
                      rope_theta=cfg.rope_theta)[0] for lp in (lp_d, lp_x)]
        gaps["attn"].append(gap(*outs))
        x = x + outs[0]
        h = L.rmsnorm(lp_d["ln2"], x)
        outs = [L.ffn(lp["ffn"], h) for lp in (lp_d, lp_x)]
        gaps["ffn"].append(gap(*outs))
        x = x + outs[0]
    return {k: (max(g[0] for g in v), max(g[1] for g in v))
            for k, v in gaps.items()}


def train_grads_gate(mods, arch, fault=False):
    """Loss (masks and the penalty's alphas both given) and grads of
    ``arch`` SMOKE in fp32 on the card against the same computation on
    the CPU: (loss relative gap, worst leaf's grad gap over its max |g|);
    encdec and vlm take the data pipeline's frontend, vlm's cross gates
    set to 1.0.  ``fault`` drops the penalty on the card (no alphas)."""
    from repro_torch import configs
    from repro_torch.data.pipeline import synthetic_batch
    from repro_torch.models.module import tree_map
    from repro_torch.train import trainer
    RW, T = mods["RW"], mods["T"]
    cfg = configs.get(arch, smoke=True)
    spec = [(r"(attn/w[qkvo]|(ffn|moe)/(gate|up|down))/w",
             RW.SchemeChoice("block", (8, 16))),
            (r"head/table", RW.SchemeChoice("block", (8, 16)))]
    rw = RW.ReweightedConfig(spec=tuple(spec), lam=TRAIN_LAM)
    p = T.init_lm(cfg, seed=0, dtype=torch.float32, device="cpu")
    if cfg.family == "vlm":
        p["groups"]["cross"]["gate"].fill_(1.0)
    frontend = (cfg.n_frontend_tokens if cfg.family in ("encdec", "vlm")
                else 0)
    args = (p, synthetic_batch(0, 0, 2, 16, cfg.vocab, device="cpu",
                               frontend_tokens=frontend,
                               d_model=cfg.d_model),
            RW.masks_for_spec(p, spec, default_rate=0.5),
            RW.update_alphas(p, rw))
    f = trainer.value_and_grad(trainer.make_loss_fn(cfg, reweighted=rw))
    (want, _), want_g = f(*args)
    card = [tree_map(lambda t: t.to(DEV), a) for a in args]
    if fault:
        card[3] = None
    (got, _), got_g = f(*card)
    flat_g = dict(RW._leaves(got_g))
    worst = max(float((flat_g[k].cpu() - w).abs().max())
                / max(float(w.abs().max()), 1e-30)
                for k, w in RW._leaves(want_g))
    return abs(float(got) - float(want)) / abs(float(want)), worst


def train_phase(mods, args):
    """yi-9b at full width (depth ``--layers``), bf16 params, fp32
    AdamW state, every layer checkpointed: the rule mapper's spec
    (TRAIN_B x TRAIN_S tokens, dataset_hard False, compression
    1 / (1 - TRAIN_RATE), V5E) snapped to (8, 16) as the train CLI snaps
    it; ``reweighted_prune`` (TRAIN_STEPS reweighted steps, alphas every
    TRAIN_REWEIGHT_EVERY, one global threshold at TRAIN_RATE,
    TRAIN_FINETUNE masked steps) on the port's synthetic batches; then
    ``compile_model`` and the counted ``generate`` through kernel 1 at the
    trained masks.  Gates, each with a planted fault: every loss finite;
    no pruned weight nonzero (one more step without masks); the share
    of normalised groups below tau (tau halved); a packed projection in
    every layer; kernel-1 launches; bf16 prefill logits packed vs
    masked-dense (a dropped bin); at 2 fp32 layers the logits and greedy
    tokens (a dropped bin); SMOKE loss and grads card vs CPU (the
    penalty dropped).  Kernel 1 vs plain at (8, 16) on yi-9b's shapes,
    and timed on the trained layouts."""
    from repro_torch.core import pruner as P
    from repro_torch.data.pipeline import synthetic_batch
    from repro_torch.launch.train import snapped_spec
    from repro_torch.train import trainer
    C, E, T, RW, ops = mods["C"], mods["E"], mods["T"], mods["RW"], \
        mods["ops"]
    full = lm_config()
    cfg = full.replace(n_layers=args.layers)
    spec = snapped_spec(cfg, TRAIN_B * TRAIN_S, TRAIN_RATE)
    print(f"[train] yi-9b at full width, {cfg.n_layers} of {full.n_layers} "
          f"layers, remat {cfg.remat!r}, {cfg.optimizer}; spec "
          f"(map_rules at {TRAIN_B * TRAIN_S} tokens, dataset_hard=False, "
          f"V5E, snapped): "
          + ", ".join(f"{p} {c.scheme} {c.block}" for p, c in spec))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = T.init_lm(cfg, seed=0, dtype=torch.bfloat16, device=DEV)
    n_params = sum(t.numel() for _, t in RW._leaves(params))
    n_pruned = sum(t.numel() for _, t, _ in RW._iter_prunable(params, spec))
    opt_init, step = trainer.make_train_step(
        cfg, lr=TRAIN_LR, reweighted=RW.ReweightedConfig(
            spec=tuple(spec), lam=TRAIN_LAM))
    state0 = opt_init(params)
    sync()
    init_s = time.perf_counter() - t0
    print(f"[train] {n_params / 1e9:.3f} B params, {n_pruned / 1e9:.3f} B "
          f"penalised; init + optimizer state {init_s:.2f} s")

    ms, losses, last = {}, {"reweighted": [], "finetune": []}, {}

    def step_fn(p, state, batch, masks, alphas):
        stage = "finetune" if masks is not None else "reweighted"
        out = timed(ms, stage, step)(p, state, batch, masks, alphas)
        losses[stage].append(float(out[2]["loss"]))
        last.update(state=out[1], batch=batch)
        if alphas is not None:
            last["alphas"] = alphas
        return out

    share = {}
    threshold = timed(ms, "global_threshold", RW.global_threshold)

    def threshold_gate(p, sp, rate):
        tau = threshold(p, sp, rate)
        rel = RW.normalised_groups(p, sp)
        share.update(groups=rel.numel(), tau=tau,
                     below=float((rel < tau).double().mean()),
                     fault=float((rel < tau / 2).double().mean()))
        return tau
    with mock.patch.object(RW, "update_alphas",
                           timed(ms, "update_alphas", RW.update_alphas)), \
            mock.patch.object(RW, "global_threshold", threshold_gate), \
            mock.patch.object(RW, "masks_for_spec",
                              timed(ms, "masks_for_spec",
                                    RW.masks_for_spec)):
        t0 = time.perf_counter()
        res = P.reweighted_prune(
            params, state0, spec, step_fn,
            lambda s: synthetic_batch(0, s, TRAIN_B, TRAIN_S, cfg.vocab,
                                      device=DEV),
            lam=TRAIN_LAM, steps=TRAIN_STEPS,
            reweight_every=TRAIN_REWEIGHT_EVERY, target_rate=TRAIN_RATE,
            finetune_steps=TRAIN_FINETUNE)
        sync()
        prune_s = time.perf_counter() - t0
    del params, state0
    out = {"layers": cfg.n_layers, "params": n_params,
           "penalised_params": n_pruned, "batch": TRAIN_B,
           "seq": TRAIN_S, "prune_s": prune_s, "losses": losses,
           "threshold": share}
    # warm steps: past the first two of each stage
    for stage in ("reweighted", "finetune"):
        med = statistics.median(ms[stage][2:])
        out[f"{stage}_step_ms"] = med
        out[f"{stage}_tok_per_s"] = TRAIN_B * TRAIN_S / med * 1e3
    for name in ("update_alphas", "global_threshold", "masks_for_spec"):
        out[f"{name}_ms"] = ms[name]
    print(f"[train] reweighted_prune {prune_s:.1f} s: loss "
          f"{losses['reweighted'][0]:.4f} -> {losses['reweighted'][-1]:.4f} "
          f"({TRAIN_STEPS} reweighted steps), {losses['finetune'][0]:.4f} "
          f"-> {losses['finetune'][-1]:.4f} ({TRAIN_FINETUNE} masked "
          f"steps); warm step {out['reweighted_step_ms']:.1f} ms = "
          f"{out['reweighted_tok_per_s']:.0f} tok/s (reweighted), "
          f"{out['finetune_step_ms']:.1f} ms = "
          f"{out['finetune_tok_per_s']:.0f} tok/s (masked)")
    print(f"[train] update_alphas {[round(t, 1) for t in ms['update_alphas']]}"
          f" ms, global_threshold {ms['global_threshold'][0]:.1f} ms (the "
          f"quantile of {share['groups']} normalised group norms, on the "
          f"card), masks_for_spec(threshold=) {ms['masks_for_spec'][0]:.1f} "
          f"ms")
    rep = res.report["__overall__"]
    out.update(density=rep["density"], compression=rep["compression"],
               report={k: v["density"] for k, v in res.report.items()})
    print(f"[train] pruned: density {rep['density']:.4f}, compression "
          f"{rep['compression']:.2f}x; per leaf " + ", ".join(
              f"{k} {v['density']:.3f}" for k, v in res.report.items()
              if k != "__overall__"))

    # gate 1: every loss finite
    if not all(math.isfinite(x) for v in losses.values() for x in v):
        raise AssertionError(f"[train] a loss is not finite: {losses}")
    # gate 2: no pruned weight survives; a step without its masks revives
    # them (Adam's momentum and the weight decay move them)
    alive = masked_out_nonzero(RW, res.params, res.masks)
    revived, _, _ = step(res.params, last["state"], last["batch"], None,
                         None)
    fault2 = masked_out_nonzero(RW, revived, res.masks)
    del revived
    print(f"[train] pruned weights nonzero: {alive} (a step without the "
          f"masks, the planted fault: {fault2})")
    if alive or not fault2:
        raise AssertionError("[train] pruned weights gate failed or missed "
                             "its fault")
    # gate 3: the threshold's share
    print(f"[train] tau {share['tau']:.6g}: {share['below']:.4f} of "
          f"{share['groups']} normalised groups below it (target "
          f"{TRAIN_RATE}); tau halved (the planted fault) "
          f"{share['fault']:.4f}")
    if abs(share["below"] - TRAIN_RATE) > THRESHOLD_SHARE_TOL or \
            abs(share["fault"] - TRAIN_RATE) <= THRESHOLD_SHARE_TOL:
        raise AssertionError("[train] threshold share gate failed or "
                             "missed its fault")

    # the traced train step (reweighted, the phase's bulk): busy share
    dev_step = device_time(lambda: step(res.params, last["state"],
                                        last["batch"], None, last["alphas"]))
    last.clear()
    torch.cuda.empty_cache()
    if dev_step is None:
        print("[train] busy share: not measured (no device activity)")
    else:
        out["step_busy_ms"] = dev_step["busy_ms"]
        out["step_busy_share"] = dev_step["busy_ms"] / out[
            "reweighted_step_ms"]
        print(f"[train] traced reweighted step: {dev_step['busy_ms']:.1f} ms "
              f"busy = {out['step_busy_share']:.3f} of its warm wall time, "
              f"{dev_step['events']} device events")
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    print(f"[train] peak device memory {out['peak_gb']:.2f} GB")
    # the BCS format of the trained masks, first and last layer
    out["bcs"] = dict(trained_bcs(mods, res.params, res.masks,
                                  (0, cfg.n_layers - 1)))

    # compile and serve the trained masks
    exec_p, report, compile_s = compile_timed(mods, res.params, res.masks,
                                              spec)
    print(f"[train] compile_model {compile_s:.2f}s:")
    print(C.compiled_summary(report))
    packed = [r.path for r in report.packed]
    lays = {p: exec_p["layers"][p.split("/")[1]][p.split("/")[2]]["packed"]
            for p in packed}
    # gate 4: every layer has a packed projection with a dead block; the
    # fault: layer 0 with every block live in every layout
    def dead_per_layer(nnz):
        return [sum(int(n[i].sum()) < lay.Kb * lay.Nb
                    for n, lay in zip(nnz, lays.values()))
                for i in range(cfg.n_layers)]
    per_layer = dead_per_layer([lay.nnz for lay in lays.values()])
    full0 = []
    for lay in lays.values():
        n = lay.nnz.clone()
        n[0] = lay.Kb
        full0.append(n)
    fault4 = dead_per_layer(full0)
    # what sets the padded degrees: each layer's live-block share and its
    # fullest block column (a bin runs at the max over its columns and
    # the stack's layers)
    live = {p.split("/")[2]: [
        (round(int(lay.nnz[i].sum()) / (lay.Kb * lay.Nb), 3),
         int(lay.nnz[i].max())) for i in range(cfg.n_layers)]
        for p, lay in lays.items()}
    print("[train] per layer (live-block share, fullest column's live "
          "blocks of Kb): " + "; ".join(f"{k} {v}" for k, v in live.items()))
    out.update(packed=packed, packed_with_dead_blocks=per_layer,
               compile_s=compile_s, live_by_layer=live)
    print(f"[train] packed {len(packed)} projections: {packed}; per layer, "
          f"those with a dead block: {per_layer} (every block of layer 0 "
          f"live, the planted fault: {fault4})")
    if not packed or min(per_layer) < 1 or min(fault4) >= 1:
        raise AssertionError("[train] a layer has no packed projection, or "
                             "the gate missed its fault")
    # gate 5: the counted generate
    e2e, launches, prompts, tokens = serve_counted(
        mods, exec_p, cfg, full, compile_s, "the trained masks at (8, 16)",
        per_layer=len(packed))
    out["serve"] = e2e
    # the planted faults act on the attention's output projection (its
    # input is never all zero: wv is not pruned), else the last packed
    _, group, fault_proj, _ = ("layers/attn/wo/w" if "layers/attn/wo/w"
                               in packed else packed[-1]).split("/")
    # the launch count's fault: that projection served dense
    dense_one = with_layout(exec_p, group, fault_proj, None)
    dense_one["layers"][group][fault_proj] = {
        "w": res.params["layers"][group][fault_proj]["w"]}
    mods["K"].reset_launches()
    with torch.no_grad():
        E.prefill(dense_one, cfg, tokens)
    fault5 = mods["K"].LAUNCHES["bsr_matmul"]
    del dense_one
    print(f"[train] one prefill with {fault_proj} served dense (the planted "
          f"fault): {fault5} launches against {cfg.n_layers * len(packed)}")
    if fault5 == cfg.n_layers * len(packed):
        raise AssertionError("[train] the launch count misses a projection "
                             "served dense")
    # gate 6: bf16 prefill logits and each layer's attention and FFN,
    # packed vs masked-dense
    broken = dropped_last_bin(exec_p, fault_proj, group)
    with torch.no_grad():
        d = E.prefill(res.params, cfg, tokens)[0]
        s = E.prefill(exec_p, cfg, tokens)[0]
        fault = logit_gap(d, E.prefill(broken, cfg, tokens)[0])
        sub = sublayer_gaps(mods, exec_p, res.params, cfg, tokens)
        sub_fault = sublayer_gaps(mods, broken, res.params, cfg, tokens)
    del broken
    gap = logit_gap(d, s)
    print(f"[train] bf16, packed vs masked-dense (bound {LOGIT_MAX_REL} / "
          f"{LOGIT_MEAN_REL} of max / mean |output|): prefill logits "
          f"{gap[0]:.4f} / {gap[1]:.4f}, worst layer's attention "
          f"{sub['attn'][0]:.4f} / {sub['attn'][1]:.4f}, FFN "
          f"{sub['ffn'][0]:.4f} / {sub['ffn'][1]:.4f}; planted fault "
          f"({fault_proj}'s last bin dropped): logits {fault[0]:.4f} / "
          f"{fault[1]:.4f}, {group} {sub_fault[group][0]:.4f} / "
          f"{sub_fault[group][1]:.4f}")
    out.update(logits_gap=gap, fault_gap=fault, sublayer_gaps=sub,
               sublayer_fault_gaps=sub_fault)
    if not (torch.isfinite(s).all() and within_bound(gap)
            and all(within_bound(g) for g in sub.values())):
        raise AssertionError("[train] bf16 packed outputs disagree with "
                             "masked-dense")
    if all(within_bound(g) for g in (fault, *sub_fault.values())):
        raise AssertionError("[train] the bf16 bounds miss a dropped bin")
    del d, s

    # kernel 1 on the trained layouts (layer 0), timed
    gen = torch.Generator(device=DEV)
    gen.manual_seed(7)
    flush = torch.empty(64 << 20, dtype=torch.float32, device=DEV)

    def trained(name, Kd, Nd):
        g = "attn" if name.startswith("w") else "ffn"
        return (exec_p["layers"][g][name]["packed"].layer(0),
                res.params["layers"][g][name]["w"][0])
    projs = [p for p in PROJECTIONS if any(
        r.endswith(f"/{p[0]}/w") for r in packed)]
    rows = kernel1_timings(mods, gen, flush, projs, (4, B * S), trained)
    print_timings("[train] kernel 1 on the trained layouts at (8, 16), "
                  "layer 0, bf16 x (L2 flushed, median ms by CUDA-graph "
                  "replay; torch.matmul on the masked dense weight):", rows,
                  "torch.matmul", f"yi-9b layer ({len(projs)} projections)",
                  ((4, "decode"), (B * S, "prefill")))
    out["rows"] = rows
    del exec_p
    torch.cuda.empty_cache()

    # gate 7: 2 fp32 layers of the trained weights, TF32 off
    cfg2 = cfg.replace(n_layers=2)
    p32 = cast_tree(first_layers(res.params, 2), torch.float32)
    m2 = first_layers(res.masks, 2)
    exec32, _, _ = compile_timed(mods, p32, m2, spec)
    broken = dropped_last_bin(exec32, fault_proj, group)
    with torch.no_grad():
        want = T.forward(p32, cfg2, tokens)
        gap32 = max(logit_gap(want, T.forward(exec32, cfg2, tokens))[0],
                    *(g[0] for g in sublayer_gaps(mods, exec32, p32, cfg2,
                                                  tokens).values()))
        fault32 = max(logit_gap(want, T.forward(broken, cfg2, tokens))[0],
                      *(g[0] for g in sublayer_gaps(mods, broken, p32, cfg2,
                                                    tokens).values()))
        same = bool(torch.equal(
            E.generate(p32, cfg2, prompts, N_NEW, device=DEV),
            E.generate(exec32, cfg2, prompts, N_NEW, device=DEV)))
    print(f"[train] fp32, 2 trained layers (TF32 off): logits and each "
          f"layer's attention and FFN, packed vs masked-dense, worst "
          f"{gap32:.2e} of max |output| (bound {MOE_FP32_LOGIT_REL}), "
          f"planted fault {fault32:.3f}; greedy tokens identical: {same}")
    out.update(fp32_gap=gap32, fp32_fault_gap=fault32,
               fp32_tokens_identical=same)
    if not (gap32 <= MOE_FP32_LOGIT_REL and same
            and fault32 > MOE_FP32_LOGIT_REL):
        raise AssertionError("[train] fp32 gate failed or missed its fault")
    del broken
    del p32, m2, exec32, res
    torch.cuda.empty_cache()

    # gate 8: SMOKE loss and grads, card vs CPU
    grads = {a: train_grads_gate(mods, a) for a in TRAIN_GRAD_ARCHS}
    fault8 = train_grads_gate(mods, TRAIN_GRAD_ARCHS[0], fault=True)
    print(f"[train] SMOKE fp32 loss and grads, card vs CPU (TF32 off): "
          + ", ".join(f"{a} loss {g[0]:.2e}, grads {g[1]:.2e}"
                      for a, g in grads.items())
          + f" (bound {TRAIN_GRAD_TOL}); planted fault (the penalty "
          f"dropped on the card): loss {fault8[0]:.3f}")
    out.update(smoke_grad_gaps=grads, smoke_grad_fault=fault8)
    if any(g[0] > TRAIN_GRAD_TOL or g[1] > TRAIN_GRAD_TOL
           for g in grads.values()) or fault8[0] <= TRAIN_GRAD_TOL:
        raise AssertionError("[train] card autograd disagrees with the CPU "
                             "or the gate missed its fault")

    # kernel 1 vs plain at (8, 16), yi-9b's shapes
    checks, max_err = kernel1_cases(
        mods, gen, sorted({(k, n) for _, k, n, _ in PROJECTIONS}),
        lambda w, mask: [("float", ops.pack(w, mask, (8, 16), reorder=True,
                                            n_bins=N_BINS),
                          ops.pack(w, mask, (8, 16)))],
        (("none", False), ("silu", True)), block=(8, 16))
    print(f"[train] kernel 1 vs plain at (8, 16): {checks} cases at yi-9b's "
          f"(K, N), M in {CHECK_M}, bf16 + fp32, reordered == unreordered "
          f"bitwise; max abs err {max_err:.3e}")
    del flush
    torch.cuda.empty_cache()
    out.update(checks=checks, max_abs_err=max_err)
    return out, launches


def trained_entry(out, launches):
    """Kernel 1's JSON ``trained`` branch."""
    decode, prefill = layer_sum(out["rows"], 4), layer_sum(out["rows"],
                                                           B * S)
    return {
        "launches": launches["bsr_matmul"], "max_abs_err": out[
            "max_abs_err"],
        "ms": decode["ms"], "plain_ms": decode["plain_ms"],
        "bound_ms": decode["bound_ms"], "bound_by": decode["bound_by"],
        "library_ms": decode["library_ms"], "stream_ms": decode[
            "stream_ms"], "prefill": prefill,
        "train_step_ms": out["reweighted_step_ms"],
        "measured_at": f"yi-9b trained by reweighted_prune at full width "
                       f"({out['layers']} layers), masks at (8, 16) blocks "
                       f"(density {out['density']:.4f}); ms/bound/plain/"
                       f"library: layer 0's packed projections at decode "
                       f"M=4 (prefill: M={B * S}), bf16; launches: the "
                       f"counted generate"}


# -- the encoder-decoder and vision-LM families -------------------------------

XFAM_ARCHS = ("seamless-m4t-large-v2", "llama-3.2-vision-90b")
VLM_GROUPS = 2           # llama-vision's depth cut: 2 of 20 groups
SEAMLESS_LAYERS = 8      # seamless's depth cut: 8 + 8 of 24 + 24 layers
# the fp32 gates' depth: seamless 2 + 2 layers, llama-vision 1 group
XFAM_FP32 = {"seamless-m4t-large-v2": dict(n_layers=2, n_enc_layers=2),
             "llama-3.2-vision-90b": dict(n_layers=5)}
# kernel 1's M cases at the new shapes: decode, the M-tile edges, prefill
# (B x S); the frontend's B x 1024 rows where a projection reads them
XFAM_CHECK_M = (1, 4, 17, 128, 129)


def xfam_config(arch):
    """seamless-m4t-large-v2 at its published widths, depth cut to
    SEAMLESS_LAYERS encoder and decoder layers; llama-3.2-vision-90b at
    its published widths, depth cut to VLM_GROUPS groups of
    ``cross_attn_interval`` layers (the rehearsal on the CPU swaps in
    narrower configs).  The cuts keep the script in its time limit."""
    from repro_torch import configs
    cfg = configs.get(arch)
    if cfg.family == "vlm":
        cfg = cfg.replace(n_layers=VLM_GROUPS * cfg.cross_attn_interval)
    else:
        cfg = cfg.replace(n_layers=SEAMLESS_LAYERS,
                          n_enc_layers=SEAMLESS_LAYERS)
    return cfg


def frontend_rows(cfg):
    """Rows of the frontend (B x n_frontend_tokens): the M of the
    encoder's projections and of every cross wk / wv."""
    return B * cfg.n_frontend_tokens


def xfam_projections(cfg):
    """{what: (M values, [(name, K, N, act)])} of the layers timed:
    seamless's encoder layer at the frontend rows, its decoder layer's 9
    token-row projections (self, cross wq / wo, FFN) at decode and
    prefill, llama-vision's self layer at decode and prefill, and each
    family's cross wk / wv at the frontend rows."""
    d, f = cfg.d_model, cfg.d_ff
    q, kv = cfg.n_heads * cfg.hd, cfg.n_kv_heads * cfg.hd
    attn = [("wq", d, q, "none"), ("wk", d, kv, "none"),
            ("wv", d, kv, "none"), ("wo", q, d, "none")]
    ffn = [("gate", d, f, "silu"), ("up", d, f, "none"),
           ("down", f, d, "none")]
    xkv = [("xattn/wk", d, kv, "none"), ("xattn/wv", d, kv, "none")]
    rows = frontend_rows(cfg)
    if cfg.family == "encdec":
        return {"encoder layer": ((rows,), attn + ffn),
                "decoder layer": ((4, B * S), attn + [
                    ("xattn/wq", d, q, "none"), ("xattn/wo", q, d, "none")]
                    + ffn),
                "cross wk/wv": ((rows,), xkv)}
    return {"self layer": ((4, B * S), attn + ffn),
            "cross wk/wv": ((rows,), xkv)}


def xfam_launches(cfg):
    """Kernel-1 launches of one prefill and of one decode step with every
    projection packed: encdec's encoder 7 a layer and decoder 11 (self 4,
    cross 4, FFN 3), its decode step 9 a decoder layer (the cross keys
    and values are cached); vlm's self layers 7, cross layers 7 at
    prefill and 5 a step (wq, wo, FFN)."""
    if cfg.family == "encdec":
        return 7 * cfg.n_enc_layers + 11 * cfg.n_layers, 9 * cfg.n_layers
    G = cfg.n_layers // cfg.cross_attn_interval
    selfs = G * (cfg.cross_attn_interval - 1)
    return 7 * selfs + 7 * G, 7 * selfs + 5 * G


def xfam_kernel_phase(mods, flush):
    """Kernel 1 at the encdec and vlm shapes: vs its plain version at
    XFAM_CHECK_M and, where a projection reads the frontend, at its B x
    1024 rows (M = 4096: 32 M tiles), bf16 and fp32, reordered ==
    unreordered bitwise; then the layers of ``xfam_projections`` timed.
    Returns (rows by arch and what, (cases, max abs err))."""
    RW, ops = mods["RW"], mods["ops"]
    gen = torch.Generator(device=DEV)
    gen.manual_seed(13)

    def layouts(w, mask):
        return [("float", ops.pack(w, mask, BLOCK, reorder=True,
                                   n_bins=N_BINS), ops.pack(w, mask, BLOCK))]
    acts = (("none", False), ("silu", True))
    checks, max_err = 0, 0.0
    for arch in XFAM_ARCHS:
        cfg = xfam_config(arch)
        groups = xfam_projections(cfg)
        shapes = sorted({(k, n) for _, projs in groups.values()
                         for _, k, n, _ in projs})
        wide = sorted({(k, n) for Ms, projs in groups.values()
                       for _, k, n, _ in projs
                       if frontend_rows(cfg) in Ms})
        for sel, Ms in ((shapes, XFAM_CHECK_M),
                        (wide, (frontend_rows(cfg),))):
            n, err = kernel1_cases(mods, gen, sel, layouts, acts, Ms=Ms)
            checks, max_err = checks + n, max(max_err, err)
            print(f"[encdec/vlm] kernel 1 vs plain, {arch}: (K, N) in "
                  f"{sel}, M in {Ms}, bf16 + fp32, bias with none/silu, "
                  f"reordered == unreordered bitwise: {n} cases, max abs "
                  f"err {err:.3e}")

    def make(name, Kd, Nd):
        w, mask = weight_and_mask(RW, Kd, Nd, gen, torch.bfloat16)
        return (ops.pack(w, mask, BLOCK, reorder=True, n_bins=N_BINS),
                w * mask.to(w.dtype))
    rows = {}
    for arch in XFAM_ARCHS:
        for what, (Ms, projs) in xfam_projections(xfam_config(arch)).items():
            r = kernel1_timings(mods, gen, flush, projs, Ms, make)
            rows[f"{arch} {what}"] = r
            print_timings(
                f"[encdec/vlm] {arch} {what} (bf16, L2 flushed, median ms "
                f"by CUDA-graph replay; stream = one torch sum over the "
                f"bound's bytes):", r, "torch.matmul",
                f"{arch} {what} ({len(projs)} projections)",
                tuple((M, f"M = {M}") for M in Ms))
    return rows, (checks, max_err)


def xfam_build(mods, cfg, dtype):
    """Seeded init at ``cfg`` on the card, vlm's cross gates set to 1.0
    (the reference's zero gates would shut the cross-attention out of the
    logits), the serving CLI's block masks at PRUNE_RATE, then
    ``compile_model(keep_dense=False)``: (masked-dense params, compiled
    params, report, init + masks s, compile s)."""
    T, RW = mods["T"], mods["RW"]
    from repro_torch.launch.serve import SPARSE_SPEC
    from repro_torch.train.trainer import apply_masks
    t0 = time.perf_counter()
    params = T.init_lm(cfg, seed=0, dtype=dtype, device=DEV)
    if cfg.family == "vlm":
        params["groups"]["cross"]["gate"].fill_(1.0)
    masks = RW.magnitude_block_masks(params, SPARSE_SPEC, None,
                                     rate=PRUNE_RATE)
    pm = apply_masks(params, masks)
    del params
    sync()
    init_s = time.perf_counter() - t0
    exec_p, report, compile_s = compile_timed(mods, pm, masks, SPARSE_SPEC)
    del masks
    return pm, exec_p, report, init_s, compile_s


def zeroed_bin(params, path):
    """``params`` with the largest degree bin (the most stored blocks) of
    the packed projection at ``path`` (e.g. "enc/ffn/down") zeroed in
    every layer of its stack; the other leaves shared."""
    head, *rest = path.split("/")
    node = params[head]
    if rest:
        return dict(params, **{head: zeroed_bin(node, "/".join(rest))})
    lay = node["packed"]
    values = list(lay.values)
    b = max(range(len(values)), key=lambda i: values[i].numel())
    values[b] = torch.zeros_like(values[b])
    return dict(params, **{head: dict(node, packed=dataclasses.replace(
        lay, values=tuple(values)))})


def xfam_faults(cfg):
    """The planted faults: one zeroed bin of a cross-attention wo, and for
    encdec one of the encoder's ffn/down."""
    if cfg.family == "encdec":
        return ("dec/xattn/wo", "enc/ffn/down")
    return ("groups/cross/xattn/wo",)


def cross_gaps(mods, exec_p, dense_p, cfg, tokens, frontend):
    """Per cross-attention layer (encdec's decoder layers, vlm's cross
    layers), its output with packed and with masked-dense params on the
    same input, the masked-dense run's residual stream and memory: the
    (max, mean) relative gaps.  Random weights leave the cross-attention
    a small share of the logits, so these hold its packed products where
    the logits cannot."""
    T, L = mods["T"], mods["L"]
    from repro_torch.models import attention as A
    positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                             device=tokens.device)
    x = L.embed(dense_p["embed"], tokens)

    def xattn(lp, h, memory):
        return A.mha(lp["xattn"], h, positions, cfg.n_heads,
                     cfg.n_kv_heads, cfg.hd, memory=memory)[0]
    gaps = []
    if cfg.family == "encdec":
        memory = T.encode(dense_p, cfg, frontend, x.dtype)
        for lp_x, lp_d in zip(T.layer_params(exec_p, "dec"),
                              T.layer_params(dense_p, "dec")):
            att, _ = A.mha(lp_d["attn"], L.rmsnorm(lp_d["ln1"], x),
                           positions, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                           rope_theta=cfg.rope_theta)
            h = L.rmsnorm(lp_d["lnx"], x + att)
            gaps.append(logit_gap(xattn(lp_d, h, memory),
                                  xattn(lp_x, h, memory)))
            x = T._layer_fwd(lp_d, x, positions, cfg, "xdec", memory)[0]
        return gaps
    memory = frontend.to(x.dtype)
    for g_x, g_d in zip(T.layer_params(exec_p, "groups"),
                        T.layer_params(dense_p, "groups")):
        for lp in T.layer_params(g_d, "selfs"):
            x = T._layer_fwd(lp, x, positions, cfg, "dense")[0]
        h = L.rmsnorm(g_d["cross"]["ln1"], x)
        gaps.append(logit_gap(xattn(g_d["cross"], h, memory),
                              xattn(g_x["cross"], h, memory)))
        x = T._layer_fwd(g_d["cross"], x, positions, cfg, "cross",
                         memory)[0]
    return gaps


def xfam_serve_phase(mods, arch):
    """``arch`` through the port's entry points: bf16, seed 0, rate 0.6,
    4 bins, B = 4 x 32 prompts and the data pipeline's (4, 1024, d_model)
    frontend, 16 new tokens.  Kernel 1's launches over the ``generate``
    asserted from the layouts; warm times and busy shares; bf16 prefill
    logits vs masked-dense and each planted fault; then fp32 at
    XFAM_FP32's depth (TF32 off): logits and greedy tokens packed vs
    masked-dense, each planted fault breaking the logit bound."""
    T, C, E = mods["T"], mods["C"], mods["E"]
    from repro_torch import configs
    from repro_torch.data.pipeline import synthetic_batch
    cfg = xfam_config(arch)
    full = configs.get(arch)
    if DEV == "cuda":
        torch.cuda.reset_peak_memory_stats()
    print(f"[encdec/vlm] {arch} at full width (d_model {cfg.d_model}, "
          f"heads {cfg.n_heads}/{cfg.n_kv_heads} x {cfg.hd}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab}, frontend {cfg.n_frontend_tokens}"
          f" tokens); "
          + (f"depth cut to {cfg.n_enc_layers} + {cfg.n_layers} of "
             f"{full.n_enc_layers} + {full.n_layers} layers"
             if cfg.family == "encdec" else
             f"depth cut to {cfg.n_layers} of {full.n_layers} layers "
             f"({VLM_GROUPS} groups of {cfg.cross_attn_interval - 1} self + "
             f"1 cross); every cross gate set to 1.0 on the packed and the "
             f"masked-dense tree")
          + f"; card {smi_line() if DEV == 'cuda' else DEV}")
    frontend = synthetic_batch(0, 0, B, S, cfg.vocab,
                               frontend_tokens=cfg.n_frontend_tokens,
                               d_model=cfg.d_model, device=DEV)["frontend"]
    pm, exec_p, report, init_s, compile_s = xfam_build(mods, cfg,
                                                        torch.bfloat16)
    print(f"init + masks {init_s:.2f}s; compile_model {compile_s:.2f}s:")
    print(C.compiled_summary(report))
    # every projection packs: encdec's encoder 7 + decoder 11 stacks,
    # vlm's self 7 + cross 7
    n_stacks = 18 if cfg.family == "encdec" else 14
    if len(report.packed) != n_stacks or any(
            lay.n_bins != min(N_BINS, lay.Nb)
            for lay in packed_layouts(exec_p)):
        raise AssertionError(f"expected {n_stacks} packed stacks of "
                             f"{N_BINS} bins, got {len(report.packed)}")
    pre, step = xfam_launches(cfg)
    want = pre + N_NEW * step
    e2e, launches, prompts, tokens = serve_counted(
        mods, exec_p, cfg, full, compile_s,
        f"{pre} a prefill + {N_NEW} x {step} a decode step = {want}, one "
        f"launch a packed projection over the {N_BINS} bins", want=want,
        frontend=frontend)
    if DEV == "cuda":
        e2e["serve_peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9

    # bf16 gates: the prefill logits, and each cross-attention layer's
    # output on the masked-dense run's input; a planted fault must break
    # one of them
    with torch.no_grad():
        d_logits = E.prefill(pm, cfg, tokens, frontend)[0]
        s_logits = E.prefill(exec_p, cfg, tokens, frontend)[0]
        gap = logit_gap(d_logits, s_logits)
        xgaps = cross_gaps(mods, exec_p, pm, cfg, tokens, frontend)
        faults = {}
        for path in xfam_faults(cfg):
            bad = zeroed_bin(exec_p, path)
            faults[path] = (logit_gap(d_logits, E.prefill(
                bad, cfg, tokens, frontend)[0]), max(
                cross_gaps(mods, bad, pm, cfg, tokens, frontend),
                key=lambda g: g[0]))
            del bad
    sync()
    agree = (d_logits.argmax(-1) == s_logits.argmax(-1)).float().mean()
    worst = max(xgaps, key=lambda g: g[0])
    print(f"[encdec/vlm] {arch} prefill logits packed vs masked-dense "
          f"(bf16): max|diff| {gap[0]:.4f} of max|logit|, mean |diff| "
          f"{gap[1]:.4f} of mean |logit| (bound {LOGIT_MAX_REL} / "
          f"{LOGIT_MEAN_REL}); argmax agree {agree:.2f}; each cross-"
          f"attention layer on one input: worst {worst[0]:.4f} / "
          f"{worst[1]:.4f}")

    def caught(g):
        return not (within_bound(g[0]) and within_bound(g[1]))
    for path, (g, xg) in faults.items():
        print(f"  planted fault, {path}: largest bin zeroed, every layer: "
              f"logits {g[0]:.4f} / {g[1]:.4f}, worst cross-attention "
              f"layer {xg[0]:.4f} / {xg[1]:.4f}"
              f"{'' if caught((g, xg)) else '  (NOT CAUGHT)'}")
    e2e.update(logits_gap=gap, cross_layer_gaps=xgaps,
               planted_faults=faults, compile_s=compile_s, init_s=init_s)
    if not (torch.isfinite(s_logits).all() and within_bound(gap)
            and all(map(within_bound, xgaps))):
        raise AssertionError(f"{arch}: packed bf16 disagrees with "
                             f"masked-dense beyond the bound")
    missed = [path for path, g in faults.items() if not caught(g)]
    if missed:
        raise AssertionError(f"{arch}: the bf16 bounds do not catch "
                             f"{missed}")
    del exec_p, pm, d_logits, s_logits
    if DEV == "cuda":
        e2e["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        print(f"[encdec/vlm] {arch} peak device memory "
              f"{e2e['peak_mem_gb']:.2f} GB (torch.cuda."
              f"max_memory_allocated)")
        torch.cuda.empty_cache()

    cfg32 = cfg.replace(**XFAM_FP32[arch])
    if DEV == "cuda":
        torch.cuda.reset_peak_memory_stats()
    pm, exec_p, _, _, _ = xfam_build(mods, cfg32, torch.float32)
    with torch.no_grad():
        d32 = T.forward(pm, cfg32, tokens, frontend=frontend)
        gap32 = logit_gap(d32, T.forward(exec_p, cfg32, tokens,
                                         frontend=frontend))[0]
        faults32 = {path: logit_gap(d32, T.forward(
            zeroed_bin(exec_p, path), cfg32, tokens,
            frontend=frontend))[0] for path in xfam_faults(cfg)}
        tok_d = E.generate(pm, cfg32, prompts, N_NEW, device=DEV,
                           frontend=frontend)
        tok_s = E.generate(exec_p, cfg32, prompts, N_NEW, device=DEV,
                           frontend=frontend)
    same = bool(torch.equal(tok_d, tok_s))
    depth = (f"{cfg32.n_enc_layers} + {cfg32.n_layers} layers"
             if cfg.family == "encdec" else
             f"{cfg32.n_layers // cfg.cross_attn_interval} group")
    print(f"[encdec/vlm] {arch} fp32 ({depth}, TF32 off): logits packed vs "
          f"masked-dense {gap32:.2e} of max|logit| (bound "
          f"{MOE_FP32_LOGIT_REL}); planted faults "
          + ", ".join(f"{p} {g:.3f}" for p, g in faults32.items())
          + f"; greedy tokens identical: {same}")
    e2e.update(fp32_logit_gap=gap32, fp32_faults=faults32,
               fp32_tokens_identical=same)
    if DEV == "cuda":
        e2e["fp32_peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    if not (gap32 <= MOE_FP32_LOGIT_REL and same):
        raise AssertionError(f"{arch}: an fp32 gate failed")
    if any(g <= MOE_FP32_LOGIT_REL for g in faults32.values()):
        raise AssertionError(f"{arch}: the fp32 bound does not catch a "
                             f"planted fault")
    del exec_p, pm
    if DEV == "cuda":
        torch.cuda.empty_cache()
    return e2e, launches


def packed_layouts(tree):
    """Every packed layout of a param tree."""
    if not isinstance(tree, dict):
        return []
    if "packed" in tree:
        return [tree["packed"]]
    return [lay for v in tree.values() for lay in packed_layouts(v)]


def xfam_phase(mods, flush):
    """The encdec and vlm families: kernel 1 at their shapes, each model
    served, and their SMOKE loss and grads on the card against the CPU
    (``forward_aux`` through ``make_loss_fn``, the penalty's fault on
    seamless).  Returns (out, launches by arch)."""
    rows, checks = xfam_kernel_phase(mods, flush)
    out = {"rows": rows, "checks": checks, "serve": {}}
    launches = {}
    for arch in XFAM_ARCHS:
        stamp(f"{arch} served")
        out["serve"][arch], launches[arch] = xfam_serve_phase(mods, arch)
    grads = {a: train_grads_gate(mods, a) for a in XFAM_ARCHS}
    fault = train_grads_gate(mods, XFAM_ARCHS[0], fault=True)
    print(f"[encdec/vlm] SMOKE fp32 forward_aux loss and grads, card vs "
          f"CPU (TF32 off): "
          + ", ".join(f"{a} loss {g[0]:.2e}, grads {g[1]:.2e}"
                      for a, g in grads.items())
          + f" (bound {TRAIN_GRAD_TOL}); planted fault (the penalty "
          f"dropped on the card): loss {fault[0]:.3f}")
    out.update(smoke_grad_gaps=grads, smoke_grad_fault=fault)
    if any(g[0] > TRAIN_GRAD_TOL or g[1] > TRAIN_GRAD_TOL
           for g in grads.values()) or fault[0] <= TRAIN_GRAD_TOL:
        raise AssertionError("[encdec/vlm] card autograd disagrees with the "
                             "CPU or the gate missed its fault")
    return out, launches


def xfam_entry(out, launches):
    """Kernel 1's ``encdec_vlm`` branch: each generate's launches, the
    checks, and every timed layer's rows and sums."""
    n, err = out["checks"]
    entry = {"launches_by_path": {f"{a} generate": launches[a]["bsr_matmul"]
                                  for a in XFAM_ARCHS},
             "cases": n, "max_abs_err": err,
             "measured_at": f"sum over a layer's projections (bf16 x, "
                            f"{BLOCK} blocks, rate 0.6, {N_BINS} bins) at "
                            f"each M; library = torch.matmul on the masked "
                            f"dense weight"}
    for what, rows in out["rows"].items():
        entry[what] = {
            f"M={M}": layer_sum(rows, M) for M in sorted({r["M"]
                                                           for r in rows})}
        entry[what]["shapes"] = [
            {"layer": r["proj"], "M": r["M"], "K": r["K"], "N": r["N"],
             "ms": r["ms"], "bound_ms": r["bound_ms"],
             "bound_by": r["bound_by"], "plain_ms": r["plain_ms"],
             "library_ms": r["library_ms"], "stream_ms": r["stream_ms"]}
            for r in rows]
    return entry


# -- the dry run and the roofline (launch/dryrun.py, core/roofline.py) --------

# the production cells: each `python -m repro_torch.launch.dryrun` call its
# own process (a "fake" group of 256 / 512 ranks cannot share a process
# with the one-rank NCCL group of the mesh phase), all started together
DRYRUN_CELLS = (("yi-9b", "train_4k", "single"),
                ("yi-9b", "prefill_32k", "single"),
                ("yi-9b", "decode_32k", "both"),
                ("yi-9b", "long_500k", "single"),
                ("mixtral-8x7b", "decode_32k", "single"),
                ("mamba2-1.3b", "long_500k", "single"))
DRYRUN_TIMEOUT_S = 600
# the one-card cells, (arch, shape, layers, batch): None keeps the
# published depth / the shape's batch.  yi-9b at full width with 2 of 48
# layers; prefill_32k's B cut to 1 of 32, train_4k's to 8 of 256;
# decode_32k at its own B = 128 over a 32768 cache (~17 GB of bf16 KV at
# 2 layers); mamba2-1.3b at full width and depth
CARD_CELLS = (("yi-9b", "decode_32k", 2, None),
              ("yi-9b", "prefill_32k", 2, 1),
              ("yi-9b", "train_4k", 2, 8),
              ("mamba2-1.3b", "long_500k", None, None))
CARD_ITERS = 3


def dryrun_start(out_dir):
    """Start every production cell's dry run (fake tensors on the card's
    device type, a fake group of 256 or 512 ranks): [(cell, Popen)]."""
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = []
    for arch, shape, mesh in DRYRUN_CELLS:
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               arch, "--shape", shape, "--mesh", mesh, "--out", str(out_dir),
               "--device", DEV]
        procs.append(((arch, shape, mesh), subprocess.Popen(
            cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    return procs


def dryrun_wait(procs, out_dir):
    """Wait for every production cell (the caller kills what is left if
    this raises); each must exit 0 and leave its records: OK, or the
    reference's SKIP where the config does not support the shape.  Prints
    each record's per-device numbers and its largest collective sites."""
    from repro_torch import configs
    for cell, p in procs:
        log, _ = p.communicate(timeout=DRYRUN_TIMEOUT_S)
        assert p.returncode == 0, (cell, log[-3000:])
    recs = {}
    for arch, shape, mesh in DRYRUN_CELLS:
        ok, why = configs.cell_is_supported(configs.get(arch), shape)
        for m in (("single", "multi") if mesh == "both" else (mesh,)):
            rec = json.loads((out_dir / f"{arch}__{shape}__{m}.json")
                             .read_text())
            recs[f"{arch} x {shape} x {m}"] = rec
            if not ok:
                assert rec["status"] == why and why.startswith("SKIP"), rec
                print(f"[dryrun] {arch} x {shape} x {m}: {why}")
                continue
            assert rec["status"] == "OK", rec
            c = rec["collectives"]
            print(f"[dryrun] {arch} x {shape} x {m} ({rec['n_devices']} "
                  f"ranks): per device {rec['cost']['flops']:.6g} FLOP, "
                  f"{rec['cost']['bytes accessed']:.6g} B (unfused), "
                  f"collectives {c['total']:.6g} B "
                  + json.dumps({k: c[k] for k in c
                                if k not in ("total", "counts")})
                  + f" counts {json.dumps(c['counts'])}, peak "
                  f"{rec['memory']['peak_bytes'] / 2**30:.3f} GiB "
                  f"(arguments {rec['memory']['argument_bytes'] / 2**30:.3f}"
                  f" GiB), traced in {rec['trace_s']} s")
            sites = list(rec["collective_sites"].items())[:4]
            print(f"[dryrun]   collective bytes by site: " + ", ".join(
                f"{k} {v:.6g}" for k, v in sites))
    return recs


def card_cell(arch, shape, layers, batch, mesh, gen):
    """One cell on the one-rank mesh, under fake tensors and for real:
    (dict of the numbers, dry-run costs)."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch import configs
    from repro_torch.core import roofline as RL
    from repro_torch.launch import dryrun as DR
    cfg = configs.get(arch)
    if layers is not None:
        cfg = cfg.replace(n_layers=layers)
    fn, args, specs = DR.build_step(cfg, shape, mesh, batch=batch)
    fake = DR.trace(fn, args, specs, mesh, DEV)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    placed = DR.materialize(args, specs, mesh, DEV, gen)
    out = fn(*placed)                    # warm-up (and DTensor's caches)
    del out
    sync()
    with FlopCounterMode(display=False) as fc:
        out = fn(*placed)
    del out
    sync()
    real_flops = fc.get_total_flops()
    ms = []
    for _ in range(CARD_ITERS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn(*placed)
        b.record()
        sync()
        del out
        ms.append(a.elapsed_time(b))
    peak = torch.cuda.max_memory_allocated() - base
    del placed
    torch.cuda.empty_cache()
    t = RL.H100
    compute_ms = fake["flops"] / t.peak_flops * 1e3
    memory_ms = fake["bytes"] / t.hbm_bw * 1e3
    warm = statistics.median(ms)
    row = {"arch": arch, "shape": shape, "layers": cfg.n_layers,
           "batch": batch or configs.SHAPES[shape]["batch"],
           "fake_flops": fake["flops"], "real_flops": real_flops,
           "bytes": fake["bytes"], "warm_ms": warm, "ms": ms,
           "compute_ms": compute_ms, "memory_ms": memory_ms,
           "measured_over_memory": warm / memory_ms,
           "dryrun_peak_bytes": fake["memory"]["peak_bytes"],
           "max_memory_allocated": peak, "trace_s": fake["trace_s"]}
    print(f"[dryrun] card {arch} x {shape} ({cfg.n_layers} layers, B "
          f"{row['batch']}): FLOP fake {fake['flops']} real {real_flops}; "
          f"warm {warm:.3f} ms (of {', '.join(f'{x:.3f}' for x in ms)}) vs "
          f"compute term {compute_ms:.4f} ms, memory term {memory_ms:.4f} "
          f"ms (measured / memory {warm / memory_ms:.3f}); peak dry run "
          f"{fake['memory']['peak_bytes'] / 2**30:.3f} GiB vs "
          f"max_memory_allocated {peak / 2**30:.3f} GiB; traced in "
          f"{fake['trace_s']:.1f} s")
    assert fake["flops"] == real_flops, (arch, shape, fake["flops"],
                                         real_flops)
    assert warm >= compute_ms, (arch, shape, warm, compute_ms)
    return row


def dryrun_phase():
    """The dry run on the card's machine: the production cells in their
    own processes (fake groups) and the roofline priced for the H100,
    then the one-card cells on a one-rank mesh, fake against real.  Not
    at once: each production process opens a CUDA context (a fake
    tensor on "cuda" does), which fails for memory while a one-card
    cell holds most of the card."""
    from repro_torch.launch import mesh as MESH
    from repro_torch.launch import roofline_report
    out_dir = ROOT / "build" / "chip_smoke_dryrun"
    for f in out_dir.glob("*.json") if out_dir.exists() else ():
        f.unlink()
    t0 = time.perf_counter()
    procs = dryrun_start(out_dir)
    try:
        recs = dryrun_wait(procs, out_dir)
    finally:
        for _, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    prod_s = time.perf_counter() - t0
    report = roofline_report.main(["--dir", str(out_dir)])
    gen = torch.Generator(device=DEV)
    gen.manual_seed(0)
    rows = []
    mesh = MESH.make_local_mesh(device=DEV)
    try:
        for arch, shape, layers, batch in CARD_CELLS:
            rows.append(card_cell(arch, shape, layers, batch, mesh, gen))
    finally:
        MESH.close_local_mesh()
    card_s = time.perf_counter() - t0 - prod_s
    print(f"[dryrun] production cells {prod_s:.1f} s (in parallel), "
          f"one-card cells {card_s:.1f} s")
    return {"card": rows, "records": recs, "roofline": report,
            "card_s": card_s, "production_s": prod_s}


# -- the reference's remaining surface: BCS, the raw entries, the cache ------

SURFACE_M = (4, 128)     # the raw entry timed at decode and prefill
SURFACE_INT8_M = (1, 4, 17, 128, 129)
SURFACE_TEMPERATURE = 0.7


def bcs_on_host(BCS, bcs):
    """A ``core.bcs.BCS`` with every tensor on the host."""
    return dataclasses.replace(
        bcs, values=bcs.values.cpu(), col_idx=bcs.col_idx.cpu(),
        row_ptr=bcs.row_ptr.cpu(), occurrence=bcs.occurrence.cpu(),
        patterns=[q.cpu() for q in bcs.patterns])


def bcs_stats(mods, w, mask, block, check=True):
    """``core.bcs`` on the card for one weight: ``from_dense``, its
    ``to_dense`` == the masked weight bitwise and ``pad_to_uniform_csc``
    == ``pad_to_uniform_csc_loop`` on the host bitwise (``check``); the
    format's numbers beside the 4-bin reordered layout's.  Returns (stats,
    (values, k_idx) of the uniform layout, reordered layout)."""
    BCS, ops = mods["BCS"], mods["ops"]
    bcs = BCS.from_dense(w, mask, block)
    vals, kidx, nnz = BCS.pad_to_uniform_csc(bcs)
    lay = ops.pack(w, mask, block, reorder=True, n_bins=N_BINS,
                   use_cache=False)
    if check:
        if not torch.equal(BCS.to_dense(bcs), w * mask.to(w.dtype)):
            raise AssertionError("BCS.to_dense != the masked weight")
        loop = BCS.pad_to_uniform_csc_loop(bcs_on_host(BCS, bcs))
        if not all(torch.equal(a.cpu(), b) for a, b in zip((vals, kidx, nnz),
                                                          loop)):
            raise AssertionError("pad_to_uniform_csc != its loop reference")
    Nb, L = kidx.shape
    stats = {"K": w.shape[0], "N": w.shape[1], "block": tuple(block),
             "nnzb": bcs.nnzb, "density": bcs.density,
             "index_bytes": bcs.index_bytes(),
             "csr_index_bytes": bcs.csr_index_bytes(),
             "patterns": len(bcs.patterns),
             "load_imbalance": BCS.load_imbalance(bcs),
             "L_max": L, "bin_L": list(lay.bin_degrees),
             "padded_blocks": Nb * L,
             "binned_blocks": lay.executed_blocks}
    return stats, (vals, kidx), lay


def print_bcs(rows, title):
    print(title)
    print(f"  {'proj':8s} {'nnzb':>7s} {'density':>7s} {'idx B':>8s} "
          f"{'csr B':>8s} {'pat':>5s} {'imbal':>6s} {'L_max':>5s} "
          f"{'bins L':>18s} {'padded':>8s} {'binned':>8s}")
    for name, r in rows:
        print(f"  {name:8s} {r['nnzb']:7d} {r['density']:7.4f} "
              f"{r['index_bytes']:8d} {r['csr_index_bytes']:8d} "
              f"{r['patterns']:5d} {r['load_imbalance']:6.3f} "
              f"{r['L_max']:5d} {str(r['bin_L']):>18s} "
              f"{r['padded_blocks']:8d} {r['binned_blocks']:8d}")


def trained_bcs(mods, params, masks, layers):
    """``bcs_stats`` (no loop check) of the trained (8, 16) masks of
    ``layers``, each of the 7 projections: skewed masks are what the
    degree binning is for."""
    rows = []
    for i in layers:
        for name, _, _, _ in PROJECTIONS:
            g = "attn" if name.startswith("w") else "ffn"
            m = masks["layers"][g][name]["w"]
            if m.ndim == 0:                  # served dense: not pruned
                continue
            w, m = params["layers"][g][name]["w"][i], m[i]
            rows.append((f"{i}/{name}", bcs_stats(mods, w, m, (8, 16),
                                                  check=False)[0]))
    print_bcs(rows, f"[train] BCS of the trained (8, 16) masks, layers "
                    f"{list(layers)} (idx B = hierarchical index bytes, "
                    f"csr B = plain CSR's; imbal = load_imbalance over "
                    f"block rows; padded = Nb x L_max, binned = the "
                    f"{N_BINS}-bin layout's executed blocks):")
    return rows


def values_as(lay, dtype):
    """A float layout with its values in ``dtype`` (the same slots)."""
    return dataclasses.replace(lay, values=tuple(v.to(dtype)
                                                 for v in lay.values))


def raw_kernel1(mods, pm, masks, gen, flush):
    """Kernel 1's raw entry over one yi-9b layer (layer 0 of the served
    masked params): the BCS format of each projection on the card, the
    raw entry vs plain at CHECK_M (bf16, fp32) and bitwise vs the 4-bin
    reordered layout, int8 under both scale shapes, ``out_dtype=float32``;
    the counted run (the layer's 7 projections through the raw entry at
    decode), then the raw entry and the reordered layout timed at
    SURFACE_M beside ``torch.matmul`` and the bound."""
    K, ref, QUANT = mods["K"], mods["ref"], mods["QUANT"]
    from repro_torch.core.packed import PackedLayout
    stats, cases, rows = [], {}, []
    checks, max_err, max_err8 = 0, 0.0, 0.0
    for name, Kd, Nd, act in PROJECTIONS:
        g = "attn" if name.startswith("w") else "ffn"
        w = pm["layers"][g][name]["w"][0]
        m = masks["layers"][g][name]["w"][0]
        st, (vals, kidx), lay = bcs_stats(mods, w, m, BLOCK)
        stats.append((name, st))
        cases[name] = (vals, kidx, lay, w * m.to(w.dtype), act)
        b = (torch.randn(Nd, generator=gen, device=DEV) * 0.1)
        for dtype in (torch.bfloat16, torch.float32):
            v, ly = vals.to(dtype), (lay if dtype == torch.bfloat16 else
                                     values_as(lay, dtype))
            bd = b.to(dtype)
            for M in CHECK_M:
                x = torch.randn(M, Kd, generator=gen, device=DEV).to(dtype)
                y = K.bsr_matmul(x, v, kidx, bd, act=act)
                want = ref.bsr_matmul_ref(x.float(), v.float(), kidx,
                                          bd.float(), act)
                packed = K.bsr_matmul_packed(x, ly, bd, act)
                sync()
                what = f"{name} M={M} {dtype} act={act}"
                max_err = max(max_err, check_close(
                    y, want, dtype, f"raw kernel 1 vs plain at {what}"))
                if not torch.equal(y, packed):
                    d = (y.float() - packed.float()).abs().max().item()
                    raise AssertionError(f"raw kernel 1 != the reordered "
                                         f"layout bitwise at {what} (max "
                                         f"|diff| {d:.3e})")
                checks += 1
        # int8, a scale per block and per column; fp32 out of a bf16 x
        one = PackedLayout(values=(vals,), k_idx=(kidx,),
                           nnz=torch.full((vals.shape[0],), vals.shape[1],
                                          dtype=torch.int32, device=DEV),
                           block=BLOCK, shape=(Kd, Nd))
        for gran in ("block", "out"):
            q = QUANT.quantize_layout(one, value_dtype="int8",
                                      scale_granularity=gran)
            for M in SURFACE_INT8_M:
                x = torch.randn(M, Kd, generator=gen, device=DEV).to(
                    torch.bfloat16)
                y = K.bsr_matmul(x, q.values[0], kidx, scales=q.scales[0],
                                 act=act)
                want = ref.bsr_matmul_ref(x.float(), q.values[0], kidx,
                                          act=act, scales=q.scales[0])
                sync()
                max_err8 = max(max_err8, check_close(
                    y, want, torch.bfloat16,
                    f"raw kernel 1 int8 ({gran}) vs plain at {name} M={M}"))
                checks += 1
        for M in SURFACE_M:
            x = torch.randn(M, Kd, generator=gen, device=DEV).to(
                torch.bfloat16)
            y = K.bsr_matmul(x, vals, kidx, act=act,
                             out_dtype=torch.float32)
            want = ref.bsr_matmul_ref(x.float(), vals.float(), kidx, act=act)
            sync()
            if y.dtype != torch.float32:
                raise AssertionError("out_dtype=float32 gave " + str(y.dtype))
            max_err = max(max_err, check_close(
                y, want, torch.float32,
                f"raw kernel 1 out_dtype=float32 vs plain at {name} M={M}"))
            checks += 1
    print_bcs(stats, f"BCS on the card, yi-9b layer 0 ({BLOCK} blocks, rate "
                     f"{PRUNE_RATE}; to_dense == masked weight and "
                     f"pad_to_uniform_csc == its host loop, bitwise; idx B "
                     f"= hierarchical index bytes, csr B = plain CSR's; "
                     f"imbal = load_imbalance over block rows; padded = Nb "
                     f"x L_max, binned = the {N_BINS}-bin layout's "
                     f"executed blocks):")
    print(f"raw kernel 1 (bsr_matmul over pad_to_uniform_csc): {checks} "
          f"cases, M in {CHECK_M} bf16 + fp32 (bitwise == the {N_BINS}-bin "
          f"reordered layout), int8 a block / a column at "
          f"{SURFACE_INT8_M}, out_dtype=float32 at {SURFACE_M}; max abs "
          f"err {max_err:.3e} (int8 {max_err8:.3e})")

    # the counted run: the layer's projections at decode, raw entry only
    xs = {name: torch.randn(4, Kd, generator=gen, device=DEV).to(
        torch.bfloat16) for name, Kd, _, _ in PROJECTIONS}
    K.reset_launches()
    outs = [K.bsr_matmul(xs[name], cases[name][0], cases[name][1],
                         act=cases[name][4]) for name, *_ in PROJECTIONS]
    sync()
    launches = K.LAUNCHES["bsr_matmul_raw"]
    if launches != len(PROJECTIONS) or not all(
            torch.isfinite(o).all() for o in outs):
        raise AssertionError(f"raw kernel 1: {launches} launches for "
                             f"{len(PROJECTIONS)} projections")
    print(f"raw kernel 1, counted: one yi-9b layer at decode, "
          f"{launches} launches (one a projection)")

    for name, Kd, Nd, act in PROJECTIONS:
        vals, kidx, lay, dense, _ = cases[name]
        nnzb = int(lay.nnz.sum())
        for M in SURFACE_M:
            x = torch.randn(M, Kd, generator=gen, device=DEV).to(
                torch.bfloat16)
            nbytes = kernel1_bytes(lay) + M * (Kd + Nd) * 2
            flops = 2 * M * nnzb * math.prod(BLOCK)
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = flops / BF16_PEAK_FLOPS * 1e3
            rows.append({
                "proj": name, "M": M, "K": Kd, "N": Nd,
                "L_max": vals.shape[1], "bin_L": list(lay.bin_degrees),
                "ms": time_ms(lambda: K.bsr_matmul(x, vals, kidx, act=act),
                              30, flush),
                "reordered_ms": time_ms(
                    lambda: K.bsr_matmul_packed(x, lay, None, act), 30,
                    flush),
                "plain_ms": time_ms(lambda: ref.bsr_matmul_ref(
                    x, vals, kidx, act=act), 3, flush),
                "library_ms": time_ms(lambda: torch.matmul(x, dense), 30,
                                      flush),
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "bytes_ms": t_bytes, "ops_ms": t_ops})
    print("raw kernel 1 timings (bf16, L2 flushed, median ms by CUDA-graph "
          "replay): the uniform layout padded to L_max against the "
          f"{N_BINS}-bin reordered layout of the same weights (Fig 4):")
    print(f"  {'proj':8s} {'M':>4s} {'L_max':>5s} {'bins L':>18s} "
          f"{'raw':>9s} {'binned':>9s} {'bound':>9s} {'plain':>9s} "
          f"{'matmul':>9s}")
    for r in rows:
        print(f"  {r['proj']:8s} {r['M']:4d} {r['L_max']:5d} "
              f"{str(r['bin_L']):>18s} {r['ms']:9.4f} "
              f"{r['reordered_ms']:9.4f} {r['bound_ms']:9.4f} "
              f"{r['plain_ms']:9.4f} {r['library_ms']:9.4f}")
    sums = {}
    for M in SURFACE_M:
        sel = [r for r in rows if r["M"] == M]
        t = {k: sum(r[k] for r in sel)
             for k in ("ms", "reordered_ms", "plain_ms", "library_ms",
                       "bytes_ms", "ops_ms")}
        t["bound_ms"] = max(t["bytes_ms"], t["ops_ms"])
        t["bound_by"] = ("bytes" if t["bytes_ms"] >= t["ops_ms"]
                         else "operations")
        sums[M] = t
        print(f"  one yi-9b layer at M = {M}: raw {t['ms']:.4f} ms, binned "
              f"{t['reordered_ms']:.4f}, torch.matmul "
              f"{t['library_ms']:.4f}, bound {t['bound_ms']:.4f} "
              f"({t['bound_by']}), plain {t['plain_ms']:.3f}")
    return {"bcs": dict(stats), "checks": checks, "max_abs_err": max_err,
            "max_abs_err_int8": max_err8, "rows": rows,
            "decode": sums[SURFACE_M[0]], "prefill": sums[SURFACE_M[1]],
            "launches": launches}


def raw_kernel2(mods, gen, flush):
    """Kernel 2's raw entry at VGG_TINY c5 under the pattern mapping (a
    1x1 conv: the alive band of the B = CONV_B input): vs plain and
    bitwise vs ``tap_gather_conv_packed`` over the reordered layout, the
    counted run, timed beside the packed entry, ``F.conv2d`` and the
    bound."""
    RW, CN, ops, ref, K = (mods["RW"], mods["CN"], mods["ops"], mods["ref"],
                           mods["K"])
    import torch.nn.functional as F
    from repro_torch.train.trainer import apply_masks
    params = CN.convnet_init(CN.VGG_TINY, seed=0, device=DEV)
    spec = conv_mappings(RW)[1][1]
    masks = conv_masks(RW, "pattern", params, spec)
    pm = apply_masks(params, masks)
    _, kh, kw, stride, shape = next(c for c in layer_inputs(
        CN.VGG_TINY, CONV_HW, CONV_B) if c[0] == "c5")
    wm, mask = pm["c5"]["w"], masks["c5"]["w"]
    one = ops.pack_taps(wm, mask, reorder=False, use_cache=False)
    lay = ops.pack_taps(wm, mask, reorder=True, use_cache=False)
    x = torch.randn(shape, generator=gen, device=DEV)
    band = ops.im2col(x, kh, kw, stride).reshape(-1, lay.shape[0])
    if lay.n_alive < band.shape[1]:
        band = band.index_select(1, lay.alive.long())
    band = band.contiguous()
    P = wm.shape[0]
    b = torch.randn(P, generator=gen, device=DEV) * 0.1
    vals, tidx = one.values[0], one.t_idx[0]
    y = K.tap_gather_conv(band, vals, tidx, b, act="relu")
    want = ref.tap_gather_ref(band, vals, tidx, b, "relu")
    packed = K.tap_gather_conv_packed(band, lay, b, "relu")
    sync()
    err = check_close(y, want, torch.float32, "raw kernel 2 vs plain at c5")
    if not torch.equal(y, packed):
        raise AssertionError("raw kernel 2 != tap_gather_conv_packed over "
                             "the reordered layout, bitwise")
    K.reset_launches()
    y = K.tap_gather_conv(band, vals, tidx, b, act="relu")
    sync()
    launches = K.LAUNCHES["tap_gather_conv_raw"]
    if launches != 1 or not torch.isfinite(y).all():
        raise AssertionError(f"raw kernel 2: {launches} launches")
    M, R = band.shape
    live = int(one.nnz.sum()) * one.group
    flops = 2 * M * live
    nbytes = band.numel() * 4 + layout_bytes(one) + M * P * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_PEAK_FLOPS * 1e3
    dense = (wm * mask).float()
    xn = x.permute(0, 3, 1, 2).contiguous()
    row = {"layer": "vgg/c5/pattern", "M": M, "R": R, "N": P,
           "L": vals.shape[1], "bin_L": list(lay.bin_degrees),
           "max_abs_err": err, "launches": launches,
           "ms": time_ms(lambda: K.tap_gather_conv(band, vals, tidx, b,
                                                   act="relu"), 20, flush),
           "packed_ms": time_ms(lambda: K.tap_gather_conv_packed(
               band, lay, b, "relu"), 20, flush),
           "plain_ms": time_ms(lambda: ref.tap_gather_ref(
               band, vals, tidx, b, "relu"), 3, flush),
           "library_ms": time_ms(lambda: torch.relu(F.conv2d(
               xn, dense, b, stride=stride)), 20, flush),
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    print(f"raw kernel 2 (tap_gather_conv, one bin) at VGG_TINY c5 pattern "
          f"(M {M}, R {R}, P {P}, L {row['L']} vs bins {row['bin_L']}): "
          f"vs plain max abs err {err:.3e}, == tap_gather_conv_packed "
          f"bitwise; counted {launches} launch; {row['ms']:.4f} ms (packed "
          f"{row['packed_ms']:.4f}, F.conv2d {row['library_ms']:.4f}, "
          f"bound {row['bound_ms']:.4f} ({row['bound_by']}), plain "
          f"{row['plain_ms']:.3f}; fp32, bias + relu, L2 flushed)")
    return row


def cache_compiles(mods, pm, masks, cfg):
    """The pack cache on the card over two ``compile_model`` calls of the
    served 8-layer yi-9b: the byte bound set to hold the first's packs
    (printed), the second all hits with the same layout objects and
    equal trees; greedy tokens of both equal, the second ``generate``
    counted (the main path: 952 launches); the digest's and the packs'
    ms of the first; the default bounds restored and the evictions they
    cause; a fault injected on a cached layout leaves the cache's copy
    valid.  Returns (out, exec params of the second compile, launches,
    prompts)."""
    ops, C, E, K, V, F_, BCS, MODULE = (
        mods["ops"], mods["C"], mods["E"], mods["K"], mods["V"], mods["F"],
        mods["BCS"], mods["M"])
    from repro_torch.launch.serve import SPARSE_SPEC
    spans = {"digest": [], "pack": []}

    def timed(kind, fn):
        def run(*a, **k):
            sync()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            sync()
            spans[kind].append(time.perf_counter() - t0)
            return out
        return run
    defaults = ops.configure_pack_cache()
    ops.clear_pack_cache()
    ops.configure_pack_cache(max_bytes=1 << 40)
    s0 = ops.pack_cache_stats()
    with mock.patch.object(ops, "_digest", timed("digest", ops._digest)), \
            mock.patch.object(BCS, "pack_csc_reordered",
                              timed("pack", BCS.pack_csc_reordered)):
        first, _, first_s = compile_timed(mods, pm, masks, SPARSE_SPEC)
    s1 = ops.pack_cache_stats()
    held = s1["bytes"]
    ops.configure_pack_cache(max_bytes=held)
    entries = list(ops._PACK_CACHE.values())
    second, _, second_s = compile_timed(mods, pm, masks, SPARSE_SPEC)
    s2 = ops.pack_cache_stats()
    n = cfg.n_layers * len(PROJECTIONS)
    got = {"first": {k: s1[k] - s0[k] for k in ("hits", "misses")},
           "second": {k: s2[k] - s1[k] for k in ("hits", "misses")}}
    now = list(ops._PACK_CACHE.values())
    same = len(now) == len(entries) and all(
        a is b for a, b in zip(now, entries))
    la, lb = MODULE.tree_leaves(first), MODULE.tree_leaves(second)
    trees_equal = len(la) == len(lb) and all(
        torch.equal(a, b) for a, b in zip(la, lb))
    print(f"pack cache: byte bound set to hold one {cfg.n_layers}-layer "
          f"yi-9b compile, {held} bytes ({held / 2**30:.3f} GiB) in "
          f"{s1['entries']} entries; first compile {got['first']} in "
          f"{first_s:.2f}s, second {got['second']} in {second_s:.2f}s; "
          f"same layout objects {same}, trees equal {trees_equal}")
    if (got["first"] != {"hits": 0, "misses": n}
            or got["second"] != {"hits": n, "misses": 0} or not same
            or not trees_equal):
        raise AssertionError(f"pack cache: expected {n} misses then {n} "
                             f"hits on the same layouts, got {got}")
    dig, pk = sum(spans["digest"]) * 1e3, sum(spans["pack"]) * 1e3
    print(f"pack cache key on the card: {len(spans['digest'])} digests "
          f"{dig:.2f} ms in all against {len(spans['pack'])} packs "
          f"(pack_csc_reordered) {pk:.2f} ms, first compile (each timed "
          f"alone, synchronised)")
    prompts = np.random.RandomState(0).randint(0, cfg.vocab, size=(B, S))
    with torch.no_grad():
        t1 = E.generate(first, cfg, prompts, N_NEW, device=DEV)
        K.reset_launches()
        t2 = E.generate(second, cfg, prompts, N_NEW, device=DEV)
        sync()
    launches = K.LAUNCHES["bsr_matmul"]
    want = cfg.n_layers * len(PROJECTIONS) * (1 + N_NEW)
    print(f"greedy tokens of the two compiles equal: {torch.equal(t1, t2)}; "
          f"the second's generate counted: {launches} bsr_matmul launches "
          f"(expected {want})")
    if not torch.equal(t1, t2) or launches != want:
        raise AssertionError("the cached compile serves other tokens or "
                             "another launch count")
    del first
    # a fault injected on a cached layout corrupts a copy only
    g0 = pm["layers"]["attn"]["wq"]["w"][0]
    m0 = masks["layers"]["attn"]["wq"]["w"][0]
    hit = ops.pack(g0, m0, BLOCK, reorder=True, n_bins=N_BINS)
    bad, rec = F_.bitflip_packed_leaf({"l": {"packed": hit}}, seed=0)
    try:
        V.validate_layout(bad["l"]["packed"])
        caught = False
    except V.LayoutError:
        caught = True
    again = ops.pack(g0, m0, BLOCK, reorder=True, n_bins=N_BINS)
    clean = again is hit and V.validate_layout(again) is again
    print(f"fault injected on a cached layout ({rec.kind}: {rec.detail}): "
          f"caught by validate {caught}; the next hit is the cached "
          f"object and validates: {clean}")
    if not (caught and clean):
        raise AssertionError("a fault injected on a cached layout reached "
                             "the cache")
    ev0 = ops.pack_cache_stats()["evictions"]
    after = ops.configure_pack_cache(max_entries=defaults["max_entries"],
                                     max_bytes=defaults["max_bytes"])
    print(f"default bounds restored ({after['max_entries']} entries, "
          f"{after['max_bytes']} bytes): {after['evictions'] - ev0} "
          f"evictions, {after['entries']} entries / {after['bytes']} bytes "
          f"held")
    out = {"held_bytes": held, "entries": s1["entries"], **got,
           "same_objects": same, "first_compile_s": first_s,
           "second_compile_s": second_s, "digest_ms": dig, "pack_ms": pk,
           "digests": len(spans["digest"]), "packs": len(spans["pack"]),
           "generate_launches": launches,
           "default_evictions": after["evictions"] - ev0,
           "fault_caught": caught}
    return out, second, launches, prompts


def sampling_oracle(mods, exec_p, cfg, prompts):
    """``generate`` and ``generate_python`` at SURFACE_TEMPERATURE on two
    generators seeded 0: the same tokens, draw for draw."""
    E = mods["E"]
    g1 = torch.Generator(device=DEV)
    g1.manual_seed(0)
    g2 = torch.Generator(device=DEV)
    g2.manual_seed(0)
    with torch.no_grad():
        a = E.generate(exec_p, cfg, prompts, N_NEW, device=DEV,
                       temperature=SURFACE_TEMPERATURE, generator=g1)
        b = E.generate_python(exec_p, cfg, prompts, N_NEW, device=DEV,
                              temperature=SURFACE_TEMPERATURE, generator=g2)
    same = torch.equal(a, b) and torch.equal(g1.get_state(), g2.get_state())
    greedy = E.generate(exec_p, cfg, prompts, N_NEW, device=DEV)
    print(f"sampling oracle: generate and generate_python at temperature "
          f"{SURFACE_TEMPERATURE}, B {B}, {N_NEW} new tokens, generators "
          f"seeded 0: identical tokens and generator states {same} "
          f"(tokens differing from greedy: "
          f"{int((a != greedy).sum())} of {a.numel()})")
    if not same:
        raise AssertionError("generate_python's samples differ from "
                             "generate's")
    return {"identical": same, "tokens": a.tolist()}


def surface_phase(mods, pm, masks, cfg, flush):
    """The reference's remaining surface on the card: ``core.bcs``'s
    format, kernels 1's and 2's raw entries, the pack cache over two
    compiles, the sampling oracle."""
    gen = torch.Generator(device=DEV)
    gen.manual_seed(0)
    k1 = raw_kernel1(mods, pm, masks, gen, flush)
    k2 = raw_kernel2(mods, gen, flush)
    cache, exec_p, launches, prompts = cache_compiles(mods, pm, masks, cfg)
    oracle = sampling_oracle(mods, exec_p, cfg, prompts)
    del exec_p
    return {"kernel1_raw": k1, "kernel2_raw": k2, "pack_cache": cache,
            "sampling_oracle": oracle}, launches


def surface_entries(out):
    """The JSON entries of the two raw entries."""
    k1, k2 = out["kernel1_raw"], out["kernel2_raw"]
    dec, pre = k1["decode"], k1["prefill"]
    return [
        {"name": "bsr_matmul_raw", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/bsr_matmul.cu",
         "replaces": "src/repro/kernels/bsr_matmul.py:143",
         "launches": k1["launches"],
         "max_abs_err": max(k1["max_abs_err"], k1["max_abs_err_int8"]),
         "ms": dec["ms"], "plain_ms": dec["plain_ms"],
         "bound_ms": dec["bound_ms"], "bound_by": dec["bound_by"],
         "library_ms": dec["library_ms"],
         "reordered_ms": dec["reordered_ms"],
         "prefill": {k: pre[k] for k in ("ms", "reordered_ms", "plain_ms",
                                         "bound_ms", "bound_by",
                                         "library_ms")},
         "measured_at": f"kernel 1's raw entry over pad_to_uniform_csc "
                        f"(one bin padded to L_max), sum over one yi-9b "
                        f"layer's 7 projections at decode M="
                        f"{SURFACE_M[0]} (prefill: M={SURFACE_M[1]}), "
                        f"bf16, {BLOCK} blocks, rate {PRUNE_RATE}; "
                        f"reordered = the {N_BINS}-bin layout of the same "
                        f"weights; launches: the layer at decode, counted"},
        {"name": "tap_gather_conv_raw", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/tap_gather.cu",
         "replaces": "src/repro/kernels/bsr_matmul.py:314",
         "launches": k2["launches"], "max_abs_err": k2["max_abs_err"],
         "ms": k2["ms"], "plain_ms": k2["plain_ms"],
         "bound_ms": k2["bound_ms"], "bound_by": k2["bound_by"],
         "library_ms": k2["library_ms"], "packed_ms": k2["packed_ms"],
         "measured_at": f"kernel 2's raw entry at VGG_TINY c5 (pattern, "
                        f"one bin), B={CONV_B} {CONV_HW}x{CONV_HW}, fp32, "
                        f"bias + relu; library = F.conv2d + relu on the "
                        f"masked dense weight, TF32 off"}]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=8,
                    help="depth cut of yi-9b (width is never cut)")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is "
              "False); this script runs only on the card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.core import bcs as BCS
        from repro_torch.core import mapper_rule as MR
        from repro_torch.core import reweighted as RW
        from repro_torch.kernels import _build, ops, ref
        from repro_torch.kernels import bsr_matmul as K
        from repro_torch.models import convnet as CN
        from repro_torch.models import layers as L
        from repro_torch.models import moe as MOE
        from repro_torch.models import ssm as SSM
        from repro_torch.models import transformer as T
        from repro_torch.serve import compile as C
        from repro_torch.serve import engine as E
        from repro_torch.serve import kvcache as KV
        from repro_torch.core import validate as V
        from repro_torch.serve import artifacts as ART
        from repro_torch.testing import faults as F
        from repro_torch.core import quant as QUANT
        from repro_torch.models import module as MODULE
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 2
    mods = dict(RW=RW, ops=ops, ref=ref, K=K, T=T, C=C, E=E, CN=CN,
                BCS=BCS, MOE=MOE, L=L, SSM=SSM, MR=MR, KV=KV, V=V, ART=ART,
                F=F, QUANT=QUANT, M=MODULE)
    # the oracles (masked-dense matmul and F.conv2d) run in full fp32: a
    # float32 conv goes through cuDNN in TF32 unless told otherwise
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = smi_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    _build.build_all(KERNEL_FILES)
    for lib in KERNEL_FILES:
        _build.load(lib)
    print(f"built {', '.join(KERNEL_FILES.values())} for sm_90a in "
          f"{time.perf_counter() - t0:.2f}s (nvcc "
          + ", ".join(f"{_build.BUILD_INFO[n]['seconds']:.2f}s"
                      for n in KERNEL_FILES) + ", in parallel)")
    for lib in KERNEL_FILES:
        for line in _build.BUILD_INFO[lib]["log"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {lib}:", line.strip())

    RUN["t0"] = time.perf_counter()
    stamp("kernel 1 (yi-9b, float and int8)")
    flush = torch.empty(64 << 20, dtype=torch.float32, device=DEV)
    rows, max_err = kernel_phase(mods, flush)
    rows8, err8, faults8, vbytes = int8_kernel_phase(mods, flush)
    torch.cuda.empty_cache()
    stamp("yi-9b served")
    e2e, launches, launches8, served = serve_phase(mods, args)
    torch.cuda.empty_cache()
    stamp("robustness")
    robust, robust_launches = robustness_phase(mods, *served)
    torch.cuda.empty_cache()
    stamp("tensor_parallel")
    tp_out, tp_launches = tensor_parallel_phase(
        mods, *served, serve_tokens=e2e["tokens"],
        unsharded_step_ms=e2e["engine"]["saturated"]["step_ms"])
    torch.cuda.empty_cache()
    stamp("mesh")
    mesh_out, mesh_launches = mesh_phase(mods, *served[:3],
                                         serve_tokens=e2e["tokens"])
    for k, v in mesh_launches.items():
        tp_launches[k].update(v)
    torch.cuda.empty_cache()
    stamp("surface: BCS, the raw entries, the pack cache, the sampling "
          "oracle")
    surface_out, surface_launches = surface_phase(mods, *served[:3], flush)
    del served
    torch.cuda.empty_cache()
    # the paper's pipeline: train, prune and fine-tune yi-9b, then serve it
    stamp("yi-9b trained, pruned and served")
    train_out, train_launches = train_phase(mods, args)
    torch.cuda.empty_cache()
    stamp("kernels 2-4 (VGG_TINY, MOBILE_TINY)")
    conv_rows, conv_err = conv_kernel_phase(mods, flush)
    conv_rows8, conv_err8, conv_faults8 = int8_conv_kernel_phase(mods,
                                                                 flush)
    floor_rows = floor_phase(mods, flush)
    del flush
    torch.cuda.empty_cache()
    stamp("VGG_TINY served")
    conv_e2e, conv_launches, conv_launches8 = conv_serve_phase(mods)
    torch.cuda.empty_cache()
    # the paper's scheme mapping: the rule mapper's own picks, served
    stamp("mapped: yi-9b served under map_rules' picks")
    map_e2e, map_launches, map_rules = mapped_lm_serve(mods, args)
    torch.cuda.empty_cache()
    stamp("mapped: kernel 1 at the mapped blocks")
    flush = torch.empty(64 << 20, dtype=torch.float32, device=DEV)
    map_rows, map_checks, map_err = mapped_kernel1_phase(mods, flush,
                                                         map_rules)
    stamp("mapped: VGG_TINY served under map_rules' picks")
    map_vgg, map_conv_launches, map_conv_err = vgg_mapped_serve(mods, flush)
    del flush
    map_model = latency_model_check(mods, args, map_rows, map_rules,
                                    map_vgg)
    # the MoE path, after the yi-9b and VGG state is gone
    torch.cuda.empty_cache()
    stamp("kernel 1 over mixtral's experts")
    flush = torch.empty(64 << 20, dtype=torch.float32, device=DEV)
    moe_rows, moe_err = moe_kernel_phase(mods, flush)
    moe_rows8, moe_err8 = int8_moe_kernel_phase(mods, flush)
    del flush
    torch.cuda.empty_cache()
    stamp("mixtral-8x7b served")
    moe_e2e, moe_launches, moe_launches8 = moe_serve_phase(mods)
    # the SSM and hybrid families, after the MoE state is gone
    torch.cuda.empty_cache()
    stamp("kernel 1 at mamba2 and hymba shapes")
    flush = torch.empty(64 << 20, dtype=torch.float32, device=DEV)
    ssm_rows, ssm_checks = ssm_kernel_phase(mods, flush)
    del flush
    torch.cuda.empty_cache()
    ssm_e2e, ssm_launches = {}, {}
    for arch in SSM_ARCHS:
        stamp(f"{arch} served")
        ssm_e2e[arch], ssm_launches[arch] = ssm_serve_phase(mods, arch)
    # the encdec and vlm families, after the SSM state is gone
    torch.cuda.empty_cache()
    stamp("kernel 1 at seamless-m4t and llama-vision shapes")
    flush = torch.empty(64 << 20, dtype=torch.float32, device=DEV)
    xfam_out, xfam_counts = xfam_phase(mods, flush)
    del flush
    torch.cuda.empty_cache()
    stamp("dry run and roofline")
    dryrun_out = dryrun_phase()
    stamp("done")

    decode, prefill = layer_sum(rows, 4), layer_sum(rows, 128)
    moe_m = prefill_capacity(moe_config())
    engines = {"yi-9b": e2e["engine"], "mixtral-8x7b": moe_e2e["engine"],
               "hymba-1.5b": ssm_e2e["hymba-1.5b"]["engine"]}
    engine_launches = {f"{a} engine": v["saturated"]["launches"]["bsr_matmul"]
                       for a, v in engines.items()}
    entry = {
        "name": "bsr_matmul", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/bsr_matmul.cu",
        "replaces": "src/repro/kernels/bsr_matmul.py:143",
        # the yi-9b, mixtral, mamba2 and hymba generates and the three
        # engine runs, each counted alone (the CNN path runs kernel 3)
        "launches": (launches["bsr_matmul"] + moe_launches["bsr_matmul"]
                     + train_launches["bsr_matmul"]
                     + sum(n["bsr_matmul"] for n in ssm_launches.values())
                     + map_launches["bsr_matmul"]
                     + sum(engine_launches.values())
                     + robust_launches["yi-9b degraded engine"]
                     + robust_launches["yi-9b warm-start generate"]
                     + surface_launches
                     + sum(n["bsr_matmul"] for n in xfam_counts.values())),
        "launches_by_path": {
            "yi-9b generate": launches["bsr_matmul"],
            "yi-9b mapped generate": map_launches["bsr_matmul"],
            "yi-9b trained generate": train_launches["bsr_matmul"],
            "mixtral-8x7b generate": moe_launches["bsr_matmul"],
            **{f"{a} generate": n["bsr_matmul"]
               for a, n in ssm_launches.items()},
            **engine_launches,
            "yi-9b degraded engine": robust_launches[
                "yi-9b degraded engine"],
            "yi-9b warm-start generate": robust_launches[
                "yi-9b warm-start generate"],
            "yi-9b generate after a cached compile": surface_launches,
            **{f"{a} generate": n["bsr_matmul"]
               for a, n in xfam_counts.items()}},
        "max_abs_err": max(max_err, moe_err, ssm_checks[1], map_err,
                           train_out["max_abs_err"], xfam_out["checks"][1]),
        # one decode step's 7 projections of one layer (M = 4), summed
        "ms": decode["ms"], "plain_ms": decode["plain_ms"],
        "bound_ms": decode["bound_ms"], "bound_by": decode["bound_by"],
        "library_ms": decode["library_ms"],
        "prefill": prefill,
        "measured_at": "sum over one yi-9b layer's 7 projections at decode "
                       "M=4 (prefill: M=128), bf16, (16,16) blocks, rate "
                       "0.6, 4 bins",
    }
    entry["shapes"] = [
        {"layer": f"yi-9b/{r['proj']}", "M": r["M"], "K": r["K"],
         "N": r["N"], "ms": r["ms"], "bound_ms": r["bound_ms"],
         "bound_by": r["bound_by"], "plain_ms": r["plain_ms"],
         "library_ms": r["library_ms"]} for r in rows]
    entry["experts"] = {
        "launches": moe_launches["bsr_matmul"], "max_abs_err": moe_err,
        "decode": layer_sum(moe_rows, 4),
        "prefill": layer_sum(moe_rows, moe_m),
        "measured_at": f"sum over one mixtral-8x7b MoE layer's 3 expert "
                       f"projections, 8 experts in one launch each, at "
                       f"decode M=4 (prefill: M={moe_m} rows an expert), "
                       f"bf16, (16,16) blocks, rate 0.6, 4 bins; library "
                       f"= torch.bmm of the masked dense (E, K, N) stack",
        "shapes": [
            {"layer": f"mixtral-8x7b/{r['proj']}", "E": r["E"], "M": r["M"],
             "K": r["K"], "N": r["N"], "ms": r["ms"],
             "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
             "plain_ms": r["plain_ms"], "library_ms": r["library_ms"],
             "stream_ms": r["stream_ms"]} for r in moe_rows]}
    entry["ssm"] = ssm_entry(ssm_rows, ssm_launches, ssm_checks)
    d8 = layer_sum(rows8, 4)
    entry["int8"] = int8_entry(
        launches8["bsr_matmul"] + moe_launches8["bsr_matmul"],
        max(err8, moe_err8, ssm_checks[3]), d8["ms"], d8["plain_ms"],
        d8["bound_ms"], d8["bound_by"], d8["library_ms"],
        launches_by_path={
            "yi-9b generate": launches8["bsr_matmul"],
            "mixtral-8x7b generate": moe_launches8["bsr_matmul"]},
        prefill=layer_sum(rows8, 128),
        experts={"decode": layer_sum(moe_rows8, 4),
                 "prefill": layer_sum(moe_rows8, moe_m)},
        stream_ms={"decode": d8["stream_ms"],
                   "prefill": layer_sum(rows8, 128)["stream_ms"]},
        layer_value_bytes={"bf16": vbytes[0], "int8_and_scales": vbytes[1]},
        planted_faults=faults8,
        measured_at="as above with int8 values and a scale per block; "
                    "bound from the int8 bytes; library = torch.matmul / "
                    "torch.bmm on the bf16 masked dense weight")
    entry["mapped"] = mapped_entry(map_rows, map_launches, map_checks,
                                   map_err, map_e2e)
    entry["trained"] = trained_entry(train_out, train_launches)
    entry["encdec_vlm"] = xfam_entry(xfam_out, xfam_counts)
    at_m = layer_sum(rows, ENGINE_SLOTS)
    entry["engine"] = {
        "M": ENGINE_SLOTS,
        "launches_per_step": {a: v["per_step_launches"]
                              for a, v in engines.items()},
        "launches": engine_launches,
        "ms": at_m["ms"], "plain_ms": at_m["plain_ms"],
        "bound_ms": at_m["bound_ms"], "bound_by": at_m["bound_by"],
        "library_ms": at_m["library_ms"], "stream_ms": at_m["stream_ms"],
        "step_ms": {a: v["saturated"]["step_ms"] for a, v in engines.items()},
        "measured_at": f"ms/bound/plain/library: sum over one yi-9b layer's "
                       f"7 projections at M={ENGINE_SLOTS} (the engine's "
                       f"step over {ENGINE_SLOTS} slots), bf16, (16,16) "
                       f"blocks, rate 0.6, 4 bins; step_ms: the median "
                       f"decode-only ServingEngine step (a CUDA-graph "
                       f"replay) of each saturated run; launches: each "
                       f"saturated run's warm-up step, admissions and "
                       f"replayed steps, counted"}
    entries = [entry] + conv_entries(conv_rows, conv_err, conv_launches,
                                     conv_rows8, conv_err8, conv_launches8)
    for e in entries[1:]:
        n = map_conv_launches.get(e["name"], 0)
        e["launches"] += n
        e["mapped"] = {
            "launches": n, "max_abs_err": map_conv_err[e["name"]],
            "shapes": [dict(conv_shape_row(r, "implicit"), block=r["block"],
                            values=r["mapped_values"],
                            mapping=tag) for tag, v in map_vgg.items()
                       for r in v["rows"]
                       if r["kernel_implicit"] == e["name"]
                       or r["kernel_materialized"] == e["name"]],
            "measured_at": "VGG_TINY under map_rules' picks on V5E "
                           "(dataset_hard True and False), B=256 32x32, "
                           "fp32, bias + relu; launches of one forward of "
                           "each mapping"}
    next(e for e in entries if e["name"] == "tap_gather_conv_implicit")[
        "int8"]["planted_faults"] = conv_faults8
    for e in entries[1:]:
        n = robust_launches["vgg"].get(e["name"], 0)
        if n:
            e["launches"] += n
            e["launches_by_path"] = {
                "VGG_TINY forwards (served, mapped)": e["launches"] - n,
                "VGG_TINY punched forward, one layer retired": n}
    entries += tp_entries(tp_out, tp_launches)
    entries += surface_entries(surface_out)
    out_dir = ROOT / "build"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "torch": torch.__version__,
         "cuda": torch.version.cuda,
         "build": {n: _build.BUILD_INFO[n]["seconds"] for n in KERNEL_FILES},
         "ptxas": {n: _build.BUILD_INFO[n]["log"] for n in KERNEL_FILES},
         "kernels": entries, "yi9b_shapes": rows, "moe_shapes": moe_rows,
         "int8_yi9b_shapes": rows8, "int8_moe_shapes": moe_rows8,
         "int8_conv_shapes": conv_rows8, "moe_serve": moe_e2e,
         "conv_shapes": conv_rows, "floor_shapes": floor_rows,
         "serve": e2e, "conv_serve": conv_e2e, "ssm_shapes": ssm_rows,
         "ssm_serve": ssm_e2e, "mapped_serve": map_e2e,
         "mapped_shapes": map_rows, "mapped_vgg": map_vgg,
         "latency_model": map_model, "train": train_out,
         "robustness": robust, "tensor_parallel": tp_out,
         "mesh": mesh_out, "surface": surface_out,
         "encdec_vlm": xfam_out, "dryrun": dryrun_out,
         "phase_start_s": RUN["phase_s"]},
        indent=1, default=str))
    print(f"card: {card}")
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
