"""Serving: ``prefill`` (a forward pass that also emits the per-layer KV
caches, SSM states and cross caches), ``generate`` (prefill, then the
greedy or sampling decode loop), ``generate_python`` (its per-token
oracle, greedy or sampling), and the continuous-batching
``ServingEngine`` (the decoder-only families), which decodes every live
request through ONE batched step a token, so each packed kernel launch
reads the weights once for the whole batch.  Works with dense, masked,
and ``compile_model``-packed params alike.

Each entry point takes ``dist`` (``distributed.sharding.Dist``): it places
its inputs by the batch spec (sharded over the data axes when the batch
divides, else replicated), runs the model on the mesh, and returns plain
whole tensors, as a JAX global array reads.  Params are placed by the
caller (``sharding.shard_packed_tree`` for the packed layouts)."""
from __future__ import annotations

import bisect
import contextlib
import functools
import time

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import sharding as SH
from repro_torch.kernels import bsr_matmul as K
from repro_torch.models import layers as L
from repro_torch.models.module import resolve_device
from repro_torch.models import transformer as T
from repro_torch.serve import compile as SC
from repro_torch.serve import kvcache as KV
from repro_torch.serve import trace as TR
from repro_torch.serve.scheduler import (REASON_DEADLINE_EXPIRED,
                                         REASON_OVER_BUDGET,
                                         REASON_QUARANTINED, Request,
                                         Scheduler)


def _window_kv(k, v, S_len, cfg):
    """The prefill ring: the last ``KV.slot_capacity`` positions, in
    order, the rule the engine's slots share."""
    cap = KV.slot_capacity(cfg, S_len)
    pos = torch.arange(S_len - cap, S_len, dtype=torch.int32,
                       device=k.device)
    return k[:, S_len - cap:], v[:, S_len - cap:], pos


def _whole(tree, dist):
    """Every placed tensor of ``tree`` gathered whole (nothing without a
    mesh)."""
    if dist is None:
        return tree
    if isinstance(tree, dict):
        return {k: _whole(v, dist) for k, v in tree.items()}
    return dist.gather(tree)


def _stack(layers):
    """The layers' cache pieces stacked on a new layer dim, each placed
    one gathered whole first (the same gather per layer at any depth)."""
    return torch.stack([SH.full(t) for t in layers])


def prefill(params, cfg: ArchConfig, tokens, frontend=None, dist=None):
    """tokens (B, S) -> (last-token logits (B, 1, V), cache).  The KV
    cache (dense, moe, hybrid) is exactly as long as the prompt, cut to
    the attention window (a ring stacked on the layer dim like
    ``models.transformer.init_cache``); the ssm and hybrid families add
    each layer's mixer state, stacked the same way.

    encdec runs its encoder once over ``frontend`` (B, T, D); its cache is
    the decoder's self "kv" (unwindowed, positions 0..S-1) and each
    layer's cross keys and values of the memory, "xk"/"xv" (n_layers, B,
    T, KV, hd).  vlm's is "kv_self" over its G * (k - 1) self layers in
    order and "xk"/"xv" (G, B, T, KV, hd) of the image patches.

    The hybrid state is the one the layer's own mixer run computed on the
    layer's normed input.  The reference (``repro.serve.engine.prefill``)
    runs the mixer a second time on the layer's OUTPUT ("recompute state
    cheaply"), so its decode continues from a state no ``forward`` ever
    had; the port does not copy that, and saves the second run.

    Under ``dist`` the logits and every cache leaf come back whole."""
    if dist is None:
        return _prefill(params, cfg, tokens, frontend, None)
    with dist.region():
        logits, cache = _prefill(params, cfg, dist.place_batch(tokens),
                                 dist.place_batch(frontend), dist)
        return dist.gather(logits), _whole(cache, dist)


def _prefill(params, cfg, tokens, frontend, dist, layers=None, row=None):
    """``prefill``'s body.  ``layers`` (the decoder's layer slices, made
    fresh when None) and ``row`` ((1,) int, the last real token of a
    right-padded prompt) are ``padded_prefill``'s: with ``row`` the
    decoder keeps the k/v of every position and the logits are that
    row's."""
    _, Sq = tokens.shape
    positions = torch.arange(Sq, dtype=torch.int32, device=tokens.device)
    x = L.embed(params["embed"], tokens)
    if dist is not None:
        x = dist.shard_activations(x)
    fam = cfg.family
    kvs, xkvs, states = [], [], []
    if fam in T.DECODER_FAMILIES:
        for lp in T.layer_params(params) if layers is None else layers:
            x, kv, st, _ = T._layer_fwd(lp, x, positions, cfg, dist=dist)
            if kv is not None:
                kvs.append((*kv, positions) if row is not None
                           else _window_kv(*kv, Sq, cfg))
            if st is not None:
                states.append(st)
    elif fam == "encdec":
        memory = T.encode(params, cfg, frontend, x.dtype, dist=dist)
        for lp in T.layer_params(params, "dec"):
            x, (k, v, xk, xv), _, _ = T._layer_fwd(lp, x, positions, cfg,
                                                   "xdec", memory, dist)
            kvs.append((k, v, positions))
            xkvs.append((xk, xv))
    elif fam == "vlm":
        memory = frontend.to(x.dtype)
        for g in T.layer_params(params, "groups"):
            for lp in T.layer_params(g, "selfs"):
                x, (k, v), _, _ = T._layer_fwd(lp, x, positions, cfg,
                                               "dense", dist=dist)
                kvs.append((k, v, positions))
            x, xkv, _, _ = T._layer_fwd(g["cross"], x, positions, cfg,
                                        "cross", memory, dist)
            xkvs.append(xkv)
    else:
        raise ValueError(fam)
    cache = {}
    if kvs:
        k, v, pos = zip(*kvs)
        cache["kv_self" if fam == "vlm" else "kv"] = {
            "k": _stack(k), "v": _stack(v), "pos": _stack(pos)}
    if xkvs:
        xk, xv = zip(*xkvs)
        cache["xk"], cache["xv"] = _stack(xk), _stack(xv)
    if states:
        cache["ssm"] = {name: _stack([st[name] for st in states])
                        for name in states[0]}
    x = x[:, -1:, :] if row is None else x.index_select(1, row)
    logits = L.unembed(params["head"], L.rmsnorm(params["norm_f"], x))
    if dist is not None:
        logits = dist.shard_logits(logits)
    return logits, cache


def prefill_buckets(seq_cap):
    """The prompt-length buckets of the engine's captured admission
    prefill: the powers of two from 16 below ``seq_cap``, then
    ``seq_cap``.  A prompt of S tokens replays the smallest bucket >= S."""
    out, b = [], 16
    while b < seq_cap:
        out.append(b)
        b *= 2
    return tuple(out) + (seq_cap,)


def replays_prefill(cfg: ArchConfig, device, dist=None) -> bool:
    """Whether an engine admits through captured prefill graphs: on the
    card, for the dense family, off a mesh.  Everywhere else the eager
    ``prefill`` runs: moe's capacity rule would count the padding and
    could drop real tokens, the ssm and hybrid scans would run past the
    prompt and keep the wrong state, and the CPU has no graphs."""
    return device.type == "cuda" and cfg.family == "dense" and dist is None


def padded_prefill(params, cfg: ArchConfig, tokens, row, layers=None):
    """The dense family's B = 1 prefill of a right-padded prompt, the
    function the engine captures once per bucket: tokens (1, Sb) at
    positions 0..Sb-1, ``row`` (1,) int the index of the prompt's last
    token -> (that row's logits (1, 1, V), the cache of every position).
    The causal mask keeps the padding away from every real query and
    every other op works row by row, so the real positions and the row's
    logits are what ``prefill`` of the prompt alone gives (``padded_cache``
    cuts its ring).  Nothing here synchronises with the host or copies
    host data."""
    return _prefill(params, cfg, tokens, None, None, layers, row)


def padded_cache(cache, S_len, cfg: ArchConfig):
    """The cache ``prefill`` gives a prompt of ``S_len`` tokens, cut from
    ``padded_prefill``'s: the ring [S_len - cap, S_len) with ``cap`` from
    ``KV.slot_capacity``, so a sliding window still cuts the real prompt,
    never the padding."""
    ring = slice(S_len - KV.slot_capacity(cfg, S_len), S_len)
    kv = cache["kv"]
    return {"kv": {"k": kv["k"][:, :, ring], "v": kv["v"][:, :, ring],
                   "pos": kv["pos"][:, ring]}}


def _inputs(tokens, frontend, device):
    dev = resolve_device(device)
    tokens = torch.as_tensor(tokens, device=dev)
    if frontend is not None:
        frontend = torch.as_tensor(frontend, device=dev)
    return dev, tokens, frontend


def generate(params, cfg: ArchConfig, tokens, n_new, device="cuda",
             frontend=None, temperature=0.0, generator=None, dist=None):
    """Prefill, then ``n_new`` decode steps.  Returns (B, n_new) int32
    tokens; the first is the prefill's argmax at any temperature.  At
    temperature 0 every later token is the argmax (greedy); above it,
    step i draws from softmax(logits / temperature) by ``generator`` (a
    ``torch.Generator`` on the device; None seeds one with 0, as the
    reference's default key is ``PRNGKey(0)``: the draws are torch's, not
    JAX's).  ``frontend`` (B, T, D) is encdec's and vlm's embedding
    stand-in.  Decoding past the prompt overwrites the ring slot of the
    oldest position, as the reference does.  Under ``dist`` the prompt is
    placed by the batch spec and the model runs on the mesh."""
    dev, tokens, frontend = _inputs(tokens, frontend, device)
    B, Sq = tokens.shape
    if temperature > 0 and generator is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(0)
    logits, cache = prefill(params, cfg, tokens, frontend, dist)
    tok = torch.argmax(logits[:, -1, :], dim=-1)[:, None].to(torch.int32)
    start = torch.full((B, 1), Sq, dtype=torch.int32, device=dev)
    toks, _ = T.decode_loop(params, cfg, tok, cache, start, n_new,
                            temperature, generator, dist)
    return toks


def generate_python(params, cfg: ArchConfig, tokens, n_new, device="cuda",
                    frontend=None, dist=None, temperature=0.0,
                    generator=None):
    """Generation one token at a time, each step's token read back to the
    host: the per-token oracle of ``generate`` and the engine.  The first
    token is the prefill's argmax; at temperature 0 every later one is
    the argmax, above it step i draws exactly as ``generate`` draws it
    (``transformer.sample`` by ``generator``, None seeding one with 0),
    so on equally seeded generators the two give the same tokens, draw
    for draw.  (The reference's ``key=`` has no counterpart: torch cannot
    draw JAX's PRNG.)"""
    dev, tokens, frontend = _inputs(tokens, frontend, device)
    B, Sq = tokens.shape
    if temperature > 0 and generator is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(0)
    logits, cache = prefill(params, cfg, tokens, frontend, dist)
    layers = T.decode_layers(params, cfg)
    tok = np.argmax(logits[:, -1, :].float().cpu().numpy(), axis=-1)
    out = []
    for i in range(n_new):
        out.append(tok.astype(np.int32))
        pos = torch.full((B, 1), Sq + i, dtype=torch.int32, device=dev)
        logits, cache = T.decode_step(
            params, cfg, torch.as_tensor(tok[:, None], device=dev), cache,
            pos, layers, dist)
        if dist is not None:
            logits = dist.gather(logits)
        if temperature > 0:
            tok = T.sample(logits[:, -1, :], temperature,
                           generator)[:, 0].cpu().numpy()
        else:
            tok = np.argmax(logits[:, -1, :].float().cpu().numpy(), axis=-1)
    return torch.as_tensor(np.stack(out, axis=1), device=dev)


class ServingEngine:
    """Continuous-batching engine: scheduler + slot cache + one batched
    decode step a token.

    Requests are admitted into free slots mid-flight (a B = 1 ``prefill``
    plus a slot-row write), every step runs ALL slots through one
    ``decode_step_ragged`` (each packed projection one kernel launch at
    M = ``n_slots``), and a finished request is evicted the step its stop
    condition fires.  Greedy: each request's tokens are those of a B = 1
    ``generate`` of it.

    The step is ``decode_step_ragged``, the argmax and a per-slot finite
    probe (``isfinite(logits).all(-1)``), written to static buffers.  On
    the card it is captured ONCE per engine as a CUDA graph, at
    construction while every slot is free (pos = 0, cap = 1 padding),
    after one uncaptured warm-up step that builds kernel 1's tables and
    grows its tile counters; each ``step()`` copies the slots' tokens,
    positions and capacities into the graph's input buffer, replays it,
    and reads the next tokens and the probe back in one copy.  On the CPU
    the step runs eagerly.  ``stats["graph_captures"]`` counts captures.

    Faults: ``validate=True`` (the default, as the reference's) runs
    ``serve.compile.degrade_invalid_layers`` at construction, before the
    step is captured: a packed layout failing ``core.validate`` is retired
    to masked-dense (its stack's dense matmul on the retained ``w`` is
    what the graph records), counted in ``stats["degraded_layers"]``, and
    its ``report`` row (when given) marked; a corrupt layout without ``w``
    raises.  No kernel is ever launched on a layout that failed.  Every
    step sweeps queue TTLs, due retries and running deadlines BEFORE
    admission, and a slot whose logits came back non-finite is
    quarantined (evicted without emitting its token); the other slots are
    untouched (slots share weights, never activations).

    ``dist`` runs the engine on a mesh: the caller places the params
    (``sharding.shard_packed_tree``), validation checks each placed layout
    gathered whole, admissions run ``prefill(dist=)``, and the step places
    the slots' operands by the batch spec and gathers the logits whole;
    the cache stays whole on every rank.  The step is captured as on one
    card: a capture records the kernels, so a replay runs none of
    DTensor's host work.

    Admission on the card, dense family, no mesh (``replays_prefill``):
    the B = 1 prefill is captured too, once per prompt-length bucket
    (``prefill_buckets(seq_cap)``, those the prefill's KV chunking can
    run), after the step and one eager warm-up at the largest bucket,
    largest first, into one memory pool the bucket graphs share (a
    replay's outputs are read before the next replay).  Each graph runs
    ``padded_prefill`` over the engine's own layer slices and a static
    (Sb + 1,) int32 input: the prompt right-padded with token 0, then the
    index of its last token.  An admission copies that input in, replays
    the graph, reads the first token (the graph's argmax of that row)
    and writes ``padded_cache``'s ring into the slot.  A prompt longer
    than the largest bucket, and every other engine, runs the eager
    ``prefill``.  ``stats``: ``prefill_captures``, ``prefill_replays``,
    ``prefill_pad_tokens`` (the padding the replays ran).

    The moe family's eager admission, off a mesh and while the recorder
    is on, counts its prefill's expert dispatch (``serve.trace.tally``):
    the routed (token, expert) pairs and those the capacity rule dropped,
    read in the copy that reads the first token, summed in ``stats``
    ``moe_pairs`` and ``moe_dropped`` and put on its ``engine.admit``
    span.  The decode step routes its tokens one by one, which never
    drops, and counts nothing.

    Spans (``serve.trace``): ``engine.init`` (``engine.capture`` and one
    ``engine.capture_prefill`` a bucket, its ``bucket``, inside, each with
    the card's ``memory_allocated`` at its close); per step
    ``engine.step`` (``active`` slots, ``admitted`` requests,
    ``harvest_ms``), inside it one ``engine.admit`` per admission (its
    ``bucket``, None on the eager path; on the moe family's eager path
    ``moe_pairs`` and ``moe_dropped``, and one ``moe.dispatch`` a layer
    inside its prefill; ``admit.prefill``, the host
    enqueuing the eager forward, or copying a bucket's input in and
    launching its graph; ``admit.first_token``, the host waiting for the
    card; ``admit.slot_write``)
    and ``engine.replay`` (``copy_in_ms``, ``launch_ms``, ``read_back_ms``
    on the host; on the card, every ``GRAPH_TIMING_EVERY``-th replay,
    ``graph_ms``: the card's time from before the graph's launch to its
    last kernel, by a pair of CUDA events); and per request ``queue``,
    from ``submit`` to its admission.  A decode step's host pieces are
    attributes, not spans, and its graph is timed one replay in
    ``GRAPH_TIMING_EVERY``, to keep what the recorder costs a step small.
    """

    FAMILIES = T.DECODER_FAMILIES
    GRAPH_TIMING_EVERY = 16

    def __init__(self, params, cfg: ArchConfig, *, n_slots=8, seq_cap=256,
                 max_queue=None, validate=True, report=None,
                 device="cuda", dist=None):
        if cfg.family not in self.FAMILIES:
            raise NotImplementedError(
                f"family {cfg.family!r} is not served (supported: "
                f"{self.FAMILIES})")
        dev = resolve_device(device)
        with TR.span("engine.init") as sp:
            self._init(params, cfg, n_slots, seq_cap, max_queue, validate,
                       report, dev, dist)
            TR.note_memory(sp, self.device)

    def _init(self, params, cfg, n_slots, seq_cap, max_queue, validate,
              report, dev, dist):
        if params["embed"]["table"].device.type != dev.type:
            raise ValueError(f"the params live on "
                             f"{params['embed']['table'].device}, not {dev}")
        self.device = params["embed"]["table"].device
        if cfg.sliding_window:
            # a slot never needs more ring than the attention window
            seq_cap = min(seq_cap, cfg.sliding_window)
        self.report = report
        degraded = []
        if validate:
            params, self.report, degraded = SC.degrade_invalid_layers(
                params, report=report)
        self.params, self.cfg, self.dist = params, cfg, dist
        self.n_slots, self.seq_cap = n_slots, seq_cap
        self.cache = KV.init_slots(params, cfg, n_slots, seq_cap,
                                   dtype=params["embed"]["table"].dtype)
        self.sched = Scheduler(n_slots, max_queue=max_queue)
        # per-slot decode operands (token, position, ring capacity) on the
        # host, and the step's input buffer on the device; free slots idle
        # as pos = 0 / cap = 1 padding
        self._ops = np.zeros((3, n_slots), np.int32)
        self._ops[2] = 1
        self.tok, self.pos, self.cap = self._ops
        self._ops_dev = torch.tensor(self._ops, device=self.device)
        self._layers = T.layer_params(params)
        self._rid = 0
        self.requests: dict = {}
        self.stats = {"steps": 0, "occupancy_sum": 0.0, "tokens": 0,
                      "admitted": 0, "finished": 0, "evicted": 0,
                      "rejected": 0, "quarantined": 0, "expired": 0,
                      "degraded_layers": len(degraded), "graph_captures": 0,
                      "prefill_captures": 0, "prefill_replays": 0,
                      "prefill_pad_tokens": 0, "moe_pairs": 0,
                      "moe_dropped": 0}
        self._graph = self._events = None
        self._replays = 0
        self._queue_spans: dict = {}
        self.logits = self._out = None
        # the admission prefill's buckets (none: every admission eager);
        # past kv_chunk the prefill's attention takes whole chunks only
        self._buckets = ()
        if replays_prefill(cfg, self.device, dist):
            self._buckets = tuple(
                b for b in prefill_buckets(seq_cap)
                if b <= cfg.kv_chunk or b % cfg.kv_chunk == 0)
        self._pf_in, self._pf_out, self._pf_graphs = {}, {}, {}
        self._pf_launches: dict = {}
        if self.device.type == "cuda":
            with TR.span("engine.capture") as sp:
                self._capture()
                TR.note_memory(sp, self.device)
            # one reusable pair around each replay (``graph_ms``)
            self._events = tuple(torch.cuda.Event(enable_timing=True)
                                 for _ in range(2))
            if self._buckets:
                self._capture_prefill()

    # -- the step -------------------------------------------------------------

    def _forward(self):
        """decode_step_ragged + argmax + finite probe over every slot:
        (logits (B, 1, V), (2, B) int32 of next tokens and probe).  Under
        a mesh the slots' operands are placed by the batch spec and the
        logits gathered whole."""
        ops, d = self._ops_dev, self.dist
        tok, pos, cap = ops[0][:, None], ops[1][:, None], ops[2]
        if d is None:
            logits, _ = T.decode_step_ragged(
                self.params, self.cfg, tok, self.cache, pos, cap,
                self._layers)
        else:
            with d.region():
                logits, _ = T.decode_step_ragged(
                    self.params, self.cfg, d.place_batch(tok), self.cache,
                    d.place_batch(pos), d.place_batch(cap), self._layers,
                    d)
                logits = d.gather(logits)
        last = logits[:, -1, :]
        out = torch.stack([torch.argmax(last, dim=-1).to(torch.int32),
                           torch.isfinite(last.float()).all(-1).to(
                               torch.int32)])
        return logits, out

    def _warm_up(self, fn):
        """``fn()`` once, uncaptured, on a side stream: what a capture needs
        first (kernel 1's tables and grown tile counters, cuBLAS)."""
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream(self.device).wait_stream(side)

    @staticmethod
    def _record(fn, pool=None):
        """(a CUDA graph of ``fn``, its outputs, the launches it recorded):
        a capture runs nothing, so its launches are taken back out of
        ``LAUNCHES``, and each replay adds them."""
        graph = torch.cuda.CUDAGraph()
        before = dict(K.LAUNCHES)
        with torch.cuda.graph(graph, pool=pool):
            out = fn()
        launches = {k: n - before[k] for k, n in K.LAUNCHES.items()
                    if n != before[k]}
        K.LAUNCHES.update(before)
        return graph, out, launches

    @torch.no_grad()
    def _capture(self):
        self._warm_up(self._forward)
        self._graph, (self.logits, self._out), self._replay_launches = \
            self._record(self._forward)
        # the graph reads the cache by address: its tensors live as long
        # as the graph, whatever later rebinds ``self.cache``
        self._graph_inputs = [t for group in self.cache.values()
                              for t in group.values()]
        self.stats["graph_captures"] += 1

    def _bucket_forward(self, b):
        """``padded_prefill`` over bucket ``b``'s static input: (the first
        token (a 0-dim int64 argmax), the cache of all b positions)."""
        buf = self._pf_in[b]
        logits, cache = padded_prefill(self.params, self.cfg, buf[None, :b],
                                       buf[b:], self._layers)
        return torch.argmax(logits[0, -1]), cache

    @torch.no_grad()
    def _capture_prefill(self):
        """One graph per bucket, largest first, into one shared pool.  The
        uncaptured warm-up at the largest bucket grows kernel 1's tile
        counters to the most any bucket needs (a capture may not grow
        them) and initialises cuBLAS; the static inputs are allocated
        before it, outside the pool."""
        self._pf_in = {b: torch.zeros(b + 1, dtype=torch.int32,
                                      device=self.device)
                       for b in self._buckets}
        self._warm_up(functools.partial(self._bucket_forward,
                                        self._buckets[-1]))
        pool = torch.cuda.graph_pool_handle()
        for b in reversed(self._buckets):
            with TR.span("engine.capture_prefill", bucket=b) as sp:
                (self._pf_graphs[b], self._pf_out[b],
                 self._pf_launches[b]) = self._record(
                    functools.partial(self._bucket_forward, b), pool)
                self.stats["prefill_captures"] += 1
                TR.note_memory(sp, self.device)

    def _bucket(self, S_len):
        """The bucket a prompt of ``S_len`` tokens replays, or None."""
        i = bisect.bisect_left(self._buckets, S_len)
        return self._buckets[i] if i < len(self._buckets) else None

    @torch.no_grad()
    def _run(self):
        """One decode step over every slot: (next tokens, probe) as host
        arrays, ``logits`` holding the step's logits.

        The copy-in, from pageable host memory, drains the stream, so the
        first event marks the card ready to launch the graph; the
        read-back syncs, so both events have completed when it returns."""
        with TR.span("engine.replay") as sp:
            t0 = time.perf_counter()
            self._ops_dev.copy_(torch.from_numpy(self._ops))
            t1 = time.perf_counter()
            ev = (self._events if sp is not None and self._replays
                  % self.GRAPH_TIMING_EVERY == 0 else None)
            self._replays += 1
            if self._graph is not None:
                if ev:
                    stream = torch.cuda.current_stream(self.device)
                    ev[0].record(stream)
                self._graph.replay()
                if ev:
                    ev[1].record(stream)
                for k, n in self._replay_launches.items():
                    K.LAUNCHES[k] += n
            else:
                self.logits, self._out = self._forward()
            t2 = time.perf_counter()
            out = self._out.cpu().numpy()
            if sp is not None:
                sp.attrs.update(
                    copy_in_ms=(t1 - t0) * 1e3, launch_ms=(t2 - t1) * 1e3,
                    read_back_ms=(time.perf_counter() - t2) * 1e3,
                    graph_ms=ev[0].elapsed_time(ev[1]) if ev else None)
        return out[0], out[1]

    # -- request intake -------------------------------------------------------

    def submit(self, prompt, max_new_tokens, *, arrival=0,
               stop_token=None, deadline_steps=None, queue_ttl=None,
               retries=0, backoff=1) -> int:
        """Queue one request; returns its id (``requests[rid].tokens`` holds
        the output).  A prompt whose ring (``slot_capacity``) exceeds the
        slot capacity is rejected up front.  ``deadline_steps`` /
        ``queue_ttl`` bound slot occupancy and queue wait, ``retries`` /
        ``backoff`` the resubmission policy against a full ``max_queue``
        (``serve.scheduler.Request``)."""
        req = Request(self._rid, tuple(int(t) for t in prompt),
                      int(max_new_tokens), arrival=arrival,
                      stop_token=stop_token, deadline_steps=deadline_steps,
                      queue_ttl=queue_ttl, retries=retries, backoff=backoff)
        self._rid += 1
        self.requests[req.rid] = req
        if (not req.prompt or req.max_new_tokens < 1
                or KV.slot_capacity(self.cfg, len(req.prompt))
                > self.seq_cap):
            self.sched.reject(req, REASON_OVER_BUDGET)
            self.stats["rejected"] += 1
        elif self.sched.submit(req, self.stats["steps"]) == "rejected":
            self.stats["rejected"] += 1
        else:
            sp = TR.begin("queue", rid=req.rid)
            if sp is not None:
                self._queue_spans[req.rid] = sp
        return req.rid

    def _end_queue(self, rid):
        sp = self._queue_spans.pop(rid, None)
        if sp is not None:
            sp.end()

    # -- engine loop ----------------------------------------------------------

    @torch.no_grad()
    def _admit(self):
        while (pair := self.sched.admit(self.stats["steps"])) is not None:
            slot, req = pair
            self._end_queue(req.rid)
            b = self._bucket(len(req.prompt))
            with TR.span("engine.admit", rid=req.rid,
                         prompt_len=len(req.prompt), bucket=b) as sp:
                self._admit_one(slot, req, b, sp)

    def _admit_one(self, slot, req, b, sp):
        S_len = len(req.prompt)
        if b is None:
            toks = torch.tensor([req.prompt], dtype=torch.int32,
                                device=self.device)
            counts = self.cfg.family == "moe" and self.dist is None
            with (TR.tally(self.device) if counts
                  else contextlib.nullcontext()) as tally:
                with TR.span("admit.prefill"):
                    logits, rc = prefill(self.params, self.cfg, toks,
                                         dist=self.dist)
            with TR.span("admit.first_token"):
                first = torch.argmax(logits[0, -1])
                if tally is None:
                    t0 = int(first)
                else:       # the first token and the count in one copy
                    t0, kept = torch.stack([first, tally.kept]).tolist()
            if tally is not None:
                moe = {"moe_pairs": tally.pairs,
                       "moe_dropped": tally.pairs - kept}
                for k, n in moe.items():
                    self.stats[k] += n
                if sp is not None:
                    sp.attrs.update(moe)
        else:
            with TR.span("admit.prefill"):
                host = np.zeros(b + 1, np.int32)
                host[:S_len] = req.prompt
                host[b] = S_len - 1
                self._pf_in[b].copy_(torch.from_numpy(host))
                self._pf_graphs[b].replay()
                for k, n in self._pf_launches[b].items():
                    K.LAUNCHES[k] += n
            first, cache = self._pf_out[b]
            with TR.span("admit.first_token"):
                t0 = int(first)
            rc = padded_cache(cache, S_len, self.cfg)
            self.stats["prefill_replays"] += 1
            self.stats["prefill_pad_tokens"] += b - S_len
        req.tokens.append(t0)
        self.stats["admitted"] += 1
        self.stats["tokens"] += 1
        if req.done():          # budget of 1 (or an instant stop token)
            self._release(slot, req, "finished")
            return
        with TR.span("admit.slot_write"):
            self.cache = KV.write_prefill(self.cache, slot, rc)
        self.cap[slot] = KV.slot_capacity(self.cfg, len(req.prompt))
        self.pos[slot] = len(req.prompt)
        self.tok[slot] = t0

    def _release(self, slot, req, status, reason=None):
        self.sched.release(req, status, reason)
        self.cache = KV.clear_slot(self.cache, slot)
        self.tok[slot], self.pos[slot], self.cap[slot] = 0, 0, 1
        if status == "finished":
            self.stats["finished"] += 1
        elif status == "quarantined":
            self.stats["quarantined"] += 1
        else:
            self.stats["evicted"] += 1

    def _sweep_faults(self):
        """Top-of-step fault pass, all BEFORE admission so freed slots
        refill the same step: expire overdue queue TTLs, re-submit due
        retry backoffs, evict running requests past ``deadline_steps``."""
        now = self.stats["steps"]
        expired = self.sched.expire(now)
        rejected = self.sched.poll_retries(now)
        for req in expired + rejected:
            self._end_queue(req.rid)
        self.stats["expired"] += len(expired)
        self.stats["rejected"] += len(rejected)
        for slot, req in self.sched.active():
            if (req.deadline_steps is not None
                    and req.admitted_at is not None
                    and now - req.admitted_at >= req.deadline_steps):
                self._release(slot, req, "evicted",
                              reason=REASON_DEADLINE_EXPIRED)
                self.stats["expired"] += 1

    def step(self) -> int:
        """One engine step: sweep deadlines/TTLs/retries, admit from the
        queue into free slots, decode every slot in one step, harvest
        tokens, evict finished requests, and quarantine any slot whose
        logits came back non-finite (its token is never appended).
        Returns the number of active slots stepped (0 = an idle tick while
        an open-loop queue waits for its arrivals)."""
        with TR.span("engine.step") as sp:
            self._sweep_faults()
            admitted = self.stats["admitted"]
            self._admit()
            active = self.sched.active()
            self.stats["steps"] += 1
            self.stats["occupancy_sum"] += len(active) / self.n_slots
            if sp is not None:
                sp.attrs.update(active=len(active),
                                admitted=self.stats["admitted"] - admitted)
            if not active:
                return 0
            nxt, ok = self._run()
            t0 = time.perf_counter()
            for slot, req in active:
                if not ok[slot]:
                    self._release(slot, req, "quarantined",
                                  reason=REASON_QUARANTINED)
                    continue
                t = int(nxt[slot])
                req.tokens.append(t)
                self.stats["tokens"] += 1
                self.pos[slot] += 1
                self.tok[slot] = t
                if req.done():
                    self._release(slot, req, "finished")
            if sp is not None:
                sp.attrs["harvest_ms"] = (time.perf_counter() - t0) * 1e3
        return len(active)

    def run(self, max_steps=100_000):
        """Drive ``step`` until queue and slots drain; returns ``stats``.
        Anything still live when ``max_steps`` trips is evicted (status
        ``"evicted"``), never silently lost."""
        while self.sched.has_work() and self.stats["steps"] < max_steps:
            self.step()
        for slot, req in self.sched.active():
            self._release(slot, req, "evicted")
        return self.stats

    def mean_occupancy(self) -> float:
        """Mean fraction of busy slots per engine step so far."""
        steps = self.stats["steps"]
        return self.stats["occupancy_sum"] / steps if steps else 0.0
