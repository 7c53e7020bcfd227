"""Serving: ``prefill`` (a forward pass that also emits the per-layer KV
caches, SSM states and cross caches), ``generate`` (prefill, then the
greedy or sampling decode loop), ``generate_python`` (its greedy
per-token oracle), and the continuous-batching ``ServingEngine`` (the
decoder-only families), which decodes every live request through ONE
batched step a token, so each packed kernel launch reads the weights once
for the whole batch.  Works with dense, masked, and
``compile_model``-packed params alike.

Each entry point takes ``dist`` (``distributed.sharding.Dist``): it places
its inputs by the batch spec (sharded over the data axes when the batch
divides, else replicated), runs the model on the mesh, and returns plain
whole tensors, as a JAX global array reads.  Params are placed by the
caller (``sharding.shard_packed_tree`` for the packed layouts)."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import bsr_matmul as K
from repro_torch.models import layers as L
from repro_torch.models.module import resolve_device
from repro_torch.models import transformer as T
from repro_torch.serve import compile as SC
from repro_torch.serve import kvcache as KV
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


def _prefill(params, cfg, tokens, frontend, dist):
    _, Sq = tokens.shape
    positions = torch.arange(Sq, dtype=torch.int32, device=tokens.device)
    x = L.embed(params["embed"], tokens)
    if dist is not None:
        x = dist.shard_activations(x)
    fam = cfg.family
    kvs, xkvs, states = [], [], []
    if fam in T.DECODER_FAMILIES:
        for lp in T.layer_params(params):
            x, kv, st, _ = T._layer_fwd(lp, x, positions, cfg, dist=dist)
            if kv is not None:
                kvs.append(_window_kv(*kv, Sq, cfg))
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
            "k": torch.stack(k), "v": torch.stack(v),
            "pos": torch.stack(pos)}
    if xkvs:
        xk, xv = zip(*xkvs)
        cache["xk"], cache["xv"] = torch.stack(xk), torch.stack(xv)
    if states:
        cache["ssm"] = {name: torch.stack([st[name] for st in states])
                        for name in states[0]}
    x = L.rmsnorm(params["norm_f"], x[:, -1:, :])
    logits = L.unembed(params["head"], x)
    if dist is not None:
        logits = dist.shard_logits(logits)
    return logits, cache


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
                    frontend=None, dist=None):
    """Greedy generation one token at a time, each step's token read back
    to the host: the per-token oracle of ``generate`` and the engine."""
    dev, tokens, frontend = _inputs(tokens, frontend, device)
    B, Sq = tokens.shape
    logits, cache = prefill(params, cfg, tokens, frontend, dist)
    layers = T.decode_layers(params, cfg)
    out = []
    for i in range(n_new):
        tok = np.argmax(logits[:, -1, :].float().cpu().numpy(), axis=-1)
        out.append(tok.astype(np.int32))
        pos = torch.full((B, 1), Sq + i, dtype=torch.int32, device=dev)
        logits, cache = T.decode_step(
            params, cfg, torch.as_tensor(tok[:, None], device=dev), cache,
            pos, layers, dist)
        if dist is not None:
            logits = dist.gather(logits)
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
    """

    FAMILIES = T.DECODER_FAMILIES

    def __init__(self, params, cfg: ArchConfig, *, n_slots=8, seq_cap=256,
                 max_queue=None, validate=True, report=None,
                 device="cuda", dist=None):
        if cfg.family not in self.FAMILIES:
            raise NotImplementedError(
                f"family {cfg.family!r} is not served (supported: "
                f"{self.FAMILIES})")
        dev = resolve_device(device)
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
                      "degraded_layers": len(degraded), "graph_captures": 0}
        self._graph = None
        self.logits = self._out = None
        if self.device.type == "cuda":
            self._capture()

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

    @torch.no_grad()
    def _capture(self):
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            self._forward()            # warm-up: tables, tile counters
        torch.cuda.current_stream(self.device).wait_stream(side)
        self._graph = torch.cuda.CUDAGraph()
        before = dict(K.LAUNCHES)
        with torch.cuda.graph(self._graph):
            self.logits, self._out = self._forward()
        self._replay_launches = {k: n - before[k]
                                 for k, n in K.LAUNCHES.items()
                                 if n != before[k]}
        K.LAUNCHES.update(before)
        # the graph reads the cache by address: its tensors live as long
        # as the graph, whatever later rebinds ``self.cache``
        self._graph_inputs = [t for group in self.cache.values()
                              for t in group.values()]
        self.stats["graph_captures"] += 1

    @torch.no_grad()
    def _run(self):
        """One decode step over every slot: (next tokens, probe) as host
        arrays, ``logits`` holding the step's logits."""
        self._ops_dev.copy_(torch.from_numpy(self._ops))
        if self._graph is not None:
            self._graph.replay()
            for k, n in self._replay_launches.items():
                K.LAUNCHES[k] += n
        else:
            self.logits, self._out = self._forward()
        out = self._out.cpu().numpy()
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
        return req.rid

    # -- engine loop ----------------------------------------------------------

    @torch.no_grad()
    def _admit(self):
        while (pair := self.sched.admit(self.stats["steps"])) is not None:
            slot, req = pair
            toks = torch.tensor([req.prompt], dtype=torch.int32,
                                device=self.device)
            logits, rc = prefill(self.params, self.cfg, toks,
                                 dist=self.dist)
            t0 = int(torch.argmax(logits[0, -1]))
            req.tokens.append(t0)
            self.stats["admitted"] += 1
            self.stats["tokens"] += 1
            if req.done():      # budget of 1 (or an instant stop token)
                self._release(slot, req, "finished")
                continue
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
        self.stats["expired"] += len(self.sched.expire(now))
        self.stats["rejected"] += len(self.sched.poll_retries(now))
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
        self._sweep_faults()
        self._admit()
        active = self.sched.active()
        self.stats["steps"] += 1
        self.stats["occupancy_sum"] += len(active) / self.n_slots
        if not active:
            return 0
        nxt, ok = self._run()
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
