"""The port's continuous-batching serving path against the reference, at
SMOKE size, fp32 (weights crossed from the reference's ``init_lm``):

- ``serve.scheduler``: the same submissions give the reference's audit
  trail event for event (arrival gating, lowest-slot admission, queue
  TTL, running deadlines, bounded retry with backoff, over-budget
  rejection, stop tokens);
- ``serve.kvcache``: ``init_slots`` / ``write_prefill`` / ``clear_slot``
  / ``poison_slot`` leave the reference's leaves;
- ``mha_decode_ragged`` and ``decode_step_ragged`` on one slot cache with
  ragged positions and capacities and a free padding slot, all four
  families, within 1e-5 of max |logit| (the hybrid cache holds the state
  from the layer input, the port's prefill rule);
- ``ServingEngine``: tokens equal the port's ``generate`` per request
  for all four families and the reference engine's for dense, moe and
  ssm (the reference's hybrid prefill takes its state from the layer
  output, ROADMAP queue 3); the packed path, a sliding window, slot
  reuse, eviction, stop tokens, quarantine, occupancy, fixed step shapes;
- a replay's launch counts and the CLI's engine path;
- the captured admission prefill: its buckets, ``padded_prefill`` against
  ``prefill`` (the real ring and the last real row), which engines take
  it (the card's dense engine off a mesh) and which admit eagerly (the
  CPU, moe, ssm, hybrid, a one-rank mesh), and the replayed admissions
  with the card's CUDA calls stubbed.

On the CPU the engine steps eagerly (no CUDA graph:
``stats["graph_captures"] == 0``); ``tests/test_torch_cuda.py`` holds the
captured step on the card."""
import contextlib
import functools
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.core import reweighted as ref_RW  # noqa: E402
from repro.launch.serve import SPARSE_SPEC as REF_SPEC  # noqa: E402
from repro.models import attention as ref_A  # noqa: E402
from repro.models import module as ref_module  # noqa: E402
from repro.models import transformer as ref_T  # noqa: E402
from repro.serve import engine as ref_engine  # noqa: E402
from repro.serve import kvcache as ref_KV  # noqa: E402
from repro.serve import scheduler as ref_sched  # noqa: E402
from repro.train.trainer import apply_masks as ref_apply_masks  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch.serve import SPARSE_SPEC  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serve import compile as C  # noqa: E402
from repro_torch.serve import engine  # noqa: E402
from repro_torch.serve import kvcache as KV  # noqa: E402
from repro_torch.serve import scheduler as sched  # noqa: E402

from test_torch_reference import to_port  # noqa: E402

TOL = 1e-5               # fp32, relative to the reference's max |value|
ROOT = Path(__file__).resolve().parents[1]
ARCH = {"dense": "yi-9b", "moe": "mixtral-8x7b", "ssm": "mamba2-1.3b",
        "hybrid": "hymba-1.5b"}
FAMILIES = tuple(ARCH)
# the port's counters of its CUDA graphs and of the moe admission's
# dispatch, which the reference engine lacks
PORT_STATS = ("graph_captures", "prefill_captures", "prefill_replays",
              "prefill_pad_tokens", "moe_pairs", "moe_dropped")


@functools.lru_cache(maxsize=None)
def _model(family, **over):
    """(ref cfg, port cfg, fp32 reference params, the same as the port's
    tensors) of ``family``'s SMOKE config."""
    rcfg = ref_configs.get(ARCH[family], smoke=True).replace(**over)
    pcfg = configs.get(ARCH[family], smoke=True).replace(**over)
    rparams = ref_module.cast_tree(ref_T.init_lm(jax.random.PRNGKey(0),
                                                 rcfg), jnp.float32)
    return rcfg, pcfg, rparams, to_port(rparams)


@functools.lru_cache(maxsize=None)
def _compiled():
    """yi-9b SMOKE masked at rate 0.6 under the serving spec: the
    reference's masked-dense params, and the port's compile of them
    (``keep_dense=False``).  In fp32 the packed path computes what the
    masked-dense one does, to summation order."""
    rcfg, pcfg, rparams, _ = _model("dense")
    rmasks = ref_RW.magnitude_block_masks(rparams, REF_SPEC, None, rate=0.6)
    rpm = ref_apply_masks(rparams, rmasks)
    pexec, rep = C.compile_model(to_port(rpm), to_port(rmasks), SPARSE_SPEC,
                                 spec=C.CompileSpec(keep_dense=False),
                                 device="cpu")
    assert len(rep.packed) == 7
    return rpm, pexec


def _prompts(vocab, lens, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, vocab, size=n).tolist() for n in lens]


def _oracle(params, cfg, prompt, n_new):
    """One B = 1 port ``generate`` of ``prompt``."""
    return engine.generate(params, cfg, np.asarray([prompt]), n_new,
                           device="cpu")[0].tolist()


def _serve(params, cfg, prompts, n_new, n_slots=2, seq_cap=32, **kw):
    eng = engine.ServingEngine(params, cfg, n_slots=n_slots,
                               seq_cap=seq_cap, device="cpu")
    rids = [eng.submit(p, n_new, **kw) for p in prompts]
    eng.run()
    return eng, [eng.requests[r].tokens for r in rids]


def _close_rel(port, ref, tol=TOL):
    ref = np.asarray(ref, np.float32)
    err = np.abs(port.detach().float().numpy() - ref).max()
    assert err <= tol * np.abs(ref).max(), (err, np.abs(ref).max())


# -- the scheduler -----------------------------------------------------------

# (arrival, prompt length, budget, stop token, deadline, queue ttl, retries,
# backoff, submit step) of each request; prompts longer than 3 are over
# the budget of the scripted engine below
SCENARIOS = {
    "arrivals": [(i // 2, 1, 3, None, None, None, 0, 1, 0)
                 for i in range(5)],
    "ttl": [(0, 2, 4, None, None, None, 0, 1, 0),
            (0, 2, 4, None, None, None, 0, 1, 0),
            (0, 1, 2, None, None, 1, 0, 1, 0),
            (1, 1, 2, None, None, 5, 0, 1, 0)],
    "deadline": [(0, 1, 6, None, 2, None, 0, 1, 0),
                 (0, 1, 3, None, None, None, 0, 1, 0),
                 (1, 2, 6, None, 3, None, 0, 1, 0)],
    "retry": [(0, 1, 4, None, None, None, 0, 1, 0),
              (0, 1, 4, None, None, None, 0, 1, 0),
              (0, 1, 2, None, None, None, 0, 1, 0),
              (0, 1, 2, None, None, None, 2, 1, 0),
              (0, 1, 2, None, None, None, 1, 2, 0),
              (3, 1, 2, None, None, None, 0, 1, 3)],
    "reject_and_stop": [(0, 5, 3, None, None, None, 0, 1, 0),
                        (0, 1, 6, 3, None, None, 0, 1, 0),
                        (0, 2, 6, 4, None, None, 0, 1, 0),
                        (2, 3, 2, None, None, None, 0, 1, 1)],
}


def _drive(mod, specs, max_queue=None):
    """A scripted engine loop over ``mod``'s Scheduler (2 slots): sweep
    TTLs, retries and deadlines, admit, emit token ``step % 5``, release
    the done.  Returns (events, per-request final state)."""
    s = mod.Scheduler(2, max_queue=max_queue)
    reqs = [mod.Request(i, (1,) * plen, budget, arrival=arr, stop_token=stop,
                        deadline_steps=dl, queue_ttl=ttl, retries=rt,
                        backoff=bo)
            for i, (arr, plen, budget, stop, dl, ttl, rt, bo, _)
            in enumerate(specs)]
    for now in range(40):
        for r, spec in zip(reqs, specs):
            if spec[-1] == now:
                if len(r.prompt) > 3:
                    s.reject(r, mod.REASON_OVER_BUDGET)
                else:
                    s.submit(r, now)
        s.expire(now)
        s.poll_retries(now)
        for _, r in s.active():
            if (r.deadline_steps is not None
                    and now - r.admitted_at >= r.deadline_steps):
                s.release(r, "evicted", mod.REASON_DEADLINE_EXPIRED)
        while s.admit(now) is not None:
            pass
        for _, r in s.active():
            r.tokens.append(now % 5)
            if r.done():
                s.release(r)
        if not s.has_work() and now > max(sp[-1] for sp in specs):
            break
    return s.events, [(r.status, r.slot, r.tokens, r.attempts,
                       r.admitted_at) for r in reqs]


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scheduler_events_equal_reference(name):
    max_queue = 1 if name == "retry" else None
    got = _drive(sched, SCENARIOS[name], max_queue)
    want = _drive(ref_sched, SCENARIOS[name], max_queue)
    assert got == want
    kinds = {e[0] for e in got[0]}
    expect = {"arrivals": {"admit", "finished"}, "ttl": {"expire"},
              "deadline": {"evicted"}, "retry": {"defer", "retry", "reject"},
              "reject_and_stop": {"reject", "finished"}}[name]
    assert expect <= kinds, kinds


def test_scheduler_admits_lowest_slot_and_gates_on_arrival():
    s = sched.Scheduler(3)
    early = sched.Request(0, (1,), 2, arrival=0)
    late = sched.Request(1, (1,), 2, arrival=5)
    s.submit(early)
    s.submit(late)
    assert s.admit(now=0) == (0, early)
    assert s.admit(now=0) is None           # head of line not arrived
    assert s.admit(now=5) == (1, late)
    s.release(early)
    assert s.active() == [(1, late)]
    assert sched.REASONS == ref_sched.REASONS


# -- the slot cache ----------------------------------------------------------

def _np_tree(tree):
    """A tree of tensors as numpy COPIES: a view would let the port's
    in-place writes reach arrays the reference (dispatching
    asynchronously) may still be reading."""
    return {k: (_np_tree(v) if isinstance(v, dict) else np.array(v))
            for k, v in tree.items()}


def _assert_leaves_equal(port, ref):
    assert sorted(port) == sorted(ref)
    for k in port:
        if isinstance(port[k], dict):
            _assert_leaves_equal(port[k], ref[k])
        else:
            want = np.asarray(ref[k])
            got = port[k].numpy()
            assert got.shape == want.shape and got.dtype == want.dtype, k
            np.testing.assert_array_equal(got, want, err_msg=k)


@pytest.mark.parametrize("family", FAMILIES)
def test_slot_cache_leaves_equal_reference(family):
    """init_slots, then a prefill written into slot 1 of 3, slot 0
    poisoned, slot 1 cleared: every leaf equal at each step."""
    rcfg, pcfg, rparams, pparams = _model(family)
    pc = KV.init_slots(pparams, pcfg, 3, 16, dtype=torch.float32)
    rc = ref_KV.init_slots(rparams, rcfg, 3, 16, dtype=jnp.float32)
    _assert_leaves_equal(pc, rc)
    tokens = np.asarray(_prompts(pcfg.vocab, [6], seed=2))
    _, req = engine.prefill(pparams, pcfg, torch.from_numpy(tokens))
    req_np = _np_tree(req)
    pc = KV.write_prefill(pc, 1, req)
    rc = ref_KV.write_prefill(rc, 1, jax.tree_util.tree_map(jnp.asarray,
                                                            req_np))
    _assert_leaves_equal(pc, rc)
    pc = KV.poison_slot(pc, 0)
    rc = ref_KV.poison_slot(rc, 0)
    _assert_leaves_equal(pc, rc)
    pc = KV.clear_slot(pc, 1)
    rc = ref_KV.clear_slot(rc, 1)
    _assert_leaves_equal(pc, rc)
    assert KV.INVALID_POS == ref_KV.INVALID_POS


def test_slot_writes_are_in_place():
    """Admission, eviction and poisoning write into the tensors
    ``init_slots`` allocated (a captured graph reads them by address)."""
    _, pcfg, _, pparams = _model("hybrid")
    cache = KV.init_slots(pparams, pcfg, 2, 8, dtype=torch.float32)
    ptrs = {(g, k): t.data_ptr() for g, d in cache.items()
            for k, t in d.items()}
    _, req = engine.prefill(pparams, pcfg,
                            torch.ones((1, 5), dtype=torch.int32))
    for out in (KV.write_prefill(cache, 1, req), KV.clear_slot(cache, 1),
                KV.poison_slot(cache, 0)):
        assert out is cache
        assert {(g, k): t.data_ptr() for g, d in out.items()
                for k, t in d.items()} == ptrs


@pytest.mark.parametrize("window", [0, 8])
def test_slot_capacity_matches_reference(window):
    rcfg, pcfg, _, _ = _model("dense")
    for n in (1, 5, 8, 12, 40):
        assert (KV.slot_capacity(pcfg.replace(sliding_window=window), n)
                == ref_KV.slot_capacity(rcfg.replace(sliding_window=window),
                                        n))


# -- the ragged decode step --------------------------------------------------

def _ragged_cache(pparams, pcfg, lens=(7, 4), n_slots=3, seq_cap=16):
    """A slot cache with the port's prefills of two prompts in slots 0 and
    2 (slot 1 free), and the step's (token, pos, cap) operands."""
    cache = KV.init_slots(pparams, pcfg, n_slots, seq_cap,
                          dtype=torch.float32)
    tok = np.zeros((n_slots, 1), np.int32)
    pos = np.zeros((n_slots, 1), np.int32)
    cap = np.ones((n_slots,), np.int32)
    for slot, n in zip((0, 2), lens):
        prompt = np.asarray(_prompts(pcfg.vocab, [n], seed=slot))
        logits, req = engine.prefill(pparams, pcfg, torch.from_numpy(prompt))
        KV.write_prefill(cache, slot, req)
        tok[slot] = int(torch.argmax(logits[0, -1]))
        pos[slot] = n
        cap[slot] = KV.slot_capacity(pcfg, n)
    return cache, tok, pos, cap


def test_mha_decode_ragged_matches_reference():
    """One attention layer over ragged slots (positions 9 and 3 in rings
    of 4 and 16, one free slot), output and the written cache."""
    rng = np.random.RandomState(0)
    _, pcfg, rparams, pparams = _model("dense")
    rp = jax.tree_util.tree_map(lambda a: a[0], rparams["layers"]["attn"])
    pp = {k: {n: t[0] for n, t in v.items()}
          for k, v in pparams["layers"]["attn"].items()}
    B, S, KVh, hd = 3, 16, pcfg.n_kv_heads, pcfg.hd
    x = rng.randn(B, 1, pcfg.d_model).astype(np.float32)
    k = rng.randn(B, S, KVh, hd).astype(np.float32)
    v = rng.randn(B, S, KVh, hd).astype(np.float32)
    kpos = np.full((B, S), KV.INVALID_POS, np.int32)
    kpos[0, :4] = [8, 5, 6, 7]
    kpos[2, :3] = [0, 1, 2]
    pos = np.asarray([[9], [0], [3]], np.int32)
    cap = np.asarray([4, 1, 16], np.int32)
    for window in (0, 3):
        r_out, r_c = ref_A.mha_decode_ragged(
            rp, jnp.asarray(x), {"k": jnp.asarray(k), "v": jnp.asarray(v),
                                 "pos": jnp.asarray(kpos)},
            jnp.asarray(pos), jnp.asarray(cap), pcfg.n_heads, KVh, hd,
            window=window)
        pc = {"k": torch.from_numpy(k.copy()), "v": torch.from_numpy(v.copy()),
              "pos": torch.from_numpy(kpos.copy())}
        p_out, p_c = A.mha_decode_ragged(
            pp, torch.from_numpy(x), pc, torch.from_numpy(pos),
            torch.from_numpy(cap), pcfg.n_heads, KVh, hd, window=window)
        assert p_c is pc
        _close_rel(p_out, r_out)
        for name in ("k", "v"):
            _close_rel(p_c[name], r_c[name])
        np.testing.assert_array_equal(p_c["pos"].numpy(),
                                      np.asarray(r_c["pos"]))
    assert p_c["pos"][0, 1] == 9 and p_c["pos"][2, 3] == 3


@pytest.mark.parametrize("family", FAMILIES)
def test_decode_step_ragged_matches_reference(family):
    """Logits within 1e-5 of max |logit| and the updated cache, on the
    same slot cache (the port's prefills; the hybrid state from the layer
    input), two steps in a row."""
    rcfg, pcfg, rparams, pparams = _model(family)
    cache, tok, pos, cap = _ragged_cache(pparams, pcfg)
    rcache = jax.tree_util.tree_map(jnp.asarray, _np_tree(cache))
    for step in range(2):
        r_logits, rcache = ref_T.decode_step_ragged(
            rparams, rcfg, jnp.asarray(tok), rcache, jnp.asarray(pos + step),
            jnp.asarray(cap))
        p_logits, cache = T.decode_step_ragged(
            pparams, pcfg, torch.from_numpy(tok), cache,
            torch.from_numpy(pos + step), torch.from_numpy(cap))
        _close_rel(p_logits, r_logits)
        tok = np.asarray(r_logits)[:, -1].argmax(-1)[:, None].astype(
            np.int32)
    for group in cache:
        for name, t in cache[group].items():
            if name == "pos":
                np.testing.assert_array_equal(
                    t.numpy(), np.asarray(rcache[group][name]))
            else:
                _close_rel(t, rcache[group][name])


def test_decode_step_ragged_packed_matches_reference():
    """The packed path (kernel 1's plain version on the CPU) against the
    reference's step on the masked-dense weights."""
    rpm, pexec = _compiled()
    rcfg, pcfg, _, _ = _model("dense")
    cache, tok, pos, cap = _ragged_cache(pexec, pcfg)
    rcache = jax.tree_util.tree_map(jnp.asarray, _np_tree(cache))
    r_logits, _ = ref_T.decode_step_ragged(
        rpm, rcfg, jnp.asarray(tok), rcache, jnp.asarray(pos),
        jnp.asarray(cap))
    p_logits, _ = T.decode_step_ragged(
        pexec, pcfg, torch.from_numpy(tok), cache, torch.from_numpy(pos),
        torch.from_numpy(cap))
    _close_rel(p_logits, r_logits)


def test_ragged_slot_equals_batch_one_decode():
    """Each live slot's logits are those of a B = 1 ``decode_step`` of its
    request after a B = 1 prefill; the moe dispatch runs ``group=1``."""
    _, pcfg, _, pparams = _model("moe")
    cache, tok, pos, cap = _ragged_cache(pparams, pcfg)
    logits, _ = T.decode_step_ragged(pparams, pcfg, torch.from_numpy(tok),
                                     cache, torch.from_numpy(pos),
                                     torch.from_numpy(cap))
    for slot, n in zip((0, 2), (7, 4)):
        prompt = torch.tensor(_prompts(pcfg.vocab, [n], seed=slot))
        _, c1 = engine.prefill(pparams, pcfg, prompt)
        want, _ = T.decode_step(pparams, pcfg, torch.from_numpy(tok[slot:
                                                                   slot + 1]),
                                c1, torch.from_numpy(pos[slot:slot + 1]))
        torch.testing.assert_close(logits[slot], want[0], rtol=1e-5,
                                   atol=1e-5)


# -- the engine --------------------------------------------------------------

@pytest.mark.parametrize("family", FAMILIES)
def test_engine_tokens_equal_generate(family):
    """Three requests of mixed lengths through two slots (the third reuses
    an evicted slot): each request's tokens are its B = 1 ``generate``'s."""
    _, pcfg, _, pparams = _model(family)
    prompts = _prompts(pcfg.vocab, [8, 12, 5])
    eng, toks = _serve(pparams, pcfg, prompts, 6)
    for p, t in zip(prompts, toks):
        assert t == _oracle(pparams, pcfg, p, 6)
    assert eng.stats["finished"] == 3 and eng.stats["graph_captures"] == 0
    assert eng.stats["tokens"] == 18
    assert [e[2] for e in eng.sched.events if e[0] == "admit"] == [0, 1, 0]


@pytest.mark.parametrize("family", ["dense", "moe", "ssm"])
def test_engine_tokens_equal_reference_engine(family):
    """The reference engine on the same weights and submissions gives the
    same tokens and the same audit trail (hybrid is not compared: the
    reference's prefill takes its state from the layer output)."""
    rcfg, pcfg, rparams, pparams = _model(family)
    prompts = _prompts(pcfg.vocab, [8, 12, 5])
    eng, toks = _serve(pparams, pcfg, prompts, 6)
    reng = ref_engine.ServingEngine(rparams, rcfg, n_slots=2, seq_cap=32,
                                    validate=False)
    rids = [reng.submit(p, 6) for p in prompts]
    reng.run()
    assert toks == [reng.requests[r].tokens for r in rids]
    assert eng.sched.events == reng.sched.events
    assert {k: v for k, v in eng.stats.items() if k not in PORT_STATS} \
        == reng.stats


def test_engine_packed_path_equals_generate_and_reference():
    """Packed params: the port engine's tokens equal the port's
    ``generate`` on them and the reference engine's on the masked-dense
    weights."""
    rpm, pexec = _compiled()
    rcfg, pcfg, _, _ = _model("dense")
    prompts = _prompts(pcfg.vocab, [9, 6])
    _, toks = _serve(pexec, pcfg, prompts, 5)
    assert toks == [_oracle(pexec, pcfg, p, 5) for p in prompts]
    reng = ref_engine.ServingEngine(rpm, rcfg, n_slots=2, seq_cap=32,
                                    validate=False)
    rids = [reng.submit(p, 5) for p in prompts]
    reng.run()
    assert toks == [reng.requests[r].tokens for r in rids]


def test_engine_sliding_window_reproduces_the_shared_ring():
    """Window 8, prompts of 12 (the ring wraps) and 5: the engine's slots
    keep ``generate``'s ring, and the reference engine's tokens."""
    rcfg, pcfg, rparams, pparams = _model("dense", sliding_window=8)
    prompts = _prompts(pcfg.vocab, [12, 5])
    eng, toks = _serve(pparams, pcfg, prompts, 6)
    assert eng.seq_cap == 8
    assert toks == [_oracle(pparams, pcfg, p, 6) for p in prompts]
    reng = ref_engine.ServingEngine(rparams, rcfg, n_slots=2, seq_cap=32,
                                    validate=False)
    rids = [reng.submit(p, 6) for p in prompts]
    reng.run()
    assert toks == [reng.requests[r].tokens for r in rids]


def test_slot_reuse_and_cleared_slot():
    """Two requests through one slot, serially, each equal to its oracle;
    after the run the evicted slot's positions are all INVALID_POS."""
    _, pcfg, _, pparams = _model("dense")
    p1, p2 = _prompts(pcfg.vocab, [11, 7], seed=3)
    eng, toks = _serve(pparams, pcfg, [p1, p2], 6, n_slots=1)
    assert toks == [_oracle(pparams, pcfg, p, 6) for p in (p1, p2)]
    assert [e[2] for e in eng.sched.events if e[0] == "admit"] == [0, 0]
    assert (eng.cache["kv"]["pos"] == KV.INVALID_POS).all()


def test_stop_token_ends_a_request_early():
    _, pcfg, _, pparams = _model("dense")
    prompt = _prompts(pcfg.vocab, [8])[0]
    ref = _oracle(pparams, pcfg, prompt, 8)
    stop = ref[3]
    _, (toks,) = _serve(pparams, pcfg, [prompt], 8, n_slots=1,
                        stop_token=stop)
    assert toks == ref[:ref.index(stop) + 1] and len(toks) < 8


def test_occupancy_and_over_budget_accounting():
    _, pcfg, _, pparams = _model("dense")
    eng = engine.ServingEngine(pparams, pcfg, n_slots=4, seq_cap=8,
                               device="cpu")
    bad = eng.submit(list(range(1, 20)), 4)          # ring 19 > seq_cap 8
    assert eng.requests[bad].status == "rejected"
    for p in _prompts(pcfg.vocab, [6, 6]):
        eng.submit(p, 4)
    eng.run()
    s = eng.stats
    assert s["admitted"] == s["finished"] == 2 and s["rejected"] == 1
    assert s["evicted"] == 0 and s["tokens"] == 8
    assert 0.0 < eng.mean_occupancy() <= 0.5          # 2 busy of 4 slots


def test_engine_fault_sweeps_equal_reference_engine():
    """Deadlines, queue TTLs and a full queue's retries through both
    engines: the same audit trail, statuses and tokens."""
    rcfg, pcfg, rparams, pparams = _model("dense")
    prompts = _prompts(pcfg.vocab, [6, 5, 7, 4, 6])
    knobs = [dict(deadline_steps=3), {}, dict(queue_ttl=1),
             dict(retries=2, backoff=1), dict(retries=1, arrival=2)]

    def drive(eng):
        rids = [eng.submit(p, 6, **kw) for p, kw in zip(prompts, knobs)]
        eng.run()
        return ([(eng.requests[r].status, eng.requests[r].tokens)
                 for r in rids], eng.sched.events)
    got = drive(engine.ServingEngine(pparams, pcfg, n_slots=2, seq_cap=16,
                                     max_queue=3, device="cpu"))
    want = drive(ref_engine.ServingEngine(rparams, rcfg, n_slots=2,
                                          seq_cap=16, max_queue=3,
                                          validate=False))
    assert got == want
    assert {"evicted", "expire", "defer"} <= {e[0] for e in got[1]}


def test_poisoned_slot_is_quarantined_alone():
    """A NaN-poisoned live slot is evicted as quarantined without emitting
    its garbage token; the other slots' tokens are those of a run without
    the poison, and the freed slot serves the queue."""
    _, pcfg, _, pparams = _model("hybrid")
    prompts = _prompts(pcfg.vocab, [8, 6, 7, 5], seed=5)
    _, clean = _serve(pparams, pcfg, prompts, 6, n_slots=3)
    eng = engine.ServingEngine(pparams, pcfg, n_slots=3, seq_cap=32,
                               device="cpu")
    rids = [eng.submit(p, 6) for p in prompts]
    eng.step()
    eng.step()
    KV.poison_slot(eng.cache, 1)
    eng.run()
    reqs = [eng.requests[r] for r in rids]
    assert reqs[1].status == "quarantined" and eng.stats["quarantined"] == 1
    assert reqs[1].tokens == clean[1][:len(reqs[1].tokens)]
    assert len(reqs[1].tokens) == 3
    for i in (0, 2, 3):
        assert reqs[i].status == "finished" and reqs[i].tokens == clean[i]
    assert ("quarantined", 1, 1, sched.REASON_QUARANTINED) in eng.sched.events


def test_step_operands_keep_their_shapes_and_tensors(monkeypatch):
    """Every step feeds ``decode_step_ragged`` the same operand shapes and
    the same cache tensors, across staggered admissions, evictions and
    slot reuse: the CUDA graph's one capture stays valid."""
    _, pcfg, _, pparams = _model("hybrid")
    seen = []

    def spy(params, cfg, token, cache, pos, cap, layers=None):
        seen.append((tuple(token.shape), tuple(pos.shape), tuple(cap.shape),
                     tuple(sorted((g, k, t.data_ptr(), tuple(t.shape))
                                  for g, d in cache.items()
                                  for k, t in d.items()))))
        return real(params, cfg, token, cache, pos, cap, layers)
    real = T.decode_step_ragged
    monkeypatch.setattr(T, "decode_step_ragged", spy)
    eng = engine.ServingEngine(pparams, pcfg, n_slots=2, seq_cap=32,
                               device="cpu")
    for i, p in enumerate(_prompts(pcfg.vocab, [8, 5, 12])):
        eng.submit(p, 4, arrival=i)
    eng.run()
    assert eng.stats["finished"] == 3 and len(seen) >= 6
    assert len(set(seen)) == 1


def test_validate_raises_and_other_families_refused():
    """``validate=True`` is the default: a clean tree serves, and a corrupt
    layout with no dense ``w`` to fall back on raises at construction
    (``_compiled`` packs with ``keep_dense=False``)."""
    from repro_torch.core import validate as V
    from repro_torch.testing import faults as F
    _, pcfg, _, pparams = _model("dense")
    _, pexec = _compiled()
    assert engine.ServingEngine(pexec, pcfg, device="cpu").stats[
        "degraded_layers"] == 0
    bad, _ = F.bitflip_packed_leaf(pexec, seed=0)
    with pytest.raises(V.LayoutNumericsError):
        engine.ServingEngine(bad, pcfg, validate=True, device="cpu")
    with pytest.raises(NotImplementedError, match="not served"):
        engine.ServingEngine(pparams, pcfg.replace(family="encdec"),
                             device="cpu")
    with pytest.raises(ValueError, match="live on"):
        engine.ServingEngine(pparams, pcfg, device="meta")


@pytest.mark.parametrize("family", ["dense", "hybrid"])
def test_generate_python_equals_generate(family):
    _, pcfg, _, pparams = _model(family)
    tokens = np.asarray(_prompts(pcfg.vocab, [9, 9], seed=7))
    got = engine.generate_python(pparams, pcfg, tokens, 7, device="cpu")
    want = engine.generate(pparams, pcfg, tokens, 7, device="cpu")
    assert got.dtype == torch.int32 and torch.equal(got, want)


# -- the captured step's launch counts ---------------------------------------

def test_replays_count_the_launches_their_capture_recorded(monkeypatch):
    """A capture records the step's kernel launches and runs none: the
    warm-up's launches stay counted, the capture's are taken back out,
    and every replay adds them once (the card's path, its CUDA calls
    stubbed here)."""
    from repro_torch.kernels import bsr_matmul as K
    _, pcfg, _, pparams = _model("dense")
    replays = []

    class Graph:
        def replay(self):
            replays.append(1)

    class Stream:
        def __init__(self, *args):
            pass

        def wait_stream(self, other):
            pass

    def counted(*args, **kw):          # 7 packed projections a step
        K.LAUNCHES["bsr_matmul"] += 7
        return real(*args, **kw)
    real = T.decode_step_ragged
    monkeypatch.setattr(T, "decode_step_ragged", counted)
    for name, fake in (("Stream", Stream), ("current_stream", Stream),
                       ("stream", lambda s: contextlib.nullcontext()),
                       ("CUDAGraph", Graph),
                       ("graph", lambda g, pool=None:
                        contextlib.nullcontext())):
        monkeypatch.setattr(torch.cuda, name, fake)
    monkeypatch.setitem(K.LAUNCHES, "bsr_matmul", 0)
    eng = engine.ServingEngine(pparams, pcfg, n_slots=2, seq_cap=32,
                               device="cpu")
    eng._capture()
    assert K.LAUNCHES["bsr_matmul"] == 7            # the warm-up alone
    assert eng.stats["graph_captures"] == 1
    eng.submit(_prompts(pcfg.vocab, [6])[0], 4)
    eng.step()
    eng.step()
    assert len(replays) == 2 and K.LAUNCHES["bsr_matmul"] == 7 + 2 * 7


def test_grown_tile_counters_keep_the_tensor_a_graph_holds(monkeypatch):
    """Kernel 1's per-device tile counters grow at least twofold and
    retire the tensor they replace without freeing it (a graph captured
    before the growth still reads it)."""
    from repro_torch.kernels import bsr_matmul as K
    monkeypatch.setattr(K, "_COUNTERS", {})
    monkeypatch.setattr(K, "_RETIRED", [])
    # a CPU build of torch has no capture state to ask
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    dev = torch.device("cpu")
    first = K._counters(dev, 10)
    assert first.numel() == 1 << 16 and K._counters(dev, 1 << 16) is first
    grown = K._counters(dev, (1 << 16) + 1)
    assert grown.numel() == 1 << 17 and not grown.any()
    assert K._RETIRED == [first]


# -- the captured admission prefill -----------------------------------------

@pytest.mark.parametrize("seq_cap,want", [
    (32, (16, 32)),
    (1024, (16, 32, 64, 128, 256, 512, 1024)),
    (1000, (16, 32, 64, 128, 256, 512, 1000)),
    (8, (8,))])
def test_prefill_buckets(seq_cap, want):
    assert engine.prefill_buckets(seq_cap) == want


@pytest.mark.parametrize("S_len,window", [(1, 0), (5, 0), (16, 0), (17, 0),
                                          (32, 0), (17, 8), (32, 8)])
def test_padded_prefill_equals_prefill(S_len, window):
    """The prompt right-padded with token 0 to its bucket (the smallest of
    ``prefill_buckets(64)`` holding it): ``padded_cache``'s ring equals
    ``prefill``'s cache within 1e-6 of its max |value| (positions
    exactly), a sliding window shorter than the prompt cutting the real
    prompt, and the last real row's logits give the same argmax."""
    _, pcfg, _, pparams = _model("dense")
    cfg = pcfg.replace(sliding_window=window)
    b = next(x for x in engine.prefill_buckets(64) if x >= S_len)
    prompt = _prompts(cfg.vocab, [S_len], seed=S_len)[0]
    toks = torch.zeros((1, b), dtype=torch.int32)
    toks[0, :S_len] = torch.tensor(prompt)
    with torch.no_grad():
        want_logits, want = engine.prefill(pparams, cfg, torch.tensor(
            [prompt], dtype=torch.int32))
        logits, cache = engine.padded_prefill(pparams, cfg, toks,
                                              torch.tensor([S_len - 1]))
    assert cache["kv"]["k"].shape == (cfg.n_layers, 1, b, cfg.n_kv_heads,
                                      cfg.hd)
    got = engine.padded_cache(cache, S_len, cfg)
    cap = KV.slot_capacity(cfg, S_len)
    assert cap == (min(window, S_len) if window else S_len)
    assert torch.equal(got["kv"]["pos"], want["kv"]["pos"])
    for name in ("k", "v"):
        assert got["kv"][name].shape == want["kv"][name].shape
        _close_rel(got["kv"][name], want["kv"][name], tol=1e-6)
    assert logits.shape == want_logits.shape
    assert int(logits.argmax()) == int(want_logits.argmax())


@pytest.mark.parametrize("kv_chunk,seq_cap,want", [
    (1024, 1024, (16, 32, 64, 128, 256, 512, 1024)),
    (16, 40, (16, 32)),
    (1024, 2000, (16, 32, 64, 128, 256, 512, 1024))])
def test_engine_buckets_are_those_the_prefill_runs(monkeypatch, kv_chunk,
                                                   seq_cap, want):
    """Past ``kv_chunk`` the prefill's attention takes whole chunks only,
    so a bucket that is not one is dropped (its prompts could not run
    eagerly either)."""
    _, pcfg, _, pparams = _model("dense")
    monkeypatch.setattr(engine, "replays_prefill", lambda *a: True)
    eng = engine.ServingEngine(pparams, pcfg.replace(kv_chunk=kv_chunk),
                               n_slots=1, seq_cap=seq_cap, device="cpu")
    assert eng._buckets == want


@pytest.mark.parametrize("device,family,meshed,want", [
    ("cuda", "dense", False, True),
    ("cpu", "dense", False, False),
    ("cuda", "moe", False, False),
    ("cuda", "ssm", False, False),
    ("cuda", "hybrid", False, False),
    ("cuda", "dense", True, False)])
def test_which_engines_replay_the_prefill(device, family, meshed, want):
    """Only the card's dense engine off a mesh captures its prefill."""
    _, pcfg, _, _ = _model(family)
    dist = object() if meshed else None
    assert engine.replays_prefill(pcfg, torch.device(device), dist) is want


@pytest.mark.parametrize("family", FAMILIES)
def test_cpu_engines_admit_eagerly(family):
    """Off the card every family admits through the eager ``prefill``:
    nothing captured, nothing replayed, the tokens ``generate``'s."""
    _, pcfg, _, pparams = _model(family)
    prompts = _prompts(pcfg.vocab, [5, 17, 9], seed=3)
    eng, toks = _serve(pparams, pcfg, prompts, 4)
    assert eng._buckets == ()
    assert (eng.stats["prefill_captures"], eng.stats["prefill_replays"],
            eng.stats["prefill_pad_tokens"]) == (0, 0, 0)
    for p, t in zip(prompts, toks):
        assert t == _oracle(pparams, pcfg, p, 4)


ONE_RANK_ENGINE = """
import json, torch
from repro_torch import configs
from repro_torch.core import reweighted as RW
from repro_torch.distributed import sharding as SH
from repro_torch.launch import mesh as MESH
from repro_torch.launch.serve import SPARSE_SPEC
from repro_torch.models import transformer as T
from repro_torch.serve import compile as C, engine as E
from repro_torch.train.trainer import apply_masks
torch.set_num_threads(1)
cfg = configs.get("yi-9b", smoke=True)
p = T.init_lm(cfg, seed=0, dtype=torch.float32, device="cpu")
masks = RW.magnitude_block_masks(p, SPARSE_SPEC, None, rate=0.5)
exec_p, _ = C.compile_model(apply_masks(p, masks), masks, SPARSE_SPEC,
                            spec=C.CompileSpec(keep_dense=False),
                            device="cpu")
mesh = MESH.make_local_mesh(1, device="cpu")
placed = SH.shard_packed_tree(exec_p, mesh)
d = SH.make_dist(mesh, cfg, 1)
prompts = [[5, 7, 11, 13], [17, 19, 23], [29, 31, 37, 41, 43]]
eng = E.ServingEngine(placed, cfg, n_slots=2, seq_cap=16, device="cpu",
                      dist=d)
rids = [eng.submit(q, 4) for q in prompts]
eng.run()
want = [E.generate(exec_p, cfg, torch.tensor([q]), 4,
                   device="cpu")[0].tolist() for q in prompts]
out = {"tokens_equal": [eng.requests[r].tokens for r in rids] == want,
       "replays_on_card": E.replays_prefill(cfg, torch.device("cuda"), d),
       "stats": [eng.stats[k] for k in ("prefill_captures",
                                        "prefill_replays",
                                        "prefill_pad_tokens")]}
MESH.close_local_mesh()
print(json.dumps(out))
"""


def test_one_rank_mesh_engine_admits_eagerly():
    """A one-rank gloo mesh (in a subprocess: no group starts in the test
    process): the engine under ``dist`` admits eagerly, and would on the
    card too; its tokens are the un-meshed ``generate``'s."""
    import json
    import os
    proc = subprocess.run(
        [sys.executable, "-c", ONE_RANK_ENGINE], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out == {"tokens_equal": True, "replays_on_card": False,
                   "stats": [0, 0, 0]}


def test_replayed_admissions_equal_generate(monkeypatch):
    """The card's admission path with its CUDA calls stubbed on the CPU: a
    stub capture runs the bucket's forward once and a stub replay runs it
    again into the captured outputs.  Each bucket is captured once,
    largest first; every admission replays its bucket, counts the
    capture's launches once (the warm-up's stay counted, the captures'
    are taken back out) and the padding it ran; the ``engine.admit``
    span names the bucket; the tokens are ``generate``'s."""
    from repro_torch.kernels import bsr_matmul as K
    from repro_torch.serve import trace as TR
    _, pcfg, _, pparams = _model("dense")
    per = 7 * pcfg.n_layers                  # kernel 1's, on the card
    held = []

    class Graph:
        def replay(self):
            eng = held[0]
            b = next(b for b, g in eng._pf_graphs.items() if g is self)
            n = K.LAUNCHES["bsr_matmul"]
            (first, cache), (new_first, new) = (eng._pf_out[b],
                                                eng._bucket_forward(b))
            first.copy_(new_first)
            for name, t in cache["kv"].items():
                t.copy_(new["kv"][name])
            K.LAUNCHES["bsr_matmul"] = n     # a replay launches nothing

    class Stream:
        def __init__(self, *args):
            pass

        def wait_stream(self, other):
            pass

    def counted(*args, **kw):
        K.LAUNCHES["bsr_matmul"] += per
        return real(*args, **kw)
    real = engine.padded_prefill
    monkeypatch.setattr(engine, "padded_prefill", counted)
    for name, fake in (("Stream", Stream), ("current_stream", Stream),
                       ("stream", lambda s: contextlib.nullcontext()),
                       ("CUDAGraph", Graph), ("graph_pool_handle", object),
                       ("graph", lambda g, pool=None:
                        contextlib.nullcontext())):
        monkeypatch.setattr(torch.cuda, name, fake)
    monkeypatch.setitem(K.LAUNCHES, "bsr_matmul", 0)
    TR.reset()
    eng = engine.ServingEngine(pparams, pcfg, n_slots=2, seq_cap=32,
                               device="cpu")
    held.append(eng)
    eng._buckets = engine.prefill_buckets(32)
    eng._capture_prefill()
    assert K.LAUNCHES["bsr_matmul"] == per          # the warm-up alone
    assert eng.stats["prefill_captures"] == 2
    assert eng._pf_launches == {16: {"bsr_matmul": per},
                                32: {"bsr_matmul": per}}
    spans, _ = TR.spans()
    assert [sp.attrs["bucket"] for sp in spans
            if sp.name == "engine.capture_prefill"] == [32, 16]
    prompts = _prompts(pcfg.vocab, [5, 16, 17, 30], seed=4)
    rids = [eng.submit(p, 5) for p in prompts]
    eng.run()
    for rid, p in zip(rids, prompts):
        assert eng.requests[rid].tokens == _oracle(pparams, pcfg, p, 5)
    assert eng.stats["prefill_replays"] == eng.stats["admitted"] == 4
    assert eng.stats["prefill_pad_tokens"] == 11 + 0 + 15 + 2
    assert K.LAUNCHES["bsr_matmul"] == per + 4 * per
    admits = [sp for sp in TR.spans()[0] if sp.name == "engine.admit"]
    assert [sp.attrs["bucket"] for sp in admits] == [16, 16, 32, 32]
    assert [sp.launches for sp in admits] == [per] * 4
    TR.reset()


# -- the CLI -----------------------------------------------------------------

@pytest.mark.parametrize("rate", [None, "1"])
def test_port_cli_engine_path_on_cpu(rate):
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "yi-9b",
         "--smoke", "--sparse", "--batch-size", "4", "--device", "cpu"]
        + (["--arrival-rate", rate] if rate else []),
        cwd=ROOT,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert (f"engine B=4, rate={float(rate)}/step" if rate
            else "engine B=4, saturated") in proc.stdout
    assert "16/16 requests" in proc.stdout
    assert "occupancy" in proc.stdout and "queued" in proc.stdout
