"""The port's span recorder (``serve.trace``) and the spans of the serving
engine and ``compile_model``, on the CPU with the engine eager at SMOKE
widths: nesting and parent indices, request ids on ``queue`` and
``engine.admit``, kernel-1 launch deltas that add up to the change in
``LAUNCHES``, one ``engine.admit`` per admission and one ``engine.step``
per step, the ring's bound and its dropped count, recording switched off,
every span in a ``torch.profiler`` trace as ``repro.<name>`` nested as
recorded, the serve CLI's span lines, and the moe family's eager
admission: its ``moe.dispatch`` spans and its counts of the routed and
dropped (token, expert) pairs, against the capacity rule, nothing counted
by a decode step, and no op added with the recorder off.  The tests
marked ``cuda`` hold the captured step's ``graph_ms`` to its step, and
the captured moe step to the same kernels with the recorder on and off,
on the card:

  PYTHONPATH=src python -m pytest -q tests/test_torch_trace.py
"""
import collections
import functools

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.core import reweighted as RW  # noqa: E402
from repro_torch.kernels import bsr_matmul as K  # noqa: E402
from repro_torch.launch import serve as CLI  # noqa: E402
from repro_torch.models import moe as MOE  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serve import compile as C  # noqa: E402
from repro_torch.serve import engine  # noqa: E402
from repro_torch.serve import kvcache as KV  # noqa: E402
from repro_torch.serve import trace as TR  # noqa: E402

ENGINE_SPANS = {"engine.step", "engine.admit", "admit.prefill",
                "admit.first_token", "admit.slot_write", "engine.replay",
                "queue"}


@pytest.fixture(autouse=True)
def recorder():
    TR.reset()
    TR.enable(True)
    yield
    TR.reset()
    TR.enable(True)


@functools.lru_cache(maxsize=None)
def _params(device="cpu"):
    cfg = configs.get("yi-9b", smoke=True)
    return cfg, T.init_lm(cfg, seed=0, dtype=torch.float32, device=device)


def _serve(n_requests=5, n_slots=2, device="cpu", max_new=(3, 1, 4, 2, 5)):
    """A SMOKE yi-9b engine serving ``n_requests`` prompts of 5-9 tokens;
    one of them (budget 1) finishes at its admission."""
    cfg, params = _params(device)
    eng = engine.ServingEngine(params, cfg, n_slots=n_slots, seq_cap=32,
                               device=device)
    rng = np.random.RandomState(0)
    for i in range(n_requests):
        eng.submit(rng.randint(1, cfg.vocab, 5 + i).tolist(),
                   max_new[i % len(max_new)])
    eng.run()
    return eng


def _closed(name=None):
    return [sp for sp in TR.spans()[0] if sp.t1 is not None
            and (name is None or sp.name == name)]


def test_nesting_and_parent_indices():
    with TR.span("a", rid=3, k=1) as a:
        with TR.span("b") as b:
            q = TR.begin("q", rid=7)
            with TR.span("c") as c:
                pass
        with TR.span("d") as d:
            q.end()
    held, dropped = TR.spans()
    assert dropped == 0
    assert [sp.name for sp in held] == ["a", "b", "q", "c", "d"]
    assert [sp.index for sp in held] == [0, 1, 2, 3, 4]
    assert (a.parent, b.parent, q.parent, c.parent, d.parent) == (
        None, a.index, b.index, b.index, a.index)   # q nests nothing
    assert a.rid == 3 and a.attrs == {"k": 1} and q.rid == 7
    for outer, inner in ((a, b), (b, c), (a, d)):
        assert outer.t0 <= inner.t0 <= inner.t1 <= outer.t1
    assert d.t0 <= q.t1 <= d.t1


def test_engine_spans_nest_as_the_step_runs():
    eng = _serve()
    spans = _closed()
    by = {sp.index: sp for sp in spans}
    assert {sp.name for sp in spans} == ENGINE_SPANS | {"engine.init"}
    for sp in spans:
        parent = by.get(sp.parent)
        if sp.name in ("engine.step", "queue", "engine.init"):
            assert sp.parent is None
            continue
        want = ("engine.admit" if sp.name.startswith("admit.")
                else "engine.step")
        assert parent.name == want, sp
        assert parent.t0 <= sp.t0 <= sp.t1 <= parent.t1
    # the replay's host pieces are attributes; no graph is timed off the card
    for r in _closed("engine.replay"):
        pieces = [r.attrs[k] for k in ("copy_in_ms", "launch_ms",
                                       "read_back_ms")]
        assert all(x >= 0 for x in pieces) and sum(pieces) <= r.ms
        assert r.attrs["graph_ms"] is None
        assert not [sp for sp in spans if sp.parent == r.index]
    for sp in _closed("engine.step"):
        if sp.attrs["active"]:
            assert 0 <= sp.attrs["harvest_ms"] <= sp.ms
    assert eng.stats["graph_captures"] == 0


def test_one_admit_per_admission_and_one_step_per_step():
    eng = _serve()
    steps, admits = _closed("engine.step"), _closed("engine.admit")
    assert len(steps) == eng.stats["steps"]
    assert len(admits) == eng.stats["admitted"] == 5
    assert sum(sp.attrs["admitted"] for sp in steps) == 5
    active = [sp.attrs["active"] for sp in steps]
    assert max(active) == 2 and len(_closed("engine.replay")) == sum(
        1 for n in active if n)
    # a request with a budget of 1 finishes at its admission: no slot write
    assert len(_closed("admit.first_token")) == 5
    assert len(_closed("admit.slot_write")) == 4


def test_request_ids_on_queue_and_admit():
    eng = _serve()
    admits = {sp.rid: sp for sp in _closed("engine.admit")}
    queues = {sp.rid: sp for sp in _closed("queue")}
    assert set(admits) == set(queues) == set(eng.requests)
    for rid, sp in admits.items():
        assert sp.attrs["prompt_len"] == len(eng.requests[rid].prompt)
        assert queues[rid].t1 <= sp.t0
    assert not eng._queue_spans


def test_queue_span_ends_at_expiry():
    cfg, params = _params()
    eng = engine.ServingEngine(params, cfg, n_slots=1, seq_cap=32,
                               device="cpu")
    eng.submit([1, 2, 3], 4)
    eng.submit([4, 5, 6], 4, queue_ttl=1)
    eng.run()
    assert eng.requests[1].status == "expired"
    assert {sp.rid for sp in _closed("queue")} == {0, 1}
    assert [sp.rid for sp in _closed("engine.admit")] == [0]
    assert not eng._queue_spans


def test_launch_deltas_sum_to_the_change_in_launches(monkeypatch):
    """Each prefill counts 5 launches and each decode step 7 (stand-ins
    for kernel 1's, which only the card counts)."""
    real_prefill, real_step = engine.prefill, T.decode_step_ragged

    def prefill(*args, **kw):
        K.LAUNCHES["bsr_matmul"] += 5
        return real_prefill(*args, **kw)

    def step(*args, **kw):
        K.LAUNCHES["bsr_matmul"] += 7
        return real_step(*args, **kw)
    monkeypatch.setattr(engine, "prefill", prefill)
    monkeypatch.setattr(T, "decode_step_ragged", step)
    before = K.LAUNCHES["bsr_matmul"]
    _serve()
    total = K.LAUNCHES["bsr_matmul"] - before
    steps = _closed("engine.step")
    assert total == sum(sp.launches for sp in steps) == 5 * 5 + 7 * len(
        _closed("engine.replay"))
    assert [sp.launches for sp in _closed("engine.admit")] == [5] * 5
    assert all(sp.launches == 5 for sp in _closed("admit.prefill"))
    assert all(sp.launches == 7 for sp in _closed("engine.replay"))
    assert all(sp.launches == 0 for name in ("admit.first_token",
                                             "admit.slot_write")
               for sp in _closed(name))
    for sp in steps:
        assert sp.launches == 5 * sp.attrs["admitted"] + (
            7 if sp.attrs["active"] else 0)


def test_ring_keeps_the_newest_and_counts_what_it_drops():
    TR.reset(capacity=8)
    for i in range(20):
        with TR.span("s", i=i):
            pass
    held, dropped = TR.spans()
    assert dropped == 12
    assert [sp.attrs["i"] for sp in held] == list(range(12, 20))
    assert [sp.index for sp in held] == list(range(12, 20))
    TR.reset(capacity=4)
    _serve(n_requests=2)
    held, dropped = TR.spans()
    assert len(held) == 4 and dropped > 0
    assert held[-1].index == dropped + 3


def test_enable_false_records_nothing():
    TR.enable(False)
    with TR.span("x") as sp:
        assert sp is None
    assert TR.begin("q") is None
    eng = _serve()
    assert TR.spans() == ([], 0)
    assert eng.stats["admitted"] == 5 and not eng._queue_spans
    TR.enable(True)
    with TR.span("y"):
        pass
    assert [sp.name for sp in TR.spans()[0]] == ["y"]


def test_compile_model_and_engine_init_are_recorded():
    cfg, params = _params()
    masks = RW.magnitude_block_masks(params, CLI.SPARSE_SPEC, None, rate=0.6)
    exec_p, _ = C.compile_model(params, masks, CLI.SPARSE_SPEC,
                                spec=C.CompileSpec(keep_dense=False),
                                device="cpu")
    engine.ServingEngine(exec_p, cfg, n_slots=2, seq_cap=32, device="cpu")
    names = [sp.name for sp in _closed()]
    assert names == ["compile_model", "engine.init"]
    # no card: no memory figure, and no capture
    assert all("memory_allocated" not in sp.attrs for sp in _closed())


def _kineto(prof):
    """(name, start ns, end ns) of the profiler's ``repro.`` host ranges."""
    res = prof.profiler.kineto_results
    return [(e.name()[len(TR.PREFIX):], e.start_ns(),
             e.start_ns() + e.duration_ns()) for e in res.events()
            if e.name().startswith(TR.PREFIX)]


def test_every_span_is_in_the_profiler_trace_nested_as_recorded():
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _serve(n_requests=3)
    spans = _closed()
    events = _kineto(prof)
    assert len(events) == len(spans) > 0
    # the k-th span of a name is the k-th range of that name, by start
    ranges = {}
    for name, a, b in sorted(events, key=lambda e: e[1]):
        ranges.setdefault(name, []).append((a, b))
    at = {}
    for sp in spans:
        at[sp.index] = ranges[sp.name][
            sum(1 for s in spans if s.name == sp.name and s.t0 < sp.t0)]
    assert {sp.name for sp in spans} == set(ranges)
    for sp in spans:
        if sp.parent is not None:
            (pa, pb), (a, b) = at[sp.parent], at[sp.index]
            assert pa <= a <= b <= pb, sp
    # outside a profiler no range is opened
    with TR.span("outside") as sp:
        assert sp._range is None


def test_cli_span_lines_read_the_spans():
    _serve()
    spans = _closed()
    line = CLI._span_line(spans)
    steps = [sp for sp in _closed("engine.step")
             if not sp.attrs["admitted"] and sp.attrs["active"]]
    host = float(np.median([sp.ms for sp in steps]))
    assert f"step host {host:.2f} / graph -" in line
    first = float(np.median([sp.ms for sp in _closed("admit.first_token")]))
    assert f"first token {first:.2f}" in line
    queue = float(np.median([sp.ms for sp in _closed("queue")]))
    assert line.endswith(f"queue {queue:.2f}")
    assert CLI._span_line([]).count("-") >= 9
    assert CLI._setup_line(spans).startswith("      set-up spans: "
                                             "engine.init ")


@pytest.mark.cuda
def test_graph_ms_within_its_step_on_the_card():
    """Every ``GRAPH_TIMING_EVERY``-th replay, and only it, is timed."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the captured step runs there")
    eng = _serve(n_slots=2, device="cuda", max_new=(14, 10, 15, 11, 12))
    assert eng.stats["graph_captures"] == 1
    by = {sp.index: sp for sp in _closed()}
    replays = _closed("engine.replay")
    every = engine.ServingEngine.GRAPH_TIMING_EVERY
    assert len(replays) > every
    for i, r in enumerate(replays):
        step = by[r.parent]
        if i % every:
            assert r.attrs["graph_ms"] is None
        else:
            assert 0 < r.attrs["graph_ms"] <= step.ms
    cap = _closed("engine.capture")
    assert len(cap) == 1 and cap[0].attrs["memory_allocated"] > 0


@pytest.mark.cuda
def test_profiled_card_run_names_every_span_on_the_host_only():
    """Under a profiler tracing the card, each span is a host range
    ``repro.<name>`` nested as recorded, and none lands on the device's
    timeline (where a trace reader would count it as device work)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the captured step runs there")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    _params("cuda")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _serve(n_slots=2, device="cuda")
    res = prof.profiler.kineto_results
    assert not [e.name() for e in res.events()
                if e.name().startswith(TR.PREFIX)
                and e.device_type() == DeviceType.CUDA]
    assert any(e.device_type() == DeviceType.CUDA for e in res.events())
    spans = _closed()
    ranges = {}
    for name, a, b in sorted(_kineto(prof), key=lambda e: e[1]):
        ranges.setdefault(name, []).append((a, b))
    assert sum(map(len, ranges.values())) == len(spans)
    at = {sp.index: ranges[sp.name][
        sum(1 for s in spans if s.name == sp.name and s.t0 < sp.t0)]
        for sp in spans}
    for sp in spans:
        if sp.parent is not None:
            (pa, pb), (a, b) = at[sp.parent], at[sp.index]
            assert pa <= a <= b <= pb, sp


# -- the moe family's eager admission ----------------------------------------

@functools.lru_cache(maxsize=None)
def _moe_params(device="cpu"):
    cfg = configs.get("mixtral-8x7b", smoke=True)
    return cfg, T.init_lm(cfg, seed=0, dtype=torch.float32, device=device)


MOE_PROMPT = tuple(np.random.RandomState(4).randint(1, 256, 32).tolist())


def _dropped_by_the_rule(logits, top_k, capacity):
    """(routed pairs, dropped pairs) of one dispatch, from its logits: a
    pair is kept iff fewer than ``capacity`` earlier tokens of its group
    picked its expert."""
    idx = torch.topk(torch.softmax(logits.float(), -1), top_k, -1).indices
    picked = torch.nn.functional.one_hot(idx, logits.shape[-1]).sum(2)
    rank = torch.cumsum(picked, 1) - 1
    keep = (picked > 0) & (rank < capacity)
    return int(picked.sum()), int(picked.sum() - keep.sum())


def test_moe_admission_counts_what_the_capacity_rule_dropped(monkeypatch):
    """A request with a budget of 1 finishes at its admission, so only
    the prefill dispatches: the counts on its ``engine.admit`` span and in
    ``stats`` are the capacity rule's over the logits each layer routed,
    and each layer's dispatch is one ``moe.dispatch`` span inside
    ``admit.prefill``."""
    cfg, params = _moe_params()
    seen = []
    real = MOE._dispatch_tensors

    def spy(logits, top_k, capacity):
        seen.append((logits.detach().clone(), top_k, capacity))
        return real(logits, top_k, capacity)
    monkeypatch.setattr(MOE, "_dispatch_tensors", spy)
    eng = engine.ServingEngine(params, cfg, n_slots=1, seq_cap=64,
                               device="cpu")
    eng.submit(list(MOE_PROMPT), 1)
    eng.run()
    assert len(seen) == cfg.n_layers
    pairs, dropped = map(sum, zip(*(_dropped_by_the_rule(*d)
                                    for d in seen)))
    assert pairs == len(MOE_PROMPT) * cfg.top_k * cfg.n_layers
    assert dropped > 0
    admit, = _closed("engine.admit")
    assert (admit.attrs["moe_pairs"], admit.attrs["moe_dropped"]) == (
        pairs, dropped)
    assert (eng.stats["moe_pairs"], eng.stats["moe_dropped"]) == (
        pairs, dropped)
    prefill, = _closed("admit.prefill")
    dispatch = _closed("moe.dispatch")
    assert len(dispatch) == cfg.n_layers
    assert all(sp.parent == prefill.index for sp in dispatch)


def test_decode_steps_count_nothing():
    """The decode step routes each token on its own (never dropped) and
    counts nothing, in an admitting step as in a decode-only one."""
    cfg, params = _moe_params()
    eng = engine.ServingEngine(params, cfg, n_slots=1, seq_cap=64,
                               device="cpu")
    eng.submit(list(MOE_PROMPT), 6)
    eng.step()                          # the admission and one decode
    counts = (eng.stats["moe_pairs"], eng.stats["moe_dropped"])
    assert counts[0] == len(MOE_PROMPT) * cfg.top_k * cfg.n_layers
    eng.run()
    assert eng.stats["steps"] > 2 and eng.stats["finished"] == 1
    assert (eng.stats["moe_pairs"], eng.stats["moe_dropped"]) == counts
    admits = _closed("engine.admit")
    assert len(admits) == 1
    for sp in _closed("engine.step")[1:]:
        assert sp.attrs["admitted"] == 0 and "moe_pairs" not in sp.attrs
    # the eager decode steps' dispatches are spans, outside any admission
    by = {sp.index: sp for sp in _closed()}
    in_steps = [sp for sp in _closed("moe.dispatch")
                if by[by[sp.parent].parent].name == "engine.step"]
    assert len(in_steps) == cfg.n_layers * (eng.stats["steps"])


def _aten_ops(fn):
    """The aten ops ``fn()`` dispatches, in order."""
    from torch.utils._python_dispatch import TorchDispatchMode
    names = []

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            names.append(str(func))
            return func(*args, **(kwargs or {}))
    with Count():
        fn()
    return names


def test_recorder_off_admits_with_the_ops_it_had():
    """With ``enable(False)`` an moe admission dispatches the ops of the
    admission without counters (the prefill, the first token's argmax
    read alone, the slot write); with the recorder on it adds the count's
    ops and nothing else changes."""
    cfg, params = _moe_params()

    def admission(on):
        TR.enable(on)
        eng = engine.ServingEngine(params, cfg, n_slots=1, seq_cap=64,
                                   device="cpu")
        eng.submit(list(MOE_PROMPT), 4)
        return _aten_ops(eng._admit)

    def without_counters():
        eng = engine.ServingEngine(params, cfg, n_slots=1, seq_cap=64,
                                   device="cpu")

        def admit():
            toks = torch.tensor([list(MOE_PROMPT)], dtype=torch.int32)
            logits, rc = engine.prefill(params, cfg, toks)
            int(torch.argmax(logits[0, -1]))
            eng.cache = KV.write_prefill(eng.cache, 0, rc)
        return _aten_ops(admit)
    off = admission(False)
    assert off == without_counters()
    on = admission(True)
    added = collections.Counter(on) - collections.Counter(off)
    # the first token is read in the copy that reads the count
    assert set(collections.Counter(off) - collections.Counter(on)) <= {
        "aten._local_scalar_dense.default"}
    assert added["aten.count_nonzero.default"] == cfg.n_layers
    assert added["aten.stack.default"] == 1


@pytest.mark.cuda
def test_captured_moe_step_same_with_the_recorder_on_and_off():
    """The moe engine's captured decode step launches the same kernels,
    kernel 1 as often, with the recorder on and off; only the eager
    admission counts, and only with the recorder on."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the captured step runs there")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.train.trainer import apply_masks
    cfg = configs.get("mixtral-8x7b", smoke=True)
    p = T.init_lm(cfg, seed=0, dtype=torch.float32, device="cpu")
    masks = RW.magnitude_block_masks(p, CLI.SPARSE_SPEC, None, rate=0.6)
    exec_p, _ = C.compile_model(apply_masks(p, masks), masks,
                                CLI.SPARSE_SPEC,
                                spec=C.CompileSpec(keep_dense=False),
                                device="cuda")
    kernels, launches, counts = {}, {}, {}
    for on in (True, False):
        TR.reset()
        TR.enable(on)
        eng = engine.ServingEngine(exec_p, cfg, n_slots=4, seq_cap=64)
        for n in (32, 17, 9):
            eng.submit(list(MOE_PROMPT[:n]), 8)
        eng.step()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                eng._graph.replay()
            torch.cuda.synchronize()
        kernels[on] = collections.Counter(
            e.name for e in prof.events() if e.device_type == DeviceType.CUDA)
        launches[on] = eng._replay_launches
        counts[on] = (eng.stats["moe_pairs"], len(_closed("moe.dispatch")))
    assert kernels[True] == kernels[False]
    assert sum(kernels[True].values()) > 0
    assert launches[True] == launches[False] == {
        "bsr_matmul": 7 * cfg.n_layers}
    # three eager admissions, one dispatch a layer each, plus the
    # uncaptured warm-up step's
    assert counts[True] == ((32 + 17 + 9) * cfg.top_k * cfg.n_layers,
                            4 * cfg.n_layers)
    assert counts[False] == (0, 0)
