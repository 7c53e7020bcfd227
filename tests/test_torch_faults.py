"""The port's chaos injectors (``testing.faults``) and degraded mode
against the reference's (``tests/test_faults.py``), yi-9b SMOKE in fp32
and VGG_TINY, weights crossed from the reference:

- ``bitflip_packed_leaf`` gives the reference's ``FaultRecord`` and the
  same corrupt leaf for seeds 0-4, float and int8 trees; its walk is
  pinned to sorted keys, so the port's own (insertion-ordered) trees give
  the same records;
- the engine retires the corrupt layout (``validate=True``, the default)
  and emits the reference's degraded engine's tokens, each equal to a
  B = 1 ``generate`` over the degraded tree; without ``w`` it raises;
- VGG_TINY punched and pattern with one retired layer give the
  reference's degraded logits;
- the chaos matrix replays identically and equals the reference's run;
- ``nan_slot``, ``expire_deadline`` and ``crash_publish`` as in the
  reference."""
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.core import reweighted as ref_RW  # noqa: E402
from repro.launch.serve import SPARSE_SPEC as REF_SPEC  # noqa: E402
from repro.models import convnet as ref_CN  # noqa: E402
from repro.models import module as ref_module  # noqa: E402
from repro.models import transformer as ref_T  # noqa: E402
from repro.serve import compile as ref_C  # noqa: E402
from repro.serve import engine as ref_engine  # noqa: E402
from repro.testing import faults as ref_F  # noqa: E402
from repro.train.trainer import apply_masks as ref_apply_masks  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core import reweighted as RW  # noqa: E402
from repro_torch.core import validate as V  # noqa: E402
from repro_torch.core.packed import DegradedLayer  # noqa: E402
from repro_torch.launch.serve import SPARSE_SPEC  # noqa: E402
from repro_torch.models import convnet as CN  # noqa: E402
from repro_torch.models import module as M  # noqa: E402
from repro_torch.serve import artifacts as ART  # noqa: E402
from repro_torch.serve import compile as C  # noqa: E402
from repro_torch.serve import engine  # noqa: E402
from repro_torch.testing import faults as F  # noqa: E402
from repro_torch.train.trainer import apply_masks  # noqa: E402

from test_torch_reference import to_port  # noqa: E402

CONV_TOL = 1e-5          # the conv tests' fp32 bound (test_torch_conv.py)
CONV_RE = r"(^|/)(c|pw|dw)\d+/w"


@functools.lru_cache(maxsize=None)
def _lm():
    """yi-9b SMOKE in fp32: (ref cfg, port cfg, reference params, the
    port's crossing of them)."""
    rcfg = ref_configs.get("yi-9b", smoke=True)
    pcfg = configs.get("yi-9b", smoke=True)
    rparams = ref_module.cast_tree(ref_T.init_lm(jax.random.PRNGKey(0),
                                                 rcfg), jnp.float32)
    return rcfg, pcfg, rparams, to_port(rparams)


@functools.lru_cache(maxsize=None)
def _packed(value_dtype=None):
    """The masked model compiled by both packages with ``keep_dense=True``
    (every packed layer keeps the masked-dense ``w`` degrading needs):
    (reference exec tree, report, port exec tree, report)."""
    _, _, rparams, _ = _lm()
    rmasks = ref_RW.magnitude_block_masks(rparams, REF_SPEC, None, rate=0.6)
    rpm = ref_apply_masks(rparams, rmasks)
    rexec, rrep = ref_C.compile_model(
        rpm, rmasks, REF_SPEC,
        spec=ref_C.CompileSpec(keep_dense=True, value_dtype=value_dtype))
    pexec, prep = C.compile_model(
        to_port(rpm), to_port(rmasks), SPARSE_SPEC,
        spec=C.CompileSpec(keep_dense=True, value_dtype=value_dtype),
        device="cpu")
    return rexec, rrep, pexec, prep


def _prompts(vocab, lens, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, vocab, size=n).tolist() for n in lens]


def _oracle(params, cfg, prompt, n_new):
    return engine.generate(params, cfg, np.asarray([prompt]), n_new,
                           device="cpu")[0].tolist()


def _node(tree, path):
    for part in path.split("/"):
        tree = tree[part]
    return tree


def _bits(t):
    """A float tensor's raw words (NaN compares equal to itself)."""
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def _reversed(tree):
    """The same tree with every dict's keys in reverse insertion order."""
    if not isinstance(tree, dict):
        return tree
    return {k: _reversed(tree[k]) for k in reversed(list(tree))}


# -- corrupt_leaf ----------------------------------------------------------------

@pytest.mark.parametrize("value_dtype", [None, "int8"])
def test_bitflip_records_equal_the_references(value_dtype):
    """Seeds 0-4: the same record, and the same corrupt leaf bit for bit;
    the port's walk ignores its trees' key order."""
    rexec, _, pexec, _ = _packed(value_dtype)
    for seed in range(5):
        rbad, rrec = ref_F.bitflip_packed_leaf(rexec, seed=seed)
        pbad, prec = F.bitflip_packed_leaf(pexec, seed=seed)
        assert (prec.kind, prec.target, prec.detail) == \
            (rrec.kind, rrec.target, rrec.detail)
        _, again = F.bitflip_packed_leaf(_reversed(pexec), seed=seed)
        assert again == prec
        rlay = _node(rbad, rrec.target)["packed"]
        play = _node(pbad, prec.target)["packed"]
        field = "values" if value_dtype is None else "k_idx"
        for p, r in zip(getattr(play, field), getattr(rlay, field)):
            r = np.asarray(r)
            if field == "values":
                r = torch.from_numpy(r.view(np.int16 if r.itemsize == 2
                                            else np.int32).copy())
                assert torch.equal(_bits(p), r)
            else:
                np.testing.assert_array_equal(p.numpy(), r)
        with pytest.raises(V.LayoutError) as ei:
            V.validate_layout(play, path=prec.target)
        assert ei.value.code == ("non_finite" if value_dtype is None
                                 else "index_range")
        # the input tree is skeleton-copied: the healthy original passes
        assert V.validate_tree(pexec) == 7


def test_degraded_engine_emits_the_references_tokens():
    """One retired stack (seed 3, as the reference's test): the engine
    counts it, marks its report row, and its tokens equal the reference's
    degraded engine's and a B = 1 ``generate`` over the degraded tree."""
    rcfg, pcfg, _, _ = _lm()
    rexec, rrep, pexec, prep = _packed()
    bad, rec = F.bitflip_packed_leaf(pexec, seed=3)
    rbad, _ = ref_F.bitflip_packed_leaf(rexec, seed=3)
    prompts = _prompts(pcfg.vocab, [8, 5], seed=4)

    eng = engine.ServingEngine(bad, pcfg, n_slots=2, seq_cap=32,
                               report=prep, device="cpu")
    assert eng.stats["degraded_layers"] == 1
    marker = _node(eng.params, rec.target)["packed"]
    assert isinstance(marker, DegradedLayer)
    assert marker.code == "non_finite" and marker.path == rec.target
    rows = [r for r in eng.report if r.degraded]
    assert len(rows) == 1 and rows[0].path == f"{rec.target}/w"
    assert "masked-dense" in rows[0].reason
    assert "[DEGRADED -> masked-dense]" in C.compiled_summary(eng.report)
    rids = [eng.submit(p, 5) for p in prompts]
    eng.run()
    assert eng.stats["finished"] == 2
    toks = [eng.requests[r].tokens for r in rids]
    assert toks == [_oracle(eng.params, pcfg, p, 5) for p in prompts]

    reng = ref_engine.ServingEngine(rbad, rcfg, n_slots=2, seq_cap=32,
                                    report=rrep)
    assert reng.stats["degraded_layers"] == 1
    ref_rids = [reng.submit(p, 5) for p in prompts]
    reng.run()
    assert toks == [reng.requests[r].tokens for r in ref_rids]


def test_clean_tree_validates_by_default_and_serves_unchanged():
    _, pcfg, _, _ = _lm()
    _, _, pexec, _ = _packed()
    prompts = _prompts(pcfg.vocab, [6, 9], seed=2)
    out = []
    for validate in (True, False):
        eng = engine.ServingEngine(pexec, pcfg, n_slots=2, seq_cap=32,
                                   validate=validate, device="cpu")
        assert eng.stats["degraded_layers"] == 0
        rids = [eng.submit(p, 4) for p in prompts]
        eng.run()
        out.append([eng.requests[r].tokens for r in rids])
    assert out[0] == out[1]


def test_corrupt_layout_without_dense_fallback_raises():
    """No ``w`` beside the corrupt layout: degrading raises, and so does an
    engine over it; never a silent wrong result."""
    _, pcfg, _, _ = _lm()
    _, _, pexec, _ = _packed()
    bad, rec = F.bitflip_packed_leaf(pexec, seed=0)
    node = _node(bad, rec.target)
    stripped = F._skeleton_swap(
        bad, node, {k: v for k, v in node.items() if k != "w"})
    with pytest.raises(V.LayoutError):
        C.degrade_invalid_layers(stripped)
    with pytest.raises(V.LayoutNumericsError):
        engine.ServingEngine(stripped, pcfg, device="cpu")


def test_degraded_layer_marker_is_static_and_retires_its_stack():
    m = DegradedLayer(path="layers/attn/wq", code="non_finite", detail="x")
    assert m == DegradedLayer("layers/attn/wq", "non_finite", "x")
    assert hash(m) == hash(DegradedLayer("layers/attn/wq", "non_finite",
                                         "x"))
    assert not any(isinstance(v, torch.Tensor) for v in vars(m).values())
    tree = {"packed": m, "w": torch.zeros(3, 4, 4)}
    one = M.take_layer(tree, 2)
    assert one["packed"] is m and one["w"].shape == (4, 4)


# -- VGG_TINY with one retired layer ---------------------------------------------

@pytest.mark.parametrize("mapping", ["punched", "pattern"])
def test_vgg_with_a_retired_layer_gives_the_references_logits(mapping):
    """The masks are the port's (equal to the reference's,
    ``tests/test_torch_conv.py``), crossed to the reference; each package
    compiles, retires the seed-0 layer and runs one 8x8 image (the
    reference's forward jitted: its interpret-mode kernels run op by op
    otherwise)."""
    scheme = ("block_punched", {"block": (8, 8)}) if mapping == "punched" \
        else ("pattern", {"connectivity": 0.5})
    rspec = [(CONV_RE, ref_RW.SchemeChoice(scheme[0], **scheme[1]))]
    pspec = [(CONV_RE, RW.SchemeChoice(scheme[0], **scheme[1]))]
    rparams = ref_CN.convnet_init(jax.random.PRNGKey(0), ref_CN.VGG_TINY,
                                  dtype=jnp.float32)
    pparams = to_port(rparams)
    pmasks = (RW.punched_conv_masks(pparams, pspec, (8, 8), rate=0.5)
              if mapping == "punched" else RW.masks_for_spec(pparams, pspec))
    rmasks = M.tree_map(lambda m: jnp.asarray(m.float().numpy()), pmasks)
    rexec, _ = ref_C.compile_model(ref_apply_masks(rparams, rmasks), rmasks,
                                   rspec,
                                   spec=ref_C.CompileSpec(keep_dense=True))
    pexec, _ = C.compile_model(apply_masks(pparams, pmasks), pmasks, pspec,
                               spec=C.CompileSpec(keep_dense=True),
                               device="cpu")
    rbad, rrec = ref_F.bitflip_packed_leaf(rexec, seed=0)
    pbad, prec = F.bitflip_packed_leaf(pexec, seed=0)
    assert (prec.target, prec.detail) == (rrec.target, rrec.detail)
    rtree, _, rdeg = ref_C.degrade_invalid_layers(rbad)
    ptree, _, pdeg = C.degrade_invalid_layers(pbad)
    assert [p for p, _ in pdeg] == [p for p, _ in rdeg] == [prec.target]
    assert sum(isinstance(n.get("packed"), DegradedLayer)
               for n in ptree.values()) == 1
    x = np.random.RandomState(14).randn(1, 8, 8, 3).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, x: ref_CN.convnet_apply(
        p, x, ref_CN.VGG_TINY))(rtree, jnp.asarray(x)))
    got = CN.convnet_apply(ptree, torch.from_numpy(x), CN.VGG_TINY)
    assert np.isfinite(want).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=CONV_TOL,
                               atol=CONV_TOL)


# -- the chaos matrix --------------------------------------------------------------

def _chaos_run(make, F_, params, cfg, prompts):
    """The reference's scenario: TTL expiry, a deadline eviction, retry
    exhaustion and a mid-flight NaN slot, at fixed steps."""
    eng = make(params, cfg, n_slots=2, seq_cap=32, max_queue=2)
    rids = [
        eng.submit(prompts[0], 6),
        eng.submit(prompts[1], 6, deadline_steps=3),
        eng.submit(prompts[2], 6, queue_ttl=1),
        eng.submit(prompts[3], 6, retries=1, backoff=1),
        eng.submit(prompts[4], 6),
    ]
    eng.step()
    F_.nan_slot(eng, eng.requests[rids[0]].slot)
    eng.run()
    toks = {r: list(eng.requests[r].tokens) for r in rids}
    status = {r: eng.requests[r].status for r in rids}
    stats = {k: v for k, v in eng.stats.items() if k != "graph_captures"}
    return list(eng.sched.events), toks, status, stats


def test_chaos_matrix_replays_identically_and_equals_the_references():
    rcfg, pcfg, rparams, pparams = _lm()
    prompts = _prompts(pcfg.vocab, [8, 6, 5, 7, 9], seed=10)
    port = functools.partial(engine.ServingEngine, device="cpu")
    a = _chaos_run(port, F, pparams, pcfg, prompts)
    assert a == _chaos_run(port, F, pparams, pcfg, prompts)
    assert a == _chaos_run(ref_engine.ServingEngine, ref_F, rparams, rcfg,
                           prompts)
    events, toks, status, stats = a
    assert set(status.values()) <= {"finished", "quarantined", "evicted",
                                     "expired", "rejected"}
    assert status[0] == "quarantined" and stats["quarantined"] == 1
    assert (stats["finished"] + stats["quarantined"] + stats["evicted"]
            == stats["admitted"])


def test_nan_slot_and_expire_deadline_as_the_reference():
    """A poisoned slot is quarantined alone and a zeroed deadline evicts a
    running request: the port's records, tokens and events are the
    reference's."""
    rcfg, pcfg, rparams, pparams = _lm()
    prompts = _prompts(pcfg.vocab, [8, 6, 5], seed=7)

    def drive(make, F_, params, cfg):
        eng = make(params, cfg, n_slots=2, seq_cap=32)
        rids = [eng.submit(p, 6) for p in prompts]
        eng.step()
        recs = [F_.expire_deadline(eng, rids[0]),
                F_.nan_slot(eng, eng.requests[rids[1]].slot)]
        eng.run()
        return ([(r.kind, r.target, r.detail) for r in recs],
                [(eng.requests[r].status, eng.requests[r].tokens)
                 for r in rids], eng.sched.events)
    got = drive(functools.partial(engine.ServingEngine, device="cpu"), F,
                pparams, pcfg)
    assert got == drive(ref_engine.ServingEngine, ref_F, rparams, rcfg)
    assert [s for s, _ in got[1]] == ["evicted", "quarantined", "finished"]
    assert got[1][2][1] == _oracle(pparams, pcfg, prompts[2], 6)


# -- crashed_publish ---------------------------------------------------------------

def test_crashed_publish_husk_ignored_and_torn_store_repacks(tmp_path,
                                                             caplog):
    """The staging husk never shadows a published artifact; a torn final
    directory loads as None, and the next compile repacks and serves the
    cold tree's tokens."""
    _, pcfg, _, pparams = _lm()
    pmasks = RW.magnitude_block_masks(pparams, SPARSE_SPEC, None, rate=0.6)
    pm = apply_masks(pparams, pmasks)
    spec = C.CompileSpec(keep_dense=True)
    cold, _ = C.compile_model(pm, pmasks, SPARSE_SPEC, spec=spec,
                              device="cpu", artifact_dir=tmp_path)
    key = ART.model_digest(pm, pmasks, SPARSE_SPEC, spec=spec)
    rec = F.crash_publish(tmp_path, key, stage="staging")
    assert rec == F.FaultRecord(**vars(ref_F.crash_publish(
        tmp_path / "ref", key, stage="staging")))
    assert ART.load_grafted(tmp_path, key, pm, device="cpu") is not None
    F.crash_publish(tmp_path, key, stage="torn")
    assert ART.load_grafted(tmp_path, key, pm, device="cpu") is None
    assert "[corrupt]" in caplog.text
    repacked, report = C.compile_model(pm, pmasks, SPARSE_SPEC, spec=spec,
                                       device="cpu", artifact_dir=tmp_path)
    assert len(report.packed) == 7
    prompts = _prompts(pcfg.vocab, [8, 5], seed=9)
    for p in prompts:
        assert _oracle(repacked, pcfg, p, 4) == _oracle(cold, pcfg, p, 4)
    assert F.FAULT_KINDS == ref_F.FAULT_KINDS
