"""The CUDA kernels against their plain PyTorch versions, on the card
(kernel 1 also over an MoE expert stack; every kernel also on int8
layouts, dequantized on the card; kernels 1 and 2 also through the shard
wrappers over tensor-parallel layouts), and the data draws, equal on the
CPU and the card.

Every test here is marked ``cuda`` and skips without a card (the kernel
has no CPU mode).  This file imports neither jax nor the JAX package, so
it runs on the card's machine:

  PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.core import reweighted as RW  # noqa: E402
from repro_torch.kernels import bsr_matmul as K  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serve import compile as C  # noqa: E402
from repro_torch.serve import engine  # noqa: E402
from repro_torch.data.pipeline import synthetic_batch  # noqa: E402
from repro_torch.models import module as M  # noqa: E402
from repro_torch.train import trainer  # noqa: E402
from repro_torch.train.trainer import apply_masks  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _layout(dev, K_, N_, block, dtype, reorder, seed=0, gran=None):
    rng = np.random.RandomState(seed)
    bk, bn = block
    live = rng.rand(K_ // bk, N_ // bn) < 0.4
    live[:, -1] = True
    mask = torch.from_numpy(np.repeat(np.repeat(live, bk, 0), bn, 1)).to(dev)
    w = torch.from_numpy(rng.randn(K_, N_).astype(np.float32)).to(dev, dtype)
    return ops.pack(w, mask, block, reorder=reorder,
                    value_dtype=gran and "int8",
                    scale_granularity=gran or "block"), w * mask.to(dtype)


def _kernel_vs_plain(dev, M, K_, N_, block, dtype, gran=None, seed=None):
    lay, _ = _layout(dev, K_, N_, block, dtype, reorder=True, gran=gran)
    unre, _ = _layout(dev, K_, N_, block, dtype, reorder=False, gran=gran)
    if seed is None:
        x = torch.randn(M, K_, device=dev).to(dtype)
        b = torch.randn(N_, device=dev).to(dtype)
    else:       # drawn on the host from a seeded generator: reproducible
        gen = torch.Generator().manual_seed(seed)
        x = torch.randn(M, K_, generator=gen).to(dev, dtype)
        b = torch.randn(N_, generator=gen).to(dev, dtype)
    for act in ("none", "silu", "relu"):
        before = K.LAUNCHES["bsr_matmul"]
        y = K.bsr_matmul_packed(x, lay, bias=b, act=act)
        torch.cuda.synchronize()
        assert K.LAUNCHES["bsr_matmul"] - before == 1
        assert torch.equal(y, K.bsr_matmul_packed(x, unre, bias=b, act=act))
        want = ref.bsr_matmul_packed_ref(x.float(), lay, b.float(), act)
        tol = 1e-4 if dtype == torch.float32 else 1e-2
        torch.testing.assert_close(y.float(), want, rtol=tol, atol=tol)


# the rule mapper's blocks (core.mapper_rule.map_rules: (256, 256) on every
# full-width LM projection, (32, 64) / (64, 128) / (128, 32) at SMOKE,
# (128, 128) from the block menu), each also with int8 values
MAPPER_BLOCKS = [(32, 64), (64, 128), (128, 32), (128, 128), (256, 256)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("block,values", [
    (b, None) for b in [(16, 16), (8, 16), (4, 4), (16, 32), (16, 8)]
    + MAPPER_BLOCKS] + [(b, "int8") for b in MAPPER_BLOCKS])
@pytest.mark.parametrize("M", [1, 4, 8, 15, 16, 17, 129])
def test_kernel_matches_plain(cuda, M, block, values, dtype):
    """At the plan's path boundaries (M tiles of 16, 32 and 128 rows, the
    tensor-core path and the FMA path; (16, 8) is the tensor-core tile of
    one n8 fragment a warp) and at the engine's step (M = 8 slots), one
    launch over all bins; a block that does not tile (256, 384) runs at
    (512, 768)."""
    K_, N_ = ((256, 384) if 256 % block[0] == 0 and 384 % block[1] == 0
              else (512, 768))
    _kernel_vs_plain(cuda, M, K_, N_, block, dtype,
                     gran=values and "block")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,block", [((1600, 320), (16, 16)),
                                         ((1600, 6464), (16, 8)),
                                         ((2048, 8512), (16, 8))])
@pytest.mark.parametrize("M", [4, 129])
def test_kernel_matches_plain_at_ssm_and_hybrid_widths(cuda, M, shape, block,
                                                       dtype):
    """Column counts of the SSM/hybrid path: hymba's wk/wv (20 block
    columns, a launch of few blocks), hymba's and mamba2's in_proj (808
    and 1064 block columns of 8)."""
    _kernel_vs_plain(cuda, M, *shape, block, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_chunked_columns_replay_in_a_cuda_graph(cuda, dtype):
    """A deep layout whose columns are cut into chunks (the per-tile
    counters pick the last block, which resets them): eager and replayed
    calls give the same bits, and the counters are 0 after each."""
    lay, _ = _layout(cuda, 4096, 256, (16, 16), dtype, reorder=True)
    x = torch.randn(4, 4096, device=cuda).to(dtype)
    plan = K.bsr_plan(4, 4096, 256, dtype, 16, 16)
    assert K._bsr_bins(lay, plan, x.device).ws_floats > 0
    want = K.bsr_matmul_packed(x, lay, act="silu")
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        y = K.bsr_matmul_packed(x, lay, act="silu")
    for _ in range(3):
        g.replay()
        torch.cuda.synchronize()
        assert torch.equal(y, want)
        assert int(K._COUNTERS[x.device].abs().sum()) == 0
    torch.testing.assert_close(
        want.float(), ref.bsr_matmul_packed_ref(x.float(), lay, None,
                                                "silu"),
        rtol=1e-2, atol=1e-2)


def test_single_bin_and_no_bias(cuda):
    lay, dense = _layout(cuda, 128, 64, (16, 16), torch.float32, False)
    x = torch.randn(5, 128, device=cuda)
    assert lay.n_bins == 1
    y = K.bsr_matmul_packed(x, lay)
    torch.testing.assert_close(y, x @ dense, rtol=1e-4, atol=1e-4)


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    lay, _ = _layout(cuda, 128, 64, (16, 16), torch.float32, False)
    x = torch.randn(5, 128, device=cuda)
    with pytest.raises(TypeError):
        K.bsr_matmul_packed(x.to(torch.bfloat16), lay)       # dtype mix
    with pytest.raises(ValueError):
        K.bsr_matmul_packed(x[:, :64], lay)                   # K mismatch
    with pytest.raises(ValueError):
        K.bsr_matmul_packed(x.t().contiguous().t(), lay)      # strides
    with pytest.raises(ValueError):
        K.bsr_matmul_packed(x, lay, act="gelu")


def test_generate_on_card_matches_cpu(cuda):
    """fp32 yi-9b SMOKE, pruned and compiled: the card's greedy tokens
    equal the CPU plain path's, through the kernel at every projection."""
    cfg = configs.get("yi-9b", smoke=True)
    spec = [(r"(attn/w[qkvo]|ffn/(gate|up|down))/w",
             RW.SchemeChoice("block", (16, 16)))]
    tokens = np.random.RandomState(0).randint(0, cfg.vocab, size=(2, 8))
    outs = {}
    for dev in ("cpu", "cuda"):
        p = T.init_lm(cfg, seed=0, dtype=torch.float32, device="cpu")
        masks = RW.magnitude_block_masks(p, spec, None, rate=0.6)
        exec_p, _ = C.compile_model(apply_masks(p, masks), masks, spec,
                                    spec=C.CompileSpec(keep_dense=False),
                                    device=dev)
        assert sum(1 for g in ("attn", "ffn")
                   for node in exec_p["layers"][g].values()
                   if "packed" in node) == 7
        K.reset_launches()
        outs[dev] = engine.generate(exec_p, cfg, tokens, 10,
                                    device=dev).cpu()
        launches = K.LAUNCHES["bsr_matmul"]
        assert launches == (cfg.n_layers * 7 * 11 if dev == "cuda" else 0)
    assert torch.equal(outs["cuda"], outs["cpu"])


# the penalised leaves of the training tests: (8, 16) blocks on the
# attention, FFN / expert projections and the head, (16, 8) on the SSM
# mixers' in/out_proj
TRAIN_SPEC = [(r"(attn/w[qkvo]|(ffn|moe)/(gate|up|down))/w",
               RW.SchemeChoice("block", (8, 16))),
              (r"ssm/(in|out)_proj/w", RW.SchemeChoice("block", (16, 8))),
              (r"head/table", RW.SchemeChoice("block", (8, 16)))]


def _train_case(arch):
    """fp32 SMOKE params (seed 0), masks at rate 0.5, alphas from the
    params and one batch (B = 2, S = 16), all on the CPU."""
    cfg = configs.get(arch, smoke=True)
    p = T.init_lm(cfg, seed=0, dtype=torch.float32, device="cpu")
    return (cfg, p, RW.masks_for_spec(p, TRAIN_SPEC, default_rate=0.5),
            RW.update_alphas(p, RW.ReweightedConfig(spec=tuple(TRAIN_SPEC))),
            synthetic_batch(0, 0, 2, 16, cfg.vocab, device="cpu"))


def _to(tree, dev):
    return M.tree_map(lambda t: t.to(dev), tree)


@pytest.mark.parametrize("arch", ["yi-9b", "mixtral-8x7b", "mamba2-1.3b",
                                  "hymba-1.5b"])
@pytest.mark.parametrize("with_", ["masks", "alphas"])
def test_train_loss_and_grads_on_card_match_cpu(cuda, arch, with_,
                                                monkeypatch):
    """fp32 SMOKE, TF32 off: the loss (with masks, or with the penalty's
    alphas) and its grads by autograd on the card equal the CPU's: loss
    within 1e-5 relative, each leaf's grads within 1e-5 of its max |g|
    (the SSD decay A_log within 3e-5: its grads cancel, see
    test_torch_train.py)."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg, p, masks, alphas, batch = _train_case(arch)
    f = trainer.value_and_grad(trainer.make_loss_fn(
        cfg, reweighted=RW.ReweightedConfig(spec=tuple(TRAIN_SPEC),
                                            lam=1e-3)))
    args = (masks, None) if with_ == "masks" else (None, alphas)
    (want, _), want_g = f(p, batch, *args)
    (got, _), got_g = f(_to(p, cuda), _to(batch, cuda),
                        *(_to(a, cuda) if a is not None else None
                          for a in args))
    assert float(got) == pytest.approx(float(want), rel=1e-5)

    def check(g, w, path=""):
        if isinstance(w, dict):
            for k in w:
                check(g[k], w[k], f"{path}/{k}")
            return
        tol = 3e-5 if path.endswith("ssm/A_log") else 1e-5
        torch.testing.assert_close(g.cpu(), w, rtol=0,
                                   atol=tol * float(w.abs().max()) + 1e-30,
                                   msg=path)
    check(got_g, want_g)


def test_train_steps_on_card_match_cpu(cuda, monkeypatch):
    """Three AdamW steps of yi-9b SMOKE (fp32, TF32 off, lr 3e-3, masks)
    on the card and on the CPU: each step's loss within 1e-4."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg, p, masks, _, _ = _train_case("yi-9b")
    init, step = trainer.make_train_step(cfg, lr=3e-3)
    runs = {}
    for dev in ("cpu", "cuda"):
        params, state, losses = _to(p, dev), init(_to(p, dev)), []
        for s in range(3):
            batch = _to(synthetic_batch(0, s, 4, 16, cfg.vocab,
                                        device="cpu"), dev)
            params, state, m = step(params, state, batch, _to(masks, dev))
            losses.append(float(m["loss"]))
        runs[dev] = losses
    assert runs["cuda"] == pytest.approx(runs["cpu"], abs=1e-4)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M", [4, 128])
def test_kernel_at_the_trained_block_and_yi9b_width(cuda, M, dtype, seed):
    """(8, 16) blocks (the train CLI's snapped block, kernel 1's FMA path
    in bf16) at yi-9b's gate / up shape (4096, 11008); x and the bias
    from a seeded generator, several seeds, so a failure reproduces."""
    _kernel_vs_plain(cuda, M, 4096, 11008, (8, 16), dtype, seed=seed)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kernel1_is_deterministic_at_the_trained_block(cuda, seed):
    """Kernel 1 launched twice on the same input at the flaky case's
    shape ((8, 16), fp32, yi-9b's gate, M = 128) gives the same bits:
    whether its chunked column reduction is deterministic run to run."""
    lay, _ = _layout(cuda, 4096, 11008, (8, 16), torch.float32,
                     reorder=True)
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(128, 4096, generator=gen).to(cuda)
    b = torch.randn(11008, generator=gen).to(cuda)
    first = K.bsr_matmul_packed(x, lay, bias=b, act="silu")
    for _ in range(3):
        again = K.bsr_matmul_packed(x, lay, bias=b, act="silu")
        torch.cuda.synchronize()
        assert torch.equal(first, again), \
            int((first != again).sum())


MESH_CHECK = """
import json, sys, torch
from repro_torch.distributed import sharding as SH
from repro_torch.kernels import bsr_matmul as K, ops
from repro_torch.launch import mesh as MESH
from repro_torch.serve.compile import _pack_stacked
import numpy as np
mesh = MESH.make_local_mesh()
rng = np.random.RandomState(0)
out = {"mesh": [list(mesh.mesh_dim_names), list(mesh.shape)],
       "backend": torch.distributed.get_backend()}
for dtype in (torch.float32, torch.bfloat16):
    K_, N_, bk = 4096, 512, 16
    live = rng.rand(K_ // bk, N_ // bk) < 0.4
    mask = torch.from_numpy(np.kron(live, np.ones((bk, bk), bool))).cuda()
    w = torch.from_numpy(rng.randn(K_, N_).astype(np.float32)).cuda()
    w = w.to(dtype)
    x = torch.from_numpy(rng.randn(7, K_).astype(np.float32)).cuda()
    x = x.to(dtype)
    sharded = ops.pack(w, mask, (bk, bk), n_shards=4)
    placed = SH.place_layout(sharded, mesh)
    K.reset_launches()
    want = ops.sparse_linear(x, sharded, act="silu")
    before = dict(K.LAUNCHES)
    got = SH.full(ops.sparse_linear(SH.place(x, mesh, ()), placed,
                                    act="silu"))
    torch.cuda.synchronize()
    lin = {k: K.LAUNCHES[k] - before[k] for k in K.LAUNCHES
           if K.LAUNCHES[k] != before[k]}
    E = 8
    we = torch.from_numpy(rng.randn(E, 256, 512).astype(np.float32))
    me = torch.from_numpy(np.kron(rng.rand(E, 16, 32) < 0.5,
                                  np.ones((16, 16), bool)))
    stack, _ = _pack_stacked(we.to(dtype).cuda(), me.cuda(), (16, 16))
    xe = torch.from_numpy(rng.randn(E, 5, 256).astype(np.float32)).cuda()
    xe = xe.to(dtype)
    want_e = ops.sparse_expert_linear(xe, stack)
    before = dict(K.LAUNCHES)
    got_e = SH.full(ops.sparse_expert_linear(
        SH.place(xe, mesh, ("model",)),
        SH.place_layout(stack, mesh, SH.expert_layout_specs(stack))))
    torch.cuda.synchronize()
    exp = {k: K.LAUNCHES[k] - before[k] for k in K.LAUNCHES
           if K.LAUNCHES[k] != before[k]}
    out[str(dtype)] = {"linear_equal": bool(torch.equal(got, want)),
                       "linear_launches": lin,
                       "expert_equal": bool(torch.equal(got_e, want_e)),
                       "expert_launches": exp}
MESH.close_local_mesh()
print(json.dumps(out))
"""


def test_one_rank_mesh_launches_equal_the_unmeshed_ones(cuda):
    """On the one-rank NCCL mesh (``make_local_mesh()``, in a subprocess:
    no group starts in the test process), a column-sharded layout placed
    by ``place_layout`` and an expert stack placed by
    ``expert_layout_specs`` give the un-meshed launches' bits, one
    launch each, and start and end their group."""
    import json
    import os
    import subprocess
    import sys
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                       "src")
    env = dict(os.environ, PYTHONPATH=src)
    run = subprocess.run([sys.executable, "-c", MESH_CHECK], env=env,
                         capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    out = json.loads(run.stdout.strip().splitlines()[-1])
    assert out["mesh"] == [["data", "model"], [1, 1]]
    assert out["backend"] == "nccl"
    for dtype in ("torch.float32", "torch.bfloat16"):
        r = out[dtype]
        assert r["linear_equal"] and r["expert_equal"], r
        assert r["linear_launches"] == {"bsr_matmul_sharded": 1}, r
        assert r["expert_launches"] == {"bsr_matmul": 1}, r


@pytest.mark.parametrize("arch,per_layer", [("mamba2-1.3b", 2),
                                            ("hymba-1.5b", 9)])
def test_ssm_generate_on_card_matches_cpu(cuda, arch, per_layer):
    """fp32 mamba2 / hymba SMOKE under the serving spec ((16, 8) blocks on
    the SSM in/out projections): the card's greedy tokens equal the CPU
    plain path's, kernel 1 launched once a packed projection a forward."""
    from repro_torch.launch.serve import SPARSE_SPEC
    cfg = configs.get(arch, smoke=True)
    tokens = np.random.RandomState(0).randint(0, cfg.vocab, size=(2, 8))
    outs = {}
    for dev in ("cpu", "cuda"):
        p = T.init_lm(cfg, seed=0, dtype=torch.float32, device="cpu")
        masks = RW.magnitude_block_masks(p, SPARSE_SPEC, None, rate=0.6)
        exec_p, report = C.compile_model(
            apply_masks(p, masks), masks, SPARSE_SPEC,
            spec=C.CompileSpec(keep_dense=False), device=dev)
        assert len(report.packed) == per_layer
        K.reset_launches()
        outs[dev] = engine.generate(exec_p, cfg, tokens, 10,
                                    device=dev).cpu()
        launches = K.LAUNCHES["bsr_matmul"]
        assert launches == (cfg.n_layers * per_layer * 11
                            if dev == "cuda" else 0)
    assert torch.equal(outs["cuda"], outs["cpu"])


# -- the continuous-batching engine's captured step --------------------------

def _engine_model(family, dev):
    """fp32 SMOKE params of ``family`` under the serving spec, compiled on
    ``dev`` (``keep_dense=False``)."""
    from repro_torch.launch.serve import SPARSE_SPEC
    arch = {"dense": "yi-9b", "moe": "mixtral-8x7b",
            "hybrid": "hymba-1.5b"}[family]
    cfg = configs.get(arch, smoke=True)
    p = T.init_lm(cfg, seed=0, dtype=torch.float32, device="cpu")
    masks = RW.magnitude_block_masks(p, SPARSE_SPEC, None, rate=0.6)
    exec_p, _ = C.compile_model(apply_masks(p, masks), masks, SPARSE_SPEC,
                                spec=C.CompileSpec(keep_dense=False),
                                device=dev)
    return cfg, exec_p


@pytest.mark.parametrize("family", ["dense", "moe", "hybrid"])
def test_engine_graph_replay_equals_eager_step(cuda, family):
    """One capture per engine; the first replayed step, after admissions
    into slots 0-2 of 4, equals the eager ``decode_step_ragged`` on a copy
    of the same cache, bitwise (logits, next tokens, the finite probe).
    The capture leaves the kernel-1 count at the warm-up step's launches,
    and the replay adds them once."""
    cfg, exec_p = _engine_model(family, cuda)
    before = K.LAUNCHES["bsr_matmul"]
    eng = engine.ServingEngine(exec_p, cfg, n_slots=4, seq_cap=32)
    per_step = K.LAUNCHES["bsr_matmul"] - before
    assert eng.stats["graph_captures"] == 1 and per_step > 0
    assert eng._replay_launches == {"bsr_matmul": per_step}
    rng = np.random.RandomState(0)
    for n in (8, 12, 5):
        eng.submit(rng.randint(1, cfg.vocab, size=n).tolist(), 6)
    eng._admit()
    copy = {g: {k: t.clone() for k, t in d.items()}
            for g, d in eng.cache.items()}
    ops_ = torch.as_tensor(eng._ops, device=cuda)
    with torch.no_grad():
        want, _ = T.decode_step_ragged(exec_p, cfg, ops_[0][:, None], copy,
                                       ops_[1][:, None], ops_[2])
    before = K.LAUNCHES["bsr_matmul"]
    nxt, ok = eng._run()
    torch.cuda.synchronize()
    assert K.LAUNCHES["bsr_matmul"] - before == per_step
    assert torch.equal(eng.logits, want)
    last = want[:, -1].float()
    assert (nxt == last.argmax(-1).int().cpu().numpy()).all()
    assert (ok == torch.isfinite(last).all(-1).int().cpu().numpy()).all()
    for g, d in eng.cache.items():
        for k, t in d.items():
            assert torch.equal(t, copy[g][k]), (g, k)
    assert eng.stats["graph_captures"] == 1


@pytest.mark.parametrize("family", ["dense", "moe", "hybrid"])
def test_engine_tokens_on_card_equal_generate(cuda, family):
    """fp32, TF32 off: the captured engine's tokens equal one B = 1
    ``generate`` per request on the card, through slot reuse."""
    cfg, exec_p = _engine_model(family, cuda)
    rng = np.random.RandomState(1)
    prompts = [rng.randint(1, cfg.vocab, size=n).tolist()
               for n in (8, 12, 5, 9)]
    eng = engine.ServingEngine(exec_p, cfg, n_slots=2, seq_cap=32)
    rids = [eng.submit(p, 6) for p in prompts]
    eng.run()
    assert eng.stats["finished"] == 4 and eng.stats["graph_captures"] == 1
    for rid, p in zip(rids, prompts):
        want = engine.generate(exec_p, cfg, np.asarray([p]), 6)[0].tolist()
        assert eng.requests[rid].tokens == want


# -- kernel 1 over an MoE expert stack ---------------------------------------

def _expert_stack(dev, E, K_, N_, dtype, reorder, seed=0, gran=None):
    rng = np.random.RandomState(seed)
    live = rng.rand(E, K_ // 16, N_ // 16) < 0.4
    live[:, :, -1] = True
    mask = torch.from_numpy(np.repeat(np.repeat(live, 16, 1), 16, 2)).to(dev)
    w = torch.from_numpy(rng.randn(E, K_, N_).astype(np.float32)).to(dev,
                                                                     dtype)
    lay, _ = C._pack_stacked(w * mask.to(dtype), mask, (16, 16),
                             reorder=reorder, n_bins=4,
                             value_dtype=gran and "int8",
                             scale_granularity=gran or "block")
    return lay


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M", [1, 4, 17, 40, 65])
def test_expert_launch_matches_plain(cuda, M, dtype):
    """Eight experts in one launch (not one per expert): each expert's
    output is the plain product with its own layout slice, and reordered
    == unreordered bitwise."""
    lay = _expert_stack(cuda, 8, 512, 384, dtype, reorder=True)
    unre = _expert_stack(cuda, 8, 512, 384, dtype, reorder=False)
    x = torch.randn(8, M, 512, device=cuda).to(dtype)
    b = torch.randn(8, 384, device=cuda).to(dtype)
    for act, bias in (("silu", b), ("none", None)):
        before = K.LAUNCHES["bsr_matmul"]
        y = ops.sparse_expert_linear(x, lay, bias=bias, act=act)
        torch.cuda.synchronize()
        assert K.LAUNCHES["bsr_matmul"] - before == 1
        assert torch.equal(y, ops.sparse_expert_linear(x, unre, bias=bias,
                                                       act=act))
        want = ref.bsr_matmul_experts_ref(
            x.float(), lay, None if bias is None else bias.float(), act)
        tol = 1e-4 if dtype == torch.float32 else 1e-2
        torch.testing.assert_close(y.float(), want, rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_expert_launch_replays_in_a_cuda_graph(cuda, dtype):
    """Chunked columns in every expert: each expert's counters are reset
    by its last block, so replays give the same bits and leave them 0."""
    lay = _expert_stack(cuda, 8, 4096, 256, dtype, reorder=True)
    x = torch.randn(8, 4, 4096, device=cuda).to(dtype)
    plan = K.bsr_plan(4, 4096, 256, dtype, 16, 16, 8)
    assert K._bsr_bins(lay, plan, x.device).ws_floats > 0
    want = ops.sparse_expert_linear(x, lay, act="silu")
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        y = ops.sparse_expert_linear(x, lay, act="silu")
    for _ in range(3):
        g.replay()
        torch.cuda.synchronize()
        assert torch.equal(y, want)
        assert int(K._COUNTERS[x.device].abs().sum()) == 0
    torch.testing.assert_close(
        want.float(), ref.bsr_matmul_experts_ref(x.float(), lay, None,
                                                 "silu"),
        rtol=1e-2, atol=1e-2)


def test_moe_generate_on_card_matches_cpu(cuda):
    """fp32 mixtral SMOKE, pruned and compiled: the card's greedy tokens
    equal the CPU plain path's; each layer launches kernel 1 seven times
    a forward (four attention projections, three expert projections)."""
    cfg = configs.get("mixtral-8x7b", smoke=True)
    spec = [(r"(attn/w[qkvo]|moe/(gate|up|down))/w",
             RW.SchemeChoice("block", (16, 16)))]
    tokens = np.random.RandomState(0).randint(0, cfg.vocab, size=(2, 8))
    outs = {}
    for dev in ("cpu", "cuda"):
        p = T.init_lm(cfg, seed=0, dtype=torch.float32, device="cpu")
        masks = RW.magnitude_block_masks(p, spec, None, rate=0.6)
        exec_p, rep = C.compile_model(apply_masks(p, masks), masks, spec,
                                      spec=C.CompileSpec(keep_dense=False),
                                      device=dev)
        assert len(rep.packed) == 7
        K.reset_launches()
        outs[dev] = engine.generate(exec_p, cfg, tokens, 10,
                                    device=dev).cpu()
        launches = K.LAUNCHES["bsr_matmul"]
        assert launches == (cfg.n_layers * 7 * 11 if dev == "cuda" else 0)
    assert torch.equal(outs["cuda"], outs["cpu"])


# -- the conv kernels (2: tap gather on the alive band, 3: the BCS conv
# from the image or from im2col patches, 4: the tap conv from the image) --

def _conv_layout(dev, scheme, P, Q, k, dtype, reorder, n_bins, seed=0,
                 gran=None):
    from repro_torch.core import bcs as BCS
    from repro_torch.core import regularity as R
    g = torch.Generator().manual_seed(seed)
    w = torch.randn(P, Q, k, k, generator=g) * 0.1
    if scheme == "pattern":
        mask = (R.pattern_mask(w, 0.5) if k == 3
                else R.connectivity_mask(w, rate=0.5))
        lay = ops.pack_taps(w.to(dev, dtype), mask.to(dev), reorder=reorder,
                            n_bins=n_bins, value_dtype=gran and "int8",
                            scale_granularity=gran or "block")
    else:
        mask = R.block_punched_mask(w, (8, 8), rate=0.5)
        lay = ops.pack(BCS.conv_lower(w).to(dev, dtype),
                       BCS.conv_lower(mask).to(dev), (8, 8), reorder=reorder,
                       n_bins=n_bins, conv=(k, k, Q),
                       value_dtype=gran and "int8",
                       scale_granularity=gran or "block")
    return lay, (w * mask).to(dev)


def _conv_plain(x, lay, k, stride, bias, act):
    """The plain version the wrapper would run on the CPU, here on the
    card's tensors (fp32 inputs)."""
    from repro_torch.core.packed import TapLayout
    from repro_torch.kernels.bsr_matmul import pad_image
    B = x.shape[0]
    xp, (Ho, Wo) = pad_image(x.float(), k, k, stride)
    b = None if bias is None else bias.float()
    if isinstance(lay, TapLayout):
        y = ref.tap_gather_implicit_ref(xp, lay, k, (Ho, Wo, stride), b, act)
    else:
        y = ref.bsr_conv2d_implicit_ref(xp, lay, lay.conv_taps_t,
                                        (Ho, Wo, stride), b, act)
    return y.reshape(B, Ho, Wo, -1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("scheme,P,Q,k,stride,H,W", [
    ("pattern", 32, 3, 3, 1, 13, 10), ("pattern", 64, 32, 3, 2, 13, 10),
    ("pattern", 64, 32, 3, 2, 12, 12), ("pattern", 32, 16, 5, 1, 13, 10),
    ("pattern", 64, 64, 1, 1, 13, 10), ("punched", 64, 32, 3, 2, 13, 10),
    ("punched", 64, 32, 3, 2, 12, 12), ("punched", 32, 16, 5, 1, 13, 10),
    ("punched", 64, 64, 1, 1, 13, 10)])
def test_conv_kernels_match_plain(cuda, scheme, P, Q, k, stride, H, W,
                                  dtype):
    """Implicit and materialized modes against the plain version on the
    card at the edge shapes (C = 3, stride 2 with the (0, 1) pad at an
    even input, Ho * Wo not a multiple of the tile), with and without
    bias, relu and none; implicit == materialized and reordered ==
    unreordered bitwise."""
    n_bins = 8 if scheme == "pattern" else 4
    lay, _ = _conv_layout(cuda, scheme, P, Q, k, dtype, True, n_bins)
    unre, _ = _conv_layout(cuda, scheme, P, Q, k, dtype, False, n_bins)
    conv = (ops.sparse_conv2d_pattern if scheme == "pattern"
            else ops.sparse_conv2d)
    x = torch.randn(3, H, W, Q, device=cuda).to(dtype)
    b = torch.randn(P, device=cuda).to(dtype)
    for act, bias in (("none", None), ("relu", b), ("none", b),
                      ("relu", None)):
        K.reset_launches()
        ys = [conv(x, lay_, kh=k, kw=k, stride=stride, bias=bias, act=act,
                   implicit=imp)
              for lay_ in (lay, unre) for imp in (True, False)]
        torch.cuda.synchronize()
        for y in ys[1:]:
            assert torch.equal(y, ys[0])
        imp_key = ("tap_gather_conv_implicit" if scheme == "pattern"
                   else "bsr_conv2d_implicit")
        mat_key = ("tap_gather_conv" if scheme == "pattern"
                   else "bsr_conv2d_materialized")
        assert K.LAUNCHES[imp_key] == 2
        assert K.LAUNCHES[mat_key] == 2
        assert K.LAUNCHES["bsr_matmul"] == 0
        want = _conv_plain(x, lay, k, stride, bias, act)
        tol = 1e-4 if dtype == torch.float32 else 2e-2
        torch.testing.assert_close(ys[0].float(), want, rtol=tol, atol=tol)


@pytest.mark.parametrize("values", [None, "int8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("P,Q,stride,kblock", [(64, 64, 1, (32, 64)),
                                               (128, 128, 2, (128, 128)),
                                               (64, 32, 2, (64, 16))])
def test_conv_kernel_matches_plain_at_wide_blocks(cuda, P, Q, stride, kblock,
                                                  dtype, values):
    """Kernel 3 at the rule mapper's conv blocks (VGG_TINY's c3 at kernel
    block (32, 64) = GEMM block (64, 32), c6 at (128, 128)) and at a
    16-wide block of 64 rows: subcolumns of 16 and slots staged in
    pieces; implicit == materialized and reordered == unreordered
    bitwise."""
    from repro_torch.core import bcs as BCS
    from repro_torch.core import regularity as R
    g = torch.Generator().manual_seed(3)
    w = torch.randn(P, Q, 3, 3, generator=g) * 0.1
    mask = R.block_punched_mask(w, kblock, rate=0.5)
    gb, _ = BCS.conv_gemm_block(kblock, tuple(w.shape))
    lays = [ops.pack(BCS.conv_lower(w).to(cuda, dtype),
                     BCS.conv_lower(mask).to(cuda), gb, reorder=r, n_bins=4,
                     conv=(3, 3, Q), value_dtype=values) for r in (True,
                                                                   False)]
    x = torch.randn(3, 13, 10, Q, device=cuda).to(dtype)
    b = torch.randn(P, device=cuda).to(dtype)
    K.reset_launches()
    ys = [ops.sparse_conv2d(x, lay, kh=3, kw=3, stride=stride, bias=b,
                            act="relu", implicit=imp)
          for lay in lays for imp in (True, False)]
    torch.cuda.synchronize()
    assert K.LAUNCHES["bsr_conv2d_implicit"] == 2
    assert K.LAUNCHES["bsr_conv2d_materialized"] == 2
    for y in ys[1:]:
        assert torch.equal(y, ys[0])
    want = _conv_plain(x, lays[0], 3, stride, b, "relu")
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(ys[0].float(), want, rtol=tol, atol=tol)


def _net_launches(exec_p, arch, x_shape):
    """Kernel launches of one ``convnet_apply``: one per packed layer,
    whichever kernel ``ops._pick_implicit`` routes it to."""
    B, H, _, C = x_shape
    n = 0
    for (name, cout, kh, kw, stride, dw) in arch:
        if exec_p[name].get("packed") is not None and not dw:
            n += 1
        _, _, H, _ = K.conv_geometry(H, H, kh, kw, stride)
        C = C if dw else cout
    return n


def test_convnet_on_card_matches_cpu(cuda, monkeypatch):
    """VGG_TINY under both mappings, compiled on the card: logits agree
    with the CPU plain path, and every packed layer went through its
    kernel.  The unpacked stem runs cuDNN, held to full fp32 (TF32 off)."""
    from repro_torch.models import convnet as CN
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    specs = {
        "punched": [(r"(^|/)(c|pw|dw)\d+/w",
                     RW.SchemeChoice("block_punched", (8, 8)))],
        "pattern": [(r"(^|/)(c|pw|dw)\d+/w",
                     RW.SchemeChoice("pattern", connectivity=0.5))]}
    g = torch.Generator().manual_seed(1)
    x, _ = CN.synthetic_images(g, 4, size=16)
    for name, spec in specs.items():
        logits = {}
        for dev in ("cpu", "cuda"):
            p = CN.convnet_init(CN.VGG_TINY, seed=0, device="cpu")
            masks = (RW.punched_conv_masks(p, spec, (8, 8), rate=0.5)
                     if name == "punched" else RW.masks_for_spec(p, spec))
            exec_p, report = C.compile_model(
                apply_masks(p, masks), masks, spec,
                spec=C.CompileSpec(keep_dense=False), device=dev)
            K.reset_launches()
            logits[dev] = CN.convnet_apply(exec_p, x.to(dev),
                                           CN.VGG_TINY).cpu()
            assert sum(K.LAUNCHES.values()) == (
                _net_launches(exec_p, CN.VGG_TINY, x.shape)
                if dev == "cuda" else 0)
        torch.testing.assert_close(logits["cuda"], logits["cpu"], rtol=1e-4,
                                   atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel2_equals_kernel4_at_a_1x1_layer(cuda, dtype):
    """Kernel 2 (kernel 4 over the alive band, dead channels dropped) and
    kernel 4 on the image agree bitwise at a connectivity-pruned 1x1
    layer, each in one launch."""
    from repro_torch.core import regularity as R
    w = torch.randn(128, 128, 1, 1, generator=torch.Generator()
                    .manual_seed(3)) * 0.1
    mask = R.connectivity_mask(w, rate=0.5)
    mask[:, :8] = 0                       # channels dead in every filter
    lay = ops.pack_taps(w.to(cuda, dtype), mask.to(cuda), n_bins=8)
    assert lay.n_alive == 120
    x = torch.randn(2, 16, 16, 128, device=cuda).to(dtype)
    b = torch.randn(128, device=cuda).to(dtype)
    band = x.reshape(-1, 128).index_select(1, lay.alive.long())
    K.reset_launches()
    y2 = K.tap_gather_conv_packed(band, lay, b, "relu")
    y4 = K.tap_gather_conv_implicit(x, lay, kh=1, kw=1, bias=b, act="relu")
    torch.cuda.synchronize()
    assert K.LAUNCHES["tap_gather_conv"] == 1
    assert K.LAUNCHES["tap_gather_conv_implicit"] == 1
    assert torch.equal(y2, y4.reshape(-1, 128))


def test_conv_bins_of_one_slot_and_fewer_columns_than_a_block(cuda):
    """A bin of degree-1 columns and bins with fewer columns than the
    block's column warps, through both BCS modes, on the card."""
    from repro_torch.core import bcs as BCS
    Q, P, k = 16, 40, 3
    rng = np.random.RandomState(5)
    w = torch.from_numpy(rng.randn(P, Q, k, k).astype(np.float32))
    live = np.zeros((k * k * Q // 8, P // 8), bool)
    live[:, :2] = True
    live[3, 2:] = True
    mask = torch.from_numpy(np.repeat(np.repeat(live, 8, 0), 8, 1))
    lay = ops.pack(BCS.conv_lower(w).to(cuda), mask.to(cuda), (8, 8),
                   reorder=True, n_bins=4, conv=(k, k, Q))
    assert 1 in lay.bin_degrees
    x = torch.randn(2, 9, 7, Q, device=cuda)
    b = torch.randn(P, device=cuda)
    ys = [ops.sparse_conv2d(x, lay, kh=k, kw=k, bias=b, act="relu",
                            implicit=imp) for imp in (True, False)]
    torch.cuda.synchronize()
    assert torch.equal(ys[0], ys[1])
    want = _conv_plain(x, lay, k, 1, b, "relu")
    torch.testing.assert_close(ys[0], want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel", ["bsr_matmul", "bsr_conv2d_implicit",
                                    "bsr_conv2d_materialized",
                                    "tap_gather_conv_implicit",
                                    "tap_gather_conv"])
def test_fused_relu_passes_non_finite_values(cuda, kernel, dtype):
    """A NaN reaching the fused relu stays NaN, +inf stays +inf and -inf
    becomes 0, as in the plain version (torch.clamp_min): the engine's
    finite probe relies on a non-finite value staying non-finite.  The
    bias carries them, so every row of those columns is hit."""
    b = torch.randn(64, device=cuda)
    b[:3] = torch.tensor([float("nan"), float("inf"), -float("inf")])
    b = b.to(dtype)
    K.reset_launches()
    if kernel == "bsr_matmul":
        lay, _ = _layout(cuda, 128, 64, (16, 16), dtype, reorder=True)
        x = torch.randn(17, 128, device=cuda).to(dtype)
        y = K.bsr_matmul_packed(x, lay, bias=b, act="relu")
        want = ref.bsr_matmul_packed_ref(x.float(), lay, b.float(), "relu")
    else:
        scheme = "punched" if kernel.startswith("bsr") else "pattern"
        lay, _ = _conv_layout(cuda, scheme, 64, 32, 3, dtype, True,
                              4 if scheme == "punched" else 8)
        conv = (ops.sparse_conv2d if scheme == "punched"
                else ops.sparse_conv2d_pattern)
        x = torch.randn(2, 9, 7, 32, device=cuda).to(dtype)
        y = conv(x, lay, kh=3, kw=3, bias=b, act="relu",
                 implicit=kernel.endswith("implicit"))
        want = _conv_plain(x, lay, 3, 1, b, "relu")
    torch.cuda.synchronize()
    assert K.LAUNCHES[kernel] == 1
    y = y.float().reshape(want.shape)
    assert torch.isnan(y[..., 0]).all() and torch.isnan(want[..., 0]).all()
    assert (y[..., 1] == float("inf")).all() and (y[..., 2] == 0).all()
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(y, want, rtol=tol, atol=tol, equal_nan=True)


def test_conv_wrappers_reject_what_the_kernels_do_not_take(cuda):
    lay, _ = _conv_layout(cuda, "punched", 32, 16, 3, torch.float32, True,
                          4)
    tap, _ = _conv_layout(cuda, "pattern", 32, 16, 3, torch.float32, True,
                          8)
    x = torch.randn(2, 8, 8, 16, device=cuda)
    for fn, l_ in ((K.bsr_conv2d_implicit, lay),
                   (K.tap_gather_conv_implicit, tap)):
        with pytest.raises(ValueError, match="contiguous"):
            fn(x.permute(0, 2, 1, 3), l_, kh=3, kw=3)
        with pytest.raises(ValueError, match="device"):
            fn(x, _layout_to(l_, "cpu"), kh=3, kw=3)
        with pytest.raises(TypeError):
            fn(x.to(torch.bfloat16), l_, kh=3, kw=3)
    # bk = 8 does not divide Cin = 12 (K-blocks would straddle taps) but
    # divides K = 2 * 2 * 12
    w = torch.randn(16, 12, 2, 2)
    from repro_torch.core import bcs as BCS
    m = torch.ones_like(w)
    l12 = ops.pack(BCS.conv_lower(w).to(cuda), BCS.conv_lower(m).to(cuda),
                   (8, 8))
    x12 = torch.randn(1, 6, 6, 12, device=cuda)
    with pytest.raises(ValueError, match="straddle"):
        K.bsr_conv2d_implicit(x12, l12, kh=2, kw=2)
    # the patch-matrix mode takes it: bk | K is all it needs
    y = ops.sparse_conv2d(x12, l12, kh=2, kw=2)
    want = ref.bsr_matmul_packed_ref(
        ops.im2col(x12, 2, 2).reshape(36, 48), l12).reshape(1, 6, 6, 16)
    torch.testing.assert_close(y, want, rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="contiguous"):
        K.bsr_conv2d_patches(torch.randn(48, 36, device=cuda).t(), l12)


def _layout_to(layout, dev):
    """The layout with every tensor leaf moved to ``dev``."""
    import dataclasses
    out = {}
    for f in dataclasses.fields(layout):
        v = getattr(layout, f.name)
        if isinstance(v, torch.Tensor):
            v = v.to(dev)
        elif isinstance(v, tuple) and v and isinstance(v[0], torch.Tensor):
            v = tuple(t.to(dev) for t in v)
        out[f.name] = v
    return type(layout)(**out)


# -- int8 layouts: every kernel dequantizes q * s on the card ---------------

@pytest.mark.parametrize("gran", ["block", "out"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("block", [(16, 16), (8, 16), (4, 4), (16, 32)])
@pytest.mark.parametrize("M", [1, 4, 17, 129])
def test_int8_kernel_matches_plain(cuda, M, block, dtype, gran):
    """Kernel 1 on int8 values under a bf16 (tensor cores, or FMAs for the
    small blocks) or fp32 x: one launch, reordered == unreordered bitwise,
    within tolerance of the plain version on the dequantized weight."""
    lay, _ = _layout(cuda, 256, 384, block, dtype, True, gran=gran)
    unre, _ = _layout(cuda, 256, 384, block, dtype, False, gran=gran)
    assert lay.value_dtype == "int8" and lay.scale_granularity == gran
    x = torch.randn(M, 256, device=cuda).to(dtype)
    b = torch.randn(384, device=cuda).to(dtype)
    for act in ("none", "silu"):
        before = K.LAUNCHES["bsr_matmul"]
        y = K.bsr_matmul_packed(x, lay, bias=b, act=act)
        torch.cuda.synchronize()
        assert K.LAUNCHES["bsr_matmul"] - before == 1
        assert torch.equal(y, K.bsr_matmul_packed(x, unre, bias=b, act=act))
        want = ref.bsr_matmul_packed_ref(x.float(), lay, b.float(), act)
        tol = 1e-4 if dtype == torch.float32 else 1e-2
        torch.testing.assert_close(y.float(), want, rtol=tol, atol=tol)


@pytest.mark.parametrize("gran", ["block", "out"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_expert_launch_matches_plain_and_replays(cuda, dtype, gran):
    """An int8 expert stack with chunked columns: one launch over the
    experts, against the plain version expert by expert, and the same
    bits from a CUDA-graph replay."""
    lay = _expert_stack(cuda, 8, 4096, 256, dtype, True, gran=gran)
    x = torch.randn(8, 4, 4096, device=cuda).to(dtype)
    plan = K.bsr_plan(4, 4096, 256, dtype, 16, 16, 8, 1)
    assert K._bsr_bins(lay, plan, x.device).ws_floats > 0
    want = ops.sparse_expert_linear(x, lay, act="silu")
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        y = ops.sparse_expert_linear(x, lay, act="silu")
    for _ in range(2):
        g.replay()
        torch.cuda.synchronize()
        assert torch.equal(y, want)
        assert int(K._COUNTERS[x.device].abs().sum()) == 0
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(
        want.float(), ref.bsr_matmul_experts_ref(x.float(), lay, None,
                                                 "silu"),
        rtol=tol, atol=tol)


@pytest.mark.parametrize("gran", ["block", "out"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("scheme,P,Q,k,stride,H,W", [
    ("pattern", 64, 32, 3, 2, 13, 10), ("pattern", 64, 64, 1, 1, 13, 10),
    ("punched", 64, 32, 3, 2, 13, 10), ("punched", 64, 64, 1, 1, 13, 10)])
def test_int8_conv_kernels_match_plain(cuda, scheme, P, Q, k, stride, H, W,
                                       dtype, gran):
    """Kernels 2-4 on int8 layouts: implicit == materialized and
    reordered == unreordered bitwise, within tolerance of the plain
    version on the dequantized weight."""
    n_bins = 8 if scheme == "pattern" else 4
    lay, _ = _conv_layout(cuda, scheme, P, Q, k, dtype, True, n_bins,
                          gran=gran)
    unre, _ = _conv_layout(cuda, scheme, P, Q, k, dtype, False, n_bins,
                           gran=gran)
    conv = (ops.sparse_conv2d_pattern if scheme == "pattern"
            else ops.sparse_conv2d)
    x = torch.randn(3, H, W, Q, device=cuda).to(dtype)
    b = torch.randn(P, device=cuda).to(dtype)
    ys = [conv(x, lay_, kh=k, kw=k, stride=stride, bias=b, act="relu",
               implicit=imp) for lay_ in (lay, unre) for imp in (True, False)]
    torch.cuda.synchronize()
    for y in ys[1:]:
        assert torch.equal(y, ys[0])
    want = _conv_plain(x, lay, k, stride, b, "relu")
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(ys[0].float(), want, rtol=tol, atol=tol)


@pytest.mark.parametrize("gran", ["block", "out"])
def test_int8_quantization_on_the_card_equals_the_host(cuda, gran):
    """core.quant on the card gives the host's int8 values and fp32 scales
    bit for bit (a packed and a tap layout)."""
    from repro_torch.core import quant as Q
    lay, _ = _layout(cuda, 512, 384, (16, 16), torch.bfloat16, True)
    tap, _ = _conv_layout(cuda, "pattern", 64, 32, 3, torch.float32, True,
                          8)
    for fl in (lay, tap):
        a = Q.quantize_layout(fl, scale_granularity=gran)
        b = Q.quantize_layout(_layout_to(fl, "cpu"), scale_granularity=gran)
        for u, v in zip(a.values + a.scales, b.values + b.scales):
            assert torch.equal(u.cpu(), v)


def test_int8_wrappers_reject_unscaled_or_misshapen_layouts(cuda):
    import dataclasses
    lay, _ = _layout(cuda, 128, 64, (16, 16), torch.float32, False,
                     gran="block")
    x = torch.randn(5, 128, device=cuda)
    with pytest.raises(TypeError):               # int8 values, no scales
        K.bsr_matmul_packed(x, dataclasses.replace(lay, scales=None))
    with pytest.raises(ValueError, match="scales"):
        K.bsr_matmul_packed(x, dataclasses.replace(
            lay, scales=tuple(s[:, :1].contiguous() for s in lay.scales)))
    tap, _ = _conv_layout(cuda, "pattern", 32, 16, 3, torch.float32, True,
                          8, gran="out")
    with pytest.raises(TypeError):
        K.tap_gather_conv_implicit(torch.randn(2, 8, 8, 16, device=cuda),
                                   dataclasses.replace(tap, scales=None),
                                   kh=3, kw=3)


# -- tensor-parallel layouts: the shard wrappers ------------------------------

@pytest.mark.parametrize("gran", [None, "block", "out"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [2, 4])
@pytest.mark.parametrize("M", [1, 4, 17, 129])
def test_sharded_kernel1_matches_plain(cuda, M, S, dtype, gran):
    """Kernel 1 over a sharded layout (every shard and bin in one launch,
    counted as ``bsr_matmul_sharded``) against the sharded plain version,
    and against the unsharded kernel: bitwise where the two launches take
    the same chunks of a column (a column of at most 64 slots here)."""
    rng = np.random.RandomState(S)
    Kd, Nd, block = 256, 512, (16, 16)
    live = rng.rand(Kd // 16, Nd // 16) < 0.4
    mask = torch.from_numpy(np.repeat(np.repeat(live, 16, 0), 16, 1)).to(
        cuda)
    w = torch.from_numpy(rng.randn(Kd, Nd).astype(np.float32)).to(cuda, dtype)
    kw = dict(value_dtype=gran and "int8", scale_granularity=gran or "block")
    sh = ops.pack(w, mask, block, n_shards=S, **kw)
    un = ops.pack(w, mask, block, reorder=True, **kw)
    x = torch.randn(M, Kd, device=cuda).to(dtype)
    b = torch.randn(Nd, device=cuda).to(dtype)
    K.reset_launches()
    y = K.bsr_matmul_packed(x, sh, bias=b, act="silu")
    torch.cuda.synchronize()
    assert K.LAUNCHES["bsr_matmul_sharded"] == 1
    assert K.LAUNCHES["bsr_matmul"] == 0
    want = ref.bsr_matmul_sharded_ref(x.float(), sh, b.float(), "silu")
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(y.float(), want, rtol=tol, atol=tol)
    assert torch.equal(y, K.bsr_matmul_packed(x, un, bias=b, act="silu"))


@pytest.mark.parametrize("S", [2, 4])
@pytest.mark.parametrize("gran", [None, "out"])
def test_sharded_kernel2_matches_plain(cuda, S, gran):
    """Kernel 2 over a sharded TapLayout (the global alive band, every
    shard's filter groups in one launch) against the sharded plain
    version, and bitwise against the unsharded launch."""
    rng = np.random.RandomState(S)
    w = torch.from_numpy(rng.randn(64, 32, 3, 3).astype(np.float32)).to(cuda)
    mask = torch.from_numpy(rng.rand(64, 32, 3, 3) < 0.4).to(cuda)
    kw = dict(value_dtype=gran and "int8", scale_granularity=gran or "block")
    sh = ops.pack_taps(w, mask, n_shards=S, **kw)
    un = ops.pack_taps(w, mask, **kw)
    x = torch.randn(300, sh.n_alive, device=cuda)
    b = torch.randn(64, device=cuda)
    K.reset_launches()
    y = K.tap_gather_conv_packed(x, sh, bias=b, act="relu")
    torch.cuda.synchronize()
    assert K.LAUNCHES["tap_gather_conv_sharded"] == 1
    want = ref.tap_gather_sharded_ref(x, sh, b, "relu")
    torch.testing.assert_close(y, want, rtol=1e-4, atol=1e-4)
    assert torch.equal(y, K.tap_gather_conv_packed(x, un, bias=b,
                                                   act="relu"))


def test_sharded_layouts_refuse_the_implicit_kernels(cuda):
    rng = np.random.RandomState(0)
    w = torch.from_numpy(rng.randn(16, 8, 3, 3).astype(np.float32)).to(cuda)
    mask = torch.ones_like(w, dtype=torch.bool)
    x = torch.randn(1, 6, 6, 8, device=cuda)
    with pytest.raises(ValueError, match="shards"):
        K.tap_gather_conv_implicit(x, ops.pack_taps(w, mask, n_shards=2),
                                   kh=3, kw=3)


def test_data_draws_are_the_same_on_cpu_and_card(cuda):
    """(seed, step, shard) gives the same batch and task on either
    device: the draws come from the host's generator."""
    for step, shard in ((0, 0), (5, 1)):
        a = synthetic_batch(0, step, 4, 16, 97, shard=shard, device="cpu")
        b = synthetic_batch(0, step, 4, 16, 97, shard=shard, device=cuda)
        for k in a:
            assert b[k].device.type == "cuda"
            assert torch.equal(a[k], b[k].cpu())
