"""The rank side of the port's multi-process CPU tests of the mesh path
(``tests/test_torch_dist_exec.py``): every rank of a gloo group over a
``file://`` store runs every check below on its own process, and writes
one JSON record per rank (check name -> {"ok", "detail"}).  The reference
outputs come in an ``.npz`` the test made beforehand; nothing here
imports JAX.

  python -m repro_torch.testing.dist_ranks RANK WORLD STORE INPUTS OUT

Checks, each at SMOKE width, fp32:

* ``linear`` / ``linear_int8`` / ``tap``: a column-sharded layout (S = 4)
  placed on the mesh runs ``sparse_linear`` / ``tap_gather_conv_sharded``
  bit-equal to the unsharded layout, the plain version once per rank
  (over its S / tp local shards) and, counted by ``CommDebugMode``, one
  all-gather over the model axis; ``expert``: an expert stack placed by
  ``expert_layout_specs`` runs each rank's experts with no collective;
* ``forward_<arch>`` (yi-9b, mixtral-8x7b, hymba-1.5b): ``forward(dist=)``
  within 1e-5 of the unsharded forward and of the reference's
  ``dist=None`` logits; ``generate_<arch>``: greedy tokens equal;
* ``packed_generate``: yi-9b compiled at ``CompileSpec(tp=4)``, placed by
  ``shard_packed_tree``, ``generate(dist=)`` tokens equal the unsharded
  compiled model's; ``engine``: ``ServingEngine(dist=)`` tokens equal
  one ``generate`` per request;
* ``train_tp`` / ``train_fsdp``: two train steps with params placed by
  ``param_shardings`` in each mode, losses within 1e-5 of unsharded;
* ``train_cli``: ``launch.train --model-parallel WORLD`` runs and saves;
* ``checkpoint``: placed params saved at this degree (every rank its
  shard), restored placed (``shardings=``) equal;
* ``comm_decode``: the collectives of one decode step, by op.
"""
from __future__ import annotations

import json
import os
import sys
import traceback

import numpy as np
import torch
import torch.distributed as dist

ARCHS = ("yi-9b", "mixtral-8x7b", "hymba-1.5b")
ATOL = 1e-5


def _unflatten(flat, prefix):
    """{"a/b/c": array} entries under ``prefix`` -> nested dicts."""
    out = {}
    for key, arr in flat.items():
        if not key.startswith(prefix):
            continue
        node = out
        parts = key[len(prefix):].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr
    return out


def _max_err(a, b):
    return float((a.float() - b.float()).abs().max())


class Checks:
    def __init__(self, rank, world, inputs, out):
        from repro_torch.launch import mesh as MESH
        self.rank, self.world, self.out = rank, world, out
        self.inputs = inputs
        self.mesh = MESH.make_local_mesh(world, device="cpu")
        self.results = {}

    def run(self, name, fn):
        print(f"[rank {self.rank}] {name}", flush=True)
        try:
            detail = fn()
            self.results[name] = {"ok": True, "detail": detail}
        except Exception:
            self.results[name] = {"ok": False,
                                  "detail": traceback.format_exc()[-3000:]}

    # -- kernels through the shard wrappers ------------------------------------

    def _count_parts(self):
        """Wrap the per-shard plain versions to count their calls."""
        from repro_torch.kernels import ref
        counts = {"bsr": 0, "tap": 0}
        bsr, tap = ref.bsr_matmul_shard_parts, ref.tap_gather_shard_parts

        def c_bsr(*a, **k):
            counts["bsr"] += 1
            return bsr(*a, **k)

        def c_tap(*a, **k):
            counts["tap"] += 1
            return tap(*a, **k)
        ref.bsr_matmul_shard_parts, ref.tap_gather_shard_parts = c_bsr, c_tap
        return counts, lambda: (setattr(ref, "bsr_matmul_shard_parts", bsr),
                                setattr(ref, "tap_gather_shard_parts", tap))

    def linear(self, value_dtype=None):
        from torch.distributed.tensor.debug import CommDebugMode

        from repro_torch.distributed import sharding as SH
        from repro_torch.kernels import ops
        rng = np.random.default_rng(0)
        K, N, b = 64, 128, 8
        w = torch.from_numpy(rng.standard_normal((K, N)).astype(np.float32))
        mask = torch.from_numpy(np.kron(rng.random((K // b, N // b)) < 0.5,
                                        np.ones((b, b), bool)))
        x = torch.from_numpy(rng.standard_normal((5, K)).astype(np.float32))
        bias = torch.from_numpy(rng.standard_normal(N).astype(np.float32))
        kw = dict(value_dtype=value_dtype)
        flat = ops.pack(w, mask, (b, b), reorder=True, **kw)
        sharded = ops.pack(w, mask, (b, b), n_shards=4, **kw)
        placed = SH.place_layout(sharded, self.mesh)
        want = ops.sparse_linear(x, flat, bias=bias, act="silu")
        counts, undo = self._count_parts()
        try:
            xd = SH.place(x, self.mesh, ())
            with CommDebugMode() as comm:
                got = ops.sparse_linear(xd, placed, bias=bias, act="silu")
            got_plain = ops.sparse_linear(x, placed, bias=bias, act="silu")
        finally:
            undo()
        ops_count = {str(k): v for k, v in comm.get_comm_counts().items()}
        assert torch.equal(SH.full(got), want), _max_err(SH.full(got), want)
        assert torch.equal(got_plain, want)
        assert counts["bsr"] == 2, counts
        local = SH.place_layout(sharded, self.mesh).values[0].to_local()
        assert local.shape[0] == 4 // self.world
        assert sum(ops_count.values()) == 1 and \
            "all_gather" in next(iter(ops_count)), ops_count
        return {"collectives": ops_count, "local_shards": 4 // self.world}

    def tap(self):
        from repro_torch.distributed import sharding as SH
        from repro_torch.kernels import bsr_matmul as K
        from repro_torch.kernels import ops
        rng = np.random.default_rng(3)
        w = torch.from_numpy(rng.standard_normal((16, 8, 3, 3)).astype(
            np.float32))
        mask = torch.from_numpy(rng.random((16, 8, 3, 3)) < 0.4)
        mask[0] = True
        flat = ops.pack_taps(w, mask)
        sharded = ops.pack_taps(w, mask, n_shards=4)
        x = torch.from_numpy(rng.standard_normal((6, flat.n_alive)).astype(
            np.float32))
        want = K.tap_gather_conv_packed(x, flat, act="relu")
        counts, undo = self._count_parts()
        try:
            got = K.tap_gather_conv_sharded(
                x, SH.place_layout(sharded, self.mesh), act="relu")
        finally:
            undo()
        assert torch.equal(got, want), _max_err(got, want)
        assert counts["tap"] == 1, counts
        return {"parts_calls": counts["tap"]}

    def expert(self):
        from torch.distributed.tensor.debug import CommDebugMode

        from repro_torch.distributed import sharding as SH
        from repro_torch.kernels import ops
        from repro_torch.serve.compile import _pack_stacked
        rng = np.random.default_rng(8)
        E, din, dout, b = 4, 32, 48, 8
        w = rng.standard_normal((E, din, dout)).astype(np.float32)
        mb = rng.random((E, din // b, dout // b)) < 0.5
        mask = np.kron(mb, np.ones((b, b), bool))
        packed, _ = _pack_stacked(torch.from_numpy(w),
                                  torch.from_numpy(mask), (b, b))
        x = torch.from_numpy(rng.standard_normal((E, 5, din)).astype(
            np.float32))
        want = ops.sparse_expert_linear(x, packed)
        placed = SH.place_layout(packed, self.mesh,
                                 SH.expert_layout_specs(packed))
        xd = SH.place(x, self.mesh, ("model",))
        with CommDebugMode() as comm:
            got = ops.sparse_expert_linear(xd, placed)
        assert got.to_local().shape[0] == E // self.world
        assert comm.get_total_counts() == 0, comm.get_comm_counts()
        assert torch.equal(SH.full(got), want), _max_err(SH.full(got), want)
        return {"local_experts": E // self.world}

    # -- models and entry points ----------------------------------------------

    def _params(self, arch):
        from repro_torch import configs
        from repro_torch.convert import params_from_numpy
        cfg = configs.get(arch, smoke=True)
        return cfg, params_from_numpy(
            _unflatten(self.inputs, f"{arch}|params|"), "cpu")

    def forward(self, arch):
        from repro_torch.distributed import sharding as SH
        from repro_torch.models import transformer as T
        from repro_torch.serve import engine as E
        cfg, params = self._params(arch)
        tokens = torch.from_numpy(self.inputs[f"{arch}|tokens"])
        d = SH.make_dist(self.mesh, cfg, tokens.shape[0])
        with torch.no_grad():
            plain = T.forward(params, cfg, tokens)
            got = SH.full(T.forward(params, cfg, tokens, dist=d))
        ref = torch.from_numpy(self.inputs[f"{arch}|logits"])
        e_plain, e_ref = _max_err(got, plain), _max_err(got, ref)
        assert e_plain <= ATOL and e_ref <= ATOL, (e_plain, e_ref)
        toks = E.generate(params, cfg, tokens, 4, device="cpu", dist=d)
        want = E.generate(params, cfg, tokens, 4, device="cpu")
        ref_toks = self.inputs[f"{arch}|tokens_out"]
        # the reference's hybrid prefill takes its decode state from the
        # layer's output (a fault of the reference the port does not copy,
        # pinned in tests/test_torch_ssm.py), so hybrid decode tokens are
        # held to the port's unsharded ones alone
        same_ref = (cfg.family == "hybrid"
                    or np.array_equal(toks.numpy(), ref_toks))
        self.results[f"generate_{arch}"] = {
            "ok": bool(torch.equal(toks, want) and same_ref),
            "detail": {"arch": arch, "dist": toks.tolist(),
                       "plain": want.tolist(),
                       "reference": ref_toks.tolist()}}
        return {"vs_plain": e_plain, "vs_reference": e_ref}

    def _compiled(self):
        from repro_torch.core import reweighted as RW
        from repro_torch.launch.serve import SPARSE_SPEC
        from repro_torch.serve import compile as C
        from repro_torch.train.trainer import apply_masks
        cfg, params = self._params("yi-9b")
        masks = RW.magnitude_block_masks(params, SPARSE_SPEC, None, rate=0.5)
        params = apply_masks(params, masks)
        spec = C.CompileSpec(keep_dense=False, tp=4)
        exec_params, _ = C.compile_model(params, masks, SPARSE_SPEC,
                                         spec=spec, device="cpu")
        flat, _ = C.compile_model(params, masks, SPARSE_SPEC,
                                  spec=C.CompileSpec(keep_dense=False),
                                  device="cpu")
        return cfg, exec_params, flat

    def packed_generate(self):
        from repro_torch.distributed import sharding as SH
        from repro_torch.serve import engine as E
        cfg, exec_params, flat = self._compiled()
        placed = SH.shard_packed_tree(exec_params, self.mesh)
        tokens = torch.from_numpy(self.inputs["yi-9b|tokens"])
        d = SH.make_dist(self.mesh, cfg, tokens.shape[0])
        counts, undo = self._count_parts()
        try:
            got = E.generate(placed, cfg, tokens, 4, device="cpu", dist=d)
        finally:
            undo()
        want = E.generate(flat, cfg, tokens, 4, device="cpu")
        assert torch.equal(got, want), (got.tolist(), want.tolist())
        self._placed = (cfg, placed, d)
        return {"tokens": got.tolist(), "sharded_linear_calls": counts["bsr"]}

    def engine(self):
        from repro_torch.serve import engine as E
        cfg, placed, d = self._placed
        prompts = [[5, 7, 11, 13], [17, 19, 23], [29, 31, 37, 41, 43]]
        eng = E.ServingEngine(placed, cfg, n_slots=2, seq_cap=16,
                              device="cpu", dist=d)
        rids = [eng.submit(p, 4) for p in prompts]
        eng.run()
        got = [eng.requests[r].tokens for r in rids]
        want = [E.generate(placed, cfg, torch.tensor([p]), 4, device="cpu",
                           dist=d)[0].tolist() for p in prompts]
        assert got == want, (got, want)
        return {"tokens": got}

    def train(self, mode):
        from repro_torch.data.pipeline import synthetic_batch
        from repro_torch.distributed import sharding as SH
        from repro_torch.train.trainer import make_train_step
        cfg, params = self._params("yi-9b")
        d = SH.make_dist(self.mesh, cfg, 4, mode=mode)
        batches = [synthetic_batch(0, s, 4, 16, cfg.vocab, device="cpu")
                   for s in range(2)]
        losses = {}
        for name, dd in (("plain", None), ("dist", d)):
            p = params if dd is None else SH.distribute(
                params, SH.param_shardings(params, cfg, self.mesh, mode))
            init, step = make_train_step(cfg, dist=dd)
            o = init(p)
            losses[name] = []
            for b in batches:
                p, o, m = step(p, o, b)
                losses[name].append(float(m["loss"]))
        gap = max(abs(a - b) for a, b in zip(losses["plain"],
                                             losses["dist"]))
        assert gap <= ATOL, losses
        return {"losses": losses, "gap": gap}

    def train_cli(self):
        from repro_torch.launch import train as CLI
        ckpt = os.path.join(self.out, "ckpt_cli")
        params, _ = CLI.main(["--arch", "yi-9b", "--smoke", "--steps", "2",
                              "--batch", "4", "--seq", "16",
                              "--model-parallel", str(self.world),
                              "--ckpt-every", "1", "--ckpt-dir", ckpt,
                              "--device", "cpu"])
        assert dist.is_initialized()        # the caller's group stays up
        assert all(not hasattr(v, "placements") for v in
                   _leaves(params)), "the CLI returns whole params"
        return {"ckpt": sorted(os.listdir(ckpt))}

    def checkpoint(self):
        from repro_torch.distributed import checkpoint as CKPT
        from repro_torch.distributed import sharding as SH
        cfg, params = self._params("yi-9b")
        sh = SH.param_shardings(params, cfg, self.mesh)
        placed = SH.distribute(params, sh)
        ckpt = os.path.join(self.out, "ckpt")
        CKPT.save(ckpt, 5, placed)
        back, step = CKPT.restore(ckpt, placed, shardings=sh)
        assert step == 5
        for a, b, c in zip(_leaves(back), _leaves(placed), _leaves(params)):
            assert tuple(a.placements) == tuple(b.placements)
            assert torch.equal(a.full_tensor(), c)
        return {"files": sorted(os.listdir(os.path.join(
            ckpt, "step_00000005")))}

    def comm_decode(self):
        from torch.distributed.tensor.debug import CommDebugMode

        from repro_torch.models import transformer as T
        from repro_torch.serve import engine as E
        cfg, placed, d = self._placed
        tokens = torch.from_numpy(self.inputs["yi-9b|tokens"])
        logits, cache = E.prefill(placed, cfg, tokens, dist=d)
        tok = torch.argmax(logits[:, -1], -1)[:, None]
        pos = torch.full((tokens.shape[0], 1), tokens.shape[1])
        with CommDebugMode() as comm:
            T.decode_step(placed, cfg, tok, cache, pos, dist=d)
        counts = {str(k): v for k, v in comm.get_comm_counts().items()}
        assert sum(counts.values()) > 0, counts
        return {"collectives": counts}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def main(rank, world, store, inputs, out):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        with np.load(inputs) as f:
            data = {k: f[k] for k in f.files}
        c = Checks(rank, world, data, out)
        c.run("linear", c.linear)
        c.run("linear_int8", lambda: c.linear("int8"))
        c.run("tap", c.tap)
        c.run("expert", c.expert)
        for arch in ARCHS:
            c.run(f"forward_{arch}", lambda a=arch: c.forward(a))
        c.run("packed_generate", c.packed_generate)
        c.run("engine", c.engine)
        c.run("comm_decode", c.comm_decode)
        c.run("train_tp", lambda: c.train("tp"))
        c.run("train_fsdp", lambda: c.train("fsdp"))
        c.run("checkpoint", c.checkpoint)
        c.run("train_cli", c.train_cli)
        with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
            json.dump(c.results, f, default=str)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    r, w, s, i, o = sys.argv[1:6]
    main(int(r), int(w), s, i, o)
