"""Multi-pod dry run: trace every (arch x input-shape x mesh) cell once
under fake tensors on the production ``DeviceMesh`` (nothing is
allocated), and record per-device FLOPs, bytes, collective bytes by op
and memory to JSON (the reference's ``repro.launch.dryrun``, which lowers
and compiles with XLA instead).

The mesh is ``launch.mesh.make_production_mesh``, (16, 16) or (2, 16,
16), over a "fake" process group of 256 or 512 ranks: ``run_cell``
starts one at rank 0 when no group is running and ends it.  The step is
the reference's (``build_step``): ``train.trainer.make_train_step`` in
``cfg.train_shard_mode``, ``serve.engine.prefill`` and
``models.transformer.decode_step`` in "tp", its params placed by
``sharding.param_specs`` / ``opt_state_specs``, its batch and cache by
the reference's batch specs (``_batch_specs``).  Each placed tensor holds
only this rank's shard (rank 0's: the first, the largest of an uneven
split), so every count below is per device:

* FLOPs: ``torch.utils.flop_counter``'s own formulas (the table
  ``FlopCounterMode`` reads, with its decomposition rule) over every op
  this rank runs on its local shards.  ``FlopCounterMode`` itself counts
  a ``DTensor`` op at its global shape, so it is the count of a one-rank
  mesh only (``chip_smoke.py`` holds the two equal there).
* bytes: the operand and result bytes of every aten op on the local
  shards, views and allocations left out.  Nothing is fused, so this is
  an upper bound on HBM traffic, where XLA's "bytes accessed" is counted
  after fusion.
* collectives: by op (all-gather, all-reduce, reduce-scatter,
  all-to-all, collective-permute); the counts are ``CommDebugMode``'s,
  the bytes the reference's accounting: result bytes, twice for an
  all-reduce.  ``collective_sites`` splits the same bytes by the port's
  function that issued them (``_site``; the backward's all fall to
  "backward").
* memory: the local bytes of the arguments and of the outputs, and the
  peak of the live local storages over the step (arguments included);
  ``temp_bytes`` is the peak less the arguments.  The port donates
  nothing, so a train step's new params count beside the old.

DTensor's sharding propagation runs each op once more at its global shape
(under the same fake mode, on a cache miss); those ops are not this
rank's work and are left out of every count.

Records keep the reference's keys, but ``lower_s`` / ``compile_s`` are
one ``trace_s`` (the port traces, it does not compile), and
``transcendentals`` is left out (nothing here counts them).  The probe
extrapolation (``_probe_cfgs``: the layer units, ``flops_remat`` = 4/3 x
at ``remat="full"``) is kept so records stay comparable; since the port
counts every layer directly, ``cost`` holds the direct full-depth count
(with ``torch.utils.checkpoint``'s recompute in it at ``remat="full"``).

Usage (outputs land in ``build/dryrun/``):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-9b --shape decode_32k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--mesh single|multi|both]
  (add ``--device cpu`` off the card)
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import json
import pathlib
import sys
import time
import weakref

import torch

from repro_torch import configs
from repro_torch.configs.base import SHAPES
from repro_torch.distributed import sharding as SH
from repro_torch.models import module as M
from repro_torch.models import transformer as T
from repro_torch.models.module import P

OUT_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "dryrun"

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")
# functional-collective op name -> the reference's collective
_COLL_OF = (("all_gather", "all-gather"), ("all_reduce", "all-reduce"),
            ("reduce_scatter", "reduce-scatter"),
            ("all_to_all", "all-to-all"), ("alltoall", "all-to-all"),
            ("permute", "collective-permute"))
# DTensor's own Shard -> Shard all-to-all on the card is
# ``_dtensor.shard_dim_alltoall``
_COLL_NAMESPACES = ("_c10d_functional", "c10d_functional", "_dtensor")


def _collective(name: str):
    """The reference's name of a functional collective (an op or an op
    packet's name), None for ``wait_tensor``; an unknown collective is an
    error, never a silent zero."""
    if "wait_tensor" in name:
        return None
    for key, coll in _COLL_OF:
        if key in name:
            return coll
    raise ValueError(f"collective {name!r} has no counterpart among "
                     f"{_COLLECTIVES}")


_PKG = str(pathlib.Path(__file__).resolve().parents[1])
# the mechanism of a gather, not its place in the model
_NOT_SITES = ("distributed/sharding.py", "launch/dryrun.py")


def _site() -> str:
    """The innermost function of the port's models, entry points or
    trainer on the Python stack ("models/attention.py:mha_decode"): where
    a collective was asked for.  Autograd runs a backward from C++, so a
    collective of the backward with no model frame above it (a
    recompute has one) is "backward"."""
    f = sys._getframe(1)
    while f is not None:
        name = f.f_code.co_filename
        if name.startswith(_PKG):
            rel = name[len(_PKG) + 1:]
            if torch._C._current_graph_task_id() != -1 and \
                    not rel.startswith(("models/", "serve/")):
                return "backward"
            if not rel.endswith(_NOT_SITES):
                return f"{rel}:{f.f_code.co_name}"
        f = f.f_back
    return "backward" if torch._C._current_graph_task_id() != -1 else "?"


def _tensors(tree):
    """The tensor leaves of nested dicts / tuples / lists."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _tensors(v)


def _local(t):
    """This rank's shard of a placed tensor; a plain one as it is."""
    return t.to_local() if SH.is_placed(t) else t


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


# metadata queries and allocations: no bytes move
_NO_TRAFFIC = {"empty", "empty_strided", "empty_like", "new_empty",
               "new_empty_strided", "size", "sym_size", "stride",
               "sym_stride", "storage_offset", "sym_storage_offset", "numel",
               "sym_numel", "dim", "is_contiguous", "sym_is_contiguous",
               "is_strides_like_format", "is_non_overlapping_and_dense",
               "lift_fresh", "_local_scalar_dense"}


class CostCounter:
    """A dispatch mode that counts this rank's FLOPs, bytes, collectives
    and live memory over what runs under it.  Enter it after the fake
    mode (``trace``); a ``DTensor`` op is handed back to DTensor
    (``NotImplemented``), whose local ops then come here."""

    def __init__(self):
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils.flop_counter import flop_registry
        counter = self
        self.flops = 0
        self.bytes = 0
        self.coll = {k: 0 for k in _COLLECTIVES}
        self.coll_counts = {k: 0 for k in _COLLECTIVES}
        self.coll_sites = collections.Counter()
        self.live = 0
        self.peak = 0
        self.paused = 0
        self.fake_mode = None        # the trace's: set by ``counting``
        self._seen = weakref.WeakValueDictionary()
        self._registry = flop_registry

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                return counter._dispatch(self, func, types, args,
                                         kwargs or {})
        self.mode = _Mode()

    # -- memory ------------------------------------------------------------

    def track(self, t):
        """Count ``t``'s local storage live until it is freed (once)."""
        st = _local(t).untyped_storage()
        key = id(st)
        if self._seen.get(key) is st:
            return
        n = st.nbytes()
        self._seen[key] = st
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, n)

    def _free(self, n):
        self.live -= n

    def storage_bytes(self, tree) -> int:
        """The local bytes of the distinct storages of ``tree``'s
        tensors."""
        seen = {}
        for t in _tensors(tree):
            st = _local(t).untyped_storage()
            seen[id(st)] = st.nbytes()
        return sum(seen.values())

    # -- dispatch ----------------------------------------------------------

    def _dispatch(self, mode, func, types, args, kwargs):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        if self.paused or _fake_mode() is not self.fake_mode:
            # DTensor's own bookkeeping, not this rank's work
            return func(*args, **kwargs)
        ns = func.namespace
        if ns in _COLL_NAMESPACES:
            coll = _collective(func.__name__)
            if coll is None:
                # the meta wait_tensor makes a new tensor where the card
                # waits on the collective's own result
                if any(isinstance(t, torch._subclasses.FakeTensor)
                       for t in args):
                    return args[0]
                return func(*args, **kwargs)
            out = func(*args, **kwargs)
            b = sum(_nbytes(t) for t in _tensors(out))
            b = 2 * b if coll == "all-reduce" else b
            self.coll[coll] += b
            self.coll_counts[coll] += 1
            self.coll_sites[_site()] += b
            for t in _tensors(out):
                self.track(t)
            return out
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        packet = func._overloadpacket
        # FlopCounterMode's rule: an op without a formula is decomposed
        # where it can be, and its parts counted
        if func not in self._registry and \
                func is not torch.ops.prim.device.default:
            with mode:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        if packet in self._registry:
            self.flops += self._registry[packet](*args, **kwargs,
                                                 out_val=out)
        if ns == "aten" and not func.is_view and \
                packet.__name__ not in _NO_TRAFFIC:
            self.bytes += sum(_nbytes(t) for t in _tensors((args, kwargs)))
            self.bytes += sum(_nbytes(t) for t in _tensors(out))
        for t in _tensors(out):
            self.track(t)
        return out

    @contextlib.contextmanager
    def counting(self):
        """The mode entered, with DTensor's sharding propagation paused:
        it runs each op (and its decompositions) again at the global
        shape, once per new input spec, so counting it would make the
        counts depend on what ran before."""
        from torch.distributed.tensor._sharding_prop import \
            ShardingPropagator as SP
        names = [n for n in _PROPAGATION if n in SP.__dict__]
        if "propagate" not in names:
            raise RuntimeError("this torch's DTensor has no sharding "
                               "propagator to pause; the per-device counts "
                               "would hold global-shape ops")
        saved = {n: SP.__dict__[n] for n in names}
        counter = self

        def pausing(orig):
            def run(*a, **k):
                counter.paused += 1
                try:
                    return orig(*a, **k)
                finally:
                    counter.paused -= 1
            return run
        for n, orig in saved.items():
            setattr(SP, n, pausing(orig))
        self.fake_mode = _fake_mode()
        try:
            with _host_math_unfaked(), self.mode:
                yield self
        finally:
            for n, orig in saved.items():
                setattr(SP, n, orig)


# the sharding propagator's entry points (whichever this torch has)
_PROPAGATION = ("propagate", "propagate_op_sharding_non_cached",
                "_propagate_tensor_meta_non_cached", "_propagate_tensor_meta")


def _fake_mode():
    """The fake mode in force, None outside one."""
    return torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE)


@contextlib.contextmanager
def _host_math_unfaked():
    """DTensor works out a ``_StridedShard``'s local sizes with small host
    tensors it reads back (``tolist``), which a fake mode refuses: they
    run with the fake mode unset for the block."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor import placement_types as PT
    cls = getattr(PT, "_StridedShard", None)
    name = "local_shard_size_and_offset"
    if cls is None or name not in cls.__dict__:
        yield
        return
    orig = cls.__dict__[name]
    fn = orig.__func__ if isinstance(orig, staticmethod) else orig

    def real(*a, **k):
        with unset_fake_temporarily():
            return fn(*a, **k)
    setattr(cls, name, staticmethod(real) if isinstance(orig, staticmethod)
            else real)
    try:
        yield
    finally:
        setattr(cls, name, orig)


# -- placing stand-ins ---------------------------------------------------------

def materialize(tree, specs, mesh, device, generator=None):
    """The meta tree ``tree`` as tensors on ``device`` placed on ``mesh``
    by the ``P`` tree ``specs`` (a None spec leaves the tensor plain):
    each leaf is cut to this rank's shard by ``sharding.place``, with no
    communication.  Under the fake mode they are fake; for a real run
    pass ``generator``: floats are drawn N(0, 0.02^2), integers are 0."""
    if isinstance(tree, dict):
        return {k: materialize(v, specs[k], mesh, device, generator)
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(materialize(v, s, mesh, device, generator)
                          for v, s in zip(tree, specs))
    if tree is None:
        return None
    if generator is not None and tree.dtype.is_floating_point:
        t = torch.randn(tree.shape, generator=generator, device=device,
                        dtype=tree.dtype).mul_(0.02)
    elif generator is not None:
        t = torch.zeros(tree.shape, dtype=tree.dtype, device=device)
    else:
        t = torch.empty(tree.shape, dtype=tree.dtype, device=device)
    return t if specs is None else SH.place(t, mesh, specs)


def trace(fn, args, specs, mesh, device) -> dict:
    """Run ``fn`` once on ``args`` (meta trees) placed by ``specs`` under
    fake tensors, counted: {"flops", "bytes", "coll", "coll_by_op",
    "coll_counts", "coll_sites", "memory", "trace_s"}.  The collective counts are
    ``CommDebugMode``'s; the counter's own must agree op for op."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.debug import CommDebugMode
    counter = CostCounter()
    with FakeTensorMode(allow_non_fake_inputs=True):
        placed = materialize(args, specs, mesh, device)
        arg_bytes = counter.storage_bytes(placed)
        for t in _tensors(placed):
            counter.track(t)
        t0 = time.perf_counter()
        with CommDebugMode() as comm, counter.counting():
            out = fn(*placed)
        trace_s = time.perf_counter() - t0
        out_bytes = counter.storage_bytes(out)
    del out, placed
    counts = {k: 0 for k in _COLLECTIVES}
    for op, n in comm.get_comm_counts().items():
        coll = _collective(str(op))
        if coll is not None:
            counts[coll] += n
    if counts != counter.coll_counts:
        raise RuntimeError(f"collective counts differ: CommDebugMode "
                           f"{counts}, counter {counter.coll_counts}")
    return {"flops": counter.flops, "bytes": counter.bytes,
            "coll": sum(counter.coll.values()),
            "coll_by_op": dict(counter.coll), "coll_counts": counts,
            "coll_sites": dict(counter.coll_sites.most_common()),
            "memory": {"argument_bytes": arg_bytes,
                       "output_bytes": out_bytes,
                       "temp_bytes": counter.peak - arg_bytes,
                       "peak_bytes": counter.peak},
            "trace_s": trace_s}


# -- the steps -----------------------------------------------------------------

def _batch_specs(cfg, shape_id, mesh, dist, batch=None):
    b = dist.batch_axes if dist.batch_axes else None
    mdl = "model"
    kind = SHAPES[shape_id]["kind"]
    if kind in ("train", "prefill"):
        specs = {"tokens": P(b, None)}
        if kind == "train":
            specs["labels"] = P(b, None)
        if cfg.family in ("encdec", "vlm"):
            specs["frontend"] = P(b, None, None)
        return specs
    # decode: token/pos + cache
    cache_abs = configs.input_specs(cfg, shape_id, batch=batch)["cache"]

    def cache_spec(path, leaf):
        if leaf.dim() == 5:           # (L, B, S, KV, hd) or ssm h (L,B,H,P,N)
            return P(None, b, mdl, None, None)
        if leaf.dim() == 4:           # conv state (L, B, W-1, C)
            return P(None, b, None, mdl)
        if leaf.dim() == 2:           # pos (L, S)
            return P(None, None)
        return P(*([None] * leaf.dim()))

    cache_specs = M.tree_map_with_path(cache_spec, cache_abs)
    return {"token": P(b, None), "pos": P(b, None), "cache": cache_specs}


def build_step(cfg, shape_id, mesh, batch=None):
    """(fn, args, specs): ``fn(*placed args)`` is the cell's step, ``args``
    a tuple of meta trees (shape / dtype stand-ins), ``specs`` the ``P``
    trees that place them.  train and prefill shard in
    ``cfg.train_shard_mode`` (FSDP / ZeRO-3 at 1M tokens); decode in
    "tp" (weights stationary, one token).  ``batch`` cuts the global
    batch (None: the shape's)."""
    from repro_torch.serve import engine as E
    from repro_torch.train.trainer import make_train_step
    sh = SHAPES[shape_id]
    kind = sh["kind"]
    mode = cfg.train_shard_mode if kind in ("train", "prefill") else "tp"
    dist = SH.make_dist(mesh, cfg, batch or sh["batch"], mode=mode)
    params_abs = T.init_lm(cfg, device="meta")
    p_specs = SH.param_specs(params_abs, cfg, mesh, mode=mode)
    ispecs = configs.input_specs(cfg, shape_id, batch=batch)
    b_specs = _batch_specs(cfg, shape_id, mesh, dist, batch)
    if kind == "train":
        opt_init, train_step = make_train_step(cfg, dist=dist)
        opt_abs = opt_init(params_abs)
        o_specs = SH.opt_state_specs(opt_abs, p_specs, cfg.optimizer)

        def fn(params, opt_state, batch):
            return train_step(params, opt_state, batch)
        return fn, (params_abs, opt_abs, ispecs), (p_specs, o_specs, b_specs)
    if kind == "prefill":
        def fn(params, batch):
            with torch.no_grad():
                return E.prefill(params, cfg, batch["tokens"],
                                 frontend=batch.get("frontend"), dist=dist)
        return fn, (params_abs, ispecs), (p_specs, b_specs)

    def fn(params, batch):
        with torch.no_grad():
            return T.decode_step(params, cfg, batch["token"], batch["cache"],
                                 batch["pos"], dist=dist)
    return fn, (params_abs, ispecs), (p_specs, b_specs)


def _probe_cfgs(cfg):
    """Two reduced-depth configs (u1, u2 layer units) for cost
    extrapolation, the reference's: its XLA cost analysis counts a scan
    body once, so the per-step cost is  c(u1) + (units-1) * (c(u2) -
    c(u1)).  The port counts every layer, so at ``remat="none"`` this
    equals its direct count."""
    if cfg.family == "vlm":
        k = cfg.cross_attn_interval
        units = cfg.n_layers // k
        return (cfg.replace(n_layers=k, unroll_layers=True, remat="none"),
                cfg.replace(n_layers=2 * k, unroll_layers=True,
                            remat="none"), units)
    if cfg.family == "encdec":
        assert cfg.n_layers == cfg.n_enc_layers
        return (cfg.replace(n_layers=1, n_enc_layers=1, unroll_layers=True,
                            remat="none"),
                cfg.replace(n_layers=2, n_enc_layers=2, unroll_layers=True,
                            remat="none"), cfg.n_layers)
    return (cfg.replace(n_layers=1, unroll_layers=True, remat="none"),
            cfg.replace(n_layers=2, unroll_layers=True, remat="none"),
            cfg.n_layers)


def _costs(cfg, shape_id, mesh, device):
    fn, args, specs = build_step(cfg, shape_id, mesh)
    return trace(fn, args, specs, mesh, device)


def probe_extrapolated(cfg, shape_id, mesh, device="cuda") -> dict:
    """Per-device per-step cost from the L=1 / L=2 probes."""
    c1_cfg, c2_cfg, units = _probe_cfgs(cfg)
    c1 = _costs(c1_cfg, shape_id, mesh, device)
    c2 = _costs(c2_cfg, shape_id, mesh, device)
    out = {}
    for k in ("flops", "bytes", "coll"):
        out[k] = c1[k] + (units - 1) * (c2[k] - c1[k])
    out["coll_by_op"] = {
        k: c1["coll_by_op"][k]
        + (units - 1) * (c2["coll_by_op"][k] - c1["coll_by_op"][k])
        for k in _COLLECTIVES}
    out["units"] = units
    out["probe_l1"] = {k: c1[k] for k in ("flops", "bytes", "coll")}
    out["probe_l2"] = {k: c2[k] for k in ("flops", "bytes", "coll")}
    # remat correction, the reference's formula: the probes run without
    # remat; with remat="full" the backward pass recomputes each layer
    # forward (~ +1/3 of train flops).  ``cost.flops`` holds the count
    # with the recompute in it.
    if SHAPES[shape_id]["kind"] == "train" and cfg.remat == "full":
        out["flops_remat"] = out["flops"] * 4.0 / 3.0
    return out


@contextlib.contextmanager
def fake_group(world: int):
    """A "fake" process group of ``world`` ranks at rank 0 for the block,
    when none is running (a running group is used as it is)."""
    import torch.distributed as dist
    if dist.is_initialized():
        yield
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def run_cell(arch: str, shape_id: str, multi_pod: bool, save=True,
             verbose=True, probe=True, device="cuda", out_dir=None) -> dict:
    from repro_torch.launch.mesh import make_production_mesh
    cfg = configs.get(arch)
    ok, why = configs.cell_is_supported(cfg, shape_id)
    mesh_name = "multi" if multi_pod else "single"
    rec = {"arch": arch, "shape": shape_id, "mesh": mesh_name}
    if not ok:
        rec["status"] = why
        if save:
            _save(rec, out_dir)
        return rec
    with fake_group(512 if multi_pod else 256):
        mesh = make_production_mesh(multi_pod=multi_pod, device=device)
        c = _costs(cfg, shape_id, mesh, device)
        coll = dict(c["coll_by_op"], total=c["coll"],
                    counts=c["coll_counts"])
        rec.update({
            "status": "OK",
            "n_devices": mesh.size(),
            "trace_s": round(c["trace_s"], 2),
            "memory": c["memory"],
            "cost": {"flops": c["flops"], "bytes accessed": c["bytes"]},
            "collectives": coll,
            "collective_sites": c["coll_sites"],
        })
        if probe and not multi_pod:
            # single-pod only: the roofline table reads these
            rec["extrapolated"] = probe_extrapolated(cfg, shape_id, mesh,
                                                     device)
    if verbose:
        print(f"[{arch} × {shape_id} × {mesh_name}] OK "
              f"trace={c['trace_s']:.1f}s flops={c['flops']} "
              f"bytes={c['bytes']} coll={c['coll'] / 1e9:.2f}GB "
              f"peak={c['memory']['peak_bytes']}")
        print("  memory:", rec["memory"])
        print("  collectives:", coll)
    if save:
        _save(rec, out_dir)
    return rec


def _save(rec, out_dir=None):
    out = pathlib.Path(out_dir or OUT_DIR)
    out.mkdir(parents=True, exist_ok=True)
    p = out / f"{rec['arch']}__{rec['shape']}__{rec['mesh']}.json"
    p.write_text(json.dumps(rec, indent=1))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="the fake tensors' and the mesh's device type "
                         "(never falls back to the CPU); cpu off the card")
    ap.add_argument("--out", default=str(OUT_DIR),
                    help="where the records land")
    args = ap.parse_args(argv)

    arch_ids = list(configs.ALIASES) if (args.all or not args.arch) \
        else [args.arch]
    shape_ids = list(SHAPES) if (args.all or not args.shape) \
        else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    failures = []
    for arch in arch_ids:
        for shape_id in shape_ids:
            for mp in meshes:
                mesh_name = "multi" if mp else "single"
                if args.skip_existing and (
                        pathlib.Path(args.out)
                        / f"{arch}__{shape_id}__{mesh_name}.json").exists():
                    continue
                try:
                    run_cell(arch, shape_id, mp, device=args.device,
                             out_dir=args.out)
                except Exception as e:  # noqa: BLE001 — record and continue
                    import traceback
                    print(traceback.format_exc()[-3000:])
                    print(f"[{arch} × {shape_id} × {mesh_name}] FAIL: {e}")
                    failures.append((arch, shape_id, mp, str(e)[:2000]))
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print(" ", f[:3], f[3][:200])
        raise SystemExit(1)
    print("\nAll dry-run cells passed.")


if __name__ == "__main__":
    main()
