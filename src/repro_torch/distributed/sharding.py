"""Sharding policy (the reference's ``repro.distributed.sharding``): param
partition rules per architecture, the activation constraints of the
``Dist`` helper threaded through the model code, the placement of packed
layouts, and int8 gradient compression.

The program is global-view, as the reference's: every tensor is the
whole array, and a spec (``models.module.P``) says how it is split over
a named ``DeviceMesh`` (axes ("data", "model") or ("pod", "data",
"model")).  A placed tensor is a ``torch.distributed.tensor.DTensor``; a
constraint is a ``redistribute`` to the spec's placements, which keeps
the values.  A plain tensor that meets a constraint is placed without
communication: every rank holds it whole, so each keeps its own piece.
Batch / DP shards over (pod, data); TP / EP / SP over model; FSDP (weights
and optimizer state sharded over the data axes) for the >= 70B archs.

The spec functions read only ``mesh.shape`` by axis name, so they take a
``DeviceMesh`` or any stand-in whose ``shape`` maps names to sizes (the
dry run's and the tests' meshes).
"""
from __future__ import annotations

import dataclasses
import re
from dataclasses import dataclass

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import module as M
from repro_torch.models.module import P


def mesh_shape(mesh) -> dict:
    """Axis name -> size, of a ``DeviceMesh`` (its dim names and shape)
    or of a stand-in whose ``shape`` is already that mapping."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


# -- placement without communication ------------------------------------------

def is_placed(t) -> bool:
    """True for a ``DTensor`` (a tensor placed on a mesh)."""
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def split_dims(x, dim) -> list:
    """The mesh dims that split ``dim`` of a placed ``x`` ([] for a plain
    one)."""
    return [i for i, pl in enumerate(getattr(x, "placements", ()))
            if pl.is_shard(dim)]


def split_ways(x, dim) -> int:
    """Into how many chunks ``dim`` of ``x`` is split (1 if whole)."""
    ways = 1
    for i in split_dims(x, dim):
        ways *= x.device_mesh.size(i)
    return ways


def unsplit(x, dim):
    """A placed ``x`` with ``dim`` gathered whole (a ``Replicate`` on each
    mesh dim that split it); anything else as it is."""
    cut = split_dims(x, dim)
    if not cut:
        return x
    from torch.distributed.tensor import Replicate
    return x.redistribute(x.device_mesh, [
        Replicate() if i in cut else pl for i, pl in enumerate(x.placements)])


def place(t, mesh, spec):
    """The global tensor ``t``, which every rank holds whole, as a
    ``DTensor`` of ``spec`` on ``mesh``: each rank keeps its own chunk
    (``torch.chunk`` order, mesh dims left to right, copied out of
    ``t``), so nothing is communicated.  A replicated placement wraps
    ``t`` itself (no copy)."""
    from torch.distributed.tensor import DTensor, Shard
    placements = P(*spec).placements(mesh)
    coord = mesh.get_coordinate()
    local = t
    for mdim, pl in enumerate(placements):
        if isinstance(pl, Shard):
            # DTensor's split: pieces of ceil(n / k), the last ones short
            # or empty
            n = local.shape[pl.dim]
            size = -(-n // mesh.size(mdim))
            start = min(coord[mdim] * size, n)
            local = local.narrow(pl.dim, start, min(size, n - start))
    if local is not t:
        # a copy even where the chunk is a contiguous view (a dim-0
        # split): the rank keeps its chunk alone, not the whole storage
        local = local.clone(memory_format=torch.contiguous_format)
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=t.shape, stride=t.stride())


def full(t):
    """A placed tensor gathered whole (every rank the same full tensor;
    differentiable); anything else as it is."""
    return t.full_tensor() if is_placed(t) else t


def full_tree(tree):
    """``full`` over a nested dict / tuple tree."""
    if isinstance(tree, dict):
        return {k: full_tree(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(full_tree(v) for v in tree)
    return full(tree)


def replicated(fn):
    """Run ``fn`` on whole local tensors: its placed tensor arguments are
    gathered (a ``redistribute`` to replicated, the collective listed in
    PERF.md for each caller), and its tensor results are placed back as
    replicated ``DTensor``s on the same mesh.  Where DTensor has no
    sharding rule for an op, the region runs this way instead of failing
    or gathering op by op."""
    def run(*args, **kw):
        from torch.distributed.tensor import DTensor, Replicate
        mesh = None

        def loc(a):
            nonlocal mesh
            if isinstance(a, DTensor):
                mesh = a.device_mesh
                return a.redistribute(
                    mesh, [Replicate()] * mesh.ndim).to_local()
            return a
        out = fn(*[loc(a) for a in args],
                 **{k: loc(v) for k, v in kw.items()})
        if mesh is None:
            return out

        def back(o):
            if isinstance(o, torch.Tensor):
                return DTensor.from_local(o, mesh, [Replicate()] * mesh.ndim,
                                          run_check=False)
            if isinstance(o, tuple):
                return tuple(back(v) for v in o)
            return o
        return back(out)
    return run


def _local_piece(t, value, dim):
    """(t's local shard, the whole ``value`` cut to that shard on every
    split dim but ``dim``, the shard's offset along ``dim``): ``place``'s
    split, chunks of ceil(n / k), the last ones short."""
    from torch.distributed.tensor import Shard
    mesh, coord = t.device_mesh, t.device_mesh.get_coordinate()
    sizes, offset = list(t.shape), 0
    for mdim, pl in enumerate(t.placements):
        if not isinstance(pl, Shard):
            continue
        n = sizes[pl.dim]
        size = -(-n // mesh.size(mdim))
        start = min(coord[mdim] * size, n)
        sizes[pl.dim] = min(size, n - start)
        if pl.dim == dim:
            offset += start
        else:
            value = value.narrow(pl.dim, start, sizes[pl.dim])
    return t.to_local(), value, offset


def index_copy(t, dim, index, value):
    """``t.index_copy_(dim, index, value)`` (value cast to t's dtype) for
    a whole ``t`` or a placed one.  A placed ``t`` is written on each
    rank's own shard: the whole value is cut to the shard on every other
    split dim, and an index on a split ``dim`` lands on the one rank
    whose chunk holds it (the others write back what they hold), with no
    collective and no host read.  DTensor's own ``index_copy_`` on a
    split ``dim`` relabels the shard replicated instead."""
    value = full(value).to(t.dtype)
    if not is_placed(t):
        return t.index_copy_(dim, index, value)
    local, value, offset = _local_piece(t, value, dim)
    li = index - offset
    inside = (li >= 0) & (li < local.shape[dim])
    li = li.clamp(0, max(local.shape[dim] - 1, 0))
    shape = [1] * value.dim()
    shape[dim] = -1
    old = local.index_select(dim, li)
    local.index_copy_(dim, li, torch.where(inside.reshape(shape), value,
                                           old))
    return t


def set_index(t, i: int, value):
    """``t[i] = value`` for a whole ``t`` or a placed one whose dim 0 is
    not split (a layer of a stacked cache): each rank writes its own
    shard, as ``index_copy``."""
    value = full(value)
    if not is_placed(t):
        t[i] = value
        return t
    if any(pl.is_shard(0) for pl in t.placements):
        raise ValueError("set_index writes along an unsplit dim 0")
    local, value, _ = _local_piece(t, value[None], 0)
    local[i] = value[0]
    return t


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh: the reference's ``jax.sharding.NamedSharding``."""
    mesh: object
    spec: P


def distribute(tree, shardings):
    """Place every tensor leaf of ``tree`` by the matching
    ``NamedSharding`` of ``shardings`` (a tree of the same structure; a
    None sharding or leaf leaves the leaf alone)."""
    if isinstance(tree, dict):
        return {k: distribute(v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(distribute(v, s) for v, s in zip(tree, shardings))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f: distribute(getattr(tree, f), getattr(shardings, f))
            for f in layout_leaf_fields(tree)})
    if tree is None or shardings is None:
        return tree
    return place(tree, shardings.mesh, shardings.spec)


# -- the activation constraints ----------------------------------------------

@dataclass
class Dist:
    """The reference's ``Dist``: the mesh, the batch axes (() when the
    global batch does not divide the data-parallel degree), the model
    axis, what divides the model axis, and the mode ("tp" | "fsdp")."""
    mesh: object
    batch_axes: tuple = ("data",)
    model_axis: str = "model"
    kv_shardable: bool = True       # n_kv_heads % tp == 0
    expert_sharded: bool = False    # n_experts % tp == 0
    vocab_shardable: bool = True    # vocab % tp == 0
    mode: str = "tp"                # "tp" | "fsdp" (see ArchConfig)

    @property
    def tp(self):
        return mesh_shape(self.mesh)[self.model_axis]

    @property
    def dp(self):
        d = 1
        for a in self.batch_axes:
            d *= mesh_shape(self.mesh)[a]
        return d

    def _c(self, x, *spec):
        """``x`` constrained to ``P(*spec)``: a placed tensor is
        redistributed (values kept), a plain one placed."""
        if not isinstance(x, torch.Tensor):
            return x
        spec = P(*spec)
        if is_placed(x):
            want = spec.placements(self.mesh)
            if tuple(x.placements) == want:
                return x
            return x.redistribute(self.mesh, want)
        return place(x, self.mesh, spec)

    def _b(self):
        return self.batch_axes if self.batch_axes else None

    def gather(self, x):
        """``x`` whole on this rank (``full``): a collective for a placed
        tensor."""
        return full(x)

    def replicated(self, fn):
        """``fn`` run on whole tensors (``replicated``)."""
        return replicated(fn)

    def local_map(self, fn, in_dims, out_dims):
        """``fn`` run on each rank's pieces, for work that is independent
        along a dim (the attention per head or per query block, the SSD
        scan per head, the expert combine per expert).  ``in_dims[i]``
        says how argument i is cut: an int d splits dim d over the model
        axis (and dim 0, a batch dim, over the batch axes), "b" splits
        only the batch dim 0, None passes it whole.  ``out_dims[j]`` says
        how result j is put back: the same, or "partial" for a sum still
        to be reduced over the model axis.  Placing the arguments is the
        only collective; when the model axis does not divide a split dim
        the whole tensors run (``replicated``)."""
        from torch.distributed.tensor import DTensor, Partial

        def spec(shape, d):
            s = [None] * len(shape)
            if d is not None and d != 0 and \
                    shape[0] % max(self.dp, 1) == 0:
                s[0] = self._b()
            if isinstance(d, int):
                s[d] = self.model_axis
            return P(*s)

        def run(*args):
            if any(isinstance(d, int) and a.shape[d] % self.tp
                   for a, d in zip(args, in_dims)):
                return replicated(fn)(*args)
            locs = []
            for a, d in zip(args, in_dims):
                if d is None:
                    locs.append(full(a))
                else:
                    locs.append(self._c(a, *spec(a.shape, d)).to_local())
            lead = next(a for a, d in zip(args, in_dims) if d not in (None, 0))
            res = []
            for o, d in zip(fn(*locs), out_dims):
                shape = list(o.shape)
                if isinstance(d, int):
                    shape[d] *= self.tp
                if d is not None and d != 0:
                    shape[0] = lead.shape[0]
                pl = spec(shape, "b" if d == "partial" else d).placements(
                    self.mesh)
                if d == "partial":
                    i = self.mesh.mesh_dim_names.index(self.model_axis)
                    pl = pl[:i] + (Partial(),) + pl[i + 1:]
                res.append(DTensor.from_local(
                    o.contiguous(), self.mesh, pl, run_check=False,
                    shape=torch.Size(shape),
                    stride=torch.empty(shape, device="meta").stride()))
            return tuple(res)
        return run

    def region(self):
        """The context every entry point runs its model under: plain
        tensors made inside the model (positions, masks, rope tables,
        caches) meet placed ones as replicated."""
        from torch.distributed.tensor.experimental import implicit_replication
        return implicit_replication()

    def place_batch(self, t):
        """An entry point's input, dim 0 its batch: sharded over the batch
        axes when that dim divides their degree, else replicated (the
        reference's batch specs, ``launch/dryrun.py``)."""
        if t is None:
            return None
        b = self._b() if t.shape[0] % max(self.dp, 1) == 0 else None
        return self._c(t, b, *([None] * (t.dim() - 1)))

    # -- activation constraints used inside models --------------------------
    def shard_activations(self, x):            # (B, S, D)
        return self.shard_residual(x)

    def shard_residual(self, x):               # (B, S, D)
        """Megatron-style sequence-parallel residual stream: the seq dim
        is sharded over the model axis between blocks; replicated when it
        does not divide (decode: seq 1)."""
        if x.shape[1] % self.tp == 0:
            return self._c(x, self._b(), self.model_axis, None)
        return self._c(x, self._b(), None, None)

    def shard_logits(self, x):                 # (B, S, V)
        if self.mode == "fsdp" or not self.vocab_shardable:
            if x.shape[1] % self.tp == 0:
                return self._c(x, self._b(), self.model_axis, None)
            return self._c(x, self._b(), None, None)
        return self._c(x, self._b(), None, self.model_axis)

    def shard_attn_q(self, q, mode):           # (B, S, H, hd)
        if self.mode == "fsdp" or mode == "seq":
            # context-parallel: q seq-sharded, full heads per device
            if q.shape[1] % self.tp == 0:
                return self._c(q, self._b(), self.model_axis, None, None)
            return q
        return self._c(q, self._b(), None, self.model_axis, None)

    def shard_attn_kv(self, k, mode, n_kv):    # (B, S, KV, hd)
        if self.mode == "fsdp" or mode == "seq":
            return self._c(k, self._b(), None, None, None)
        if mode == "heads" and self.kv_shardable:
            return self._c(k, self._b(), None, self.model_axis, None)
        return self._c(k, self._b(), None, None, None)

    def shard_cache(self, c):                  # (B, S, KV, hd): S-sharded
        return self._c(c, self._b(), self.model_axis, None, None)

    def shard_heads(self, x):                  # ssm (B, S, H, P)
        return self._c(x, self._b(), None, self.model_axis, None)

    def shard_experts(self, x):                # moe (G, E, C, D)
        if self.expert_sharded:
            g = self._b() if x.shape[0] % max(self.dp, 1) == 0 and \
                self.batch_axes else None
            return self._c(x, g, self.model_axis, None, None)
        return x


def make_dist(mesh, cfg: ArchConfig, global_batch: int,
              mode: str = "tp") -> Dist:
    shape = mesh_shape(mesh)
    axes = [a for a in ("pod", "data") if a in shape]
    dp = 1
    for a in axes:
        dp *= shape[a]
    batch_axes = tuple(axes) if global_batch % dp == 0 else ()
    tp = shape["model"]
    return Dist(mesh=mesh, batch_axes=batch_axes,
                kv_shardable=(cfg.n_kv_heads % tp == 0) if cfg.n_kv_heads
                else False,
                expert_sharded=(cfg.n_experts % tp == 0) if cfg.n_experts
                else False,
                vocab_shardable=cfg.vocab % tp == 0,
                mode=mode)


# -- packed-layout partition specs (tensor-parallel sharded layouts) ----------

def layout_leaf_fields(layout):
    """The tensor (or tuple-of-tensor) fields of a ``PackedLayout`` /
    ``TapLayout``."""
    from repro_torch.core.packed import PackedLayout
    if isinstance(layout, PackedLayout):
        return ("values", "k_idx", "nnz", "perm", "inv_perm", "scales")
    return ("values", "t_idx", "nnz", "alive", "perm", "inv_perm", "k_full",
            "scales")


def _axis_at(leaf, pos, axis):
    """P with ``axis`` at dim ``pos`` of ``leaf``, None-safe."""
    if leaf is None:
        return None
    spec = [None] * leaf.dim()
    spec[pos] = axis
    return P(*spec)


def _replicated(leaf):
    return None if leaf is None else P()


def _tmap(fn, leaf):
    """``fn`` over a leaf, or over each bin of a per-bin tuple of them (a
    spec ``P`` is a leaf, not a tuple of bins)."""
    if leaf is None:
        return None
    if isinstance(leaf, tuple) and not isinstance(leaf, P):
        return tuple(fn(x) for x in leaf)
    return fn(leaf)


def layout_partition_specs(layout, model_axis: str = "model"):
    """Per-leaf ``P`` layout for a ``PackedLayout`` / ``TapLayout`` (the
    same class, each tensor leaf replaced by its spec).  A column-sharded
    layout (``n_shards`` > 0) maps its shard stack dim, the last stack
    dim, onto the model axis: values at ndim - 5 (tap: ndim - 4), and the
    index, nnz, perm and scale leaves at the same absolute dim;
    ``inv_perm`` and ``alive`` stay replicated (the merge gathers through
    them).  An unsharded layout replicates every leaf."""
    from repro_torch.core.packed import PackedLayout
    fields = layout_leaf_fields(layout)
    if not layout.n_shards:
        return dataclasses.replace(layout, **{
            f: _tmap(lambda _: P(), getattr(layout, f)) for f in fields})
    lead = layout.values[0].dim() - (5 if isinstance(layout, PackedLayout)
                                     else 4)

    def shard(x):
        return _axis_at(x, lead, model_axis)
    out = dataclasses.replace(
        layout, values=_tmap(shard, layout.values), nnz=shard(layout.nnz),
        perm=shard(layout.perm), inv_perm=_replicated(layout.inv_perm),
        scales=_tmap(shard, layout.scales))
    if isinstance(layout, PackedLayout):
        return dataclasses.replace(out, k_idx=_tmap(shard, layout.k_idx))
    return dataclasses.replace(out, t_idx=_tmap(shard, layout.t_idx),
                               k_full=_tmap(shard, layout.k_full),
                               alive=_replicated(layout.alive))


def expert_layout_specs(layout, model_axis: str = "model"):
    """Specs for an expert-parallel MoE layout stack: every tensor leaf
    carries the expert axis in front, so each shards at dim 0 over the
    model axis; column sharding must never reach these layouts."""
    assert layout.n_shards == 0, \
        "expert layouts shard along experts, not block columns"
    return dataclasses.replace(layout, **{
        f: _tmap(lambda x: _axis_at(x, 0, model_axis), getattr(layout, f))
        for f in layout_leaf_fields(layout)})


def layout_shardings(layout, mesh, model_axis: str = "model", specs=None):
    """``NamedSharding`` layout for ``layout`` on ``mesh`` (its
    ``layout_partition_specs``, or the given ``specs``)."""
    specs = specs if specs is not None else \
        layout_partition_specs(layout, model_axis)
    return dataclasses.replace(specs, **{
        f: _tmap(lambda s: NamedSharding(mesh, s), getattr(specs, f))
        for f in layout_leaf_fields(specs)})


def place_layout(layout, mesh, specs=None, model_axis: str = "model"):
    """``layout`` with every tensor leaf placed on ``mesh`` by its spec
    (``layout_partition_specs`` unless ``specs`` is given, e.g.
    ``expert_layout_specs``)."""
    return distribute(layout, layout_shardings(layout, mesh, model_axis,
                                               specs))


def gather_layout(layout):
    """A placed layout with every leaf gathered whole (``full``): what
    ``core.validate`` checks; the layout itself when not placed."""
    if not is_placed(layout.nnz):
        return layout
    return dataclasses.replace(layout, **{
        f: _tmap(full, getattr(layout, f))
        for f in layout_leaf_fields(layout)})


def shard_packed_tree(params, mesh, model_axis: str = "model"):
    """Place every ``"packed"`` layout of a compiled param tree by its
    ``layout_partition_specs`` (column-sharded leaves split over the
    model axis, everything else replicated): the step between
    ``compile_model(spec=CompileSpec(tp=...))`` and serving on a mesh.
    Non-layout leaves are left alone."""
    from repro_torch.core.packed import PackedLayout, TapLayout

    def walk(node):
        if not isinstance(node, dict):
            return node
        out = {k: walk(v) for k, v in node.items()}
        pk = out.get("packed")
        if isinstance(pk, (PackedLayout, TapLayout)):
            out["packed"] = place_layout(pk, mesh, model_axis=model_axis)
        return out

    return walk(params)


# -- param partition rules (path regex -> right-aligned spec) -----------------

def _fsdp_axes(mesh):
    return tuple(a for a in ("pod", "data") if a in mesh_shape(mesh))


def needs_fsdp(cfg: ArchConfig) -> bool:
    """FSDP when a model-only shard of the Adam state would not fit
    (the >= ~30B archs)."""
    return cfg.name in ("kimi-k2-1t-a32b", "llama-3.2-vision-90b")


def param_rules(cfg: ArchConfig, mesh):
    shape = mesh_shape(mesh)
    f = _fsdp_axes(mesh) if needs_fsdp(cfg) else None
    mdl = "model"
    tp = shape[mdl]
    return [
        # MoE experts (E, D, F) / (E, F, D): EP when the experts divide,
        # else TP on the hidden dim; FSDP on D for the 1T arch
        (r"moe/(gate|up)/w", P(mdl, f, None) if cfg.n_experts % tp == 0
         else P(None, f, mdl)),
        (r"moe/down/w", P(mdl, None, f) if cfg.n_experts % tp == 0
         else P(None, mdl, f)),
        (r"moe/router", P()),
        (r"attn/wq/w|xattn/wq/w", P(f, mdl)),
        (r"attn/w[kv]/w|xattn/w[kv]/w",
         P(f, mdl) if cfg.n_kv_heads % tp == 0 else P(f, None)),
        (r"attn/wo/w|xattn/wo/w", P(mdl, f)),
        (r"ffn/(gate|up)/w", P(f, mdl)),
        (r"ffn/down/w", P(mdl, f)),
        (r"ssm/in_proj/w", P(f, mdl)),
        (r"ssm/out_proj/w", P(mdl, f)),
        (r"ssm/(conv|A_log|D|dt_bias|norm)", P()),
        # embeddings: vocab-sharded over model; odd vocabs d_model-sharded
        (r"embed/table|head/table",
         P(mdl, f) if cfg.vocab % tp == 0 else P(None, mdl)),
        (r"ln|norm|gate$|scale|b$", P()),
    ]


def _fsdp_axis_options(mesh):
    axes = _fsdp_axes(mesh)
    opts = [axes + ("model",), ("model",)]
    if axes:
        opts.append(axes)
    return opts


def _size(combo, shape):
    n = 1
    for a in combo:
        n *= shape[a]
    return n


def _entry(combo):
    return combo if len(combo) > 1 else combo[0]


def fsdp_leaf_spec(shape, mesh) -> P:
    """ZeRO-3 spec: one dim split over as many mesh axes as divide it
    (the output dim first, then the input dim, else replicated)."""
    ms = mesh_shape(mesh)
    for dim in (len(shape) - 1, max(len(shape) - 2, 0)):
        for combo in _fsdp_axis_options(mesh):
            size = _size(combo, ms)
            if shape[dim] % size == 0 and shape[dim] >= size:
                spec = [None] * len(shape)
                spec[dim] = _entry(combo)
                return P(*spec)
    return P()


def param_specs(params, cfg: ArchConfig, mesh, mode: str = "tp"):
    """The ``P`` tree of a dense param tree (leaves need only ``shape``:
    meta tensors do).  "tp": the path rules.  "fsdp" (training): dense
    weights ZeRO-3 sharded, MoE experts on the EP rules, scalars
    replicated."""
    if mode == "tp":
        return M.spec_from_rules(params, param_rules(cfg, mesh))
    ms = mesh_shape(mesh)
    moe_rules = [(pat, s) for pat, s in param_rules(cfg, mesh)
                 if pat.startswith("moe")]

    def assign(s, leaf):
        shape = tuple(leaf.shape)
        nd = len(shape)
        for pat, spec in moe_rules:
            if re.search(pat, s):
                pad = nd - len(spec)
                return P(*([None] * max(pad, 0) + list(spec))) if pad >= 0 \
                    else P(*spec[-nd:])
        if nd < 2 or re.search(r"ln|norm|gate$|scale|A_log|dt_bias|D$", s):
            return P()
        if "head/table" in s:
            # vocab-sharded output head (vocab-parallel loss)
            for combo in _fsdp_axis_options(mesh):
                if shape[0] % _size(combo, ms) == 0:
                    return P(_entry(combo), None)
            return fsdp_leaf_spec(shape, mesh)
        if "embed/table" in s:
            # D-sharded input embedding (lookups stay local)
            for combo in _fsdp_axis_options(mesh):
                if shape[1] % _size(combo, ms) == 0:
                    return P(None, _entry(combo))
            return P()
        # the stacked-layer leading dim takes no part in the decision
        stacked = nd >= 3 and any(t in s for t in
                                  ("layers", "enc/", "dec/", "groups"))
        core = shape[1:] if stacked else shape
        spec = fsdp_leaf_spec(core, mesh)
        pad = nd - len(spec)
        return P(*([None] * max(pad, 0) + list(spec)))

    return M.tree_map_with_path(assign, params)


def param_shardings(params, cfg: ArchConfig, mesh, mode: str = "tp"):
    """``NamedSharding`` tree of ``param_specs``; ``distribute(params,
    param_shardings(...))`` places the params."""
    return M.tree_map(lambda s: NamedSharding(mesh, s),
                      param_specs(params, cfg, mesh, mode))


def opt_state_specs(opt_abs, p_specs, kind: str):
    """Optimizer-state specs mirroring the param specs.  AdamW's m / v
    share the param spec; Adafactor's factored vr / vc drop the last /
    second-to-last dim of it."""
    if kind == "adamw":
        return {"m": p_specs, "v": p_specs, "step": P()}
    assert kind == "adafactor"

    def fspec(pspec, fdict):
        if "vr" in fdict:
            s = list(pspec)
            return {"vr": P(*s[:-1]), "vc": P(*(s[:-2] + s[-1:]))}
        return {"v": pspec}

    def walk(specs, fstate):
        if isinstance(specs, dict):
            return {k: walk(v, fstate[k]) for k, v in specs.items()}
        return fspec(specs, fstate)
    return {"f": walk(p_specs, opt_abs["f"]), "step": P()}


# -- gradient compression (int8 stochastic rounding) --------------------------

def quantize_int8(x, generator=None):
    """x -> (int8 q, fp32 scale): scale amax / 127, q = round(x / scale +
    U(-0.5, 0.5)) clipped to +-127.  The noise comes from ``generator``
    (a ``torch.Generator`` on x's device): the reference's distribution,
    not its draws."""
    xf = x.float()
    amax = torch.max(torch.abs(xf)) + 1e-12
    scale = amax / 127.0
    noise = torch.rand(x.shape, generator=generator, dtype=torch.float32,
                       device=x.device) - 0.5
    q = torch.clamp(torch.round(xf / scale + noise), -127, 127).to(
        torch.int8)
    return q, scale


def dequantize_int8(q, scale):
    return q.float() * scale


def compressed_allreduce(x, generator=None, mesh=None,
                         axis_name: str = "model"):
    """The int8-quantized sum of ``x`` over the ranks of ``mesh``'s
    ``axis_name``: quantized, dequantized, then one ``all_reduce`` over
    that axis's group (the reference's psum; its wire payload is modelled,
    as there).  Without a mesh, the dequantized ``x`` of one rank."""
    q, scale = quantize_int8(x, generator)
    xs = dequantize_int8(q, scale)
    if mesh is not None:
        import torch.distributed as dist
        dist.all_reduce(xs, group=mesh.get_group(axis_name))
    return xs
