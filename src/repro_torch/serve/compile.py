"""Model "codegen" (paper §4.3): pruning masks + per-layer scheme mapping
-> packed execution params.

``compile_model`` packs every block-pruned linear layer of a param tree
into a ``core.packed.PackedLayout`` and installs it as
``params[...]["packed"]``, so ``models.layers.linear`` runs it on the BCS
kernel.  Conv layers pack too: block-punched convs as the PackedLayout of
their im2col-lowered weight (with its ``conv_taps``), pattern/connectivity
convs as a ``TapLayout``; ``models.convnet`` dispatches on the type.
Row reordering for load balance (Fig 4) happens here by default
(``reorder=True``).  Stacked layer weights are packed slice by slice and
every slice's per-bin degree is padded to the stack max (``_pack_stacked``)
so one layout serves the whole stack.

``spec.value_dtype="int8"`` turns on the quantized value path
(``core.quant``): packed values are stored int8 with fp32 scale leaves and
the kernels dequantize on the card; a per-layer ``SchemeChoice.value_dtype``
overrides the spec.  ``spec.tp`` > 1 packs tensor-parallel layouts: each
layer's block columns (a pattern conv's filters) are spread over ``tp``
shards by degree (``core.bcs.shard_columns``); MoE expert stacks and
layers that ``tp`` does not divide stay unsharded, and the report's
``shards`` says which layers shard.

``compile_model(artifact_dir=)`` looks the model up in the crash-safe
artifact store (``serve.artifacts``) first and publishes a fresh pack
there.  ``degrade_invalid_layers`` validates every packed layout of an
exec tree (``core.validate``) and retires a corrupt one to masked-dense
(``core.packed.DegradedLayer``); ``ServingEngine`` runs it at
construction.  The report, its rows and the spec have the reference's
JSON forms (the artifact manifest stores them).
"""
from __future__ import annotations

import dataclasses
import logging
import math
import warnings

import torch

from repro_torch.core import bcs as BCS
from repro_torch.core import quant as QUANT
from repro_torch.core import reweighted as RW
from repro_torch.core import validate as V
from repro_torch.core.packed import DegradedLayer, PackedLayout
from repro_torch.distributed import sharding as SH
from repro_torch.kernels import ops
from repro_torch.models import module as M
from repro_torch.serve import trace as TR

# FC block schemes pack the weight as-is; block_punched (the paper's CONV
# scheme) packs the im2col-lowered weight into whole dead BCS blocks;
# pattern (incl. connectivity pruning) tap-lowers into a TapLayout
BLOCK_SCHEMES = ("block", "block_row", "block_col")
CONV_SCHEMES = ("block_punched",)
PATTERN_SCHEMES = ("pattern",)
PACKABLE_SCHEMES = BLOCK_SCHEMES + CONV_SCHEMES + PATTERN_SCHEMES

# value dtypes the packed executors serve (None = keep float values)
VALUE_DTYPES = (None, "int8")


@dataclasses.dataclass(frozen=True)
class CompileSpec:
    """The ``compile_model`` knobs.

    keep_dense : keep "w" next to "packed"; False drops it.
    reorder : degree-sort + bin block columns before padding (Fig 4).
    n_bins : number of degree bins when reordering.  None uses each
        producer's own default: 4 for block layouts, 8 for tap layouts.
    block_override : one (bk, bn) packing block for every layer
        (otherwise each layer uses its mapped ``choice.block``).
    min_saving : skip packing when the skipped-FLOP fraction is not above
        this.
    implicit : conv x-operand hint for serving dispatch (None = auto, see
        ``kernels.ops._pick_implicit``); recorded with the report, it does
        not change the layouts.
    value_dtype : serving precision of packed values — None keeps float,
        "int8" quantizes symmetrically with fp32 scale leaves
        (``core.quant``); a layer's ``SchemeChoice.value_dtype`` overrides
        it.
    scale_granularity : scale group of quantized BCS layouts — "block"
        (one fp32 per stored block) or "out" (one per block column).  Tap
        layouts always quantize per filter ("out"): a group = 1 slot holds
        one value, so a per-slot scale would cost 4 bytes per value.
    exclude : path substrings never packed (embeddings/head, §5.2.4).
    tp : tensor-parallel degree.  tp > 1 column-shards every packed
        layout (degree-balanced, ``core.bcs.shard_columns``).  Paths with
        a ``moe`` component are exempt (an expert stack shards along its
        expert axis), and a layer whose block columns (a pattern conv's
        filters) tp does not divide stays unsharded; the report's
        ``shards`` records each layer's.
    """
    keep_dense: bool = True
    reorder: bool = True
    n_bins: int | None = None
    block_override: tuple | None = None
    min_saving: float = 0.0
    implicit: bool | None = None
    value_dtype: str | None = None
    scale_granularity: str = "block"
    exclude: tuple = ("router", "embed", "head")
    tp: int = 1

    def __post_init__(self):
        if self.value_dtype not in VALUE_DTYPES:
            raise ValueError(f"value_dtype {self.value_dtype!r} not in "
                             f"{VALUE_DTYPES}")
        if self.scale_granularity not in QUANT.GRANULARITIES:
            raise ValueError(
                f"scale_granularity {self.scale_granularity!r} not in "
                f"{QUANT.GRANULARITIES}")
        if self.block_override is not None:
            bo = tuple(int(b) for b in self.block_override)
            if len(bo) != 2:
                raise ValueError(f"block_override must be (bk, bn), got "
                                 f"{self.block_override!r}")
            object.__setattr__(self, "block_override", bo)
        object.__setattr__(self, "exclude", tuple(self.exclude))
        if self.n_bins is not None:
            object.__setattr__(self, "n_bins", int(self.n_bins))
        if int(self.tp) < 1:
            raise ValueError(f"tp must be >= 1, got {self.tp}")
        object.__setattr__(self, "tp", int(self.tp))

    def digest_fields(self) -> tuple:
        """The layout-determining fields in the reference's order: what
        the artifact ``model_digest`` hashes.  ``keep_dense`` and
        ``implicit`` only change serving dispatch."""
        return (self.block_override, float(self.min_saving),
                bool(self.reorder), self.n_bins, tuple(self.exclude),
                self.value_dtype, str(self.scale_granularity),
                int(self.tp))

    def to_json(self) -> dict:
        """The reference's JSON form (its field order)."""
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: dict) -> "CompileSpec":
        """Rebuild from ``to_json`` output (either package's)."""
        d = dict(d)
        if d.get("block_override") is not None:
            d["block_override"] = tuple(d["block_override"])
        if d.get("exclude") is not None:
            d["exclude"] = tuple(d["exclude"])
        return cls(**d)


# LayerReport fields the JSON row keeps even when falsy
_ALWAYS_KEYS = ("path", "packed")


@dataclasses.dataclass(frozen=True)
class LayerReport:
    """One layer's line of the compile log: the layout geometry, the
    load-balance lever (pre-reorder padded degree ``L`` -> post-reorder
    ``L_reordered`` of ``Kb`` column blocks), the served ``value_dtype``
    (None = float) and the layout's tensor-parallel ``shards`` (None =
    unsharded) for packed rows, the ``reason`` for skipped ones; a row
    whose layout ``degrade_invalid_layers`` retired carries
    ``degraded=True`` and the failure as its ``reason``."""
    path: str
    packed: bool
    kind: str | None = None
    scheme: str | None = None
    reason: str | None = None
    block: tuple | None = None
    shape: tuple | None = None
    L: int | None = None
    Kb: int | None = None
    L_reordered: float | None = None
    reorder_gain: float | None = None
    density: float | None = None
    flops_saved: float | None = None
    layers: int | None = None
    value_dtype: str | None = None
    patch_b_per_pos: int | None = None
    shards: int | None = None
    degraded: bool | None = None

    def to_json(self) -> dict:
        """Plain-JSON row: only the present (non-None) fields."""
        return {k: v for k, v in dataclasses.asdict(self).items()
                if v is not None or k in _ALWAYS_KEYS}

    @classmethod
    def from_json(cls, d: dict) -> "LayerReport":
        """Rebuild from either package's ``to_json`` row (unknown fields
        dropped)."""
        names = {f.name for f in dataclasses.fields(cls)}
        d = {k: v for k, v in d.items() if k in names}
        for k in ("block", "shape"):
            if d.get(k) is not None:
                d[k] = tuple(d[k])
        return cls(**d)


@dataclasses.dataclass(frozen=True)
class CompileReport:
    """The per-layer rows ``compile_model`` returns, plus its spec."""
    rows: tuple = ()
    spec: CompileSpec | None = None

    def __iter__(self):
        return iter(self.rows)

    @property
    def packed(self) -> tuple:
        return tuple(r for r in self.rows if r.packed)

    def to_json(self) -> dict:
        """Manifest form: {"spec": ..., "layers": [row, ...]}."""
        return {"spec": self.spec.to_json() if self.spec else None,
                "layers": [r.to_json() for r in self.rows]}

    @classmethod
    def from_json(cls, d) -> "CompileReport":
        """Rebuild from ``to_json`` output (or a bare list of rows)."""
        if isinstance(d, dict):
            spec = (CompileSpec.from_json(d["spec"])
                    if d.get("spec") else None)
            rows = d.get("layers", ())
        else:
            spec, rows = None, d
        return cls(rows=tuple(LayerReport.from_json(r) for r in rows),
                   spec=spec)


def _pack_stacked(w, mask, block, *, reorder=True, n_bins=4,
                  value_dtype=None, scale_granularity="block", n_shards=0):
    """Pack (..., K, N) weights slice by slice, pad every slice's per-bin
    column degree to the stack max, and restack -> a ``PackedLayout``
    whose leaves carry the leading stack dims; ``value_dtype="int8"``
    quantizes the STACKED layout (``core.quant``), as the reference does.
    ``n_shards`` > 0 shards every slice's block columns (the shard axis
    the innermost stack dim of every per-bin leaf).  Returns (layout,
    stats)."""
    mask = mask.expand(w.shape) if mask.ndim else mask
    lead = tuple(w.shape[:-2])
    K, N = w.shape[-2:]
    bk, bn = block
    S = int(n_shards)
    shard = (S,) if S else ()
    wf = w.reshape(-1, K, N)
    mf = mask.reshape(-1, K, N)
    layouts = [ops.pack(wf[i], mf[i], block, reorder=reorder, n_bins=n_bins,
                        n_shards=S)
               for i in range(wf.shape[0])]
    values, k_idx = [], []
    F = torch.nn.functional
    for b in range(layouts[0].n_bins):          # identical across slices
        Lb = max(lay.bin_degrees[b] for lay in layouts)
        # the degree axis: values (..., nb, L, bk, bn), k_idx (..., nb, L)
        v = torch.stack([F.pad(lay.values[b], (0, 0, 0, 0, 0,
                                               Lb - lay.bin_degrees[b]))
                         for lay in layouts])
        k = torch.stack([F.pad(lay.k_idx[b], (0, Lb - lay.bin_degrees[b]))
                         for lay in layouts])
        values.append(v.reshape(lead + shard + (-1, Lb, bk, bn)))
        k_idx.append(k.reshape(lead + shard + (-1, Lb)))

    def restack(get):
        a = torch.stack([get(lay) for lay in layouts])
        return a.reshape(lead + tuple(a.shape[1:]))

    nnz = restack(lambda lay: lay.nnz)
    has_perm = reorder or S
    stacked = PackedLayout(
        values=tuple(values), k_idx=tuple(k_idx), nnz=nnz,
        perm=restack(lambda lay: lay.perm) if has_perm else None,
        inv_perm=restack(lambda lay: lay.inv_perm) if has_perm else None,
        block=tuple(block), shape=(K, N), n_shards=S)
    if value_dtype is not None:
        stacked = QUANT.quantize_layout(
            stacked, value_dtype=value_dtype,
            scale_granularity=scale_granularity)
    L_pre = max(1, int(nnz.max()))
    L_eff = stacked.L_effective
    stats = {
        "block": tuple(block), "shape": (K, N), "L": L_pre, "Kb": K // bk,
        "L_reordered": round(L_eff, 2),
        "reorder_gain": round(L_pre / max(L_eff, 1e-9), 2),
        "density": stacked.density,
        "flops_saved": stacked.flops_saved,
        "layers": math.prod(lead),
    }
    return stacked, stats


def _layer_kind(w, scheme: str) -> str:
    """The layout producer a weight goes to: "conv" (4-D weight, CONV block
    scheme -> im2col BCS), "pattern_conv" (4-D, pattern scheme -> taps),
    "depthwise" (Q == 1, never packed), "bad_conv" (a conv scheme on a
    weight that is not 4-D), else "linear"."""
    if scheme in CONV_SCHEMES + PATTERN_SCHEMES:
        if w.ndim != 4:
            return "bad_conv"
        if w.shape[1] == 1:
            return "depthwise"
        return "pattern_conv" if scheme in PATTERN_SCHEMES else "conv"
    return "linear"


def _tap_stats(tap, w):
    P, Q, Kh, Kw = w.shape
    return {
        "block": (1, tap.group), "shape": tap.shape, "L": tap.L_max,
        "Kb": tap.shape[0], "L_reordered": round(tap.L_effective, 2),
        "reorder_gain": round(tap.L_max / max(tap.L_effective, 1e-9), 2),
        "density": tap.density, "flops_saved": tap.flops_saved,
        "layers": 1,
        # patch bytes the materialized path allocates per output position,
        # which the implicit kernels never touch
        "patch_b_per_pos": Kh * Kw * Q * w.element_size(),
    }


# the historical compile_model keywords, a deprecated spelling of a
# CompileSpec (the same defaults)
_LEGACY_SPEC_KWARGS = ("block_override", "keep_dense", "min_saving",
                       "reorder", "n_bins", "exclude", "implicit",
                       "value_dtype", "scale_granularity")


def resolve_spec(spec=None, **legacy) -> CompileSpec:
    """The one ``CompileSpec`` of a ``spec``-or-keywords compile call:
    ``spec`` as it is, or one built from the historical keywords (with a
    DeprecationWarning; None-valued keywords count as not given).  A
    TypeError for an unknown keyword, for ``spec`` mixed with keywords,
    and for a ``spec`` that is not a ``CompileSpec``."""
    legacy = {k: v for k, v in legacy.items() if v is not None}
    bad = set(legacy) - set(_LEGACY_SPEC_KWARGS)
    if bad:
        raise TypeError(f"unknown compile_model argument(s): {sorted(bad)}")
    if spec is not None:
        if legacy:
            raise TypeError(
                f"pass spec= OR legacy keywords, not both (got spec and "
                f"{sorted(legacy)})")
        if not isinstance(spec, CompileSpec):
            raise TypeError(f"spec must be a CompileSpec, got "
                            f"{type(spec).__name__}")
        return spec
    if legacy:
        warnings.warn(
            "compile_model(keep_dense=..., reorder=..., ...) keywords are "
            "deprecated; pass spec=CompileSpec(...) instead",
            DeprecationWarning, stacklevel=3)
    return CompileSpec(**legacy)


def compile_model(params, masks=None, mapping=(), spec=None, device="cuda",
                  artifact_dir=None, **legacy):
    """Pack every block-pruned linear or conv layer of ``params`` for
    sparse execution on ``device``.  Returns (exec_params, CompileReport).

    params  : model param tree (nested dicts; linear nodes hold "w").
    masks   : mask tree matching ``params`` (scalar sentinels on unpruned
              leaves, as ``core.reweighted`` builds them).  None derives the
              masks from the zeros already baked into ``w``.
    mapping : [(path_regex, SchemeChoice)] — only paths mapped to a
              packable scheme are packed (FC block schemes, block_punched
              convs, pattern convs).
    spec    : ``CompileSpec``.  The historical keywords (``keep_dense=``,
              ``reorder=``, ``n_bins=``, ... : ``_LEGACY_SPEC_KWARGS``)
              still build an equal spec, with a DeprecationWarning
              (``resolve_spec``); mixing both is a TypeError.
    artifact_dir : the artifact store (``serve.artifacts``).  The model
              digest (weights, masks, mapping, the spec's digest fields)
              is looked up first: a match that passes its checksum and
              layout validation is grafted onto ``params`` with no
              packing.  Any failure logs its ``code`` and falls back to
              this fresh pack, which is then published for the next start.

    Recorded as the span ``compile_model`` (``serve.trace``), with the
    card's ``memory_allocated`` at its close.
    """
    spec = resolve_spec(spec, **legacy)
    dev = M.resolve_device(device)
    with TR.span("compile_model") as sp:
        out = _compile_model(params, masks, mapping, spec, dev, artifact_dir)
        TR.note_memory(sp, dev)
    return out


def _compile_model(params, masks, mapping, spec, dev, artifact_dir):
    artifact_key = None
    if artifact_dir is not None:
        from repro_torch.serve import artifacts as ART
        artifact_key = ART.model_digest(params, masks, mapping, spec=spec)
        warm = ART.load_grafted(artifact_dir, artifact_key, params,
                                keep_dense=spec.keep_dense, device=dev)
        if warm is not None:
            return warm
    # per-producer bin defaults: 4 for block layouts, 8 for tap layouts
    gemm_bins = 4 if spec.n_bins is None else spec.n_bins
    tap_bins = 8 if spec.n_bins is None else spec.n_bins
    rows = []

    def walk(p, m, path):
        if not isinstance(p, dict):
            return p.to(dev) if isinstance(p, torch.Tensor) else p
        out = {k: walk(v, m.get(k) if isinstance(m, dict) else None,
                       f"{path}/{k}" if path else k)
               for k, v in p.items()}
        w = out.get("w")
        if not isinstance(w, torch.Tensor) or w.ndim < 2:
            return out
        wpath = f"{path}/w" if path else "w"

        def skip(reason):
            rows.append(LayerReport(path=wpath, packed=False, reason=reason))
            return out

        if any(e in wpath for e in spec.exclude):
            return skip("excluded")
        choice = RW.match(list(mapping), wpath)
        if choice is None or choice.scheme not in PACKABLE_SCHEMES:
            return skip("no block scheme mapped")
        kind = _layer_kind(w, choice.scheme)
        if kind == "depthwise":
            return skip("depthwise conv never packed (§5.2.4)")
        if kind == "bad_conv":
            return skip(f"{choice.scheme} needs a (P, Q, Kh, Kw) conv "
                        f"weight, got shape {tuple(w.shape)}")
        mask = m.get("w") if isinstance(m, dict) else None
        if masks is None:
            mask = w != 0
        elif mask is None or mask.ndim == 0:
            return skip("no mask (layer not pruned)")
        mask = mask.to(dev)
        block = tuple(spec.block_override or choice.block)
        # per-layer precision: the mapper's pick wins over the spec
        vdt = choice.value_dtype or spec.value_dtype
        if vdt not in VALUE_DTYPES:
            return skip(f"unsupported value_dtype {vdt!r}")
        # tensor-parallel column shards: MoE expert stacks are exempt (they
        # shard along the expert axis), and a layer whose column count tp
        # does not divide stays unsharded (the row's ``shards`` says so)
        shards = 0 if "moe" in wpath.split("/") or spec.tp < 2 else spec.tp
        if kind == "pattern_conv":
            if shards and w.shape[0] % shards:
                shards = 0
            packed = ops.pack_taps(w, mask, reorder=spec.reorder,
                                   n_bins=tap_bins, value_dtype=vdt,
                                   scale_granularity="out", n_shards=shards)
            stats = _tap_stats(packed, w)
        elif kind == "conv":
            gemm_block, why = BCS.conv_gemm_block(block, tuple(w.shape))
            if gemm_block is None:
                return skip(why)
            P, Q, Kh, Kw = w.shape
            if shards and (P // gemm_block[1]) % shards:
                shards = 0
            packed, stats = _pack_stacked(
                BCS.conv_lower(w), BCS.conv_lower(mask.expand(w.shape)),
                gemm_block, reorder=spec.reorder, n_bins=gemm_bins,
                value_dtype=vdt, scale_granularity=spec.scale_granularity,
                n_shards=shards)
            # the static tap table the implicit kernel gathers through
            packed = dataclasses.replace(
                packed,
                conv_taps=BCS.conv_tap_table(Kh, Kw, Q, gemm_block[0]))
            stats["patch_b_per_pos"] = Kh * Kw * Q * w.element_size()
        else:
            K, N = w.shape[-2:]
            if K % block[0] or N % block[1]:
                return skip(f"block {block} does not divide ({K}, {N})")
            if shards and (N // block[1]) % shards:
                shards = 0
            packed, stats = _pack_stacked(
                w, mask, block, reorder=spec.reorder, n_bins=gemm_bins,
                value_dtype=vdt, scale_granularity=spec.scale_granularity,
                n_shards=shards)
        if stats["flops_saved"] <= spec.min_saving:
            return skip(f"no effective saving (L={stats['L']} of "
                        f"Kb={stats['Kb']} column blocks survive)")
        out["packed"] = packed
        if not spec.keep_dense:
            del out["w"]
        rows.append(LayerReport(path=wpath, packed=True, kind=kind,
                                scheme=choice.scheme, value_dtype=vdt,
                                shards=shards or None, **stats))
        return out

    exec_params = walk(params, masks, "")
    report = CompileReport(rows=tuple(rows), spec=spec)
    if artifact_key is not None:
        # publish for the next start; an unwritable store never fails the
        # compile itself
        try:
            ART.save_artifact(artifact_dir, artifact_key, exec_params,
                              report)
        except OSError as e:
            ART.log.warning("could not publish artifact to %s: %s",
                            artifact_dir, e)
    return exec_params, report


def compiled_summary(report) -> str:
    """One line per layer: the load-balance lever (pre-reorder L ->
    post-reorder effective L and the gain) or the skip reason; quantized
    rows add ``values=int8``, sharded rows ``tp=<shards>``, conv rows the
    patch bytes per output position the implicit mode avoids."""
    lines = []
    for r in report:
        if r.packed:
            line = (
                f"  pack {r.path:<28s} [{r.kind}] block={r.block} "
                f"density={r.density:.2f} "
                f"L={r.L}->{r.L_reordered}/{r.Kb} "
                f"(reorder_gain={r.reorder_gain:.2f}x) "
                f"flops_saved={r.flops_saved:.2f}")
            if r.value_dtype:
                line += f" values={r.value_dtype}"
            if r.shards:
                line += f" tp={r.shards}"
            if r.patch_b_per_pos is not None:
                line += f" implicit_avoids={r.patch_b_per_pos}B/pos"
            if r.degraded:
                line += " [DEGRADED -> masked-dense]"
            lines.append(line)
        else:
            lines.append(f"  skip {r.path:<28s} ({r.reason})")
    return "\n".join(lines)


def degrade_invalid_layers(exec_params, report=None):
    """Validate every packed layout of an exec-param tree and retire each
    failure to masked-dense: a ``DegradedLayer`` marker replaces the
    layout, and that layer (its whole stack) runs the dense matmul on its
    retained ``w``; every other layer keeps its kernel.  Each degradation
    logs a warning and, given a ``CompileReport``, its row comes back with
    ``degraded=True`` and the failure as its reason.

    A corrupt layout whose node has no ``w`` (packed with
    ``keep_dense=False``) cannot degrade: its ``LayoutError`` is
    re-raised, since a repack is the only safe answer.

    Returns ``(exec_params, report, degraded)``: the tree (its dict
    skeleton copied, leaves shared), the report, and ``[(layer path,
    LayoutError), ...]``."""
    log = logging.getLogger("repro_torch.serve.compile")
    degraded = []

    def walk(node, path):
        if not isinstance(node, dict):
            return node
        out = {}
        for k, v in node.items():
            sub = f"{path}/{k}" if path else k
            if k != "packed":
                out[k] = walk(v, sub)
                continue
            if v is None or isinstance(v, (dict, DegradedLayer)):
                out[k] = v
                continue
            try:
                # a layout placed on a mesh is checked gathered whole, and
                # kept placed
                checked = V.validate_layout(SH.gather_layout(v), path=sub)
                out[k] = v if SH.is_placed(v.nnz) else checked
            except V.LayoutError as e:
                if "w" not in node:
                    raise     # no dense fallback weight: repack or fail
                out[k] = DegradedLayer(path=path or "packed", code=e.code,
                                       detail=e.detail)
                degraded.append((path, e))
                log.warning(
                    "layer %s: packed layout failed validation, degrading "
                    "to masked-dense execution: %s", path, e)
        return out

    tree = walk(exec_params, "")
    if isinstance(report, CompileReport) and degraded:
        bad = {(f"{p}/w" if p else "w"): e for p, e in degraded}
        rows = tuple(
            dataclasses.replace(
                r, degraded=True,
                reason=f"[{bad[r.path].code}] degraded to masked-dense: "
                       f"{bad[r.path].detail}")
            if r.path in bad else r
            for r in report)
        report = dataclasses.replace(report, rows=rows)
    return tree, report, degraded
