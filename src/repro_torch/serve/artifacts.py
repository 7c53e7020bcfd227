"""Crash-safe store of compiled (packed) models, the reference's format v2.

The store persists the §4.3 compile result (every ``PackedLayout`` /
``TapLayout`` plus the compile report), so a replica can load weights
already packed:

    serve.compile.compile_model(..., artifact_dir=...)   # the front door
    launch.serve --artifacts DIR                         # the CLI

On-disk format: content-addressed, one directory per model digest::

    <artifact_dir>/<digest>/arrays.npz      every layout leaf, path-keyed
                                            (bf16 widened to fp32)
    <artifact_dir>/<digest>/MANIFEST.json   format version, pack key,
                                            sha256 + byte size of the
                                            arrays, per-layer layout specs,
                                            the compile report

The format, the digest and the report are the reference's
(``repro.serve.artifacts``), so a store written by either package loads
in the other.  ``model_digest`` hashes the weights, the masks, the
mapping and the spec's digest fields, leaves in the reference's order
(dict keys sorted, ``None`` dropped, ``/``-joined paths; a bf16 tensor as
its raw 16-bit words under the dtype name ``"bfloat16"``).

Writers stage into a ``.tmp_*`` sibling and publish with one atomic
``os.replace`` after the manifest (checksums included) is written, so a
crashed writer leaves an ignored husk, never a half-written artifact.
Load checks, in order: digest directory, manifest, format version, pack
key, byte size and sha256 of the arrays, each leaf against the manifest,
then ``core.validate`` on every layout (on the requested device).  Every
failure raises a structured ``ArtifactError`` or ``LayoutError``;
``load_grafted`` logs its code and returns None, so the caller packs
afresh.  Tensor-parallel layouts (``n_shards`` > 0, ``CompileSpec.tp``)
are stored with their shard axes, as the reference stores them.
"""
from __future__ import annotations

import hashlib
import json
import logging
import os
import pathlib
import shutil

import numpy as np
import torch

from repro_torch.core.packed import PackedLayout, TapLayout, dtype_name
from repro_torch.core.validate import LayoutError, validate_layout
from repro_torch.distributed.checkpoint import file_checksum
from repro_torch.models.module import resolve_device
from repro_torch.serve.compile import CompileReport, CompileSpec

log = logging.getLogger("repro_torch.serve.artifacts")

FORMAT_VERSION = 2
MANIFEST_FILE = "MANIFEST.json"
ARRAYS_FILE = "arrays.npz"


class ArtifactError(RuntimeError):
    """Base of the artifact-failure taxonomy; ``code`` is the stable tag
    the fallback log carries."""

    code = "artifact"

    def __init__(self, detail, *, path=None):
        self.detail = detail
        self.path = str(path) if path is not None else None
        where = f" [{self.path}]" if self.path else ""
        super().__init__(f"[{self.code}]{where} {detail}")


class ArtifactMissing(ArtifactError):
    """No artifact published for this digest."""

    code = "missing"


class ArtifactDigestMismatch(ArtifactError):
    """The manifest's pack key disagrees with the requested digest."""

    code = "digest_mismatch"


class ArtifactVersionSkew(ArtifactError):
    """Written under a different format version."""

    code = "version_skew"


class ArtifactChecksumError(ArtifactError):
    """A payload file fails its manifest checksum or byte size."""

    code = "checksum"


class ArtifactCorrupt(ArtifactError):
    """Structurally unreadable: manifest or leaves missing, bad JSON, leaf
    shapes or dtypes disagreeing with the manifest."""

    code = "corrupt"


# -- the model digest -----------------------------------------------------------

def _flatten(tree, path=()):
    """(path, leaf) in the reference's flatten order: dict keys sorted,
    ``None`` dropped."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], path + (str(k),))
    else:
        yield "/".join(path), tree


def _hash_tree(h, tree, tag):
    h.update(f"<{tag}>".encode())
    if tree is None:
        h.update(b"none")
        return
    for p, leaf in _flatten(tree):
        t = leaf.detach().cpu().contiguous()
        name = dtype_name(t)
        if t.dtype == torch.bfloat16:          # numpy has no bf16: its bits
            t = t.view(torch.int16)
        a = t.numpy()
        h.update(p.encode())
        h.update(str((tuple(a.shape), name)).encode())
        h.update(a.reshape(-1).view(np.uint8))


def model_digest(params, masks, mapping, *, spec=None) -> str:
    """Content digest of what determines the compile result: the weights,
    the masks, the scheme mapping and the ``CompileSpec`` digest fields
    (``keep_dense`` / ``implicit`` only change serving, so they stay out).
    Equal to the reference's ``model_digest`` on the same inputs."""
    spec = spec if spec is not None else CompileSpec()
    h = hashlib.blake2b(digest_size=16)
    h.update(repr(("repro-artifact", FORMAT_VERSION,
                   [(pat, repr(choice)) for pat, choice in mapping],
                   spec.digest_fields())).encode())
    _hash_tree(h, params, "params")
    _hash_tree(h, masks, "masks")
    return h.hexdigest()


# -- layout (de)serialization -----------------------------------------------------

def _to_numpy(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:          # numpy has no bf16: widen,
        t = t.float()                      # losslessly; load casts back
    return t.detach().cpu().numpy()


def _layout_leaves(layout):
    """(name, leaf or None) pairs in the reference's fixed order."""
    if isinstance(layout, PackedLayout):
        for b in range(layout.n_bins):
            yield f"values.{b}", layout.values[b]
            yield f"k_idx.{b}", layout.k_idx[b]
            if layout.scales is not None:
                yield f"scales.{b}", layout.scales[b]
        yield "nnz", layout.nnz
        yield "perm", layout.perm
        yield "inv_perm", layout.inv_perm
    else:
        for b in range(layout.n_bins):
            yield f"values.{b}", layout.values[b]
            yield f"t_idx.{b}", layout.t_idx[b]
            if layout.k_full is not None:
                yield f"k_full.{b}", layout.k_full[b]
            if layout.scales is not None:
                yield f"scales.{b}", layout.scales[b]
        yield "nnz", layout.nnz
        yield "alive", layout.alive
        yield "perm", layout.perm
        yield "inv_perm", layout.inv_perm


def _layout_spec(layout):
    """The manifest's static description of one layout: its aux and each
    leaf's true dtype and shape (so bf16 survives the fp32 widening)."""
    leaves = {name: {"dtype": dtype_name(leaf), "shape": list(leaf.shape)}
              for name, leaf in _layout_leaves(layout) if leaf is not None}
    if isinstance(layout, PackedLayout):
        return {"layout": "packed", "n_bins": layout.n_bins,
                "block": list(layout.block), "shape": list(layout.shape),
                "conv_taps": ([list(t) for t in layout.conv_taps]
                              if layout.conv_taps is not None else None),
                "n_shards": layout.n_shards, "leaves": leaves}
    return {"layout": "tap", "n_bins": layout.n_bins,
            "group": layout.group, "shape": list(layout.shape),
            "n_shards": layout.n_shards, "leaves": leaves}


def _layout_from_spec(lpath, spec, data, dev):
    """Rebuild one layout on ``dev`` from its manifest spec and the arrays
    bundle; ``ArtifactCorrupt`` on a missing or divergent leaf."""
    leaves = spec["leaves"]
    n_shards = int(spec.get("n_shards", 0))

    def _get(name, required=True):
        rec = leaves.get(name)
        if rec is None:
            if required:
                raise ArtifactCorrupt(
                    f"layer {lpath!r}: required leaf {name!r} absent from "
                    "the manifest spec")
            return None
        key = f"{lpath}::{name}"
        if key not in data:
            raise ArtifactCorrupt(
                f"layer {lpath!r}: leaf {name!r} missing from "
                f"{ARRAYS_FILE}")
        a = data[key]
        if list(a.shape) != list(rec["shape"]):
            raise ArtifactCorrupt(
                f"layer {lpath!r}: leaf {name!r} shape {tuple(a.shape)} "
                f"!= manifest {tuple(rec['shape'])}")
        dtype = getattr(torch, str(rec["dtype"]), None)
        if not isinstance(dtype, torch.dtype):
            raise ArtifactCorrupt(
                f"layer {lpath!r}: leaf {name!r} has unknown dtype "
                f"{rec['dtype']!r}")
        return torch.from_numpy(np.ascontiguousarray(a)).to(dtype).to(dev)

    n_bins = int(spec["n_bins"])
    scales = (tuple(_get(f"scales.{b}") for b in range(n_bins))
              if "scales.0" in leaves else None)
    if spec["layout"] == "packed":
        return PackedLayout(
            values=tuple(_get(f"values.{b}") for b in range(n_bins)),
            k_idx=tuple(_get(f"k_idx.{b}") for b in range(n_bins)),
            nnz=_get("nnz"),
            perm=_get("perm", required=False),
            inv_perm=_get("inv_perm", required=False),
            block=tuple(spec["block"]), shape=tuple(spec["shape"]),
            conv_taps=(tuple(tuple(t) for t in spec["conv_taps"])
                       if spec.get("conv_taps") is not None else None),
            scales=scales, n_shards=n_shards)
    if spec["layout"] == "tap":
        return TapLayout(
            values=tuple(_get(f"values.{b}") for b in range(n_bins)),
            t_idx=tuple(_get(f"t_idx.{b}") for b in range(n_bins)),
            k_full=(tuple(_get(f"k_full.{b}") for b in range(n_bins))
                    if "k_full.0" in leaves else None),
            nnz=_get("nnz"), alive=_get("alive"),
            perm=_get("perm", required=False),
            inv_perm=_get("inv_perm", required=False),
            group=int(spec["group"]), shape=tuple(spec["shape"]),
            scales=scales, n_shards=n_shards)
    raise ArtifactCorrupt(
        f"layer {lpath!r}: unknown layout kind {spec['layout']!r}")


# -- save / load ------------------------------------------------------------------

def _resolve(tree, lpath):
    node = tree
    for part in lpath.split("/") if lpath else ():
        node = node[part]
    return node


def _packed_layers(exec_params, report):
    """{layer node path: layout} for every packed row of the report."""
    out = {}
    for row in report:
        if not row.packed:
            continue
        lpath = row.path[:-2] if row.path.endswith("/w") else ""
        out[lpath] = _resolve(exec_params, lpath)["packed"]
    return out


def save_artifact(artifact_dir, key, exec_params, report):
    """Publish the compile result under ``<artifact_dir>/<key>``.

    Stages into a ``.tmp_*`` sibling, writes the arrays, then the manifest,
    then publishes with one atomic ``os.replace``.  An artifact already
    published at this key in the current format (or one a concurrent
    writer renamed first) is kept; one of another format version is
    replaced.  Every layout is validated first, so a
    corrupt one never reaches the disk.  Returns the final path."""
    artifact_dir = pathlib.Path(artifact_dir)
    final = artifact_dir / key
    if final.exists():
        try:
            man = json.loads((final / MANIFEST_FILE).read_text())
            if man.get("format_version") == FORMAT_VERSION:
                return final
        except (OSError, ValueError):
            pass                       # unreadable manifest: replace it
        shutil.rmtree(final, ignore_errors=True)
    layers = _packed_layers(exec_params, report)
    for lpath, layout in layers.items():
        validate_layout(layout, path=lpath)
    arrays, specs = {}, {}
    for lpath, layout in layers.items():
        specs[lpath] = _layout_spec(layout)
        for name, leaf in _layout_leaves(layout):
            if leaf is not None:
                arrays[f"{lpath}::{name}"] = _to_numpy(leaf)
    tmp = artifact_dir / f".tmp_{key}_{os.getpid()}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    arrays_path = tmp / ARRAYS_FILE
    np.savez(arrays_path, **arrays)
    manifest = {
        "format_version": FORMAT_VERSION,
        "pack_key": key,
        "files": {ARRAYS_FILE: {"sha256": file_checksum(arrays_path),
                                "bytes": arrays_path.stat().st_size}},
        "layers": specs,
        "report": report.to_json(),
        "meta": {},
    }
    (tmp / MANIFEST_FILE).write_text(json.dumps(manifest, indent=1))
    try:
        os.replace(tmp, final)
    except OSError:                    # lost a concurrent writer's race
        shutil.rmtree(tmp, ignore_errors=True)
    log.info("published artifact %s (%d layer(s), %.2f MiB)", final,
             len(layers), sum(a.nbytes for a in arrays.values()) / 2**20)
    return final


def load_artifact(artifact_dir, key, device="cuda"):
    """Load and verify the artifact for ``key`` onto ``device``.

    Order: digest directory -> manifest readable -> format version -> pack
    key -> byte size and sha256 of each file -> each leaf against the
    manifest (cast to its dtype, then moved to ``device``) -> every layout
    through ``core.validate``.  Raises the matching ``ArtifactError`` (or
    ``LayoutError``) at the first failure; returns ``(layers, report)``,
    ``layers`` mapping layer node paths to validated layouts."""
    dev = resolve_device(device)
    artifact_dir = pathlib.Path(artifact_dir)
    d = artifact_dir / key
    if not d.is_dir():
        stale = [p.name for p in artifact_dir.glob("*")
                 if p.is_dir() and not p.name.startswith(".tmp")] \
            if artifact_dir.is_dir() else []
        hint = (f" ({len(stale)} artifact(s) with other digests present "
                "— stale after a weight/mapping change?)") if stale else ""
        raise ArtifactMissing(f"no artifact for digest {key}{hint}", path=d)
    man_path = d / MANIFEST_FILE
    if not man_path.exists():
        raise ArtifactCorrupt("manifest missing (torn write?)", path=d)
    try:
        manifest = json.loads(man_path.read_text())
    except (OSError, json.JSONDecodeError) as e:
        raise ArtifactCorrupt(f"unreadable manifest: {e}",
                              path=man_path) from e
    ver = manifest.get("format_version")
    if ver != FORMAT_VERSION:
        raise ArtifactVersionSkew(
            f"artifact format_version {ver!r} != supported "
            f"{FORMAT_VERSION}", path=man_path)
    if manifest.get("pack_key") != key:
        raise ArtifactDigestMismatch(
            f"manifest pack_key {manifest.get('pack_key')!r} != requested "
            f"digest {key!r}", path=man_path)
    for fname, rec in manifest.get("files", {}).items():
        fp = d / fname
        if not fp.exists():
            raise ArtifactChecksumError(f"payload file {fname} missing",
                                        path=fp)
        size = fp.stat().st_size
        if size != rec.get("bytes"):
            raise ArtifactChecksumError(
                f"{fname} is {size} bytes, manifest says "
                f"{rec.get('bytes')} (truncated write?)", path=fp)
        digest = file_checksum(fp)
        if digest != rec.get("sha256"):
            raise ArtifactChecksumError(
                f"{fname} sha256 {digest[:12]}... != manifest "
                f"{str(rec.get('sha256'))[:12]}... (bit corruption?)",
                path=fp)
    try:
        data = np.load(d / ARRAYS_FILE)
    except Exception as e:  # zipfile/pickle errors vary by corruption
        raise ArtifactCorrupt(f"unreadable arrays bundle: {e}",
                              path=d / ARRAYS_FILE) from e
    try:
        layer_specs = manifest["layers"]
        report = manifest["report"]
    except KeyError as e:
        raise ArtifactCorrupt(f"manifest missing section {e}",
                              path=man_path) from e
    layers = {}
    with data:
        for lpath, spec in layer_specs.items():
            layout = _layout_from_spec(lpath, spec, data, dev)
            validate_layout(layout, path=lpath)     # LayoutError propagates
            layers[lpath] = layout
    return layers, CompileReport.from_json(report)


def _copy_to(tree, dev):
    """The dict skeleton copied and every tensor on ``dev`` (a tensor
    already there is shared): grafting never mutates the caller's tree."""
    if isinstance(tree, dict):
        return {k: _copy_to(v, dev) for k, v in tree.items()}
    return tree.to(dev) if isinstance(tree, torch.Tensor) else tree


def load_grafted(artifact_dir, key, params, *, keep_dense=True,
                 device="cuda"):
    """The warm start behind ``compile_model(artifact_dir=)``: returns
    ``(exec_params, report)`` with the stored layouts grafted onto
    ``params`` on ``device`` (``w`` dropped where packed when
    ``keep_dense`` is False, as a fresh compile does), or None after
    logging the failure's code: the caller then packs afresh."""
    dev = resolve_device(device)
    try:
        layers, report = load_artifact(artifact_dir, key, device=dev)
        exec_params = _copy_to(params, dev)
        for lpath, layout in layers.items():
            node = _resolve(exec_params, lpath)
            node["packed"] = layout
            if not keep_dense:
                node.pop("w", None)
    except (ArtifactError, LayoutError, KeyError, TypeError) as e:
        code = getattr(e, "code", type(e).__name__)
        level = log.info if isinstance(e, ArtifactMissing) else log.warning
        level("artifact fallback -> fresh pack [%s]: %s", code, e)
        return None
    log.info("warm start: %d packed layer(s) from %s", len(layers),
             pathlib.Path(artifact_dir) / key)
    return exec_params, report
