"""Fault-tolerant checkpoints in the reference's format
(``repro.distributed.checkpoint``), so a checkpoint written by either
package restores in the other:

    <ckpt_dir>/step_%08d/shard_<rank>.npz   every leaf of the tree, keyed
                                            by its '/'-joined path (dict
                                            keys sorted); bf16 widened to
                                            fp32, recast on restore
    <ckpt_dir>/step_%08d/MANIFEST.json      step, n_hosts, the sorted
                                            keys, meta, and the sha256 and
                                            byte size of each shard file

A writer stages into ``.tmp_step_%08d_0``, writes the manifest LAST and
publishes the step with one atomic ``os.replace``, so a torn
write is never picked up: ``available_steps`` lists only steps whose
manifest exists.  ``restore`` checks the shard's size and sha256 against
the manifest before reading it, then the key set and each leaf's shape
and dtype kind against the restore target; every failure raises a
``CheckpointError`` naming its ``code`` and the offending file or param.

Trees are nested dicts of tensors (a param tree, ``{"params", "opt"}``
with the AdamW state); ``None`` leaves are skipped, as a jax flatten skips
them.  On a mesh every rank gathers the placed leaves whole (a
collective, so every rank calls ``save``) and writes them all to its own
``shard_<rank>.npz`` in the one staging directory; rank 0 writes the
manifest last (``n_hosts`` the world size, a checksum per shard) and
publishes.  So a checkpoint written at any tensor-parallel degree holds
whole arrays and restores at any other, and in the reference.
``restore`` reads shard 0, puts each leaf on ``device`` (default: where
the target's leaf lives) and, given ``shardings``, places it on the mesh
by its spec.
"""
from __future__ import annotations

import hashlib
import json
import os
import pathlib
import shutil

import numpy as np
import torch

from repro_torch.models import module as M

MANIFEST_FILE = "MANIFEST.json"
SHARD_FILE = "shard_0.npz"


class CheckpointError(RuntimeError):
    """A restore failure: the checkpoint ``path`` and the failure class
    ``code`` (``missing_key`` / ``unexpected_key`` / ``checksum`` /
    ``shape`` / ``dtype`` / ``missing_file``)."""

    def __init__(self, detail, *, code="invalid", path=None):
        self.code = code
        self.path = str(path) if path is not None else None
        where = f" [{self.path}]" if self.path else ""
        super().__init__(f"[{code}]{where} {detail}")


def file_checksum(path) -> str:
    """Streaming sha256 of one file, read 1 MiB at a time — shared by the
    checkpoint manifest and the artifact store (``serve.artifacts``)."""
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while block := f.read(1 << 20):
            h.update(block)
    return h.hexdigest()


def _leaves(tree, path=()):
    """(path string, leaf) of every non-None leaf, dict keys sorted."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (str(k),))
    else:
        yield M.path_str(path), tree


def _to_numpy(v):
    if isinstance(v, torch.Tensor):
        v = v.detach()
        if v.dtype == torch.bfloat16:   # numpy has no bf16: widen,
            v = v.float()               # losslessly; restore recasts
        return v.cpu().numpy()
    return np.asarray(v)


def _step_dir(ckpt_dir, step):
    return pathlib.Path(ckpt_dir) / f"step_{step:08d}"


def _ranks():
    """(rank, world size) of the default process group, (0, 1) without
    one."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _barrier(n_hosts):
    if n_hosts > 1:
        import torch.distributed as dist
        dist.barrier()


def save(ckpt_dir, step: int, tree, host_id: int | None = None,
         n_hosts: int | None = None):
    """Write ``tree`` as step ``step``: each host's shard file (every
    placed leaf gathered whole first), then host 0's manifest, then the
    atomic publish.  ``host_id`` / ``n_hosts`` default to the process
    group's rank and size.  A step already published is kept.  Returns
    the step's directory."""
    rank, world = _ranks()
    host_id = rank if host_id is None else host_id
    n_hosts = world if n_hosts is None else n_hosts
    ckpt_dir = pathlib.Path(ckpt_dir)
    final = _step_dir(ckpt_dir, step)
    tmp = ckpt_dir / f".tmp_step_{step:08d}_0"
    tmp.mkdir(parents=True, exist_ok=True)
    arrays = {p: _to_numpy(_whole(v)) for p, v in _leaves(tree)}
    np.savez(tmp / f"shard_{host_id}.npz", **arrays)
    _barrier(n_hosts)                  # every shard is in before publish
    if host_id == 0:
        shards = sorted(f.name for f in tmp.glob("shard_*.npz"))
        manifest = {"step": step, "n_hosts": n_hosts, "keys": sorted(arrays),
                    "meta": {},
                    "checksums": {name: {
                        "sha256": file_checksum(tmp / name),
                        "bytes": (tmp / name).stat().st_size}
                        for name in shards}}
        (tmp / MANIFEST_FILE).write_text(json.dumps(manifest))
        if final.exists():
            shutil.rmtree(tmp, ignore_errors=True)
        else:
            os.replace(tmp, final)
    _barrier(n_hosts)                  # published before anyone goes on
    return final


def _whole(v):
    """A placed (``DTensor``) leaf gathered whole; anything else as is."""
    return v.full_tensor() if hasattr(v, "full_tensor") else v


def available_steps(ckpt_dir) -> list:
    """Every COMPLETE step (manifest published), newest first — the order
    ``distributed.elastic.replica_restore`` falls back through when a
    step fails its checks.  Torn steps (no manifest) are invisible."""
    ckpt_dir = pathlib.Path(ckpt_dir)
    if not ckpt_dir.exists():
        return []
    steps = [int(d.name.split("_")[1]) for d in ckpt_dir.iterdir()
             if d.name.startswith("step_") and (d / MANIFEST_FILE).exists()]
    return sorted(steps, reverse=True)


def latest_step(ckpt_dir) -> int | None:
    """The newest complete step, or None."""
    steps = available_steps(ckpt_dir)
    return steps[0] if steps else None


def _verify_shard(d, shard_name):
    """The shard file against its step's manifest (size, then sha256);
    returns the manifest.  A manifest without checksums (an older writer)
    skips them."""
    shard_path = d / shard_name
    if not shard_path.exists():
        raise CheckpointError(f"shard file {shard_name} is missing",
                              code="missing_file", path=d)
    manifest_path = d / MANIFEST_FILE
    if not manifest_path.exists():
        raise CheckpointError("manifest is missing (torn checkpoint?)",
                              code="missing_file", path=d)
    manifest = json.loads(manifest_path.read_text())
    rec = manifest.get("checksums", {}).get(shard_name)
    if rec is not None:
        size = shard_path.stat().st_size
        if size != rec["bytes"]:
            raise CheckpointError(
                f"shard {shard_name} is {size} bytes, manifest says "
                f"{rec['bytes']} (truncated write?)", code="checksum",
                path=shard_path)
        digest = file_checksum(shard_path)
        if digest != rec["sha256"]:
            raise CheckpointError(
                f"shard {shard_name} sha256 {digest[:12]}... != manifest "
                f"{rec['sha256'][:12]}... (bit corruption?)",
                code="checksum", path=shard_path)
    return manifest


def _kind(dtype) -> str:
    """A dtype's kind, numpy's letters, every float kind "f"."""
    if isinstance(dtype, torch.dtype):
        if dtype.is_floating_point:
            return "f"
        return "b" if dtype == torch.bool else (
            "u" if dtype == torch.uint8 else "i")
    return "f" if np.issubdtype(dtype, np.floating) else np.dtype(dtype).kind


def _check_leaf(path, like, arr, d):
    """One stored array against its restore target: the same shape and
    dtype kind, or a ``CheckpointError`` naming the param."""
    like_shape = getattr(like, "shape", None)
    if like_shape is not None and tuple(arr.shape) != tuple(like_shape):
        raise CheckpointError(
            f"param {path!r}: checkpoint shape {tuple(arr.shape)} != "
            f"restore target shape {tuple(like_shape)}", code="shape",
            path=d)
    like_dtype = getattr(like, "dtype", None)
    if like_dtype is not None and _kind(arr.dtype) != _kind(like_dtype):
        raise CheckpointError(
            f"param {path!r}: checkpoint dtype {arr.dtype} is not "
            f"restorable into target dtype {like_dtype} (different dtype "
            f"kind — wrong tree?)", code="dtype", path=d)


def _rebuild(tree, get, path=()):
    """``tree``'s structure with each non-None leaf replaced by
    ``get(path string, leaf)``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _rebuild(v, get, path + (str(k),))
                for k, v in tree.items()}
    return get(M.path_str(path), tree)


def restore(ckpt_dir, tree_like, step: int | None = None, device=None,
            shardings=None):
    """Restore step ``step`` (default the newest complete one) into the
    structure of ``tree_like``: each leaf cast to its target's dtype and
    put on ``device`` (default the target leaf's device), then, given
    ``shardings`` (a tree of ``sharding.NamedSharding`` of the same
    structure, the elastic-restart path), placed on its mesh by its spec.
    Returns (tree, step), or (None, None) when there is no complete step.

    Raises ``CheckpointError`` when the shard fails its manifest checks,
    when a param of ``tree_like`` is missing from the checkpoint or the
    checkpoint holds one ``tree_like`` lacks, or when a param's shape or
    dtype kind disagrees."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            return None, None
    d = _step_dir(ckpt_dir, step)
    _verify_shard(d, SHARD_FILE)
    dev = None if device is None else M.resolve_device(device)
    with np.load(d / SHARD_FILE) as data:
        files = set(data.files)
        want = [p for p, _ in _leaves(tree_like)]
        missing = sorted(set(want) - files)
        if missing:
            more = f" (+{len(missing) - 1} more)" if len(missing) > 1 else ""
            raise CheckpointError(
                f"param {missing[0]!r}{more} expected by the restore target "
                "is missing from the checkpoint — wrong tree?",
                code="missing_key", path=d)
        extra = sorted(files - set(want))
        if extra:
            more = f" (+{len(extra) - 1} more)" if len(extra) > 1 else ""
            raise CheckpointError(
                f"checkpoint carries param {extra[0]!r}{more} the restore "
                "target does not expect — wrong tree?",
                code="unexpected_key", path=d)

        def get(path, like):
            arr = data[path]
            _check_leaf(path, like, arr, d)
            t = torch.from_numpy(np.ascontiguousarray(arr))
            if isinstance(like, torch.Tensor):
                return t.to(device=dev or like.device, dtype=like.dtype)
            return t if dev is None else t.to(dev)
        out = _rebuild(tree_like, get)
    if shardings is not None:
        from repro_torch.distributed.sharding import distribute
        out = distribute(out, shardings)
    return out, step
