"""Seeded fault injectors for the serving stack (the reference's chaos
harness, ``repro.testing.faults``).

Every injector is a pure function of its arguments; the random ones draw
from ``numpy.random.RandomState`` (never the clock or a global RNG), so a
fault scenario replays exactly, and ``bitflip_packed_leaf``'s ``seed``
picks the same layer, bin and element as in the reference:

  ``bitflip_packed_leaf``  corrupt one packed layout in memory (a float
                           value's exponent bits saturated to non-finite,
                           or an int8 layout's index leaf set out of
                           range) -> caught by ``core.validate``, the
                           layer degrades to masked-dense
  ``nan_slot``             poison one engine slot's cache row with NaN ->
                           the step's finite probe quarantines the slot
  ``expire_deadline``      zero a request's deadline / TTL budgets ->
                           evicted by the scheduler's sweep
  ``crash_publish``        an artifact writer dying mid-publish (a stale
                           staging husk, or a final directory without its
                           manifest) -> ignored, or a fresh pack

Each returns a ``FaultRecord`` of what it did.
"""
from __future__ import annotations

import dataclasses
import pathlib

import numpy as np
import torch

from repro_torch.core.packed import PackedLayout, TapLayout
from repro_torch.serve import kvcache as KV

# one name per injector, the reference's fault-matrix axis
FAULT_KINDS = ("corrupt_leaf", "nan_slot", "expired_deadline",
               "crashed_publish")

# exponent-saturation masks by float itemsize, as signed words of that
# width: OR-ing one in makes any float Inf or NaN, which the finite check
# is sure to see (a mantissa flip could stay finite and undetectable)
_EXP_MASK = {8: (torch.int64, 0x7FF0000000000000),
             4: (torch.int32, 0x7F800000),
             2: (torch.int16, 0x7F80)}


@dataclasses.dataclass(frozen=True)
class FaultRecord:
    """What an injector did: the fault ``kind`` (one of ``FAULT_KINDS``),
    the ``target`` it hit (layer path, slot, request id or artifact key)
    and a ``detail``."""

    kind: str
    target: str
    detail: str


def _packed_layers(tree):
    """``(path, node)`` of every node holding a real packed layout, dict
    keys visited in sorted order.  The reference walks its trees in their
    own order, which is sorted wherever its ``apply_masks`` (a jax tree
    map) has run; the port's trees keep insertion order, so the walk is
    pinned to sorted keys and a seed picks the same layer in both."""
    found = []

    def walk(node, path):
        if not isinstance(node, dict):
            return
        if isinstance(node.get("packed"), (PackedLayout, TapLayout)):
            found.append((path, node))
        for k in sorted(node):
            if k != "packed":
                walk(node[k], f"{path}/{k}" if path else k)

    walk(tree, "")
    return found


def _skeleton_swap(tree, target_node, new_node):
    """``tree``'s dict skeleton copied (leaves shared) with one node
    replaced: the injected tree never aliases the input's dicts, so the
    healthy tree stays healthy."""
    def walk(node):
        if node is target_node:
            return new_node
        if not isinstance(node, dict):
            return node
        return {k: walk(v) for k, v in node.items()}

    return walk(tree)


def bitflip_packed_leaf(exec_params, *, seed=0):
    """Corrupt one packed layout of ``exec_params``, seeded: a float
    ``values`` element gets its exponent bits saturated (``non_finite``);
    on int8 values an index-leaf entry is set out of range instead
    (``index_range``).  Only the one bin is copied.  Returns
    ``(injected tree, FaultRecord)``; the input tree is untouched."""
    layers = _packed_layers(exec_params)
    if not layers:
        raise ValueError("no packed layouts to corrupt")
    rng = np.random.RandomState(seed)
    path, node = layers[int(rng.randint(len(layers)))]
    layout = node["packed"]
    bins = [b for b, v in enumerate(layout.values) if v.numel()]
    b = bins[int(rng.randint(len(bins)))]
    v = layout.values[b]
    if not v.dtype.is_floating_point:
        # int8 values: corrupt the index leaf instead (index_range)
        idx_name = "k_idx" if isinstance(layout, PackedLayout) else "t_idx"
        idx = getattr(layout, idx_name)[b].clone()
        i = int(rng.randint(idx.numel()))
        idx.view(-1)[i] = np.iinfo(np.int32).max // 2
        leaves = list(getattr(layout, idx_name))
        leaves[b] = idx
        new_layout = dataclasses.replace(layout, **{idx_name: tuple(leaves)})
        detail = f"{idx_name}[bin {b}] flat[{i}] -> out of range"
    else:
        v = v.clone()
        words = v.view(-1)
        i = int(rng.randint(words.numel()))
        wtype, mask = _EXP_MASK[v.element_size()]
        words = words.view(wtype)
        words[i] = words[i] | mask
        leaves = list(layout.values)
        leaves[b] = v
        new_layout = dataclasses.replace(layout, values=tuple(leaves))
        detail = f"values[bin {b}] flat[{i}] -> exponent saturated"
    new_node = dict(node, packed=new_layout)
    return (_skeleton_swap(exec_params, node, new_node),
            FaultRecord("corrupt_leaf", path, detail))


def nan_slot(engine, slot):
    """Poison slot ``slot`` of a running ``ServingEngine``'s cache with NaN
    in place (``kvcache.poison_slot``): the next step gives non-finite
    logits for that slot only and quarantines it."""
    engine.cache = KV.poison_slot(engine.cache, slot)
    return FaultRecord("nan_slot", f"slot {slot}",
                       "cache row overwritten with nan")


def expire_deadline(engine, rid):
    """Zero request ``rid``'s deadline budgets: a running request is
    evicted (``deadline_expired``) at the next sweep, a queued one expires
    from the queue, each with a typed audit event."""
    req = engine.requests[rid]
    req.deadline_steps = 0
    req.queue_ttl = -1
    return FaultRecord("expired_deadline", f"rid {rid}",
                       f"deadline budgets zeroed while {req.status}")


def crash_publish(artifact_dir, key, *, stage="staging"):
    """An artifact writer crashing mid-publish under ``key``:
    ``stage="staging"`` leaves a stale ``.tmp_*`` husk with a half-written
    array file (the store must ignore it); ``stage="torn"`` a final
    directory without its manifest (``load_grafted`` must return None so
    the caller repacks).  The garbage bytes come from seed 0."""
    d = pathlib.Path(artifact_dir)
    junk = np.random.RandomState(0).bytes(64)
    if stage == "staging":
        husk = d / f".tmp_{key}_31337"
        husk.mkdir(parents=True, exist_ok=True)
        (husk / "arrays.npz").write_bytes(junk)
        detail = f"stale staging husk {husk.name}"
    elif stage == "torn":
        torn = d / key
        torn.mkdir(parents=True, exist_ok=True)
        (torn / "arrays.npz").write_bytes(junk)
        manifest = torn / "MANIFEST.json"
        if manifest.exists():
            manifest.unlink()
        detail = "final dir without MANIFEST.json"
    else:
        raise ValueError(f"unknown stage {stage!r}")
    return FaultRecord("crashed_publish", str(key), detail)
