"""Mesh factories (the reference's ``repro.launch.mesh``): each returns a
``torch.distributed`` ``DeviceMesh`` with the reference's axis names,
("data", "model") or ("pod", "data", "model").  Functions, never
module-level constants, so importing this module touches no process
group or device.

A mesh spans the ranks of the default process group, which the caller
starts (``torch.distributed.init_process_group``), but for the local
mesh at one rank: ``make_local_mesh`` starts a one-rank group itself
(NCCL on the card, gloo on the CPU, over a file store in a temporary
directory) and ``close_local_mesh`` ends it.  A mesh lives on the card
unless the caller asks for the CPU (``device="cpu"``), as the tests do.
"""
from __future__ import annotations

import math
import os
import shutil
import tempfile

import torch
import torch.distributed as dist

# the one-rank group make_local_mesh started: its store's directory
_LOCAL_GROUP: dict = {}


def _device_type(device) -> str:
    """"cpu" when the caller asks for it, else "cuda" (which must exist:
    a mesh never falls back to the CPU)."""
    kind = "cuda" if device is None else torch.device(device).type
    if kind == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a mesh on the card was requested but CUDA is "
                           "not available; pass device='cpu'")
    return kind


def make_mesh(shape, axes, device=None):
    """A ``DeviceMesh`` of ``shape`` with dim names ``axes`` over the
    default group's ranks, which must number prod(shape)."""
    from torch.distributed.device_mesh import init_device_mesh
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         f"rank")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a started process group "
                           "(torch.distributed.init_process_group)")
    if math.prod(shape) != dist.get_world_size():
        raise ValueError(f"a {shape} mesh needs {math.prod(shape)} ranks, "
                         f"the group has {dist.get_world_size()}")
    return init_device_mesh(_device_type(device), shape,
                            mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """The reference's production mesh: (16, 16) ("data", "model"), or
    multi-pod (2, 16, 16) ("pod", "data", "model"); needs a group of 256
    or 512 ranks (a "fake" group stands in for them off the cluster)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)


def _start_local_group(kind: str):
    """A one-rank default group: NCCL on the card, gloo on the CPU, over
    a file store in a fresh temporary directory."""
    root = tempfile.mkdtemp(prefix="repro_mesh_")
    if kind == "cuda":
        torch.cuda.set_device(torch.cuda.current_device())
    dist.init_process_group("nccl" if kind == "cuda" else "gloo",
                            init_method=f"file://{os.path.join(root, 'store')}",
                            rank=0, world_size=1)
    _LOCAL_GROUP["root"] = root


def make_local_mesh(tp: int = 1, device=None):
    """A ("data", "model") mesh over the group's ranks with ``tp`` on
    "model": (world // tp, tp).  With no group started and ``tp`` 1, it
    starts a one-rank group itself, the reference's (1, 1) mesh that runs
    the exact sharded code path on one device.  A ``tp`` above the
    group's size raises, as the reference's "needs more devices": it
    never falls back to a smaller mesh or to the CPU."""
    if tp < 1:
        raise ValueError(f"tp must be >= 1, got {tp}")
    kind = _device_type(device)
    if not dist.is_initialized():
        if tp > 1:
            raise ValueError(f"tp={tp} needs {tp} ranks; start a process "
                             f"group of them first (one process per "
                             f"device)")
        _start_local_group(kind)
    world = dist.get_world_size()
    if tp > world:
        raise ValueError(f"tp={tp} needs more devices than the {world} "
                         f"rank(s) of the process group")
    if world % tp:
        raise ValueError(f"tp={tp} does not divide the group's {world} "
                         f"ranks")
    return make_mesh((world // tp, tp), ("data", "model"), kind)


def close_local_mesh():
    """End the one-rank group ``make_local_mesh`` started (a no-op when
    it started none) and remove its store."""
    root = _LOCAL_GROUP.pop("root", None)
    if root is None:
        return
    if dist.is_initialized():
        dist.destroy_process_group()
    shutil.rmtree(root, ignore_errors=True)
