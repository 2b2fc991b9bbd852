"""Mesh construction (port of ``repro.launch.mesh``).

Functions, not module-level constants, so importing this module touches no
process group: the dry-run makes its ``fake`` group first.

``make_production_mesh`` is the reference's fleet, ``(16, 16)`` over
``("data", "model")`` or ``(2, 16, 16)`` over ``("pod", "data", "model")``,
as a ``DeviceMesh`` over a world of 256 or 512 ranks (the dry-run's fake
group).  ``make_local_mesh`` is a ``("data",)`` mesh over the world.  One
torch process drives one card, where one JAX process drives every local
device, so a single process's local mesh has one device (ROADMAP C17).
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist


def mesh_over(device_type: str, shape, names):
    """A ``DeviceMesh`` of ``shape`` over ``names`` on the first ranks of the
    current process group (every rank of the world must call it)."""
    from torch.distributed.device_mesh import DeviceMesh

    n = 1
    for d in shape:
        n *= d
    ranks = torch.arange(n, dtype=torch.int).reshape(tuple(shape))
    return DeviceMesh(device_type, ranks, mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cpu"):
    """The production mesh over the current process group, whose world must
    hold 512 (``multi_pod``) or 256 ranks (the dry-run's fake group).

    Its ``cpu`` default is no entry point that computes: the dry-run builds
    its models on ``meta`` tensors and runs nothing on the mesh's devices,
    so the type only names the fake group's backend."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return mesh_over(device_type, shape, axes)


def make_local_mesh(device: str = "cuda"):
    """Every rank of the world as a 1-D ``("data",)`` mesh on ``device``
    (``"cuda"`` or ``"cpu"``).

    With no process group yet, this process makes a world of one: ``nccl``
    for ``cuda``, ``gloo`` for the CPU, over an in-process store (no port;
    the caller destroys the group when done).
    Asked for ``cuda`` with no card it raises; it never falls back to the
    CPU.  Under ``cuda`` the rank's card is ``LOCAL_RANK`` (default 0).
    """
    device_type = torch.device(device).type
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"make_local_mesh: no mesh on {device!r}")
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("make_local_mesh('cuda'): no CUDA device")
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    if not dist.is_initialized():
        dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0, world_size=1)
    return mesh_over(device_type, (dist.get_world_size(),), ("data",))

