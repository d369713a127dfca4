"""Meshes. Port of ``repro/launch/mesh.py``. Functions, not module
constants, so importing this module starts no process group.

The reference's production meshes are TPU pods (16 x 16 and 2 x 16 x 16
chips), which the port cannot make: ``make_production_mesh`` gives their
shape alone (``MeshShape``, the counterpart of JAX's ``AbstractMesh``), for
the sharding rules and the dry-run. ``make_mesh_for`` gives a real
``DeviceMesh`` over the ranks of a ``torch.distributed`` process group,
which ``init_process_group`` starts from the caller's size, rank and port
or from the environment ``torchrun`` sets (``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR``, ``MASTER_PORT``; the card by ``LOCAL_RANK``).
"""
from __future__ import annotations

import dataclasses
import math
import os
import socket

import torch
import torch.distributed as dist

from repro_torch import _device


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A shape-only mesh: axis names and sizes, no devices."""
    axis_sizes: tuple[int, ...]
    axis_names: tuple[str, ...]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    """Single pod: (data=16, model=16) = 256 chips. Multi-pod: (pod=2,
    data=16, model=16) = 512 chips; the `pod` axis is the slow axis — Hulk's
    placement puts only DP gradient reduction (or pipeline activations,
    cost-model-chosen) on it. The reference's shapes, without devices."""
    if multi_pod:
        return MeshShape((2, 16, 16), ("pod", "data", "model"))
    return MeshShape((16, 16), ("data", "model"))


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launched_world() -> int:
    """The world size ``torchrun`` gave this process (1 without one)."""
    return int(os.environ.get("WORLD_SIZE", "1"))


def init_process_group(backend: str, world_size: int | None = None,
                       rank: int | None = None,
                       port: int | None = None) -> None:
    """Join (or, with world size 1, start) the default process group. With
    a world size given, at ``tcp://localhost:<port>``: the caller gives the
    size, its rank and the port (a free one when none is given: world size
    1 only, other ranks must be told the same port). Without one, under
    ``torchrun`` (``WORLD_SIZE`` set), the group ``torchrun``'s environment
    describes (``env://``), with NCCL on the card ``LOCAL_RANK`` names
    (made the current one); else a group of this process alone."""
    if dist.is_initialized():
        return
    if world_size is None and "WORLD_SIZE" in os.environ:
        if backend == "nccl":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        dist.init_process_group(backend, init_method="env://")
        return
    world_size = 1 if world_size is None else world_size
    rank = 0 if rank is None else rank
    if port is None:
        if world_size != 1:
            raise ValueError("a process group of several ranks needs the "
                             "port every rank connects to")
        port = _free_port()
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            world_size=world_size, rank=rank)


def device_mesh(shape: tuple[int, ...], axis_names: tuple[str, ...],
                device=None):
    """A ``DeviceMesh`` of ``shape`` over ranks 0 .. prod(shape) - 1 of the
    process group, on the CUDA device unless ``device`` says otherwise
    (``"cpu"``: gloo). Without a process group it starts one of this process
    alone (NCCL on the card, gloo on the CPU)."""
    from torch.distributed.device_mesh import DeviceMesh
    dev = _device.resolve(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"a device mesh lives on CUDA or the CPU, not {dev}")
    init_process_group("nccl" if dev.type == "cuda" else "gloo")
    n = math.prod(shape)
    if n > dist.get_world_size():
        raise ValueError(f"a mesh of {n} ranks needs a process group that "
                         f"large, this one has {dist.get_world_size()}")
    return DeviceMesh(dev.type, torch.arange(n).reshape(shape),
                      mesh_dim_names=tuple(axis_names))


def make_mesh_for(devices_needed: int, device=None):
    """Best-effort mesh from the ranks actually available (one rank per
    device): (data=N, model=1), N = min(devices_needed, world size)."""
    available = dist.get_world_size() if dist.is_initialized() \
        else launched_world()
    n = min(devices_needed, available)
    return device_mesh((n, 1), ("data", "model"), device)
