"""Production mesh builders on `torch.distributed`'s `DeviceMesh`; the
port of the JAX package's ``launch/mesh.py``.

FUNCTIONS (not module-level constants): importing this module starts no
process group and builds no mesh. The caller starts the group (gloo or
``fake`` on the CPU, NCCL on the card) with one rank per device; a mesh
covers every rank of it.
"""

from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def make_mesh_compat(shape, axes, *, device_type: str = "cuda") -> DeviceMesh:
    """A mesh of `shape` with axis names `axes` over the ranks of the
    started process group, in rank order (the last axis varies fastest)."""
    if not dist.is_initialized():
        raise RuntimeError("start a process group (torch.distributed.init_process_group) "
                           "before building a mesh")
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda") -> DeviceMesh:
    """16x16 = 256 chips per pod; 2 pods = 512 chips multi-pod."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh_compat(shape, axes, device_type=device_type)


def make_debug_mesh(data: int = 1, model: int = 1, *, device_type: str = "cuda") -> DeviceMesh:
    """Small mesh over however many ranks exist (CPU tests, one card)."""
    return make_mesh_compat((data, model), ("data", "model"), device_type=device_type)


def mesh_host_shard() -> tuple[int, int]:
    """``(host_id, num_hosts)`` of this process in the launch mesh — the
    pair `BlockPlan.shard` and ``restore_checkpoint(shard=...)``
    partition prefetch work by, and the host id a `repro_torch.peer.PeerGroup`
    must be constructed with so rendezvous block ownership agrees with
    plan sharding across the fleet. One process drives one card, so this
    is the process group's ``(rank, world_size)``; single-process runs
    (no group) get ``(0, 1)``."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1
