"""The ranks of the sharded engine: the port of ``xslam_tpu/parallel/mesh.py``.

The JAX package lays one mesh axis, ``space``, over its devices: volume
stages shard over X-slabs, the ICP system is summed over the same axis. Here
a :class:`SpaceGroup` is a ``torch.distributed`` process group whose rank r
holds the slab ``[r * local_x, (r + 1) * local_x)`` of the volume's X, on one
device: ``cuda:LOCAL_RANK`` over NCCL, or the CPU over gloo where the caller
asks for it. A failed NCCL set-up raises; nothing falls back to gloo or to the
CPU. A default group the caller initialised is taken with its backend, so
several ranks on one card, which NCCL refuses, run where the caller starts
gloo there.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.distributed as dist

_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


@dataclass(frozen=True)
class SpaceGroup:
    """The process group of the sharded engine and this process's place in it."""

    group: Optional[dist.ProcessGroup]  # the ranks' group, the default one; None: the default group
    rank: int
    world_size: int
    device: torch.device

    def slab(self, x: int) -> Tuple[int, int]:
        """This rank's X-slab ``[start, stop)`` of a volume ``x`` voxels long
        (``x`` a multiple of the world size)."""
        if x % self.world_size:
            raise ValueError(f"volume X {x} does not divide over {self.world_size} ranks")
        local = x // self.world_size
        return self.rank * local, (self.rank + 1) * local

    @property
    def backend(self) -> str:
        return dist.get_backend(self.group)


def init_space_group(device=None, init_method: Optional[str] = None, rank: Optional[int] = None,
                     world_size: Optional[int] = None) -> SpaceGroup:
    """This process's :class:`SpaceGroup`.

    ``device``: None for the card (NCCL on ``cuda:LOCAL_RANK``; CUDA must
    exist), ``"cpu"`` for gloo on the CPU. The rank and world size come from
    the arguments, else from torchrun's variables (``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``); without them the group
    is this process alone (over an in-process store). ``init_method`` (e.g.
    ``file://...`` or ``tcp://localhost:PORT``) where the caller gives the
    rendezvous itself. Where ``torch.distributed`` is already initialised its
    default group is taken as it is."""
    cpu = device is not None and torch.device(device).type == "cpu"
    if dist.is_initialized():
        return _group_of(cpu, int(os.environ.get("LOCAL_RANK", dist.get_rank())))
    env = {k: os.environ.get(k) for k in _ENV}
    if rank is None:
        rank = int(env["RANK"]) if env["RANK"] is not None else 0
    if world_size is None:
        world_size = int(env["WORLD_SIZE"]) if env["WORLD_SIZE"] is not None else 1
    local_rank = int(env["LOCAL_RANK"]) if env["LOCAL_RANK"] is not None else rank
    if cpu:
        backend = "gloo"
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("init_space_group: CUDA is not available (pass device='cpu' for gloo on the CPU)")
        torch.cuda.set_device(local_rank % torch.cuda.device_count())
        backend = "nccl"
    kwargs = dict(backend=backend, rank=rank, world_size=world_size)
    if init_method is not None:
        kwargs["init_method"] = init_method
    elif env["MASTER_ADDR"] is None and world_size == 1:
        kwargs["store"] = dist.HashStore()  # a group of one: no rendezvous
    elif env["MASTER_ADDR"] is None:
        raise ValueError("init_space_group: several ranks need init_method or torchrun's MASTER_ADDR and MASTER_PORT")
    dist.init_process_group(**kwargs)  # raises where the backend cannot start: no fallback
    return _group_of(cpu, local_rank)


def _group_of(cpu: bool, local_rank: int) -> SpaceGroup:
    backend = dist.get_backend()
    if cpu and backend != "gloo":
        raise ValueError(f"the process group runs {backend}: the CPU takes gloo")
    device = torch.device("cpu") if cpu else torch.device("cuda", local_rank % torch.cuda.device_count())
    return SpaceGroup(dist.group.WORLD, dist.get_rank(), dist.get_world_size(), device)


def destroy_space_group() -> None:
    """End the default process group, where one is initialised."""
    if dist.is_initialized():
        dist.destroy_process_group()
