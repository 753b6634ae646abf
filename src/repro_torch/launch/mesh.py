"""Mesh factories, as the JAX package's ``launch/mesh.py`` has them.

``make_production_mesh`` is the dry run's mesh, larger than any machine the
port runs on: a ``VirtualMesh`` (one rank's view, no process group).
``make_host_mesh`` is the live one: a ``ProcessMesh`` over the process group
that is running (one rank where none is).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.distributed.context import VirtualMesh


def make_production_mesh(*, multi_pod: bool = False) -> VirtualMesh:
    """16×16 cards per pod, ``(data, model)``; 2 pods multi-pod (512 cards),
    ``(pod, data, model)``: rank 0's view."""
    shape = {"pod": 2, "data": 16, "model": 16} if multi_pod else {"data": 16, "model": 16}
    return VirtualMesh(shape, 0)


def make_host_mesh(model_parallel: int = 1, device: Optional[torch.device] = None):
    """A ``(data, model)`` mesh over every rank alive: the initialised
    ``torch.distributed`` group's world, or one rank (elastic restores,
    examples). ``device`` is this rank's (``cuda:LOCAL_RANK`` by default)."""
    import torch.distributed as dist

    from repro_torch.distributed.context import (ProcessMesh, default_backend,
                                                 rank_device)

    n = dist.get_world_size() if dist.is_initialized() else 1
    if model_parallel < 1 or n % model_parallel != 0:
        raise ValueError(
            f"cannot build a host mesh: {n} visible device(s) not divisible "
            f"by model_parallel={model_parallel}; pass a divisor of {n} "
            f"(e.g. model_parallel=1), or launch more ranks (torchrun "
            f"--nproc-per-node N; the JAX package emulates host devices with "
            f"XLA_FLAGS=--xla_force_host_platform_device_count=N)")
    dev = rank_device(device)
    if not dist.is_initialized():  # one rank: a group of one, in memory
        dist.init_process_group(default_backend(dev), store=dist.HashStore(), rank=0,
                                world_size=1)
    return ProcessMesh({"data": n // model_parallel, "model": model_parallel}, dev)
