"""Process groups and device meshes for the port's sharding axes
(counterpart of ``jeicyboodsp_tpu/parallel/mesh.py``).

The JAX package names two axes: ``data`` (independent streams, no
communication) and ``time`` (the block axis of one stream, with halos and
prefix scans).  Here a mesh is a ``torch.distributed`` ``DeviceMesh`` whose
dimensions carry those names; each process is one rank of it, on one card
with NCCL or on the CPU with gloo.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist


def init_distributed(coordinator: str | None = None, num_processes: int | None = None,
                     process_id: int | None = None, device="cuda"):
    """Join this process to its world.

    ``coordinator`` is the rendezvous address (``tcp://host:port`` or
    ``file:///path``), ``num_processes`` the world size and ``process_id``
    this rank.  Without them the ``torchrun`` variables (``WORLD_SIZE``,
    ``RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) are read; a single process
    that was given no world does nothing, as JAX's single host.  NCCL on a
    CUDA ``device`` (this rank's card is ``LOCAL_RANK``, else the rank
    modulo the card count), gloo on the CPU.  Returns True once the process
    group is up."""
    if dist.is_initialized():
        return True
    if num_processes is None and "WORLD_SIZE" in os.environ:
        num_processes = int(os.environ["WORLD_SIZE"])
    if num_processes is None:
        return False  # one process, no world
    if process_id is None:
        process_id = int(os.environ.get("RANK", 0))
    dev = torch.device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", process_id % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    dist.init_process_group(backend, init_method=coordinator or "env://",
                            world_size=num_processes, rank=process_id)
    return True


def make_mesh(shape=None, axis_names=("data", "time")):
    """A ``DeviceMesh`` over the world with JAX's axis names.

    ``shape=None`` puts every rank on the last axis (time).  The device type
    follows the backend (``cuda`` under NCCL, ``cpu`` under gloo).  Raises
    when no process group is up: a sharded path never runs silently on one
    process."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("no process group: call init_distributed (or torchrun) first")
    n = dist.get_world_size()
    if shape is None:
        shape = (1,) * (len(axis_names) - 1) + (n,)
    shape = tuple(int(s) for s in shape)
    if int(np.prod(shape)) != n or len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {shape} with axes {axis_names} for a world of {n}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, shape, mesh_dim_names=tuple(axis_names))
