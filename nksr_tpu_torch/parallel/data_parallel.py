"""Process groups and device meshes (counterpart of
nksr_tpu/parallel/data_parallel.py's ``init_distributed`` and
``make_mesh``; its data-parallel training step is ROADMAP item 15b).

JAX runs one controller over every chip of a ``Mesh``; PyTorch runs one
process a GPU (``torchrun --nproc_per_node=N``), NCCL between GPUs and
gloo on the CPU.  A 1-D ``torch.distributed.device_mesh.DeviceMesh``
over the default group stands for the JAX mesh: ``reconstruct(...,
mesh=make_mesh())``.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

# seconds a collective may wait before the group raises (a rank that
# stops early or raises alone would otherwise block the others)
TIMEOUT_S = 60


def init_distributed(backend: Optional[str] = None,
                     init_method: Optional[str] = None) -> bool:
    """Join the process group that torchrun's environment describes
    (``WORLD_SIZE``, ``RANK``; ``MASTER_ADDR`` and ``MASTER_PORT``
    unless ``init_method`` names another rendezvous, e.g. ``file://``).
    Returns False at world 1 (nothing to join) and True once the group
    is up.  ``backend``: "nccl" where CUDA is available, else "gloo"."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return False
    if dist.is_initialized():
        return True
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(
        backend, init_method=init_method or "env://", world_size=world,
        rank=int(os.environ["RANK"]),
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    return True


def make_mesh(device="cuda") -> DeviceMesh:
    """A 1-D ``DeviceMesh`` (axis "data") over every rank of the default
    group.  On "cuda" the rank's card is ``LOCAL_RANK`` (torchrun's; 0
    without it), and a missing GPU raises: nothing falls back to the
    CPU.  Without a group at world 1, a one-process group is made over
    an in-memory store, so the sharded routes run alone too."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh(device='cuda'): no CUDA device is "
                               "available")
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    if not dist.is_initialized():
        if int(os.environ.get("WORLD_SIZE", "1")) > 1:
            raise RuntimeError("make_mesh: WORLD_SIZE > 1 but no process "
                               "group; call init_distributed() first")
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo", store=dist.HashStore(),
            rank=0, world_size=1,
            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    return DeviceMesh(dev.type, list(range(dist.get_world_size())),
                      mesh_dim_names=("data",))
