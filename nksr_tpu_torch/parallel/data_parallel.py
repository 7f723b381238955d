"""Process groups, device meshes and data-parallel training (counterpart
of nksr_tpu/parallel/data_parallel.py).

JAX runs one controller over every chip of a ``Mesh``; PyTorch runs one
process a GPU (``torchrun --nproc_per_node=N``), NCCL between GPUs and
gloo on the CPU.  A 1-D ``torch.distributed.device_mesh.DeviceMesh``
over the default group stands for the JAX mesh: ``reconstruct(...,
mesh=make_mesh())``, ``dp_train_step(..., mesh)``.

The JAX step ``vmap``s the per-cloud forward and losses and takes the
mean over the batch, so XLA emits one gradient all-reduce.  Here each
rank runs its clouds one after the other, adds their gradients into one
flat f32 buffer and reduces it with one ``all_reduce``, then every rank
applies the same update: the parameters stay bit-equal across ranks.
``DistributedDataParallel`` is not used: its bucketed all-reduce sums in
an order of its own, it needs ``find_unused_parameters`` for the leaves
no loss reaches (JAX gives them zeros), and the step already owns
``.grad``.
"""

from __future__ import annotations

import datetime
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from . import spatial as SP

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


def mesh_device(mesh) -> torch.device:
    """The rank's device: its current card on a "cuda" mesh."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def stack_samples(samples) -> Dict[str, np.ndarray]:
    """Stack per-cloud batch dicts (``data.loader.to_device_batch``'s)
    into (B, ...) arrays; keys absent from any cloud are dropped."""
    keys = set(samples[0])
    for s in samples[1:]:
        keys &= set(s)
    return {k: np.stack([np.asarray(s[k]) for s in samples], 0)
            for k in sorted(keys)}


def to_device(batch: Dict, device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(np.asarray(v)).to(device)
            for k, v in batch.items()}


def shard_batch(mesh, batch: Dict) -> Dict[str, torch.Tensor]:
    """This rank's ``B // world`` clouds of a stacked (B, ...) ``batch``
    (rank r takes clouds r * B / world onwards, as JAX's ``data`` axis
    splits them), as tensors on the rank's device.  ``B`` must be a
    multiple of the world size."""
    n, r = SP.size(mesh), SP.rank(mesh)
    b = len(next(iter(batch.values())))
    if b % n:
        raise ValueError(f"batch of {b} clouds must be a multiple of the "
                         f"mesh's {n} ranks")
    per = b // n
    return to_device({k: np.asarray(v)[r * per:(r + 1) * per]
                      for k, v in batch.items()}, mesh_device(mesh))


def _leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves(tree[k])]
    return [tree]


def replicate(mesh, state):
    """Every rank's parameters and optimizer state set to rank 0's (one
    broadcast of them all, packed in f64, which holds their f32, int32
    and bool values exactly), so that every rank starts from one state.
    Returns ``state``, changed in place."""
    if SP.size(mesh) == 1:
        return state
    leaves = [p.data for p in state.net.parameters()] + \
        _leaves(state.opt_state)
    flat = torch.cat([t.reshape(-1).to(torch.float64) for t in leaves])
    buf = SP._to_comm(mesh, flat)
    dist.broadcast(buf, SP._global(mesh, 0), group=SP.group(mesh))
    flat = buf.to(flat.device)
    off = 0
    with torch.no_grad():
        for t in leaves:
            t.copy_(flat[off:off + t.numel()].view(t.shape).to(t.dtype))
            off += t.numel()
    return state


def sample_seed(seed: int, step: int, index: int, batch_size: int) -> int:
    """The draw generator's seed of the cloud at global ``index`` of a
    step's batch: the same on any world size, and at ``batch_size`` 1
    the single-device step's ``seed * 1000003 + step``."""
    return (seed * 1000003 + step) * batch_size + index


def dp_train_step(cfg, tc, lcfg, state, batch: Dict[str, torch.Tensor],
                  gens: Optional[Sequence[torch.Generator]], mesh,
                  use_gt_structure: bool = True,
                  samples: Optional[Sequence[Dict]] = None, tm=None):
    """One data-parallel step over this rank's ``b`` clouds (``batch``:
    stacked (b, ...) tensors, ``shard_batch``'s) of a global batch of
    ``b * world``.  Each cloud in turn: ``train.loop.loss_and_grads``
    (its draws from ``gens[i]``, or ``samples[i]``), its gradients
    (None as zeros) added into one flat f32 buffer in
    ``named_parameters()`` order; then one ``all_reduce`` sum of that
    buffer over the mesh, divided by the global batch and written back
    as ``.grad`` (which keeps it after the step), and the unchanged
    ``train.loop.apply_optimizer``: its value clip, finiteness test and
    AMSGrad see the batch mean, as optax sees it in JAX.  The loss terms
    are summed over the rank's clouds, reduced by one ``all_reduce`` and
    divided by the global batch (JAX's ``tree_map(jnp.mean)``), with
    "sum".  Returns (new state, losses as floats).  ``tm`` (a
    ``PhaseTimer`` that accumulates) adds "train: host build", "dp:
    flatten", "dp: all_reduce" and "train: optimizer" to
    ``loss_and_grads``' phases."""
    from ..models import pipeline as P
    from ..train import loop as T

    def lap(name):
        if tm is not None:
            tm.lap(name)
    net = state.net
    params = list(net.parameters())
    dev = params[0].device
    n_local = len(batch["xyz"])
    flat = torch.zeros(sum(p.numel() for p in params), dtype=torch.float32,
                       device=dev)
    names, loss_sum = None, None
    net.train()
    for i in range(n_local):
        inp = P.prepare_inputs(cfg, {k: v[i] for k, v in batch.items()},
                               dev, use_gt_structure)
        lap("train: host build")
        losses, _, _ = T.loss_and_grads(
            cfg, lcfg, net, inp, None if samples is None else samples[i],
            tm=tm, use_gt_structure=use_gt_structure,
            gen=None if gens is None else gens[i])
        off = 0
        for p in params:
            if p.grad is not None:
                flat[off:off + p.numel()] += p.grad.reshape(-1)
            off += p.numel()
        if names is None:
            names = list(losses)
        vec = torch.stack([losses[k].detach().float() for k in names])
        loss_sum = vec if loss_sum is None else loss_sum + vec
        lap("dp: flatten")
    n_global = n_local * SP.size(mesh)
    flat = SP.psum(mesh, flat) / n_global
    loss_mean = SP.psum(mesh, loss_sum) / n_global
    lap("dp: all_reduce")
    off = 0
    for p in params:
        p.grad = flat[off:off + p.numel()].view_as(p)
        off += p.numel()
    opt_state = T.apply_optimizer(tc, net, state.opt_state)
    lap("train: optimizer")
    return (T.TrainState(net, opt_state, state.step + 1),
            dict(zip(names, loss_mean.tolist())))
