"""Neighbour exchanges and collectives over a 1-D device mesh, and the
chunked reconstruction with its chunks dealt over the ranks (counterpart
of nksr_tpu/parallel/spatial.py).

The sharded routes exchange tensors through the mesh's process group:

  * under NCCL on the tensors' own GPU;
  * under gloo, which sends no CUDA tensor, through a host copy of each
    (a property of the backend the caller chose, not a fallback: it is
    what lets two ranks share one GPU, which NCCL refuses).

``halo_exchange_1d`` is JAX's ring (or open chain) of ``ppermute``s;
the x-slab solve and mesher (``lattice_shard.py``, ``mesh_shard.py``)
send whole planes with ``exchange``.  Every collective here is called
by every rank in the same order: a rank that skipped one would block
the others until the group's timeout.

``reconstruct_chunks_sharded``: the JAX package forces one
``LatticeSpec`` on every chunk so that it can stack them under ``vmap``,
a static-shape need of the TPU.  Here rank r reconstructs chunks r, r +
n, ... through the body of ``recon/chunking.reconstruct_chunked``, each
chunk's field is then broadcast from its rank, and every rank returns
the whole ``ChunkedField``: bit-equal to the serial chunked field on the
same device.
"""

from __future__ import annotations

import io
import pickle
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist


# ------------------------------------------------------------------ mesh
def group(mesh):
    return mesh.get_group()


def rank(mesh) -> int:
    return mesh.get_local_rank()


def size(mesh) -> int:
    return mesh.size()


def _global(mesh, r: int) -> int:
    return int(mesh.mesh.reshape(-1)[r])


def _staged(mesh) -> bool:
    """Whether tensors travel through host copies (gloo)."""
    return dist.get_backend(group(mesh)) != "nccl"


def _to_comm(mesh, t: torch.Tensor) -> torch.Tensor:
    return t.cpu().contiguous() if _staged(mesh) else t.contiguous()


# ------------------------------------------------------------ exchanges
def exchange(mesh, to_left: Optional[torch.Tensor],
             to_right: Optional[torch.Tensor], ring: bool = False
             ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Each rank sends ``to_left`` to rank - 1 and ``to_right`` to rank +
    1 and returns (what rank + 1 sent left, what rank - 1 sent right),
    on the device of the tensor sent.  Either may be None on every rank.
    ``ring``: the ends wrap; else the open chain's ends receive zeros."""
    n, r = size(mesh), rank(mesh)
    out = []
    for send, peer_send, peer_recv in ((to_left, r - 1, r + 1),
                                       (to_right, r + 1, r - 1)):
        if send is None:
            out.append(None)
            continue
        if ring:
            peer_send, peer_recv = peer_send % n, peer_recv % n
        if n == 1:
            out.append(send.clone() if ring else torch.zeros_like(send))
            continue
        buf = torch.zeros_like(_to_comm(mesh, send))
        ops = []
        if 0 <= peer_send < n:
            ops.append(dist.P2POp(dist.isend, _to_comm(mesh, send),
                                  _global(mesh, peer_send), group(mesh)))
        if 0 <= peer_recv < n:
            ops.append(dist.P2POp(dist.irecv, buf, _global(mesh, peer_recv),
                                  group(mesh)))
        for w in dist.batch_isend_irecv(ops):
            w.wait()
        out.append(buf.to(send.device))
    return out[0], out[1]


def halo_exchange_1d(mesh, values: torch.Tensor, halo: int,
                     ring: bool = True):
    """Exchange ``halo`` rows of this rank's slab ``values`` (L, ...)
    with its neighbours: returns (right_halo, left_halo), the first
    rows of rank + 1 and the last rows of rank - 1 (JAX's ``ppermute``
    pair, nksr_tpu/parallel/spatial.py:337).  ``ring=False``: the open
    chain, whose ends receive zeros."""
    return exchange(mesh, values[:halo], values[-halo:], ring=ring)


def psum(mesh, t: torch.Tensor) -> torch.Tensor:
    """``all_reduce`` sum of ``t`` over the mesh (the same value on every
    rank: each element is reduced once and broadcast)."""
    if size(mesh) == 1:
        return t
    buf = _to_comm(mesh, t).clone()
    dist.all_reduce(buf, group=group(mesh))
    return buf.to(t.device)


def all_gather_cat(mesh, t: torch.Tensor) -> torch.Tensor:
    """Every rank's ``t`` (one shape on all ranks) stacked in rank order
    along a new leading axis, on ``t``'s device."""
    n = size(mesh)
    if n == 1:
        return t[None]
    src = _to_comm(mesh, t)
    out = src.new_empty((n,) + tuple(src.shape))
    if _staged(mesh):
        dist.all_gather(list(out.unbind(0)), src, group=group(mesh))
    else:
        dist.all_gather_into_tensor(out, src, group=group(mesh))
    return out.to(t.device)


def all_gather_object(mesh, obj) -> list:
    out = [None] * size(mesh)
    if size(mesh) == 1:
        out[0] = obj
    else:
        dist.all_gather_object(out, obj, group=group(mesh))
    return out


def broadcast_bytes(mesh, data: Optional[bytes], src: int) -> bytes:
    """``data`` of rank ``src`` on every rank."""
    if size(mesh) == 1:
        return data
    dev = torch.device("cpu") if _staged(mesh) else \
        torch.device("cuda", torch.cuda.current_device())
    mine = rank(mesh) == src
    n = torch.tensor([len(data) if mine else 0], dtype=torch.int64,
                     device=dev)
    dist.broadcast(n, _global(mesh, src), group=group(mesh))
    buf = torch.frombuffer(bytearray(data), dtype=torch.uint8).to(dev) \
        if mine else torch.empty(int(n), dtype=torch.uint8, device=dev)
    dist.broadcast(buf, _global(mesh, src), group=group(mesh))
    return data if mine else buf.cpu().numpy().tobytes()


# --------------------------------------------------------------- chunks
class _FieldPickler(pickle.Pickler):
    """Pickles a chunk's field with the network's modules as references
    by name: the receiver's own network takes their place."""

    def __init__(self, f, net):
        super().__init__(f, protocol=pickle.HIGHEST_PROTOCOL)
        self._names = {id(m): name for name, m in net.named_modules()}

    def persistent_id(self, obj):
        if isinstance(obj, torch.nn.Module):
            return self._names.get(id(obj))
        return None


class _FieldUnpickler(pickle.Unpickler):
    def __init__(self, f, net):
        super().__init__(f)
        self._modules = dict(net.named_modules())

    def persistent_load(self, pid):
        return self._modules[pid]


def share_chunks(mesh, chunks: Sequence[Optional[dict]], net, device
                 ) -> List[dict]:
    """Every chunk on every rank: chunk i is broadcast from rank i % n,
    which holds it (the others hold None there).  Fields keep their
    tensors where their owner parked them, moved to ``device`` on the
    receivers; the network's modules are each rank's own."""
    n, r = size(mesh), rank(mesh)
    out = []
    for i, ch in enumerate(chunks):
        owner = i % n
        data = None
        if r == owner:
            f = io.BytesIO()
            _FieldPickler(f, net).dump(ch)
            data = f.getvalue()
        data = broadcast_bytes(mesh, data, owner)
        if r == owner:
            out.append(ch)
            continue
        ch = _FieldUnpickler(io.BytesIO(data), net).load()
        ch["field"].to(device)
        out.append(ch)
    return out


def reconstruct_chunks_sharded(recon, xyz: np.ndarray,
                               normal: Optional[np.ndarray],
                               sensor: Optional[np.ndarray],
                               chunk_size: float, mesh,
                               approx_kernel_grad: bool = False,
                               solver_tol: float = 1e-5):
    """``reconstruct(..., chunk_size=..., mesh=...)``: the chunked
    reconstruction with chunk i solved on rank i % n and shared (see the
    module docstring); every rank returns the whole ``ChunkedField``."""
    from ..recon.chunking import reconstruct_chunked
    return reconstruct_chunked(recon, xyz, normal, sensor, chunk_size,
                               approx_kernel_grad=approx_kernel_grad,
                               solver_tol=solver_tol, mesh=mesh)
