"""Multi-GPU reconstruction over ``torch.distributed`` (counterpart of
nksr_tpu/parallel/): one process a GPU, every rank calling
``Reconstructor.reconstruct(..., mesh=make_mesh())`` with the same cloud.

  * ``data_parallel``: ``init_distributed`` (torchrun's environment) and
    ``make_mesh`` (a 1-D ``DeviceMesh`` over the default group);
  * ``spatial``: the neighbour exchanges and collectives the sharded
    routes are built on (``halo_exchange_1d``) and the chunked
    reconstruction with its chunks dealt over the ranks
    (``reconstruct_chunks_sharded``);
  * ``lattice_shard``: one scene's lattice solve in x-slabs, a halo
    plane a depth exchanged in every matvec, CG dots by ``all_reduce``;
  * ``mesh_shard``: the dual marching cubes of a sharded field, slab by
    slab, merged on the host.
"""

from .data_parallel import init_distributed, make_mesh
from .spatial import halo_exchange_1d, reconstruct_chunks_sharded

__all__ = ["init_distributed", "make_mesh", "halo_exchange_1d",
           "reconstruct_chunks_sharded"]
