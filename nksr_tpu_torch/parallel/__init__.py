"""Multi-GPU reconstruction over ``torch.distributed`` (counterpart of
nksr_tpu/parallel/): one process a GPU, every rank calling
``Reconstructor.reconstruct(..., mesh=make_mesh())`` with the same cloud.

  * ``data_parallel``: ``init_distributed`` (torchrun's environment),
    ``make_mesh`` (a 1-D ``DeviceMesh`` over the default group) and
    data-parallel training (``dp_train_step`` with ``replicate``,
    ``shard_batch`` and ``stack_samples``; ``train.driver.fit(
    batch_size=B)``);
  * ``spatial``: the neighbour exchanges and collectives the sharded
    routes are built on (``halo_exchange_1d``) and the chunked
    reconstruction with its chunks dealt over the ranks
    (``reconstruct_chunks_sharded``);
  * ``lattice_shard``: one scene's lattice solve in x-slabs, a halo
    plane a depth exchanged in every matvec, CG dots by ``all_reduce``;
  * ``mesh_shard``: the dual marching cubes of a sharded field, slab by
    slab, merged on the host.
"""

from .data_parallel import (make_mesh, shard_batch, replicate,
                            dp_train_step, init_distributed,
                            stack_samples)
from . import spatial
from .spatial import halo_exchange_1d, reconstruct_chunks_sharded

__all__ = ["make_mesh", "shard_batch", "replicate", "dp_train_step",
           "init_distributed", "stack_samples", "spatial",
           "halo_exchange_1d", "reconstruct_chunks_sharded"]
