"""nksr_tpu_torch: the PyTorch + CUDA port of nksr_tpu for one NVIDIA
Hopper GPU.

It mirrors the JAX package's module layout.  It imports torch and numpy,
never JAX, flax or ``nksr_tpu``; the JAX package stays the reference the
port is tested against.  The points -> mesh path runs with the three
structures of the JAX package: predicted (the default), splat and
adaptive, on the dense lattice or, where its budgets are exceeded, on
the per-level predicted engine or the sparse fallback
(``recon/reconstructor.py`` says which input takes which):

    from nksr_tpu_torch import Reconstructor
    field = Reconstructor().reconstruct(xyz, normal)
    mesh = field.extract_dual_mesh(mise_iter=1)

and the README's lidar recipe, normals estimated from sensor positions
and the scene reconstructed in chunks:

    from nksr_tpu_torch import get_estimate_normal_preprocess_fn
    field = Reconstructor().reconstruct(
        xyz, sensor=sensor, chunk_size=20.0,
        preprocess_fn=get_estimate_normal_preprocess_fn(64, 85.0))
"""

from .models.pipeline import PipelineConfig
from .recon import Reconstructor, get_estimate_normal_preprocess_fn

__all__ = ["PipelineConfig", "Reconstructor",
           "get_estimate_normal_preprocess_fn"]
