"""nksr_tpu_torch: the PyTorch + CUDA port of nksr_tpu for one NVIDIA
Hopper GPU.

It mirrors the JAX package's module layout.  It imports torch and numpy,
never JAX, flax or ``nksr_tpu``; the JAX package stays the reference the
port is tested against.  The ported route is the splat points -> mesh
path, on the dense lattice or, where its budgets are exceeded, on the
sparse fallback (``recon/reconstructor.py`` says which input takes
which):

    from nksr_tpu_torch import Reconstructor
    field = Reconstructor().reconstruct(xyz, normal, structure="splat")
    mesh = field.extract_dual_mesh(mise_iter=1)
"""

from .models.pipeline import PipelineConfig
from .recon.reconstructor import Reconstructor

__all__ = ["PipelineConfig", "Reconstructor"]
