"""recon layer of the PyTorch port (see the package docstring)."""

from .reconstructor import Reconstructor, get_estimate_normal_preprocess_fn

__all__ = ["Reconstructor", "get_estimate_normal_preprocess_fn"]
