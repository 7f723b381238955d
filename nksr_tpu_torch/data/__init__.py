"""Data layer of the PyTorch port: the mesh writer (the rest of
nksr_tpu/data is ROADMAP queue 1, item 16)."""

from .io import write_ply

__all__ = ["write_ply"]
