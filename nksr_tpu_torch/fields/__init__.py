"""fields layer of the PyTorch port (see the package docstring): the
kernel field, the neural and mask fields, the texture field
(counterpart of nksr_tpu/fields/__init__.py's exports)."""

from .kernel_field import KernelField, FieldEval
from .neural_field import NeuralField, LayerField, PCNNField, DecoderFn
from .support import InterpolatorFn

__all__ = ["KernelField", "FieldEval", "NeuralField", "LayerField",
           "PCNNField", "DecoderFn", "InterpolatorFn"]
