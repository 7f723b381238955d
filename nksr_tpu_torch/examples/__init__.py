"""The port's examples: the JAX package's recipes of examples/ on the
port's API (``python -m nksr_tpu_torch.examples.<name>``)."""
