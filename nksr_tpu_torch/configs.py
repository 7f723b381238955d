"""Pretrained checkpoints by name (counterpart of nksr_tpu/configs.py):

    from nksr_tpu_torch import Reconstructor, configs
    ckpt = configs.load_checkpoint_from_url("ks")
    reconstructor = Reconstructor()
    reconstructor.network.load_state_dict(ckpt["state_dict"])

``load_checkpoint_from_url`` reads the local cache ``NKSR_TPU_CKPT_DIR``
and downloads nothing; ``models.network.NKSRNetwork.load_state_dict``
says which state-dict layouts it takes.
"""

from .utils.checkpoint import PRETRAINED, load_checkpoint_from_url

__all__ = ["load_checkpoint_from_url", "PRETRAINED"]
