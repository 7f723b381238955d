"""The network's parameters as ``nn.Module``s, named as the flax tree is
(``encoder.Dense_0``, ``unet.enc_0.SparseConv_0``, ``interpolators.
interp_0.Dense_1`` ...), so ``utils.checkpoint.params_to_torch`` maps a
JAX checkpoint onto them key for key."""

from __future__ import annotations

from typing import TYPE_CHECKING, List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

if TYPE_CHECKING:
    from .pipeline import PipelineConfig


class MLP(nn.Module):
    """Dense layers ``Dense_0 .. Dense_n`` with SiLU between them."""

    def __init__(self, n_in: int, hidden: Sequence[int], n_out: int):
        super().__init__()
        dims = (n_in,) + tuple(hidden) + (n_out,)
        for i in range(len(dims) - 1):
            self.add_module(f"Dense_{i}", nn.Linear(dims[i], dims[i + 1]))
        self.n_layers = len(dims) - 1

    def layers(self) -> List[nn.Linear]:
        return [getattr(self, f"Dense_{i}") for i in range(self.n_layers)]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        *hidden, last = self.layers()
        for layer in hidden:
            x = F.silu(layer(x))
        return last(x)


def mlp_with_tangents(mlp: MLP, x: torch.Tensor, n_tan: int
                      ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """``1 + mlp(x)`` and its derivatives along the first ``n_tan`` input
    axes (forward-mode; ``nksr_tpu.fields.lattice._raw_blockdiag``).  The
    tangent of input axis a is the same indicator for every row, so its
    first-layer image is the weight column a."""
    layers = mlp.layers()
    h, tans = x, []
    for li, layer in enumerate(layers):
        pre = layer(h)
        if li == 0:
            t_pre = [layer.weight[:, a].expand_as(pre) for a in range(n_tan)]
        else:
            t_pre = [t @ layer.weight.T for t in tans]
        if li < len(layers) - 1:
            s = torch.sigmoid(pre)
            h = pre * s
            ds = s * (1.0 + pre * (1.0 - s))
            tans = [ds * t for t in t_pre]
        else:
            h, tans = pre, t_pre
    return 1.0 + h, tans


class Interpolators(nn.Module):
    """Per-depth basis MLPs ``interp_d``: (local offset, corner feature)
    -> k raw basis values."""

    def __init__(self, cfg: PipelineConfig):
        super().__init__()
        for d in range(cfg.tree_depth):
            self.add_module(f"interp_{d}", MLP(
                3 + cfg.basis_dim, (cfg.interp_hidden,) * cfg.interp_layers,
                cfg.kernel_dim))

    def level(self, d: int) -> MLP:
        return getattr(self, f"interp_{d}")


class MaskedGroupNorm(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))


class ConvBlock(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.SparseConv_0 = nn.Conv3d(cin, cout, 3, padding=1)
        self.MaskedGroupNorm_0 = MaskedGroupNorm(cout)
        self.SparseConv_1 = nn.Conv3d(cout, cout, 3, padding=1)
        self.MaskedGroupNorm_1 = MaskedGroupNorm(cout)


class UNetParams(nn.Module):
    """Conv blocks, stride-2 convs and heads of the dense UNet
    (``models/dense_unet.py`` runs them)."""

    def __init__(self, cfg: PipelineConfig):
        super().__init__()
        f = cfg.f_maps
        for d in range(cfg.tree_depth):
            self.add_module(f"enc_{d}", ConvBlock(f, f))
            self.add_module(f"dec_{d}", ConvBlock(f, f))
            self.add_module(f"struct_{d}", nn.Linear(f, 3))
            self.add_module(f"udf_{d}", nn.Linear(f, cfg.udf_dim))
            self.add_module(f"basis_{d}", nn.Linear(f, cfg.basis_dim))
            self.add_module(f"normal_{d}", nn.Linear(f, 3))
            if d < cfg.tree_depth - 1:
                self.add_module(f"down_{d}", nn.Conv3d(f, f, 2, stride=2))
            if d > 0:
                self.add_module(f"up_{d}", nn.ConvTranspose3d(
                    f, f, 2, stride=2, bias=False))


class NKSRNetwork(nn.Module):
    """All parameters of one model.  The UDF decoder is the UDF mask
    head's, the SDF decoder the ``geometry="neural"`` head's
    (``fields/neural_field.py``); a kernel-geometry model holds it
    unused, so a checkpoint loads whole."""

    def __init__(self, cfg: PipelineConfig):
        super().__init__()
        n_feat = 3 if cfg.feature in ("normal", "sensor") else 0
        self.encoder = MLP(n_feat + 4, (cfg.f_maps,), cfg.f_maps)
        self.unet = UNetParams(cfg)
        self.interpolators = Interpolators(cfg)
        self.sdf_decoder = MLP(cfg.basis_dim, (2 * cfg.basis_dim,) * 2, 1)
        self.udf_decoder = MLP(cfg.udf_dim, (2 * cfg.udf_dim,) * 2, 1)

    def load_state_dict(self, state_dict, strict: bool = True,
                        assign: bool = False):
        """Load one of three layouts, told apart by key set and shapes:

        (a) this module's own ``state_dict()`` (its keys, its shapes):
            torch's load, whole;
        (b) the JAX package's canonical export (``utils.checkpoint.
            params_to_torch_state_dict``): this module's keys, each leaf
            of the export's shape (3-D ``(Cout, Cin, 27)`` conv kernels,
            the stride-2 convs as flax leaves); every family through
            ``torch_state_dict_to_params`` and ``params_to_torch``, then
            torch's load, whole;
        (c) a reference-wheel checkpoint: no key of this module's and
            ``utils.checkpoint.looks_like_reference_state_dict``, e.g.
            ``configs.load_checkpoint_from_url("ks")["state_dict"]``: the
            interpolators and the decoders imported by order and shape
            (``import_reference_state_dict``, lenient as in the JAX
            package's ``NetworkHandle``), the encoder and the UNet kept as
            they are; each family's report is printed.

        (a) and (b) return torch's result (missing and unexpected keys,
        both empty).  (c) returns the module, as the JAX package's
        ``NetworkHandle.load_state_dict`` returns its handle.  Anything
        else, such as this module's layout at another width or depth or
        with keys missing, goes to torch's load with ``strict``, which
        raises on shapes, and with ``strict`` on keys, that do not
        match."""
        from ..utils import checkpoint as CK
        own = super().state_dict()
        shapes = {k: tuple(v.shape) for k, v in state_dict.items()}
        if shapes == {k: tuple(v.shape) for k, v in own.items()}:
            return super().load_state_dict(state_dict, strict, assign)
        tree = {"params": CK.torch_to_params(own)}
        export = CK.params_to_torch_state_dict(tree)
        if shapes == {k: v.shape for k, v in export.items()}:
            tree = CK.torch_state_dict_to_params(None, state_dict, tree)
            return super().load_state_dict(CK.params_to_torch(tree), True,
                                           assign)
        if not shapes.keys() & (own.keys() | export.keys()) and \
                CK.looks_like_reference_state_dict(state_dict):
            tree, report = CK.import_reference_state_dict(state_dict, tree)
            for fam, status in report.items():
                print(f"[nksr_tpu_torch] checkpoint import: {fam}: {status}")
            super().load_state_dict(CK.params_to_torch(tree), True, assign)
            return self
        return super().load_state_dict(state_dict, strict, assign)
