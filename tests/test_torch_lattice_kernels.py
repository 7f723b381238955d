"""The AV0 cascade kernels' module (nksr_tpu_torch/fields/lattice_kernels.py)
against the Pallas kernels of the JAX package, run in interpret mode on
the CPU, and against the XLA cascade the JAX package runs by default.

On the CPU the wrappers take the plain PyTorch versions; the CUDA
kernels themselves are held against those plain versions on the card by
chip_smoke.py.  The test spec is the one of
tests/test_lattice.py::test_pallas_cascade_matches_xla (depth 3, so 96
lanes: nothing may assume 128).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nksr_tpu.fields import lattice as JLAT
from nksr_tpu.fields import lattice_pallas as JLP
from nksr_tpu_torch import cuda_build as CB
from nksr_tpu_torch.fields import lattice as LAT
from nksr_tpu_torch.fields import lattice_kernels as LK

torch.set_num_threads(1)

DIMS = ((24, 24, 16), (16, 16, 8), (8, 8, 8))


def _specs():
    kw = dict(dims=DIMS, k=4, depth=3, adaptive_depth=2, s_pt=64, p_rows=4,
              s_gr=32, n_pts_cap=256)
    return JLAT.LatticeSpec(**kw), LAT.LatticeSpec(**kw)


def _coeffs(spec, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(spec.n_cells(d), spec.k)).astype(np.float32)
            for d in range(spec.depth)]


def _interior(spec) -> np.ndarray:
    """Depth-0 cells whose ancestors avoid every depth's last row, where
    the XLA cascade's flat windows wrap and the kernels zero-fill."""
    x0, y0, z0 = spec.dims[0]
    X, Y, Z = np.meshgrid(np.arange(x0), np.arange(y0), np.arange(z0),
                          indexing="ij")
    inter = np.ones((x0, y0, z0), bool)
    for d in range(spec.depth):
        xd, yd, zd = spec.dims[d]
        inter &= ((X >> d) < xd - 1) & ((Y >> d) < yd - 1) \
            & ((Z >> d) < zd - 1)
    return inter.reshape(-1)


@pytest.mark.parametrize("h_override", [None, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_equals_pallas(h_override, dtype):
    """Pure selection: exactly equal to the Pallas kernel everywhere,
    edge cells included, for one and for several y-blocks."""
    jspec, spec = _specs()
    xs = _coeffs(spec, 11)
    ref = JLP.av0_cascade_pallas(
        jspec, [jnp.asarray(x.reshape(-1, 128)) for x in xs],
        getattr(jnp, dtype), interpret=True, h_override=h_override)
    got = LK.av0_cascade(spec, [torch.from_numpy(x) for x in xs],
                         getattr(torch, dtype))
    np.testing.assert_array_equal(
        got.float().numpy(), np.asarray(ref.astype(jnp.float32)))


def test_adjoint_matches_pallas():
    """f32 sums in another order than the Pallas halo fold: rtol/atol
    1e-5 (each output sums at most 8 * 4^3 unit-normal terms)."""
    jspec, spec = _specs()
    rng = np.random.default_rng(12)
    z = rng.normal(size=(spec.n_cells(0), spec.lanes)).astype(np.float32)
    ref = JLP.av0_adjoint_cascade_pallas(jspec, jnp.asarray(z),
                                         interpret=True)
    got = LK.av0_adjoint_cascade(spec, torch.from_numpy(z), torch.float32)
    for d in range(spec.depth):
        np.testing.assert_allclose(got[d].numpy().reshape(-1),
                                   np.asarray(ref[d]).reshape(-1),
                                   rtol=1e-5, atol=1e-5)


def test_forward_equals_xla_cascade_on_interior():
    """The JAX package's default (XLA) cascade agrees exactly on every
    cell a solve can reach."""
    jspec, spec = _specs()
    xs = _coeffs(spec, 13)
    ref = np.asarray(JLAT._av0_cascade(
        jspec, tuple(jnp.asarray(x.reshape(-1, 128)) for x in xs),
        jnp.float32))
    got = LK.av0_cascade(spec, [torch.from_numpy(x) for x in xs],
                         torch.float32).numpy()
    m = _interior(spec)
    assert m.sum() > 1000
    np.testing.assert_array_equal(got[m], ref[m])


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_adjoint_pair(compute_dtype):
    """<fwd(x), z> == <x, adj(z)>: the CG matvec must stay symmetric.
    With a bf16 compute dtype the adjoint reads z rounded to bf16, so
    the pair holds for that rounded z (1e-5 relative: f32 sums of ~1e5
    products in two orders)."""
    _, spec = _specs()
    cdt = getattr(torch, compute_dtype)
    xs = [torch.from_numpy(x) for x in _coeffs(spec, 14)]
    rng = np.random.default_rng(15)
    z = torch.from_numpy(rng.normal(
        size=(spec.n_cells(0), spec.lanes)).astype(np.float32))
    fwd = LK.av0_cascade(spec, xs, torch.float32).double()
    adj = LK.av0_adjoint_cascade(spec, z, cdt)
    lhs = float((fwd * z.to(cdt).double()).sum())
    rhs = float(sum((a.double() * x.double()).sum() for a, x in zip(adj, xs)))
    assert abs(lhs - rhs) / abs(lhs) < 1e-5


def test_cpu_calls_do_not_count_launches():
    _, spec = _specs()
    xs = [torch.from_numpy(x) for x in _coeffs(spec, 16)]
    before = (LK.av0_cascade.launches, LK.av0_adjoint_cascade.launches)
    LK.av0_adjoint_cascade(spec, LK.av0_cascade(spec, xs, torch.float32),
                           torch.float32)
    assert (LK.av0_cascade.launches,
            LK.av0_adjoint_cascade.launches) == before


def test_non_cpu_tensor_never_takes_the_plain_version(monkeypatch):
    """A tensor that is not on the CPU launches the kernel or raises; a
    meta tensor stands in for a CUDA tensor on this CUDA-less machine."""
    _, spec = _specs()

    def fail(*a, **k):
        raise AssertionError("plain version called for a device tensor")

    monkeypatch.setattr(LK, "av0_cascade_plain", fail)
    monkeypatch.setattr(LK, "av0_adjoint_cascade_plain", fail)
    xs = [torch.empty((spec.n_cells(d), spec.k), device="meta")
          for d in range(spec.depth)]
    with pytest.raises(RuntimeError, match="CUDA tensor"):
        LK.av0_cascade(spec, xs, torch.bfloat16)
    z = torch.empty((spec.n_cells(0), spec.lanes), device="meta")
    with pytest.raises(RuntimeError, match="CUDA tensor"):
        LK.av0_adjoint_cascade(spec, z, torch.float32)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """The kernels' build (nksr_tpu_torch/cuda_build.py) raises where
    there is no nvcc."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        CB.build_kernels()
