"""The kernel probes (nksr_tpu_torch/ops/probes.py) and their entry point
(nksr_tpu_torch/scripts/probe_kernels.py) against the JAX package's
scripts/probe_mosaic.py and scripts/probe_mosaic_cascade.py.

The 11 Pallas probe bodies of probe_mosaic.py are taken from the script
itself (its ``probe`` is replaced by a recorder while its ``main`` runs),
with its own numpy checks; the bisect's bodies 0-5 live inside lambdas,
so they are restated here with the script's block specs.  Every body runs
in Pallas interpret mode on the CPU, on the script's input and on a
random one, against the port's plain version (what a CPU tensor takes),
and the script's own numpy check where it has one.  Tolerance: exact, except the leading-dim sum
and the window product (f32 sums in another order: rtol 1e-5 and atol
1e-5 of the largest value).  The CUDA kernels are held against the plain
versions on the card (tests/test_torch_cuda_kernels.py, chip_smoke.py).
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from nksr_tpu.fields import lattice as JLAT
from nksr_tpu.fields import lattice_pallas as JLP
from nksr_tpu_torch.fields import lattice_kernels as LK
from nksr_tpu_torch.ops import probes as P
from nksr_tpu_torch.scripts import probe_kernels as PK

torch.set_num_threads(1)

_SCRIPTS = Path(__file__).resolve().parent.parent / "scripts"
_VMEM = dict(memory_space=pltpu.VMEM)


@pytest.fixture(scope="module")
def mosaic_probes(tmp_path_factory):
    """name -> (kernel, out_shape, check) of scripts/probe_mosaic.py.  The
    script opens a log file under /tmp at import; its ``open`` is replaced
    so that the file lands in the test's own temporary directory."""
    logs = tmp_path_factory.mktemp("probe_mosaic_log")
    spec = importlib.util.spec_from_file_location(
        "jax_probe_mosaic", _SCRIPTS / "probe_mosaic.py")
    mod = importlib.util.module_from_spec(spec)
    mod.open = lambda path, *a, **k: open(logs / Path(path).name, *a, **k)
    spec.loader.exec_module(mod)
    found = {}
    mod.probe = lambda name, kernel, in_shape, out_shape, check=None: \
        found.__setitem__(name, (kernel, out_shape, check))
    mod.main()
    assert len(found) == 11
    return found


def _mosaic_call(kernel, out_shape):
    return pl.pallas_call(kernel, in_specs=[pl.BlockSpec(**_VMEM)],
                          out_specs=pl.BlockSpec(**_VMEM),
                          out_shape=jax.ShapeDtypeStruct(out_shape,
                                                         jnp.float32),
                          interpret=True)


# ---- bisect probes 0-5, restated from scripts/probe_mosaic_cascade.py
def _k0(x_ref, o_ref):
    o_ref[...] = x_ref[...] * 2.0


def _k1(x_ref, o_ref):
    d = pl.program_id(2)
    for dd in range(2):
        @pl.when(d == dd)
        def _(dd=dd):
            if dd == 0:
                o_ref[...] = x_ref[...] * 1.0
            else:
                o_ref[...] += x_ref[...]


def _k3(x_ref, o_ref):
    o_ref[...] = x_ref[...] + 1.0


def _k4(a_ref, z_ref, o_ref):
    # the script stores the (8, 128) product into the (1, 8, 128) block
    # as a whole, which interpret mode refuses; here into its one row
    a3 = a_ref[...]
    acat = jnp.concatenate(
        [a3[i, j:j + 8, :] for i in (0, 1) for j in (0, 1)], axis=-1)
    o_ref[0] = jax.lax.dot_general(
        acat, z_ref[...], (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32)


def _k5(x_ref, o_ref):
    o_ref[...] = jnp.broadcast_to(
        x_ref[...][:, None, :], (8, 2, 128)).reshape(16, 128)


def _k_perm(i_ref, o_ref):
    # probe_mosaic.py:67 with its index vector made in the kernel: JAX
    # refuses the script's captured jnp.arange constant
    idx = 127 - jax.lax.broadcasted_iota(jnp.int32, (128,), 0)
    o_ref[:] = jnp.take(i_ref[:], idx, axis=1)


def _f32(shape):
    return jax.ShapeDtypeStruct(shape, jnp.float32)


BISECT = {
    "times2": lambda: pl.pallas_call(_k0, out_shape=_f32((8, 128)),
                                     interpret=True),
    "grid_accumulate": lambda: pl.pallas_call(
        _k1, grid=(2, 2, 2),
        in_specs=[pl.BlockSpec((8, 64), lambda x, t, d: (x, t), **_VMEM)],
        out_specs=pl.BlockSpec((8, 64), lambda x, t, d: (x, t), **_VMEM),
        out_shape=_f32((16, 128)), interpret=True),
    "element_blocks": lambda: pl.pallas_call(
        _k0, grid=(2,),
        in_specs=[pl.BlockSpec((pl.Element(8), pl.Element(128)),
                               lambda i: (i * 4, 0), **_VMEM)],
        out_specs=pl.BlockSpec((8, 128), lambda i: (i, 0), **_VMEM),
        out_shape=_f32((16, 128)), interpret=True),
    "shifted_blocks": lambda: pl.pallas_call(
        _k3, grid=(4,),
        in_specs=[pl.BlockSpec((8, 128), lambda x: (x >> 1, 0), **_VMEM)],
        out_specs=pl.BlockSpec((8, 128), lambda x: (x, 0), **_VMEM),
        out_shape=_f32((32, 128)), interpret=True),
    "window_dot": lambda: pl.pallas_call(
        _k4, grid=(2,),
        in_specs=[pl.BlockSpec((pl.Element(2), pl.Element(16),
                                pl.Element(32)), lambda x: (x, 0, 0),
                               **_VMEM),
                  pl.BlockSpec(**_VMEM)],
        out_specs=pl.BlockSpec((1, 8, 128), lambda x: (x, 0, 0), **_VMEM),
        out_shape=_f32((2, 8, 128)), interpret=True),
    "row_replicate": lambda: pl.pallas_call(_k5, out_shape=_f32((16, 128)),
                                            interpret=True),
}


def test_probe_table_covers_both_scripts(mosaic_probes):
    """17 probes: the 11 of probe_mosaic.py by their labels, then the
    bisect's 0-5, each pointing at its TPU kernel."""
    assert len(P.PROBES) == 17
    assert [p.name for p in P.PROBES[:11]] == list(mosaic_probes)
    assert [p.key for p in P.PROBES[11:]] == list(BISECT)
    for p in P.PROBES:
        path, line = p.replaces.split(":")
        assert (_SCRIPTS.parent / path).is_file() and int(line) > 0


@pytest.mark.parametrize("key", [p.key for p in P.PROBES])
def test_probe_matches_pallas(key, mosaic_probes):
    p = next(p for p in P.PROBES if p.key == key)
    if key in BISECT:
        call, check = BISECT[key](), None
    else:
        kernel, out_shape, check = mosaic_probes[p.name]
        assert tuple(out_shape) == p.out_shape
        call = _mosaic_call(_k_perm if key == "lane_reverse" else kernel,
                            out_shape)
    rng = np.random.default_rng(7)
    for kind in ("script", "random"):
        ins = p.inputs(kind, rng)
        ref = np.asarray(call(*map(jnp.asarray, ins)))
        got = p(*map(torch.from_numpy, ins)).numpy()
        assert P.agree(got, ref, p.exact)[0], kind
        if check is not None and kind == "script":
            assert check(ins[0], got)    # the TPU script's own check
    if key == "dyn_lane_roll":         # the random input's shift is not 0
        assert int(ins[0][0, 0]) % 128 != 0


@pytest.mark.parametrize("dims", PK.CASCADE_DIMS,
                         ids=["depth-2", "depth-3"])
def test_cascade_bisect_specs_match_pallas(dims):
    """Bisect probes 6-8: the cascade kernels at the bisect's specs, on
    ones as the bisect runs them and on random coefficients."""
    spec = PK.cascade_spec(dims)
    jspec = JLAT.LatticeSpec(dims=dims, k=4, depth=len(dims),
                             adaptive_depth=1, s_pt=8, p_rows=4, s_gr=8,
                             n_pts_cap=8)
    rng = np.random.default_rng(8)
    for xs in ([np.ones((spec.n_cells(d), 4), np.float32)
                for d in range(spec.depth)],
               [rng.standard_normal((spec.n_cells(d), 4)).astype(np.float32)
                for d in range(spec.depth)]):
        ref = JLP.av0_cascade_pallas(
            jspec, [jnp.asarray(x.reshape(-1, 128)) for x in xs],
            jnp.float32, interpret=True)
        got = LK.av0_cascade(spec, [torch.from_numpy(x) for x in xs],
                             torch.float32)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    z = rng.standard_normal((spec.n_cells(0), spec.lanes)).astype(np.float32)
    ref = JLP.av0_adjoint_cascade_pallas(jspec, jnp.asarray(z),
                                         interpret=True)
    got = LK.av0_adjoint_cascade(spec, torch.from_numpy(z), torch.float32)
    for d in range(spec.depth):
        np.testing.assert_allclose(got[d].numpy().reshape(-1),
                                   np.asarray(ref[d]).reshape(-1),
                                   rtol=1e-5, atol=1e-5)


def test_probe_entry_point_passes_on_cpu(capsys):
    assert PK.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert sum(line.endswith(" ok") for line in out) == 17 + 3


def test_probe_entry_point_fails_on_a_wrong_result(monkeypatch, capsys):
    """One probe whose result differs from its plain version (as a wrong
    kernel's would): its line says FAIL and the run exits 1."""
    p = next(p for p in P.PROBES if p.key == "shift4")
    call = P.Probe.__call__
    monkeypatch.setattr(P.Probe, "__call__", lambda self, *ins: call(
        self, *ins) + (1.0 if self is p else 0.0))
    assert PK.main(["--device", "cpu"]) == 1
    out = capsys.readouterr().out
    assert f"{p.name:48s} FAIL" in out
    assert out.count(" ok\n") == 17 + 3 - 1


def test_probes_never_take_the_plain_version_off_the_cpu(monkeypatch):
    """A tensor that is not on the CPU launches the kernel or raises; a
    meta tensor stands in for a CUDA tensor here."""
    for p in P.PROBES:
        monkeypatch.setattr(p, "plain", None)
        ins = [torch.empty(s, device="meta") for s in p.in_shapes]
        with pytest.raises(RuntimeError, match="CUDA tensor"):
            p(*ins)
        assert p.launches == 0
