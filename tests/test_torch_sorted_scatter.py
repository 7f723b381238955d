"""The sorted row scatter ops (nksr_tpu_torch/ops/sorted_scatter.py) and
the port's row-stage microbenchmark against the JAX package's
scripts/microbench_scatter.py.

The JAX script's own kernel bodies run through its own
``PrefetchScalarGridSpec`` in Pallas interpret mode on the CPU; the port's
wrappers take their plain versions on CPU tensors.  The CUDA kernels are
held against those plain versions on the card
(tests/test_torch_cuda_kernels.py, chip_smoke.py).  Tolerance: exact for unique indices (each cell receives
one row); where rows share a cell, rtol 1e-6 and an atol of 1e-6 of the
sum of the absolute terms (f32 sums in another order).
"""

import functools
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from nksr_tpu_torch.ops import sorted_scatter as SS
from nksr_tpu_torch.scripts import microbench_scatter as MB

torch.set_num_threads(1)

_SCRIPT = Path(__file__).resolve().parent.parent / "scripts" / \
    "microbench_scatter.py"


@pytest.fixture(scope="module")
def jmb(tmp_path_factory):
    """The JAX script, imported by path.  It opens a log file under /tmp at
    import; its ``open`` is replaced so that the file lands in the test's
    own temporary directory."""
    logs = tmp_path_factory.mktemp("scatterbench_log")
    spec = importlib.util.spec_from_file_location("jax_microbench_scatter",
                                                  _SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    mod.open = lambda path, *a, **k: open(logs / Path(path).name, *a, **k)
    spec.loader.exec_module(mod)
    return mod


def _script_starts(idx, c0, bc):
    """The JAX script's slot CSR (scripts/microbench_scatter.py:207-211)."""
    nb = (c0 + bc - 1) // bc
    counts = np.bincount(idx // bc, minlength=nb)
    cap = max(int(np.ceil(counts.max() / 256)) * 256, 512)
    starts = np.zeros(nb + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    return starts.astype(np.int32), cap


def _pallas_blocked(jmb, y, idx, c0, bc):
    """``_blocked_kernel`` through the grid spec of ``pallas_blocked``
    (SMEM slot index), y and idx padded by ``cap`` rows as the script
    pads them, in interpret mode."""
    w = y.shape[1]
    starts, cap = _script_starts(idx, c0, bc)
    nb = len(starts) - 1
    f = pl.pallas_call(
        functools.partial(jmb._blocked_kernel, cap=cap, bc=bc),
        grid_spec=pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=1, grid=(nb,),
            in_specs=[pl.BlockSpec(memory_space=pl.ANY),
                      pl.BlockSpec(memory_space=pl.ANY)],
            out_specs=pl.BlockSpec((bc, w), lambda b, s: (b, 0)),
            scratch_shapes=[pltpu.VMEM((cap, w), jnp.float32),
                            pltpu.SMEM((cap,), jnp.int32),
                            pltpu.SemaphoreType.DMA(()),
                            pltpu.SemaphoreType.DMA(())]),
        out_shape=jax.ShapeDtypeStruct((nb * bc, w), jnp.float32),
        interpret=True)
    yp = np.concatenate([y, np.zeros((cap, w), np.float32)])
    ip = np.concatenate([idx, np.zeros(cap, np.int32)])
    return np.asarray(f(jnp.asarray(starts), jnp.asarray(ip),
                        jnp.asarray(yp)))


def _rows(seed, c0, s, w, dup):
    rng = np.random.default_rng(seed)
    if dup:
        idx = np.sort(rng.integers(0, c0 // 8, s)).astype(np.int32)
    else:
        idx = np.sort(rng.choice(c0, s, replace=False)).astype(np.int32)
    return idx, rng.standard_normal((s, w)).astype(np.float32)


def _assert_sums(got, want, terms_abs, exact):
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        assert np.all(np.abs(got - want)
                      <= 1e-6 * np.abs(want) + 1e-6 * terms_abs)


@pytest.mark.parametrize("dup", [False, True], ids=["unique", "dup"])
@pytest.mark.parametrize("w", [32, 128])
def test_blocked_matches_pallas(jmb, w, dup):
    """At the TPU's block size and at the card's: the values do not
    depend on bc."""
    c0, s, bc = 8192, 1024, 2048
    idx, y = _rows(1, c0, s, w, dup)
    ref = _pallas_blocked(jmb, y, idx, c0, bc)
    terms = np.zeros_like(ref)
    np.add.at(terms, idx, np.abs(y))
    for b in (bc, SS.card_block_cells(w)):
        starts = SS.block_starts(idx, c0, b)
        got = SS.blocked_sorted_scatter(
            torch.from_numpy(y), torch.from_numpy(idx),
            torch.from_numpy(starts), c0, b).numpy()
        assert got.shape == (-(-c0 // b) * b, w)
        _assert_sums(got[:c0], ref[:c0], terms[:c0], exact=not dup)
        assert not got[c0:].any()


@pytest.mark.parametrize("w", [32, 128])
def test_rate_read_matches_pallas_row0(jmb, w):
    """``_rate_kernel_read`` writes row 0 of its (bc, w) output: the sum
    of the rows y[idx[r]], in row order."""
    cap, bc = 1024, 512
    rng = np.random.default_rng(2)
    idx = np.sort(rng.integers(0, bc, cap)).astype(np.int32)
    y = rng.standard_normal((cap, w)).astype(np.float32)
    f = pl.pallas_call(
        jmb._rate_kernel_read,
        grid_spec=pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=1, grid=(1,),
            in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)],
            out_specs=pl.BlockSpec(memory_space=pltpu.VMEM)),
        out_shape=jax.ShapeDtypeStruct((bc, w), jnp.float32), interpret=True)
    ref = np.asarray(f(jnp.asarray(idx), jnp.asarray(y)))[0:1]
    got = SS.scatter_rate_read(torch.from_numpy(idx),
                               torch.from_numpy(y)).numpy()
    assert got.shape == (1, w)
    _assert_sums(got, ref, np.abs(y[idx]).sum(0), exact=False)


@pytest.mark.parametrize("w", [32, 128])
def test_rate_write_matches_blocked_kernel_at_one_block(jmb, w):
    """``_rate_kernel_write`` never zeroes its output, so its defined
    function is ``_blocked_kernel`` at one block: zero, then
    o[idx[r]] += y[r] in row order."""
    cap, bc = 1024, 512
    rng = np.random.default_rng(3)
    idx = np.sort(rng.integers(0, bc, cap)).astype(np.int32)
    y = rng.standard_normal((cap, w)).astype(np.float32)
    ref = _pallas_blocked(jmb, y, idx, bc, bc)
    got = SS.scatter_rate_write(torch.from_numpy(idx), torch.from_numpy(y),
                                bc).numpy()
    terms = np.zeros_like(ref)
    np.add.at(terms, idx, np.abs(y))
    assert got.shape == (bc, w)
    _assert_sums(got, ref, terms, exact=False)


@pytest.mark.parametrize("c0,bc", [(4096, 1024), (MB.C0, 4096),
                                   (MB.C0, 8192), (MB.C0, 512)])
def test_block_starts_matches_script(c0, bc):
    """``block_starts`` is the script's construction, at its own sizes
    (S = 2^19 unique rows of C0 cells, bc 4096 and 8192) and at the
    card's."""
    s = min(MB.S, c0 // 2)
    idx, _ = _rows(4, c0, s, 1, dup=False)
    starts = SS.block_starts(idx, c0, bc)
    np.testing.assert_array_equal(starts, _script_starts(idx, c0, bc)[0])
    assert starts.dtype == np.int32


def test_microbench_runs_on_cpu(monkeypatch, capsys):
    """The entry point at a tiny size: every line printed, each hand
    kernel recorded with its numbers."""
    monkeypatch.setattr(MB, "run", functools.partial(MB.run, rows=1024,
                                                     cells=8192))
    assert MB.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    for label in ("index_select 32-wide", "index_copy_", "sorted dup",
                  "rate write", "rate read", "blocked sorted scatter w=128"):
        assert label in out
    res = MB.run("cpu", essential=True, rows=512, cells=4096,
                 log=lambda m: None)
    assert set(res) == {"scatter_rate_write", "scatter_rate_read",
                        "blocked_sorted_scatter"}
    for rec in res.values():
        assert rec["max_abs_err"] == 0.0 and rec["ms"] > 0
        assert rec["bytes"] > 0 and rec["library_ms"] > 0


def test_microbench_raises_on_a_wrong_kernel(monkeypatch):
    """A hand kernel that disagrees with its plain version ends the run
    (the JAX script only logged its MISMATCH)."""
    def wrong(y, idx, starts, n_cells, bc):
        return SS.blocked_sorted_scatter_plain(y, idx, starts, n_cells,
                                               bc) + 1.0
    monkeypatch.setattr(SS, "blocked_sorted_scatter", wrong)
    with pytest.raises(AssertionError, match="blocked_sorted_scatter"):
        MB.run("cpu", essential=True, rows=512, cells=4096,
               log=lambda m: None)


def test_cpu_calls_do_not_count_launches():
    idx, y = _rows(5, 2048, 256, 32, dup=True)    # idx < 256 = rows of y
    ti, ty = torch.from_numpy(idx), torch.from_numpy(y)
    fns = (SS.scatter_rate_write, SS.scatter_rate_read,
           SS.blocked_sorted_scatter)
    before = [f.launches for f in fns]
    SS.scatter_rate_write(ti, ty, 2048)
    SS.scatter_rate_read(ti, ty)
    SS.blocked_sorted_scatter(ty, ti, torch.from_numpy(
        SS.block_starts(idx, 2048, 512)), 2048, 512)
    assert [f.launches for f in fns] == before


def test_non_cpu_tensor_never_takes_the_plain_version(monkeypatch):
    """A tensor that is not on the CPU launches the kernel or raises; a
    meta tensor stands in for a CUDA tensor on this CUDA-less machine."""
    def fail(*a, **k):
        raise AssertionError("plain version called for a device tensor")
    for name in ("scatter_rate_write_plain", "scatter_rate_read_plain",
                 "blocked_sorted_scatter_plain"):
        monkeypatch.setattr(SS, name, fail)
    idx = torch.empty((64,), dtype=torch.int32, device="meta")
    y = torch.empty((64, 32), device="meta")
    starts = torch.empty((9,), dtype=torch.int32, device="meta")
    with pytest.raises(RuntimeError, match="CUDA tensor"):
        SS.scatter_rate_write(idx, y, 128)
    with pytest.raises(RuntimeError, match="CUDA tensor"):
        SS.scatter_rate_read(idx, y)
    with pytest.raises(RuntimeError, match="CUDA tensor"):
        SS.blocked_sorted_scatter(y, idx, starts, 1024, 128)


def _assert_tiles(starts, ends, n):
    """Slices [starts[k], ends[k]) cover [0, n) once each, in order, none
    empty."""
    if n == 0:
        assert (ends == starts).all()
        return
    assert starts[0] == 0 and ends[-1] == n
    np.testing.assert_array_equal(starts[1:], ends[:-1])
    assert (ends > starts).all()


@pytest.mark.parametrize("n", [0, 1, 127, 128, 129, 16384, 131071, 1 << 19,
                               3_000_001])
def test_rate_read_slices_cover_every_index_once(n):
    rows, ctas = SS.rate_read_slices(n)
    assert ctas >= 1 and rows >= SS.READ_MIN_ROWS
    assert ctas <= max(1, SS.READ_MAX_CTAS)
    starts = np.arange(ctas, dtype=np.int64) * rows
    _assert_tiles(starts, np.minimum(starts + rows, n), n)


@pytest.mark.parametrize("w,vec4", [(4, True), (32, True), (128, True),
                                    (32, False), (6, False), (4096, True)])
@pytest.mark.parametrize("bc", [0, 1, 33, 8192, 8205, 1 << 18, 1 << 23])
def test_rate_write_tiles_cover_every_cell_once(bc, w, vec4):
    """A CTA's cells give each thread the same number of (cell, column
    group) items, one where the grid stays within WRITE_CTAS, and fit the
    kernel's RATE_MAX_CELLS; the tiles cover the table once."""
    nv = SS.column_groups(w, vec4)
    assert nv * (4 if vec4 else 1) == w
    cells, ctas = SS.rate_write_tiles(bc, nv)
    base = max(1, SS.RATE_THREADS // nv)
    assert 1 <= cells <= SS.RATE_MAX_CELLS and cells % base == 0
    # the fewest items a thread that keep the grid within WRITE_CTAS, or
    # as many as RATE_MAX_CELLS allows
    assert cells == base or -(-bc // (cells - base)) > SS.WRITE_CTAS
    assert ctas <= SS.WRITE_CTAS or cells + base > SS.RATE_MAX_CELLS
    starts = np.arange(ctas, dtype=np.int64) * cells
    _assert_tiles(starts, np.minimum(starts + cells, bc), bc)


def test_rate_grids_fill_the_card():
    """Not one CTA: at cap 16384 rows into 8192 cells, w = 32, 256 CTAs of
    32 cells for the write and 128 slices of 128 indices for the read; at
    the row stage's 2^19 rows into 2^18 cells, 1024 CTAs for the write
    and 512 slices of 1024 indices for the read."""
    nv = SS.column_groups(32, True)
    assert SS.rate_write_tiles(MB.RATE_BC, nv) == (32, 256)
    assert SS.rate_read_slices(MB.RATE_CAP) == (128, 128)
    assert SS.rate_write_tiles(MB.S // 2, nv) == (256, 1024)
    assert SS.rate_write_tiles(MB.S // 2, SS.column_groups(128, True)) == \
        (256, 1024)
    assert SS.rate_read_slices(MB.S) == (1024, 512)


def test_rate_stage_cuts_match_the_kernel_source():
    """The stage-timing script's cuts each find their text once in the
    rate kernels' source, so its staged copy tracks the kernels."""
    from nksr_tpu_torch.scripts import time_rate_stages as TS
    src = TS.staged_source()
    # the write kernel and the two entry points take it; the write's two
    # cuts and the read's entry point read it
    assert src.count("int stop") == 3 and src.count("stop == ") == 3
    assert "blocked_scatter_kernel" not in src
