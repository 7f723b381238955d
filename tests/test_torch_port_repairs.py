"""The port builds and runs from its own tree: its C++ host sources are its
own copies of the JAX package's, its scene generator is its own copy of
bench.py's, and no module of the port nor chip_smoke.py imports JAX,
flax, optax, msgpack, ``nksr_tpu``, ``bench`` or ``yaml`` (the card's
machine has none of the first five, nor PyYAML: the port reads run
configs and reads and writes checkpoints itself) or reaches into
``nksr_tpu/``.
"""

import ast
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import bench
from nksr_tpu_torch import native
from nksr_tpu_torch.utils.scenes import synthetic_scene

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "nksr_tpu_torch"
PORT_FILES = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "msgpack", "nksr_tpu",
             "bench", "yaml"}
# the acceptance grep, plus the single-quoted path component
GREP = re.compile(r"import (jax|flax|optax|msgpack)"
                  r"|from (jax|flax|optax|msgpack|nksr_tpu\b|bench)"
                  r"|import (nksr_tpu\b|bench)|\"nksr_tpu\"|'nksr_tpu'")


def _code_lines(path: Path):
    return [ln for ln in path.read_text().splitlines()
            if not ln.lstrip().startswith("//")]


@pytest.mark.parametrize("name", ["sortops.cpp", "kdtree.cpp", "raycast.cpp"])
def test_host_sources_are_the_jax_packages(name):
    """Line for line the JAX package's code; only comments may differ
    (two name no host path)."""
    ours = PORT / "host_src" / name
    assert ours in native.SOURCES
    assert _code_lines(ours) == _code_lines(REPO / "nksr_tpu" / "native"
                                            / name)


def test_native_builds_only_from_the_port():
    for src in native.SOURCES:
        assert src.is_file() and PORT in src.resolve().parents


@pytest.mark.parametrize("n,seed,half_extent",
                         [(1000, 0, 20.0), (5000, 3, 50.0), (1, 7, 30.0)])
def test_synthetic_scene_matches_bench(n, seed, half_extent):
    got = synthetic_scene(n, seed=seed, half_extent=half_extent)
    ref = bench.synthetic_scene(n, seed=seed, half_extent=half_extent)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype
        np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(REPO)) for p in PORT_FILES])
def test_no_jax_package_imports(path):
    src = path.read_text()
    assert not GREP.search(src)
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        assert not {n.split(".")[0] for n in names} & FORBIDDEN, names


def test_port_imports_with_the_jax_package_blocked():
    """Every module of the port, and chip_smoke.py, imports in a process
    where importing jax, flax, optax, msgpack, nksr_tpu, bench or yaml
    fails."""
    code = (
        "import importlib, pkgutil, sys\n"
        f"for m in {sorted(FORBIDDEN)!r}:\n"
        "    sys.modules[m] = None\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
        "import nksr_tpu_torch\n"
        "for info in pkgutil.walk_packages(nksr_tpu_torch.__path__,\n"
        "                                  'nksr_tpu_torch.'):\n"
        "    importlib.import_module(info.name)\n"
        "import chip_smoke\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO,
                   timeout=300)


# (keys, queries) with empty keys; the second is the JAX package's
# test_stencil_join_empty
EMPTY_KEY_CASES = [(np.empty(0, np.int64), np.empty(0, np.int64)),
                   (np.empty(0, np.int64), np.array([5], np.int64)),
                   (np.empty(0, np.int64), np.array([-3, 0, 7, 7, 1 << 40],
                                                    np.int64))]


@pytest.mark.parametrize("keys,q", EMPTY_KEY_CASES,
                         ids=["no-queries", "one-query", "five-queries"])
def test_numpy_joins_on_empty_keys_match_the_cpp_path(monkeypatch, keys, q):
    """The numpy fallback of sorted_join, keysearch and stencil_join (with
    and without cap) gives the C++ path's arrays on empty keys: all -1."""
    assert native._load() is not None, "the C++ host library did not build"
    deltas = np.array([0, 1], np.int64)

    def joins():
        return [native.sorted_join(keys, q), native.keysearch(keys, q),
                native.stencil_join(keys, q, deltas),
                native.stencil_join(keys, q, deltas, cap=4)]

    cpp = joins()
    monkeypatch.setattr(native, "_load", lambda: None)
    fallback = joins()
    for c, f in zip(cpp, fallback):
        assert f.dtype == c.dtype == np.int32 and f.shape == c.shape
        np.testing.assert_array_equal(f, c)
        assert (f == -1).all()
    assert fallback[2].shape == (len(q), 2)
