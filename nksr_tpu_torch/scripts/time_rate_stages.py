"""Where the two rate kernels' time goes on the card: each timed whole
and cut after each of its stages, and their grid sizes swept, as device
time in one CUDA graph of REPS calls.

    python -m nksr_tpu_torch.scripts.time_rate_stages

Stages (``csrc/sorted_scatter.cu``): ``scatter_rate_write`` 1 the two
32-way searches for the CTA's rows, 2 the pass that finds each cell's
first row, 3 whole (the row sums and stores); ``scatter_rate_read`` 1
its first launch (the slices' gathers and partial rows), 3 whole (with
the second, the fold).  A cut kernel is a copy of the source with a
return after the stage, built with nvcc into ``_build/`` beside the
package's kernels; whole, each is checked bit-equal to its wrapper.  The
sweep sets ``WRITE_CTAS``, ``READ_MIN_ROWS`` and ``READ_MAX_CTAS`` of
``ops/sorted_scatter.py`` one at a time, the others at their values.
Shapes: the study's (16,384 sorted rows into 8,192 cells) and the row
stage's (2^19 rows into 2^18 cells), stages at w = 32, the sweep at 32
and 128; the launch floor (an empty kernel) is printed first.  Exits 2
without a CUDA device.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys

import numpy as np
import torch

from .. import cuda_build as CB
from ..ops import probes as P
from ..ops import sorted_scatter as SS
from ..utils.profiling import graph_ms

REPS = 100
SHAPES = (("study", 16384, 8192), ("S", 1 << 19, 1 << 18))
SWEEP = (("WRITE_CTAS", (256, 512, 1024, 2048, 4096)),
         ("READ_MIN_ROWS", (32, 64, 128, 256, 512)),
         ("READ_MAX_CTAS", (256, 512, 1024, 2048, 4096)))
# (text of the source, what replaces it) in the staged copy
CUTS = (
    ("int64_t n_rows, int32_t bc, int32_t w, int32_t cells) {",
     "int64_t n_rows, int32_t bc, int32_t w, int32_t cells, int stop) {"),
    ("  const int64_t lo = range[0], hi = max64(range[0], range[1]);\n",
     "  const int64_t lo = range[0], hi = max64(range[0], range[1]);\n"
     "  if (stop == 1) {\n"
     "    if (threadIdx.x == 0 && lo > n_rows) out[0] = 1.0f;\n"
     "    return;\n  }\n"),
    ("  __syncthreads();\n  const int nv = w / W;\n",
     "  __syncthreads();\n"
     "  if (stop == 2) {\n"
     "    if (threadIdx.x == 0 && first[0] > n_rows) out[0] = 1.0f;\n"
     "    return;\n  }\n  const int nv = w / W;\n"),
)
ENTRIES = """
extern "C" int write_stage(const int32_t* idx, const float* y, float* out,
                           int64_t n, int32_t bc, int32_t w, int32_t cells,
                           int stop, void* s) {
  rate_write_kernel<float4><<<(unsigned)((bc + cells - 1) / cells),
                              RATE_THREADS, 0, (cudaStream_t)s>>>(
      idx, y, out, n, bc, w, cells, stop);
  return (int)cudaGetLastError();
}
extern "C" int read_stage(const int32_t* idx, const float* y, float* part,
                          float* out, int64_t n, int64_t ny, int32_t w,
                          int64_t rows, int64_t ctas, int stop, void* s) {
  rate_read_partials<float4><<<(unsigned)ctas, RATE_THREADS, 0,
                               (cudaStream_t)s>>>(idx, y, part, n, ny, w,
                                                  rows);
  if (stop == 3)
    rate_read_fold<float4><<<(w / 4 + FOLD_GROUPS - 1) / FOLD_GROUPS,
                             RATE_THREADS, 0, (cudaStream_t)s>>>(part, out,
                                                                 ctas, w);
  return (int)cudaGetLastError();
}
"""


def staged_source() -> str:
    """The package's rate kernels (the rate section of
    ``csrc/sorted_scatter.cu``) with a ``stop`` argument, cut as ``CUTS``
    says, and their entry points."""
    src = (CB.CSRC / "sorted_scatter.cu").read_text()
    src = src[src.index("#include <cuda_runtime.h>"):
              src.index("__global__ void blocked_scatter_kernel")]
    for old, new in CUTS:
        if src.count(old) != 1:
            raise RuntimeError(f"time_rate_stages: {old!r} is not once in "
                               "csrc/sorted_scatter.cu")
        src = src.replace(old, new)
    return src + ENTRIES


def staged_library() -> ctypes.CDLL:
    """``staged_source`` built with nvcc into ``_build/``."""
    CB.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = CB.BUILD_DIR / "rate_stages.cu"
    so = CB.BUILD_DIR / "librate_stages.so"
    cu.write_text(staged_source())
    subprocess.run([CB._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                    "-I", str(CB.CSRC), "-o", str(so), str(cu)], check=True)
    lib = ctypes.CDLL(str(so))
    p, i32, i64, c = (ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64,
                      ctypes.c_int)
    lib.write_stage.argtypes = [p, p, p, i64, i32, i32, i32, c, p]
    lib.read_stage.argtypes = [p, p, p, p, i64, i64, i32, i64, i64, c, p]
    return lib


def stages(lib, idx: torch.Tensor, y: torch.Tensor, bc: int, log) -> None:
    """Each kernel cut after stages 1, 2 and whole, at w = y.shape[1]."""
    n, w = y.shape
    out = torch.empty((bc, w), device="cuda")
    cells, _ = SS.rate_write_tiles(bc, SS.column_groups(w, True))
    rows, ctas = SS.rate_read_slices(n)
    part = torch.empty((ctas, w), device="cuda")
    row = torch.empty((1, w), device="cuda")

    def stream():     # the capturing stream inside graph_ms
        return torch.cuda.current_stream().cuda_stream

    def write(stop):
        CB.raise_on(lib.write_stage(idx.data_ptr(), y.data_ptr(),
                                    out.data_ptr(), n, bc, w, cells, stop,
                                    stream()), "write_stage")

    def read(stop):
        CB.raise_on(lib.read_stage(idx.data_ptr(), y.data_ptr(),
                                   part.data_ptr(), row.data_ptr(), n, n, w,
                                   rows, ctas, stop, stream()), "read_stage")

    for name, fn, stops in (("write", write, (1, 2, 3)),
                            ("read", read, (1, 3))):
        us = [graph_ms(lambda: fn(stop), REPS) * 1e3 for stop in stops]
        log(f"{name} n={n} bc={bc} w={w}: " + ", ".join(
            f"to stage {k} {u:.2f} us" for k, u in zip(stops, us)))
    if not (torch.equal(out, SS.scatter_rate_write(idx, y, bc))
            and torch.equal(row, SS.scatter_rate_read(idx, y))):
        raise AssertionError("time_rate_stages: the whole staged kernels "
                             "differ from the wrappers")


def run(log=print) -> None:
    rng = np.random.default_rng(0)
    log(f"== rate kernel stages on {torch.cuda.get_device_name(0)}; launch "
        f"floor {graph_ms(lambda: P.launch_floor('cuda'), REPS) * 1e3:.2f} "
        "us a launch")
    lib = staged_library()
    data = {}
    for tag, n, bc in SHAPES:
        idx = torch.from_numpy(np.sort(rng.integers(0, bc, n))
                               .astype(np.int32)).cuda()
        for w in (32, 128):
            data[tag, w] = idx, torch.from_numpy(rng.standard_normal(
                (n, w)).astype(np.float32)).cuda(), bc
        stages(lib, *data[tag, 32], log)
    for knob, values in SWEEP:
        default = getattr(SS, knob)
        kernel = "read" if knob.startswith("READ") else "write"
        for v in values:
            setattr(SS, knob, v)
            us = []
            for (tag, w), (idx, y, bc) in data.items():
                fn = ((lambda: SS.scatter_rate_read(idx, y))
                      if kernel == "read" else
                      (lambda: SS.scatter_rate_write(idx, y, bc)))
                us.append(f"{tag} w={w} {graph_ms(fn, REPS) * 1e3:.2f}")
            log(f"{kernel} {knob}={v}{' (default)' if v == default else ''}"
                f": " + ", ".join(us) + " us")
        setattr(SS, knob, default)


def main() -> int:
    if not torch.cuda.is_available():
        print("time_rate_stages: no CUDA device", file=sys.stderr)
        return 2
    run()
    return 0


if __name__ == "__main__":
    sys.exit(main())
