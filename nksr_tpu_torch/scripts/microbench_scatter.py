"""Microbenchmark of the lattice CG adjoint's row stage: sorted row
scatter-add strategies on the card.

    python -m nksr_tpu_torch.scripts.microbench_scatter [--essential]
        [--device cpu]

Counterpart of scripts/microbench_scatter.py, at its shapes and seed
(S = 2^19 slot rows, C0 = 5,326,848 dense depth-0 cells, ``default_rng(0)``;
``idx_u`` unique sorted, ``idx_d`` sorted with duplicates over C0 // 8).
The XLA strategies become their PyTorch calls: the 32- and 128-wide bf16
gathers ``index_select``; scatter-add ``zeros(...).index_add_`` (PyTorch
has no sortedness or uniqueness hint, so XLA's plain and sorted+unique
lines are one call here); scatter-SET ``index_copy_``.  The three Pallas
kernels become the hand kernels of ``ops/sorted_scatter.py``: the rate
kernels and the blocked sorted scatter at the card's block size, on
``idx_u`` and on ``idx_d``.

The rate kernels.  The TPU study ran ``pallas_rate`` on ``grid=(1,)``:
on its one-TensorCore v5e chip that was the whole chip, and the figure
of merit was the chip's time per row.  Their kernels here use the whole
card the same way (a grid over tiles of cells for the write, slices of
the indices for the read), at the study's shape (cap 16,384 sorted rows
into bc 8,192 cells) and at the row stage's (S rows into S // 2 cells,
two rows a cell as in the study).  Bytes bound both; at the study's
shape one launch costs more than the bound, so each rate line also
prints the launch floor (an empty kernel, ``ops/probes.launch_floor``)
timed the same way.

Each line is the mean of REPS calls timed with CUDA events after one
warm-up call (on ``--device cpu``, the host clock: a rehearsal, no device
metric), in ms and ns per row.  The rate lines lead with device time
from one CUDA graph of GRAPH_REPS calls (the host's dispatch taken out;
for a kernel of a few microseconds CUDA events read the host's enqueue
rate), the events figure beside it.  Each hand kernel's result is held
against its plain version first, and a mismatch raises: the rate write
bit for bit against its plain version on a CPU copy (CPU ``index_add_``
adds in row order, as the kernel does), the blocked scatter exact for
unique indices; rtol 1e-5 and atol 1e-5 of the largest output where rows
share a cell or for the rate read (f32 sums in another order).  The two
rate kernels are also bit-equal from call to call.  ``--essential``
keeps the lines the JAX script's ``NKSR_BENCH_ESSENTIAL=1`` keeps, plus
the duplicate-index blocked scatter and the row stage's rate lines at
w = 32.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Callable, Dict

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import probes as P
from ..ops import sorted_scatter as SS
from ..utils.profiling import bound_ms, graph_ms

S = 1 << 19          # slot rows
C0 = 5326848         # dense depth-0 cells at bench scale
REPS = 8
GRAPH_REPS = 100     # calls in one CUDA graph (as the probes are timed)
RATE_CAP, RATE_BC = 16384, 8192   # the JAX script's rate-kernel sizes


def time_ms(fn: Callable, device: str, reps: int = REPS) -> float:
    """Mean ms per call over ``reps`` calls after one warm-up call: CUDA
    events on the card, the host clock on the CPU."""
    fn()
    if device == "cpu":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def check(got: torch.Tensor, ref: torch.Tensor, exact: bool,
          what: str) -> float:
    """Max abs error of ``got`` against ``ref``; raises past the bound."""
    if got.shape != ref.shape:
        raise AssertionError(f"{what}: shape {tuple(got.shape)} != "
                             f"{tuple(ref.shape)}")
    err = float((got - ref).abs().max()) if got.numel() else 0.0
    if exact and err != 0.0:
        raise AssertionError(f"{what}: max abs error {err}, expected exact")
    if not exact:
        torch.testing.assert_close(got, ref, rtol=1e-5,
                                   atol=1e-5 * float(ref.abs().max()),
                                   msg=lambda m: f"{what}: {m}")
    return err


def run(device: str = "cuda", essential: bool = False, rows: int = S,
        cells: int = C0, seed: int = 0, log=print) -> Dict:
    """Run and print every line; returns, per hand kernel, its max error
    over every check and, at w = 32 (unique indices for the blocked
    scatter, the study's shape for the rate kernels), its ms, plain ms,
    library ms and the bytes and f32 operations of one call; the rate
    kernels' ms are device time from one CUDA graph with the events
    figures beside them (``events_ms`` ...) and their row stage's records
    (``row_stage``, by width); on the card each kernel's ``floor_ms``,
    the empty kernel timed as that kernel is timed."""
    dev = torch.device(device)
    rng = np.random.default_rng(seed)
    idx_u = np.sort(rng.choice(cells, rows, replace=False)).astype(np.int32)
    idx_d = np.sort(rng.integers(0, cells // 8, rows)).astype(np.int32)
    ys = {32: torch.from_numpy(
              rng.standard_normal((rows, 32)).astype(np.float32)).to(dev),
          128: torch.from_numpy(
              rng.standard_normal((rows, 128)).astype(np.float32)).to(dev)}
    ju = torch.from_numpy(idx_u).to(dev)
    jd = torch.from_numpy(idx_d).to(dev)
    ju64, jd64 = ju.long(), jd.long()   # index_copy_ takes int64 only
    gen = torch.Generator(device=dev).manual_seed(seed)
    kernels: Dict[str, Dict] = {}

    def line(name, fn, per_rows=rows):
        ms = time_ms(fn, device)
        log(f"{name:64s} {ms:9.4f} ms {ms * 1e6 / per_rows:8.2f} ns/row")
        return ms

    def in_turns(kernel_fn, plain_fn, graph=False):
        """plain, kernel, kernel, plain, by CUDA events (the host clock on
        the CPU) or by ``graph_ms``: the faster of each pair."""
        t = ((lambda fn: graph_ms(fn, GRAPH_REPS)) if graph else
             (lambda fn: time_ms(fn, device)))
        p1, k1, k2, p2 = t(plain_fn), t(kernel_fn), t(kernel_fn), t(plain_fn)
        return min(k1, k2), min(p1, p2)

    def turns(label, kernel_fn, plain_fn, err, per_rows):
        ms, plain = in_turns(kernel_fn, plain_fn)
        log(f"{label:64s} {ms:9.4f} ms {ms * 1e6 / per_rows:8.2f} ns/row  "
            f"(plain {plain:.4f} ms, max err {err:.2e})")
        return ms, plain

    def record(name, w, err, **kw):
        rec = kernels.setdefault(name, {"max_abs_err": 0.0})
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        if w == 32 and kw:
            rec.update(kw)

    log(f"== scatter microbench on {device}"
        + (f" ({torch.cuda.get_device_name(dev)})" if device == "cuda"
           else " (host clock: a rehearsal)")
        + f": S {rows}, C0 {cells}, REPS {REPS}")

    # ---- library lines (the XLA strategies' PyTorch calls)
    for w in ((128,) if essential else (32, 128)):
        table = torch.randn((cells, w), generator=gen, device=dev,
                            dtype=torch.bfloat16)
        line(f"index_select {w}-wide bf16 (gather rate ref)",
             lambda: table.index_select(0, ju64))
        del table

    def index_add(w, idx):
        return lambda: torch.zeros((cells, w), device=dev).index_add_(
            0, idx, ys[w])

    library = {32: line("index_add_ 32 unique (= XLA plain and sorted+unique)",
                        index_add(32, ju64))}
    if not essential:
        line("index_copy_ 32 unique (XLA scatter-SET sorted+unique)",
             lambda: torch.zeros((cells, 32), device=dev).index_copy_(
                 0, ju64, ys[32]))
        line("index_add_ 32 sorted dup (d1-like)", index_add(32, jd64))
    library[128] = line("index_add_ 128 unique (XLA sorted+unique)",
                        index_add(128, ju64))

    # ---- the rate kernels on the whole card: the study's shape, then the
    # row stage's
    floor = None
    if device == "cuda":
        floor = {"graph_ms": graph_ms(lambda: P.launch_floor(dev),
                                      GRAPH_REPS),
                 "events_ms": time_ms(lambda: P.launch_floor(dev), device)}
        log(f"{'launch floor (empty kernel), CUDA graph':64s} "
            f"{floor['graph_ms']:9.4f} ms  (events "
            f"{floor['events_ms']:.4f} ms)")

    def rate_line(label, kernel_fn, plain_fn, lib_name, lib_fn, n_bytes,
                  ops, per_rows, err):
        """Kernel and plain version in turns and the library call, as
        device time in one CUDA graph (on the CPU, the host clock) and by
        CUDA events; the line and its record."""
        ms, plain = in_turns(kernel_fn, plain_fn)
        rec = {"ms": ms, "plain_ms": plain, "library_ms": time_ms(lib_fn,
                                                                  device),
               "bytes": n_bytes, "ops": ops}
        bound, by = bound_ms(n_bytes, ops)
        tail = ""
        if device == "cuda":
            rec["events_ms"], rec["plain_events_ms"] = rec["ms"], plain
            rec["library_events_ms"] = rec["library_ms"]
            rec["ms"], rec["plain_ms"] = in_turns(kernel_fn, plain_fn,
                                                    graph=True)
            rec["library_ms"] = graph_ms(lib_fn, GRAPH_REPS)
            tail = (f"; events {rec['events_ms']:.4f}, plain "
                    f"{rec['plain_events_ms']:.4f}, {lib_name} "
                    f"{rec['library_events_ms']:.4f}; floor "
                    f"{floor['graph_ms']:.4f} / {floor['events_ms']:.4f}")
        log(f"{label:64s} {rec['ms']:9.4f} ms "
            f"{rec['ms'] * 1e6 / per_rows:8.2f} ns/row  (plain "
            f"{rec['plain_ms']:.4f}, {lib_name} {rec['library_ms']:.4f}; "
            f"bound {bound:.5f} by {by}; max err {err:.2e}{tail})")
        return rec

    def rate_pair(tag, ji, y, bc, per_rows):
        """Both rate kernels on sorted indices ``ji`` into ``bc`` cells and
        rows ``y``: checked, then timed; (write record, read record, the
        read's max error)."""
        w = y.shape[1]
        got = SS.scatter_rate_write(ji, y, bc)
        if not torch.equal(got.cpu(), SS.scatter_rate_write_plain(
                ji.cpu(), y.cpu(), bc)):
            raise AssertionError(f"scatter_rate_write {tag} w={w}: differs "
                                 "from CPU index_add_")
        if not torch.equal(got, SS.scatter_rate_write(ji, y, bc)):
            raise AssertionError(f"scatter_rate_write {tag} w={w}: two "
                                 "calls differ")
        vec4 = w % 4 == 0
        cells, ctas = SS.rate_write_tiles(bc, SS.column_groups(w, vec4))
        n = ji.numel()
        wrec = rate_line(
            f"rate write {tag} bc={bc} w={w} (grid {ctas} x "
            f"{SS.RATE_THREADS})",
            lambda: SS.scatter_rate_write(ji, y, bc),
            lambda: SS.scatter_rate_write_plain(ji, y, bc),
            "zeros + index_add_",
            lambda: torch.zeros((bc, w), device=dev).index_add_(0, ji, y),
            n * 4 * (1 + w) + bc * w * 4, n * w, per_rows, 0.0)
        got = SS.scatter_rate_read(ji, y)
        err = check(got, SS.scatter_rate_read_plain(ji, y), False,
                    f"scatter_rate_read {tag} w={w}")
        if not torch.equal(got, SS.scatter_rate_read(ji, y)):
            raise AssertionError(f"scatter_rate_read {tag} w={w}: two calls "
                                 "differ")
        bag = ji.long()[None]
        n_read = int(torch.unique(ji).numel())
        rrec = rate_line(
            f"rate read {tag} w={w} (grid {SS.rate_read_slices(n)[1]} x "
            f"{SS.RATE_THREADS})",
            lambda: SS.scatter_rate_read(ji, y),
            lambda: SS.scatter_rate_read_plain(ji, y),
            "embedding_bag", lambda: F.embedding_bag(bag, y, mode="sum"),
            n * 4 + n_read * w * 4 + w * 4, n * w, per_rows, err)
        return wrec, rrec, err

    r_ji = torch.from_numpy(np.sort(rng.integers(0, RATE_BC, RATE_CAP))
                            .astype(np.int32)).to(dev)
    for w in ((32,) if essential else (32, 128)):
        y = torch.from_numpy(rng.standard_normal(
            (RATE_CAP, w)).astype(np.float32)).to(dev)
        wrec, rrec, err = rate_pair(f"cap={RATE_CAP}", r_ji, y, RATE_BC,
                                    RATE_CAP)
        record("scatter_rate_write", w, 0.0, **wrec)
        record("scatter_rate_read", w, err, **rrec)
        del y
    s_ji = torch.from_numpy(np.sort(rng.integers(0, rows // 2, rows))
                            .astype(np.int32)).to(dev)
    for w in ((32,) if essential else (32, 128)):
        wrec, rrec, err = rate_pair(f"S={rows}", s_ji, ys[w], rows // 2, rows)
        for name, rec, e in (("scatter_rate_write", wrec, 0.0),
                             ("scatter_rate_read", rrec, err)):
            record(name, w, e)
            rec["bound_ms"] = bound_ms(rec["bytes"], rec["ops"])[0]
            kernels[name].setdefault("row_stage", {})[f"w{w}"] = rec

    # ---- blocked sorted scatter at the card's block size
    for w in (32, 128):
        bc = SS.card_block_cells(w)
        for tag, idx_np, ji in (("unique", idx_u, ju), ("dup", idx_d, jd)):
            starts_np = SS.block_starts(idx_np, cells, bc)
            starts = torch.from_numpy(starts_np).to(dev)
            nb = len(starts_np) - 1

            def kern():
                return SS.blocked_sorted_scatter(ys[w], ji, starts, cells, bc)

            def plain_fn():
                return SS.blocked_sorted_scatter_plain(ys[w], ji, starts,
                                                       cells, bc)
            err = check(kern(), plain_fn(), tag == "unique",
                        f"blocked_sorted_scatter w={w} {tag}")
            ms, plain = turns(f"blocked sorted scatter w={w} bc={bc} {tag}",
                              kern, plain_fn, err, rows)
            if tag == "unique":
                record("blocked_sorted_scatter", w, err, ms=ms,
                       plain_ms=plain, library_ms=library[w],
                       bytes=rows * 4 * (1 + w) + (nb + 1) * 4
                       + nb * bc * w * 4, ops=rows * w)
            else:
                record("blocked_sorted_scatter", w, err)
            del starts
    if floor is not None:   # each kernel's floor, timed as it is timed
        kernels["scatter_rate_write"]["floor_ms"] = floor["graph_ms"]
        kernels["scatter_rate_read"]["floor_ms"] = floor["graph_ms"]
        kernels["blocked_sorted_scatter"]["floor_ms"] = floor["events_ms"]
    return kernels


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--essential", action="store_true",
                    help="only the JAX script's essential lines")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("microbench_scatter: no CUDA device (use --device cpu to "
              "rehearse)", file=sys.stderr)
        return 2
    run(args.device, args.essential)
    return 0


if __name__ == "__main__":
    sys.exit(main())
