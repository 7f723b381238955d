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
kernels become the hand kernels of ``ops/sorted_scatter.py``: the
one-CTA rate kernels (cap 16384 rows into 8192 cells) and the blocked
sorted scatter at the card's block size, on ``idx_u`` and on ``idx_d``.

Each line is the mean of REPS calls timed with CUDA events after one
warm-up call (on ``--device cpu``, the host clock: a rehearsal, no device
metric), in ms and ns per row.  Each hand kernel's result is held against
its plain version first, and a mismatch raises: exact for unique indices;
rtol 1e-5 and atol 1e-5 of the largest output where rows share a cell
(f32 sums in another order).  ``--essential`` keeps the lines the JAX
script's ``NKSR_BENCH_ESSENTIAL=1`` keeps, plus the duplicate-index
blocked scatter.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Callable, Dict

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import sorted_scatter as SS

S = 1 << 19          # slot rows
C0 = 5326848         # dense depth-0 cells at bench scale
REPS = 8
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
    over every check and, at w = 32 with unique indices, its ms, plain
    ms, library ms and the bytes and f32 operations of one call."""
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

    def turns(label, kernel_fn, plain_fn, err, per_rows):
        """plain, kernel, kernel, plain: the faster of each pair."""
        p1 = time_ms(plain_fn, device)
        k1 = time_ms(kernel_fn, device)
        k2 = time_ms(kernel_fn, device)
        p2 = time_ms(plain_fn, device)
        ms, plain = min(k1, k2), min(p1, p2)
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

    # ---- one-CTA rate kernels (cap rows into bc cells, idx sorted)
    r_idx = np.sort(rng.integers(0, RATE_BC, RATE_CAP)).astype(np.int32)
    r_ji = torch.from_numpy(r_idx).to(dev)
    n_read = len(np.unique(r_idx))
    for w in ((32,) if essential else (32, 128)):
        y = torch.from_numpy(rng.standard_normal(
            (RATE_CAP, w)).astype(np.float32)).to(dev)
        err = check(SS.scatter_rate_write(r_ji, y, RATE_BC),
                    SS.scatter_rate_write_plain(r_ji, y, RATE_BC), False,
                    f"scatter_rate_write w={w}")
        ms, plain = turns(
            f"rate write cap={RATE_CAP} bc={RATE_BC} w={w} (1 CTA)",
            lambda: SS.scatter_rate_write(r_ji, y, RATE_BC),
            lambda: SS.scatter_rate_write_plain(r_ji, y, RATE_BC), err,
            RATE_CAP)
        record("scatter_rate_write", w, err, ms=ms, plain_ms=plain,
               library_ms=time_ms(lambda: torch.zeros(
                   (RATE_BC, w), device=dev).index_add_(0, r_ji, y), device),
               bytes=RATE_CAP * 4 * (1 + w) + RATE_BC * w * 4,
               ops=RATE_CAP * w)
        err = check(SS.scatter_rate_read(r_ji, y),
                    SS.scatter_rate_read_plain(r_ji, y), False,
                    f"scatter_rate_read w={w}")
        ms, plain = turns(f"rate read cap={RATE_CAP} w={w} (1 CTA)",
                          lambda: SS.scatter_rate_read(r_ji, y),
                          lambda: SS.scatter_rate_read_plain(r_ji, y), err,
                          RATE_CAP)
        bag = r_ji.long()[None]
        record("scatter_rate_read", w, err, ms=ms, plain_ms=plain,
               library_ms=time_ms(lambda: F.embedding_bag(bag, y,
                                                          mode="sum"),
                                  device),
               bytes=RATE_CAP * 4 + n_read * w * 4 + w * 4,
               ops=RATE_CAP * w)
        del y

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
