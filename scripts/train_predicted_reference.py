"""The JAX package's predicted-structure training step at
``tests/test_torch_train_predicted.py``'s size, on the CPU: the reference
that test's ``parity`` fixture holds the port against.  Its compile takes
about two minutes here, too long for a Tier-1 test, so its numbers are
kept in ``tests/data/train_predicted_reference.npz``:

    env -u PYTHONPATH JAX_PLATFORMS=cpu \\
        python scripts/train_predicted_reference.py [--out PATH]

The inputs (runs/synth_r3c/best.ckpt under its config.yaml at the test's
voxel size, capacities and solver settings, the test's sphere batch and
draw key) are the test module's (``jax_reference``).  The file holds the
loss terms (``loss_names``, ``loss_values``), the gradient by flax path
(``grad_names``, ``grad_<i>``), the structure logits and the candidate
and decoder voxels per depth (``jax_logits_<d>``, ``jax_cand_<d>``,
``jax_dec_<d>``), the draws (``spatial``, ``surface``) and each PCG
solve's (iterations, relative residual) (``stats``).
"""

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]


def main():
    import test_torch_train_predicted as T
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=str(T.REF))
    args = ap.parse_args()
    t0 = time.perf_counter()
    r = T.jax_reference()
    T.save_reference(args.out, r)
    print(f"wrote {args.out} in {time.perf_counter() - t0:.1f} s: losses "
          f"{r['jax_losses']}, solves {r['jax_stats']}, candidates "
          f"{[len(c) for c in r['jax_cand']]}, decoder "
          f"{[len(c) for c in r['jax_dec']]}")


if __name__ == "__main__":
    main()
