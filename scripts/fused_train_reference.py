"""The JAX package's teacher-forced training step at
``tests/test_train.py``'s configuration (UDF off, the solve raised to
``PARITY_ITERS`` iterations), on the CPU, unfused and with
``fused_mode``: the references that ``tests/test_torch_train.py``'s
``parity`` fixture and ``tests/test_torch_fused_train.py`` hold the port
against.  Each takes about a minute of compile here, too long for a
Tier-1 test, so their numbers are kept in
``tests/data/fused_train_reference.npz``:

    env -u PYTHONPATH JAX_PLATFORMS=cpu \\
        python scripts/fused_train_reference.py [--out PATH]

The inputs (the seeded init, the test's sphere batch and draw key) are
``test_torch_train.jax_parity``'s.  Under each prefix (``unfused_``,
``fused_``) the file holds the loss terms (``loss_names``,
``loss_values``), the gradient by flax path (``grad_names``,
``grad_<i>``), the structure logits and the candidate voxels per depth
(``jax_logits_<d>``, ``jax_cand_<d>``), the draws (``sample_spatial``,
``sample_surface``) and each PCG solve's (iterations, relative residual)
(``stats``).
"""

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]


def main():
    import numpy as np
    import pytest
    import test_torch_train as T
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=str(T.REF))
    args = ap.parse_args()
    out = {}
    for prefix, fused in ((T.UNFUSED, False), (T.FUSED, True)):
        t0 = time.perf_counter()
        mp = pytest.MonkeyPatch()
        try:
            r = T.jax_parity(False, mp, fused=fused)
        finally:
            mp.undo()
        T.save_reference(out, prefix, r)
        print(f"{prefix} {time.perf_counter() - t0:.1f} s: losses "
              f"{r['jax_losses']}, solves {r['jax_stats']}")
    np.savez_compressed(args.out, **out)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
