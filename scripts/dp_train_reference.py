"""The JAX package's data-parallel step at ``tests/test_torch_dp_train.py``'s
size, on the CPU: the reference that test holds the port's gloo worlds
against.  Its compile takes a minute or two, too long for a Tier-1 test,
so its numbers are kept in ``tests/data/dp_train_reference.npz``:

    env -u PYTHONPATH JAX_PLATFORMS=cpu \\
        python scripts/dp_train_reference.py [--out PATH]

The inputs are tests/test_parallel.py's (``CFG``, ``LCFG``,
``make_clouds(2)``, init key 0, step keys ``split(PRNGKey(1), 2)``) with
the solve raised to convergence (``tests/torch_dp_cases.py``).  The file
holds the clouds (``xyz``, ``normal``, ``mask``), the init params
(``p/<flax path>``), ``dp_train_step``'s mean losses (``loss_names``,
``loss_values``) and updated params (``np/...``), the mean of the two
clouds' ``value_and_grad`` gradients (``g/...``), each cloud's draws
(``spatial_<i>``, ``surface_<i>``) and each PCG solve's (iterations,
relative residual) (``stats``).
"""

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]


def main():
    import torch_dp_cases as C
    import test_torch_dp_train as T
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=C.REF)
    args = ap.parse_args()
    t0 = time.perf_counter()
    r = T.jax_reference()
    T.save_reference(args.out, r)
    print(f"wrote {args.out} in {time.perf_counter() - t0:.1f} s: losses "
          f"{r['losses']}, per cloud {r['per_losses']}, solves "
          f"{r['stats']}")


if __name__ == "__main__":
    main()
