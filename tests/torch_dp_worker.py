"""One rank of a gloo world of ``tests/test_torch_dp_train.py``: the
port's data-parallel step on CPU tensors, its numbers saved for the test
to check.

    python tests/torch_dp_worker.py RANK WORLD STORE OUT

``STORE``: the world's ``FileStore`` file; ``OUT``: where the rank writes
``rank{RANK}.npz`` (and, in a world of two, ``fit_rank{RANK}/``, the
run directory of its ``fit``).  The global batch is the reference
file's two clouds, ``2 // WORLD`` a rank.  Imports the port, never JAX;
``tests/data/dp_train_reference.npz`` holds the JAX package's side.
"""

import datetime
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), HERE]

import torch_dp_cases as C  # noqa: E402
from nksr_tpu_torch import parallel as PP  # noqa: E402
from nksr_tpu_torch.models import pipeline as P  # noqa: E402
from nksr_tpu_torch.parallel import data_parallel as DP  # noqa: E402
from nksr_tpu_torch.train import driver  # noqa: E402
from nksr_tpu_torch.train import loop as T  # noqa: E402
from nksr_tpu_torch.train import losses as L  # noqa: E402
from nksr_tpu_torch.utils.checkpoint import (params_to_torch,  # noqa: E402
                                             torch_to_params)


def flax_flat(named) -> dict:
    """Torch-named tensors by flax path."""
    return dict(C.flatten({"params": torch_to_params(
        {n: t.detach().clone() for n, t in named.items()})}))


def steps(rank, world, ref, out):
    """``C.STEPS`` data-parallel steps from the JAX params: the first on
    the JAX draws, the rest on generators seeded by step and global
    cloud index.  Rank r > 0 starts from another init, which
    ``replicate`` must overwrite."""
    cfg = P.PipelineConfig(**C.CFG_KW)
    lcfg = C.loss_config(L)
    tc = T.TrainConfig()
    mesh = PP.make_mesh("cpu")
    jax_params = C.unflatten({k[2:]: ref[k] for k in ref.files
                              if k.startswith("p/")})
    state = T.init_state(cfg, tc, params=jax_params if rank == 0
                         else P.init_params(cfg, 1), device="cpu")
    state = PP.replicate(mesh, state)
    want = params_to_torch(jax_params)
    out["replicated"] = np.array(all(
        torch.equal(p, torch.as_tensor(want[n]))
        for n, p in state.net.named_parameters()))
    full = PP.stack_samples([C.batch(ref, i) for i in range(C.N_CLOUDS)])
    local = PP.shard_batch(mesh, full)
    n_local = C.N_CLOUDS // world
    first = rank * n_local
    for s in range(C.STEPS):
        if s == 0:
            samples = [{"spatial": torch.as_tensor(ref[f"spatial_{g}"]),
                        "surface": torch.as_tensor(ref[f"surface_{g}"])
                        .long()} for g in range(first, first + n_local)]
            gens = None
        else:
            samples = None
            gens = [torch.Generator().manual_seed(DP.sample_seed(
                0, s, g, C.N_CLOUDS)) for g in range(first, first + n_local)]
        state, losses = PP.dp_train_step(cfg, tc, lcfg, state, local, gens,
                                         mesh, samples=samples)
        named = dict(state.net.named_parameters())
        for k, v in flax_flat({n: p.grad for n, p in named.items()}).items():
            out[f"s{s}/grad/{k}"] = v
        for k, v in flax_flat(named).items():
            out[f"s{s}/param/{k}"] = v
        out[f"s{s}/loss_names"] = np.array(list(losses))
        out[f"s{s}/loss_values"] = np.array(list(losses.values()))
    out["local_clouds"] = np.array([len(local["xyz"])])


def fit_checks(rank, world, ref, tmp, out):
    """``fit(batch_size=3)`` raises on every rank; ``fit(batch_size=2)``
    for 3 steps with one validation, each rank with its own run
    directory: only rank 0's may exist."""
    cfg = C.fit_config()
    mine = [C.batch(ref, rank)] * 3
    val = [C.batch(ref, 0)]
    try:
        driver.fit(cfg, mine, val, os.path.join(tmp, f"bad_rank{rank}"),
                   max_steps=3, batch_size=3, device="cpu")
        out["bad_batch_raised"] = np.array("")
    except ValueError as e:
        out["bad_batch_raised"] = np.array(str(e))
    st = driver.fit(cfg, mine, val, os.path.join(tmp, f"fit_rank{rank}"),
                    max_steps=3, val_every=3, batch_size=2, device="cpu")
    out["fit_step"] = np.array([st.step])
    for k, v in flax_flat(dict(st.net.named_parameters())).items():
        out[f"fit/param/{k}"] = v


def main():
    rank, world, store, tmp = (int(sys.argv[1]), int(sys.argv[2]),
                               sys.argv[3], sys.argv[4])
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    ref = np.load(C.REF)
    out = {}
    steps(rank, world, ref, out)
    if world > 1:
        fit_checks(rank, world, ref, tmp, out)
    np.savez(os.path.join(tmp, f"rank{rank}.npz"), **out)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
