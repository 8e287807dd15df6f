"""One rank of ``tests/test_torch_dryrun.py``'s gloo check:

    python tests/torch_dryrun_worker.py RANK WORLD INIT_URL OUT

Runs the ``lace_dp`` local step of reduced qwen1.5-0.5b on a ``(data=2,
model=1)`` grid over gloo on CPU tensors (the dry run's step, its
arguments drawn by ``realize``) and writes rank 0's ``Grid.stats`` to
``OUT``. Imports torch and the port, never JAX.
"""
from __future__ import annotations

import os
import sys
import warnings

import torch
import torch.distributed as dist

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import InputShape  # noqa: E402
from repro_torch.launch.dryrun import build_step, realize  # noqa: E402
from repro_torch.sharding import Grid  # noqa: E402


def main():
    rank, world, init, out = sys.argv[1:]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=int(rank),
                            world_size=int(world))
    try:
        grid = Grid(("data", "model"), (2, 1))
        cfg = get_config("qwen1.5-0.5b").reduced()
        step, args, _, cfg = build_step(
            "qwen1.5-0.5b", "t", grid, cfg=cfg,
            shape=InputShape("t", 16, 2, "train"), num_clients=2)
        args = realize(args, cfg.vocab_size, seed=int(rank))
        grid.reset_stats()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            step(*args)
        if int(rank) == 0:
            torch.save(grid.stats, out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
