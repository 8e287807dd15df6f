"""SCALA on the multi-device backend ``lace_dp``, one process a rank.

Every rank builds the same ``ExperimentSpec(backend="lace_dp")`` and a
:class:`repro_torch.sharding.Grid` over the process group, then runs it
through ``build(spec, mesh=grid, batch_specs=...)`` -> ``Trainer``: each
rank keeps its client shard (and its slice of every client's rows over
``model``), draws the same host batches as every other rank, and the
step's collectives (the priors' histograms, the two loss sums, one
all_reduce of the server gradient tree, the client gradients over
``model``) run over the grid. Rank 0 prints one ``round N loss_s=...
loss_c=...`` line a round (an ``event`` line in ``--mode async``), the
losses of the whole grid.

    # four ranks on the CPU over gloo, a (data=2, model=2) grid
    PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 4 \\
        examples/lace_dp.py --grid 2,2 --device cpu --reduced
    # one card: a world of one over NCCL
    PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 1 \\
        examples/lace_dp.py --grid 1,1 --device cuda

``--mode`` is ``masked`` (the default), ``sparse`` (each client shard
gathers its own participants: the participation is balanced over the
shards), ``async`` (each shard pops ``cohort / shards`` of its own
finishers) or ``subset``. The same flags with ``--backend lace`` on one
process run the single-program round, for comparison.
"""
from __future__ import annotations

import argparse
import os
import sys

import torch
import torch.distributed as dist

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch import api  # noqa: E402
from repro_torch.configs import ScalaConfig  # noqa: E402
from repro_torch.configs.base import InputShape  # noqa: E402
from repro_torch.launch.input_specs import train_batch_specs  # noqa: E402
from repro_torch.sharding import Grid, tree_specs  # noqa: E402


def build_spec(args) -> api.ExperimentSpec:
    shards = args.grid[0]
    fed = {"masked": api.FedSpec(participation=f"uniform:{args.frac}:"
                                 f"{shards}", aggregator="bias_compensated"),
           "sparse": api.FedSpec(participation=f"uniform:{args.frac}:"
                                 f"{shards}", aggregator="weighted"),
           }.get(args.mode, api.FedSpec())
    ex = api.ExecutionSpec(mode=args.mode, backend=args.backend,
                           boundary=args.boundary,
                           cohort=args.cohort if args.mode == "async" else 0,
                           delay="lognormal:1:1.5")
    return api.ExperimentSpec(
        arch=args.arch, reduced=args.reduced, method="scala",
        rounds=args.rounds, seed=args.seed,
        scala=ScalaConfig(num_clients=args.clients,
                          participation=args.frac,
                          local_iters=args.local_iters,
                          server_batch=args.clients, lr=args.lr),
        fed=fed, execution=ex,
        data=api.DataSpec(kind="lm_synthetic", seq=args.seq,
                          docs_per_client=args.docs_per_client)).validate()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--grid", default="1,1",
                    help="DATA,MODEL: client shards, ranks a client's rows "
                         "split over (their product is the world size)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--mode", default="masked",
                    choices=("subset", "masked", "sparse", "async"))
    ap.add_argument("--backend", default="lace_dp",
                    choices=("lace_dp", "lace"))
    ap.add_argument("--boundary", default="fused", choices=("fused", "dual"))
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--frac", type=float, default=0.5)
    ap.add_argument("--cohort", type=int, default=4)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--local-iters", type=int, default=2)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--docs-per-client", type=int, default=4)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    args.grid = tuple(int(x) for x in args.grid.split(","))

    on_card = torch.device(args.device).type == "cuda"
    if on_card:
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0))
                              % torch.cuda.device_count())
    else:
        torch.set_num_threads(1)
    dist.init_process_group("nccl" if on_card else "gloo")
    try:
        spec = build_spec(args)
        kw = {}
        if args.backend == "lace_dp":
            grid = Grid(("data", "model"), args.grid)
            C = spec.slots
            shapes, axes = train_batch_specs(spec.model_config(), InputShape(
                "run", spec.data.seq, C, "train"), C)
            kw = dict(mesh=grid, batch_specs=tree_specs(axes, shapes, grid))
        trainer = api.Trainer(spec, device=args.device, **kw)
        for r, m in enumerate(trainer.run()):
            if dist.get_rank() == 0:
                kind = "event" if args.mode == "async" else "round"
                print(f"{kind} {r} loss_s={m['loss_server']:.4f} "
                      f"loss_c={m['loss_client']:.4f}", flush=True)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
