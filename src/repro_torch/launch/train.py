"""SCALA training CLI: the reference LM training command line, on the port.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \
        --clients 16 --participation 0.25 --local-iters 2 --seq 512 \
        --server-batch 16 --docs-per-client 8 --rounds 3

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \
        --clients 16 --participation uniform:0.25 --aggregator \
        bias_compensated --optimizer momentum --server-batch 16 \
        [--slot-gather] [--server-optimizer fedadam --server-lr 0.01]

The flags are those of ``repro.launch.train``; argparse fills a
:class:`repro_torch.api.ExperimentSpec` (the same JSON schema) and
:class:`repro_torch.api.Trainer` runs it, printing one loss line per
round in the reference's format. ``--config PATH`` runs a spec JSON --
``repro.launch.train --dump-config`` output runs verbatim -- and
``--dump-config [PATH]`` writes the resolved spec and exits.

Participation as in the reference: a bare ``--participation`` fraction
is host-side subset sampling (``subset``); a scheduler spec (``full`` |
``uniform:FRAC[:SHARDS]`` | ``dirichlet:FRAC[:ALPHA]``) keeps all K
client slots and masks the round's subset in the program (``masked``),
or with ``--slot-gather`` gathers it into a dense axis first
(``sparse``). eq. 3 then splits ``--server-batch`` over all K slots.
``--aggregator`` (fedavg | weighted | bias_compensated[:GAMMA] |
staleness_weighted[:DECAY] | hierarchical:EDGES[:EDGE[:TOP]]),
``--opt-state-policy`` and ``--server-optimizer`` / ``--server-lr``
(FedOpt on the server half) act as there. ``--async`` runs the
asynchronous event runtime (one event a "round": ``--cohort`` arrivals
popped by finish time, ``--delay-spec``, ``--staleness-decay``,
``--mix-rate``, ``--snapshots dense|delta`` with ``--ring-size``,
``--arrival sort|topk``, ``--lr-scale``, ``--opt-paging host``,
``--deadline`` / ``--backoff``), printing ``event N loss_s=... loss_c=...
t=... stale=...`` as the reference's driver does:

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \
        --clients 16 --async --cohort 4 --delay-spec lognormal:1:1.5 \
        --staleness-decay 0.5 --rounds 4

``--faults`` (``drop:P``, ``corrupt:P[:nan|inf|noise[:SCALE]]``,
``stall:P[:FACTOR]``) injects failures and ``--guards`` (``nonfinite``,
``clip:TAU[:BETA]``) screens the updates, a rejection re-running the
round's local phase over the survivors, in the masked, sparse and async
modes (the header names both; ``Trainer.history`` records
``guard_rejected`` per round):

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \
        --clients 16 --participation uniform:0.25 --rounds 3 \
        --faults drop:0.1,corrupt:0.5:nan --guards nonfinite,clip:10

The dispatch knobs act as in the reference: ``--precision bf16`` runs
the local steps in bfloat16 against float32 master params (the LACE
boundary gets a bf16 head), ``--rounds-per-call R`` runs R rounds in one
program call (one host copy of the metrics a chunk; a loss line still
prints per round, with the chunk's seconds divided over it), and
``--no-donate`` keeps the state passed to a round intact (by default a
round overwrites it from its first local step on):

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \
        --clients 16 --participation 0.25 --precision bf16 \
        --rounds-per-call 2 --rounds 4

``--arrival topk:sharded`` exits with build's refusal: the sharded pop
needs a grid of ranks, and this driver builds none, as the reference's
builds no mesh (the multi-device path runs through ``build(spec,
mesh=, batch_specs=)``: ``examples/lace_dp.py``). The port always runs a
round as a
Python loop of steps, so ``--no-scan`` changes nothing and ``--unroll``
has nothing to act on.

Added here: ``--device`` (``cuda`` unless given; no CPU fallback) and
``--init-params PATH``, a ``repro.checkpoint`` params file (client half
merged or stacked over the slots) to start from instead of the port's own
seeded init -- so one spec and one set of params run through both
CLIs.

Checkpoints as in the reference: ``--checkpoint-dir`` saves the params
after every round (servable by :mod:`repro_torch.launch.serve`),
``--state-dir`` the whole run (``Trainer.save``) -- both once a chunk
under ``--rounds-per-call``, at the round the state belongs to -- and
``--resume``
restores the newest complete one from ``--state-dir`` and runs only the
remaining rounds, bit for bit as if never stopped. The FL / SFL
baselines have no split losses to print (the reference's driver cannot
run them either): this driver refuses them and names
:class:`repro_torch.api.Trainer` and ``python -m
repro_torch.benchmarks.run``, which run them.
"""
from __future__ import annotations

import argparse
import sys

from repro_torch import api, checkpoint
from repro_torch.configs import ScalaConfig
from repro_torch.core import engine
from repro_torch.tree import leaves


def spec_from_args(args) -> api.ExperimentSpec:
    """The CLI surface as the declarative experiment spec (the
    reference's resolution, field for field)."""
    try:
        part_frac = float(args.participation)
        scheduler_spec = None
    except ValueError:
        part_frac = 1.0
        scheduler_spec = args.participation
    mode = "subset" if scheduler_spec is None else "masked"
    if args.slot_gather:
        mode = "sparse"
    if args.async_mode:
        mode = "async"
    server_opt = (None if args.server_optimizer == "none"
                  else api.OptimSpec(
                      name=api.OPTIMIZER_ALIASES.get(args.server_optimizer,
                                                     args.server_optimizer),
                      lr=args.server_lr, momentum=args.momentum,
                      weight_decay=args.weight_decay))
    return api.ExperimentSpec(
        arch=args.arch, reduced=args.reduced, method="scala",
        rounds=args.rounds, seed=args.seed,
        scala=ScalaConfig(
            num_clients=args.clients, participation=part_frac,
            local_iters=args.local_iters, server_batch=args.server_batch,
            lr=args.lr, adjust_server=not args.no_adjust,
            adjust_client=not args.no_adjust),
        optim=api.OptimSpec(name=args.optimizer, momentum=args.momentum,
                            weight_decay=args.weight_decay,
                            schedule=args.schedule, warmup=args.warmup),
        fed=api.FedSpec(aggregator=args.aggregator,
                        participation=scheduler_spec,
                        opt_state_policy=args.opt_state_policy,
                        faults=args.faults or None,
                        guards=args.guards or None),
        execution=api.ExecutionSpec(
            mode=mode, backend="lace", delay=args.delay_spec,
            cohort=args.cohort, staleness_decay=args.staleness_decay,
            mix_rate=args.mix_rate, server_optimizer=server_opt,
            unroll=args.unroll, precision=args.precision,
            boundary=args.boundary, rounds_per_call=args.rounds_per_call,
            donate=not args.no_donate, snapshots=args.snapshots,
            ring_size=args.ring_size, lr_scale=args.lr_scale,
            arrival=args.arrival, opt_paging=args.opt_paging,
            deadline=args.deadline, backoff=args.backoff),
        data=api.DataSpec(kind="lm_synthetic", seq=args.seq,
                          docs_per_client=args.docs_per_client))


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="",
                    help="run a spec JSON (from --dump-config of either "
                         "CLI) verbatim; spec-level flags are ignored")
    ap.add_argument("--dump-config", nargs="?", const="-", default=None,
                    metavar="PATH",
                    help="write the resolved ExperimentSpec JSON (stdout "
                         "if no PATH) and exit without training")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (cuda unless given)")
    ap.add_argument("--init-params", default="", metavar="PATH",
                    help="start from a repro.checkpoint params .npz "
                         "instead of the port's seeded init")
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--clients", type=int, default=16)
    ap.add_argument("--participation", default="0.25",
                    help="bare fraction (host-side subset sampling) or "
                         "scheduler spec: full | uniform:FRAC[:SHARDS] | "
                         "dirichlet:FRAC[:ALPHA] (in-program masking)")
    ap.add_argument("--aggregator", default="weighted",
                    help="FL-phase weighting: fedavg | weighted | "
                         "bias_compensated[:GAMMA] | "
                         "staleness_weighted[:DECAY] | "
                         "hierarchical:EDGES[:EDGE[:TOP]]")
    ap.add_argument("--opt-state-policy", default="carry",
                    choices=engine.OPT_STATE_POLICIES,
                    help="client optimizer state at the round boundary")
    ap.add_argument("--slot-gather", action="store_true",
                    help="sparse slots: gather the scheduler's subset into "
                         "a dense axis before the local steps (needs a "
                         "scheduler spec --participation)")
    ap.add_argument("--server-optimizer", default="none",
                    choices=("none", "sgd", "momentum", "adamw", "fedavgm",
                             "fedadam"),
                    help="FedOpt on the server half's round delta")
    ap.add_argument("--server-lr", type=float, default=1.0)
    ap.add_argument("--async", dest="async_mode", action="store_true")
    ap.add_argument("--delay-spec", default="lognormal:1:1")
    ap.add_argument("--cohort", type=int, default=0)
    ap.add_argument("--staleness-decay", type=float, default=0.5)
    ap.add_argument("--mix-rate", type=float, default=1.0)
    ap.add_argument("--snapshots", default="dense", choices=("dense", "delta"))
    ap.add_argument("--ring-size", type=int, default=64)
    ap.add_argument("--lr-scale", default="none", choices=("none", "cohort"))
    ap.add_argument("--arrival", default="sort",
                    choices=("sort", "topk", "topk:sharded"))
    ap.add_argument("--opt-paging", default="none", choices=("none", "host"))
    ap.add_argument("--local-iters", type=int, default=5)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--server-batch", type=int, default=16)
    ap.add_argument("--docs-per-client", type=int, default=32)
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--optimizer", default="sgd",
                    choices=("sgd", "momentum", "adamw"))
    ap.add_argument("--momentum", type=float, default=0.9)
    ap.add_argument("--weight-decay", type=float, default=0.0)
    ap.add_argument("--schedule", default="constant",
                    choices=("constant", "cosine"))
    ap.add_argument("--warmup", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-adjust", action="store_true",
                    help="ablation: plain SFL (no logit adjustments)")
    ap.add_argument("--no-scan", action="store_true")
    ap.add_argument("--unroll", type=int, default=-1)
    ap.add_argument("--precision", default="f32", choices=("f32", "bf16"))
    ap.add_argument("--boundary", default="fused", choices=("dual", "fused"))
    ap.add_argument("--rounds-per-call", type=int, default=1)
    ap.add_argument("--no-donate", action="store_true")
    ap.add_argument("--faults", default="")
    ap.add_argument("--guards", default="")
    ap.add_argument("--deadline", type=float, default=None)
    ap.add_argument("--backoff", type=float, default=2.0)
    ap.add_argument("--checkpoint-dir", default="",
                    help="save params-only checkpoints (servable) after "
                         "every round")
    ap.add_argument("--state-dir", default="",
                    help="save full crash-recovery checkpoints "
                         "(Trainer.save) after every round")
    ap.add_argument("--resume", action="store_true",
                    help="restore the newest complete checkpoint from "
                         "--state-dir and run only the remaining rounds")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    try:
        if args.config:
            with open(args.config) as f:
                spec = api.ExperimentSpec.from_json(f.read())
        else:
            spec = spec_from_args(args)
        spec.validate()
    except (ValueError, NotImplementedError) as e:
        raise SystemExit(str(e))
    if args.dump_config is not None:
        payload = spec.to_json()
        if args.dump_config == "-":
            print(payload)
        else:
            with open(args.dump_config, "w") as f:
                f.write(payload + "\n")
            print(f"wrote {args.dump_config}", file=sys.stderr)
        return spec
    if spec.method not in api.SCALA_METHODS:
        raise SystemExit(
            f"method {spec.method!r} is an FL/SFL baseline, which has no "
            "split losses to report: run it through repro_torch.api."
            "Trainer or python -m repro_torch.benchmarks.run")
    if args.resume and not args.state_dir:
        raise SystemExit("--resume needs --state-dir (the directory "
                         "Trainer.save wrote full-state checkpoints to)")
    if spec.execution.arrival == "topk:sharded":
        # build's own refusal: the sharded pop needs a grid of ranks
        raise SystemExit("arrival 'topk:sharded' pops per client-mesh "
                         "shard; it needs build(spec, mesh=), which this "
                         "driver does not build (examples/lace_dp.py runs "
                         "the multi-device path)")

    cfg = spec.model_config()
    print(f"arch={cfg.name} layers={cfg.num_layers} d={cfg.d_model} "
          f"vocab={cfg.vocab_size}")
    params = None
    if args.init_params:
        from repro_torch import convert

        params = convert.train_params_from_npz(args.init_params, cfg)
    trainer = api.Trainer(spec, device=args.device, params=params)
    meta = trainer.program.metadata
    n_params = sum(a.numel()
                   for a in leaves(trainer.state.inner.params["server"]))
    print(f"server params: {n_params/1e6:.1f}M, "
          f"mode: {meta['mode']} (slots: {meta['slots']}), "
          f"participation: "
          f"{spec.fed.participation or spec.scala.participation}, "
          f"aggregator: {spec.fed.aggregator}, "
          f"opt-state: {spec.fed.opt_state_policy}, "
          f"optimizer: {spec.optim.spec}, schedule: {spec.optim.schedule}, "
          f"device: {meta['device']}")
    if meta["mode"] == "async":
        ex = spec.execution
        extra = (f" deadline={ex.deadline} backoff={ex.backoff}"
                 if ex.deadline else "")
        print(f"async: delay={ex.delay} cohort={meta['cohort']}/"
              f"{meta['slots']} staleness_decay={ex.staleness_decay} "
              f"mix_rate={ex.mix_rate} snapshots={ex.snapshots} "
              f"arrival={ex.arrival} opt_paging={ex.opt_paging}{extra}")
    if spec.fed.faults or spec.fed.guards:
        print(f"faults: {spec.fed.faults} guards: {spec.fed.guards}")

    start = 0
    if args.resume:
        start = trainer.resume(args.state_dir)
        print(f"resumed at round {start} from {args.state_dir}")

    label = "event" if meta["mode"] == "async" else "round"

    def on_round(rnd, metrics, dt):
        extra = ""
        if "t_event" in metrics:
            extra = (f" t={metrics['t_event']:.2f}"
                     f" stale={metrics['staleness_mean']:.2f}")
        print(f"{label} {rnd:3d} loss_s={metrics['loss_server']:.4f} "
              f"loss_c={metrics['loss_client']:.4f}{extra} ({dt:.1f}s)",
              flush=True)
        # the state advances a chunk at a time: save once a chunk, at the
        # round the state belongs to (the chunk's last)
        if rnd != trainer.round - 1:
            return
        if args.checkpoint_dir:
            checkpoint.save(args.checkpoint_dir, rnd,
                            trainer.state.inner.params)
        if args.state_dir:
            trainer.save(args.state_dir)

    trainer.run(spec.rounds - start, on_round=on_round)
    print("done")
    return trainer


if __name__ == "__main__":
    main()
