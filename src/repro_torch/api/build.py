"""``build(spec)`` -- an :class:`ExperimentSpec` into a round program.

The port runs the SCALA program of ``repro.api.build._build_scala`` in
the ``subset``, ``masked`` and ``sparse`` modes and the ``async`` event
runtime, for a text arch (the transformer) or the CNN family (AlexNet at
``spec.width``, split at ``spec.split``), and the FL / SFL baselines of
``_build_fl`` / ``_build_sfl`` on AlexNet: ``init()`` builds the program
state, ``step(state, batches, sizes)`` runs one round (T local steps and
the FL phase) or one async event, and ``predict(state, batch)`` the
current global model (SCALA and SFL: slot 0's client half and the server
half; FL: the full model). The dispatch knobs of
:class:`~repro_torch.api.specs.ExecutionSpec` act as the reference's:

* ``rounds_per_call = R > 1``: ``step(state, batches, sizes)`` runs R
  whole rounds (or async events) in one call (:func:`fuse_rounds`):
  ``batches`` / ``sizes`` leaves gain a leading (R,) axis, R is read
  from the shapes (the remainder chunk is the same code), and the
  metrics come back stacked (R, ...) where they were made, the device's
  on the device. The rounds are the unfused step, one after the other,
  so a chunk equals R calls of it bit for bit.
* ``donate`` (the default): the ``state`` passed to ``step`` is dead
  after the call -- keep only the one it returns. The synchronous round
  then overwrites its input from its first local step on (the server
  half and the dense optimizer moments in place,
  :func:`repro_torch.core.engine.make_round_runner`), and the async
  event writes its cohort's rows into its own stacks; every ``init()``
  hands out storage of its own (:func:`fresh`), so two states of one
  program share none. ``donate=False`` leaves the passed state bitwise
  intact.
* ``precision``: the compute policy
  (:func:`repro_torch.core.engine.cast_to_compute`,
  :func:`repro_torch.core.baselines.cast_fed_model`); ``predict`` always
  runs the float32 master params.

A round that threads federation state (a
participation scheduler, a stateful aggregator, a server optimizer, a
fault model, a clipping guard) keeps it in ``ProgramState.fed``
(:func:`repro_torch.fed.init_fed_state`, seeded by :func:`fed_seed`: the
fault stream shares the seed under its own tag); an async program keeps its
:class:`repro_torch.fed.AsyncFedState` there (its delay stream seeded by
:func:`fed_seed`). Under ``snapshots="delta"`` the client half is held
over one slot; with ``opt_paging="host"`` the step is two-phase on the
host: page the arrivals' moments in (:class:`repro_torch.fed.
HostOptPager`), run the event, page them out.

Params are the port's own init, drawn from ``torch.Generator(device)``
seeded with ``spec.seed`` -- the JAX init's numbers cannot be drawn here
-- or given: ``build(spec, params=...)`` starts from exactly the
reference's. For SCALA that is the training layout of
:func:`repro_torch.convert.train_params_from_reference`; for an FL
method the merged AlexNet tree, for an SFL method ``{'wc', 'ws'}`` (and
``'aux'`` for sfl_localloss) -- see
:func:`repro_torch.convert.baseline_state_from_reference`.

As in the reference, the baselines get no local optimizer (plain SGD
whatever ``spec.optim`` says, at ``spec.optim.resolve_lr(spec.scala.lr)``;
an FL method takes ``execution.server_optimizer``, FedAvgM / FedAdam), the
``weighted`` aggregator is the data-size FedAvg, and their rounds take
client-major (C, T, ...) batches: the step transposes the Trainer's
(T, C, ...) ones (axes 1 and 2 of a fused chunk's).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, Dict

import numpy as np
import torch

from repro_torch.api.specs import ExperimentSpec
from repro_torch.models.common import resolve_device
from repro_torch.tree import leaves, tree_map


@dataclass(frozen=True)
class ProgramState:
    """``inner``: the engine :class:`TrainState` (a baseline's state);
    ``fed``: the federation carry (``()`` when the round threads none)."""

    inner: Any
    fed: Any = ()


@dataclass(frozen=True)
class RoundProgram:
    spec: ExperimentSpec
    model: Any
    init: Callable[[], ProgramState]
    step: Callable[..., Any]
    predict: Callable[..., Any]
    metadata: Dict[str, Any]


def fresh(tree):
    """Every tensor leaf of ``tree`` copied into storage of its own; a
    client half broadcast over its slots (stride 0 on the slot axis) stays
    a broadcast of one copied slot, not C materialized ones."""

    def copy(a):
        if not isinstance(a, torch.Tensor):
            return a
        if a.dim() > 0 and a.shape[0] > 1 and a.stride(0) == 0:
            return a[0].clone()[None].expand(a.shape)
        return a.clone()

    return tree_map(copy, tree)


def fuse_rounds(step):
    """The reference's ``_fuse_rounds`` on the port: ``fused(state,
    batches, sizes)`` runs ``step`` once per entry of the leading (R,)
    axis of ``batches`` (and of ``sizes``), threading the state, and
    returns the last state and the R rounds' metrics, each stacked on a
    leading (R,) axis where it was made: device tensors on their device,
    host values (the async schedule's numpy, a guard's float) with
    ``np.stack``. An eager program has no trace to unroll or scan: the
    chunk is the unfused rounds one after another, bit for bit."""

    def fused(state, batches, sizes):
        R = leaves(batches)[0].shape[0]
        per_round = []
        for r in range(R):
            state, m = step(state, {k: v[r] for k, v in batches.items()},
                            None if sizes is None else sizes[r])
            per_round.append(m)
        return state, {k: (torch.stack([m[k] for m in per_round])
                           if isinstance(v, torch.Tensor) else
                           np.stack([np.asarray(m[k]) for m in per_round]))
                       for k, v in per_round[0].items()}

    return fused


def _dispatch(program: "RoundProgram") -> "RoundProgram":
    """The dispatch knobs on a built program: R rounds a call, the
    baselines' transpose, and the metadata the reference's ``build`` adds
    (each builder's ``init()`` copies its params under ``donate``)."""
    ex = program.spec.execution
    step = program.step
    if ex.rounds_per_call > 1:
        step = fuse_rounds(step)
    if program.metadata.get("client_major"):
        # the baselines' rounds take client-major (C, T, ...) batches: one
        # transpose per call, of the whole chunk's (R, T, C, ...) ones
        inner = step
        a0, a1 = (1, 2) if ex.rounds_per_call > 1 else (0, 1)

        def step(state, batches, sizes):
            return inner(state, {k: v.transpose(a0, a1)
                                 for k, v in batches.items()}, sizes)
    metadata = dict(program.metadata, precision=ex.precision,
                    rounds_per_call=ex.rounds_per_call, donate=ex.donate)
    return dataclasses.replace(program, step=step, metadata=metadata)


def text_split_init(spec: ExperimentSpec, slots: int, device):
    """The transformer split model and its stacked params from the port's
    init: one full init drawn from a generator seeded with ``spec.seed``,
    its client half repeated over ``slots``."""
    from repro_torch.core import engine
    from repro_torch.core.scala import transformer_split_model
    from repro_torch.models import transformer as T

    cfg = spec.model_config()
    gen = torch.Generator(device)
    gen.manual_seed(spec.seed)
    full = T.init_params(gen, cfg)
    params = engine.init_scala_params(gen, lambda g: full["client"],
                                      lambda g: full["server"], slots)
    return transformer_split_model(cfg), params


def _cnn_split_init(spec: ExperimentSpec, slots: int, device):
    """AlexNet's split model and its stacked params from the port's init
    on a generator seeded with ``spec.seed``."""
    from repro_torch.core.split import stack_client_params
    from repro_torch.models import alexnet as A

    gen = torch.Generator(device)
    gen.manual_seed(spec.seed)
    full = A.init_params(gen, num_classes=spec.data.num_classes,
                         width=spec.width)
    wc, ws = A.split_params(full, spec.split)
    return _split_model(spec), {"client": stack_client_params(wc, slots),
                                "server": ws}


def _split_model(spec: ExperimentSpec):
    from repro_torch.core.scala import (alexnet_split_model,
                                        transformer_split_model)

    cfg = spec.model_config()
    if cfg.family == "cnn":
        return alexnet_split_model(spec.split,
                                   num_classes=spec.data.num_classes)
    return transformer_split_model(cfg)


def _check_params(params, spec: ExperimentSpec, slots: int, device):
    """Given params on ``device``, their client half stacked over
    ``slots`` (a merged client half is repeated, a half stacked over one
    slot too; a delta async program asks one slot)."""
    from repro_torch.core.split import stack_client_params

    cfg = spec.model_config()
    if cfg.family == "cnn":
        probe, shape = params["client"]["convs"][0]["w"], None
        merged = probe.dim() == 4
    else:
        probe = params["client"]["embed"]["tok"]
        shape = (cfg.vocab_size, cfg.d_model)
        merged = tuple(probe.shape) == shape
    if merged:
        params = dict(params, client=stack_client_params(params["client"],
                                                         slots))
    elif probe.shape[0] == 1 and slots != 1:
        params = dict(params, client=stack_client_params(tree_map(
            lambda a: a[0], params["client"]), slots))
    elif probe.shape[0] not in (slots, 1) or (
            shape is not None and tuple(probe.shape[1:]) != shape):
        raise ValueError(f"client half's first leaf has shape "
                         f"{tuple(probe.shape)}; expected it merged or "
                         f"stacked over {slots} slots of {cfg.name}")
    return tree_map(lambda a: a.to(device), params)


def fed_seed(spec: ExperimentSpec) -> int:
    """The participation scheduler's stream seed. The reference keys its
    scheduler with ``fold_in(PRNGKey(seed), 11)`` for ``image_synthetic``
    and ``PRNGKey(seed + 1)`` for ``lm_synthetic`` (``api/build.py:
    _fed_key``), apart from the streams of the data and the init; the
    port keeps the two tags and hashes them with ``spec.seed``:
    ``SeedSequence([seed, 11 or 1]).generate_state(1)[0]``, so its draws
    (``default_rng([fed_seed, round])``) share no seed with the host's
    data streams (``seed``, ``seed + 1``, ``seed + 7``)."""
    import numpy as np

    tag = 11 if spec.data.kind == "image_synthetic" else 1
    return int(np.random.SeedSequence([spec.seed, tag]).generate_state(1)[0])


def build(spec: ExperimentSpec, *, device="cuda", params=None, mesh=None,
          batch_specs=None) -> RoundProgram:
    """Validate ``spec`` and build its program on ``device``.

    ``mesh`` (a :class:`repro_torch.sharding.Grid`) and ``batch_specs``
    (a spec per batch key, :func:`repro_torch.launch.input_specs.
    train_batch_specs` through :func:`repro_torch.sharding.tree_specs`)
    are required for ``backend="lace_dp"``, ``mesh`` for
    ``arrival="topk:sharded"``. Under ``lace_dp`` the program's state is
    this rank's (the client slots of its shard; the server half
    replicated) and ``step`` takes the global batches every rank draws
    alike."""
    from repro_torch import fed
    from repro_torch.core import engine
    from repro_torch.core.baselines import FL_METHODS, SFL_METHODS

    spec.validate()
    ex = spec.execution
    if ex.backend == "lace_dp" and (mesh is None or batch_specs is None):
        raise ValueError("backend 'lace_dp' needs build(spec, mesh=, "
                         "batch_specs=)")
    if ex.arrival == "topk:sharded" and mesh is None:
        raise ValueError("arrival 'topk:sharded' pops per client-mesh "
                         "shard; it needs build(spec, mesh=)")
    device = resolve_device(device)
    if spec.method in FL_METHODS + SFL_METHODS:
        return _build_baseline(spec, device, params)
    ex, fd, sc = spec.execution, spec.fed, spec.scala
    if spec.method == "scala_noadj":
        sc = dataclasses.replace(sc, adjust_server=False, adjust_client=False)
    slots = spec.slots
    # delta snapshots hold the global client half over ONE param slot (the
    # ring replaces the per-client stack); the client count stays slots
    delta = ex.mode == "async" and ex.snapshots == "delta"
    param_slots = 1 if delta else slots
    opt = spec.optim.make()
    sched = spec.optim.make_schedule(spec.rounds * sc.local_iters,
                                     default_lr=sc.lr)
    agg = fd.make_aggregator()
    scheduler = (fd.make_participation(slots)
                 if ex.mode in ("masked", "sparse") else None)
    server_opt, server_lr = _server_optimizer(spec)
    faults, guards = fd.make_faults(), fd.make_guards()
    if params is None:
        init = (_cnn_split_init if spec.model_config().family == "cnn"
                else text_split_init)
        model, params = init(spec, param_slots, device)
    else:
        model = _split_model(spec)
        params = _check_params(params, spec, param_slots, device)
    dp = ex.backend == "lace_dp"
    if dp and param_slots > 1:
        # the rank keeps its client shard's slots
        params = {"client": mesh.local_clients(params["client"]),
                  "server": params["server"]}
    if ex.mode == "async":
        return _build_async(spec, sc, device, model, params, opt, sched,
                            agg, server_opt, server_lr, faults, guards,
                            mesh, batch_specs)
    round_fn = engine.make_round_runner(
        model, sc, backend=ex.backend, boundary=ex.boundary, optimizer=opt,
        schedule=sched, aggregator=agg, participation=scheduler,
        opt_state_policy=fd.opt_state_policy,
        slot_gather=ex.mode == "sparse", server_optimizer=server_opt,
        server_lr=server_lr, precision=ex.precision, faults=faults,
        guards=guards, donate=ex.donate, mesh=mesh if dp else None,
        batch_specs=batch_specs if dp else None)
    thread_fed = (scheduler is not None or agg.stateful
                  or server_opt is not None or faults is not None
                  or (guards is not None and guards.stateful))

    def init() -> ProgramState:
        p = fresh(params) if ex.donate else params
        fed_state = (fed.init_fed_state(
            fed_seed(spec), agg, scheduler, num_clients=slots,
            server_optimizer=server_opt, server_params=p["server"],
            faults=faults, guards=guards, device=device)
            if thread_fed else ())
        return ProgramState(inner=engine.init_train_state(p, opt),
                            fed=fed_state)

    def step(state: ProgramState, batches, sizes):
        if thread_fed:
            inner, fed_state, metrics = round_fn(state.inner, batches, sizes,
                                                 state.fed)
            return ProgramState(inner=inner, fed=fed_state), metrics
        inner, metrics = round_fn(state.inner, batches, sizes)
        return ProgramState(inner=inner, fed=state.fed), metrics

    return _dispatch(RoundProgram(
        spec=spec, model=model, init=init, step=step,
        predict=_scala_predict(model),
        metadata=dict(method=spec.method, mode=ex.mode, slots=slots,
                      backend=ex.backend, boundary=ex.boundary,
                      thread_fed=thread_fed, device=str(device),
                      mesh=mesh)))


def _scala_predict(model):
    """The global model: slot 0's client half and the server half."""

    @torch.no_grad()
    def predict(state: ProgramState, batch):
        wc0 = tree_map(lambda a: a[0], state.inner.params["client"])
        acts = model.client_fwd(wc0, batch)
        logits, _ = model.server_fwd(state.inner.params["server"], acts)
        return logits

    return predict


def _build_async(spec: ExperimentSpec, sc, device, model, params, opt,
                 sched, agg, server_opt, server_lr, faults, guards, mesh,
                 batch_specs) -> RoundProgram:
    """The async branch of ``repro.api.build._build_scala``: one event per
    ``step``."""
    from repro_torch import fed
    from repro_torch.core import engine

    ex, slots = spec.execution, spec.slots
    delays = ex.make_delays()
    cohort = ex.resolve_cohort(slots)
    paged = ex.opt_paging == "host"
    event = fed.make_async_runner(
        model, sc, backend=ex.backend, boundary=ex.boundary, optimizer=opt,
        schedule=sched, delays=delays, cohort=cohort,
        staleness_decay=ex.staleness_decay, mix_rate=ex.mix_rate,
        aggregator=agg, server_optimizer=server_opt, server_lr=server_lr,
        opt_state_policy=spec.fed.opt_state_policy, precision=ex.precision,
        snapshots=ex.snapshots, ring_size=ex.ring_size,
        lr_scale=ex.lr_scale, num_clients=slots, arrival=ex.arrival,
        paged_opt=paged, deadline=ex.deadline, backoff=ex.backoff,
        donate=ex.donate, faults=faults, guards=guards, mesh=mesh,
        batch_specs=batch_specs)
    pager = (fed.HostOptPager(opt, tree_map(lambda a: a[0],
                                            params["client"]), slots)
             if paged else None)
    # the schedule is laid out over the client shards for the per-shard
    # event and the sharded pop
    sched_mesh = (mesh if ex.backend == "lace_dp"
                  or ex.arrival == "topk:sharded" else None)
    pop = fed.make_arrival_pop(cohort, ex.arrival, mesh=sched_mesh)

    def init() -> ProgramState:
        # the snapshots and the ring are copies of their own already
        p = fresh(params) if ex.donate else params
        afed = fed.init_async_state(
            fed_seed(spec), p["client"], delays, aggregator=agg,
            server_optimizer=server_opt, server_params=p["server"],
            snapshots=ex.snapshots, ring_size=ex.ring_size,
            num_clients=slots, guards=guards, mesh=sched_mesh)
        if pager is not None:
            pager.reset()
        return ProgramState(inner=engine.init_train_state(p, opt),
                            fed=afed)

    def step(state: ProgramState, batches, sizes):
        if pager is None:
            inner, afed, metrics = event(state.inner, state.fed, batches,
                                         sizes)
            return ProgramState(inner=inner, fed=afed), metrics
        # the pop is a host function of the host schedule: the rows paged
        # are the event's own arrivals
        idx = pop(state.fed.finish_time, state.fed.version)[0]
        inner, afed, metrics, new_co = event(
            state.inner, state.fed, batches, sizes,
            pager.gather(idx, device))
        pager.scatter(idx, new_co)
        return ProgramState(inner=inner, fed=afed), metrics

    return _dispatch(RoundProgram(
        spec=spec, model=model, init=init, step=step,
        predict=_scala_predict(model),
        metadata=dict(method=spec.method, mode="async", slots=slots,
                      backend=ex.backend, boundary=ex.boundary,
                      thread_fed=True, device=str(device), cohort=cohort,
                      host_paged=paged, pager=pager, mesh=mesh)))


def _server_optimizer(spec: ExperimentSpec):
    """(the server optimizer or None, its lr)."""
    so = spec.execution.server_optimizer
    return (None, 1.0) if so is None else (so.make(), so.lr)


def _merged_conv(tree) -> bool:
    return tree["convs"][0]["w"].dim() == 4


def _baseline_params(spec: ExperimentSpec, device, params):
    """The FL weights, or the SFL ``{'wc', 'ws'[, 'aux']}``: the port's
    seeded init, or ``params`` on ``device`` (a merged client half or
    aux head repeated over the slots)."""
    from repro_torch.core.baselines import FL_METHODS
    from repro_torch.core.split import stack_client_params
    from repro_torch.models import alexnet as A

    slots, N = spec.slots, spec.data.num_classes
    fl = spec.method in FL_METHODS
    if params is None:
        gen = torch.Generator(device)
        gen.manual_seed(spec.seed)
        full = A.init_params(gen, num_classes=N, width=spec.width)
        if fl:
            return full
        wc, ws = A.split_params(full, spec.split)
        state = {"wc": stack_client_params(wc, slots), "ws": ws}
        if spec.method == "sfl_localloss":
            probe = A.client_forward_from_split(
                wc, torch.zeros((1, 32, 32, 3), device=device), spec.split)
            w = torch.randn((probe[0].numel(), N), generator=gen,
                            device=device) * 0.05
            state["aux"] = stack_client_params({"w": w}, slots)
        return state
    want = ({"convs", "fcs", "head"} if fl else {"wc", "ws"} | (
        {"aux"} if spec.method == "sfl_localloss" else set()))
    if set(params) != want:
        raise ValueError(f"{spec.method} params have keys {sorted(params)}; "
                         f"expected {sorted(want)}")
    params = tree_map(lambda a: a.to(device), params)
    if fl:
        if not _merged_conv(params):
            raise ValueError("FL params are the merged model; its first "
                             "conv weight must be (O, I, H, W)")
        return params
    if _merged_conv(params["wc"]):
        params = dict(params, wc=stack_client_params(params["wc"], slots))
    if "aux" in params and params["aux"]["w"].dim() == 2:
        params = dict(params, aux=stack_client_params(params["aux"], slots))
    for key in ("wc",) + (("aux",) if "aux" in params else ()):
        n = leaves(params[key])[0].shape[0]
        if n != slots:
            raise ValueError(f"{key} is stacked over {n} slots; expected "
                             f"{slots}")
    return params


def _build_baseline(spec: ExperimentSpec, device, params) -> RoundProgram:
    """``repro.api.build._build_fl`` / ``_build_sfl`` on the port."""
    from repro_torch.core import baselines as B
    from repro_torch.core.scala import alexnet_split_model
    from repro_torch.models import alexnet as A

    slots = spec.slots
    fd = spec.fed
    agg = fd.make_aggregator() if fd.aggregator != "weighted" else None
    lr = spec.optim.resolve_lr(spec.scala.lr)
    precision, donate = spec.execution.precision, spec.execution.donate
    state0 = _baseline_params(spec, device, params)
    if spec.method in B.FL_METHODS:
        model = B.FedModel(forward=lambda p, x: A.forward(p, x, spec.split),
                           num_classes=spec.data.num_classes,
                           features=A.features)
        server_opt, server_lr = _server_optimizer(spec)
        round_fn = B.make_fl_round(spec.method, model, lr=lr, aggregator=agg,
                                   server_optimizer=server_opt,
                                   server_lr=server_lr, precision=precision)

        def init() -> ProgramState:
            w = fresh(state0) if donate else state0
            return ProgramState(inner=w, fed=B.init_fl_state(
                spec.method, w, slots, server_optimizer=server_opt))

        def round_step(state: ProgramState, batches, sizes):
            w, fl_state = round_fn(state.inner, batches, sizes, state.fed)
            return ProgramState(inner=w, fed=fl_state), {}

        def forward(state: ProgramState, x):
            return model.forward(state.inner, x)
    else:
        model = alexnet_split_model(spec.split,
                                    num_classes=spec.data.num_classes)

        def aux_head_fwd(p, feats):
            # the reference's NHWC flatten, so its (feat_dim, N) aux head
            # applies unchanged; bf16 features meet the float32 head in
            # float32, as jnp's type promotion has it
            x = feats.permute(0, 2, 3, 1).reshape(feats.shape[0], -1)
            dt = torch.promote_types(x.dtype, p["w"].dtype)
            return x.to(dt) @ p["w"].to(dt)

        round_fn = B.make_sfl_round(spec.method, model, lr=lr,
                                    aux_head_fwd=aux_head_fwd,
                                    aggregator=agg, precision=precision)

        def init() -> ProgramState:
            return ProgramState(inner=fresh(state0) if donate else state0)

        def round_step(state: ProgramState, batches, sizes):
            return ProgramState(inner=round_fn(state.inner, batches, sizes),
                                fed=state.fed), {}

        def forward(state: ProgramState, x):
            wc0 = tree_map(lambda a: a[0], state.inner["wc"])
            logits, _ = model.server_fwd(state.inner["ws"],
                                         model.client_fwd(wc0, {"x": x}))
            return logits

    @torch.no_grad()
    def predict(state: ProgramState, batch):
        return forward(state, batch["x"])

    # client-major: the rounds take (C, T, ...) batches; the transpose is
    # the dispatch's (:func:`_dispatch`)
    return _dispatch(RoundProgram(
        spec=spec, model=model, init=init, step=round_step, predict=predict,
        metadata=dict(method=spec.method, mode="subset", slots=slots,
                      backend="logits", boundary=spec.execution.boundary,
                      device=str(device), client_major=True)))
