"""``build(spec)`` -- an :class:`ExperimentSpec` into a round program.

The port runs the synchronous SCALA round of ``repro.api.build.
_build_scala`` in ``subset`` mode, for a text arch (the transformer) or
the CNN family (AlexNet at ``spec.width``, split at ``spec.split``), and
the FL / SFL baselines of ``_build_fl`` / ``_build_sfl`` on AlexNet:
``init()`` builds the program state, ``step(state, batches, sizes)`` runs
one round (T local steps and the FL phase) and ``predict(state, batch)``
the current global model (SCALA and SFL: slot 0's client half and the
server half; FL: the full model).

Params are the port's own init, drawn from ``torch.Generator(device)``
seeded with ``spec.seed`` -- the JAX init's numbers cannot be drawn here
-- or given: ``build(spec, params=...)`` starts from exactly the
reference's. For SCALA that is the training layout of
:func:`repro_torch.convert.train_params_from_reference`; for an FL
method the merged AlexNet tree, for an SFL method ``{'wc', 'ws'}`` (and
``'aux'`` for sfl_localloss) -- see
:func:`repro_torch.convert.baseline_state_from_reference`.

As in the reference, the baselines get no optimizer (plain SGD whatever
``spec.optim`` says, at ``spec.optim.resolve_lr(spec.scala.lr)``), the
``weighted`` aggregator is the data-size FedAvg, and their rounds take
client-major (C, T, ...) batches: the step transposes the Trainer's
(T, C, ...) ones.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, Dict

import torch

from repro_torch.api.specs import ExperimentSpec
from repro_torch.models.common import resolve_device
from repro_torch.tree import leaves, tree_map


@dataclass(frozen=True)
class ProgramState:
    """``inner``: the engine :class:`TrainState`; ``fed``: the federation
    carry (empty: the ported aggregators are stateless)."""

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
    ``slots`` (a merged client half is repeated)."""
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
    elif probe.shape[0] != slots or (shape is not None
                                     and tuple(probe.shape[1:]) != shape):
        raise ValueError(f"client half's first leaf has shape "
                         f"{tuple(probe.shape)}; expected it merged or "
                         f"stacked over {slots} slots of {cfg.name}")
    return tree_map(lambda a: a.to(device), params)


def build(spec: ExperimentSpec, *, device="cuda",
          params=None) -> RoundProgram:
    """Validate ``spec`` and build its program on ``device``."""
    from repro_torch.core import engine
    from repro_torch.core.baselines import FL_METHODS, SFL_METHODS

    spec.validate()
    device = resolve_device(device)
    if spec.method in FL_METHODS + SFL_METHODS:
        return _build_baseline(spec, device, params)
    ex, fd, sc = spec.execution, spec.fed, spec.scala
    if spec.method == "scala_noadj":
        sc = dataclasses.replace(sc, adjust_server=False, adjust_client=False)
    slots = spec.slots
    opt = spec.optim.make()
    sched = spec.optim.make_schedule(spec.rounds * sc.local_iters,
                                     default_lr=sc.lr)
    agg = fd.make_aggregator()
    if params is None:
        init = (_cnn_split_init if spec.model_config().family == "cnn"
                else text_split_init)
        model, params = init(spec, slots, device)
    else:
        model = _split_model(spec)
        params = _check_params(params, spec, slots, device)
    round_fn = engine.make_round_runner(
        model, sc, backend=ex.backend, boundary=ex.boundary, optimizer=opt,
        schedule=sched, aggregator=agg, opt_state_policy=fd.opt_state_policy,
        precision=ex.precision)

    def init() -> ProgramState:
        return ProgramState(inner=engine.init_train_state(params, opt))

    def step(state: ProgramState, batches, sizes):
        inner, metrics = round_fn(state.inner, batches, sizes)
        return ProgramState(inner=inner, fed=state.fed), metrics

    @torch.no_grad()
    def predict(state: ProgramState, batch):
        wc0 = tree_map(lambda a: a[0], state.inner.params["client"])
        acts = model.client_fwd(wc0, batch)
        logits, _ = model.server_fwd(state.inner.params["server"], acts)
        return logits

    return RoundProgram(
        spec=spec, model=model, init=init, step=step, predict=predict,
        metadata=dict(method=spec.method, mode=ex.mode, slots=slots,
                      backend=ex.backend, boundary=ex.boundary,
                      precision=ex.precision, rounds_per_call=1,
                      device=str(device)))


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
    precision = spec.execution.precision
    state0 = _baseline_params(spec, device, params)
    if spec.method in B.FL_METHODS:
        model = B.FedModel(forward=lambda p, x: A.forward(p, x, spec.split),
                           num_classes=spec.data.num_classes,
                           features=A.features)
        round_fn = B.make_fl_round(spec.method, model, lr=lr, aggregator=agg,
                                   precision=precision)

        def init() -> ProgramState:
            return ProgramState(inner=state0, fed=B.init_fl_state(
                spec.method, state0, slots))

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
            # applies unchanged
            return feats.permute(0, 2, 3, 1).reshape(feats.shape[0],
                                                     -1) @ p["w"]

        round_fn = B.make_sfl_round(spec.method, model, lr=lr,
                                    aux_head_fwd=aux_head_fwd,
                                    aggregator=agg, precision=precision)

        def init() -> ProgramState:
            return ProgramState(inner=state0)

        def round_step(state: ProgramState, batches, sizes):
            return ProgramState(inner=round_fn(state.inner, batches, sizes),
                                fed=state.fed), {}

        def forward(state: ProgramState, x):
            wc0 = tree_map(lambda a: a[0], state.inner["wc"])
            logits, _ = model.server_fwd(state.inner["ws"],
                                         model.client_fwd(wc0, {"x": x}))
            return logits

    def step(state: ProgramState, batches, sizes):
        # client-major: the baselines' rounds take (C, T, ...) batches
        return round_step(state, {k: v.transpose(0, 1)
                                  for k, v in batches.items()}, sizes)

    @torch.no_grad()
    def predict(state: ProgramState, batch):
        return forward(state, batch["x"])

    return RoundProgram(
        spec=spec, model=model, init=init, step=step, predict=predict,
        metadata=dict(method=spec.method, mode="subset", slots=slots,
                      backend="logits", boundary=spec.execution.boundary,
                      precision=precision, rounds_per_call=1,
                      device=str(device), client_major=True))
