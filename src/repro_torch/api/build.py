"""``build(spec)`` -- an :class:`ExperimentSpec` into a round program.

The port runs the synchronous SCALA round of ``repro.api.build.
_build_scala`` in ``subset`` mode: ``init()`` builds the program state
(params, optimizer state), ``step(state, batches, sizes)`` runs one round
(T local steps and the FL phase) and ``predict(state, batch)`` the
current global model (slot 0's client half and the server half).

Params are the port's own init, drawn from ``torch.Generator(device)``
seeded with ``spec.seed`` -- the JAX init's numbers cannot be drawn here
-- or given: ``build(spec, params=...)`` with the training layout of
:func:`repro_torch.convert.train_params_from_reference` (a reference
tree or checkpoint) starts from exactly the reference's params.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, Dict

import torch

from repro_torch.api.specs import ExperimentSpec
from repro_torch.models.common import resolve_device
from repro_torch.tree import tree_map


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


def _check_params(params, spec: ExperimentSpec, slots: int, device):
    """Given params on ``device``, their client half stacked over
    ``slots`` (a merged client half is repeated)."""
    from repro_torch.core.split import stack_client_params

    cfg = spec.model_config()
    tok = params["client"]["embed"]["tok"]
    if tuple(tok.shape) == (cfg.vocab_size, cfg.d_model):
        params = dict(params, client=stack_client_params(params["client"],
                                                         slots))
    elif tuple(tok.shape) != (slots, cfg.vocab_size, cfg.d_model):
        raise ValueError(f"client embedding has shape {tuple(tok.shape)}; "
                         f"expected ({cfg.vocab_size}, {cfg.d_model}) or "
                         f"({slots}, ...) for {slots} slots of {cfg.name}")
    return tree_map(lambda a: a.to(device), params)


def build(spec: ExperimentSpec, *, device="cuda",
          params=None) -> RoundProgram:
    """Validate ``spec`` and build its program on ``device``."""
    from repro_torch.core import engine

    spec.validate()
    device = resolve_device(device)
    ex, fd, sc = spec.execution, spec.fed, spec.scala
    if spec.method == "scala_noadj":
        sc = dataclasses.replace(sc, adjust_server=False, adjust_client=False)
    slots = spec.slots
    opt = spec.optim.make()
    sched = spec.optim.make_schedule(spec.rounds * sc.local_iters,
                                     default_lr=sc.lr)
    agg = fd.make_aggregator()
    if params is None:
        model, params = text_split_init(spec, slots, device)
    else:
        from repro_torch.core.scala import transformer_split_model

        model = transformer_split_model(spec.model_config())
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
