"""The baselines the paper compares against (Tables 1-6).

FL family (the full model on every client, FedAvg aggregation):
  fedavg, fedprox, feddyn, feddecorr, fedlogit (eq. 15 used locally),
  fedla (FedLC-style logit calibration).

SFL family (the split model):
  splitfed_v1 (per-client server copies, both halves averaged per round),
  splitfed_v2 (one shared server half updated client by client; no
  server average),
  splitfed_v3 (personalized client halves, server averaged),
  sfl_localloss (an auxiliary client head; no server->client gradients).

The rounds of :mod:`repro.core.baselines`: the reference's ``vmap`` over
the clients is a loop over the slots, its ``scan`` over the local steps
a loop, and every gradient is ``torch.autograd.grad`` on fresh leaves
that require grad. As in the reference, the local objectives ignore the
batches' ``weights``: the zero-weight padding rows of
:func:`repro_torch.data.loader.round_batches` are trained on and fedla's
class counts count them. FedDyn's ``h`` and splitfed_v3's client halves
live by slot, not by client id. Local updates are plain SGD, as the
reference's API passes no optimizer; an FL round may add a server
optimizer on its aggregated delta (FedAvgM, FedAdam). A prior-aware
aggregator gets the round's label priors, the padding rows left out.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

import dataclasses

import torch

from repro_torch.core import engine, losses
from repro_torch.core.engine import SplitModel
from repro_torch.core.label_stats import histogram, prior
from repro_torch.core.split import (fedavg, stack_client_params,
                                    weighted_mean)
from repro_torch.fed import AggContext, aggregation_priors
from repro_torch.optim import optimizers
from repro_torch.tree import leaves, tree_map, unflatten

FL_METHODS = ("fedavg", "fedprox", "feddyn", "feddecorr", "fedlogit", "fedla")
SFL_METHODS = ("splitfed_v1", "splitfed_v2", "splitfed_v3", "sfl_localloss")


@dataclass(frozen=True)
class FedModel:
    """Full (non-split) model adapter for the FL baselines."""

    forward: Callable[[Any, Any], Any]              # (params, x) -> logits
    num_classes: int
    # optional feature extractor for FedDecorr
    features: Optional[Callable[[Any, Any], Any]] = None


def cast_fed_model(model: FedModel, precision: str) -> FedModel:
    """The FL baselines' mirror of :func:`repro_torch.core.engine.
    cast_to_compute`: ``"f32"`` runs the model as it is; ``"bf16"`` casts
    the params and the inputs to bfloat16 inside the wrapped forward (and
    FedDecorr's features), so the master params stay float32 and the
    cast's backward brings the param grads back to float32; the losses
    reduce in float32 (AlexNet's convolutions then run in bf16 on cuDNN:
    no kernel of the port)."""
    if precision not in engine.PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}; expected "
                         f"{engine.PRECISIONS}")
    if precision == "f32":
        return model
    bf16 = torch.bfloat16

    def forward(p, x):
        return model.forward(engine.cast_floats(p, bf16),
                             engine.cast_floats(x, bf16))

    features = None
    if model.features is not None:
        def features(p, x):
            return model.features(engine.cast_floats(p, bf16),
                                  engine.cast_floats(x, bf16))

    return dataclasses.replace(model, forward=forward, features=features)


def _grads(loss_fn, *trees):
    """d loss_fn(*trees) / d every leaf of every tree, one gradient tree
    per tree (zeros for an unused leaf)."""
    with torch.enable_grad():
        fresh = [engine._grad_leaves(t) for t in trees]
        loss = loss_fn(*(t for t, _ in fresh))
        flat = [x for _, ls in fresh for x in ls]
        gs = torch.autograd.grad(loss, flat, allow_unused=True)
    out, i = [], 0
    for tree, ls in fresh:
        out.append(unflatten(tree, [
            torch.zeros_like(p) if g is None else g
            for p, g in zip(ls, gs[i:i + len(ls)])]))
        i += len(ls)
    return out


def _slot(tree, c):
    return tree_map(lambda a: a[c], tree)


def _stack(trees):
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def _steps(batches):
    """The local steps' batches of one client: leaves (T, Bk, ...)."""
    T = leaves(batches)[0].shape[0]
    return [{k: v[t] for k, v in batches.items()} for t in range(T)]


# ---------------------------------------------------------------------------
# local losses
# ---------------------------------------------------------------------------


def _decorr_loss(feats):
    """FedDecorr: squared off-diagonal correlation of normalized features
    (the population std, as ``jnp.std``)."""
    f = engine.at_least_f32(feats.reshape(feats.shape[0], -1))
    f = (f - f.mean(0)) / (f.std(0, correction=0) + 1e-5)
    n = f.shape[0]
    corr = (f.T @ f) / n
    d = corr.shape[0]
    off = corr - torch.diag(torch.diag(corr))
    return (off ** 2).sum() / (d * d)


def _sq_dist(params, ref):
    return sum(((a - b.to(a.dtype)) ** 2).sum()
               for a, b in zip(leaves(params), leaves(ref)))


MU, ALPHA, BETA, TAU = 0.01, 0.01, 0.1, 1.0   # the reference's defaults


def make_local_loss(method: str, model: FedModel):
    """``loss(params, batch, ctx)`` of an FL method; ``ctx`` holds
    ``w_global``, the client's prior ``p_k``, its class counts
    ``counts_k`` and FedDyn's ``h_k``."""

    def base_ce(params, batch, ctx):
        logits = model.forward(params, batch["x"])
        return losses.softmax_xent(logits, batch["labels"])

    if method == "fedavg":
        return base_ce

    if method == "fedprox":
        def loss(params, batch, ctx):
            return (base_ce(params, batch, ctx)
                    + 0.5 * MU * _sq_dist(params, ctx["w_global"]))
        return loss

    if method == "feddyn":
        def loss(params, batch, ctx):
            lin = sum((a * g).sum() for a, g in zip(leaves(params),
                                                    leaves(ctx["h_k"])))
            return (base_ce(params, batch, ctx) - lin
                    + 0.5 * ALPHA * _sq_dist(params, ctx["w_global"]))
        return loss

    if method == "feddecorr":
        assert model.features is not None, "feddecorr needs model.features"

        def loss(params, batch, ctx):
            logits = model.forward(params, batch["x"])
            feats = model.features(params, batch["x"])
            return (losses.softmax_xent(logits, batch["labels"])
                    + BETA * _decorr_loss(feats))
        return loss

    if method == "fedlogit":
        # eq. (15) applied to purely local FL training
        def loss(params, batch, ctx):
            logits = model.forward(params, batch["x"])
            return losses.softmax_xent(logits, batch["labels"],
                                       prior=ctx["p_k"], tau=TAU)
        return loss

    if method == "fedla":
        # FedLC (Zhang et al. 2022): margin calibration by count^{-1/4}
        def loss(params, batch, ctx):
            logits = engine.at_least_f32(model.forward(params, batch["x"]))
            margin = TAU * (ctx["counts_k"] + 1e-8) ** -0.25
            return losses.softmax_xent(logits - margin, batch["labels"])
        return loss

    raise ValueError(f"unknown FL method {method!r}")


# ---------------------------------------------------------------------------
# FL runner
# ---------------------------------------------------------------------------


def fl_local_round(loss_fn, w_global, batches, ctx, lr: float):
    """T local SGD steps from ``w_global``; batches leaves (T, Bk, ...)."""
    opt = optimizers.sgd()
    w, st = w_global, opt.init(w_global)
    for batch in _steps(batches):
        (g,) = _grads(lambda p: loss_fn(p, batch, ctx), w)
        w, st = opt.update(g, st, w, lr)
    return w


def _aggregate_clients(aggregator, stacked, data_sizes, p_k=None,
                       p_global=None):
    """The FL phase: the :mod:`repro_torch.fed` aggregator's weights when
    one is given (stateless only: a baseline round threads no aggregator
    state), else the data-size FedAvg."""
    if aggregator is None:
        return fedavg(stacked, data_sizes)
    if aggregator.stateful:
        raise ValueError("baseline rounds support stateless aggregators "
                         f"only; {aggregator.name!r} keeps state")
    first = leaves(stacked)[0]
    ctx = AggContext(num_clients=first.shape[0], data_sizes=data_sizes,
                     p_k=p_k, p_global=p_global)
    w, _ = aggregator.client_weights(ctx, ())
    return weighted_mean(stacked, w.to(first.device))


def _aggregation_priors(num_classes: int, round_batches):
    """(P_k, P_global) over the round's labels for a prior-aware
    aggregator, the zero-weight padding rows left out (client-major
    batches)."""
    return aggregation_priors(num_classes, round_batches["labels"],
                              round_batches.get("weights"), client_axis=0)


def _aggregate_round(aggregator, stacked, data_sizes, num_classes,
                     round_batches):
    """:func:`_aggregate_clients` with the round's priors when the
    aggregator needs them."""
    p_k = p_global = None
    if aggregator is not None and aggregator.needs_priors:
        p_k, p_global = _aggregation_priors(num_classes, round_batches)
    return _aggregate_clients(aggregator, stacked, data_sizes, p_k=p_k,
                              p_global=p_global)


def make_fl_round(method: str, model: FedModel, lr: float,
                  aggregator=None, server_optimizer=None,
                  server_lr: float = 1.0, precision: str = "f32"):
    """``round(w_global, round_batches, data_sizes, state) -> (w_global',
    state')``; round_batches leaves (C, T, Bk, ...). ``precision``: the
    compute policy (:func:`cast_fed_model`); aggregation and FedOpt stay
    float32.

    ``server_optimizer``: FedOpt (Reddi et al.): the round delta
    ``w_global - avg(w_k)`` is a pseudo-gradient the server optimizer
    steps ``w_global`` against at ``server_lr`` (momentum: FedAvgM, adamw:
    FedAdam); its state lives in ``state['server_opt']``
    (:func:`init_fl_state`). Plain SGD at 1.0 is the round without it.
    """
    model = cast_fed_model(model, precision)
    loss_fn = make_local_loss(method, model)

    def round_fn(w_global, round_batches, data_sizes, state):
        C = round_batches["labels"].shape[0]
        w_k = []
        for c in range(C):
            batches = _slot(round_batches, c)
            counts = histogram(batches["labels"], model.num_classes)
            ctx = {"w_global": w_global, "p_k": prior(counts),
                   "counts_k": counts,
                   "h_k": _slot(state["h"], c) if method == "feddyn"
                   else None}
            w_k.append(fl_local_round(loss_fn, w_global, batches, ctx, lr))
        w_k = _stack(w_k)
        if method == "feddyn":
            # h_k <- h_k - alpha (w_k - w_global)
            state = dict(state, h=tree_map(
                lambda hk, wk, wg: hk - ALPHA * (wk - wg[None]),
                state["h"], w_k, w_global))
        w_avg = _aggregate_round(aggregator, w_k, data_sizes,
                                 model.num_classes, round_batches)
        if server_optimizer is not None:
            if "server_opt" not in state:
                raise ValueError("server_optimizer needs state['server_opt']"
                                 " -- init with init_fl_state(..., "
                                 "server_optimizer=)")
            delta = tree_map(
                lambda a, b: engine.at_least_f32(a) - engine.at_least_f32(b),
                w_global, w_avg)
            w_avg, so = server_optimizer.update(delta, state["server_opt"],
                                                w_global, server_lr)
            state = dict(state, server_opt=so)
        return w_avg, state

    return round_fn


def init_fl_state(method: str, w_global, num_clients: int,
                  server_optimizer=None):
    """FedDyn's ``h``, zeros by slot, and the server optimizer's state
    over ``w_global``; ``{}`` when neither applies."""
    state = {}
    if method == "feddyn":
        state["h"] = tree_map(lambda a: torch.zeros(
            (num_clients,) + a.shape, dtype=a.dtype, device=a.device),
            w_global)
    if server_optimizer is not None:
        state["server_opt"] = server_optimizer.init(w_global)
    return state


# ---------------------------------------------------------------------------
# SFL baselines (split model)
# ---------------------------------------------------------------------------


def make_sfl_round(method: str, model: SplitModel, lr: float,
                   aux_head_fwd=None, aggregator=None,
                   precision: str = "f32"):
    """``round(state, round_batches, data_sizes) -> state'``.

    State: ``{'wc': (C, ...) stacked client halves, 'ws': the server
    half}``, plus ``'aux'`` (C, ...) for sfl_localloss; round_batches
    leaves (C, T, Bk, ...). The local objective is
    :func:`repro_torch.core.engine.split_ce`; ``aggregator`` as in
    :func:`_aggregate_clients`. ``precision``: the compute policy
    (:func:`repro_torch.core.engine.cast_to_compute`), bf16 local compute
    against float32 master params.
    """
    model = engine.cast_to_compute(model, precision)
    opt = optimizers.sgd()

    def _agg(stacked, data_sizes, round_batches):
        return _aggregate_round(aggregator, stacked, data_sizes,
                                model.num_classes, round_batches)

    def ce_grads(wc, ws, batch):
        return _grads(lambda a, b: engine.split_ce(model, a, b, batch),
                      wc, ws)

    def local_steps_pair(wc, ws, batches):
        st_c, st_s = opt.init(wc), opt.init(ws)
        for batch in _steps(batches):
            gc, gs = ce_grads(wc, ws, batch)
            wc, st_c = opt.update(gc, st_c, wc, lr)
            ws, st_s = opt.update(gs, st_s, ws, lr)
        return wc, ws

    if method in ("splitfed_v1", "splitfed_v3"):
        def round_fn(state, round_batches, data_sizes):
            C = round_batches["labels"].shape[0]
            wc_k, ws_k = zip(*(local_steps_pair(_slot(state["wc"], c),
                                                state["ws"],
                                                _slot(round_batches, c))
                               for c in range(C)))
            new_ws = _agg(_stack(ws_k), data_sizes, round_batches)
            if method == "splitfed_v1":
                new_wc = stack_client_params(
                    _agg(_stack(wc_k), data_sizes, round_batches), C)
            else:  # v3: personalized client halves
                new_wc = _stack(wc_k)
            return {"wc": new_wc, "ws": new_ws}
        return round_fn

    if method == "splitfed_v2":
        # one shared server half, the clients in turn within each local step
        def round_fn(state, round_batches, data_sizes):
            wc_stack, ws = state["wc"], state["ws"]
            C, T = round_batches["labels"].shape[:2]
            st_c = engine._client_opt_init(opt, wc_stack)
            st_s = opt.init(ws)
            for t in range(T):
                gcs = []
                for k in range(C):
                    batch = {n: v[k, t] for n, v in round_batches.items()}
                    gc, gs = ce_grads(_slot(wc_stack, k), ws, batch)
                    ws, st_s = opt.update(gs, st_s, ws, lr)
                    gcs.append(gc)
                wc_stack, st_c = opt.update(_stack(gcs), st_c, wc_stack, lr)
            return {"wc": stack_client_params(
                        _agg(wc_stack, data_sizes, round_batches), C),
                    "ws": ws}
        return round_fn

    if method == "sfl_localloss":
        assert aux_head_fwd is not None

        def one_client(wc, aux_p, ws, batches):
            st_c, st_a, st_s = opt.init(wc), opt.init(aux_p), opt.init(ws)
            for batch in _steps(batches):
                # client: the local auxiliary loss only
                def closs(wc_, aux_):
                    acts = model.client_fwd(wc_, batch)
                    return losses.softmax_xent(aux_head_fwd(aux_, acts["x"]),
                                               batch["labels"])
                gc, ga = _grads(closs, wc, aux_p)
                wc, st_c = opt.update(gc, st_c, wc, lr)
                aux_p, st_a = opt.update(ga, st_a, aux_p, lr)
                # server: trains on the activations recomputed with the
                # updated client half, detached
                with torch.no_grad():
                    acts = model.client_fwd(wc, batch)

                def sloss(ws_):
                    lg, aux = model.server_fwd(ws_, acts)
                    return losses.softmax_xent(lg, batch["labels"]) + aux
                (gs,) = _grads(sloss, ws)
                ws, st_s = opt.update(gs, st_s, ws, lr)
            return wc, aux_p, ws

        def round_fn(state, round_batches, data_sizes):
            C = round_batches["labels"].shape[0]
            wc_k, aux_k, ws_k = (_stack(x) for x in zip(*(
                one_client(_slot(state["wc"], c), _slot(state["aux"], c),
                           state["ws"], _slot(round_batches, c))
                for c in range(C))))
            return {"wc": stack_client_params(
                        _agg(wc_k, data_sizes, round_batches), C),
                    "ws": _agg(ws_k, data_sizes, round_batches),
                    "aux": stack_client_params(
                        _agg(aux_k, data_sizes, round_batches), C)}
        return round_fn

    raise ValueError(f"unknown SFL method {method!r}")
