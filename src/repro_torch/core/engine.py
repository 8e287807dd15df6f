"""The split-step engine: one SCALA local iteration, and the round.

The reference's five stages (paper Alg. 2 lines 9-20), in PyTorch:

  stage 1  label priors       P_k per client, P_s concatenated (eqs. 5-6)
  stage 2  client forward     a Python loop over the client axis (the
                              reference vmaps it); each client's half runs
                              on its own detached leaves, its graph kept
  stage 3  server forward     ONE forward of the server half on the
                              concatenated activations, a detached leaf
                              that requires grad: ``server_fwd`` to the
                              logits (backend ``logits``) or
                              ``server_trunk`` to the features (``lace``)
  stage 4  dual pullbacks     both losses and both cotangents at the
                              boundary; autograd pulls the P_s cotangent
                              back to d w_s (keeping the graph) and the
                              P_k one back to the activation grads G_k;
                              under ``lace`` the head, unused by the
                              trunk, gets dW_s; each client pulls its
                              slice of G_k back through its own graph
                              (eq. 9)
  stage 5  update             an :class:`repro_torch.optim.Optimizer`

The boundary (stage 4), per backend and ``boundary``:

* ``lace`` + ``fused``: :func:`repro_torch.kernels.lace.ops.lace2_grads`
  (K1 + K2 on a card), both losses from one ``feats @ w_head`` product;
* ``lace`` + ``dual``: two :func:`~repro_torch.kernels.lace.ops.
  lace_loss` gradients (K4 + K5 each on a card), eq. 14 wrt (feats,
  w_head) and eq. 15 wrt feats alone, so the client side's K5 skips dW;
* ``logits`` + ``fused``: :func:`repro_torch.core.losses.
  dual_adjusted_xent` over the materialized logits;
* ``logits`` + ``dual`` (and ``fused`` with ``label_smoothing > 0``, as in
  the reference): two ``softmax_xent`` gradients.

On the CPU the fused and dual boundaries give bit-identical float32
gradients and losses (their plain ops share every step; the tests hold
them to it).

Ported: backends ``logits`` and ``lace``, both boundaries, ``precision=
"f32"`` (the model's own compute dtype), an optional participation
``mask``, and the synchronous round with an aggregator and the
``opt_state_policy`` carry / reset / average. ``lace_dp``, the bf16
policy, sparse slots, faults, guards and server-side FedOpt raise
``NotImplementedError`` naming the slice that brings them.

Memory: the client half's graph from stage 2 is kept and pulled back
once (the reference re-runs the client forward inside its vjp); the
server half is not rematerialized (about 0.5 GB of saved activations per
layer at 8192 tokens of qwen1.5-0.5b), so every attention layer launches
the forward kernel once per step and the backward kernel once per
pullback through it.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.configs.base import ScalaConfig
from repro_torch.core import losses
from repro_torch.core.label_stats import client_and_concat_priors
from repro_torch.core.split import stack_client_params, weighted_mean
from repro_torch.optim import optimizers, schedules
from repro_torch.tree import leaves, tree_map, unflatten

BACKENDS = ("logits", "lace", "lace_dp")
BOUNDARIES = ("dual", "fused")
PRECISIONS = ("f32", "bf16")
OPT_STATE_POLICIES = ("carry", "reset", "average")

_LATER = {
    "lace_dp": "the multi-device slice",
    "bf16": "the dispatch-knob slice",
}


@dataclass(frozen=True)
class SplitModel:
    """The two halves of a split model.

    client_fwd(wc, batch) -> acts ``{'x', ...}`` (a transformer adds
    ``'positions'``); server_fwd(ws, acts) -> (logits, aux). For the
    ``lace`` backend also server_trunk(ws, acts) -> (features, aux),
    everything but the head; head_weight(ws) -> (d, V); and
    head_grad_merge(d_ws, dW), which adds the boundary's head gradient.
    """

    client_fwd: Callable[[Any, Dict[str, Any]], Dict[str, Any]]
    server_fwd: Callable[[Any, Dict[str, Any]], Any]
    num_classes: int
    server_trunk: Optional[Callable[[Any, Dict[str, Any]], Any]] = None
    head_weight: Optional[Callable[[Any], Any]] = None
    head_grad_merge: Optional[Callable[[Any, Any], Any]] = None


def default_ce_chunk(num_classes: int) -> int:
    """The plain boundary's token chunk: logits of ~2^32 elements."""
    return max(4096, (1 << 32) // max(1, num_classes))


def _priors(labels, weights, N, scala: ScalaConfig):
    """Stage 1: (P_k (C, N), P_s (N,)) from this step's labels."""
    return client_and_concat_priors(labels, N, weights, eps=scala.prior_eps)


def _check(backend, boundary, precision, model):
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected {BACKENDS}")
    if boundary not in BOUNDARIES:
        raise ValueError(f"unknown boundary {boundary!r}; expected "
                         f"{BOUNDARIES}")
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}; expected "
                         f"{PRECISIONS}")
    for value in (backend, boundary, precision):
        if value in _LATER:
            raise NotImplementedError(
                f"{value!r} is not ported yet; it comes with "
                f"{_LATER[value]}")
    if backend != "logits" and model.server_trunk is None:
        raise ValueError(f"backend {backend!r} needs model.server_trunk/"
                         "head_weight (fused LACE path)")


def _grad_leaves(tree):
    """The tree's leaves as fresh autograd leaves (views of the same
    memory), and the list of them in order."""
    tree = tree_map(lambda a: a.detach().requires_grad_(), tree)
    return tree, leaves(tree)


def _logits_boundary(logits, labels, weights, p_k, p_s, scala, boundary):
    """Stage 4 of backend ``logits``: (loss_s, loss_k, g_s, g_k,
    accuracy) over the materialized logits (C*B, ..., N), the priors
    broadcast over each client's tokens as the reference's
    ``_prior_for_tokens``."""
    N = logits.shape[-1]
    labels_f = labels.reshape((-1,) + labels.shape[2:])
    weights_f = (None if weights is None
                 else weights.reshape((-1,) + weights.shape[2:]))
    ps_use = p_s if scala.adjust_server else None
    pk_tok = p_k.reshape((p_k.shape[0],) + (1,) * (labels.dim() - 1) + (N,))
    pk_use = (pk_tok.expand(labels.shape[:2] + (1,) * (labels.dim() - 2)
                            + (N,)).reshape((-1,) + (1,) * (labels.dim() - 2)
                                            + (N,))
              if scala.adjust_client else None)
    kw = dict(tau=scala.tau, label_smoothing=scala.label_smoothing,
              prior_eps=scala.prior_eps)
    acc = losses.accuracy(logits, labels_f, weights_f)
    if boundary == "fused" and scala.label_smoothing == 0.0:
        return losses.dual_adjusted_xent(logits, labels_f, weights=weights_f,
                                         prior_s=ps_use, prior_k=pk_use,
                                         **kw) + (acc,)
    out = []
    for prior in (ps_use, pk_use):
        lg = logits.detach().requires_grad_()
        loss = losses.softmax_xent(lg, labels_f, weights=weights_f,
                                   prior=prior, **kw)
        out.append((loss.detach(), torch.autograd.grad(loss, lg)[0]))
    (loss_s, g_s), (loss_k, g_k) = out
    return loss_s, loss_k, g_s, g_k, acc


def _lace_boundary(feats, w_head, labels, weights, p_k, p_s, scala,
                   boundary, ce_chunk):
    """Stage 4 of backend ``lace``: (loss_s, loss_k, gf_s, gf_k, gW_s)
    with the feature cotangents (C, tokens, d)."""
    from repro_torch.kernels.lace import ops

    C = labels.shape[0]
    feats_g = feats.reshape(C, -1, feats.shape[-1])
    labels_g = labels.reshape(C, -1)
    weights_g = None if weights is None else weights.reshape(C, -1)
    ps_rows = p_s[None] if scala.adjust_server else None
    pk_rows = p_k if scala.adjust_client else None
    pk_ids = (torch.arange(C, device=labels.device) if scala.adjust_client
              else None)
    args = (scala.tau, scala.prior_eps, ce_chunk)
    if boundary == "fused":
        return ops.lace2_grads(feats_g, w_head, labels_g, ps_rows, None,
                               pk_rows, pk_ids, weights_g, *args)[:5]
    # eq. 14: the concatenated prior P_s, for the server update (d w_s)
    fg = feats_g.detach().requires_grad_()
    wh = w_head.detach().requires_grad_()
    loss_s = ops.lace_loss(fg, wh, labels_g, ps_rows, None, weights_g, *args)
    gf_s, gW_s = torch.autograd.grad(loss_s, (fg, wh))
    # eq. 15: the per-client priors P_k, for the activation grads G_k
    loss_k = ops.lace_loss(fg, w_head.detach(), labels_g, pk_rows, pk_ids,
                           weights_g, *args)
    (gf_k,) = torch.autograd.grad(loss_k, fg)
    return loss_s.detach(), loss_k.detach(), gf_s, gf_k, gW_s


def split_step_grads(model: SplitModel, params, batch, scala: ScalaConfig, *,
                     backend: str = "lace", boundary: str = "fused",
                     ce_chunk: Optional[int] = None, mask=None,
                     precision: str = "f32"):
    """Stages 1-4 of the SCALA local iteration.

    params: ``{'client': stacked (C, ...), 'server': ...}``; batch leaves
    (C, B_k, ...). Returns (grads, metrics), grads mirroring params.
    ``mask`` is an optional (C,) 0/1 participation mask folded into the
    token weights: masked-out clients add nothing to the priors or the
    losses and get zero gradient.
    """
    _check(backend, boundary, precision, model)
    N = model.num_classes
    labels = batch["labels"]
    weights = batch.get("weights")
    C = labels.shape[0]
    if mask is not None:
        mw = mask.float().reshape((C,) + (1,) * (labels.dim() - 1))
        base = (torch.ones(labels.shape, dtype=torch.float32,
                           device=labels.device) if weights is None
                else torch.broadcast_to(weights, labels.shape))
        weights = base * mw

    # --- stage 1: label statistics (clients upload Y_k with A_k) ---
    p_k, p_s = _priors(labels, weights, N, scala)

    with torch.enable_grad():
        # --- stage 2: every client's forward, its graph kept ---
        client_trees, client_acts = [], []
        for c in range(C):
            wc, wc_leaves = _grad_leaves(tree_map(lambda a: a[c],
                                                  params["client"]))
            b = {k: v[c] for k, v in batch.items()}
            acts = model.client_fwd(wc, b)
            client_trees.append(wc_leaves)
            client_acts.append(acts)
        if "memory" in client_acts[0]:
            raise NotImplementedError("cross-attention memory at the split "
                                      "is not ported yet; it comes with the "
                                      "other archs")
        x_c = [a["x"] for a in client_acts]
        x = torch.cat([a.detach() for a in x_c]).requires_grad_()

        # --- stage 3: one server forward on the concatenation, every
        # other activation (positions) taken from client 0, as the
        # reference closes over its first slot's ---
        ws, ws_leaves = _grad_leaves(params["server"])
        server = model.server_fwd if backend == "logits" else \
            model.server_trunk
        out, aux = server(ws, {**client_acts[0], "x": x})

        # --- stage 4: both losses and cotangents at the split boundary ---
        metrics = {}
        if backend == "logits":
            loss_s, loss_k, g_s, g_k, metrics["accuracy"] = \
                _logits_boundary(out.detach(), labels, weights, p_k, p_s,
                                 scala, boundary)
        else:
            loss_s, loss_k, g_s, g_k, gW_s = _lace_boundary(
                out.detach(), model.head_weight(params["server"]), labels,
                weights, p_k, p_s, scala, boundary,
                default_ce_chunk(N) if ce_chunk is None else ce_chunk)
        g_s = g_s.reshape(out.shape).to(out.dtype)
        g_k = g_k.reshape(out.shape).to(out.dtype)

    # stage 4a: P_s cotangent -> d w_s; P_k cotangent -> G_k
    d_ws = torch.autograd.grad(out, ws_leaves, g_s, retain_graph=True,
                               allow_unused=True)
    d_ws = unflatten(params["server"], [
        torch.zeros_like(p) if g is None else g
        for p, g in zip(ws_leaves, d_ws)])
    (g_x,) = torch.autograd.grad(out, [x], g_k)
    if backend != "logits":
        d_ws = model.head_grad_merge(d_ws, gW_s)

    # stage 4b (eq. 9): each client pulls its own G_k back
    d_wc, start = [], 0
    for c in range(C):
        n = x_c[c].shape[0]
        g = torch.autograd.grad(x_c[c], client_trees[c],
                                g_x[start:start + n], allow_unused=True)
        d_wc.append([torch.zeros_like(p) if gi is None else gi
                     for p, gi in zip(client_trees[c], g)])
        start += n
    d_wc = unflatten(params["client"], [torch.stack(gs)
                                        for gs in zip(*d_wc)])
    metrics = {"loss_server": loss_s, "loss_client": loss_k,
               "aux": aux.detach(), **metrics}
    return {"client": d_wc, "server": d_ws}, metrics


# ---------------------------------------------------------------------------
# stage 5 and the state threaded through steps and rounds
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class TrainState:
    """Params, per-half optimizer state (every client-state leaf carries
    the stacked (C, ...) axis) and the global step driving the lr
    schedule (an int)."""

    params: Any
    opt_state: Any
    step: int


def _client_opt_init(opt: optimizers.Optimizer, client_params):
    """The optimizer's state for a stacked client half: a step count
    per client, as the reference's per-client (vmapped) init gives."""
    state = opt.init(client_params)
    if isinstance(state, dict) and "count" in state:
        C = leaves(client_params)[0].shape[0]
        state = dict(state, count=state["count"].expand(C).clone())
    return state


def init_train_state(params, optimizer: optimizers.Optimizer) -> TrainState:
    return TrainState(
        params=params,
        opt_state={"client": _client_opt_init(optimizer, params["client"]),
                   "server": optimizer.init(params["server"])},
        step=0)


def _apply_updates(opt: optimizers.Optimizer, state: TrainState, grads,
                   lr) -> TrainState:
    new_s, st_s = opt.update(grads["server"], state.opt_state["server"],
                             state.params["server"], lr)
    new_c, st_c = opt.update(grads["client"], state.opt_state["client"],
                             state.params["client"], lr)
    return TrainState(params={"client": new_c, "server": new_s},
                      opt_state={"client": st_c, "server": st_s},
                      step=state.step + 1)


def make_split_step(model: SplitModel, scala: ScalaConfig, *,
                    backend: str = "lace", boundary: str = "fused",
                    optimizer: Optional[optimizers.Optimizer] = None,
                    schedule: Optional[Callable] = None,
                    ce_chunk: Optional[int] = None, precision: str = "f32"):
    """The stateful step: (TrainState, batch[, mask]) -> (TrainState,
    metrics). ``optimizer`` defaults to plain SGD (eqs. 7/9) and
    ``schedule`` to a constant ``scala.lr``, driven by ``state.step``."""
    _check(backend, boundary, precision, model)
    opt = optimizer if optimizer is not None else optimizers.sgd()
    sched = schedule if schedule is not None else schedules.constant(scala.lr)

    def step(state: TrainState, batch, mask=None):
        grads, metrics = split_step_grads(model, state.params, batch, scala,
                                          backend=backend, boundary=boundary,
                                          ce_chunk=ce_chunk, mask=mask,
                                          precision=precision)
        return _apply_updates(opt, state, grads, sched(state.step)), metrics

    return step


def _round_boundary_opt_state(opt: optimizers.Optimizer, opt_state,
                              new_params, weights, policy: str):
    """Client optimizer state at the round boundary; the server half's
    always carries."""
    if policy == "carry":
        return opt_state
    if policy == "reset":
        return {"client": _client_opt_init(opt, new_params["client"]),
                "server": opt_state["server"]}

    def avg(a):  # "average": aggregated like the params, in f32
        wb = weights.reshape((-1,) + (1,) * (a.dim() - 1)).float()
        m = (a.float() * wb).sum(0).to(a.dtype)
        return m[None].expand(a.shape)

    return {"client": tree_map(avg, opt_state["client"]),
            "server": opt_state["server"]}


def make_round_runner(model: SplitModel, scala: ScalaConfig, *,
                      backend: str = "lace", boundary: str = "fused",
                      optimizer: Optional[optimizers.Optimizer] = None,
                      schedule: Optional[Callable] = None,
                      ce_chunk: Optional[int] = None, aggregate: bool = True,
                      aggregator=None, participation=None,
                      opt_state_policy: str = "carry",
                      slot_gather: bool = False, server_optimizer=None,
                      precision: str = "f32", faults=None, guards=None):
    """One synchronous round: T local steps over ``round_batches``
    (leaves (T, C, B_k, ...)), then the FL phase -- the aggregator's
    weights average the client halves, which go back to every slot, and
    ``opt_state_policy`` (carry | reset | average) fixes the client
    optimizer state.

    Returns ``round_fn(state, round_batches, data_sizes=None) ->
    (TrainState, metrics)``, the metrics of the last step.
    """
    from repro_torch import fed as _fed

    if opt_state_policy not in OPT_STATE_POLICIES:
        raise ValueError(f"unknown opt_state_policy {opt_state_policy!r}; "
                         f"expected {OPT_STATE_POLICIES}")
    for name, value, slice_ in (
            ("participation", participation, "the federation slice"),
            ("slot_gather", slot_gather or None, "the sparse/async slice"),
            ("server_optimizer", server_optimizer, "the federation slice"),
            ("faults", faults, "the fault-tolerance slice"),
            ("guards", guards, "the fault-tolerance slice")):
        if value is not None:
            raise NotImplementedError(f"{name} is not ported yet; it comes "
                                      f"with {slice_}")
    opt = optimizer if optimizer is not None else optimizers.sgd()
    agg = aggregator if aggregator is not None else _fed.weighted()
    step = make_split_step(model, scala, backend=backend, boundary=boundary,
                           optimizer=opt, schedule=schedule,
                           ce_chunk=ce_chunk, precision=precision)

    def round_fn(state: TrainState, round_batches, data_sizes=None):
        T = leaves(round_batches)[0].shape[0]
        metrics = None
        for t in range(T):
            state, metrics = step(state, {k: v[t] for k, v in
                                          round_batches.items()})
        if aggregate:
            C = leaves(state.params["client"])[0].shape[0]
            ctx = _fed.AggContext(num_clients=C, data_sizes=data_sizes)
            w, _ = agg.client_weights(ctx, ())
            w = w.to(leaves(state.params["client"])[0].device)
            params = {"client": stack_client_params(
                weighted_mean(state.params["client"], w), C),
                "server": state.params["server"]}
            opt_state = _round_boundary_opt_state(
                opt, state.opt_state, params, w, opt_state_policy)
            state = TrainState(params=params, opt_state=opt_state,
                               step=state.step)
        return state, metrics

    return round_fn


def split_ce(model: SplitModel, wc, ws, batch):
    """Plain CE through the split: ONE client's forward into the server
    half, no concatenation and no logit adjustment, plus the server's
    ``aux`` loss. The local objective of the SFL baselines
    (:mod:`repro_torch.core.baselines`)."""
    acts = model.client_fwd(wc, batch)
    logits, aux = model.server_fwd(ws, acts)
    return losses.softmax_xent(logits, batch["labels"]) + aux


def init_scala_params(gen: torch.Generator, init_client, init_server,
                      num_clients: int):
    """The stacked-client SCALA layout from per-half inits, both drawn
    from ``gen`` in turn."""
    return {"client": stack_client_params(init_client(gen), num_clients),
            "server": init_server(gen)}

