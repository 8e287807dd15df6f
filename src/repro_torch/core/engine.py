"""The split-step engine: one SCALA local iteration, and the round.

The reference's five stages (paper Alg. 2 lines 9-20), in PyTorch:

  stage 1  label priors       P_k per client, P_s concatenated (eqs. 5-6)
  stage 2  client forward     a Python loop over the client axis (the
                              reference vmaps it); each client's half runs
                              on its own detached leaves, its graph kept
  stage 3  server forward     ONE forward of the server half on the
                              concatenated activations (and a cross-
                              attention arch's concatenated encoder
                              memory), each a detached leaf that
                              requires grad: ``server_fwd`` to the
                              logits (backend ``logits``) or
                              ``server_trunk`` to the features (``lace``)
  stage 4  dual pullbacks     both losses and both cotangents at the
                              boundary; autograd pulls (P_s cotangent, 1)
                              through (out, aux) back to d w_s (keeping
                              the graph), so the MoE router loss charges
                              the server weights, and the P_k one through
                              out alone (aux's cotangent 0) back to the
                              activation grads G_k (and the memory's
                              G_mem; the P_s pass's is dropped, as the
                              reference's);
                              under ``lace`` the head, unused by the
                              trunk, gets dW_s; each client pulls its
                              slice of G_k (and of G_mem) back through
                              its own graph (eq. 9)
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
  the reference): two ``softmax_xent`` gradients;
* ``lace_dp`` (the reference's manual-SPMD profile, on a
  :class:`repro_torch.sharding.Grid` passed as ``mesh=``): every rank
  runs the step on its own client shard and token slice with the
  minimal collective schedule -- the priors' histograms summed over
  ``inner`` then ``client``; the global weight denominator, then the two
  raw loss sums, as scalars over all ranks; ONE all_reduce of the server
  gradient tree over all ranks; the client gradients over ``inner``
  (both in ``scala.grad_reduce_dtype`` on the wire); ``aux`` averaged.
  The boundary takes raw sums over the rank's tokens
  (:func:`~repro_torch.kernels.lace.ops.lace2_grads` with ``mean=False``,
  K1 + K2 on a card, fused; two ``lace_nll_sum``, K4 + K5, dual) and
  rescales the unit-cotangent gradients by the global denominator;
  gradients never go through a collective before the stage-4 sums.

Under ``lace_dp`` a step, round or event takes this rank's state (the
client rows of its shard, the server half replicated) and the GLOBAL
batches, masks and data sizes, which every rank draws alike on the host:
``batch_specs`` (:func:`repro_torch.launch.input_specs.
train_batch_specs` through :func:`repro_torch.sharding.tree_specs`)
cuts this rank's block out of them, as the reference's ``shard_map``
in_specs do. Metrics come back global, the same on every rank.

On the CPU the fused and dual boundaries give bit-identical float32
gradients and losses (their plain ops share every step; the tests hold
them to it).

Ported: every backend, both boundaries, both compute policies
(``precision="f32"``: the model's own compute dtype; ``"bf16"``:
:func:`cast_to_compute`), an optional participation ``mask``, and the
synchronous round with the federation layer: a participation scheduler
(masked, or gathered into a dense subset axis: sparse; under ``lace_dp``
each client shard gathers its own slots), any aggregator of
:mod:`repro_torch.fed`, the ``opt_state_policy`` carry / reset / average,
server-side FedOpt, fault injection and guarded aggregation (the survivor
re-run), and round-level donation.

Memory: the client half's graph from stage 2 is kept and pulled back
once (the reference re-runs the client forward inside its vjp); the
server half is not rematerialized (about 0.5 GB of saved activations per
layer at 8192 tokens of qwen1.5-0.5b), so every attention layer launches
the forward kernel once per step and the backward kernel once per
pullback through it.
"""
from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import ScalaConfig
from repro_torch.core import losses
from repro_torch.core.label_stats import (client_and_concat_priors,
                                          histogram, prior)
from repro_torch.core.split import stack_client_params, weighted_mean
from repro_torch.models.common import dtype_of
from repro_torch.optim import optimizers, schedules
from repro_torch.tree import leaves, tree_map, unflatten

BACKENDS = ("logits", "lace", "lace_dp")
BOUNDARIES = ("dual", "fused")
PRECISIONS = ("f32", "bf16")
OPT_STATE_POLICIES = ("carry", "reset", "average")


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


# ---------------------------------------------------------------------------
# mixed precision
# ---------------------------------------------------------------------------


def cast_floats(tree, dtype):
    """Every floating leaf of a tree cast to ``dtype`` (integer leaves and
    non-tensors pass through). The cast is differentiable: autograd's
    backward of it brings a cotangent back to the leaf's own dtype."""
    return tree_map(lambda a: a.to(dtype) if isinstance(a, torch.Tensor)
                    and a.is_floating_point() else a, tree)


def cast_to_compute(model: SplitModel, precision: str) -> SplitModel:
    """``model`` under a compute-precision policy (the reference's
    ``cast_to_compute``). ``"f32"`` returns it unchanged. ``"bf16"`` casts
    the param halves and the float batch inputs to bfloat16 inside each
    wrapped forward, so activations and both backward passes run in bf16
    while the master params stay float32; the cast sits inside the
    differentiated function, so every param gradient comes back float32.
    ``head_weight`` hands the LACE boundary a bf16 head: the ops read its
    float32 copy per chunk (the kernels take the bf16 operand as one exact
    TF32 term), so losses and logit adjustments stay float32, and they
    return the head's gradient in the head's dtype, rounded to bf16 once
    before ``head_grad_merge`` upcasts and adds it."""
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}; expected "
                         f"{PRECISIONS}")
    if precision == "f32":
        return model
    bf16 = torch.bfloat16

    def client_fwd(wc, batch):
        return model.client_fwd(cast_floats(wc, bf16),
                                cast_floats(batch, bf16))

    def server_fwd(ws, acts):
        return model.server_fwd(cast_floats(ws, bf16), acts)

    kw = {}
    if model.server_trunk is not None:
        kw["server_trunk"] = (
            lambda ws, acts: model.server_trunk(cast_floats(ws, bf16), acts))
    if model.head_weight is not None:
        kw["head_weight"] = (
            lambda ws: cast_floats(model.head_weight(ws), bf16))
    return dataclasses.replace(model, client_fwd=client_fwd,
                               server_fwd=server_fwd, **kw)


def default_ce_chunk(num_classes: int) -> int:
    """The plain boundary's token chunk: logits of ~2^32 elements."""
    return max(4096, (1 << 32) // max(1, num_classes))


@dataclass(frozen=True)
class MeshAxes:
    """Axis roles of the ``lace_dp`` backend: the client axis splits over
    ``client``, each client's batch over ``inner``."""

    client: tuple = ()
    inner: tuple = ()

    @property
    def all(self) -> tuple:
        return self.client + self.inner


def mesh_axes(mesh) -> MeshAxes:
    """The roles of a :class:`repro_torch.sharding.Grid`'s axes."""
    return MeshAxes(client=mesh.client_axes, inner=mesh.inner_axes)


def client_shard_count(mesh) -> int:
    """How many ways the stacked client axis splits on ``mesh``: the
    product of its client axes' sizes."""
    return mesh.n_client_shards


def _priors(labels, weights, N, scala: ScalaConfig, grid=None):
    """Stage 1: (P_k (C, N), P_s (N,)) from this step's labels; on a grid
    each client's histogram is summed over ``inner`` (its token slices),
    then the concatenated one over ``client``."""
    if grid is None:
        return client_and_concat_priors(labels, N, weights,
                                        eps=scala.prior_eps)
    hist_k = torch.stack([
        histogram(labels[c], N, None if weights is None else weights[c])
        for c in range(labels.shape[0])])
    if grid.inner_axes:
        hist_k = grid.all_reduce(hist_k, "inner")
    hist_s = hist_k.sum(0)
    if grid.client_axes:
        hist_s = grid.all_reduce(hist_s, "client")
    return prior(hist_k, scala.prior_eps), prior(hist_s, scala.prior_eps)


def shard_batch(grid, batch, specs):
    """This rank's block of every leaf of a global ``batch`` dict under
    its spec in ``specs`` (the same keys)."""
    missing = set(batch) - set(specs)
    if missing:
        raise ValueError(f"batch_specs has no spec for {sorted(missing)}")
    return {k: grid.shard(v, specs[k]) for k, v in batch.items()}


def _check(backend, boundary, precision, model, mesh=None):
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected {BACKENDS}")
    if boundary not in BOUNDARIES:
        raise ValueError(f"unknown boundary {boundary!r}; expected "
                         f"{BOUNDARIES}")
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}; expected "
                         f"{PRECISIONS}")
    if (backend == "lace_dp") != (mesh is not None):
        raise ValueError("backend 'lace_dp' requires a grid of ranks "
                         "(mesh=), and only it")
    if backend != "logits" and model.server_trunk is None:
        raise ValueError(f"backend {backend!r} needs model.server_trunk/"
                         "head_weight (fused LACE path)")


def at_least_f32(a):
    """``a`` in float32, as the reference casts, or in float64 when it
    already is (a float64 check run keeps its precision)."""
    return a.to(torch.promote_types(a.dtype, torch.float32))


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
    with the feature cotangents (C, tokens, d) in the feats' dtype and the
    head's gradient in ``w_head``'s: under the bf16 policy the ops round
    their float32 dW to bf16 once, as the reference's ops return the
    cotangent of a bf16 head (``head_grad_merge`` then upcasts it)."""
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


def _lace_dp_boundary(feats, w_head, labels, weights, p_k, p_s, scala,
                      boundary, ce_chunk, grid):
    """Stage 4 of backend ``lace_dp`` on this rank's tokens: the global
    weight denominator first (one scalar all_reduce), raw sums and their
    unit-cotangent gradients (K1 + K2, or K4 + K5 twice, on a card), the
    two loss sums in one all_reduce, then the gradients rescaled to the
    global mean in float32. No gradient goes through a collective here
    (the reference's ``lace_dp`` branch)."""
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
    wsum = (weights_g.float().sum() if weights_g is not None
            else torch.tensor(float(labels_g.numel()), device=feats.device))
    w_global = torch.clamp(grid.all_reduce(wsum.reshape(1), "all")[0],
                           min=1e-8)
    if boundary == "fused":
        nll_s, nll_k, gf_s, gf_k, gW_s, _ = ops.lace2_grads(
            feats_g, w_head, labels_g, ps_rows, None, pk_rows, pk_ids,
            weights_g, *args, mean=False)
    else:
        fg = feats_g.detach().requires_grad_()
        wh = w_head.detach().requires_grad_()
        nll_s = ops.lace_nll_sum(fg, wh, labels_g, ps_rows, None, weights_g,
                                 *args)
        gf_s, gW_s = torch.autograd.grad(nll_s, (fg, wh))
        nll_k = ops.lace_nll_sum(fg, w_head.detach(), labels_g, pk_rows,
                                 pk_ids, weights_g, *args)
        (gf_k,) = torch.autograd.grad(nll_k, fg)
    sums = grid.all_reduce(torch.stack([nll_s.detach(), nll_k.detach()])
                           .float(), "all")
    return (sums[0] / w_global, sums[1] / w_global, gf_s.float() / w_global,
            gf_k.float() / w_global, gW_s.float() / w_global)


def split_step_grads(model: SplitModel, params, batch, scala: ScalaConfig, *,
                     backend: str = "lace", boundary: str = "fused",
                     ce_chunk: Optional[int] = None, mask=None,
                     precision: str = "f32", mesh=None):
    """Stages 1-4 of the SCALA local iteration.

    params: ``{'client': stacked (C, ...), 'server': ...}``; batch leaves
    (C, B_k, ...). Returns (grads, metrics), grads mirroring params.
    ``mask`` is an optional (C,) 0/1 participation mask folded into the
    token weights: masked-out clients add nothing to the priors or the
    losses and get zero gradient. ``precision`` (:data:`PRECISIONS`)
    selects the compute policy (:func:`cast_to_compute`): under
    ``"bf16"`` stages 2-4 run in bfloat16 against the float32 master
    params; the priors, the loss reductions and the grads stay float32.
    ``mesh`` (a :class:`repro_torch.sharding.Grid`) is given iff
    ``backend == "lace_dp"``; params, batch and mask are then this rank's
    blocks and the grads come back reduced (module docstring).
    """
    _check(backend, boundary, precision, model, mesh)
    model = cast_to_compute(model, precision)
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
    p_k, p_s = _priors(labels, weights, N, scala, mesh)

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
        # the uploads the server differentiates: x, and a cross-attention
        # arch's encoder memory, each concatenated over the clients
        keys = ["x"] + (["memory"] if "memory" in client_acts[0] else [])
        ups = {k: [a[k] for a in client_acts] for k in keys}
        cat = {k: torch.cat([a.detach() for a in v]).requires_grad_()
               for k, v in ups.items()}

        # --- stage 3: one server forward on the concatenation, every
        # other activation (positions) taken from client 0, as the
        # reference closes over its first slot's ---
        ws, ws_leaves = _grad_leaves(params["server"])
        server = model.server_fwd if backend == "logits" else \
            model.server_trunk
        out, aux = server(ws, {**client_acts[0], **cat})

        # --- stage 4: both losses and cotangents at the split boundary ---
        metrics = {}
        if backend == "logits":
            loss_s, loss_k, g_s, g_k, metrics["accuracy"] = \
                _logits_boundary(out.detach(), labels, weights, p_k, p_s,
                                 scala, boundary)
        else:
            boundary_fn = (_lace_boundary if mesh is None else
                           functools.partial(_lace_dp_boundary, grid=mesh))
            loss_s, loss_k, g_s, g_k, gW_s = boundary_fn(
                out.detach(), model.head_weight(params["server"]), labels,
                weights, p_k, p_s, scala, boundary,
                default_ce_chunk(N) if ce_chunk is None else ce_chunk)
        g_s = g_s.reshape(out.shape).to(out.dtype)
        g_k = g_k.reshape(out.shape).to(out.dtype)

    # stage 4a: (P_s cotangent, 1) through (out, aux) -> d w_s, so the
    # router loss charges the server weights; (P_k cotangent, 0) -> G_k,
    # i.e. out alone. A dense arch's aux needs no grad: out alone too.
    # The memory's cotangent under P_s is not asked for (the reference
    # drops it); under P_k it is G_mem, beside G_k.
    if aux.requires_grad:
        d_ws = torch.autograd.grad((out, aux), ws_leaves,
                                   (g_s, torch.ones_like(aux)),
                                   retain_graph=True, allow_unused=True)
    else:
        d_ws = torch.autograd.grad(out, ws_leaves, g_s, retain_graph=True,
                                   allow_unused=True)
    d_ws = unflatten(params["server"], [
        torch.zeros_like(p) if g is None else g
        for p, g in zip(ws_leaves, d_ws)])
    g_up = torch.autograd.grad(out, [cat[k] for k in keys], g_k)
    if backend != "logits":
        d_ws = model.head_grad_merge(d_ws, gW_s)

    # stage 4b (eq. 9): each client pulls its own slices of G_k (and
    # G_mem) back through its own (x, memory) into the stacked (C, ...)
    # grads slot by slot, each client's freed at once (16 slots of qwen's
    # embedding grad are 10 GB)
    d_wc = [torch.empty(p.shape, dtype=p.dtype, device=p.device)
            for p in leaves(params["client"])]
    start = 0
    for c in range(C):
        n = ups["x"][c].shape[0]
        g = torch.autograd.grad([ups[k][c] for k in keys], client_trees[c],
                                [gu[start:start + n] for gu in g_up],
                                allow_unused=True)
        for out, gi in zip(d_wc, g):
            if gi is None:
                out[c].zero_()
            else:
                out[c].copy_(gi)
        start += n
        del g
    d_wc = unflatten(params["client"], d_wc)
    aux = aux.detach()
    if mesh is not None:
        # stage 4's reductions: ONE all_reduce of the server gradient tree
        # (every leaf a local partial), the client grads over ``inner``
        # (each client's tokens split there), optionally narrower on the
        # wire; aux averaged
        rdt = (dtype_of(scala.grad_reduce_dtype)
               if scala.grad_reduce_dtype else None)
        d_ws = mesh.all_reduce_tree(d_ws, "all", rdt)
        if mesh.inner_axes:
            d_wc = mesh.all_reduce_tree(d_wc, "inner", rdt)
        aux = mesh.all_reduce(aux.float().reshape(1).clone(), "all")[0] \
            / mesh.world
    metrics = {"loss_server": loss_s, "loss_client": loss_k,
               "aux": aux, **metrics}
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
                   lr, donate: bool = False) -> TrainState:
    new_s, st_s = opt.update(grads["server"], state.opt_state["server"],
                             state.params["server"], lr, donate=donate)
    new_c, st_c = opt.update(grads["client"], state.opt_state["client"],
                             state.params["client"], lr, donate=donate)
    return TrainState(params={"client": new_c, "server": new_s},
                      opt_state={"client": st_c, "server": st_s},
                      step=state.step + 1)


def _local_step_fn(model, scala, backend, boundary, opt, sched, ce_chunk,
                   precision, mesh):
    """The step on batches (and a mask) already cut to this rank."""

    def step(state: TrainState, batch, mask=None, donate=False):
        grads, metrics = split_step_grads(model, state.params, batch, scala,
                                          backend=backend, boundary=boundary,
                                          ce_chunk=ce_chunk, mask=mask,
                                          precision=precision, mesh=mesh)
        return _apply_updates(opt, state, grads, sched(state.step),
                              donate), metrics

    return step


def _dp_args(backend, mesh, batch_specs):
    if backend == "lace_dp" and (mesh is None or batch_specs is None):
        raise ValueError("backend 'lace_dp' needs mesh and batch_specs")
    return mesh if backend == "lace_dp" else None


def make_split_step(model: SplitModel, scala: ScalaConfig, *,
                    backend: str = "lace", boundary: str = "fused",
                    optimizer: Optional[optimizers.Optimizer] = None,
                    schedule: Optional[Callable] = None,
                    ce_chunk: Optional[int] = None, precision: str = "f32",
                    mesh=None, batch_specs=None):
    """The stateful step: (TrainState, batch[, mask[, donate]]) ->
    (TrainState, metrics). ``optimizer`` defaults to plain SGD (eqs. 7/9)
    and ``schedule`` to a constant ``scala.lr``, driven by ``state.step``.
    ``donate=True``: the caller never reads ``state`` again, so the
    update may overwrite it (:class:`repro_torch.optim.Optimizer`).

    ``backend="lace_dp"`` needs ``mesh`` (a Grid) and ``batch_specs``
    (a spec per batch key): the state is this rank's, the batch and the
    (C,) mask global, cut to this rank on entry."""
    grid = _dp_args(backend, mesh, batch_specs)
    _check(backend, boundary, precision, model, grid)
    opt = optimizer if optimizer is not None else optimizers.sgd()
    sched = schedule if schedule is not None else schedules.constant(scala.lr)
    step = _local_step_fn(model, scala, backend, boundary, opt, sched,
                          ce_chunk, precision, grid)
    if grid is None:
        return step

    def dp_step(state: TrainState, batch, mask=None, donate=False):
        if mask is not None:
            mask = mask[grid.client_slice(mask.shape[0])]
        return step(state, shard_batch(grid, batch, batch_specs), mask,
                    donate)

    return dp_step


def sgd_apply(params, grads, lr):
    """The paper's eq. 7 / 9 update in the params' dtype."""
    return tree_map(lambda w, g: w - lr * g.to(w.dtype), params, grads)


def local_step(model: SplitModel, params, batch, scala: ScalaConfig, *,
               backend: str = "logits", boundary: str = "fused",
               lr: Optional[float] = None, ce_chunk: Optional[int] = None,
               mesh=None, batch_specs=None, precision: str = "f32"):
    """One stateless SCALA local iteration with plain SGD (eqs. 7 / 9):
    (new params, metrics). ``backend="lace_dp"`` takes ``mesh`` and
    ``batch_specs`` as :func:`make_split_step` does (params this rank's,
    the batch global)."""
    lr = scala.lr if lr is None else lr
    grid = _dp_args(backend, mesh, batch_specs)
    if grid is not None:
        batch = shard_batch(grid, batch, batch_specs)
    grads, metrics = split_step_grads(model, params, batch, scala,
                                      backend=backend, boundary=boundary,
                                      ce_chunk=ce_chunk, precision=precision,
                                      mesh=grid)
    return sgd_apply(params, grads, lr), metrics


def _shard_mean(grid, stacked, weights):
    """The weighted mean over the global client axis of a tree whose
    leaves hold this rank's rows, ``weights`` this rank's slice of the
    normalized (C,) weights: the local partial in float32, one
    all_reduce over ``client``, rounded once to each leaf's dtype."""
    part = tree_map(lambda a: (a.float() * weights.float().reshape(
        (-1,) + (1,) * (a.dim() - 1))).sum(0), stacked)
    return tree_map(lambda m, a: m.to(a.dtype),
                    grid.all_reduce_tree(part, "client"), stacked)


def _round_boundary_opt_state(opt: optimizers.Optimizer, opt_state,
                              new_params, weights, policy: str, grid=None):
    """Client optimizer state at the round boundary; the server half's
    always carries. On a grid ``weights`` is this rank's slice."""
    if policy == "carry":
        return opt_state
    if policy == "reset":
        return {"client": _client_opt_init(opt, new_params["client"]),
                "server": opt_state["server"]}
    if grid is not None:
        means = _shard_mean(grid, opt_state["client"], weights)
        return {"client": tree_map(lambda m, a: m[None].expand(a.shape),
                                   means, opt_state["client"]),
                "server": opt_state["server"]}

    def avg(a):  # "average": aggregated like the params, in f32
        wb = weights.reshape((-1,) + (1,) * (a.dim() - 1)).float()
        m = (a.float() * wb).sum(0).to(a.dtype)
        return m[None].expand(a.shape)

    return {"client": tree_map(avg, opt_state["client"]),
            "server": opt_state["server"]}


def slot_gather_indices(mask, k_active: int):
    """Participating slot ids, ascending, from a host (C,) 0/1 mask with a
    static subset size ``k_active`` (the sparse round): the participants
    first, then, if there are fewer than ``k_active``, the lowest absent
    slots (they compute with zero aggregation weight), sorted. An int64
    numpy array."""
    on = np.asarray(mask) > 0
    idx = np.concatenate([np.flatnonzero(on), np.flatnonzero(~on)])
    return np.sort(idx[:k_active])


def gather_rows(tree, idx):
    """Rows ``idx`` (a tensor) of every (C, ...) leaf, packed into a dense
    leading axis."""
    return tree_map(lambda a: a.index_select(0, idx), tree)


def scatter_rows(full_tree, sub_tree, idx):
    """The full leaves with rows ``idx`` replaced by the dense results."""
    return tree_map(lambda f, s: f.index_copy(0, idx, s.to(f.dtype)),
                    full_tree, sub_tree)


def _gather_clients(state: TrainState, idx) -> TrainState:
    """The participating client slots packed into a dense axis (the
    server half shared)."""
    return TrainState(
        params={"client": gather_rows(state.params["client"], idx),
                "server": state.params["server"]},
        opt_state={"client": gather_rows(state.opt_state["client"], idx),
                   "server": state.opt_state["server"]},
        step=state.step)


def _scatter_clients(state: TrainState, sub: TrainState, idx) -> TrainState:
    """The dense results written back into the static slots. Absent slots
    keep their params and their optimizer state untouched (the masked
    round instead ticks absent slots' moments with zero gradients)."""
    return TrainState(
        params={"client": scatter_rows(state.params["client"],
                                       sub.params["client"], idx),
                "server": sub.params["server"]},
        opt_state={"client": scatter_rows(state.opt_state["client"],
                                          sub.opt_state["client"], idx),
                   "server": sub.opt_state["server"]},
        step=sub.step)


def make_round_runner(model: SplitModel, scala: ScalaConfig, *,
                      backend: str = "lace", boundary: str = "fused",
                      optimizer: Optional[optimizers.Optimizer] = None,
                      schedule: Optional[Callable] = None,
                      ce_chunk: Optional[int] = None, aggregate: bool = True,
                      aggregator=None, participation=None,
                      opt_state_policy: str = "carry",
                      slot_gather: bool = False, server_optimizer=None,
                      server_lr: float = 1.0, precision: str = "f32",
                      faults=None, guards=None, donate: bool = False,
                      mesh=None, batch_specs=None):
    """One synchronous round: T local steps over ``round_batches``
    (leaves (T, C, B_k, ...)), then the FL phase -- the aggregator's
    weights average the client halves, which go back to every slot, and
    ``opt_state_policy`` (carry | reset | average) fixes the client
    optimizer state; the server half's always carries.

    ``participation``: a :class:`repro_torch.fed.ParticipationScheduler`
    whose (C,) mask over the static slots is folded into every step, so
    the priors and logit adjustments are those of the participating
    subset, and into the aggregation. ``slot_gather=True`` (sparse)
    gathers the scheduler's ``subset_size`` participating slots into a
    dense axis before the local steps and scatters them back after, so
    the round computes only them; it matches the masked round but for
    the absent slots' optimizer moments, which the masked round ticks
    with zero gradients and the sparse one leaves untouched.

    ``server_optimizer``: FedOpt on the server half, the round's delta
    ``w_s_start - w_s_end`` a pseudo-gradient stepped from ``w_s_start``
    at ``server_lr`` (plain SGD at 1.0 is the round without it).

    Returns ``round_fn(state, round_batches, data_sizes=None,
    fed_state=None)``: ``(TrainState, metrics)`` without ``fed_state``
    (a stateless aggregator and scheduler, no server optimizer), else
    ``(TrainState, fed_state', metrics)`` with the dict of
    :func:`repro_torch.fed.init_fed_state`; the metrics are the last
    step's. The mask and the gather indices are drawn on the host at the
    round's start, so the round adds no device-to-host copy.

    ``faults`` (:mod:`repro_torch.fed.faults`): each round draws drop /
    corrupt / stall masks on the host from the stream in
    ``fed_state["faults"]``; dropped and stalled slots leave the mask
    before the steps, corrupted ones are rewritten after them. A sparse
    round with faults passes the gathered slots' mask into every step
    (a fill slot must not count in the priors). ``guards``
    (:mod:`repro_torch.fed.guards`): the trained client halves are
    screened against the round's start (one host copy of the accept and
    clip vectors); if any participant is rejected the local phase runs
    again from the start over the survivors, then the clipped, rejected-
    zeroed halves are averaged over the survivors. The metrics add
    ``guard_accept``, ``guard_norm`` and ``guard_rejected`` (a float).
    Guards with no fault firing leave the round bitwise unchanged.

    ``donate=True``: the caller gives the ``state`` it passes up (the
    reference's donated round), so the local steps may overwrite it from
    the first step on (:class:`repro_torch.optim.Optimizer`): the server
    half and the dense optimizer moments update in place. What the round
    still reads of its start is kept: server FedOpt's delta reads the
    start's server half, so it is copied first; the guards' screen, the
    survivor re-run and the clip read the whole start state, so a guarded
    round's first step stays functional. A sparse round trains gathered
    copies of its slots, so the absent slots' rows are never touched.
    ``donate=False`` leaves ``state`` bitwise as it was.

    ``backend="lace_dp"`` (``mesh``: a Grid, ``batch_specs``): ``state``
    is this rank's, the round batches, masks and data sizes global. The
    masked round aggregates with the global weights, each rank's partial
    summed over ``client``. The sparse round gathers in-shard: each
    client shard packs its own participating slots into a dense local
    axis of ``subset_size / n_shards``, and the FL phase is the
    aggregator's ``shard_local`` weights (the edge fold) and one sum over
    the shards (the server fold); it needs a shards-balanced scheduler
    (``uniform:FRAC:SHARDS``, SHARDS a multiple of the client shards) and
    a stateless, prior-free aggregator with ``shard_local``. Faults and
    guards are refused there, as the reference refuses them; on the
    masked ``lace_dp`` round each rank corrupts its own slots of the
    global fault draw, and the guards' screen gathers the rows' norms
    over the client shards (:func:`repro_torch.fed.guards.screen`).
    """
    from repro_torch import fed as _fed

    if opt_state_policy not in OPT_STATE_POLICIES:
        raise ValueError(f"unknown opt_state_policy {opt_state_policy!r}; "
                         f"expected {OPT_STATE_POLICIES}")
    if slot_gather:
        if participation is None:
            raise ValueError("slot_gather needs a participation scheduler "
                             "(the static K_active comes from its "
                             "subset_size)")
        if participation.subset_size is None:
            raise ValueError(
                f"slot_gather needs a scheduler with a static subset_size; "
                f"{participation.name!r} has none -- without it the gather "
                "would silently degrade to full-K masked compute")
    from repro_torch.fed import faults as _faults
    from repro_torch.fed import guards as _guards

    faults = _faults.make_faults(faults)
    guards = _guards.make_guards(guards)
    opt = optimizer if optimizer is not None else optimizers.sgd()
    agg = aggregator if aggregator is not None else _fed.weighted()
    stateful = _fed.is_stateful(agg, participation)
    if (faults is not None or guards is not None) and not aggregate:
        raise ValueError("faults/guards screen and aggregate the round's "
                         "client updates; they need aggregate=True")
    k_active = (participation.subset_size if participation is not None
                else None)
    do_gather = slot_gather and k_active < participation.num_clients
    grid = _dp_args(backend, mesh, batch_specs)
    dp_gather = do_gather and grid is not None
    robust = faults is not None or guards is not None
    if dp_gather and robust:
        raise ValueError(
            "faults/guards are not supported with the in-shard lace_dp "
            "slot_gather round (its FL phase is sharded); use the masked "
            "lace_dp round or a sparse single-program backend")
    n_shards = grid.n_client_shards if grid is not None else 1
    if dp_gather:
        shards = getattr(participation, "shards", 1)
        if shards % n_shards:
            raise ValueError(
                f"lace_dp slot_gather needs a shards-balanced participation "
                f"scheduler: scheduler shards {shards} must be a multiple "
                f"of the {n_shards} client mesh shards (use "
                f"'uniform:FRAC:{n_shards}')")
        if k_active % n_shards or participation.num_clients % n_shards:
            raise ValueError(
                f"subset size {k_active} and client count "
                f"{participation.num_clients} must divide over the "
                f"{n_shards} client shards")
        if agg.shard_local is None or agg.stateful or agg.needs_priors:
            raise ValueError(
                f"aggregator {agg.name!r} cannot run inside the sharded "
                "client axis; lace_dp slot_gather needs a stateless, "
                "prior-free, shard-decomposable aggregator (fedavg / "
                "weighted / hierarchical)")
        if opt_state_policy == "average":
            raise ValueError("opt_state_policy 'average' is not supported "
                             "with lace_dp slot_gather; use 'carry' or "
                             "'reset'")
    _check(backend, boundary, precision, model, grid)
    step = _local_step_fn(model, scala, backend, boundary, opt,
                          schedule if schedule is not None
                          else schedules.constant(scala.lr), ce_chunk,
                          precision, grid)
    rb_specs = None
    if grid is not None:
        from repro_torch.sharding import round_specs

        rb_specs = round_specs(batch_specs)

    def dp_round(start: TrainState, rb, mask_np, data_sizes, own):
        """The in-shard sparse round on this rank's client shard: its own
        participants gathered, T steps, the two-tier FL phase."""
        K = participation.num_clients
        cs = grid.client_slice(K)
        device = leaves(start.params["client"])[0].device
        mask_l = mask_np[cs]
        idx_t = torch.from_numpy(slot_gather_indices(
            mask_l, k_active // n_shards)).to(device)
        sub = _gather_clients(start, idx_t)
        metrics = None
        for t in range(leaves(rb)[0].shape[0]):
            sub, metrics = step(sub, {k: v[t].index_select(0, idx_t)
                                      for k, v in rb.items()}, None,
                                donate=own or t > 0)
        st = _scatter_clients(start, sub, idx_t)
        del sub
        if not aggregate:
            return st, metrics
        sizes = (torch.ones(K, dtype=torch.float32) if data_sizes is None
                 else data_sizes)
        sizes_l = sizes[cs].to(device).float()
        m_l = torch.from_numpy(np.asarray(mask_l, np.float32)).to(device)

        def reduce(t):
            return grid.all_reduce(t.reshape(1).clone(), "client")[0]

        raw = agg.shard_local(m_l, sizes_l, reduce, n_shards) * m_l
        w_n = raw / torch.clamp(reduce(raw.sum()), min=1e-8)
        C_l = leaves(st.params["client"])[0].shape[0]
        params = {"client": stack_client_params(
            _shard_mean(grid, st.params["client"], w_n), C_l),
            "server": st.params["server"]}
        opt_state = _round_boundary_opt_state(opt, st.opt_state, params,
                                              w_n, opt_state_policy, grid)
        return TrainState(params=params, opt_state=opt_state,
                          step=st.step), metrics

    def round_fn(state: TrainState, round_batches, data_sizes=None,
                 fed_state=None):
        if fed_state is None:
            if stateful:
                raise ValueError(
                    f"aggregator {agg.name!r} / participation scheduler are "
                    "stateful; pass fed_state (repro_torch.fed."
                    "init_fed_state)")
            if server_optimizer is not None:
                raise ValueError(
                    "server_optimizer needs fed_state -- build it with "
                    "repro_torch.fed.init_fed_state(..., server_optimizer=, "
                    "server_params=)")
            if faults is not None:
                raise ValueError(
                    "faults need fed_state['faults'] (the fault stream's "
                    "state) -- build fed_state with repro_torch.fed."
                    "init_fed_state(..., faults=...)")
            if guards is not None and guards.clip > 0:
                raise ValueError(
                    "guard norm clipping is stateful (running median) -- "
                    "build fed_state with repro_torch.fed.init_fed_state("
                    "..., guards=...)")
            sched_state, agg_state, so_state = (), (), ()
            fault_state, guard_state = None, ()
        else:
            sched_state, agg_state = fed_state["sched"], fed_state["agg"]
            so_state = fed_state.get("server_opt", ())
            if server_optimizer is not None and "server_opt" not in fed_state:
                raise ValueError(
                    "server_optimizer needs fed_state['server_opt'] -- build "
                    "fed_state with repro_torch.fed.init_fed_state(..., "
                    "server_optimizer=, server_params=)")
            fault_state = fed_state.get("faults")
            if faults is not None and fault_state is None:
                raise ValueError(
                    "faults need fed_state['faults'] -- build fed_state with "
                    "repro_torch.fed.init_fed_state(..., faults=...)")
            guard_state = fed_state.get("guard", ())
            if guards is not None and guards.clip > 0 and guard_state == ():
                raise ValueError(
                    "guard norm clipping needs fed_state['guard'] -- build "
                    "fed_state with repro_torch.fed.init_fed_state(..., "
                    "guards=...)")
        device = leaves(state.params["client"])[0].device
        # the steps may overwrite the round's start from step 0 on, unless
        # guards read it after the first pass (screen, re-run, clip)
        own = donate and guards is None
        ws_start = state.params["server"]
        if own and server_optimizer is not None:
            # FedOpt's delta reads the start's server half after the steps
            ws_start = tree_map(torch.clone, ws_start)
        start = state  # the round-start state: the re-run's and the screen's
        T = leaves(round_batches)[0].shape[0]
        C_all = leaves(state.params["client"])[0].shape[0] * n_shards
        rb = (round_batches if grid is None
              else shard_batch(grid, round_batches, rb_specs))
        cs = grid.client_slice(C_all) if grid is not None else slice(None)
        mask_np = None
        if participation is not None:
            mask_np, sched_state = participation.sample(sched_state)

        new_fault_state = fault_state
        corrupt_np = None
        if faults is not None:
            f_seed, f_count = (int(x) for x in fault_state.tolist())
            fmasks = faults.draw(f_seed, f_count, C_all)
            new_fault_state = torch.tensor([f_seed, f_count + 1],
                                           dtype=torch.int64)
            # dropped and stalled clients never deliver this round: they
            # leave the subset before the steps, so the eq. 14/15 priors
            # are the survivors'
            alive = (1.0 - fmasks["drop"]) * (1.0 - fmasks["stall"])
            mask_np = alive if mask_np is None else mask_np * alive
            corrupt_np = fmasks["corrupt"] * mask_np

        def local_phase(m_np, again=False):
            """The T local steps from ``start`` under the (C,) host mask
            ``m_np`` (None: no mask; ``again``: the guards' survivor
            re-run), then the corruption in transit: (state, metrics,
            the gathered slots or None)."""
            st, metrics, idx = start, None, None
            if do_gather:
                idx = slot_gather_indices(m_np, k_active)
                idx_t = torch.from_numpy(idx).to(device)
                # without faults or a re-run every gathered slot
                # participates: no mask in the steps; with them a fill
                # slot must not count in the priors, so the gathered
                # slots' mask goes in
                sub_mask = (torch.from_numpy(m_np[idx]).to(device)
                            if again or faults is not None else None)
                sub = _gather_clients(start, idx_t)
                for t in range(T):
                    sub, metrics = step(
                        sub, {k: v[t].index_select(0, idx_t)
                              for k, v in round_batches.items()}, sub_mask,
                        donate=own or t > 0)
                st = _scatter_clients(start, sub, idx_t)
                del sub
            else:
                mask = (None if m_np is None else
                        torch.tensor(m_np[cs], dtype=torch.float32,
                                     device=device))
                # from the second step on the state is the round's own
                # (from the first with ``own``): its update may overwrite it
                for t in range(T):
                    st, metrics = step(st, {k: v[t] for k, v in rb.items()},
                                       mask, donate=own or t > 0)
            if corrupt_np is not None:
                # the update is corrupted in transit, after training (in
                # place: these rows are the round's own)
                _faults.corrupt_update(faults, f_seed, f_count,
                                       st.params["client"], corrupt_np, cs)
            return st, metrics, idx

        agg_mask_np = mask_np
        screened = None
        new_guard_state = guard_state
        if dp_gather:
            state, metrics = dp_round(start, rb, mask_np, data_sizes, own)
        elif guards is not None:
            # a sparse round's slots outside the gather are exactly
            # unchanged: the screen reads only the gathered rows
            state, metrics, idx, screened = _guards.guarded(
                guards, guard_state, start.params["client"], mask_np, C_all,
                local_phase, grid)
            agg_mask_np, new_guard_state = screened.survivors, screened.state
        else:
            state, metrics, idx = local_phase(mask_np)

        if aggregate and not dp_gather:
            C = C_all
            p_k = p_global = None
            if agg.needs_priors:
                p_k, p_global = _fed.aggregation_priors(
                    model.num_classes, round_batches["labels"],
                    round_batches.get("weights"), client_axis=1)
            agg_mask = (None if agg_mask_np is None else
                        torch.tensor(agg_mask_np, dtype=torch.float32,
                                     device=device))
            ctx = _fed.AggContext(num_clients=C, mask=agg_mask,
                                  data_sizes=data_sizes, p_k=p_k,
                                  p_global=p_global)
            w, agg_state = agg.client_weights(ctx, agg_state)
            w = w.to(device)
            pc = state.params["client"]
            if screened is not None:
                screened.apply_(start.params["client"], pc, cs)
            if grid is None:
                avg = weighted_mean(pc, w)
            else:
                w = w[cs]
                avg = _shard_mean(grid, pc, w)
            params = {"client": stack_client_params(
                avg, leaves(pc)[0].shape[0]),
                "server": state.params["server"]}
            opt_state = _round_boundary_opt_state(
                opt, state.opt_state, params, w, opt_state_policy, grid)
            state = TrainState(params=params, opt_state=opt_state,
                               step=state.step)

        if screened is not None:
            metrics = dict(metrics, **screened.metrics)

        if server_optimizer is not None:
            # FedOpt on the server half: the round delta a pseudo-gradient
            delta = tree_map(lambda a, b: at_least_f32(a) - at_least_f32(b),
                             ws_start, state.params["server"])
            new_ws, so_state = server_optimizer.update(delta, so_state,
                                                       ws_start, server_lr)
            state = TrainState(params={"client": state.params["client"],
                                       "server": new_ws},
                               opt_state=state.opt_state, step=state.step)

        if fed_state is None:
            return state, metrics
        out_fed = {"sched": sched_state, "agg": agg_state}
        if "server_opt" in fed_state:
            out_fed["server_opt"] = so_state
        if "faults" in fed_state:
            out_fed["faults"] = (new_fault_state if faults is not None
                                 else fed_state["faults"])
        if "guard" in fed_state:
            out_fed["guard"] = (new_guard_state if guards is not None
                                else fed_state["guard"])
        return state, out_fed, metrics

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

