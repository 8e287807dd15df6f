"""Cross-entropy losses on materialized logits (plain and logit-adjusted)
and accuracies: the ``logits`` backend of the split step and evaluation.
(The ``lace`` backend never materializes the logits:
:mod:`repro_torch.kernels.lace`.)

:func:`dual_adjusted_xent` is the fused flavor of the ``logits``
boundary: both adjusted losses and their logit gradients in one pass. It
repeats, op for op, what autograd does for :func:`softmax_xent` (same
forward ops, the same backward products in the same order), so with
``label_smoothing == 0`` its float32 values and gradients equal two
``torch.autograd.grad`` passes bit for bit.
"""
from __future__ import annotations

import torch

from repro_torch.core.logit_adjust import adjust_logits


def _side(logits, labels, prior, tau, label_smoothing, prior_eps, weights):
    """One adjusted-CE side's forward: (loss, its intermediates). The
    log-sum-exp is jax's (a max shift that is finite or 0, detached),
    spelled out so that :func:`_side_grad` can mirror its backward."""
    z = logits.float()
    if prior is not None:
        z = adjust_logits(z, prior, tau, prior_eps)
    amax = z.detach().amax(dim=-1)
    amax = torch.where(torch.isfinite(amax), amax, torch.zeros_like(amax))
    exp_a = torch.exp(z - amax[..., None])
    sumexp = exp_a.sum(dim=-1)
    lse = torch.log(sumexp) + amax
    idx = labels.long()[..., None]
    nll = lse - z.gather(-1, idx)[..., 0]
    ls = label_smoothing
    if ls > 0.0:
        nll = (1 - ls) * nll + ls * (lse - z.mean(dim=-1))
    if weights is None:
        loss = nll.mean()
    else:
        w = weights.float()
        loss = (nll * w).sum() / torch.clamp(w.sum(), min=1e-8)
    return loss, (exp_a, sumexp, idx)


def softmax_xent(logits, labels, *, weights=None, prior=None,
                 tau: float = 1.0, label_smoothing: float = 0.0,
                 prior_eps: float = 1e-8):
    """Weighted-mean softmax cross-entropy with an optional logit
    adjustment. logits (..., N); labels (...) int; weights (...) or None;
    prior (N,) or broadcastable to (..., N) -- the eq. 14 / 15
    adjustment. Returns a float32 scalar."""
    loss, _ = _side(logits, labels, prior, tau, label_smoothing, prior_eps,
                    weights)
    return loss


def _token_cotangent(labels, weights):
    """d loss / d nll of the weighted mean with a unit loss cotangent, as
    autograd computes it: ``1 / size`` (mean) or ``weights * (1 / max(sum,
    eps))``."""
    if weights is None:
        one = torch.ones(labels.shape, dtype=torch.float32,
                         device=labels.device)
        return one / labels.numel()
    w = weights.float()
    return (torch.ones((), dtype=torch.float32, device=w.device)
            / torch.clamp(w.sum(), min=1e-8)) * w


def _side_grad(stats, cw):
    """d loss / d logits of one side (``label_smoothing == 0``) from its
    forward intermediates: the exp path, then the label's -d nll added
    where the gather picked it."""
    exp_a, sumexp, idx = stats
    g = (cw / sumexp)[..., None] * exp_a
    return g.scatter_add_(-1, idx, -cw[..., None])


def dual_adjusted_xent(logits, labels, *, weights=None, prior_s=None,
                       prior_k=None, tau: float = 1.0,
                       label_smoothing: float = 0.0,
                       prior_eps: float = 1e-8):
    """Both SCALA losses (eq. 14 with ``prior_s``, eq. 15 with
    ``prior_k``) and their logit gradients, from one pass over shared
    logits: ``(loss_s, loss_k, g_s, g_k)``, the gradients in
    ``logits.dtype``. Takes ``label_smoothing == 0`` only (the engine
    runs the smoothed objective through two autograd passes, as the
    reference does)."""
    if label_smoothing != 0.0:
        raise ValueError("dual_adjusted_xent mirrors the unsmoothed "
                         "backward; use two softmax_xent gradients for "
                         "label_smoothing > 0")
    cw = _token_cotangent(labels, weights)
    out = []
    for prior in (prior_s, prior_k):
        loss, stats = _side(logits, labels, prior, tau, 0.0, prior_eps,
                            weights)
        out.append((loss, _side_grad(stats, cw).to(logits.dtype)))
    (loss_s, g_s), (loss_k, g_k) = out
    return loss_s, loss_k, g_s, g_k


def accuracy(logits, labels, weights=None):
    correct = (logits.argmax(-1) == labels).float()
    if weights is None:
        return correct.mean()
    w = weights.float()
    return (correct * w).sum() / torch.clamp(w.sum(), min=1e-8)


def per_class_accuracy(logits, labels, num_classes: int):
    """Balanced (macro-averaged) accuracy -- the paper's motivating
    metric: the mean over the classes present of each class's
    accuracy."""
    pred = logits.argmax(-1).reshape(-1)
    lab = labels.reshape(-1).long()
    correct = (pred == lab).float()
    hits = torch.zeros(num_classes, device=logits.device).index_add_(
        0, lab, correct)
    counts = torch.zeros(num_classes, device=logits.device).index_add_(
        0, lab, torch.ones_like(correct))
    per_class = hits / torch.clamp(counts, min=1.0)
    present = (counts > 0).float()
    return (per_class * present).sum() / torch.clamp(present.sum(), min=1.0)
