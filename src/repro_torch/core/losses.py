"""Cross-entropy and accuracy on materialized logits: what evaluation
uses. (Training's split boundary never materializes the logits:
:mod:`repro_torch.kernels.lace`; the logit-adjusted losses on
materialized logits come with the ``logits`` backend.)"""
from __future__ import annotations

import torch


def softmax_xent(logits, labels):
    """Mean softmax cross-entropy. logits (..., N); labels (...) int.
    Returns a float32 scalar."""
    z = logits.float()
    nll = (torch.logsumexp(z, dim=-1)
           - z.gather(-1, labels.long()[..., None])[..., 0])
    return nll.mean()


def accuracy(logits, labels):
    return (logits.argmax(-1) == labels).float().mean()
