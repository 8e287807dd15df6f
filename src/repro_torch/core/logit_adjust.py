"""Logit adjustment (paper eqs. 13-15).

The balanced class-probability argmax (eq. 13) is realized by *adding*
``tau * log P(y)`` to the logits inside the softmax cross-entropy during
training (eqs. 14/15): high-frequency classes get their logits inflated
inside the loss, so the model must push them down to reduce it --
equalizing classifier updates across frequencies (Lemma 4.3).
"""
from __future__ import annotations

import torch


def log_prior(prior, eps: float = 1e-8):
    return torch.log(prior.float() + eps)


def adjust_logits(logits, prior, tau: float = 1.0, eps: float = 1e-8):
    """logits (..., N); prior broadcastable (..., N) or (N,)."""
    return logits.float() + tau * log_prior(prior, eps)


def balanced_prediction(logits, prior, tau: float = 1.0, eps: float = 1e-8):
    """Inference-time balanced argmax (eq. 13): subtract the prior."""
    return torch.argmax(logits.float() - tau * log_prior(prior, eps), dim=-1)
