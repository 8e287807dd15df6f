"""The port's losses and logit adjustment against the JAX reference on the
CPU (``repro_torch.core.{losses,logit_adjust}`` vs ``repro.core``).

Same numpy logits, labels, weights and priors through both:
``softmax_xent`` (prior, tau, label smoothing, weights; value and
gradient), ``dual_adjusted_xent`` (both losses and both logit
gradients), ``accuracy`` (weighted and not), ``per_class_accuracy`` and
the logit-adjust helpers. float32; values and gradients within 1e-5 of
the largest entry (sums in another order), accuracies exact. Inside the
port, ``dual_adjusted_xent`` equals two autograd passes of
``softmax_xent`` bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import logit_adjust as jla
from repro.core import losses as jlosses
from repro_torch.core import logit_adjust, losses

torch.set_num_threads(1)
RTOL = 1e-5


def _close(got, want, name, rtol=RTOL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-6)
    err = np.abs(got - want).max()
    assert err <= rtol * scale, f"{name}: max err {err} vs scale {scale}"


def _inputs(seed, shape=(6, 5), N=11, weighted=True):
    rng = np.random.default_rng(seed)
    logits = (3 * rng.standard_normal(shape + (N,))).astype(np.float32)
    labels = rng.integers(0, N, shape).astype(np.int32)
    weights = None
    if weighted:
        weights = (rng.random(shape) > 0.3).astype(np.float32)
    prior_s = rng.dirichlet(np.ones(N)).astype(np.float32)
    prior_k = rng.dirichlet(np.full(N, 0.4), size=shape[0]).astype(
        np.float32)[:, None, :]
    prior_k[:, :, : N // 4] = 0.0                 # classes never seen
    return logits, labels, weights, prior_s, prior_k


def _j(a):
    return None if a is None else jnp.asarray(a)


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("prior,tau,ls,weighted", [
    (None, 1.0, 0.0, False),
    ("s", 1.0, 0.0, True),
    ("k", 1.3, 0.0, True),
    ("s", 0.0, 0.0, False),                       # tau = 0
    ("k", 1.0, 0.1, True),                        # label smoothing
    (None, 1.0, 0.2, False),
])
def test_softmax_xent_matches_reference(prior, tau, ls, weighted):
    logits, labels, weights, p_s, p_k = _inputs(7, weighted=weighted)
    pr = {None: None, "s": p_s, "k": p_k}[prior]
    kw = dict(tau=tau, label_smoothing=ls)

    def jloss(lg):
        return jlosses.softmax_xent(lg, _j(labels), weights=_j(weights),
                                    prior=_j(pr), **kw)

    want, jgrad = jax.value_and_grad(jloss)(jnp.asarray(logits))
    lg = _t(logits).requires_grad_()
    got = losses.softmax_xent(lg, _t(labels), weights=_t(weights),
                              prior=_t(pr), **kw)
    (grad,) = torch.autograd.grad(got, lg)
    assert got.dtype == torch.float32 and got.dim() == 0
    _close(got.item(), float(want), "loss")
    _close(grad.numpy(), jgrad, "grad")


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("sides", ["both", "s", "k"])
def test_dual_adjusted_xent_matches_reference(weighted, sides):
    logits, labels, weights, p_s, p_k = _inputs(3, weighted=weighted)
    ps = p_s if sides in ("both", "s") else None
    pk = p_k if sides in ("both", "k") else None
    want = jlosses.dual_adjusted_xent(
        jnp.asarray(logits), _j(labels), weights=_j(weights),
        prior_s=_j(ps), prior_k=_j(pk), tau=1.2)
    got = losses.dual_adjusted_xent(
        _t(logits), _t(labels), weights=_t(weights), prior_s=_t(ps),
        prior_k=_t(pk), tau=1.2)
    for name, a, b in zip(("loss_s", "loss_k", "g_s", "g_k"), got, want):
        _close(a.numpy(), b, name)

    # inside the port: the fused mirror == two autograd passes, bitwise
    for loss, grad, prior in ((got[0], got[2], ps), (got[1], got[3], pk)):
        lg = _t(logits).requires_grad_()
        ref = losses.softmax_xent(lg, _t(labels), weights=_t(weights),
                                  prior=_t(prior), tau=1.2)
        (ref_grad,) = torch.autograd.grad(ref, lg)
        assert torch.equal(loss, ref.detach())
        assert torch.equal(grad, ref_grad)
    with pytest.raises(ValueError, match="label_smoothing"):
        losses.dual_adjusted_xent(_t(logits), _t(labels), label_smoothing=0.1)


def test_accuracies_match_reference():
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((40, 7)).astype(np.float32)
    labels = rng.integers(0, 6, 40).astype(np.int64)   # class 6 absent
    logits[np.arange(20), labels[:20]] += 3.0           # half made right
    weights = rng.integers(0, 3, 40).astype(np.float32)
    for w in (None, weights):
        want = jlosses.accuracy(jnp.asarray(logits), jnp.asarray(labels),
                                _j(w))
        got = losses.accuracy(_t(logits), _t(labels), _t(w))
        _close(got.item(), float(want), "accuracy", rtol=1e-6)
    want = jlosses.per_class_accuracy(jnp.asarray(logits),
                                      jnp.asarray(labels), 7)
    got = losses.per_class_accuracy(_t(logits), _t(labels), 7)
    _close(got.item(), float(want), "per_class_accuracy", rtol=1e-6)
    # 2-d labels (tokens) flatten the same way
    want = jlosses.per_class_accuracy(jnp.asarray(logits.reshape(4, 10, 7)),
                                      jnp.asarray(labels.reshape(4, 10)), 7)
    got = losses.per_class_accuracy(_t(logits.reshape(4, 10, 7)),
                                    _t(labels.reshape(4, 10)), 7)
    _close(got.item(), float(want), "per_class_accuracy 2-d", rtol=1e-6)


def test_logit_adjust_matches_reference():
    logits, _, _, p_s, p_k = _inputs(11)
    for prior in (p_s, p_k):
        _close(logit_adjust.log_prior(_t(prior)).numpy(),
               jla.log_prior(jnp.asarray(prior)), "log_prior")
        _close(logit_adjust.adjust_logits(_t(logits), _t(prior), 0.7)
               .numpy(), jla.adjust_logits(jnp.asarray(logits),
                                           jnp.asarray(prior), 0.7),
               "adjust_logits")
        np.testing.assert_array_equal(
            logit_adjust.balanced_prediction(_t(logits), _t(prior), 0.7)
            .numpy(), np.asarray(jla.balanced_prediction(
                jnp.asarray(logits), jnp.asarray(prior), 0.7)))
