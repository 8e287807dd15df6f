"""The LACE pair ops (``lace2_loss``, ``lace2_nll_sum``) of the port on
the CPU.

Both adjusted losses of the same tokens from one pass, as one autograd
function whose backward folds the two cotangents into one df and one dW
(the reference's ``kernels/lace/ops.py:lace2_loss`` / ``lace2_nll_sum``).
On the same numpy inputs they are held, in float32 to 2e-5 of the largest
entry (sums in another order):

* to the port's materialized oracle ``lace_ref`` per side, values and
  the autograd gradients of ``a * out_s + b * out_k``;
* to the reference's pair ops, values and ``jax.grad`` of the same
  combination;
* to the port's own ``lace2_grads``: out_s / out_k equal, df the sum of
  its two feature cotangents at unit cotangents (the raw-sum pair is not
  held to the reference's bitwise claim, which its own test fails).

Nothing launches a kernel on the CPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.lace import ops as jops
from repro_torch.kernels.lace import ops
from repro_torch.kernels.lace.ref import lace_ref

torch.set_num_threads(1)
RTOL = 2e-5
A, B = 0.7, -1.3          # the two cotangents the backward folds


def _inputs(seed, G, N, d, V):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((G, N, d), np.float32)
    w = (rng.standard_normal((d, V), np.float32) * d ** -0.5).astype(
        np.float32)
    labels = rng.integers(0, V, (G, N)).astype(np.int32)
    weights = np.ones((G, N), np.float32)
    weights[:, -(N // 4):] = 0.0
    p_s = rng.dirichlet(np.ones(V))[None].astype(np.float32)
    p_k = rng.dirichlet(np.full(V, 0.3), size=G).astype(np.float32)
    return feats, w, labels, weights, p_s, p_k


def _close(got, want, name):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-6)
    err = np.abs(got - want).max()
    assert err <= RTOL * scale, f"{name}: max err {err} vs scale {scale}"


CASES = [
    # (G, N, d, V, chunk, tau, sides, mean)
    (3, 37, 16, 61, 8, 1.0, "both", True),       # N % chunk != 0
    (2, 24, 8, 40, 24, 0.0, "both", False),      # tau = 0, raw sums
    (2, 20, 16, 50, 7, 1.0, "k", True),          # server side absent
    (3, 24, 8, 33, 10, 0.5, "s", False),         # client side absent
]


def _args(sides, G, p_s, p_k):
    ids = np.arange(G, dtype=np.int32)
    ps = p_s if sides in ("both", "s") else None
    pk = p_k if sides in ("both", "k") else None
    return ps, (ids if pk is not None else None), pk


@pytest.mark.parametrize("G,N,d,V,chunk,tau,sides,mean", CASES)
def test_pair_ops_match_oracle_and_reference(G, N, d, V, chunk, tau, sides,
                                             mean):
    feats, w, labels, weights, p_s, p_k = _inputs(G + N + V, G, N, d, V)
    ps, pid, pk = _args(sides, G, p_s, p_k)
    op, jop = ((ops.lace2_loss, jops.lace2_loss) if mean
               else (ops.lace2_nll_sum, jops.lace2_nll_sum))

    f = torch.from_numpy(feats).requires_grad_()
    wh = torch.from_numpy(w).requires_grad_()
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    before = (ops.LAUNCHES_FWD, ops.LAUNCHES_BWD)
    out_s, out_k = op(f, wh, t(labels), t(ps), None, t(pk), t(pid),
                      t(weights), tau, 1e-8, chunk)
    (A * out_s + B * out_k).backward()
    assert (ops.LAUNCHES_FWD, ops.LAUNCHES_BWD) == before

    # the port's oracle, per side, through autograd
    f2 = torch.from_numpy(feats).requires_grad_()
    w2 = torch.from_numpy(w).requires_grad_()
    flat = lambda a: a.reshape(-1, *a.shape[2:])            # noqa: E731
    scale = 1.0 if mean else float(weights.sum())
    refs = []
    for rows, row_ids in ((ps, None),
                          (pk, None if pk is None else np.repeat(pid, N))):
        refs.append(scale * lace_ref(
            flat(f2), w2, torch.from_numpy(flat(labels)),
            prior_rows=t(rows), prior_ids=t(row_ids), tau=tau,
            weights=torch.from_numpy(flat(weights))))
    (A * refs[0] + B * refs[1]).backward()
    _close(out_s.detach(), refs[0].detach(), "oracle out_s")
    _close(out_k.detach(), refs[1].detach(), "oracle out_k")
    _close(f.grad, f2.grad, "oracle df")
    _close(wh.grad, w2.grad, "oracle dW")

    # the reference's pair op
    jargs = [None if a is None else jnp.asarray(a)
             for a in (labels, ps, None, pk, pid, weights)]

    def comb(ff, ww):
        s, k = jop(ff, ww, *jargs, tau, 1e-8, chunk)
        return A * s + B * k, (s, k)

    (_, (js, jk)), (jdf, jdw) = jax.value_and_grad(
        comb, argnums=(0, 1), has_aux=True)(jnp.asarray(feats),
                                            jnp.asarray(w))
    _close(out_s.detach(), js, "reference out_s")
    _close(out_k.detach(), jk, "reference out_k")
    _close(f.grad, jdf, "reference df")
    _close(wh.grad, jdw, "reference dW")


@pytest.mark.parametrize("mean", [True, False])
def test_pair_values_and_unit_df_match_lace2_grads(mean):
    G, N, d, V = 2, 30, 8, 25
    feats, w, labels, weights, p_s, p_k = _inputs(9, G, N, d, V)
    ps, pid, pk = _args("both", G, p_s, p_k)
    targs = [torch.from_numpy(a) if a is not None else None
             for a in (labels, ps, None, pk, pid, weights)]
    f = torch.from_numpy(feats).requires_grad_()
    op = ops.lace2_loss if mean else ops.lace2_nll_sum
    out_s, out_k = op(f, torch.from_numpy(w), *targs, 1.0, 1e-8, 16)
    (out_s + out_k).backward()
    want = ops.lace2_grads(torch.from_numpy(feats), torch.from_numpy(w),
                           *targs, 1.0, 1e-8, 16, mean=mean)
    assert torch.equal(out_s.detach(), want[0])
    assert torch.equal(out_k.detach(), want[1])
    _close(f.grad, (want[2] + want[3]), "df_s + df_k")


def test_pair_ops_reject_mixed_devices_and_bad_shapes():
    feats, w, labels, weights, p_s, p_k = _inputs(1, 2, 8, 4, 10)
    f, wh = torch.from_numpy(feats), torch.from_numpy(w)
    with pytest.raises(ValueError, match="prior_ids"):
        ops.lace2_loss(f, wh, torch.from_numpy(labels), None, None,
                       torch.from_numpy(p_k), torch.arange(3),
                       torch.from_numpy(weights))
    with pytest.raises(ValueError, match="labels"):
        ops.lace2_nll_sum(f, wh, torch.from_numpy(labels[:1]), None, None,
                          None, None, None)
