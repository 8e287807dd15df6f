"""The single-prior LACE ops of the PyTorch port on the CPU: the dual
boundary's loss (K4 forward, K5 backward on a card).

* ``lace_loss`` / ``lace_nll_sum`` / ``lace_loss_flat`` -- the plain
  chunked version a CPU tensor gets -- against the reference ops under
  ``jax.value_and_grad`` on the same numpy inputs: values and the
  gradients wrt feats and w_head, with N not a chunk multiple, K prior
  rows picked by id, tau 0, a zero-weight client and bf16 feats. float32:
  2e-5 of the largest entry (sums in another order); bf16 feats: the
  same for values and dW, 1e-2 for the bf16-rounded df. The dW product
  is skipped when w_head needs no gradient, and nothing launches.
* The plain versions of K4 and K5 (``lace_fwd_plain`` /
  ``lace_bwd_plain``, the kernels' own signature: a (rows, V) table of
  tau * log(P + eps) and per-token row ids) against the Pallas kernels
  ``lace_fwd_pallas`` / ``lace_bwd_pallas`` in interpret mode, as
  ``tests/test_kernels.py`` runs them: per-token nll and lse, df and dW,
  within 1e-5 of the largest entry. The Pallas kernels take one prior
  row per call, so the K-row table is checked group by group.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.lace import ops as jops
from repro.kernels.lace.kernel import lace_bwd_pallas, lace_fwd_pallas
from repro_torch.kernels.lace import ops
from repro_torch.kernels.lace.ref import lace_bwd_plain, lace_fwd_plain

torch.set_num_threads(1)
RTOL = 2e-5


def _close(got, want, name, rtol=RTOL):
    got = np.asarray(got, np.float64)
    want = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-6)
    err = np.abs(got - want).max()
    assert err <= rtol * scale, f"{name}: max err {err} vs scale {scale}"


def _inputs(seed, G, N, d, V, zero_client=False):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((G, N, d), np.float32)
    w = (rng.standard_normal((d, V), np.float32) * d ** -0.5).astype(
        np.float32)
    labels = rng.integers(0, V, (G, N)).astype(np.int32)
    weights = np.ones((G, N), np.float32)
    weights[:, -(N // 4):] = 0.0               # padding rows of a batch
    if zero_client:
        weights[G - 1] = 0.0                   # an absent client
    rows = rng.dirichlet(np.full(V, 0.5), size=G).astype(np.float32)
    rows[:, :V // 5] = 0.0                     # classes a client never saw
    return feats, w, labels, weights, rows


CASES = [
    # (G, N, d, V, chunk, tau, prior, zero_client, feats dtype, fn)
    (3, 37, 16, 61, 8, 1.0, "rows", True, "float32", "loss"),  # N % c
    (2, 32, 8, 40, 32, 0.0, "rows", False, "float32", "loss"),  # tau = 0
    (2, 20, 16, 50, 7, 1.0, "one", True, "float32", "loss"),   # P_s row
    (3, 24, 8, 33, 10, 0.5, "rows", True, "float32", "sum"),   # raw sums
    (2, 30, 12, 45, 16, 1.0, None, False, "float32", "sum"),   # plain CE
    (2, 26, 16, 70, 8, 1.0, "rows", True, "bfloat16", "loss"),  # bf16
]


@pytest.mark.parametrize("G,N,d,V,chunk,tau,prior,zero_client,dtype,fn",
                         CASES)
def test_lace_loss_matches_reference(G, N, d, V, chunk, tau, prior,
                                     zero_client, dtype, fn):
    feats, w, labels, weights, rows = _inputs(G * N + V, G, N, d, V,
                                              zero_client)
    pr = {"rows": rows, "one": rows[:1], None: None}[prior]
    ids = np.arange(G, dtype=np.int32) if prior == "rows" else None
    jfn = {"loss": jops.lace_loss, "sum": jops.lace_nll_sum}[fn]
    tfn = {"loss": ops.lace_loss, "sum": ops.lace_nll_sum}[fn]

    def jloss(f, wh):
        return jfn(f, wh, jnp.asarray(labels),
                   None if pr is None else jnp.asarray(pr),
                   None if ids is None else jnp.asarray(ids),
                   jnp.asarray(weights), tau, 1e-8, chunk)

    jf = jnp.asarray(feats).astype(dtype)
    want, (jdf, jdw) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jf, jnp.asarray(w))
    tdt = getattr(torch, dtype)
    f = torch.from_numpy(np.array(jf.astype(jnp.float32))).to(tdt)
    f.requires_grad_()
    wh = torch.from_numpy(w).requires_grad_()
    before = (ops.LAUNCHES_FWD1, ops.LAUNCHES_BWD1)
    got = tfn(f, wh, torch.from_numpy(labels),
              None if pr is None else torch.from_numpy(pr),
              None if ids is None else torch.from_numpy(ids),
              torch.from_numpy(weights), tau, 1e-8, chunk)
    df, dw = torch.autograd.grad(got, (f, wh))
    assert (ops.LAUNCHES_FWD1, ops.LAUNCHES_BWD1) == before
    assert df.dtype == tdt and dw.dtype == torch.float32
    _close(got.item(), want, "value")
    _close(df.float().numpy(), jdf, "dfeats",
           1e-2 if dtype == "bfloat16" else RTOL)
    _close(dw.numpy(), jdw, "dw")
    if zero_client:                            # weight-0 rows: exactly 0
        assert torch.all(df[torch.from_numpy(weights) == 0] == 0)

    # no head gradient asked: the same df, and no dW computed
    loss2 = tfn(f, wh.detach(), torch.from_numpy(labels),
                None if pr is None else torch.from_numpy(pr),
                None if ids is None else torch.from_numpy(ids),
                torch.from_numpy(weights), tau, 1e-8, chunk)
    (df2,) = torch.autograd.grad(loss2, f)
    assert torch.equal(df2, df)


def test_lace_loss_flat_matches_reference():
    feats, w, labels, weights, rows = _inputs(4, 1, 29, 8, 23)
    rid = np.int32(0)
    kw = dict(prior_rows=rows, prior_ids=rid, weights=weights[0], tau=0.8,
              chunk=8)
    want, (jdf, jdw) = jax.value_and_grad(
        lambda f, wh: jops.lace_loss_flat(
            f, wh, jnp.asarray(labels[0]),
            **{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
               for k, v in kw.items()}), argnums=(0, 1))(
        jnp.asarray(feats[0]), jnp.asarray(w))
    f = torch.from_numpy(feats[0]).requires_grad_()
    wh = torch.from_numpy(w).requires_grad_()
    got = ops.lace_loss_flat(
        f, wh, torch.from_numpy(labels[0]),
        **{k: torch.from_numpy(np.asarray(v)) if isinstance(
            v, (np.ndarray, np.integer)) else v for k, v in kw.items()})
    df, dw = torch.autograd.grad(got, (f, wh))
    _close(got.item(), want, "value")
    _close(df.numpy(), jdf, "dfeats")
    _close(dw.numpy(), jdw, "dw")


def test_lace_loss_group_axis_mismatch_raises():
    feats, w, labels, weights, rows = _inputs(0, 2, 8, 4, 10)
    t = torch.from_numpy
    with pytest.raises(ValueError, match="prior_ids must be"):
        ops.lace_loss(t(feats), t(w), t(labels), t(rows), torch.arange(3),
                      t(weights))
    # meta tensors get the shape function; a mix of devices raises
    with pytest.raises(ValueError, match="CPU or CUDA"):
        ops.lace_loss(t(feats).to("meta"), t(w), t(labels).to("meta"),
                      None, None, None)
    loss = ops.lace_loss(t(feats).to("meta"), t(w).to("meta"),
                         t(labels).to("meta"), None, None, None)
    assert loss.device.type == "meta" and loss.shape == ()


@pytest.mark.parametrize("N,d,V,tb,vb,tau", [
    (64, 16, 64, 32, 16, 1.0),
    (100, 32, 130, 64, 64, 1.0),     # N and V not tile multiples
    (57, 24, 64, 32, 32, 0.0),       # tau = 0 (V a tile multiple: the
                                     # Pallas kernel's -inf padding of the
                                     # prior masks nothing at tau = 0)
])
def test_plain_k4_k5_match_pallas_interpret(N, d, V, tb, vb, tau):
    G = 3
    feats, w, labels, weights, rows = _inputs(N + V, G, N, d, V)
    f2 = feats.reshape(G * N, d)
    lab = labels.reshape(-1)
    ids = np.repeat(np.arange(G, dtype=np.int32), N)
    ts = (weights / weights.sum()).reshape(-1).astype(np.float32)
    log_rows = np.log(rows + 1e-8).astype(np.float32)
    adj = torch.from_numpy(tau * log_rows)
    t = torch.from_numpy
    nll, lse = lace_fwd_plain(t(f2), t(w), t(lab), adj, t(ids))
    df, dw = lace_bwd_plain(t(f2), t(w), t(lab), adj, t(ids), lse, t(ts))
    want_dw = np.zeros((d, V), np.float32)
    for g in range(G):                 # one prior row per Pallas call
        sl = slice(g * N, (g + 1) * N)
        jnll, jlse = lace_fwd_pallas(jnp.asarray(f2[sl]), jnp.asarray(w),
                                     jnp.asarray(lab[sl]),
                                     jnp.asarray(log_rows[g]), tau=tau,
                                     tb=tb, vb=vb)
        _close(nll[sl].numpy(), jnll, f"nll group {g}", 1e-5)
        _close(lse[sl].numpy(), jlse, f"lse group {g}", 1e-5)
        jdf, jdw = lace_bwd_pallas(jnp.asarray(f2[sl]), jnp.asarray(w),
                                   jnp.asarray(lab[sl]),
                                   jnp.asarray(log_rows[g]), jlse,
                                   jnp.asarray(ts[sl]), tau=tau, tb=tb,
                                   vb=vb)
        _close(df[sl].numpy(), jdf, f"df group {g}", 1e-5)
        want_dw += np.asarray(jdw)
    _close(dw.numpy(), want_dw, "dW", 1e-5)
    # without dW: the same df, no dW
    df2, dw2 = lace_bwd_plain(t(f2), t(w), t(lab), adj, t(ids), lse, t(ts),
                              want_dw=False)
    assert dw2 is None and torch.equal(df2, df)
