"""The fused dual-prior boundary (LACE) of the PyTorch port on the CPU.

The port's plain chunked ``lace2_grads`` -- what a CPU tensor gets, and
the yardstick of kernels K1/K2 on a card -- against the reference's
``lace2_grads`` and against ``jax.grad`` of the reference oracle
``lace_ref``, on the same numpy inputs: per-client prior rows picked by
id, an absent side, tau 0 and 1, weight-0 rows, N not a chunk multiple,
mean and raw sums. float32 throughout; tolerance 2e-5 relative to the
largest entry (sums in another order). The port's own ``lace_ref``
matches the reference's, and nothing launches on the CPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.lace import ops as jops
from repro.kernels.lace.ref import lace_ref as jax_lace_ref
from repro_torch.kernels.lace import ops
from repro_torch.kernels.lace.ref import lace_ref

torch.set_num_threads(1)
RTOL = 2e-5


def _inputs(seed, G, N, d, V, zero_rows):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((G, N, d), np.float32)
    w = (rng.standard_normal((d, V), np.float32) * d ** -0.5).astype(
        np.float32)
    labels = rng.integers(0, V, (G, N)).astype(np.int32)
    weights = np.ones((G, N), np.float32)
    if zero_rows:
        weights[:, -(N // 4):] = 0.0           # padding rows of a batch
        weights[G - 1] = 0.0                   # an absent client
    p_s = rng.dirichlet(np.ones(V))[None].astype(np.float32)
    p_k = rng.dirichlet(np.full(V, 0.3), size=G).astype(np.float32)
    p_k[:, :V // 5] = 0.0                      # classes a client never saw
    return feats, w, labels, weights, p_s, p_k


def _close(got, want, name):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-6)
    err = np.abs(got - want).max()
    assert err <= RTOL * scale, f"{name}: max err {err} vs scale {scale}"


CASES = [
    # (G, N, d, V, chunk, tau, sides, zero_rows, mean)
    (3, 37, 16, 61, 8, 1.0, "both", True, True),     # N % chunk != 0
    (2, 32, 8, 40, 32, 0.0, "both", False, True),    # tau = 0
    (2, 20, 16, 50, 7, 1.0, "k", True, True),        # server side absent
    (3, 24, 8, 33, 10, 0.5, "s", True, False),       # raw sums, k absent
    (1, 50, 12, 70, 64, 1.0, "both", False, False),  # one chunk > N
]


@pytest.mark.parametrize("G,N,d,V,chunk,tau,sides,zero_rows,mean", CASES)
def test_lace2_grads_matches_reference(G, N, d, V, chunk, tau, sides,
                                       zero_rows, mean):
    feats, w, labels, weights, p_s, p_k = _inputs(G * N + V, G, N, d, V,
                                                  zero_rows)
    ids = np.arange(G, dtype=np.int32)
    ps = p_s if sides in ("both", "s") else None
    pk = p_k if sides in ("both", "k") else None
    pid = ids if pk is not None else None
    jargs = [None if a is None else jnp.asarray(a)
             for a in (feats, w, labels, ps, None, pk, pid, weights)]
    want = jops.lace2_grads(*jargs, tau, 1e-8, chunk, mean)
    targs = [None if a is None else torch.from_numpy(a)
             for a in (feats, w, labels, ps, None, pk, pid, weights)]
    before = (ops.LAUNCHES_FWD, ops.LAUNCHES_BWD)
    got = ops.lace2_grads(*targs, tau, 1e-8, chunk, mean)
    assert (ops.LAUNCHES_FWD, ops.LAUNCHES_BWD) == before
    names = ("out_s", "out_k", "df_s", "df_k", "dw_s", "w_sum")
    for name, a, b in zip(names, got, want):
        assert tuple(a.shape) == tuple(b.shape), name
        _close(a.numpy(), b, name)
    if zero_rows:                               # weight-0 rows: exactly 0
        zero = weights == 0
        assert np.all(got[2].numpy()[zero] == 0)
        assert np.all(got[3].numpy()[zero] == 0)

    # the oracle: jax.grad of the materialized-logits loss per side
    flat = lambda a: a.reshape(-1, *a.shape[2:])
    for side, rows, row_ids, out, df in (
            ("s", ps, None, got[0], got[2]),
            ("k", pk, None if pk is None else np.repeat(ids, N), got[1],
             got[3])):
        def loss(f, wh):
            val = jax_lace_ref(f, wh, jnp.asarray(flat(labels)),
                               prior_rows=None if rows is None
                               else jnp.asarray(rows),
                               prior_ids=None if row_ids is None
                               else jnp.asarray(row_ids),
                               tau=tau, weights=jnp.asarray(flat(weights)))
            return val if mean else val * weights.sum()
        val, (g_f, g_w) = jax.value_and_grad(loss, argnums=(0, 1))(
            jnp.asarray(flat(feats)), jnp.asarray(w))
        _close(out.numpy(), val, f"oracle out_{side}")
        _close(flat(df.numpy()), g_f, f"oracle df_{side}")
        if side == "s":
            _close(got[4].numpy(), g_w, "oracle dw_s")


def test_port_lace_ref_matches_reference():
    feats, w, labels, weights, _, p_k = _inputs(3, 1, 30, 8, 20, True)
    ids = np.arange(30, dtype=np.int32) % 1
    want = jax_lace_ref(jnp.asarray(feats[0]), jnp.asarray(w),
                        jnp.asarray(labels[0]), prior_rows=jnp.asarray(p_k),
                        prior_ids=jnp.asarray(ids), tau=0.7,
                        weights=jnp.asarray(weights[0]))
    got = lace_ref(torch.from_numpy(feats[0]), torch.from_numpy(w),
                   torch.from_numpy(labels[0]),
                   prior_rows=torch.from_numpy(p_k),
                   prior_ids=torch.from_numpy(ids), tau=0.7,
                   weights=torch.from_numpy(weights[0]))
    _close(got.numpy(), want, "lace_ref")


def test_group_axis_mismatch_raises():
    feats, w, labels, weights, p_s, p_k = _inputs(0, 2, 8, 4, 10, False)
    t = torch.from_numpy
    with pytest.raises(ValueError, match="prior_ids must be"):
        ops.lace2_grads(t(feats), t(w), t(labels), None, None, t(p_k),
                        torch.arange(3), t(weights))
    with pytest.raises(ValueError, match="CPU or CUDA"):
        ops.lace2_grads(t(feats).to("meta"), t(w).to("meta"),
                        t(labels).to("meta"), None, None, None, None, None)
