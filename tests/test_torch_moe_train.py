"""MoE training in the PyTorch port against the reference, on the CPU:
the split step. (The rounds, the masked round, a mamba + MoE hybrid and
the CLIs are in ``test_torch_moe_train_rounds.py``, which shares these
helpers; the two files run on two workers.)

The same params (the reference's init, each client slot perturbed so the
slots differ) and the same numpy batches through both packages:

* ``split_step_grads`` on ``helpers.tiny_moe_cfg`` (an MoE FFN in every
  layer, one client layer, two server layers) at the helper's capacity
  factor 2.0 and at a tight 0.5, where each row of the concatenated
  server batch drops (token, k) pairs; backend ``lace`` fused and dual,
  and ``logits`` fused. The losses and ``aux`` within 1e-5 relative,
  every grad leaf within 1e-4 of its largest entry (float32 sums in
  another order), the engine tests' bars.
* The same step at ``router_aux_weight = 10``, where the router loss
  dominates the server routers' gradient: the reference's stage 4a pulls
  (g_s, 1) through (out, aux), so the router loss charges the server
  weights. A stage 4a that pulls back ``out`` alone misses that term.
* No client leaf gets a router-loss gradient: the client grads at
  ``router_aux_weight`` 10 equal those at 0 bitwise (the client half's
  aux is dropped and G_k is pulled with aux's cotangent 0), while every
  server router's grad moves.

Top-k routing is a discontinuous function of the router logits: each
comparison asserts that the nearest gap between a token's top_k-th and
(top_k+1)-th logit, over every routing of the port's run, stays above
``GAP_MIN``, so a near-tie that float32 rounding could flip is named, not
hidden in a grad mismatch.
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import tiny_mamba_cfg, tiny_moe_cfg
from repro.configs.base import MoEConfig as JMoEConfig
from repro.configs.base import ScalaConfig as JScala
from repro.core import engine as jengine
from repro.core.scala import transformer_split_model as j_split_model
from repro.models import transformer as JT
from repro_torch import convert
from repro_torch.configs.base import MambaConfig as TMambaConfig
from repro_torch.configs.base import ModelConfig as TModelConfig
from repro_torch.configs.base import MoEConfig as TMoEConfig
from repro_torch.configs.base import ScalaConfig as TScala
from repro_torch.core import engine
from repro_torch.core.scala import transformer_split_model
from repro_torch.models.layers import moe
from repro_torch.tree import leaves

torch.set_num_threads(1)
LEAF_RTOL, LOSS_RTOL = 1e-4, 1e-5
GAP_MIN = 1e-4


def _port_cfg(cfg):
    sub = {"moe": TMoEConfig, "mamba": TMambaConfig}
    fields = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if f.name in sub and v is not None:
            v = sub[f.name](**dataclasses.asdict(v))
        fields[f.name] = v
    return TModelConfig(**fields)


def _moe(cf=2.0, aux=0.01):
    return JMoEConfig(num_experts=4, top_k=2, d_expert=48,
                      capacity_factor=cf, router_aux_weight=aux)


CONFIGS = {
    "moe": lambda cf, aux, **kw: tiny_moe_cfg(**kw) if (cf, aux) == (
        2.0, 0.01) else dataclasses.replace(tiny_moe_cfg(**kw),
                                            moe=_moe(cf, aux)),
    "mamba-moe": lambda cf, aux, **kw: tiny_mamba_cfg(
        ffn_pattern=("moe",), moe=_moe(cf, aux), **kw),
}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _setup(name="moe", cf=2.0, aux=0.01, C=2, Bk=2, S=16, T=2, seed=0,
           **kw):
    """(reference cfg, numpy stacked params with distinct slots, numpy
    round batches (T, C, Bk, S), sizes)."""
    cfg = CONFIGS[name](cf, aux, **kw)
    params = jengine.init_scala_params(
        jax.random.PRNGKey(seed), lambda k: JT.init_params(k, cfg)["client"],
        lambda k: JT.init_params(k, cfg)["server"], C)
    rng = np.random.default_rng(seed)
    params = jax.tree.map(lambda a: (np.asarray(a, np.float32) + 0.02 * (
        rng.standard_normal(a.shape).astype(np.float32))).astype(a.dtype),
        _np(params))
    toks = rng.integers(0, cfg.vocab_size, (T, C, Bk, S + 1))
    weights = np.ones((T, C, Bk, S), np.float32)
    weights[:, -1, -1, S // 2:] = 0.0            # an eq. 3 padding tail
    batches = {"tokens": toks[..., :-1].astype(np.int32),
               "labels": toks[..., 1:].astype(np.int32), "weights": weights}
    sizes = np.array([5.0, 3.0, 2.0, 4.0][:C], np.float32)
    return cfg, params, batches, sizes


def _flat(tree):
    """Leaves in sorted-key order, whichever framework built the dicts."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k])]
    return [tree]


def _num(a):
    return (a.detach().float().numpy() if isinstance(a, torch.Tensor)
            else np.asarray(a, np.float32)).astype(np.float64)


def _bf16_order(t):
    """bf16 bit patterns as integers in the order of the values, so that
    neighbouring bf16 values differ by 1."""
    i = t.contiguous().view(torch.int16).int()
    return torch.where(i < 0, -(i & 0x7FFF), i)


def _close_tree(got, want, what, rtol=LEAF_RTOL, bf16_ulps=None):
    """Every leaf within ``rtol`` of its largest entry; with ``bf16_ulps``,
    every entry of a bf16 leaf within that many bf16 ulps of its own
    value."""
    g, w = _flat(got), _flat(want)
    assert len(g) == len(w), (what, len(g), len(w))
    for i, (a, b) in enumerate(zip(g, w)):
        if bf16_ulps is not None and a.dtype == torch.bfloat16:
            assert b.dtype == torch.bfloat16, (what, i, b.dtype)
            ulps = int((_bf16_order(a) - _bf16_order(b)).abs().max())
            assert ulps <= bf16_ulps, (what, i, ulps)
            continue
        a, b = _num(a), _num(b)
        assert a.shape == b.shape, (what, i, a.shape, b.shape)
        err = np.abs(a - b).max()
        assert err <= rtol * max(np.abs(b).max(), 1e-6), (what, i, err,
                                                          np.abs(b).max())


def _close(a, b, what, rtol=LOSS_RTOL):
    a, b = float(a), float(b)
    assert abs(a - b) <= rtol * max(abs(b), 1e-6), (what, a, b)


@contextlib.contextmanager
def _gaps_above(min_gap=GAP_MIN):
    """Asserts, on leaving, that every routing of the port's run kept the
    gap between each token's top_k-th and (top_k+1)-th router logit above
    ``min_gap`` (and that some routing ran)."""
    gaps, orig = [], moe.route

    def route(params, x, m):
        top = (x.detach().float() @ params["router"].detach().float()).topk(
            m.top_k + 1).values
        gaps.append(float((top[..., -2] - top[..., -1]).min()))
        return orig(params, x, m)

    moe.route = route
    try:
        yield gaps
    finally:
        moe.route = orig
    assert gaps and min(gaps) > min_gap, ("near-tied router logits",
                                         min(gaps))


def _step_pair(cfg, params, batch, backend, boundary, C=2):
    """(port grads, port metrics, reference grads, reference metrics)."""
    pcfg = _port_cfg(cfg)
    scala = dict(num_clients=C, tau=1.0)
    want, wm = jax.jit(lambda p, b: jengine.split_step_grads(
        j_split_model(cfg), p, b, JScala(**scala), backend=backend,
        boundary=boundary))(jax.tree.map(jnp.asarray, params),
                            jax.tree.map(jnp.asarray, batch))
    with _gaps_above():
        got, gm = engine.split_step_grads(
            transformer_split_model(pcfg),
            convert.train_params_from_reference(params, pcfg),
            {k: _t(v) for k, v in batch.items()}, TScala(**scala),
            backend=backend, boundary=boundary)
    return got, gm, convert.train_params_from_reference(_np(want), pcfg), wm


def check_step(name, cf, backend, boundary, aux):
    """The split step, port against reference: losses, aux, every grad."""
    cfg, params, batches, _ = _setup(name, cf, aux)
    batch = {k: v[0] for k, v in batches.items()}
    got, gm, want, wm = _step_pair(cfg, params, batch, backend, boundary)
    for key in ("loss_server", "loss_client", "aux"):
        _close(gm[key], wm[key], key)
    assert float(wm["aux"]) > 0
    _close_tree(got, want, "grads")


# (capacity factor, backend, boundary, router_aux_weight)
STEP_CASES = [(cf, backend, boundary, 0.01) for cf in (2.0, 0.5)
              for backend, boundary in (("lace", "fused"), ("lace", "dual"),
                                        ("logits", "fused"))]
STEP_CASES.append((0.5, "lace", "fused", 10.0))


@pytest.mark.parametrize("cf,backend,boundary,aux", STEP_CASES)
def test_split_step_matches_reference(cf, backend, boundary, aux):
    check_step("moe", cf, backend, boundary, aux)


def test_tight_capacity_drops_pairs_of_the_server_batch():
    """At capacity factor 0.5 (4 slab rows an expert a batch row of 16
    tokens, top 2 of 4) the server's routing keeps fewer pairs than it
    routes; at 2.0 it keeps all of them."""
    kept = {}
    orig = moe.capacity
    for cf in (2.0, 0.5):
        cfg, params, batches, _ = _setup("moe", cf)
        pcfg = _port_cfg(cfg)
        caps = []

        def capacity(n, m):
            caps.append(orig(n, m))
            return caps[-1]

        seen = []
        route = moe.route

        def counting(p, x, m):
            out = route(p, x, m)
            top_i = out[2].reshape(x.shape[0], -1)
            counts = torch.stack([(top_i == e).sum(1)
                                  for e in range(m.num_experts)], 1)
            seen.append(int(counts.clamp(max=caps[-1]).sum()))
            seen.append(int(counts.sum()))
            return out

        moe.capacity, moe.route = capacity, counting
        try:
            p = convert.train_params_from_reference(params, pcfg)
            engine.split_step_grads(
                transformer_split_model(pcfg), p,
                {k: _t(v[0]) for k, v in batches.items()},
                TScala(num_clients=2))
        finally:
            moe.capacity, moe.route = orig, route
        # routings: 2 clients x layer 0, then the server's layers 1, 2
        kept[cf] = seen[4:]
    assert all(k == r for k, r in zip(kept[2.0][::2], kept[2.0][1::2]))
    assert all(k < r for k, r in zip(kept[0.5][::2], kept[0.5][1::2]))


def test_no_client_leaf_gets_a_router_loss_gradient():
    runs = {}
    for aux in (0.0, 10.0):
        cfg, params, batches, _ = _setup("moe", 0.5, aux)
        pcfg = _port_cfg(cfg)
        runs[aux] = engine.split_step_grads(
            transformer_split_model(pcfg),
            convert.train_params_from_reference(params, pcfg),
            {k: _t(v[0]) for k, v in batches.items()},
            TScala(num_clients=2, tau=1.0))
    (g0, m0), (g1, m1) = runs[0.0], runs[10.0]
    assert float(m0["aux"]) == 0.0 and float(m1["aux"]) > 0
    assert all(torch.equal(a, b) for a, b in zip(leaves(g0["client"]),
                                                 leaves(g1["client"])))
    for l in ("blk1", "blk2"):
        r0 = g0["server"]["blocks"][l]["ffn"]["router"]
        r1 = g1["server"]["blocks"][l]["ffn"]["router"]
        assert float((r1 - r0).abs().max()) > 0.1 * float(r0.abs().max()), l


