"""The port's federation layer against the JAX reference on the CPU.

* The schedulers (``repro_torch.fed.participation``): subset sizes, 0/1
  masks, the ``[seed, count]`` state, shards-balanced blocks, the spec
  parser (the assertions of ``tests/test_fed.py``; the masks themselves
  are the port's own numpy draws, not the reference's).
* The aggregators: every one's weights against the reference's on the
  same contexts (masks, sizes, priors; 1e-6 relative), and the
  reference's behavioural assertions (bias compensation, staleness ages,
  hierarchical tiers); the aggregation priors.
* The round (``core.engine.make_round_runner``) with the reference's
  masks injected: the masks are drawn by ``repro.fed.uniform`` from the
  fed state's key, exactly as the reference round draws them, and given
  to the port through a scheduler built from them here. Masked and sparse
  rounds of AlexNet (``logits``, width 0.125) and reduced qwen1.5-0.5b
  (``lace``) with ``bias_compensated`` and ``staleness_weighted``,
  momentum locally and server adamw, two rounds: losses within 1e-5
  relative, every leaf of the state (params, optimizer state) and of the
  fed state (ages, the server moments) within 1e-4 of its largest entry
  (float32 sums in another order). The server adamw runs at eps 1e-3:
  its first step is delta / (|delta| + eps), so at the default 1e-8 an
  entry whose delta is float32 noise would flip its step's sign, which
  says nothing about the round.
* Within the port: sparse == masked at the reference's own tolerances
  (losses rtol 1e-6, params atol 1e-6 rtol 1e-5), the masked step ==
  the step on the re-stacked subset, the opt-state policies with a mask,
  server FedOpt and the FL baselines' FedOpt and prior-aware aggregation.
"""
import dataclasses
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import tiny_cfg
from repro import configs as jcfgs
from repro import fed as jfed
from repro.configs.base import ScalaConfig as JScala
from repro.core import baselines as JB
from repro.core import engine as jengine
from repro.core.scala import alexnet_split_model as j_alexnet_model
from repro.core.scala import transformer_split_model as j_tf_model
from repro.models import alexnet as JA
from repro.models import transformer as JT
from repro.optim import optimizers as jopt
from repro_torch import convert
from repro_torch import fed
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig as TModelConfig
from repro_torch.configs.base import ScalaConfig
from repro_torch.core import baselines as B
from repro_torch.core import engine
from repro_torch.core.label_stats import client_and_concat_priors
from repro_torch.core.scala import (alexnet_split_model,
                                    transformer_split_model)
from repro_torch.core.split import normalize_client_weights
from repro_torch.optim import optimizers
from repro_torch.tree import leaves, tree_map

torch.set_num_threads(1)
LEAF_RTOL, LOSS_RTOL = 1e-4, 1e-5
SERVER_EPS, SERVER_LR = 1e-3, 0.01


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _flat(tree):
    """Leaves in sorted-key order, whichever framework built the dicts."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _flat(v)]
    return [tree]


def _num(a):
    return (a.detach().numpy() if isinstance(a, torch.Tensor)
            else np.asarray(a)).astype(np.float64)


def _close_tree(got, want, what, rtol=LEAF_RTOL, atol=0.0):
    """Every leaf within ``rtol`` of its largest entry (plus ``atol``)."""
    g, w = _flat(got), _flat(want)
    assert len(g) == len(w), (what, len(g), len(w))
    for i, (a, b) in enumerate(zip(g, w)):
        a, b = _num(a), _num(b)
        assert a.shape == b.shape, (what, i, a.shape, b.shape)
        err = np.abs(a - b).max()
        assert err <= rtol * max(np.abs(b).max(), 1e-6) + atol, (
            what, i, err, np.abs(b).max())


def _close(a, b, what, rtol=LOSS_RTOL):
    a, b = float(a), float(b)
    assert abs(a - b) <= rtol * max(abs(b), 1e-6), (what, a, b)


def _chip_smoke():
    """``chip_smoke.py`` at the repo's root as a module (its scheduler of
    recorded masks, shared with the card's checks)."""
    path = os.path.join(os.path.dirname(__file__), "..", "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_recorded = _chip_smoke().recorded_scheduler


# --------------------------------------------------------------------------
# participation schedulers
# --------------------------------------------------------------------------


def test_full_scheduler_is_all_ones_and_stateless():
    part = fed.full(5)
    assert not part.stateful and part.subset_size == 5
    mask, state = part.sample(part.init(0))
    np.testing.assert_array_equal(mask, np.ones(5))
    assert state == ()


@pytest.mark.parametrize("frac,m", [(0.5, 4), (0.25, 2), (0.01, 1)])
def test_uniform_scheduler_subset_size(frac, m):
    part = fed.uniform(8, frac)
    assert part.subset_size == m == jfed.uniform(8, frac).subset_size
    state = part.init(3)
    masks = []
    for r in range(6):
        mask, state = part.sample(state)
        assert mask.dtype == np.float32 and mask.sum() == m
        assert set(np.unique(mask)) <= {0.0, 1.0}
        masks.append(mask)
        # the state: the seed and the count of draws, an int64 CPU tensor
        assert state.dtype == torch.int64 and state.device.type == "cpu"
        assert state.tolist() == [3, r + 1]
    assert any(not np.array_equal(masks[0], mk) for mk in masks[1:])


def test_scheduler_deterministic_given_state():
    for part in (fed.uniform(8, 0.5), fed.dirichlet(8, 0.5)):
        m1, s1 = part.sample(part.init(3))
        m2, _ = part.sample(part.init(3))
        np.testing.assert_array_equal(m1, m2)
        # a restored state continues the same draws
        m3, _ = part.sample(s1)
        m4, _ = part.sample(torch.tensor([3, 1]))
        np.testing.assert_array_equal(m3, m4)


def test_dirichlet_scheduler_subset_size():
    part = fed.dirichlet(10, 0.3, alpha=0.2)
    assert part.subset_size == 3 == jfed.dirichlet(10, 0.3).subset_size
    state = part.init(1)
    for _ in range(4):
        mask, state = part.sample(state)
        assert mask.sum() == 3 and set(np.unique(mask)) <= {0.0, 1.0}


def test_dirichlet_ties_go_to_the_lower_slot(monkeypatch):
    """The reference's lax.top_k rule: of equal scores, the lower slot id.
    Equal gamma draws and zero Gumbel noise make every score equal."""

    class Equal:
        def __init__(self, seed):
            pass

        def gamma(self, a, size):
            return np.ones(size)

        def gumbel(self, size):
            return np.zeros(size)

    part = fed.dirichlet(6, 0.5)
    monkeypatch.setattr(np.random, "default_rng", Equal)
    mask, _ = part.sample(part.init(0))
    np.testing.assert_array_equal(mask, [1, 1, 1, 0, 0, 0])


def test_make_participation_specs():
    assert fed.make_participation("full", 8).name == "full"
    p = fed.make_participation("uniform:0.25", 8)
    assert p.name == "uniform" and p.num_clients == 8
    assert fed.make_participation("dirichlet:0.5:1.0", 8).name == "dirichlet"
    with pytest.raises(ValueError, match="unknown participation"):
        fed.make_participation("nope", 8)
    with pytest.raises(ValueError, match="uniform spec"):
        fed.make_participation("uniform", 8)
    with pytest.raises(ValueError, match="dirichlet spec"):
        fed.make_participation("dirichlet:0.5:1:2", 8)


def test_uniform_shards_balanced_blocks():
    part = fed.make_participation("uniform:0.5:4", 16)
    assert part.shards == 4 and part.subset_size == 8
    state = part.init(0)
    for _ in range(5):
        mask, state = part.sample(state)
        np.testing.assert_array_equal(mask.reshape(4, 4).sum(1),
                                      np.full(4, 2))
    for C, frac, shards in ((16, 0.3, 4), (8, 0.5, 1), (12, 0.2, 3)):
        assert fed.uniform(C, frac, shards=shards).subset_size == \
            jfed.uniform(C, frac, shards=shards).subset_size
    assert fed.make_participation("uniform:0.25", 8).shards == 1
    with pytest.raises(ValueError, match="shards"):
        fed.uniform(6, 0.5, shards=4)


# --------------------------------------------------------------------------
# aggregators: the reference's weights on the same contexts
# --------------------------------------------------------------------------


AGG_CASES = ("fedavg", "weighted", "bias_compensated",
             "bias_compensated:0.5", "staleness_weighted",
             "staleness_weighted:0.3", "hierarchical:2",
             "hierarchical:4:fedavg:fedavg", "hierarchical:2:weighted:fedavg")


@pytest.mark.parametrize("spec", AGG_CASES)
def test_aggregator_weights_match_reference(spec):
    rng = np.random.default_rng(len(spec))
    C, N = 8, 5
    ja, ta = jfed.make_aggregator(spec), fed.make_aggregator(spec)
    assert (ta.name, ta.needs_priors, ta.stateful) == (
        ja.name, ja.needs_priors, ja.stateful)
    js, ts = ja.init(C), ta.init(C)
    for r in range(3):
        mask = (rng.random(C) < 0.5).astype(np.float32)
        if r == 2:
            mask[:] = 0.0                       # nobody: the fallback
        sizes = rng.integers(0, 5, C).astype(np.float32)
        labels = rng.integers(0, N, (2, C, 6))
        weights = (rng.random((2, C, 6)) < 0.8).astype(np.float32)
        jp = jfed.aggregation_priors(N, jnp.asarray(labels),
                                     jnp.asarray(weights), client_axis=1)
        tp = fed.aggregation_priors(N, _t(labels), _t(weights),
                                    client_axis=1)
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
        jw, js = ja.client_weights(jfed.AggContext(
            num_clients=C, mask=jnp.asarray(mask), data_sizes=jnp.asarray(
                sizes), p_k=jp[0], p_global=jp[1]), js)
        tw, ts = ta.client_weights(fed.AggContext(
            num_clients=C, mask=_t(mask), data_sizes=_t(sizes), p_k=tp[0],
            p_global=tp[1]), ts)
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6,
                                   atol=1e-7)
        assert np.isfinite(tw.numpy()).all()
        if ta.stateful:
            np.testing.assert_array_equal(ts["age"].numpy(),
                                          np.asarray(js["age"]))


def test_weighted_and_fedavg_aggregate():
    stacked = {"w": torch.arange(4.0).reshape(4, 1)}
    sizes = torch.tensor([5.0, 1.0, 2.0, 2.0])
    avg, _ = fed.weighted().aggregate(stacked, fed.AggContext(
        num_clients=4, data_sizes=sizes))
    torch.testing.assert_close(avg["w"], torch.tensor([(0 + 1 + 4 + 6)
                                                        / 10.0]))
    avg, _ = fed.fedavg().aggregate(stacked, fed.AggContext(
        num_clients=4, mask=torch.tensor([1.0, 0.0, 1.0, 0.0]),
        data_sizes=torch.full((4,), 9.0)))
    torch.testing.assert_close(avg["w"], torch.tensor([1.0]))


def test_bias_compensated_downweights_skewed_client():
    p_k = torch.tensor([[0.5, 0.5], [1.0, 0.0]])
    p_global = torch.tensor([0.5, 0.5])
    agg = fed.bias_compensated(gamma=2.0)
    assert agg.needs_priors
    w, _ = agg.client_weights(fed.AggContext(num_clients=2, p_k=p_k,
                                             p_global=p_global), ())
    assert w[0] > w[1] > 0 and abs(float(w.sum()) - 1.0) < 1e-6
    w0, _ = fed.bias_compensated(gamma=0.0).client_weights(
        fed.AggContext(num_clients=2, p_k=p_k, p_global=p_global,
                       data_sizes=torch.tensor([1.0, 3.0])), ())
    torch.testing.assert_close(w0, torch.tensor([0.25, 0.75]))
    with pytest.raises(ValueError, match="priors"):
        agg.client_weights(fed.AggContext(num_clients=2), ())


def test_staleness_weighted_ages_and_decay():
    agg = fed.staleness_weighted(decay=0.5)
    assert agg.stateful
    state = agg.init(3)
    np.testing.assert_array_equal(state["age"].numpy(), np.zeros(3))
    one = torch.tensor([1.0, 0.0, 0.0])
    w, state = agg.client_weights(fed.AggContext(num_clients=3, mask=one),
                                  state)
    torch.testing.assert_close(w, torch.tensor([1.0, 0.0, 0.0]))
    np.testing.assert_array_equal(state["age"].numpy(), [0.0, 1.0, 1.0])
    _, state = agg.client_weights(fed.AggContext(num_clients=3, mask=one),
                                  state)
    np.testing.assert_array_equal(state["age"].numpy(), [0.0, 2.0, 2.0])
    w, state = agg.client_weights(
        fed.AggContext(num_clients=3, mask=torch.ones(3)), state)
    torch.testing.assert_close(w, torch.tensor([1.0, 0.25, 0.25]) / 1.5)
    np.testing.assert_array_equal(state["age"].numpy(), np.zeros(3))


def test_hierarchical_tiers():
    mask = torch.tensor([1, 0, 1, 1, 0, 1, 1, 1], dtype=torch.float32)
    sizes = torch.arange(1.0, 9.0)
    ctx = fed.AggContext(num_clients=8, mask=mask, data_sizes=sizes)
    w_f, _ = fed.weighted().client_weights(ctx, ())
    for edges in (1, 2, 4, 8):       # weighted / weighted == flat weighted
        w_h, _ = fed.hierarchical(edges).client_weights(ctx, ())
        torch.testing.assert_close(w_h, w_f, atol=1e-6, rtol=0)
    mask = torch.tensor([1, 1, 1, 1, 0, 0, 1, 1], dtype=torch.float32)
    sizes = torch.tensor([100.0, 100.0, 1.0, 1.0, 50.0, 50.0, 1.0, 1.0])
    w, _ = fed.hierarchical(4, top="fedavg").client_weights(
        fed.AggContext(num_clients=8, mask=mask, data_sizes=sizes), ())
    torch.testing.assert_close(w.reshape(4, 2).sum(1),
                               torch.tensor([1 / 3, 1 / 3, 0.0, 1 / 3]))
    w, _ = fed.hierarchical(2).client_weights(fed.AggContext(
        num_clients=4, mask=torch.zeros(4), data_sizes=torch.ones(4)), ())
    assert torch.isfinite(w).all() and abs(float(w.sum()) - 1.0) < 1e-6


def test_hierarchical_spec_and_validation():
    assert fed.make_aggregator("hierarchical:4").name == "hierarchical"
    assert fed.make_aggregator("hierarchical:2:fedavg:fedavg").name == \
        "hierarchical"
    with pytest.raises(ValueError, match="tiers"):
        fed.hierarchical(2, edge="nope")
    with pytest.raises(ValueError, match="edges"):
        fed.hierarchical(0)
    with pytest.raises(ValueError, match="divide"):
        fed.hierarchical(3).client_weights(
            fed.AggContext(num_clients=4, mask=torch.ones(4)), ())
    with pytest.raises(ValueError):
        fed.make_aggregator("hierarchical")


def test_make_aggregator_registry():
    for name in fed.AGGREGATORS:
        spec = "hierarchical:2" if name == "hierarchical" else name
        assert fed.make_aggregator(spec).name == name
    assert fed.make_aggregator("staleness").name == "staleness_weighted"
    assert fed.make_aggregator("bias_compensated:0").name == \
        "bias_compensated"
    assert fed.make_aggregator("staleness_weighted:0.25").name == \
        "staleness_weighted"
    with pytest.raises(ValueError, match="unknown aggregator"):
        fed.make_aggregator("nope")
    with pytest.raises(ValueError, match="takes no spec arguments"):
        fed.make_aggregator("fedavg:2")


def test_init_fed_state():
    part, agg = fed.uniform(4, 0.5), fed.staleness_weighted()
    assert fed.is_stateful(agg, None) and fed.is_stateful(None, part)
    assert not fed.is_stateful(fed.weighted(), fed.full(4))
    fs = fed.init_fed_state(5, agg, part)
    assert fs["sched"].tolist() == [5, 0]
    np.testing.assert_array_equal(fs["agg"]["age"].numpy(), np.zeros(4))
    so = optimizers.adamw()
    fs = fed.init_fed_state(5, server_optimizer=so,
                            server_params={"w": torch.ones(3)})
    assert fs["sched"] == () and fs["agg"] == ()
    assert set(fs["server_opt"]) == {"mu", "nu", "count"}
    with pytest.raises(ValueError, match="server_params"):
        fed.init_fed_state(0, server_optimizer=so)
    with pytest.raises(ValueError, match="num_clients"):
        fed.init_fed_state(0, agg)
    # the fault stream's [seed, count] and, for a clipping policy, the
    # guards' running median
    fs = fed.init_fed_state(5, faults="drop:0.1", guards="clip:2")
    assert fs["faults"].tolist() == [5, 0] and set(fs["guard"]) == {"med",
                                                                   "n"}
    assert fed.init_fed_state(0, guards="nonfinite")["guard"] == ()


# --------------------------------------------------------------------------
# priors over the participating subset
# --------------------------------------------------------------------------


def test_masked_priors_equal_subset_priors():
    rng = np.random.default_rng(4)
    C, Bk, N = 5, 16, 7
    labels = _t(rng.integers(0, N, (C, Bk)))
    weights = torch.ones(C, Bk)
    mask = torch.tensor([1.0, 0.0, 1.0, 1.0, 0.0])
    sub = torch.tensor([0, 2, 3])
    p_k_m, p_s_m = client_and_concat_priors(labels, N,
                                            weights * mask[:, None])
    p_k_s, p_s_s = client_and_concat_priors(labels[sub], N, weights[sub])
    torch.testing.assert_close(p_s_m, p_s_s, atol=1e-7, rtol=0)
    torch.testing.assert_close(p_k_m[sub], p_k_s, atol=1e-7, rtol=0)
    # a masked-out client's prior is the uniform one
    torch.testing.assert_close(p_k_m[1], torch.full((N,), 1.0 / N))


def test_baseline_aggregation_priors_exclude_padded_rows():
    labels = torch.tensor([[[2, 2, 0, 0]], [[1, 1, 1, 1]]])  # (C=2, T=1, 4)
    weights = torch.tensor([[[1.0, 1.0, 0.0, 0.0]], [[1.0, 1.0, 1.0, 1.0]]])
    p_k, p_global = B._aggregation_priors(3, {"labels": labels,
                                              "weights": weights})
    torch.testing.assert_close(p_k[0], torch.tensor([0.0, 0.0, 1.0]))
    torch.testing.assert_close(p_global,
                               torch.tensor([0.0, 4.0 / 6.0, 2.0 / 6.0]))
    p_k_u, _ = B._aggregation_priors(3, {"labels": labels})
    assert float(p_k_u[0, 0]) > 0
    jp = JB._aggregation_priors(3, {"labels": jnp.asarray(labels.numpy()),
                                    "weights": jnp.asarray(weights.numpy())})
    for a, b in zip((p_k, p_global), jp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)


# --------------------------------------------------------------------------
# the round: AlexNet (logits) and reduced qwen (lace), from the
# reference's params, with the reference's masks
# --------------------------------------------------------------------------


def _port_cfg(cfg):
    return TModelConfig(**{f.name: getattr(cfg, f.name)
                           for f in dataclasses.fields(cfg)
                           if f.name not in ("moe", "mamba", "xlstm")})


def _setup(arch, C=4, Bk=3, T=2, seed=0):
    """(reference model, port model, port cfg, numpy stacked params with
    distinct slots, numpy round batches (T, C, Bk, ...), sizes)."""
    rng = np.random.default_rng(seed)
    if arch == "alexnet":
        full = JA.init_params(jax.random.PRNGKey(seed), num_classes=10,
                              width=0.125)
        wc, ws = JA.split_params(full, "s2")
        params = {"client": jax.tree.map(
            lambda a: np.broadcast_to(a[None], (C,) + a.shape), wc),
            "server": ws}
        batches = {"x": rng.standard_normal((T, C, Bk, 32, 32, 3)).astype(
            np.float32), "labels": rng.integers(0, 10, (T, C, Bk)).astype(
                np.int32)}
        models = (j_alexnet_model("s2", num_classes=10),
                  alexnet_split_model("s2", num_classes=10))
        pcfg = get_config("alexnet-cifar")
        shape = (T, C, Bk)
    else:
        name = {"qwen": "qwen1.5-0.5b", "whisper": "whisper-tiny"}[arch]
        cfg = dataclasses.replace(jcfgs.get_config(name).reduced(),
                                  vocab_size=97)
        if cfg.pos_embed == "learned":
            cfg = dataclasses.replace(cfg, max_position=64)
        params = jengine.init_scala_params(
            jax.random.PRNGKey(seed),
            lambda k: JT.init_params(k, cfg)["client"],
            lambda k: JT.init_params(k, cfg)["server"], C)
        S = 8
        toks = rng.integers(0, cfg.vocab_size, (T, C, Bk, S + 1))
        batches = {"tokens": toks[..., :-1].astype(np.int32),
                   "labels": toks[..., 1:].astype(np.int32)}
        if cfg.frontend == "audio":
            # each slot's own encoder memory, gathered with its tokens
            batches["memory_emb"] = (0.1 * rng.standard_normal(
                (T, C, Bk, cfg.num_prefix_tokens, cfg.frontend_dim))
            ).astype(np.float32)
        models = (j_tf_model(cfg), None)
        pcfg = _port_cfg(cfg)
        models = (models[0], transformer_split_model(pcfg))
        shape = (T, C, Bk, S)
    params = jax.tree.map(
        lambda a: np.asarray(a) + 0.02 * rng.standard_normal(a.shape).astype(
            np.float32), _np(params))
    weights = np.ones(shape, np.float32)
    weights[:, -1, -1] = 0.0                   # an eq. 3 padding row
    batches["weights"] = weights
    sizes = np.array([5.0, 3.0, 2.0, 4.0][:C], np.float32)
    return models, pcfg, params, batches, sizes


def _backend(arch):
    return "logits" if arch == "alexnet" else "lace"


PARITY_CASES = [(arch, mode, agg) for arch in ("alexnet", "qwen")
                for mode in ("masked", "sparse")
                for agg in ("bias_compensated", "staleness_weighted")]


@pytest.mark.parametrize("arch,mode,agg_name", PARITY_CASES)
def test_round_matches_reference_with_injected_masks(arch, mode, agg_name):
    C, rounds = 4, 2
    (jm, tm), pcfg, params, batches, sizes = _setup(arch, C=C)
    backend = _backend(arch)
    ja, ta = jfed.make_aggregator(agg_name), fed.make_aggregator(agg_name)
    jpart = jfed.uniform(C, 0.5)
    js_opt, ts_opt = jopt.adamw(eps=SERVER_EPS), optimizers.adamw(
        eps=SERVER_EPS)
    jparams = jax.tree.map(jnp.asarray, params)
    jfs = jfed.init_fed_state(jax.random.PRNGKey(7), ja, jpart,
                              server_optimizer=js_opt,
                              server_params=jparams["server"])
    masks, sched = [], jfs["sched"]
    for _ in range(rounds):           # the masks the reference round draws
        m, sched = jpart.sample(sched)
        masks.append(np.asarray(m))
    assert all(m.sum() == 2 for m in masks)
    gather = mode == "sparse"
    jround = jax.jit(jengine.make_round_runner(
        jm, JScala(num_clients=C, lr=0.05), backend=backend,
        optimizer=jopt.momentum(0.9), aggregator=ja, participation=jpart,
        slot_gather=gather, server_optimizer=js_opt, server_lr=SERVER_LR,
        unroll=True))
    tpart = _recorded(masks)
    tround = engine.make_round_runner(
        tm, ScalaConfig(num_clients=C, lr=0.05), backend=backend,
        optimizer=optimizers.momentum(0.9), aggregator=ta,
        participation=tpart, slot_gather=gather, server_optimizer=ts_opt,
        server_lr=SERVER_LR)
    js = jengine.init_train_state(jparams, jopt.momentum(0.9))
    ts = convert.train_state_from_reference(_np(js), pcfg)
    tfs = fed.init_fed_state(0, ta, tpart, server_optimizer=ts_opt,
                             server_params=ts.params["server"])
    jb = jax.tree.map(jnp.asarray, batches)
    tb = {k: _t(v) for k, v in batches.items()}
    for r in range(rounds):
        js, jfs, jmet = jround(js, jb, jnp.asarray(sizes), jfs)
        ts, tfs, tmet = tround(ts, tb, _t(sizes), tfs)
        for key in ("loss_server", "loss_client"):
            _close(tmet[key], jmet[key], f"round {r} {key}")
    want = convert.train_state_from_reference(_np(js), pcfg)
    assert ts.step == want.step == rounds * 2
    _close_tree(ts.params, want.params, "params")
    _close_tree(ts.opt_state, want.opt_state, "opt state")
    half = convert._halves(pcfg)[1]
    _close_tree(tfs["server_opt"], convert._opt_half(
        _np(jfs["server_opt"]), half, pcfg, "cpu"), "server adamw state")
    if ta.stateful:
        np.testing.assert_array_equal(tfs["agg"]["age"].numpy(),
                                      np.asarray(jfs["agg"]["age"]))
        assert tfs["agg"]["age"].max() > 0
    assert int(tfs["sched"]) == rounds
    for a in leaves(ts.params["client"]):        # slots re-unified
        assert torch.equal(a[0], a[1])


@pytest.mark.parametrize("mode", ["masked", "sparse"])
def test_frontend_round_matches_reference(mode):
    """Reduced whisper, each slot with its own audio memory, through the
    masked round and the sparse gather (the reference's masks injected,
    bias_compensated, momentum; no server optimizer: FedOpt's state is the
    difference of two float32 params, and the cross-attention norms'
    round deltas sit near their ulps) against the reference's round:
    losses, params and optimizer state."""
    C, rounds = 4, 2
    (jm, tm), pcfg, params, batches, sizes = _setup("whisper", C=C)
    assert "memory_emb" in batches
    ja, ta = jfed.bias_compensated(), fed.bias_compensated()
    jpart = jfed.uniform(C, 0.5)
    jfs = jfed.init_fed_state(jax.random.PRNGKey(7), ja, jpart)
    masks, sched = [], jfs["sched"]
    for _ in range(rounds):
        m, sched = jpart.sample(sched)
        masks.append(np.asarray(m))
    gather = mode == "sparse"
    jround = jax.jit(jengine.make_round_runner(
        jm, JScala(num_clients=C, lr=0.05), backend="lace",
        optimizer=jopt.momentum(0.9), aggregator=ja, participation=jpart,
        slot_gather=gather, unroll=True))
    tpart = _recorded(masks)
    tround = engine.make_round_runner(
        tm, ScalaConfig(num_clients=C, lr=0.05), backend="lace",
        optimizer=optimizers.momentum(0.9), aggregator=ta,
        participation=tpart, slot_gather=gather)
    js = jengine.init_train_state(jax.tree.map(jnp.asarray, params),
                                  jopt.momentum(0.9))
    ts = convert.train_state_from_reference(_np(js), pcfg)
    tfs = fed.init_fed_state(0, ta, tpart)
    jb = jax.tree.map(jnp.asarray, batches)
    tb = {k: _t(v) for k, v in batches.items()}
    for r in range(rounds):
        js, jfs, jmet = jround(js, jb, jnp.asarray(sizes), jfs)
        ts, tfs, tmet = tround(ts, tb, _t(sizes), tfs)
        for key in ("loss_server", "loss_client"):
            _close(tmet[key], jmet[key], f"round {r} {key}")
    want = convert.train_state_from_reference(_np(js), pcfg)
    assert ts.step == want.step == rounds * 2
    _close_tree(ts.params, want.params, "params")
    _close_tree(ts.opt_state, want.opt_state, "opt state")
    for a in leaves(ts.params["client"]):        # slots re-unified
        assert torch.equal(a[0], a[1])


def _alexnet_port(C=4, Bk=3, T=3, seed=5):
    (_, tm), pcfg, params, batches, sizes = _setup("alexnet", C=C, Bk=Bk,
                                                   T=T, seed=seed)
    return (tm, convert.train_params_from_reference(params, pcfg),
            {k: _t(v) for k, v in batches.items()}, _t(sizes))


def test_masked_step_equals_substacked_step():
    """The masked step == the step on the re-stacked participating subset:
    losses, server grads, the participants' client grads; an absent
    client gets exactly zero gradient."""
    model, params, rb, _ = _alexnet_port()
    batch = {k: v[0] for k, v in rb.items()}
    sc = ScalaConfig(lr=0.05)
    mask = torch.tensor([1.0, 0.0, 1.0, 0.0])
    sub = torch.tensor([0, 2])
    g_m, m_m = engine.split_step_grads(model, params, batch, sc,
                                       backend="logits", mask=mask)
    g_s, m_s = engine.split_step_grads(
        model, {"client": tree_map(lambda a: a[sub], params["client"]),
                "server": params["server"]},
        {k: v[sub] for k, v in batch.items()}, sc, backend="logits")
    for key in ("loss_server", "loss_client"):
        _close(m_m[key], m_s[key], key, rtol=1e-6)
    _close_tree(g_m["server"], g_s["server"], "server grads", rtol=0,
                atol=1e-6)
    _close_tree(tree_map(lambda a: a[sub], g_m["client"]), g_s["client"],
                "client grads", rtol=0, atol=1e-6)
    for g in leaves(g_m["client"]):
        assert float(g[torch.tensor([1, 3])].abs().max()) == 0.0


@pytest.mark.parametrize("arch", ["alexnet", "qwen"])
def test_masked_round_runs_and_unifies_slots(arch):
    """uniform(0.5) + bias_compensated through the port's own scheduler:
    finite losses and params, the slots re-unified, the step count."""
    (_, tm), pcfg, params, batches, sizes = _setup(arch)
    agg, part = fed.bias_compensated(), fed.uniform(4, 0.5)
    runner = engine.make_round_runner(
        tm, ScalaConfig(lr=0.05), backend=_backend(arch), aggregator=agg,
        participation=part)
    state = engine.init_train_state(
        convert.train_params_from_reference(params, pcfg), optimizers.sgd())
    fs = fed.init_fed_state(1, agg, part)
    for _ in range(2):
        state, fs, metrics = runner(state, {k: _t(v) for k, v in
                                            batches.items()}, None, fs)
    assert state.step == 4 and fs["sched"].tolist() == [1, 2]
    assert np.isfinite(float(metrics["loss_server"]))
    assert np.isfinite(float(metrics["loss_client"]))
    assert all(bool(torch.isfinite(a).all()) for a in leaves(state.params))
    for a in leaves(state.params["client"]):
        assert torch.equal(a[0], a[1])


def test_stateful_runner_requires_fed_state():
    model, params, rb, _ = _alexnet_port()
    sc = ScalaConfig(lr=0.05)
    state = engine.init_train_state(params, optimizers.sgd())
    for kw in (dict(participation=fed.uniform(4, 0.5)),
               dict(aggregator=fed.staleness_weighted())):
        runner = engine.make_round_runner(model, sc, backend="logits", **kw)
        with pytest.raises(ValueError, match="fed_state"):
            runner(state, rb, None)
    with pytest.raises(ValueError, match="opt_state_policy"):
        engine.make_round_runner(model, sc, opt_state_policy="nope")
    # faults need their stream's state, clipping its median
    for kw, match in ((dict(faults="drop:0.1"), "fault stream"),
                      (dict(guards="clip:2"), "stateful")):
        runner = engine.make_round_runner(model, sc, backend="logits", **kw)
        with pytest.raises(ValueError, match=match):
            runner(state, rb, None)


# --------------------------------------------------------------------------
# opt-state policies under a participation mask
# --------------------------------------------------------------------------


MASKS = [np.array([1.0, 0.0, 1.0, 1.0], np.float32)]


def _policy_round(policy):
    model, params, rb, sizes = _alexnet_port()
    opt = optimizers.momentum(beta=0.9)
    runner = engine.make_round_runner(
        model, ScalaConfig(lr=0.05), backend="logits", optimizer=opt,
        opt_state_policy=policy, participation=_recorded(MASKS))
    state, _, _ = runner(engine.init_train_state(params, opt), rb, sizes,
                         {"sched": torch.tensor(0), "agg": ()})
    return state


def test_opt_state_policy_carry_keeps_per_slot_momentum():
    state = _policy_round("carry")
    l0 = leaves(state.opt_state["client"])[0]
    assert float((l0[0] - l0[2]).abs().max()) > 0
    # the absent slot's moments ticked with zero gradients: still zero
    assert all(float(a[1].abs().max()) == 0.0
               for a in leaves(state.opt_state["client"]))


def test_opt_state_policy_reset_zeroes_client_momentum():
    state = _policy_round("reset")
    assert all(float(a.abs().max()) == 0.0
               for a in leaves(state.opt_state["client"]))
    assert any(float(a.abs().max()) > 0
               for a in leaves(state.opt_state["server"]))


def test_opt_state_policy_average_redistributes_momentum():
    carry, avg = _policy_round("carry"), _policy_round("average")
    w = normalize_client_weights(torch.tensor([5.0, 3.0, 2.0, 4.0]),
                                 torch.from_numpy(MASKS[0]))
    assert float(w[1]) == 0.0
    for lc, la in zip(leaves(carry.opt_state["client"]),
                      leaves(avg.opt_state["client"])):
        want = (lc * w.reshape((-1,) + (1,) * (lc.dim() - 1))).sum(0)
        for c in range(la.shape[0]):
            torch.testing.assert_close(la[c], want, atol=1e-6, rtol=1e-5)
    for a, b in zip(leaves(carry.params), leaves(avg.params)):
        assert torch.equal(a, b)


# --------------------------------------------------------------------------
# sparse slots (tests/test_async.py's assertions)
# --------------------------------------------------------------------------


def test_slot_gather_indices_orders_participants():
    np.testing.assert_array_equal(
        engine.slot_gather_indices(np.array([0.0, 1.0, 0.0, 1.0, 1.0]), 3),
        [1, 3, 4])
    rng = np.random.default_rng(0)
    for _ in range(20):                 # the reference's compaction
        mask = (rng.random(9) < 0.4).astype(np.float32)
        k = int(rng.integers(1, 9))
        np.testing.assert_array_equal(
            engine.slot_gather_indices(mask, k),
            np.asarray(jengine.slot_gather_indices(jnp.asarray(mask), k)))


@pytest.mark.parametrize("agg_name,policy", [("fedavg", "carry"),
                                             ("bias_compensated", "average")])
def test_sparse_slot_round_matches_masked(agg_name, policy):
    model, params, rb, sizes = _alexnet_port()
    part = fed.uniform(4, 0.5)
    agg = fed.make_aggregator(agg_name)
    out = {}
    for name, gather in (("masked", False), ("sparse", True)):
        runner = engine.make_round_runner(
            model, ScalaConfig(lr=0.05), backend="logits", aggregator=agg,
            participation=part, slot_gather=gather, opt_state_policy=policy)
        state = engine.init_train_state(params, optimizers.sgd())
        fs = fed.init_fed_state(4, agg, part)
        ms = []
        for _ in range(2):
            state, fs, m = runner(state, rb, sizes, fs)
            ms.append(m)
        out[name] = (state, ms)
    (sm, mm), (ss, msp) = out["masked"], out["sparse"]
    for a, b in zip(mm, msp):
        for key in ("loss_server", "loss_client"):
            np.testing.assert_allclose(float(b[key]), float(a[key]),
                                       rtol=1e-6)
    for a, b in zip(leaves(ss.params), leaves(sm.params)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6,
                                   rtol=1e-5)
    assert ss.step == sm.step == 6


def test_slot_gather_validation():
    model, _, _, _ = _alexnet_port()
    sc = ScalaConfig(lr=0.05)
    with pytest.raises(ValueError, match="participation scheduler"):
        engine.make_round_runner(model, sc, slot_gather=True)
    no_size = dataclasses.replace(fed.uniform(4, 0.5), subset_size=None)
    with pytest.raises(ValueError, match="static subset_size"):
        engine.make_round_runner(model, sc, slot_gather=True,
                                 participation=no_size)
    with pytest.raises(ValueError, match="lace_dp"):
        engine.make_round_runner(model, sc, backend="lace_dp",
                                 slot_gather=True,
                                 participation=fed.uniform(4, 0.5))


def test_slot_gather_full_participation_is_the_default_round():
    model, params, rb, _ = _alexnet_port()
    sc = ScalaConfig(lr=0.05)
    state0 = engine.init_train_state(params, optimizers.sgd())
    part = fed.full(4)
    s, _, _ = engine.make_round_runner(
        model, sc, backend="logits", participation=part, slot_gather=True)(
        state0, rb, None, fed.init_fed_state(0, None, part))
    s_ref, _ = engine.make_round_runner(model, sc, backend="logits")(
        state0, rb, None)
    for a, b in zip(leaves(s.params), leaves(s_ref.params)):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0)


def test_sparse_leaves_absent_moments_untouched():
    """Sparse freezes an absent slot's momentum; masked ticks it."""
    model, params, rb, sizes = _alexnet_port()
    opt = optimizers.momentum(0.9)
    masks = [np.array([1, 1, 0, 0], np.float32),
             np.array([0, 0, 1, 1], np.float32)]
    got = {}
    for gather in (False, True):
        runner = engine.make_round_runner(
            model, ScalaConfig(lr=0.05), backend="logits", optimizer=opt,
            participation=_recorded(masks), slot_gather=gather)
        state, fs = engine.init_train_state(params, opt), {
            "sched": torch.tensor(0), "agg": ()}
        state, fs, _ = runner(state, rb, sizes, fs)
        after1 = [a[0].clone() for a in leaves(state.opt_state["client"])]
        state, fs, _ = runner(state, rb, sizes, fs)
        got[gather] = (after1, [a[0] for a in
                                leaves(state.opt_state["client"])])
    frozen, ticked = got[True], got[False]
    for a, b in zip(*frozen):
        assert torch.equal(a, b)                 # slot 0 absent in round 2
    for a, b in zip(*ticked):
        torch.testing.assert_close(b, 0.9 ** 3 * a, rtol=1e-6, atol=0)


# --------------------------------------------------------------------------
# server-side FedOpt
# --------------------------------------------------------------------------


def test_server_fedopt_sgd_identity_and_momentum_diverges():
    model, params, rb, _ = _alexnet_port()
    sc = ScalaConfig(lr=0.05)
    sizes = torch.ones(4)
    state0 = engine.init_train_state(params, optimizers.sgd())
    ref_fn = engine.make_round_runner(model, sc, backend="logits")
    s_ref = state0
    for _ in range(2):
        s_ref, _ = ref_fn(s_ref, rb, sizes)
    fs = fed.init_fed_state(0, server_optimizer=optimizers.sgd(),
                            server_params=params["server"])
    id_fn = engine.make_round_runner(model, sc, backend="logits",
                                     server_optimizer=optimizers.sgd(),
                                     server_lr=1.0)
    s_id = state0
    for _ in range(2):
        s_id, fs, _ = id_fn(s_id, rb, sizes, fs)
    for a, b in zip(leaves(s_id.params), leaves(s_ref.params)):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)
    mom = optimizers.momentum(0.9)
    fs_m = fed.init_fed_state(0, server_optimizer=mom,
                              server_params=params["server"])
    m_fn = engine.make_round_runner(model, sc, backend="logits",
                                    server_optimizer=mom, server_lr=1.0)
    s_m = state0
    for _ in range(2):
        s_m, fs_m, _ = m_fn(s_m, rb, sizes, fs_m)
    assert max(float((a - b).abs().max()) for a, b in zip(
        leaves(s_m.params["server"]), leaves(s_ref.params["server"]))) > 1e-6
    assert any(float(a.abs().max()) > 0 for a in leaves(fs_m["server_opt"]))


def test_server_fedopt_requires_fed_state():
    model, params, rb, _ = _alexnet_port()
    runner = engine.make_round_runner(model, ScalaConfig(lr=0.05),
                                      backend="logits",
                                      server_optimizer=optimizers.sgd())
    state = engine.init_train_state(params, optimizers.sgd())
    with pytest.raises(ValueError, match="server_optimizer needs fed_state"):
        runner(state, rb, None)
    with pytest.raises(ValueError, match="server_opt"):
        runner(state, rb, None, {"sched": (), "agg": ()})


# --------------------------------------------------------------------------
# the FL / SFL baselines on the fed layer
# --------------------------------------------------------------------------


def _linear_fl(seed=13, C=3, T=2, Bk=4, N=6):
    rng = np.random.default_rng(seed)
    w = {"w": (rng.standard_normal((12, N)) * 0.1).astype(np.float32)}
    rbs = {"x": rng.standard_normal((C, T, Bk, 12)).astype(np.float32),
           "labels": rng.integers(0, N, (C, T, Bk)).astype(np.int32),
           "weights": np.ones((C, T, Bk), np.float32)}
    rbs["weights"][0, :, -1] = 0.0
    fwd = lambda p, x: x.reshape(x.shape[0], -1) @ p["w"]
    return (JB.FedModel(forward=fwd, num_classes=N),
            B.FedModel(forward=fwd, num_classes=N), w, rbs,
            np.array([2.0, 1.0, 1.0], np.float32))


@pytest.mark.parametrize("method,agg,server", [
    ("fedavg", "bias_compensated", None),
    ("fedavg", None, "momentum"),
    ("feddyn", "hierarchical:3", "adamw"),
    ("fedprox", "bias_compensated:1.0", "sgd")])
def test_fl_round_fed_layer_matches_reference(method, agg, server):
    """An FL round with a fed aggregator (prior-aware: the round's priors)
    and server FedOpt, three rounds: the reference's weights and server
    state within 1e-4 of their largest entry."""
    jm, tm, w, rbs, sizes = _linear_fl()
    so = dict(sgd=lambda m: m.sgd(), momentum=lambda m: m.momentum(0.9),
              adamw=lambda m: m.adamw(eps=SERVER_EPS))
    jso = so[server](jopt) if server else None
    tso = so[server](optimizers) if server else None
    jfn = jax.jit(JB.make_fl_round(
        method, jm, lr=0.1, aggregator=jfed.make_aggregator(agg)
        if agg else None, server_optimizer=jso, server_lr=0.5))
    tfn = B.make_fl_round(method, tm, lr=0.1, aggregator=fed.make_aggregator(
        agg) if agg else None, server_optimizer=tso, server_lr=0.5)
    jw, tw = jax.tree.map(jnp.asarray, w), {"w": _t(w["w"])}
    jst = JB.init_fl_state(method, jw, 3, server_optimizer=jso)
    tst = B.init_fl_state(method, tw, 3, server_optimizer=tso)
    assert set(tst) == set(jst)
    jb = jax.tree.map(jnp.asarray, rbs)
    tb = {k: _t(v) for k, v in rbs.items()}
    for _ in range(3):
        jw, jst = jfn(jw, jb, jnp.asarray(sizes), jst)
        tw, tst = tfn(tw, tb, _t(sizes), tst)
    _close_tree(tw, _np(jw), "weights")
    _close_tree(tst, _np(jst), "fl state")
    if server and server != "sgd":
        assert any(float(a.abs().max()) > 0 for a in leaves(
            tst["server_opt"]))


def test_fl_fedopt_identity_and_errors():
    _, tm, w, rbs, sizes = _linear_fl()
    tw, tb = {"w": _t(w["w"])}, {k: _t(v) for k, v in rbs.items()}
    w_ref, _ = B.make_fl_round("fedavg", tm, lr=0.1)(tw, tb, _t(sizes), {})
    id_fn = B.make_fl_round("fedavg", tm, lr=0.1,
                            server_optimizer=optimizers.sgd(), server_lr=1.0)
    st = B.init_fl_state("fedavg", tw, 3, server_optimizer=optimizers.sgd())
    w_id, _ = id_fn(tw, tb, _t(sizes), st)
    torch.testing.assert_close(w_id["w"], w_ref["w"], atol=1e-6, rtol=1e-6)
    with pytest.raises(ValueError, match="server_opt"):
        id_fn(tw, tb, _t(sizes), {})
    st_dyn = B.init_fl_state("feddyn", tw, 3,
                             server_optimizer=optimizers.sgd())
    assert set(st_dyn) == {"h", "server_opt"}
    with pytest.raises(ValueError, match="stateless"):
        B.make_fl_round("fedavg", tm, lr=0.1,
                        aggregator=fed.staleness_weighted())(
            tw, tb, _t(sizes), {})


def test_sfl_round_accepts_fed_aggregator():
    model, params, _, _ = _alexnet_port(C=3)
    rng = np.random.default_rng(15)
    rbs = {"x": _t(rng.standard_normal((3, 2, 4, 32, 32, 3)).astype(
        np.float32)), "labels": _t(rng.integers(0, 10, (3, 2, 4)))}
    out = B.make_sfl_round("splitfed_v1", model, lr=0.05,
                           aggregator=fed.bias_compensated())(
        {"wc": params["client"], "ws": params["server"]}, rbs,
        torch.tensor([2.0, 1.0, 1.0]))
    assert all(bool(torch.isfinite(a).all()) for a in leaves(out))


@pytest.mark.parametrize("name", ["sgd", "momentum"])
def test_donated_update_is_the_functional_one(name):
    """``donate=True`` writes the update into the dense params and state
    (from a round's second step on, and slice by slice), bit for bit the
    functional update; a broadcast (stride-0) client half is never
    overwritten."""
    rng = np.random.default_rng(9)
    params = {"a": _t(rng.standard_normal((6, 5)).astype(np.float32)),
              "b": _t(rng.standard_normal(7).astype(np.float32))[None]
              .expand(3, 7)}
    grads = tree_map(lambda p: _t(rng.standard_normal(tuple(p.shape))
                                  .astype(np.float32)), params)
    opt = optimizers.make_optimizer(name)
    state = tree_map(lambda p: _t(rng.standard_normal(tuple(p.shape))
                                  .astype(np.float32)), params) \
        if name == "momentum" else ()
    want_p, want_s = opt.update(grads, state, params, 0.05)
    b_before = params["b"].clone()
    got_p, got_s = opt.update(grads, tree_map(torch.clone, state),
                              {"a": params["a"].clone(), "b": params["b"]},
                              0.05, donate=True)
    for a, b in zip(leaves((got_p, got_s)), leaves((want_p, want_s))):
        assert torch.equal(a, b)
    assert torch.equal(params["b"], b_before)        # the broadcast kept
    x = torch.arange(40.0).reshape(10, 4)
    parts = optimizers._slices(x, n=8)
    assert len(parts) == 5 and all(p.shape == (2, 4) for p in parts)
    assert optimizers._slices(x)[0] is x
