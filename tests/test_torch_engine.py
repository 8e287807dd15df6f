"""The PyTorch port's split-step engine against the JAX reference on the
CPU.

Same numpy batches and the same params (the reference's init, converted
by ``repro_torch.convert``, each client slot perturbed so the slots
differ) through both: ``split_step_grads`` (backend ``lace``, fused
boundary, with and without a participation mask) and a two-step
``make_round_runner`` round (sgd / momentum / adamw under the carry /
reset / average opt-state policies), on ``helpers.tiny_cfg`` and on
qwen1.5-0.5b reduced, in float32. Every leaf of the grads, params and
optimizer state is held to 1e-4 of its largest entry (float32 sums in
another order through a few layers); the losses to 1e-5 relative. Also
the SCALA helpers elementwise: label statistics, the split helpers, the
aggregators and the optimizers.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import tiny_cfg
from repro import configs as jcfgs
from repro import fed as jfed
from repro.configs.base import ScalaConfig as JScala
from repro.core import engine as jengine
from repro.core import label_stats as jls
from repro.core import split as jsplit
from repro.core.scala import transformer_split_model as j_split_model
from repro.models import transformer as JT
from repro.optim import optimizers as jopt
from repro.optim import schedules as jsched
from repro_torch import convert
from repro_torch import fed as tfed
from repro_torch.configs.base import ModelConfig as TModelConfig
from repro_torch.configs.base import ScalaConfig as TScala
from repro_torch.core import engine, label_stats, split
from repro_torch.core.scala import transformer_split_model
from repro_torch.kernels.flash_attn import ops as flash_ops
from repro_torch.kernels.lace import ops as lace_ops
from repro_torch.optim import optimizers, schedules
from repro_torch.tree import leaves

torch.set_num_threads(1)
LEAF_RTOL = 1e-4
LOSS_RTOL = 1e-5


def _port_cfg(cfg):
    return TModelConfig(**{f.name: getattr(cfg, f.name)
                           for f in dataclasses.fields(cfg)
                           if f.name not in ("moe", "mamba", "xlstm")})


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


CONFIGS = {
    "tiny": lambda: tiny_cfg(qkv_bias=True),
    "qwen-reduced": lambda: dataclasses.replace(
        jcfgs.get_config("qwen1.5-0.5b").reduced(), vocab_size=97),
}


def _setup(name, C=2, Bk=2, S=12, T=2, seed=0):
    cfg = CONFIGS[name]()
    key = jax.random.PRNGKey(seed)
    params = jengine.init_scala_params(
        key, lambda k: JT.init_params(k, cfg)["client"],
        lambda k: JT.init_params(k, cfg)["server"], C)
    rng = np.random.default_rng(seed)
    # distinct client slots, and nonzero biases
    params = jax.tree.map(
        lambda a: a + 0.02 * rng.standard_normal(a.shape).astype(np.float32),
        _np(params))
    toks = rng.integers(0, cfg.vocab_size, (T, C, Bk, S + 1))
    weights = np.ones((T, C, Bk, S), np.float32)
    weights[:, -1, -1] = 0.0                  # an eq. 3 padding row
    batches = {"tokens": toks[..., :-1].astype(np.int32),
               "labels": toks[..., 1:].astype(np.int32), "weights": weights}
    sizes = np.array([5.0, 3.0] + [2.0] * (C - 2), np.float32)
    return cfg, params, batches, sizes


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


def _close_tree(got, want, what, rtol=LEAF_RTOL):
    g, w = _flat(got), _flat(want)
    assert len(g) == len(w), (what, len(g), len(w))
    for i, (a, b) in enumerate(zip(g, w)):
        a, b = _num(a), _num(b)
        assert a.shape == b.shape, (what, i, a.shape, b.shape)
        scale = max(np.abs(b).max(), 1e-6)
        err = np.abs(a - b).max()
        assert err <= rtol * scale, (what, i, err, scale)


def _close(a, b, what, rtol=LOSS_RTOL):
    a, b = float(a), float(b)
    assert abs(a - b) <= rtol * max(abs(b), 1e-6), (what, a, b)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_split_step_grads_matches_reference(name, masked):
    cfg, params, batches, _ = _setup(name, C=3 if masked else 2)
    pcfg = _port_cfg(cfg)
    scala = dict(num_clients=3, tau=1.0)
    batch = {k: v[0] for k, v in batches.items()}
    mask = np.array([1.0, 0.0, 1.0], np.float32) if masked else None
    model_j = j_split_model(cfg)
    want, wm = jax.jit(lambda p, b, m: jengine.split_step_grads(
        model_j, p, b, JScala(**scala), backend="lace", mask=m))(
        jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, batch),
        None if mask is None else jnp.asarray(mask))
    before = (flash_ops.LAUNCHES, flash_ops.LAUNCHES_BWD,
              lace_ops.LAUNCHES_FWD)
    got, gm = engine.split_step_grads(
        transformer_split_model(pcfg),
        convert.train_params_from_reference(params, pcfg),
        {k: _t(v) for k, v in batch.items()}, TScala(**scala),
        mask=None if mask is None else _t(mask))
    assert before == (flash_ops.LAUNCHES, flash_ops.LAUNCHES_BWD,
                      lace_ops.LAUNCHES_FWD)      # nothing launched on CPU
    _close(gm["loss_server"], wm["loss_server"], "loss_server")
    _close(gm["loss_client"], wm["loss_client"], "loss_client")
    _close_tree(got, convert.train_params_from_reference(_np(want), pcfg),
                "grads")
    if masked:                                  # an absent client: no grad
        assert all(float(g[1].abs().max()) == 0.0
                   for g in leaves(got["client"]))


ROUND_CASES = [
    ("tiny", "sgd", "carry", LEAF_RTOL),
    ("tiny", "momentum", "average", LEAF_RTOL),
    # Adam divides by sqrt(v): a grad entry near zero turns its float32
    # rounding difference into an update difference of up to lr
    ("tiny", "adamw", "reset", 1e-3),
    ("qwen-reduced", "sgd", "carry", LEAF_RTOL),
]


@pytest.mark.parametrize("name,opt_name,policy,rtol", ROUND_CASES)
def test_round_matches_reference(name, opt_name, policy, rtol):
    cfg, params, batches, sizes = _setup(name, C=2, T=2)
    pcfg = _port_cfg(cfg)
    scala = dict(num_clients=2, lr=0.05)
    jo = jopt.make_optimizer(opt_name)
    round_j = jengine.make_round_runner(
        j_split_model(cfg), JScala(**scala), backend="lace", optimizer=jo,
        schedule=jsched.linear_warmup_cosine(0.05, 1, 4), unroll=True,
        aggregator=jfed.weighted(), opt_state_policy=policy)
    s0 = jengine.init_train_state(jax.tree.map(jnp.asarray, params), jo)
    s1, wm = jax.jit(round_j)(s0, jax.tree.map(jnp.asarray, batches),
                              jnp.asarray(sizes))

    to = optimizers.make_optimizer(opt_name)
    round_t = engine.make_round_runner(
        transformer_split_model(pcfg), TScala(**scala), optimizer=to,
        schedule=schedules.linear_warmup_cosine(0.05, 1, 4),
        aggregator=tfed.weighted(), opt_state_policy=policy)
    t0 = convert.train_state_from_reference(_np(s0), pcfg)
    t1, tm = round_t(t0, {k: _t(v) for k, v in batches.items()}, _t(sizes))
    _close(tm["loss_server"], wm["loss_server"], "loss_server")
    _close(tm["loss_client"], wm["loss_client"], "loss_client")
    want = convert.train_state_from_reference(_np(s1), pcfg)
    assert t1.step == want.step == 2
    _close_tree(t1.params, want.params, "params", rtol)
    _close_tree(t1.opt_state, want.opt_state, "opt state", rtol)
    # FedAvg redistributed one client half to every slot
    for a in leaves(t1.params["client"]):
        assert torch.equal(a[0], a[1])


# --------------------------------------------------------------------------
# the SCALA helpers, elementwise
# --------------------------------------------------------------------------


def test_label_stats():
    rng = np.random.default_rng(0)
    labels = rng.integers(-2, 12, (3, 5, 4)).astype(np.int32)  # some invalid
    weights = rng.integers(0, 2, (3, 5, 4)).astype(np.float32)
    weights[2] = 0.0                                # a client with no weight
    for w in (None, weights):
        jw = None if w is None else jnp.asarray(w)
        tw = None if w is None else _t(w)
        np.testing.assert_allclose(
            label_stats.histogram(_t(labels), 10, tw).numpy(),
            np.asarray(jls.histogram(jnp.asarray(labels), 10, jw)))
        pk, ps = label_stats.client_and_concat_priors(_t(labels), 10, tw)
        jpk, jps = jls.client_and_concat_priors(jnp.asarray(labels), 10, jw)
        np.testing.assert_allclose(pk.numpy(), np.asarray(jpk), rtol=1e-6)
        np.testing.assert_allclose(ps.numpy(), np.asarray(jps), rtol=1e-6)


@pytest.mark.parametrize("sizes,mask", [
    ([3.0, 1.0, 0.0], None), ([0.0, 0.0, 0.0], None),
    ([2.0, 5.0, 1.0], [1.0, 0.0, 1.0]), ([0.0, 4.0, 0.0], [1.0, 0.0, 1.0]),
    ([1.0, 1.0, 1.0], [0.0, 0.0, 0.0])])
def test_split_helpers_and_aggregators(sizes, mask):
    s = np.asarray(sizes, np.float32)
    m = None if mask is None else np.asarray(mask, np.float32)
    want = jsplit.normalize_client_weights(
        jnp.asarray(s), None if m is None else jnp.asarray(m))
    got = split.normalize_client_weights(_t(s), None if m is None else _t(m))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-7)
    tree = {"a": np.random.default_rng(1).standard_normal((3, 4, 2))
            .astype(np.float32)}
    np.testing.assert_allclose(
        split.fedavg({"a": _t(tree["a"])}, _t(s))["a"].numpy(),
        np.asarray(jsplit.fedavg({"a": jnp.asarray(tree["a"])},
                                 jnp.asarray(s))["a"]), rtol=1e-6)
    red = split.redistribute({"a": _t(tree["a"])}, _t(s))["a"]
    assert red.shape == (3, 4, 2) and torch.equal(red[0], red[2])
    for name in ("fedavg", "weighted"):
        ctx_j = jfed.AggContext(num_clients=3, data_sizes=jnp.asarray(s),
                                mask=None if m is None else jnp.asarray(m))
        ctx_t = tfed.AggContext(num_clients=3, data_sizes=_t(s),
                                mask=None if m is None else _t(m))
        wj, _ = jfed.make_aggregator(name).client_weights(ctx_j, ())
        wt, _ = tfed.make_aggregator(name).client_weights(ctx_t, ())
        np.testing.assert_allclose(wt.numpy(), np.asarray(wj), rtol=1e-7)
    np.testing.assert_array_equal(
        split.client_minibatch_sizes([10, 30, 60], 16),
        jsplit.client_minibatch_sizes([10, 30, 60], 16))


def test_unported_aggregators_raise():
    with pytest.raises(NotImplementedError, match="bias_compensated"):
        tfed.make_aggregator("bias_compensated:2")
    with pytest.raises(ValueError, match="unknown aggregator"):
        tfed.make_aggregator("nope")


@pytest.mark.parametrize("name", ["sgd", "momentum", "adamw"])
def test_optimizers_match_reference(name):
    rng = np.random.default_rng(2)
    params = {"w": rng.standard_normal((3, 4)).astype(np.float32),
              "b": {"c": rng.standard_normal(5).astype(np.float32)}}
    kw = dict(weight_decay=0.01) if name != "momentum" else dict(
        momentum=0.8, weight_decay=0.01)
    jo, to = jopt.make_optimizer(name, **kw), optimizers.make_optimizer(
        name, **kw)
    jp, js = jax.tree.map(jnp.asarray, params), None
    js = jo.init(jp)
    tp = {"w": _t(params["w"]), "b": {"c": _t(params["b"]["c"])}}
    ts = to.init(tp)
    for step in range(3):
        g = jax.tree.map(lambda a: rng.standard_normal(a.shape)
                         .astype(np.float32), params)
        jp, js = jo.update(jax.tree.map(jnp.asarray, g), js, jp,
                           jsched.cosine_decay(0.1, 5)(step))
        tp, ts = to.update({"w": _t(g["w"]), "b": {"c": _t(g["b"]["c"])}},
                           ts, tp, schedules.cosine_decay(0.1, 5)(step))
        _close_tree(tp, jp, f"{name} params step {step}", rtol=1e-6)
        _close_tree(ts, js, f"{name} state step {step}", rtol=1e-6)
