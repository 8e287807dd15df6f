"""The port's asynchronous event runtime on the CPU.

* Against the JAX package: each case runs 4 events of the reference's
  runner and of the port's from one state (the reference's converted by
  ``repro_torch.convert.async_state_from_reference``) with the
  reference's delays injected (each event's draw replayed from its key
  stream into ``repro_torch.fed.delays.recorded``): ``version``,
  ``finish_time``, ``server_version``, ``now`` and ``retries`` exactly,
  every event's losses within 1e-4 relative, and every leaf of the state
  (params, optimizer state, snapshots or ring, server optimizer state)
  within 1e-4 of its largest entry (float32 sums in another order). On
  AlexNet width 0.125 (``logits``): dense momentum carry, delta SGD,
  deadline with backoff, ``lr_scale`` cohort with the top-k pop, the
  reset and average policies (bias_compensated), server FedAdam (its eps
  1e-3, as ``tests/test_torch_fed.py`` says why); on reduced qwen1.5-0.5b
  (``lace``, the plain versions): momentum carry with a deadline and
  server FedAdam, and delta SGD.
* Within the port, the assertions of ``tests/test_async.py`` and the
  async deadline ones of ``tests/test_faults.py``: the delay models and
  the spec strings (accepted and refused as the reference's), the keyed
  delay stream, the cohort pop's rotation, zero delays with cohort = K ==
  the sync round, the staleness ages == the sync staleness_weighted
  simulation, the heavy-tail invariants, delta == dense bitwise, ring
  eviction, ``lr_scale``, state bytes flat in K, cohort-sized batches,
  the emit gate, a loose deadline == none bitwise and a tight one's
  backoff, ``donate=False`` == ``donate=True``; the spec, build, Trainer
  (resume bitwise, dense and delta) and CLI layers.

Left out: the ``lace_dp`` event, the sharded pop and the sharded delay
sampling (``tests/test_torch_dp.py``, ``tests/test_torch_dp_pop.py``), the legacy deprecation shims (the
port has none) and the server-FedOpt / slot-gather assertions the sync
round's tests already hold (``tests/test_torch_fed.py``).
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro import configs as jcfgs
from repro import fed as jfed
from repro.configs.base import ScalaConfig as JScala
from repro.core import engine as jengine
from repro.core.scala import alexnet_split_model as j_alexnet_model
from repro.core.scala import transformer_split_model as j_tf_model
from repro.launch import train as jtrain
from repro.models import alexnet as JA
from repro.models import transformer as JT
from repro.optim import optimizers as jopt
from repro_torch import api, convert, fed
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig as TModelConfig
from repro_torch.configs.base import ScalaConfig
from repro_torch.core import engine
from repro_torch.core.scala import (alexnet_split_model,
                                    transformer_split_model)
from repro_torch.core.split import stack_client_params
from repro_torch.launch import train
from repro_torch.optim import optimizers
from repro_torch.tree import leaves, tree_map

torch.set_num_threads(1)
LEAF_RTOL, LOSS_RTOL = 1e-4, 1e-4
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


def _close_tree(got, want, what, rtol=LEAF_RTOL):
    """Every leaf within ``rtol`` of its largest entry."""
    g, w = _flat(got), _flat(want)
    assert len(g) == len(w), (what, len(g), len(w))
    for i, (a, b) in enumerate(zip(g, w)):
        a, b = _num(a), _num(b)
        assert a.shape == b.shape, (what, i, a.shape, b.shape)
        err = np.abs(a - b).max() if a.size else 0.0
        assert err <= rtol * max(np.abs(b).max() if b.size else 0.0,
                                 1e-6), (what, i, err)


def _port_cfg(cfg):
    return TModelConfig(**{f.name: getattr(cfg, f.name)
                           for f in dataclasses.fields(cfg)
                           if f.name not in ("moe", "mamba", "xlstm")})


def _setup(arch, K=4, Bk=3, T=2, seed=0):
    """(reference model, port model, port cfg, numpy params stacked over K
    identical slots, numpy round batches (T, K, Bk, ...), sizes)."""
    rng = np.random.default_rng(seed)
    if arch == "alexnet":
        full = JA.init_params(jax.random.PRNGKey(seed), num_classes=10,
                              width=0.125)
        wc, ws = JA.split_params(full, "s2")
        batches = {"x": rng.standard_normal((T, K, Bk, 32, 32, 3)).astype(
            np.float32), "labels": rng.integers(0, 10, (T, K, Bk)).astype(
                np.int32)}
        models = (j_alexnet_model("s2", num_classes=10),
                  alexnet_split_model("s2", num_classes=10))
        pcfg, shape = get_config("alexnet-cifar"), (T, K, Bk)
    else:
        cfg = dataclasses.replace(
            jcfgs.get_config("qwen1.5-0.5b").reduced(), vocab_size=97)
        full = JT.init_params(jax.random.PRNGKey(seed), cfg)
        wc, ws = full["client"], full["server"]
        S = 8
        toks = rng.integers(0, cfg.vocab_size, (T, K, Bk, S + 1))
        batches = {"tokens": toks[..., :-1].astype(np.int32),
                   "labels": toks[..., 1:].astype(np.int32)}
        pcfg = _port_cfg(cfg)
        models = (j_tf_model(cfg), transformer_split_model(pcfg))
        shape = (T, K, Bk, S)
    wc = jax.tree.map(lambda a: np.asarray(a) + 0.02 * rng.standard_normal(
        a.shape).astype(np.float32), _np(wc))
    weights = np.ones(shape, np.float32)
    weights[:, -1, -1] = 0.0                   # an eq. 3 padding row
    batches["weights"] = weights
    sizes = np.array([5.0, 3.0, 2.0, 4.0][:K], np.float32)
    return models, pcfg, wc, _np(ws), batches, sizes


# (arch, case): the runner's keywords on both sides, and the optimizer
PARITY = {
    "dense_momentum_carry": dict(opt="momentum", delay="lognormal:1:1.5",
                                 mix_rate=0.8),
    "delta_sgd": dict(opt="sgd", delay="lognormal:1:1.5",
                      snapshots="delta", ring_size=3),
    "deadline_backoff": dict(opt="momentum", delay="lognormal:1:1",
                             deadline=0.3, backoff=3.0),
    "lr_scale_cohort": dict(opt="momentum", delay="uniform:0.5:2",
                            lr_scale="cohort", arrival="topk"),
    "reset": dict(opt="momentum", delay="lognormal:1:1",
                  opt_state_policy="reset"),
    "average": dict(opt="momentum", delay="lognormal:1:1",
                    opt_state_policy="average",
                    aggregator="bias_compensated"),
    "server_fedadam": dict(opt="sgd", delay="lognormal:1:1",
                           server=True),
    "deadline_momentum_fedadam": dict(opt="momentum", delay="lognormal:1:1",
                                      deadline=0.4, server=True),
}
PARITY_CASES = ([("alexnet", c) for c in PARITY
                 if c != "deadline_momentum_fedadam"]
                + [("qwen", "deadline_momentum_fedadam"),
                   ("qwen", "delta_sgd")])


@pytest.mark.parametrize("arch,case", PARITY_CASES)
def test_events_match_reference_with_injected_delays(arch, case):
    K, cohort, events = 4, 2, 4
    kw = dict(PARITY[case])
    opt_name, delay = kw.pop("opt"), kw.pop("delay")
    server = kw.pop("server", False)
    agg_name = kw.pop("aggregator", "weighted")
    (jm, tm), pcfg, wc, ws, batches, sizes = _setup(arch, K=K)
    backend = "logits" if arch == "alexnet" else "lace"
    delta = kw.get("snapshots") == "delta"
    slots = 1 if delta else K
    jdm = jfed.make_delays(delay)
    jso = jopt.adamw(eps=SERVER_EPS) if server else None
    tso = optimizers.adamw(eps=SERVER_EPS) if server else None
    jo, to = jopt.make_optimizer(opt_name), optimizers.make_optimizer(
        opt_name)
    jparams = {"client": jax.tree.map(
        lambda a: jnp.broadcast_to(a[None], (slots,) + a.shape), wc),
        "server": jax.tree.map(jnp.asarray, ws)}
    jrun = jax.jit(jfed.make_async_runner(
        jm, JScala(num_clients=K, lr=0.05), backend=backend, delays=jdm,
        cohort=cohort, optimizer=jo, aggregator=jfed.make_aggregator(
            agg_name), server_optimizer=jso, server_lr=SERVER_LR,
        num_clients=K, unroll=True, **kw))
    js = jengine.init_train_state(jparams, jo)
    jaf = jfed.init_async_state(
        jax.random.PRNGKey(3), jparams["client"], jdm,
        server_optimizer=jso, server_params=jparams["server"],
        snapshots=kw.get("snapshots", "dense"),
        ring_size=kw.get("ring_size", 64), num_clients=K)
    ts = convert.train_state_from_reference(_np(js), pcfg)
    taf = convert.async_state_from_reference(_np(jaf), pcfg, seed=0)
    jb, jsz = jax.tree.map(jnp.asarray, batches), jnp.asarray(sizes)
    table, jmets = [np.asarray(jaf.finish_time)], []
    for _ in range(events):
        # the draw the reference's event makes from its key
        table.append(np.asarray(jdm.sample(jax.random.split(jaf.key)[0],
                                           (cohort,))))
        js, jaf, m = jrun(js, jaf, jb, jsz)
        jmets.append(_np(m))
    trun = fed.make_async_runner(
        tm, ScalaConfig(num_clients=K, lr=0.05), backend=backend,
        delays=fed.delays.recorded(table), cohort=cohort, optimizer=to,
        aggregator=fed.make_aggregator(agg_name), server_optimizer=tso,
        server_lr=SERVER_LR, num_clients=K, **kw)
    tb = {k: _t(v) for k, v in batches.items()}
    for e in range(events):
        ts, taf, m = trun(ts, taf, tb, _t(sizes))
        want = jmets[e]
        for key in ("loss_server", "loss_client"):
            a, b = float(m[key]), float(want[key])
            assert abs(a - b) <= LOSS_RTOL * abs(b), (e, key, a, b)
        np.testing.assert_array_equal(m["arrival_mask"],
                                      want["arrival_mask"])
        np.testing.assert_array_equal(m["staleness"], want["staleness"])
        assert m["t_event"] == want["t_event"]
        assert m["server_version"] == int(want["server_version"])
        if "deadline" in kw:
            assert m["deadline_missed"] == want["deadline_missed"]
    np.testing.assert_array_equal(taf.version, np.asarray(jaf.version))
    np.testing.assert_array_equal(taf.finish_time,
                                  np.asarray(jaf.finish_time))
    np.testing.assert_array_equal(taf.retries, np.asarray(jaf.retries))
    assert taf.server_version == int(jaf.server_version) == events
    assert taf.now == np.float32(jaf.now)
    if "deadline" in kw:
        assert sum(float(m["deadline_missed"]) for m in jmets) > 0
        assert np.asarray(jaf.retries).max() >= 1
    if delta:
        np.testing.assert_array_equal(taf.ring_versions,
                                      np.asarray(jaf.ring_versions))
    want = convert.async_state_from_reference(_np(jaf), pcfg, seed=0)
    _close_tree(taf.client_params, want.client_params, "snapshots")
    _close_tree(taf.ring, want.ring, "ring")
    _close_tree(taf.server_opt, want.server_opt, "server optimizer")
    want = convert.train_state_from_reference(_np(js), pcfg)
    assert ts.step == want.step == events * 2
    _close_tree(ts.params, want.params, "params")
    _close_tree(ts.opt_state, want.opt_state, "optimizer state")


# --------------------------------------------------------------------------
# delay models
# --------------------------------------------------------------------------


def test_delay_models_shapes_and_support():
    rng = np.random.default_rng(0)
    d = fed.delays.constant(2.5).sample(rng, (7,))
    np.testing.assert_allclose(d, 2.5)
    d = fed.delays.uniform(0.5, 2.0).sample(rng, (100,))
    assert d.shape == (100,) and d.dtype == np.float32
    assert (d >= 0.5).all() and (d <= 2.0).all()
    d = fed.delays.lognormal(1.0, 1.5).sample(rng, (2000,))
    assert d.dtype == np.float32 and (d > 0).all()
    assert d.max() > 5 * np.median(d)            # heavy tail


SPECS = ["zero", "zero:1", "constant", "constant:3", "constant:1:2",
         "constant:-1", "uniform:1:2", "uniform:1", "uniform:3:1",
         "lognormal", "lognormal:2", "lognormal:2:0.5", "lognormal:0:1",
         "lognormal:1:2:3", "nope", "uniform:a:b"]


@pytest.mark.parametrize("spec", SPECS)
def test_make_delays_accepts_and_refuses_as_the_reference(spec):
    try:
        want = jfed.make_delays(spec).name
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            fed.make_delays(spec)
        assert str(got.value) == str(e)
        return
    dm = fed.make_delays(spec)
    assert dm.name == want
    if spec.startswith(("zero", "constant")):
        np.testing.assert_array_equal(
            dm.draw(0, 0, (3,)),
            np.asarray(jfed.make_delays(spec).sample(jax.random.PRNGKey(0),
                                                     (3,))))


def test_delay_stream_is_keyed_by_seed_and_version():
    dm = fed.make_delays("lognormal:1:1.5")
    a = dm.draw(3, 5, (6,))
    np.testing.assert_array_equal(a, dm.draw(3, 5, (6,)))
    assert not np.array_equal(a, dm.draw(3, 6, (6,)))
    assert not np.array_equal(a, dm.draw(4, 5, (6,)))
    np.testing.assert_array_equal(
        a, dm.sample(np.random.default_rng([3, 5]), (6,)))
    rec = fed.delays.recorded([[1.0, 2.0, 3.0], [0.5]])
    np.testing.assert_array_equal(rec.draw(99, 0, (3,)), [1.0, 2.0, 3.0])
    np.testing.assert_array_equal(rec.draw(0, 1, (1,)), [0.5])
    with pytest.raises(ValueError, match="shape"):
        rec.draw(0, 1, (2,))


# --------------------------------------------------------------------------
# the event schedule, on a tiny linear split net and AlexNet
# --------------------------------------------------------------------------


def _linear_model():
    def client_fwd(wc, batch):
        return {"x": batch["x"] @ wc["w"]}

    def server_fwd(ws, acts):
        return acts["x"] @ ws["w"], torch.zeros(())

    return engine.SplitModel(client_fwd=client_fwd, server_fwd=server_fwd,
                             num_classes=3)


def _linear_params(seed, slots):
    g = torch.Generator().manual_seed(seed)
    wc = {"w": torch.randn(4, 3, generator=g)}
    return {"client": stack_client_params(wc, slots),
            "server": {"w": torch.randn(3, 3, generator=g)}}


def _linear_batches(seed, T, C, Bk=4):
    rng = np.random.default_rng(seed)
    return {"x": torch.from_numpy(rng.standard_normal(
        (T, C, Bk, 4)).astype(np.float32)),
        "labels": torch.from_numpy(rng.integers(0, 3, (T, C, Bk)))}


def _alexnet(K, seed):
    (_, tm), pcfg, wc, ws, batches, sizes = _setup("alexnet", K=K, seed=seed,
                                                   T=3, Bk=6)
    params = convert.train_params_from_reference(
        {"client": wc, "server": ws}, pcfg)
    params["client"] = stack_client_params(params["client"], K)
    return tm, params, {k: _t(v) for k, v in batches.items()}, _t(sizes)


def _same(a, b):
    for x, y in zip(leaves(a), leaves(b)):
        assert torch.equal(x, y)


def test_arrival_cohort_pops_earliest_with_slot_tiebreak():
    ft = np.array([3.0, 1.0, 2.0, 1.0], np.float32)
    idx, mask, t = fed.arrival_cohort(ft, 2)
    np.testing.assert_array_equal(idx, [1, 3])
    np.testing.assert_array_equal(mask, [0, 1, 0, 1])
    assert t == 1.0
    idx, _, t = fed.arrival_cohort(ft, 3)
    np.testing.assert_array_equal(idx, [1, 2, 3])
    assert t == 2.0
    idx, _, _ = fed.arrival_cohort(np.array([1.0, 1.0, 1.0, 2.0], np.float32),
                                   2, np.array([5, 3, 4, 0], np.int32))
    np.testing.assert_array_equal(idx, [1, 2])


def test_zero_delay_partial_cohort_rotates_without_starvation():
    model, params, rb, _ = _alexnet(4, 30)
    dm = fed.delays.constant(0.0)
    event = fed.make_async_runner(model, ScalaConfig(lr=0.05), delays=dm,
                                  cohort=2, staleness_decay=0.5)
    state = engine.init_train_state(params, optimizers.sgd())
    afed = fed.init_async_state(31, params["client"], dm)
    masks = []
    for _ in range(4):
        state, afed, m = event(state, afed, rb)
        masks.append(m["arrival_mask"])
    for e, want in enumerate(([1, 1, 0, 0], [0, 0, 1, 1]) * 2):
        np.testing.assert_array_equal(masks[e], want)
    assert afed.version.min() > 0


@pytest.mark.parametrize("opt_name", ["sgd", "momentum"])
def test_async_zero_delay_full_cohort_matches_sync(opt_name):
    C = 4
    model, params, rb, sizes = _alexnet(C, 1)
    sc = ScalaConfig(lr=0.05)
    opt = optimizers.make_optimizer(opt_name)
    sync_fn = engine.make_round_runner(model, sc, backend="logits",
                                       optimizer=opt)
    dm = fed.delays.constant(0.0)
    event = fed.make_async_runner(model, sc, optimizer=opt, delays=dm,
                                  cohort=C, staleness_decay=0.5)
    s_sync = engine.init_train_state(params, opt)
    s_async = engine.init_train_state(params, opt)
    afed = fed.init_async_state(2, params["client"], dm)
    for _ in range(3):
        s_sync, m_sync = sync_fn(s_sync, rb, sizes)
        s_async, afed, m_async = event(s_async, afed, rb, sizes)
    for tree in ("params", "opt_state"):
        for x, y in zip(leaves(getattr(s_sync, tree)),
                        leaves(getattr(s_async, tree))):
            np.testing.assert_allclose(x.numpy(), y.numpy(), atol=1e-6,
                                       rtol=1e-6)
    for key in ("loss_server", "loss_client"):
        np.testing.assert_allclose(float(m_sync[key]), float(m_async[key]),
                                   rtol=1e-6)
    assert s_async.step == s_sync.step == 9
    np.testing.assert_array_equal(m_async["arrival_mask"], np.ones(C))
    np.testing.assert_array_equal(m_async["staleness"], np.zeros(C))
    assert afed.server_version == 3
    np.testing.assert_array_equal(afed.version, np.full(C, 3))


def test_async_staleness_matches_sync_age_simulation():
    C = 4
    model, params, rb, _ = _alexnet(C, 7)
    dm = fed.delays.constant(1.0)
    event = fed.make_async_runner(model, ScalaConfig(lr=0.05), delays=dm,
                                  cohort=2, staleness_decay=0.5)
    state = engine.init_train_state(params, optimizers.sgd())
    afed = fed.init_async_state(8, params["client"], dm)
    sim = fed.staleness_weighted(decay=0.5)
    sim_state = sim.init(C)
    for _ in range(5):
        pre_ages = sim_state["age"].numpy()
        state, afed, m = event(state, afed, rb)
        np.testing.assert_array_equal(m["staleness"], pre_ages)
        _, sim_state = sim.client_weights(fed.AggContext(
            num_clients=C, mask=torch.from_numpy(m["arrival_mask"])),
            sim_state)
        np.testing.assert_array_equal(afed.server_version - afed.version,
                                      sim_state["age"].numpy())


def test_async_invariants_and_metrics_under_heavy_tail():
    C = 6
    model, params, rb, _ = _alexnet(C, 9)
    dm = fed.make_delays("lognormal:1:1.5")
    event = fed.make_async_runner(model, ScalaConfig(lr=0.05), delays=dm,
                                  cohort=2, mix_rate=0.8)
    state = engine.init_train_state(params, optimizers.sgd())
    afed = fed.init_async_state(10, params["client"], dm)
    last_now = 0.0
    for _ in range(6):
        state, afed, m = event(state, afed, rb)
        assert m["arrival_mask"].sum() == 2
        assert afed.now >= last_now                  # a monotone clock
        last_now = afed.now
        assert (afed.finish_time >= afed.now - 1e-6).all()
        assert afed.version.max() <= afed.server_version
        assert np.isfinite(float(m["loss_server"]))
    assert afed.server_version == 6
    assert all(bool(torch.isfinite(a).all()) for a in leaves(state.params))
    c0 = leaves(state.params["client"])[0]
    assert torch.equal(c0[0], c0[1])          # the slots stay unified


def test_async_runner_lace_backend_smoke():
    (_, tm), pcfg, wc, ws, batches, sizes = _setup("qwen", K=4, Bk=2)
    params = convert.train_params_from_reference(
        {"client": wc, "server": ws}, pcfg)
    params["client"] = stack_client_params(params["client"], 4)
    dm = fed.delays.uniform(0.5, 2.0)
    mom = optimizers.momentum(0.9)
    event = fed.make_async_runner(tm, ScalaConfig(lr=0.05), backend="lace",
                                  ce_chunk=8, delays=dm, cohort=2,
                                  server_optimizer=mom, server_lr=1.0)
    state = engine.init_train_state(params, optimizers.sgd())
    afed = fed.init_async_state(13, params["client"], dm,
                                server_optimizer=mom,
                                server_params=params["server"])
    for _ in range(2):
        state, afed, m = event(state, afed, {k: _t(v) for k, v in
                                             batches.items()})
    assert np.isfinite(float(m["loss_server"])) and state.step == 4
    assert all(bool(torch.isfinite(a).all()) for a in leaves(state.params))


def test_runner_and_state_validation():
    model = _linear_model()
    sc = ScalaConfig(lr=0.05)
    dm = fed.delays.constant(0.0)
    params = _linear_params(0, 4)
    with pytest.raises(ValueError, match="server_params"):
        fed.init_async_state(0, params["client"], dm,
                             server_optimizer=optimizers.sgd())
    with pytest.raises(ValueError, match="cohort"):
        fed.make_async_runner(model, sc, delays=dm, cohort=0)
    with pytest.raises(ValueError, match="mesh= and batch_specs="):
        fed.make_async_runner(model, sc, delays=dm, cohort=2,
                              backend="lace_dp")
    # faults and guards are ported; their specs are parsed as the
    # reference's, and a clipping guard needs its median in the state
    for name, spec in (("faults", "explode:0.1"), ("guards", "median")):
        with pytest.raises(ValueError, match="unknown"):
            fed.make_async_runner(model, sc, delays=dm, cohort=2,
                                  **{name: spec})
    event = fed.make_async_runner(model, sc, delays=dm, cohort=2,
                                  guards="clip:2")
    with pytest.raises(ValueError, match="afed.guard"):
        event(engine.init_train_state(params, optimizers.sgd()),
              fed.init_async_state(0, params["client"], dm),
              _linear_batches(0, 1, 4), None)
    with pytest.raises(ValueError, match="deadline must be > 0"):
        fed.make_async_runner(model, sc, delays=dm, cohort=2, deadline=0.0)
    with pytest.raises(ValueError, match="backoff"):
        fed.make_async_runner(model, sc, delays=dm, cohort=2, deadline=1.0,
                              backoff=0.5)
    event = fed.make_async_runner(model, sc, delays=dm, cohort=8)
    state = engine.init_train_state(params, optimizers.sgd())
    afed = fed.init_async_state(0, params["client"], dm)
    with pytest.raises(ValueError, match="exceeds"):
        event(state, afed, _linear_batches(0, 1, 4))


def _delta_pair(model, sc, dm, *, K, cohort, ring_size, **kw):
    out = []
    for snapshots, slots in (("dense", K), ("delta", 1)):
        event = fed.make_async_runner(model, sc, delays=dm, cohort=cohort,
                                      snapshots=snapshots,
                                      ring_size=ring_size, num_clients=K,
                                      **kw)
        params = _linear_params(40, slots)
        out.append((event, engine.init_train_state(params,
                                                   optimizers.sgd()),
                    fed.init_async_state(41, params["client"], dm,
                                         snapshots=snapshots,
                                         ring_size=ring_size,
                                         num_clients=K)))
    return out


def test_delta_snapshots_bitwise_identical_to_dense():
    model, sc = _linear_model(), ScalaConfig(lr=0.05)
    K, cohort, R = 8, 2, 8
    dm = fed.make_delays("lognormal:1:1")
    (r_d, s_d, a_d), (r_r, s_r, a_r) = _delta_pair(model, sc, dm, K=K,
                                                   cohort=cohort,
                                                   ring_size=R)
    rb = _linear_batches(41, 2, K)
    for _ in range(6):
        s_d, a_d, m_d = r_d(s_d, a_d, rb)
        s_r, a_r, m_r = r_r(s_r, a_r, rb)
        _same(tree_map(lambda a: a[0], s_d.params["client"]),
              tree_map(lambda a: a[0], s_r.params["client"]))
        _same(s_d.params["server"], s_r.params["server"])
        for x, y in ((a_d.version, a_r.version),
                     (a_d.finish_time, a_r.finish_time),
                     (m_d["arrival_mask"], m_r["arrival_mask"]),
                     (m_d["staleness"], m_r["staleness"])):
            np.testing.assert_array_equal(x, y)
        assert (a_d.server_version, a_d.now) == (a_r.server_version,
                                                 a_r.now)
        for key in ("loss_server", "loss_client"):
            assert torch.equal(m_d[key], m_r[key])
    per_snap = 4 * 3 * 4
    assert fed.async_state_bytes(a_d)["snapshot_bytes"] == K * per_snap
    assert fed.async_state_bytes(a_r)["snapshot_bytes"] == R * per_snap


def test_delta_ring_eviction_clamps_to_oldest_retained():
    model, sc = _linear_model(), ScalaConfig(lr=0.05)
    K, cohort, R = 8, 2, 2
    dm = fed.delays.constant(0.0)       # round-robin: staleness grows to K/c
    event = fed.make_async_runner(model, sc, delays=dm, cohort=cohort,
                                  snapshots="delta", ring_size=R,
                                  num_clients=K)
    params = _linear_params(42, 1)
    state = engine.init_train_state(params, optimizers.sgd())
    afed = fed.init_async_state(43, params["client"], dm, snapshots="delta",
                                ring_size=R, num_clients=K)
    rb = _linear_batches(44, 2, K)
    history = [state.params["client"]["w"][0].clone()]
    for e in range(1, 9):
        state, afed, _ = event(state, afed, rb)
        history.append(state.params["client"]["w"][0].clone())
        assert afed.server_version == e
        snaps, eff = fed.ring_lookup(afed.ring, afed.version,
                                     afed.server_version, R)
        oldest = e - R + 1
        np.testing.assert_array_equal(eff, np.maximum(afed.version, oldest))
        for k in range(K):
            assert torch.equal(snaps["w"][k],
                               history[max(int(afed.version[k]), oldest)])
        if e >= 5:          # the clamp is exercised, not vacuous
            assert afed.version.min() < oldest


def test_lr_scale_cohort_sync_equivalence_and_partial_scaling():
    model, sc = _linear_model(), ScalaConfig(lr=0.05)
    K = 8
    dm = fed.delays.constant(0.0)
    rb = _linear_batches(45, 2, K)

    def run(cohort, lr_scale):
        event = fed.make_async_runner(model, sc, delays=dm, cohort=cohort,
                                      lr_scale=lr_scale, num_clients=K)
        params = _linear_params(46, K)
        state = engine.init_train_state(params, optimizers.sgd())
        afed = fed.init_async_state(47, params["client"], dm)
        for _ in range(2):
            state, afed, _ = event(state, afed, rb)
        return state.params

    _same(run(K, "none"), run(K, "cohort"))
    d = max((a - b).abs().max().item() for a, b in
            zip(leaves(run(2, "none")), leaves(run(2, "cohort"))))
    assert d > 1e-7
    with pytest.raises(ValueError, match="lr_scale"):
        fed.make_async_runner(model, sc, delays=dm, cohort=2,
                              lr_scale="nope", num_clients=K)
    with pytest.raises(ValueError, match="num_clients"):
        fed.make_async_runner(model, sc, delays=dm, cohort=2,
                              lr_scale="cohort")


def test_async_state_bytes_delta_flat_in_k():
    dm = fed.delays.constant(0.0)
    rows = {}
    for K in (64, 256):
        for snapshots, slots in (("dense", K), ("delta", 1)):
            params = _linear_params(48, slots)
            rows[(snapshots, K)] = fed.async_state_bytes(
                fed.init_async_state(49, params["client"], dm,
                                     snapshots=snapshots, ring_size=16,
                                     num_clients=K))
    assert rows[("dense", 256)]["snapshot_bytes"] \
        == 4 * rows[("dense", 64)]["snapshot_bytes"]
    assert rows[("delta", 256)]["snapshot_bytes"] \
        == rows[("delta", 64)]["snapshot_bytes"]
    for snapshots in ("dense", "delta"):
        assert rows[(snapshots, 256)]["per_client_scalar_bytes"] == 256 * 8
    for v in rows.values():
        assert v["total_bytes"] == (v["snapshot_bytes"]
                                    + v["per_client_scalar_bytes"]
                                    + v["other_bytes"])


def test_cohort_sized_batches_match_full_slot_batches():
    model, sc = _linear_model(), ScalaConfig(lr=0.05)
    K, cohort = 8, 2
    dm = fed.delays.constant(0.0)
    cb = _linear_batches(50, 2, cohort)
    full_b = {k: v.repeat((1, K // cohort) + (1,) * (v.dim() - 2))
              for k, v in cb.items()}

    def run(batches):
        event = fed.make_async_runner(model, sc, delays=dm, cohort=cohort)
        params = _linear_params(51, K)
        state = engine.init_train_state(params, optimizers.sgd())
        afed = fed.init_async_state(52, params["client"], dm)
        return event(state, afed, batches)

    s_full, _, m_full = run(full_b)
    s_coh, _, m_coh = run(cb)
    _same(s_full.params, s_coh.params)
    assert torch.equal(m_full["loss_server"], m_coh["loss_server"])
    params = _linear_params(53, K)
    state = engine.init_train_state(params, optimizers.sgd())
    afed = fed.init_async_state(54, params["client"], dm)
    event = fed.make_async_runner(model, sc, delays=dm, cohort=cohort,
                                  aggregator=fed.bias_compensated())
    with pytest.raises(ValueError, match="cohort-sized"):
        event(state, afed, cb)
    event = fed.make_async_runner(model, sc, delays=dm, cohort=cohort)
    with pytest.raises(ValueError, match="client axis"):
        event(state, afed, {k: v[:, :3] for k, v in full_b.items()})


def test_delta_snapshot_validation():
    model, sc = _linear_model(), ScalaConfig(lr=0.05)
    dm = fed.delays.constant(0.0)
    with pytest.raises(ValueError, match="unknown snapshots"):
        fed.make_async_runner(model, sc, delays=dm, cohort=2,
                              snapshots="nope")
    with pytest.raises(ValueError, match="average"):
        fed.make_async_runner(model, sc, delays=dm, cohort=2,
                              snapshots="delta", opt_state_policy="average")
    one = _linear_params(1, 1)["client"]
    with pytest.raises(ValueError, match="ring_size"):
        fed.init_async_state(0, one, dm, snapshots="delta", ring_size=0,
                             num_clients=4)
    with pytest.raises(ValueError, match="unknown snapshots"):
        fed.init_async_state(0, one, dm, snapshots="nope")
    with pytest.raises(ValueError, match="stacked over"):
        fed.init_async_state(0, _linear_params(1, 2)["client"], dm,
                             num_clients=8)
    K, mom = 4, optimizers.momentum(0.9)
    event = fed.make_async_runner(model, sc, delays=dm, cohort=2,
                                  snapshots="delta", ring_size=4,
                                  optimizer=mom, num_clients=K)
    params = _linear_params(2, 1)
    state = engine.init_train_state(params, mom)
    afed = fed.init_async_state(3, params["client"], dm, snapshots="delta",
                                ring_size=4, num_clients=K)
    rb = _linear_batches(4, 1, K)
    with pytest.raises(ValueError, match="stateless optimizer"):
        event(state, afed, rb)
    event = fed.make_async_runner(model, sc, delays=dm, cohort=2,
                                  snapshots="delta", ring_size=4,
                                  optimizer=mom, opt_state_policy="reset",
                                  num_clients=K)
    state, afed, m = event(state, afed, rb)
    assert np.isfinite(float(m["loss_server"]))


def test_emit_client_metrics_gate_drops_k_vectors():
    model, sc = _linear_model(), ScalaConfig(lr=0.05)
    dm = fed.delays.constant(0.0)
    event = fed.make_async_runner(model, sc, delays=dm, cohort=2,
                                  emit_client_metrics=False)
    params = _linear_params(55, 8)
    state = engine.init_train_state(params, optimizers.sgd())
    afed = fed.init_async_state(56, params["client"], dm)
    _, _, m = event(state, afed, _linear_batches(57, 2, 8))
    assert "arrival_mask" not in m and "staleness" not in m
    assert m["staleness_mean"] == 0.0 and m["server_version"] == 1


def _qwen_event_setup(K=4):
    (_, tm), pcfg, wc, ws, batches, sizes = _setup("qwen", K=K)
    params = convert.train_params_from_reference(
        {"client": wc, "server": ws}, pcfg)
    params["client"] = stack_client_params(params["client"], K)
    return tm, params, {k: _t(v) for k, v in batches.items()}, _t(sizes)


def test_loose_deadline_matches_no_deadline_bitwise():
    model, params, rb, sizes = _qwen_event_setup()
    dm = fed.make_delays("lognormal:1:1")
    mom = optimizers.momentum(0.9)
    runs = {}
    for deadline in (None, 1e6):
        event = fed.make_async_runner(model, ScalaConfig(lr=0.05),
                                      backend="lace", optimizer=mom,
                                      delays=dm, cohort=2, num_clients=4,
                                      deadline=deadline)
        state = engine.init_train_state(params, mom)
        afed = fed.init_async_state(17, params["client"], dm)
        for _ in range(4):
            state, afed, m = event(state, afed, rb, sizes)
            if deadline is not None:
                assert m["deadline_missed"] == 0.0
        runs[deadline] = (state, afed)
    (s_l, a_l), (s_b, a_b) = runs[None], runs[1e6]
    _same(s_l.params, s_b.params)
    _same(s_l.opt_state, s_b.opt_state)
    np.testing.assert_array_equal(a_l.finish_time, a_b.finish_time)
    np.testing.assert_array_equal(a_l.version, a_b.version)
    np.testing.assert_array_equal(a_b.retries, np.zeros(4))


def test_tight_deadline_partial_cohort_and_backoff():
    model, params, rb, sizes = _qwen_event_setup()
    dm = fed.make_delays("lognormal:1:1")
    event = fed.make_async_runner(model, ScalaConfig(lr=0.05),
                                  backend="lace", delays=dm, cohort=3,
                                  num_clients=4, deadline=0.05, backoff=3.0)
    state = engine.init_train_state(params, optimizers.sgd())
    afed = fed.init_async_state(19, params["client"], dm)
    ft_before, missed = afed.finish_time.copy(), 0
    for _ in range(4):
        state, afed, m = event(state, afed, rb, sizes)
        missed += int(m["deadline_missed"])
        # the event never waits for the full cohort barrier
        assert m["t_event"] <= np.sort(ft_before)[0] + np.float32(0.05)
        ft_before = afed.finish_time.copy()
    assert missed > 0 and afed.retries.max() >= 1
    assert all(bool(torch.isfinite(a).all()) for a in leaves(state.params))
    assert np.isfinite(afed.finish_time).all()


def test_donate_false_leaves_the_inputs_and_matches_donate():
    model, sc = _linear_model(), ScalaConfig(lr=0.05)
    K, mom = 6, optimizers.momentum(0.9)
    dm = fed.make_delays("lognormal:1:1")
    rb = _linear_batches(60, 2, K)
    out = {}
    for donate in (True, False):
        for snapshots, slots in (("dense", K), ("delta", 1)):
            kw = (dict(opt_state_policy="reset") if snapshots == "delta"
                  else {})
            event = fed.make_async_runner(model, sc, delays=dm, cohort=2,
                                          optimizer=mom, donate=donate,
                                          snapshots=snapshots, ring_size=4,
                                          num_clients=K, **kw)
            params = _linear_params(61, slots)
            state = engine.init_train_state(params, mom)
            afed = fed.init_async_state(62, params["client"], dm,
                                        snapshots=snapshots, ring_size=4,
                                        num_clients=K)
            before = tuple(a.clone() for a in leaves(
                (state.opt_state, afed.ring, afed.client_params)))
            for _ in range(3):
                new = event(state, afed, rb)
                if not donate:
                    _same((state.opt_state, afed.ring, afed.client_params),
                          before)
                state, afed, _ = new
                before = tuple(a.clone() for a in leaves(
                    (state.opt_state, afed.ring, afed.client_params)))
            out[(donate, snapshots)] = (state, afed)
    for snapshots in ("dense", "delta"):
        (s1, a1), (s2, a2) = out[(True, snapshots)], out[(False, snapshots)]
        _same((s1.params, s1.opt_state, a1.client_params, a1.ring),
              (s2.params, s2.opt_state, a2.client_params, a2.ring))


# --------------------------------------------------------------------------
# spec, build, Trainer, CLI
# --------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(delay="nope"), dict(delay="uniform:1"), dict(cohort=-1),
    dict(ring_size=0), dict(deadline=0.0), dict(backoff=0.5)])
def test_execution_spec_structural_checks_match_reference(kw):
    with pytest.raises(ValueError) as want:
        japi.ExecutionSpec(**kw)
    with pytest.raises(ValueError) as got:
        api.ExecutionSpec(**kw)
    assert str(got.value) == str(want.value)


def test_resolve_cohort_and_make_delays():
    assert api.ExecutionSpec().resolve_cohort(16) == 4
    assert api.ExecutionSpec().resolve_cohort(3) == 1
    assert api.ExecutionSpec(cohort=5).resolve_cohort(16) == 5
    assert api.ExecutionSpec(delay="uniform:1:2").make_delays().name == \
        "uniform"


def _lm_spec(ex, fd=None, optim=None, clients=4):
    kw = dict(arch="qwen1.5-0.5b", reduced=True, rounds=3, seed=0,
              scala=dict(num_clients=clients, participation=0.5,
                         local_iters=2, server_batch=8, lr=0.05),
              data=dict(kind="lm_synthetic", seq=16, docs_per_client=3),
              execution=dict({"backend": "lace"}, **ex))
    if fd:
        kw["fed"] = fd
    if optim:
        kw["optim"] = optim
    return kw


VALIDATE_CASES = [
    (dict(mode="async", cohort=9), None, None),
    (dict(mode="async", deadline=1.0, snapshots="delta",
          opt_paging="host"), None, dict(name="momentum")),
    (dict(mode="async", snapshots="delta"), dict(opt_state_policy="average"),
     None),
    (dict(mode="async", snapshots="delta"), None, dict(name="adamw")),
    (dict(mode="async"), dict(aggregator="staleness_weighted"), None),
    (dict(mode="async"), dict(participation="uniform:0.5"), None),
    (dict(mode="masked", deadline=1.0), dict(participation="uniform:0.5"),
     None),
    (dict(mode="async", opt_paging="host", snapshots="delta"),
     dict(opt_state_policy="reset"), None),
    (dict(mode="async", snapshots="delta", opt_paging="host"), None,
     dict(name="momentum")),
    (dict(mode="async", cohort=3, deadline=0.5, backoff=3.0,
          lr_scale="cohort", arrival="topk"), None, None),
]


@pytest.mark.parametrize("case", range(len(VALIDATE_CASES)))
def test_validate_async_rules_match_reference(case):
    ex, fd, optim = VALIDATE_CASES[case]
    d = _lm_spec(ex, fd, optim)
    try:
        japi.ExperimentSpec.from_dict(json.loads(json.dumps(d))).validate()
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            api.ExperimentSpec.from_dict(d).validate()
        assert str(got.value) == str(e)
        return
    spec = api.ExperimentSpec.from_dict(d)
    assert spec.validate() is spec


def test_async_still_refuses_what_later_slices_bring():
    # the multi-device event and pop are ported: they validate, and build
    # refuses them without a grid, as the reference's build does
    for ex, match in ((dict(mode="async", backend="lace_dp"),
                       "mesh=, batch_specs="),
                      (dict(mode="async", arrival="topk:sharded"),
                       "mesh=")):
        spec = api.ExperimentSpec.from_dict(_lm_spec(ex, None))
        assert spec.validate() is spec
        with pytest.raises(ValueError, match=match):
            api.build(spec, device="cpu")
    # the dispatch knobs are ported: with faults or guards they validate
    for ex, fd in ((dict(mode="async", precision="bf16"),
                    dict(faults="drop:0.1")),
                   (dict(mode="async", rounds_per_call=2),
                    dict(guards="nonfinite"))):
        spec = api.ExperimentSpec.from_dict(_lm_spec(ex, fd))
        assert spec.validate() is spec


def test_build_equals_the_hand_built_event():
    """build(spec) in the async mode is the runtime built by hand from
    the same pieces (its delay stream seeded by fed_seed), bit for bit."""
    from repro_torch.api.build import fed_seed, text_split_init

    spec = api.ExperimentSpec.from_dict(_lm_spec(
        dict(mode="async", cohort=2, delay="lognormal:1:1.5",
             staleness_decay=0.5), optim=dict(name="momentum")))
    prog = api.build(spec, device="cpu")
    assert prog.metadata["mode"] == "async" and prog.metadata["cohort"] == 2
    t = api.Trainer(spec, device="cpu")
    batches, sizes = t._next_round_batches()
    s1, m1 = prog.step(prog.init(), batches, sizes)
    model, params = text_split_init(spec, 4, torch.device("cpu"))
    mom = optimizers.momentum(0.9)
    dm = fed.make_delays("lognormal:1:1.5")
    event = fed.make_async_runner(
        model, spec.scala, backend="lace", optimizer=mom,
        schedule=spec.optim.make_schedule(6, default_lr=0.05), delays=dm,
        cohort=2, staleness_decay=0.5, num_clients=4)
    state = engine.init_train_state(params, mom)
    afed = fed.init_async_state(fed_seed(spec), params["client"], dm,
                                num_clients=4)
    s2, a2, m2 = event(state, afed, batches, sizes)
    _same(s1.inner.params, s2.params)
    np.testing.assert_array_equal(s1.fed.finish_time, a2.finish_time)
    assert torch.equal(m1["loss_server"], m2["loss_server"])


@pytest.mark.parametrize("ex", [
    dict(mode="async", cohort=2, deadline=1.0),
    dict(mode="async", cohort=2, snapshots="delta", ring_size=2),
])
def test_trainer_async_history_and_resume_bitwise(tmp_path, ex):
    spec = api.ExperimentSpec.from_dict(_lm_spec(
        ex, optim=dict(name="momentum" if "snapshots" not in ex
                       else "sgd")))
    full = api.Trainer(spec, device="cpu")
    full.run(3)
    for m in full.history:
        assert {"loss_server", "staleness_mean", "t_event",
                "server_version"} <= set(m)
        assert ("deadline_missed" in m) == ("deadline" in ex)
    assert [m["server_version"] for m in full.history] == [1.0, 2.0, 3.0]
    t = api.Trainer(spec, device="cpu")
    t.run(1)
    t.save(str(tmp_path))
    r = api.Trainer(spec, device="cpu")
    assert r.resume(str(tmp_path)) == 1
    r.run(2)
    assert r.history == full.history
    a = flatten_leaves(r.state)
    b = flatten_leaves(full.state)
    assert a.keys() == b.keys()
    for k, x in a.items():
        y = b[k]
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y), k
        else:
            assert type(x) is type(y) and np.array_equal(x, y), k


def flatten_leaves(state):
    from repro_torch.checkpoint.checkpoint import flatten_with_paths

    return flatten_with_paths(state)


def test_trainer_paged_run_trains_and_refuses_save(tmp_path):
    spec = api.ExperimentSpec.from_dict(_lm_spec(
        dict(mode="async", cohort=2, snapshots="delta", ring_size=4,
             opt_paging="host", arrival="topk", lr_scale="cohort"),
        optim=dict(name="momentum")))
    t = api.Trainer(spec, device="cpu")
    t.run(2)
    pager = t.program.metadata["pager"]
    assert pager.nbytes() > 0 and pager.seconds["page_out"] > 0
    assert leaves(t.state.inner.opt_state["client"])[0].shape[0] == 1
    with pytest.raises(ValueError, match="opt_paging='host'"):
        t.save(str(tmp_path))


def test_cli_async_and_reference_json(tmp_path, capsys):
    flags = ["--arch", "qwen1.5-0.5b", "--reduced", "--rounds", "2",
             "--clients", "4", "--local-iters", "2", "--seq", "16",
             "--server-batch", "8", "--docs-per-client", "3", "--async",
             "--cohort", "2", "--delay-spec", "lognormal:1:1.5",
             "--optimizer", "momentum", "--deadline", "2.0"]
    train.main(flags + ["--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert any(line.startswith("async: delay=lognormal:1:1.5 cohort=2/4")
               for line in out)
    events = [line for line in out if line.startswith("event ")]
    assert len(events) == 2 and all(" stale=" in e for e in events)
    path = tmp_path / "run.json"
    jtrain.main(flags + ["--dump-config", str(path)])
    spec = api.ExperimentSpec.from_json(path.read_text())
    assert spec.execution.mode == "async"
    capsys.readouterr()
    train.main(["--config", str(path), "--device", "cpu"])
    assert sum(line.startswith("event ")
               for line in capsys.readouterr().out.splitlines()) == 2
