"""The port's multi-device path (backend ``lace_dp``) over gloo on the CPU.

Four ranks form a ``(data=2, model=2)`` :class:`repro_torch.sharding.Grid`
(``tests/torch_dp_worker.py``, spawned with a ``file://`` rendezvous in
``tmp_path``, one thread a rank, under a 300 s timeout so a hung
collective fails its test), then one rank alone forms a one-rank grid.
The ranks import no JAX; this process runs the JAX reference on the same
numpy inputs and converted params (reduced qwen1.5-0.5b, 8 clients of 2
rows of 16 tokens, 2 local steps) and compares:

* (i) the ``lace_dp`` step, fused and dual, with the reference's
  single-program ``lace`` step; (ii) the ``lace_dp`` round with the
  reference's ``lace`` round, both at the reference's own bar
  (``tests/test_fed.py``: 5e-4 of each leaf's largest entry on
  parameters, 1e-5 on the loss);
* (iii) the masked ``lace_dp`` round (``bias_compensated``, uniform 0.5)
  with the port's masked ``lace`` round for the same host masks (1e-5);
* (iv) the sparse round with the in-shard gather (``weighted``, the
  reference's ``uniform:0.5:2`` masks) with the reference's
  single-program MASKED ``lace`` round for those masks (its own
  ``lace_dp`` sparse round fails its own test);
* (v) the ``lace_dp`` async event at zero delays and full cohort with
  the reference's single-program event, and delta == dense snapshots
  within 1e-6 on the port (cohort 2, a one-slot pop per shard);
* (vi) fused == dual inside ``lace_dp`` bitwise, as the port holds them
  for ``lace`` on the CPU;
* (vii) a one-rank grid against the no-grid calls (1e-6), and the dp ops
  (``lace_loss_dp``, ``lace2_grads_dp``) over four ranks against the
  single-program ops (1e-5);
* the sharded pop over gloo bitwise the single pop, and a single-program
  event with ``arrival="topk:sharded"`` bitwise the ``topk`` event, also
  under a deadline, drops, stalls and guards;
* the masked ``lace_dp`` round under faults and guards (a NaN
  corruption rejected, the round re-run over the survivors) against the
  port's masked ``lace`` round with the same (1e-5, accept vectors
  equal).

The gradients are all_reduced in float32 here (``grad_reduce_dtype=
None``, as the reference's test); one more round in bfloat16 on the wire
stays within 1e-2 of the float32 one.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfgs
from repro import fed as jfed
from repro.configs.base import ScalaConfig as JScala
from repro.core import engine as jengine
from repro.core.scala import transformer_split_model as j_tf_model
from repro.kernels.lace import ops as jops
from repro.models import transformer as JT
from repro.optim import optimizers as jopt
from repro_torch import convert, fed
from repro_torch.configs.base import ModelConfig as TModelConfig
from repro_torch.configs.base import ScalaConfig
from repro_torch.core import engine
from repro_torch.core.scala import transformer_split_model
from repro_torch.kernels.lace import ops
from repro_torch.optim import optimizers
from repro_torch.tree import leaves, tree_map

torch.set_num_threads(1)
C, T, BK, S = 8, 2, 2, 16
CE_CHUNK = 8
PARAM_RTOL, LOSS_ATOL = 5e-4, 1e-5       # tests/test_fed.py:624-625
#: the masked round's faults and guards: drops, NaN corruption (the guards
#: reject it and re-run the round over the survivors), clipping
ROBUST = {"faults": "drop:0.2,corrupt:0.4:nan", "guards": "nonfinite,clip:10"}
SPAWN_TIMEOUT = 300
WORKER = os.path.join(os.path.dirname(__file__), "torch_dp_worker.py")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _flat(v)]
    return [tree]


def _num(a):
    return (a.detach().numpy() if isinstance(a, torch.Tensor)
            else np.asarray(a)).astype(np.float64)


def _rel_err(got, want):
    """The largest of each leaf's max |got - want| over its max |want|."""
    g, w = _flat(got), _flat(want)
    assert len(g) == len(w), (len(g), len(w))
    errs = []
    for a, b in zip(g, w):
        a, b = _num(a), _num(b)
        assert a.shape == b.shape, (a.shape, b.shape)
        errs.append(np.abs(a - b).max() / max(np.abs(b).max(), 1e-8))
    return max(errs)


def _port_cfg(cfg):
    return TModelConfig(**{f.name: getattr(cfg, f.name)
                           for f in dataclasses.fields(cfg)
                           if f.name not in ("moe", "mamba", "xlstm")})


def _jrecorded(masks, shards=1):
    """A reference scheduler replaying ``masks`` (its state a count)."""
    return jfed.ParticipationScheduler(
        name="recorded", num_clients=C, init=lambda key: 0,
        sample=lambda s: (jnp.asarray(masks[s]), s + 1),
        subset_size=int(masks[0].sum()), shards=shards)


def _trecorded(masks):
    def sample(state):
        return np.array(masks[int(state)], np.float32), state + 1

    return fed.ParticipationScheduler(
        name="recorded", num_clients=C, init=lambda seed: torch.tensor(0),
        sample=sample, subset_size=int(masks[0].sum()))


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    cfg = jcfgs.get_config("qwen1.5-0.5b").reduced()
    pcfg = _port_cfg(cfg)
    params = jengine.init_scala_params(
        jax.random.PRNGKey(0), lambda k: JT.init_params(k, cfg)["client"],
        lambda k: JT.init_params(k, cfg)["server"], C)
    # distinct slots, so a wrong client row shows
    params = jax.tree.map(
        lambda a: np.asarray(a) + 0.02 * rng.standard_normal(a.shape).astype(
            np.float32), _np(params))
    toks = rng.integers(0, cfg.vocab_size, (T, C, BK, S + 1))
    weights = np.ones((T, C, BK, S), np.float32)
    weights[:, -1, -1] = 0.0                     # an eq. 3 padding row
    batches = {"tokens": toks[..., :-1].astype(np.int32),
               "labels": toks[..., 1:].astype(np.int32),
               "weights": weights}
    sizes = np.array([5, 3, 2, 4, 1, 6, 2, 3], np.float32)
    part = fed.uniform(C, 0.5)                   # the port's host masks
    st, masks = part.init(11), []
    for _ in range(2):
        m, st = part.sample(st)
        masks.append(m)
    jpart = jfed.make_participation("uniform:0.5:2", C)
    key, masks_sharded = jpart.init(jax.random.PRNGKey(5)), []
    for _ in range(2):
        m, key = jpart.sample(key)
        masks_sharded.append(np.asarray(m, np.float32))
    G, N, d, V = 4, 16, 32, 40
    bnd = {"feats": rng.standard_normal((G, N, d)).astype(np.float32),
           "w_head": (0.2 * rng.standard_normal((d, V))).astype(np.float32),
           "labels": rng.integers(0, V, (G, N)).astype(np.int32),
           "weights": (rng.random((G, N)) > 0.2).astype(np.float32),
           "p_k": rng.dirichlet(np.ones(V), G).astype(np.float32),
           "p_s": rng.dirichlet(np.ones(V)).astype(np.float32)}
    payload = {
        "cfg": {f.name: getattr(pcfg, f.name)
                for f in dataclasses.fields(pcfg)},
        "dims": (C, T, BK, S), "batches": batches, "sizes": sizes,
        "params": convert.train_params_from_reference(params, pcfg),
        "masks": masks, "masks_sharded": masks_sharded, "boundary": bnd,
        "robust": ROBUST}
    return {"cfg": cfg, "pcfg": pcfg, "params": params, "payload": payload}


def _spawn(tmp_path, job, world, payload):
    inputs, out = str(tmp_path / "inputs.pt"), str(tmp_path / "out.pt")
    torch.save(payload, inputs)
    init = f"file://{tmp_path / 'rendezvous'}"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, WORKER, job, str(r), str(world), init, inputs, out],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(world)]
    errs = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=SPAWN_TIMEOUT)
            errs.append(err)
    except subprocess.TimeoutExpired:
        pytest.fail(f"a {job} rank did not finish in {SPAWN_TIMEOUT} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r}: {errs[r][-3000:]}"
    return torch.load(out, weights_only=False)


@pytest.fixture(scope="module")
def grid4(setup, tmp_path_factory):
    return _spawn(tmp_path_factory.mktemp("grid4"), "grid4", 4,
                  setup["payload"])


@pytest.fixture(scope="module")
def grid1(setup, tmp_path_factory):
    return _spawn(tmp_path_factory.mktemp("grid1"), "grid1", 1,
                  setup["payload"])


def _jsc():
    return JScala(num_clients=C, lr=0.05, grad_reduce_dtype=None)


def _jstate(setup):
    return jengine.init_train_state(jax.tree.map(jnp.asarray,
                                                 setup["params"]),
                                    jopt.sgd())


def _jbatches(setup):
    return jax.tree.map(jnp.asarray, setup["payload"]["batches"])


def _to_port(setup, params):
    return convert.train_params_from_reference(_np(params), setup["pcfg"])


def _check(got, want_params, want_loss, what, rtol=PARAM_RTOL,
           atol=LOSS_ATOL):
    err = _rel_err(got["params"], want_params)
    assert err < rtol, (what, err)
    loss = got["metrics"][-1] if "metrics" in got else got
    assert abs(loss["loss_server"] - float(want_loss)) < atol, (
        what, loss["loss_server"], float(want_loss))


@pytest.mark.parametrize("boundary", ["fused", "dual"])
def test_dp_step_matches_reference_lace_step(setup, grid4, boundary):
    step = jengine.make_split_step(j_tf_model(setup["cfg"]), _jsc(),
                                   backend="lace", ce_chunk=CE_CHUNK)
    js, jm = step(_jstate(setup),
                  jax.tree.map(lambda a: a[0], _jbatches(setup)))
    _check(grid4[f"step_{boundary}"], _to_port(setup, js.params),
           jm["loss_server"], boundary)
    assert abs(grid4[f"step_{boundary}"]["loss_client"]
               - float(jm["loss_client"])) < LOSS_ATOL


def test_dp_round_matches_reference_lace_round(setup, grid4):
    rnd = jengine.make_round_runner(j_tf_model(setup["cfg"]), _jsc(),
                                    backend="lace", ce_chunk=CE_CHUNK)
    js, jm = rnd(_jstate(setup), _jbatches(setup),
                 jnp.asarray(setup["payload"]["sizes"]))
    _check(grid4["round"], _to_port(setup, js.params), jm["loss_server"],
           "round")


def _port_round(setup, **kw):
    """The port's single-program ``lace`` round, from the same params."""
    p = setup["payload"]
    tm = transformer_split_model(setup["pcfg"])
    rnd = engine.make_round_runner(
        tm, ScalaConfig(num_clients=C, lr=0.05, grad_reduce_dtype=None),
        backend="lace", ce_chunk=CE_CHUNK, **kw)
    st = engine.init_train_state(
        {k: dict(v) for k, v in p["params"].items()}, optimizers.sgd())
    tb = {k: torch.from_numpy(v) for k, v in p["batches"].items()}
    sizes = torch.from_numpy(p["sizes"])
    if "participation" not in kw:
        st, m = rnd(st, tb, sizes)
        return st, [m]
    fs = fed.init_fed_state(0, kw["aggregator"], kw["participation"],
                            faults=kw.get("faults"), guards=kw.get("guards"))
    out = []
    for _ in p["masks"]:
        st, fs, m = rnd(st, tb, sizes, fs)
        out.append(m)
    return st, out


def test_dp_masked_round_matches_port_masked_lace_round(setup, grid4):
    st, ms = _port_round(setup, aggregator=fed.bias_compensated(),
                         participation=_trecorded(setup["payload"]["masks"]))
    got = grid4["masked"]
    assert _rel_err(got["params"], st.params) < 1e-5
    for g, m in zip(got["metrics"], ms):
        for key in ("loss_server", "loss_client"):
            assert abs(g[key] - float(m[key])) < 1e-6, (key, g, m)
    for a in leaves(got["params"]["client"]):    # every slot re-unified
        assert torch.equal(a[0], a[-1])


def test_dp_sparse_in_shard_matches_reference_masked_round(setup, grid4):
    masks = setup["payload"]["masks_sharded"]
    for m in masks:                               # shards-balanced
        assert m[:C // 2].sum() == m[C // 2:].sum() == 2
    agg, part = jfed.weighted(), _jrecorded(masks, shards=2)
    rnd = jengine.make_round_runner(j_tf_model(setup["cfg"]), _jsc(),
                                    backend="lace", ce_chunk=CE_CHUNK,
                                    aggregator=agg, participation=part)
    js, fs = _jstate(setup), jfed.init_fed_state(jax.random.PRNGKey(0),
                                                 agg, part)
    for _ in masks:
        js, fs, jm = rnd(js, _jbatches(setup),
                         jnp.asarray(setup["payload"]["sizes"]), fs)
    _check(grid4["sparse"], _to_port(setup, js.params), jm["loss_server"],
           "sparse")


def test_dp_async_matches_single_program_event(setup, grid4):
    dm = jfed.make_delays("zero")
    ev = jfed.make_async_runner(j_tf_model(setup["cfg"]), _jsc(),
                                backend="lace", ce_chunk=CE_CHUNK,
                                delays=dm, cohort=C)
    params = jax.tree.map(jnp.asarray, setup["params"])
    af = jfed.init_async_state(jax.random.PRNGKey(6), params["client"], dm)
    js = _jstate(setup)
    for _ in range(2):
        js, af, jm = ev(js, af, _jbatches(setup),
                        jnp.asarray(setup["payload"]["sizes"]))
    got = grid4["async"]
    _check(got, _to_port(setup, js.params), jm["loss_server"], "async")
    np.testing.assert_array_equal(got["version"], np.full(C, 2))
    assert got["server_version"] == 2
    assert all(m["stale"] == 0.0 and m["t"] == 0.0 for m in got["metrics"])


def test_dp_async_delta_equals_dense(grid4):
    dense, delta = grid4["async_dense"], grid4["async_delta"]
    np.testing.assert_array_equal(dense["version"], delta["version"])
    # zero delays, cohort 2 over 2 shards: one slot a shard per event,
    # round-robin by version: 2 slots still at 0, 2 at each of 1, 2, 3
    assert np.bincount(dense["version"]).tolist() == [2, 2, 2, 2]
    got = {"client": tree_map(lambda a: a[:1], dense["params"]["client"]),
           "server": dense["params"]["server"]}
    assert _rel_err(delta["params"], got) < 1e-6
    for a, b in zip(dense["metrics"], delta["metrics"]):
        assert abs(a["loss_server"] - b["loss_server"]) < 1e-6


def test_dp_fused_equals_dual_bitwise(grid4):
    f, d = grid4["step_fused"], grid4["step_dual"]
    for a, b in zip(_flat(f["params"]), _flat(d["params"])):
        assert torch.equal(a, b)
    assert f["loss_server"] == d["loss_server"]
    assert f["loss_client"] == d["loss_client"]


def _ops_reference(setup):
    b = {k: jnp.asarray(v) for k, v in setup["payload"]["boundary"].items()}
    ids = jnp.arange(b["feats"].shape[0])

    def loss(f, w):
        return jops.lace_loss(f, w, b["labels"], b["p_k"], ids,
                              b["weights"], 1.0, 1e-8, 8)

    val, (df, dw) = jax.value_and_grad(loss, argnums=(0, 1))(b["feats"],
                                                             b["w_head"])
    out2 = jops.lace2_grads(b["feats"], b["w_head"], b["labels"],
                            b["p_s"][None], None, b["p_k"], ids,
                            b["weights"], 1.0, 1e-8, 8)
    return ({"loss": val, "df": df, "dw": dw},
            {"loss_s": out2[0], "loss_k": out2[1], "df_s": out2[2],
             "df_k": out2[3], "dw": out2[4]})


@pytest.mark.parametrize("op", ["lace_loss_dp", "lace2_grads_dp"])
def test_dp_ops_match_single_program(setup, grid4, op):
    want = dict(zip(("lace_loss_dp", "lace2_grads_dp"),
                    _ops_reference(setup)))[op]
    got = grid4["ops"][op]
    for key, w in want.items():
        g = got[key]
        if isinstance(g, float):
            assert abs(g - float(w)) <= 1e-5 * max(abs(float(w)), 1.0), key
        else:
            assert _rel_err(g, np.asarray(w)) < 1e-5, key
    # the server gradient went through ONE all_reduce a step, the
    # client gradient through one over ``inner``
    stats = grid4["stats"]
    assert stats["inner"]["calls"] > 0 and stats["all"]["calls"] > 0


def test_one_rank_grid_matches_no_grid(setup, grid1):
    st, ms = _port_round(setup)
    got = grid1["round"]
    assert _rel_err(got["params"], st.params) < 1e-6
    assert abs(got["metrics"][-1]["loss_server"]
               - float(ms[-1]["loss_server"])) < 1e-6
    b = {k: torch.from_numpy(v)
         for k, v in setup["payload"]["boundary"].items()}
    ids = torch.arange(b["feats"].shape[0])
    f = b["feats"].clone().requires_grad_()
    w = b["w_head"].clone().requires_grad_()
    loss = ops.lace_loss_dp(f, w, b["labels"], b["p_k"], ids, b["weights"],
                            1.0, 1e-8, 8)            # no grid: lace_loss
    loss.backward()
    g1 = grid1["ops"]["lace_loss_dp"]
    assert abs(g1["loss"] - loss.item()) < 1e-6
    assert _rel_err(g1["df"], f.grad) < 1e-6
    assert _rel_err(g1["dw"], w.grad) < 1e-6


def test_bf16_wire_round_stays_close(grid4):
    f32, bf16 = grid4["round"], grid4["bf16_wire"]
    assert _rel_err(bf16["params"], f32["params"]) < 1e-2
    assert not _rel_err(bf16["params"], f32["params"]) == 0.0
    assert abs(bf16["metrics"][-1]["loss_server"]
               - f32["metrics"][-1]["loss_server"]) < 1e-5


def test_sharded_pop_over_gloo_is_the_single_pop(grid4):
    assert grid4["sharded_pop"] is True


def test_topk_sharded_event_equals_topk_event(grid4):
    """The single-program event popping with the schedule split over two
    client shards is the ``topk`` event bitwise (lognormal delays)."""
    res = grid4["sharded_event"]
    assert res["diff"] == 0.0
    assert res["losses"][0] == res["losses"][1]
    assert len({t for _, t, *_ in res["losses"][0]}) == 3   # clock moves


def test_dp_masked_round_with_faults_and_guards_matches_port_lace(setup,
                                                                   grid4):
    """The masked ``lace_dp`` round under drops, NaN corruption (each rank
    corrupts its own slots of the global draw) and guards (the screen's
    norms gathered over the client shards; a rejection re-runs the round
    over the survivors) against the port's single-program round with the
    same faults and guards: the accept vectors and rejections equal, the
    params and losses within 1e-5."""
    st, ms = _port_round(setup, aggregator=fed.bias_compensated(),
                         participation=_trecorded(setup["payload"]["masks"]),
                         faults=ROBUST["faults"], guards=ROBUST["guards"])
    got = grid4["masked_robust"]
    assert sum(float(m["guard_rejected"]) for m in ms) > 0   # a re-run ran
    for g, m in zip(got["metrics"], ms):
        assert torch.equal(g["guard_accept"], m["guard_accept"])
        assert float(g["guard_rejected"]) == float(m["guard_rejected"])
        for key in ("loss_server", "loss_client"):
            assert abs(g[key] - float(m[key])) < 1e-6, (key, g, m)
    assert _rel_err(got["params"], st.params) < 1e-5


def test_topk_sharded_event_with_deadline_faults_guards_equals_topk(grid4):
    """The same with a deadline, drops, stalls and guards: the sharded
    schedule's misses, backoffs and rejections are the single one's."""
    res = grid4["sharded_event_robust"]
    assert res["diff"] == 0.0
    assert res["losses"][0] == res["losses"][1]
    assert any(m > 0 for _, _, _, m, _ in res["losses"][0])  # a miss
