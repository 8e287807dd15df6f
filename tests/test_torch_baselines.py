"""The FL / SFL baselines on the PyTorch port (CPU), the assertions of
``tests/test_baselines.py``, ``tests/test_api.py`` and
``tests/test_fed.py`` on the port:

* every FL and SFL method runs and learns on a small MLP (the evaluation
  loss falls over five rounds), splitfed_v3 keeps personalized client
  halves, sfl_localloss moves the server half;
* ``build`` of a baseline spec steps exactly as the round function
  called directly; incoherent baseline specs raise the reference's
  ``ValueError``s;
* the fed layer's aggregators drive an FL round;
* FedDecorr's regularizer equals the reference's (population std), the
  table runner prints the reference's CSV block, and a run's final state
  is checked for inf and NaN.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import baselines as JB
from repro_torch import api, fed
from repro_torch.benchmarks import run as table_run
from repro_torch.configs import ScalaConfig
from repro_torch.core import baselines as B
from repro_torch.core.engine import SplitModel
from repro_torch.core.losses import softmax_xent
from repro_torch.launch import train
from repro_torch.tree import leaves, tree_map

torch.set_num_threads(1)

# a 2-layer MLP classification model
D_IN, D_H, N_CLS = 8, 16, 4


def _mlp_init(seed=0):
    rng = np.random.default_rng(seed)
    t = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(
        np.float32))
    return {"w1": t(D_IN, D_H) * 0.3, "b1": torch.zeros(D_H),
            "w2": t(D_H, N_CLS) * 0.3, "b2": torch.zeros(N_CLS)}


def _mlp_feats(p, x):
    return torch.relu(x @ p["w1"] + p["b1"])


def _mlp_fwd(p, x):
    return _mlp_feats(p, x) @ p["w2"] + p["b2"]


MODEL = B.FedModel(forward=_mlp_fwd, num_classes=N_CLS, features=_mlp_feats)


def _round_data(seed=0, C=3, T=4, Bk=8):
    rng = np.random.default_rng(seed)
    ys = rng.integers(0, N_CLS, (C, T, Bk))
    protos = np.eye(N_CLS, D_IN) * 3
    xs = rng.standard_normal((C, T, Bk, D_IN)) + protos[ys]
    return {"x": torch.from_numpy(xs.astype(np.float32)),
            "labels": torch.from_numpy(ys)}


@pytest.mark.parametrize("method", B.FL_METHODS)
def test_fl_methods_run_and_learn(method):
    w = _mlp_init()
    state = B.init_fl_state(method, w, 3)
    round_fn = B.make_fl_round(method, MODEL, lr=0.1)
    data = _round_data()
    sizes = torch.ones(3)
    x_eval, y_eval = data["x"].reshape(-1, D_IN), data["labels"].reshape(-1)
    loss0 = float(softmax_xent(_mlp_fwd(w, x_eval), y_eval))
    for _ in range(5):
        w, state = round_fn(w, data, sizes, state)
    loss1 = float(softmax_xent(_mlp_fwd(w, x_eval), y_eval))
    assert all(bool(torch.isfinite(a).all()) for a in leaves(w))
    assert loss1 < loss0, (method, loss0, loss1)
    if method == "feddyn":
        assert leaves(state["h"])[0].shape[0] == 3     # by slot


# the split model: client = first layer, server = second
def _client_fwd(wc, batch):
    return {"x": torch.relu(batch["x"] @ wc["w1"] + wc["b1"])}


def _server_fwd(ws, acts):
    return acts["x"] @ ws["w2"] + ws["b2"], torch.zeros(())


SPLIT = SplitModel(client_fwd=_client_fwd, server_fwd=_server_fwd,
                   num_classes=N_CLS)


def _split_state(C):
    p = _mlp_init()
    wc = {"w1": p["w1"], "b1": p["b1"]}
    stack = lambda t: tree_map(lambda a: a[None].expand((C,) + a.shape), t)
    return {"wc": stack(wc), "ws": {"w2": p["w2"], "b2": p["b2"]}}


@pytest.mark.parametrize("method",
                         ["splitfed_v1", "splitfed_v2", "splitfed_v3"])
def test_sfl_methods_run_and_learn(method):
    C = 3
    state = _split_state(C)
    data = _round_data(C=C)
    sizes = torch.ones(C)
    round_fn = B.make_sfl_round(method, SPLIT, lr=0.1)

    def eval_loss(st):
        wc0 = tree_map(lambda a: a[0], st["wc"])
        acts = _client_fwd(wc0, {"x": data["x"].reshape(-1, D_IN)})
        logits, _ = _server_fwd(st["ws"], acts)
        return float(softmax_xent(logits, data["labels"].reshape(-1)))

    loss0 = eval_loss(state)
    for _ in range(5):
        state = round_fn(state, data, sizes)
    loss1 = eval_loss(state)
    assert loss1 < loss0, (method, loss0, loss1)
    if method == "splitfed_v3":
        # personalized client halves stay different
        assert not torch.allclose(state["wc"]["w1"][0], state["wc"]["w1"][1])
    else:
        assert torch.equal(state["wc"]["w1"][0], state["wc"]["w1"][1])


def test_sfl_localloss_runs():
    C = 3
    state = _split_state(C)
    aux0 = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (D_H, N_CLS)).astype(np.float32)) * 0.1
    state["aux"] = {"w": aux0[None].expand(C, D_H, N_CLS)}
    data = _round_data(C=C)
    round_fn = B.make_sfl_round("sfl_localloss", SPLIT, lr=0.1,
                                aux_head_fwd=lambda p, f: f @ p["w"])
    state2 = round_fn(state, data, torch.ones(C))
    assert all(bool(torch.isfinite(a).all()) for a in leaves(state2))
    # the server moved, with no server gradient reaching the clients
    assert not torch.allclose(state["ws"]["w2"], state2["ws"]["w2"])
    assert not torch.allclose(state["aux"]["w"], state2["aux"]["w"])


def test_fl_round_accepts_fed_aggregator():
    num_classes = 6
    model = B.FedModel(
        forward=lambda p, x: x.reshape(x.shape[0], -1) @ p["w"],
        num_classes=num_classes)
    rng = np.random.default_rng(13)
    w = {"w": torch.from_numpy(rng.standard_normal(
        (12, num_classes)).astype(np.float32)) * 0.1}
    C, T, Bk = 3, 2, 4
    rbs = {"x": torch.from_numpy(rng.standard_normal(
        (C, T, Bk, 12)).astype(np.float32)),
           "labels": torch.from_numpy(rng.integers(0, num_classes,
                                                   (C, T, Bk)))}
    sizes = torch.tensor([2.0, 1.0, 1.0])
    w_uniform, _ = B.make_fl_round("fedavg", model, lr=0.1,
                                   aggregator=fed.fedavg())(w, rbs, sizes, {})
    w_sized, _ = B.make_fl_round("fedavg", model, lr=0.1)(w, rbs, sizes, {})
    assert bool(torch.isfinite(w_uniform["w"]).all())
    # uniform weights, not the data sizes
    assert not torch.allclose(w_uniform["w"], w_sized["w"])
    w_weighted, _ = B.make_fl_round("fedavg", model, lr=0.1,
                                    aggregator=fed.weighted())(w, rbs, sizes,
                                                               {})
    torch.testing.assert_close(w_weighted["w"], w_sized["w"], rtol=0,
                               atol=1e-7)


def test_decorr_loss_matches_reference():
    """FedDecorr's population std (``jnp.std``, ddof 0), with a dead and a
    nearly constant feature."""
    f = np.random.default_rng(2).standard_normal((7, 2, 5)).astype(
        np.float32)
    f[:, 0, 0] = 0.0
    f[:, 1, 1] = 0.25
    want = float(JB._decorr_loss(jnp.asarray(f)))
    got = float(B._decorr_loss(torch.from_numpy(f)))
    assert abs(got - want) <= 1e-5 * abs(want), (got, want)


def test_cast_fed_model():
    assert B.cast_fed_model(MODEL, "f32") is MODEL
    with pytest.raises(NotImplementedError, match="dispatch-knob"):
        B.cast_fed_model(MODEL, "bf16")
    with pytest.raises(ValueError, match="unknown precision"):
        B.cast_fed_model(MODEL, "f16")


def _image_spec(**overrides):
    kw = dict(
        arch="alexnet-cifar", method="scala", rounds=2, seed=0,
        scala=ScalaConfig(num_clients=4, participation=0.5, local_iters=2,
                          server_batch=24, lr=0.05),
        execution=api.ExecutionSpec(mode="subset"),
        data=api.DataSpec(kind="image_synthetic", n_train=200, n_test=50,
                          alpha=2))
    kw.update(overrides)
    return api.ExperimentSpec(**kw)


def test_build_matches_direct_fl_baseline():
    from repro_torch.models import alexnet as A

    spec = _image_spec(method="fedavg")
    program = api.build(spec, device="cpu")
    rng = np.random.default_rng(3)
    C = spec.scala.clients_per_round
    batches = {"x": torch.from_numpy(rng.standard_normal(
        (2, C, 5, 32, 32, 3)).astype(np.float32)),
        "labels": torch.from_numpy(rng.integers(0, 10, (2, C, 5))),
        "weights": torch.ones(2, C, 5)}
    sizes = torch.tensor([5.0, 5.0])
    state = program.init()
    out, metrics = program.step(state, batches, sizes)
    assert metrics == {}

    model = B.FedModel(forward=lambda p, x: A.forward(p, x, spec.split),
                       num_classes=10)
    gen = torch.Generator().manual_seed(spec.seed)
    w0 = A.init_params(gen, num_classes=10, width=spec.width)
    round_fn = B.make_fl_round("fedavg", model, lr=spec.scala.lr)
    w_ref, _ = round_fn(w0, {k: v.transpose(0, 1) for k, v in
                             batches.items()}, sizes, {})
    for a, b in zip(leaves(out.inner), leaves(w_ref)):
        assert torch.equal(a, b)


def test_validate_rejects_incoherent_baselines():
    with pytest.raises(ValueError, match="only supports.*'subset'"):
        _image_spec(method="fedavg",
                    fed=api.FedSpec(participation="uniform:0.5"),
                    execution=api.ExecutionSpec(mode="masked")).validate()
    with pytest.raises(ValueError, match="CNN"):
        api.ExperimentSpec(arch="qwen1.5-0.5b", reduced=True,
                           method="fedavg",
                           execution=api.ExecutionSpec(mode="subset"),
                           ).validate()
    with pytest.raises(ValueError, match="not supported by the SFL"):
        _image_spec(method="splitfed_v1",
                    execution=api.ExecutionSpec(
                        mode="subset",
                        server_optimizer=api.OptimSpec(
                            name="adamw", lr=0.01))).validate()
    # FedOpt over an FL baseline is the federation slice's, not refused
    with pytest.raises(NotImplementedError, match="federation slice"):
        _image_spec(method="fedavg", execution=api.ExecutionSpec(
            mode="subset", server_optimizer=api.OptimSpec(
                name="momentum", lr=0.9))).validate()
    for m in B.FL_METHODS + B.SFL_METHODS:
        assert _image_spec(method=m).validate().method == m


def test_build_refuses_mismatched_baseline_params():
    spec = _image_spec(method="splitfed_v1")
    state = api.build(spec, device="cpu").init().inner
    with pytest.raises(ValueError, match="expected"):
        api.build(spec, device="cpu", params={"wc": state["wc"]})
    with pytest.raises(ValueError, match="slots"):
        api.build(spec, device="cpu", params=dict(
            state, wc=tree_map(lambda a: a[:1], state["wc"])))
    # a merged client half is repeated over the slots
    merged = dict(state, wc=tree_map(lambda a: a[0], state["wc"]))
    again = api.build(spec, device="cpu", params=merged).init().inner
    assert leaves(again["wc"])[0].shape[0] == spec.slots


def test_train_cli_refuses_baselines(tmp_path):
    path = tmp_path / "fedavg.json"
    path.write_text(_image_spec(method="fedavg").to_json())
    with pytest.raises(SystemExit, match="Trainer"):
        train.main(["--config", str(path), "--device", "cpu"])


def test_nonfinite_leaves_counts_a_diverged_state():
    """A diverged run still evaluates to a finite accuracy (argmax over
    NaN logits picks one class); its state's inf / NaN leaves are what
    the table runner reports."""
    from repro_torch.api.build import ProgramState
    from repro_torch.benchmarks.common import nonfinite_leaves

    w = {"a": torch.zeros(3), "b": torch.ones(2, 2),
         "labels": torch.arange(3)}
    state = ProgramState(inner=w, fed={"h": {"a": torch.zeros(2, 3)}})
    assert nonfinite_leaves(state) == 0
    w["a"][1] = float("nan")
    w["b"][0, 0] = float("inf")
    assert nonfinite_leaves(state) == 2


def test_table_runner_prints_reference_block(capsys, tmp_path):
    out_json = tmp_path / "t8.json"
    rows = table_run.main(["--table", "t8", "--quick", "--device", "cpu",
                           "--out", str(out_json)])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "table,setting,method,acc,balanced_acc,seconds"
    assert [r["setting"] for r in rows] == ["split=s1", "split=s2"]
    for line, row in zip(out[1:], rows):
        table, setting, method, acc, bacc, _ = line.split(",")
        assert (table, setting, method) == ("T8", row["setting"], "scala")
        assert 0.0 <= float(acc) <= 1.0 and 0.0 <= float(bacc) <= 1.0
        assert row["nonfinite_leaves"] == 0
    saved = json.loads(out_json.read_text())
    assert saved["device"]["platform"] == "cpu" and saved["rows"] == rows
    with pytest.raises(SystemExit, match="not ported yet"):
        table_run.main(["--table", "round_loop"])
