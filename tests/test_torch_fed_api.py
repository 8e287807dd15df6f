"""The federation layer through the port's declarative layer, on the CPU.

* The spec strings (aggregator, participation, optimizer with the FedOpt
  aliases) parse as the reference's do and the whole spec tree
  round-trips through JSON; the reference's ``--dump-config`` of a masked
  or sparse run is the port's spec (``tests/test_api.py``).
* ``build(spec)`` in the masked and sparse modes equals the engine round
  built by hand from the same pieces (the scheduler seeded by
  ``fed_seed``), bit for bit; ``validate`` applies the reference's rules
  (sparse needs a scheduler, a scheduler needs an in-program mode,
  stateful aggregators need stable identities, SFL refuses FedOpt).
* The Trainer: in the masked and sparse modes a round's batches cover all
  K slots, the reference's host streams (LM; images at the budget
  ``round(server_batch / participation)``); every scheduler, every
  aggregator, each opt-state policy and a server optimizer train; FedAvgM
  / FedAdam on an FL baseline.
* The CLI runs ``--participation uniform:0.5 --aggregator
  bias_compensated --optimizer momentum``, masked and with
  ``--slot-gather``, and prints the reference's round header.
* Checkpoints: save -> resume is bitwise with the fed state (scheduler
  state, ages, server moments); a JAX-written masked directory is
  refused (its scheduler key cannot be continued) while its params
  still start a run; a JAX-written FedAvgM or SCALA-with-FedOpt
  directory resumes, its server state converted.
* The table runner's SMOKE rows and the participation leg.
"""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from repro import api as japi
from repro import fed as jfed
from repro.configs.base import ScalaConfig as JScala
from repro.launch import train as jtrain
from repro_torch import api, fed
from repro_torch.api.build import fed_seed
from repro_torch.checkpoint.checkpoint import flatten_with_paths
from repro_torch.configs import ScalaConfig
from repro_torch.core import engine
from repro_torch.launch import train
from repro_torch.tree import leaves

torch.set_num_threads(1)


def _roundtrip(spec):
    return api.ExperimentSpec.from_dict(json.loads(json.dumps(spec.to_dict())))


def _image_spec(**overrides):
    kw = dict(
        arch="alexnet-cifar", method="scala", rounds=2, seed=0,
        scala=ScalaConfig(num_clients=4, participation=0.5, local_iters=2,
                          server_batch=12, lr=0.05),
        data=api.DataSpec(kind="image_synthetic", n_train=120, n_test=30,
                          alpha=2))
    kw.update(overrides)
    return api.ExperimentSpec(**kw)


def _lm_spec(**overrides):
    kw = dict(
        arch="qwen1.5-0.5b", reduced=True, method="scala", rounds=2, seed=2,
        scala=ScalaConfig(num_clients=4, local_iters=2, server_batch=4,
                          lr=0.05),
        fed=api.FedSpec(participation="uniform:0.5"),
        execution=api.ExecutionSpec(mode="masked", backend="lace"),
        data=api.DataSpec(kind="lm_synthetic", seq=16, docs_per_client=3))
    kw.update(overrides)
    return api.ExperimentSpec(**kw)


def _jax_spec(tspec):
    """The reference's spec of a port spec (the same JSON)."""
    d = tspec.to_dict()
    return japi.ExperimentSpec.from_dict(dict(
        d, scala=JScala(**d["scala"]),
        execution=dict(d["execution"], unroll=0)))


def _equal_trees(a, b, what):
    fa, fb = flatten_with_paths(a), flatten_with_paths(b)
    assert fa.keys() == fb.keys(), (what, fa.keys() ^ fb.keys())
    for key, x in fa.items():
        y = fb[key]
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and x.shape == y.shape, (what, key)
            assert torch.equal(x, y), (what, key)
        else:
            assert x == y, (what, key, x, y)


# --------------------------------------------------------------------------
# spec strings and JSON
# --------------------------------------------------------------------------


AGG_SPECS = ("fedavg", "weighted", "bias_compensated", "bias_compensated:1.5",
             "staleness_weighted", "staleness_weighted:0.25", "staleness",
             "hierarchical:2", "hierarchical:2:fedavg:weighted")
PART_SPECS = ("full", "uniform:0.25", "uniform:0.5", "uniform:0.5:2",
              "dirichlet:0.3", "dirichlet:0.3:0.25")
OPT_SPECS = ("sgd", "sgd:0.05", "momentum", "momentum:0.1:0.8", "adamw",
             "adamw:0.001:0.01", "fedavgm:0.9", "fedadam:0.01")


@pytest.mark.parametrize("spec_str", AGG_SPECS)
def test_aggregator_spec_roundtrip(spec_str):
    agg = fed.make_aggregator(spec_str)
    assert agg.name == jfed.make_aggregator(spec_str).name
    part = "uniform:0.5" if agg.stateful else None
    spec = _image_spec(fed=api.FedSpec(aggregator=spec_str,
                                       participation=part),
                       execution=api.ExecutionSpec(mode="masked"))
    assert _roundtrip(spec) == spec.validate()
    assert _roundtrip(spec).fed.aggregator == spec_str


@pytest.mark.parametrize("spec_str", PART_SPECS)
def test_participation_spec_roundtrip(spec_str):
    sched = fed.make_participation(spec_str, 4)
    ref = jfed.make_participation(spec_str, 4)
    assert (sched.name, sched.subset_size, sched.shards) == (
        ref.name, ref.subset_size, ref.shards)
    spec = _image_spec(fed=api.FedSpec(participation=spec_str),
                       execution=api.ExecutionSpec(mode="sparse"))
    assert _roundtrip(spec) == spec.validate()


@pytest.mark.parametrize("spec_str", OPT_SPECS)
def test_optimizer_spec_roundtrip(spec_str):
    o = api.OptimSpec.parse(spec_str)
    j = japi.OptimSpec.parse(spec_str)
    assert dataclasses.asdict(o) == dataclasses.asdict(j)
    assert o.spec == j.spec
    o.make()
    spec = _image_spec(
        optim=o, execution=api.ExecutionSpec(
            mode="masked",
            server_optimizer=api.OptimSpec.parse(spec_str, default_lr=1.0)))
    back = _roundtrip(spec.validate())
    assert back == spec and back.execution.server_optimizer.lr is not None


def test_optimizer_alias_canonicalization():
    assert api.OptimSpec.parse("fedadam:0.01") == api.OptimSpec(
        name="adamw", lr=0.01)
    assert api.OptimSpec.parse("fedavgm:0.9:0.95") == api.OptimSpec(
        name="momentum", lr=0.9, momentum=0.95)
    assert api.OptimSpec.parse("sgd").resolve_lr(0.05) == 0.05
    assert api.OptimSpec().spec == "sgd"
    assert api.OptimSpec.parse("fedadam:0.01").spec == "adamw:0.01:0.0"
    with pytest.raises(ValueError, match="bad optimizer spec"):
        api.OptimSpec.parse("sgd:0.1:extra")
    with pytest.raises(ValueError, match="bad optimizer spec"):
        api.OptimSpec.parse("nope")


def test_lm_spec_roundtrip_and_reference_schema():
    spec = api.ExperimentSpec(
        arch="qwen1.5-0.5b", reduced=True, rounds=3, seed=7,
        scala=ScalaConfig(num_clients=8, local_iters=2, server_batch=8),
        optim=api.OptimSpec(name="momentum", schedule="cosine", warmup=4),
        fed=api.FedSpec(aggregator="bias_compensated:2.0",
                        participation="dirichlet:0.3:0.25",
                        opt_state_policy="average"),
        execution=api.ExecutionSpec(mode="sparse", backend="lace",
                                    server_optimizer=api.OptimSpec.parse(
                                        "fedadam:0.01", default_lr=1.0)),
        data=api.DataSpec(kind="lm_synthetic", seq=32, docs_per_client=4))
    spec.validate()
    assert _roundtrip(spec) == spec
    assert api.ExperimentSpec.from_json(spec.to_json()) == spec


FLAGS = ["--arch", "qwen1.5-0.5b", "--reduced", "--clients", "4",
         "--participation", "uniform:0.5", "--aggregator", "bias_compensated",
         "--optimizer", "momentum", "--rounds", "2", "--local-iters", "1",
         "--seq", "16", "--server-batch", "4", "--docs-per-client", "3"]


@pytest.mark.parametrize("extra", [[], ["--slot-gather"],
                                   ["--slot-gather", "--server-optimizer",
                                    "fedadam", "--server-lr", "0.01",
                                    "--aggregator", "staleness_weighted"]])
def test_driver_spec_is_the_reference_spec(extra, capsys):
    jtrain.main(FLAGS + extra + ["--dump-config"])
    want = json.loads(capsys.readouterr().out)
    spec = train.main(FLAGS + extra + ["--dump-config"])
    assert json.loads(capsys.readouterr().out) == want
    assert spec.execution.mode == ("sparse" if extra else "masked")
    assert spec.slots == 4 and spec.to_dict() == want


# --------------------------------------------------------------------------
# validate: the reference's rules
# --------------------------------------------------------------------------


@pytest.mark.parametrize("kw,match", [
    (dict(execution=api.ExecutionSpec(mode="sparse")),
     "needs a participation spec"),
    (dict(fed=api.FedSpec(participation="uniform:0.5"),
          execution=api.ExecutionSpec(mode="subset")),
     "needs an in-program mode"),
    (dict(fed=api.FedSpec(participation="uniform:0.5"),
          execution=api.ExecutionSpec(mode="async")), "arrival cohort IS"),
    (dict(fed=api.FedSpec(aggregator="staleness_weighted"),
          execution=api.ExecutionSpec(mode="masked")),
     "stable client identities"),
    (dict(fed=api.FedSpec(aggregator="staleness_weighted"),
          execution=api.ExecutionSpec(mode="subset")),
     "stable client identities"),
    (dict(fed=api.FedSpec(aggregator="staleness_weighted"),
          execution=api.ExecutionSpec(mode="async")), "double-decays"),
    (dict(method="splitfed_v1", execution=api.ExecutionSpec(
        mode="subset", server_optimizer=api.OptimSpec.parse(
            "fedadam:0.01"))), "not supported by the SFL"),
    (dict(method="fedavg", fed=api.FedSpec(participation="uniform:0.5"),
          execution=api.ExecutionSpec(mode="masked")),
     "only supports.*'subset'"),
    (dict(execution=api.ExecutionSpec(mode="masked", backend="lace")),
     "only supports backend 'logits'"),
    (dict(execution=api.ExecutionSpec(mode="masked",
                                      snapshots="delta")), "async"),
])
def test_validate_applies_the_reference_rules(kw, match):
    spec = _image_spec(**kw)
    with pytest.raises(ValueError, match=match):
        spec.validate()
    with pytest.raises(ValueError, match=match):
        _jax_spec(spec).validate()


def test_validate_names_the_slices_still_to_come():
    # the multi-device path is ported: the sharded pop validates with a
    # deadline, and build refuses it without a grid, as the reference's
    spec = _image_spec(execution=api.ExecutionSpec(
        mode="async", arrival="topk:sharded", deadline=2.0))
    assert spec.validate() is spec
    with pytest.raises(ValueError, match="mesh="):
        api.build(spec, device="cpu")
    # the dispatch knobs are ported: they validate, with faults too
    for kw in (dict(fed=api.FedSpec(participation="uniform:0.5",
                                    faults="drop:0.1"),
                    execution=api.ExecutionSpec(mode="masked",
                                                precision="bf16")),
               dict(fed=api.FedSpec(participation="uniform:0.5"),
                    execution=api.ExecutionSpec(mode="masked",
                                                rounds_per_call=2))):
        spec = _image_spec(**kw)
        assert spec.validate() is spec
    for fd in (api.FedSpec(participation="uniform:0.5"),
               api.FedSpec(participation="uniform:0.5", faults="drop:0.1",
                           guards="nonfinite")):
        spec = _lm_spec(fed=fd, execution=api.ExecutionSpec(
            mode="masked", backend="lace_dp"))
        assert spec.validate() is spec      # built with a grid


def test_bad_spec_strings_raise_at_construction():
    with pytest.raises(ValueError, match="unknown aggregator"):
        api.FedSpec(aggregator="nope")
    with pytest.raises(ValueError, match="takes no spec arguments"):
        api.FedSpec(aggregator="fedavg:2.0")
    with pytest.raises(ValueError, match="unknown participation"):
        api.FedSpec(participation="nope:0.5")
    with pytest.raises(ValueError, match="uniform spec"):
        api.FedSpec(participation="uniform")


# --------------------------------------------------------------------------
# build == the engine round built by hand
# --------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["masked", "sparse"])
def test_build_matches_direct_sync_round(mode):
    spec = _image_spec(fed=api.FedSpec(participation="uniform:0.5",
                                       aggregator="staleness_weighted"),
                       execution=api.ExecutionSpec(
                           mode=mode, server_optimizer=api.OptimSpec.parse(
                               "fedavgm:0.5")))
    program = api.build(spec, device="cpu")
    assert program.metadata["thread_fed"] and program.metadata["slots"] == 4
    rng = np.random.default_rng(3)
    batches = {"x": torch.from_numpy(rng.standard_normal(
        (2, 4, 5, 32, 32, 3)).astype(np.float32)),
        "labels": torch.from_numpy(rng.integers(0, 10, (2, 4, 5))),
        "weights": torch.ones(2, 4, 5)}
    sizes = torch.tensor([5.0, 4.0, 3.0, 2.0])
    state = program.init()
    assert state.fed["sched"].tolist() == [fed_seed(spec), 0]
    # the donated step gives its input up: the hand-built round starts
    # from a copy taken before it
    from repro_torch.api.build import fresh
    start = engine.TrainState(params=fresh(state.inner.params),
                              opt_state=fresh(state.inner.opt_state),
                              step=state.inner.step)
    out, metrics = program.step(state, batches, sizes)

    sched = fed.make_participation("uniform:0.5", 4)
    agg = fed.staleness_weighted()
    so = spec.execution.server_optimizer.make()
    round_fn = engine.make_round_runner(
        program.model, spec.scala, backend="logits", aggregator=agg,
        participation=sched, slot_gather=mode == "sparse",
        server_optimizer=so, server_lr=0.5)
    fs = fed.init_fed_state(fed_seed(spec), agg, sched, num_clients=4,
                            server_optimizer=so,
                            server_params=start.params["server"])
    ref, ref_fed, ref_m = round_fn(start, batches, sizes, fs)
    _equal_trees(out.inner, ref, "state")
    _equal_trees(out.fed, ref_fed, "fed state")
    assert set(metrics) == set(ref_m)
    assert all(torch.equal(metrics[k], ref_m[k]) for k in metrics)


def test_fed_seed_separates_the_streams():
    lm, img = _lm_spec(), _image_spec()
    assert fed_seed(lm) != fed_seed(img)
    assert fed_seed(lm) not in (lm.seed, lm.seed + 1, lm.seed + 7)
    assert fed_seed(dataclasses.replace(lm, seed=3)) != fed_seed(lm)


# --------------------------------------------------------------------------
# the Trainer
# --------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["masked", "sparse"])
@pytest.mark.parametrize("kind", ["lm", "image"])
def test_round_batches_match_reference(kind, mode):
    """All K slots a round, the reference's host streams; images at the
    budget round(server_batch / participation)."""
    base = _lm_spec() if kind == "lm" else _image_spec(
        fed=api.FedSpec(participation="uniform:0.5"))
    spec = dataclasses.replace(base, execution=dataclasses.replace(
        base.execution, mode=mode))
    tj, tt = japi.Trainer(_jax_spec(spec)), api.Trainer(spec, device="cpu")
    for _ in range(2):
        (bj, sj), (bt, st) = tj._next_round_batches(), tt._next_round_batches()
        np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
        assert set(bt) == set(bj)
        for k in bj:
            np.testing.assert_array_equal(bt[k].numpy(), np.asarray(bj[k]))
        assert bt["labels"].shape[1] == 4


TRAIN_CASES = [
    ("full", "fedavg", "carry", None),
    ("uniform:0.5", "weighted", "reset", "sgd:1.0"),
    ("uniform:0.5:2", "hierarchical:2", "average", "fedavgm:0.5"),
    ("dirichlet:0.5", "bias_compensated", "carry", "fedadam:0.01"),
    ("dirichlet:0.5:1.0", "staleness_weighted", "average", None),
]


@pytest.mark.parametrize("mode", ["masked", "sparse"])
@pytest.mark.parametrize("part,agg,policy,server", TRAIN_CASES)
def test_trainer_trains_every_scheduler_and_aggregator(part, agg, policy,
                                                       server, mode):
    spec = _image_spec(
        optim=api.OptimSpec(name="momentum"),
        fed=api.FedSpec(participation=part, aggregator=agg,
                        opt_state_policy=policy),
        execution=api.ExecutionSpec(
            mode=mode, server_optimizer=None if server is None
            else api.OptimSpec.parse(server)))
    t = api.Trainer(spec, device="cpu")
    hist = t.run()
    assert len(hist) == 2 and all(np.isfinite(h["loss_server"])
                                  for h in hist)
    assert t.state.fed["sched"] == () if part == "full" else \
        t.state.fed["sched"].tolist()[1] == 2
    res = t.evaluate()
    assert 0.0 <= res["acc"] <= 1.0


@pytest.mark.parametrize("server", ["fedavgm:0.9", "fedadam:0.01"])
def test_fl_baseline_takes_fedopt(server):
    spec = _image_spec(method="fedavg", execution=api.ExecutionSpec(
        mode="subset", server_optimizer=api.OptimSpec.parse(server)))
    t = api.Trainer(spec, device="cpu")
    t.run()
    assert any(float(a.abs().max()) > 0
               for a in leaves(t.state.fed["server_opt"]))
    assert all(bool(torch.isfinite(a).all()) for a in leaves(t.state.inner))


# --------------------------------------------------------------------------
# the CLI
# --------------------------------------------------------------------------


@pytest.mark.parametrize("extra,mode", [([], "masked"),
                                        (["--slot-gather"], "sparse")])
def test_cli_runs_the_reference_example(extra, mode, capsys):
    trainer = train.main(FLAGS + extra + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert (f"mode: {mode} (slots: 4), participation: uniform:0.5, "
            "aggregator: bias_compensated, opt-state: carry, optimizer: "
            "momentum") in out
    rounds = [line for line in out.splitlines() if line.startswith("round")]
    assert len(rounds) == 2 and len(trainer.history) == 2


# --------------------------------------------------------------------------
# checkpoints with fed state
# --------------------------------------------------------------------------


RESUME_SPECS = {
    "lm-masked-staleness-adamw": lambda: _lm_spec(
        rounds=3, optim=api.OptimSpec(name="momentum"),
        fed=api.FedSpec(participation="uniform:0.5",
                        aggregator="staleness_weighted"),
        execution=api.ExecutionSpec(mode="masked", backend="lace",
                                    server_optimizer=api.OptimSpec.parse(
                                        "fedadam:0.01"))),
    "image-sparse-dirichlet-bias": lambda: _image_spec(
        rounds=3, fed=api.FedSpec(participation="dirichlet:0.5",
                                  aggregator="bias_compensated"),
        execution=api.ExecutionSpec(mode="sparse",
                                    server_optimizer=api.OptimSpec.parse(
                                        "fedavgm:0.5"))),
}


@pytest.mark.parametrize("case", sorted(RESUME_SPECS))
def test_resume_with_fed_state_is_bitwise(case, tmp_path):
    spec = RESUME_SPECS[case]()
    straight = api.Trainer(spec, device="cpu")
    straight.run(3)
    first = api.Trainer(spec, device="cpu")
    first.run(2)
    first.save(str(tmp_path))
    resumed = api.Trainer(spec, device="cpu")
    assert resumed.resume(str(tmp_path)) == 2
    assert resumed.state.fed["sched"].tolist()[1] == 2
    resumed.run(1)
    _equal_trees(resumed.state, straight.state, case)
    assert resumed.history == straight.history


def test_resume_refuses_a_reference_masked_directory(tmp_path):
    tspec = _image_spec(fed=api.FedSpec(participation="uniform:0.5"),
                        execution=api.ExecutionSpec(mode="masked"))
    tj = japi.Trainer(_jax_spec(tspec))
    tj.run(1)
    tj.save(str(tmp_path))
    with pytest.raises(ValueError, match="jax.random key"):
        api.Trainer(tspec, device="cpu").resume(str(tmp_path))
    # its params still start a run (--init-params reads params only)
    lm = _lm_spec(rounds=1)
    tl = japi.Trainer(_jax_spec(lm))
    tl.save(str(tmp_path / "lm"))
    npz = str(tmp_path / "lm" / "ckpt_00000000.npz")
    path = tmp_path / "lm.json"
    path.write_text(lm.to_json())
    trainer = train.main(["--config", str(path), "--device", "cpu",
                          "--init-params", npz])
    want = jax.tree.map(np.asarray, tl.state.inner.params)
    got = trainer.program.init().inner.params
    np.testing.assert_array_equal(
        got["client"]["embed"]["tok"][0].numpy(),
        want["client"]["embed"]["tok"][0])
    assert len(trainer.history) == 1


@pytest.mark.parametrize("case", ["fedavgm", "scala-subset-fedadam"])
def test_resume_from_reference_fedopt_checkpoint(case, tmp_path):
    if case == "fedavgm":
        tspec = _image_spec(method="fedavg", execution=api.ExecutionSpec(
            mode="subset", server_optimizer=api.OptimSpec.parse(
                "fedavgm:0.9")))
    else:
        tspec = _image_spec(execution=api.ExecutionSpec(
            mode="subset", server_optimizer=api.OptimSpec.parse(
                "fedadam:0.01")))
    tj = japi.Trainer(_jax_spec(tspec))
    tj.run(1)
    tj.save(str(tmp_path))
    tt = api.Trainer(tspec, device="cpu")
    assert tt.resume(str(tmp_path)) == 1
    want = jax.tree.map(np.asarray, tj.state.fed["server_opt"])
    got = tt.state.fed["server_opt"]
    assert len(leaves(got)) == len(jax.tree.leaves(want)) > 0
    (w,), (g,) = tj.run(1)[1:], tt.run(1)[1:]
    if case != "fedavgm":
        for key in ("loss_server", "loss_client"):
            assert abs(g[key] - w[key]) <= 1e-4 * abs(w[key])


# --------------------------------------------------------------------------
# the table runner
# --------------------------------------------------------------------------


def test_table_runner_smoke_rows(capsys, tmp_path):
    from repro_torch.benchmarks import run as table_run

    rows = table_run.main(["--smoke", "--device", "cpu", "--dryrun-dir",
                           str(tmp_path)])
    assert [(r["setting"], r["method"]) for r in rows] == [
        ("exec=subset", "scala"), ("exec=masked", "scala"),
        ("exec=sparse", "scala"), ("fedavgm", "fedavg"),
        ("fused+bf16", "scala")]
    assert all(0.0 <= r["acc"] <= 1.0 and r["nonfinite_leaves"] == 0
               for r in rows)
    out = capsys.readouterr().out.splitlines()
    assert out[0] == table_run.HEADER
    # the five rows, then the boundary and serving guards' rows (each
    # asserted >= 1 inside) and the roofline reprint (no records here)
    smoke = [line.split(",")[1] for line in out if line.startswith("SMOKE")]
    assert smoke == ["exec=subset", "exec=masked", "exec=sparse", "fedavgm",
                     "fused+bf16", "boundary_guard", "serve_guard"]
    assert out[-1] == "roofline,NO_DRYRUN_RESULTS,,,,"


def test_participation_leg(tmp_path):
    from repro_torch.benchmarks import run as table_run
    from repro_torch.benchmarks.participation import bench_participation

    res = bench_participation(rounds=1, K=4, Bk=2, T=1, device="cpu")
    assert set(res["modes"]) == {"frac=0.25", "frac=0.5", "frac=1.0"}
    for entry in res["modes"].values():
        assert set(entry) == {"masked", "sparse"}
        assert all(e["rounds_per_sec"] > 0 for e in entry.values())
    assert res["subset_restacked_frac=0.5"]["seconds"] > 0
    # every reference leg is ported now; an unknown one is refused
    assert {"boundary", "serve"} <= set(table_run.LEGS)
    with pytest.raises(SystemExit):
        table_run.main(["--table", "no_such_leg"])
