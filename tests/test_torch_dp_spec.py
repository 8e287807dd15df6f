"""The spec, build and Trainer layer of the port's multi-device path.

* Every refusal the reference makes around ``lace_dp`` and
  ``topk:sharded`` stays one, with the reference's message
  (``api/specs.py``: a non-decomposable aggregator or the ``average``
  policy on the sparse / async programs, ``topk:sharded`` redundant under
  ``lace_dp``, host paging on ``lace_dp``, faults / guards / deadline on
  the sparse / async programs; ``api/build.py``: ``lace_dp`` needs
  ``mesh=`` and ``batch_specs=``, ``topk:sharded`` needs ``mesh=``).
* The port's own refusals are gone: ``backend="lace_dp"`` and
  ``arrival="topk:sharded"`` validate wherever the reference's do, with
  faults, guards and deadlines where the reference takes them.
* ``build(spec, mesh=, batch_specs=)`` through the ``Trainer`` on a
  one-rank gloo grid (this process): ``lace_dp`` masked, sparse and
  async against the ``lace`` program of the same spec (losses within
  1e-5), and the grid's collectives counted (the server tree once a
  step over all ranks, the client tree once over ``inner``); the
  reference's deprecated ``scala_local_step_fused_dp`` warns once and is
  the engine's step.
"""
import json

import pytest
import torch
import torch.distributed as dist

from repro import api as japi
from repro_torch import api
from repro_torch.configs.base import InputShape
from repro_torch.launch.input_specs import train_batch_specs
from repro_torch.sharding import Grid, tree_specs

torch.set_num_threads(1)


def _spec_dict(ex, fd=None, clients=4):
    d = dict(arch="qwen1.5-0.5b", reduced=True, rounds=2, seed=0,
             scala=dict(num_clients=clients, participation=0.5,
                        local_iters=2, server_batch=8, lr=0.05,
                        grad_reduce_dtype=None),
             data=dict(kind="lm_synthetic", seq=16, docs_per_client=3),
             execution=dict({"backend": "lace_dp"}, **ex))
    if fd:
        d["fed"] = fd
    return d


REFUSED = [
    # api/specs.py: the in-shard programs need a decomposable aggregator
    (dict(mode="sparse"), dict(participation="uniform:0.5",
                               aggregator="bias_compensated"),
     "shard-decomposable"),
    (dict(mode="async"), dict(aggregator="staleness_weighted"),
     "shard-decomposable"),
    (dict(mode="async"), dict(opt_state_policy="average"), "average"),
    (dict(mode="sparse"), dict(participation="uniform:0.5",
                               opt_state_policy="average"), "average"),
    # topk:sharded is the lace_dp event's own pop
    (dict(mode="async", arrival="topk:sharded"), None, "redundant"),
    # host paging predicts the pop outside the event
    (dict(mode="async", snapshots="delta", opt_paging="host"),
     dict(opt_state_policy="carry"), "opt_paging='host'"),
    # faults / guards / deadline on the in-shard programs
    (dict(mode="sparse"), dict(participation="uniform:0.5",
                               faults="drop:0.1"), "in-shard"),
    (dict(mode="async"), dict(guards="nonfinite"), "in-shard"),
    (dict(mode="async", deadline=2.0), None, "in-shard"),
]


@pytest.mark.parametrize("ex,fd,match", REFUSED)
def test_reference_refusals_stay(ex, fd, match):
    d = _spec_dict(ex, fd)
    with pytest.raises(ValueError, match=match) as want:
        japi.ExperimentSpec.from_dict(json.loads(json.dumps(d))).validate()
    with pytest.raises(ValueError) as got:
        api.ExperimentSpec.from_dict(d).validate()
    assert str(got.value) == str(want.value)


ACCEPTED = [(dict(mode="subset"), None), (dict(mode="masked"), None),
            (dict(mode="sparse"), None), (dict(mode="async"), None),
            (dict(mode="async", snapshots="delta"), None),
            (dict(mode="async", boundary="dual"), None),
            (dict(mode="masked"), dict(faults="drop:0.1,corrupt:0.2:nan",
                                       guards="nonfinite,clip:10")),
            (dict(mode="async", backend="lace", arrival="topk:sharded"),
             None),
            (dict(mode="async", backend="lace", arrival="topk:sharded",
                  deadline=2.0), dict(faults="drop:0.1", guards="nonfinite"))]


@pytest.mark.parametrize("ex,extra", ACCEPTED)
def test_port_refusals_are_gone(ex, extra):
    fd = (dict(participation="uniform:0.5")
          if ex["mode"] in ("masked", "sparse") else {})
    d = _spec_dict(ex, dict(fd, **(extra or {})) or None)
    japi.ExperimentSpec.from_dict(json.loads(json.dumps(d))).validate()
    spec = api.ExperimentSpec.from_dict(d)
    assert spec.validate() is spec


def test_build_needs_the_grid():
    d = _spec_dict(dict(mode="masked"), dict(participation="uniform:0.5"))
    with pytest.raises(ValueError, match="mesh=, batch_specs="):
        api.build(api.ExperimentSpec.from_dict(d), device="cpu")
    d = _spec_dict(dict(mode="async", backend="lace", arrival="topk:sharded"))
    with pytest.raises(ValueError, match="needs build\\(spec, mesh=\\)"):
        api.build(api.ExperimentSpec.from_dict(d), device="cpu")


@pytest.fixture(scope="module")
def grid(tmp_path_factory):
    """A one-rank gloo grid in this process, torn down after the module."""
    path = tmp_path_factory.mktemp("rdv") / "init"
    dist.init_process_group("gloo", init_method=f"file://{path}", rank=0,
                            world_size=1)
    try:
        yield Grid(("data", "model"), (1, 1))
    finally:
        dist.destroy_process_group()


def _losses(spec, **kw):
    tr = api.Trainer(spec, device="cpu", **kw)
    hist = tr.run()
    return [(h["loss_server"], h["loss_client"]) for h in hist], tr


@pytest.mark.parametrize("mode", ["masked", "sparse", "async"])
def test_trainer_on_a_one_rank_grid_matches_lace(grid, mode):
    fd = dict(participation="uniform:0.5") if mode != "async" else None
    ex = dict(mode=mode, **({"cohort": 2} if mode == "async" else {}))
    dp = api.ExperimentSpec.from_dict(_spec_dict(ex, fd))
    single = api.ExperimentSpec.from_dict(_spec_dict(dict(ex, backend="lace"),
                                                     fd))
    cfg = dp.model_config()
    C = dp.slots
    shapes, axes = train_batch_specs(cfg, InputShape(
        "t", dp.data.seq, C, "train"), C)
    grid.reset_stats()
    got, tr = _losses(dp, mesh=grid, batch_specs=tree_specs(axes, shapes,
                                                            grid))
    want, _ = _losses(single)
    for (gs, gk), (ws, wk) in zip(got, want):
        assert abs(gs - ws) < 1e-5 and abs(gk - wk) < 1e-5, (got, want)
    steps = dp.rounds * dp.scala.local_iters
    # per step: the weight denominator, the loss pair, the server tree,
    # the priors' and the aux's sums; the client tree over ``inner``
    assert grid.stats["all"]["calls"] >= 4 * steps
    assert grid.stats["inner"]["calls"] >= 2 * steps
    tr._single_program("save")     # one rank holds the whole state


def test_legacy_dp_step_alias_warns_once_and_is_the_engine_step(grid):
    """``core.scala.scala_local_step_fused_dp`` (the reference's
    deprecated alias): one DeprecationWarning a process, then
    ``engine.local_step`` on ``lace_dp``; on a one-rank grid it is the
    single-program ``lace`` step (1e-6 of each leaf's largest entry)."""
    import warnings

    from repro_torch.api.build import text_split_init
    from repro_torch.core import engine, scala as core_scala
    from repro_torch.tree import leaves

    spec = api.ExperimentSpec.from_dict(_spec_dict(dict(mode="subset")))
    cfg = spec.model_config()
    model, params = text_split_init(spec, 2, "cpu")
    gen = torch.Generator().manual_seed(3)
    toks = torch.randint(0, cfg.vocab_size, (2, 1, 17), generator=gen)
    batch = {"tokens": toks[..., :-1], "labels": toks[..., 1:],
             "weights": torch.ones(2, 1, 16)}
    shapes, axes = train_batch_specs(cfg, InputShape("t", 16, 2, "train"), 2)
    specs = tree_specs(axes, shapes, grid)
    sc = spec.scala
    core_scala._DEPRECATION_WARNED.clear()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        got, m = core_scala.scala_local_step_fused_dp(
            model, params, batch, sc, grid, specs, ce_chunk=8)
        core_scala.scala_local_step_fused_dp(model, params, batch, sc, grid,
                                             specs, ce_chunk=8)
    assert sum(issubclass(w.category, DeprecationWarning)
               for w in seen) == 1
    want, wm = engine.local_step(model, params, batch, sc, backend="lace",
                                 ce_chunk=8)
    assert abs(float(m["loss_server"]) - float(wm["loss_server"])) < 1e-6
    for a, b in zip(leaves(got), leaves(want)):
        assert (a - b).abs().max() <= 1e-6 * max(b.abs().max(), 1e-6)


def test_mesh_axes_and_client_shard_count_read_the_grid(grid):
    from repro_torch.core import engine

    axes = engine.mesh_axes(grid)
    assert (axes.client, axes.inner, axes.all) == (("data",), ("model",),
                                                   ("data", "model"))
    assert engine.client_shard_count(grid) == 1
    assert grid.client_slice(4) == slice(0, 4)
    with pytest.raises(ValueError, match="layouts"):
        Grid(("model", "data"), (1, 1))
    with pytest.raises(ValueError, match="ranks"):
        Grid(("data", "model"), (2, 1))
