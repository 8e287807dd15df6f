"""The port's training CLI against the reference's, on the CPU.

* One spec, written by ``repro.launch.train --dump-config`` (qwen1.5-0.5b
  reduced, host-side subset sampling, 2 rounds), runs through both CLIs
  from the same params (the reference's init, handed to the port as a
  ``repro.checkpoint`` file with ``--init-params``): the per-round losses
  match at 1e-4 relative (float32, sums in another order over two
  rounds), and the port prints the reference's round lines.
* The host streams: both Trainers assemble identical round batches, and
  the data modules (synthetic sets, label-skew partitions, image round
  batches) draw the same numbers from the same seed.
* ``Trainer.evaluate`` (the global model's held-out next-token loss and
  accuracy) after one round from the same params: loss at 1e-4
  relative, accuracy within one token in 1000.
* ``--dump-config`` writes the reference's JSON schema.
* ``validate()`` names what is not ported, applies the reference's rules
  (AlexNet is ``logits``-only) and admits the paper's setup.
"""
import dataclasses
import json
import re

import jax
import numpy as np
import pytest
import torch

from repro import api as japi
from repro import checkpoint as jckpt
from repro.launch import train as jtrain
from repro_torch import api
from repro_torch.launch import train

torch.set_num_threads(1)

FLAGS = ["--arch", "qwen1.5-0.5b", "--reduced", "--rounds", "2",
         "--clients", "4", "--participation", "0.5", "--local-iters", "2",
         "--seq", "16", "--server-batch", "4", "--docs-per-client", "4",
         "--lr", "0.05"]
LINE = re.compile(r"^round +(\d+) loss_s=([\d.]+) loss_c=([\d.]+) \(")


def test_same_config_same_losses_through_both_clis(tmp_path, capsys):
    cfg_path = str(tmp_path / "run.json")
    jtrain.main(FLAGS + ["--dump-config", cfg_path])
    spec = japi.ExperimentSpec.from_json(open(cfg_path).read())
    params = japi.build(spec).init().inner.params
    npz = jckpt.save(str(tmp_path / "init"), 0, params)
    capsys.readouterr()

    want = jtrain.main(["--config", cfg_path]).history
    ref_out = capsys.readouterr().out
    got = train.main(["--config", cfg_path, "--device", "cpu",
                      "--init-params", npz]).history
    out = capsys.readouterr().out
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        for key in ("loss_server", "loss_client"):
            assert abs(g[key] - w[key]) <= 1e-4 * abs(w[key]), (key, g, w)
    lines = [LINE.match(l) for l in out.splitlines() if l.startswith("round")]
    ref_lines = [LINE.match(l) for l in ref_out.splitlines()
                 if l.startswith("round")]
    assert len(lines) == len(ref_lines) == 2 and all(lines)
    assert [m.group(1) for m in lines] == [m.group(1) for m in ref_lines]


def test_round_batches_match_reference():
    spec_j = jtrain.spec_from_args(jtrain.build_parser().parse_args(FLAGS))
    spec_t = train.spec_from_args(train.build_parser().parse_args(FLAGS))
    tj = japi.Trainer(spec_j)
    tt = api.Trainer(spec_t, device="cpu")
    for _ in range(2):
        (bj, sj), (bt, st) = tj._next_round_batches(), tt._next_round_batches()
        np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
        assert set(bt) == set(bj)
        for k in bj:
            np.testing.assert_array_equal(bt[k].numpy(), np.asarray(bj[k]))


@pytest.mark.parametrize("skew", [dict(alpha=2), dict(beta=0.5)])
def test_data_modules_match_reference(skew):
    from repro.data import loader as jloader, partition as jpartition
    from repro.data import synthetic as jsynthetic
    from repro_torch.data import loader, partition, synthetic

    x, y = synthetic.gaussian_images(120, num_classes=6, hw=8, seed=3)
    xj, yj = jsynthetic.gaussian_images(120, num_classes=6, hw=8, seed=3)
    np.testing.assert_array_equal(x, xj)
    np.testing.assert_array_equal(y, yj)
    parts = partition.partition(y, 5, num_classes=6, seed=4, **skew)
    parts_j = jpartition.partition(yj, 5, num_classes=6, seed=4, **skew)
    assert len(parts) == len(parts_j) == 5
    for a, b in zip(parts, parts_j):
        np.testing.assert_array_equal(a, b)
    data = loader.FederatedData.from_partition(x, y, parts)
    data_j = jloader.FederatedData.from_partition(xj, yj, parts_j)
    rng, rng_j = np.random.default_rng(5), np.random.default_rng(5)
    sel = loader.sample_clients(5, 3, rng)
    sel_j = jloader.sample_clients(5, 3, rng_j)
    np.testing.assert_array_equal(sel, sel_j)
    got = loader.round_batches(data, sel, 8, 2, rng)
    want = jloader.round_batches(data_j, sel_j, 8, 2, rng_j)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))
    with pytest.raises(ValueError, match="exactly one"):
        partition.partition(y, 5, alpha=2, beta=0.5)


def test_evaluate_matches_reference():
    from repro_torch import convert

    spec_j = jtrain.spec_from_args(jtrain.build_parser().parse_args(FLAGS))
    spec_t = train.spec_from_args(train.build_parser().parse_args(FLAGS))
    tj = japi.Trainer(spec_j)
    params = jax.tree_util.tree_map(np.asarray, tj.state.inner.params)
    tt = api.Trainer(spec_t, device="cpu", params=convert.
                     train_params_from_reference(params,
                                                 spec_t.model_config()))
    tj.step()
    tt.step()
    got, want = tt.evaluate(), tj.evaluate()
    assert abs(got["eval_loss"] - want["eval_loss"]) <= 1e-4 * want["eval_loss"]
    assert abs(got["eval_accuracy"] - want["eval_accuracy"]) <= 1e-3


def test_dual_boundary_cli_runs_plain_and_matches_fused():
    """``--boundary dual --device cpu``: the plain versions (no kernel
    launches) and, the CPU contract, the same per-round losses as the
    fused boundary bit for bit."""
    from repro_torch.kernels.lace import ops

    before = (ops.LAUNCHES_FWD, ops.LAUNCHES_BWD, ops.LAUNCHES_FWD1,
              ops.LAUNCHES_BWD1)
    hist = {b: train.main(FLAGS + ["--device", "cpu", "--boundary", b])
            .history for b in ("fused", "dual")}
    assert before == (ops.LAUNCHES_FWD, ops.LAUNCHES_BWD, ops.LAUNCHES_FWD1,
                      ops.LAUNCHES_BWD1)
    assert hist["dual"] == hist["fused"] and len(hist["dual"]) == 2


def test_dump_config_writes_the_reference_schema(capsys):
    jtrain.main(FLAGS + ["--dump-config"])
    want = json.loads(capsys.readouterr().out)
    train.main(FLAGS + ["--dump-config"])
    got = json.loads(capsys.readouterr().out)
    assert got == want
    spec = api.ExperimentSpec.from_json(json.dumps(want))
    assert spec.to_dict() == want
    assert spec.execution.mode == "subset" and spec.slots == 2


def _spec(**kw):
    base = train.spec_from_args(train.build_parser().parse_args(FLAGS))
    out = base
    for part, fields in kw.items():
        if part == "top":
            out = dataclasses.replace(out, **fields)
        else:
            out = dataclasses.replace(
                out, **{part: dataclasses.replace(getattr(out, part),
                                                  **fields)})
    return out


# the CNN family on its data (the paper's setup)
ALEXNET = dict(arch="alexnet-cifar", reduced=False,
               data=api.DataSpec(kind="image_synthetic", alpha=2))


@pytest.mark.parametrize("change,error,match", [
    # the in-program modes are ported: masked runs all K slots, sparse
    # needs a scheduler
    pytest.param(dict(execution=dict(mode="masked")), None, None,
                 id="masked-validates"),
    pytest.param(dict(execution=dict(mode="sparse")), ValueError,
                 "needs a participation spec",
                 id="sparse-ValueError-needs a participation spec"),
    # the async event runtime is ported, and the multi-device path (the
    # ids name what these cases checked before it was)
    pytest.param(dict(execution=dict(mode="async")), None, None,
                 id="async-validates"),
    pytest.param(dict(execution=dict(mode="async", arrival="topk:sharded")),
                 None, None,
                 id="async-topk-sharded-NotImplementedError"),
    pytest.param(dict(execution=dict(backend="lace_dp")),
                 None, None,
                 id="lace_dp-NotImplementedError"),
    # AlexNet has no trunk/head split: the reference's rule
    pytest.param(dict(top=ALEXNET, execution=dict(backend="lace")),
                 ValueError, "only supports backend 'logits'",
                 id="alexnet-lace-ValueError"),
    # the FL baselines run on the CNN family in subset mode
    pytest.param(dict(top=dict(ALEXNET, method="fedavg"),
                      execution=dict(backend="logits")), None, None,
                 id="alexnet-fedavg-validates"),
    # the dispatch knobs are ported (the ids name what these cases
    # checked before they were)
    pytest.param(dict(execution=dict(precision="bf16")), None, None,
                 id="bf16-NotImplementedError"),
    pytest.param(dict(execution=dict(rounds_per_call=2)), None, None,
                 id="rounds_per_call-NotImplementedError"),
    # server FedOpt is ported; it needs its lr, as the reference's round
    pytest.param(dict(execution=dict(server_optimizer=api.OptimSpec(
        name="sgd"))), ValueError, "server_optimizer needs its lr",
        id="server_optimizer-ValueError-needs its lr"),
    # faults and guards are ported in the in-program modes, and with the
    # dispatch knobs
    pytest.param(dict(fed=dict(faults="drop:0.1"),
                      execution=dict(mode="masked", precision="bf16")),
                 None, None, id="faults-NotImplementedError"),
    pytest.param(dict(fed=dict(guards="nonfinite"),
                      execution=dict(mode="masked", rounds_per_call=2)),
                 None, None, id="guards-NotImplementedError"),
    pytest.param(dict(fed=dict(faults="drop:0.1", guards="nonfinite"),
                      execution=dict(mode="masked")), None, None,
                 id="faults-guards-masked-validates"),
    pytest.param(dict(fed=dict(faults="drop:0.1")), ValueError,
                 "mode 'subset' re-stacks", id="faults-subset-ValueError"),
    # bias_compensated is ported and validates
    pytest.param(dict(fed=dict(aggregator="bias_compensated")), None, None,
                 id="bias_compensated-validates"),
    # ... and the reference refuses the baselines on a text arch
    pytest.param(dict(top=dict(method="fedavg")), ValueError,
                 "needs the CNN", id="text-fedavg-ValueError-needs the CNN"),
    # xLSTM trains (K6's backward is ported)
    pytest.param(dict(top=dict(arch="xlstm-1.3b")), None, None,
                 id="xlstm-validates"),
    # the paper's setup validates: AlexNet, logits, the dual boundary
    pytest.param(dict(top=ALEXNET, execution=dict(backend="logits",
                                                  boundary="dual")),
                 None, None, id="alexnet-dual-validates"),
    # the MoE archs train (the router loss's cotangent is ported)
    pytest.param(dict(top=dict(arch="qwen3-moe-30b-a3b")), None, None,
                 id="qwen3-moe-NotImplementedError"),
    pytest.param(dict(top=dict(arch="dbrx-132b")), None, None,
                 id="dbrx-NotImplementedError"),
])
def test_validate_names_what_is_not_ported(change, error, match):
    if error is None:
        spec = _spec(**change)
        assert spec.validate() is spec
    else:
        with pytest.raises(error, match=match):
            _spec(**change).validate()
    _spec().validate()
    # the sharded pop is ported, on a grid of ranks: the CLI builds none,
    # as the reference's builds no mesh
    with pytest.raises(SystemExit, match="mesh="):
        train.main(FLAGS + ["--device", "cpu", "--async", "--faults",
                            "drop:0.1", "--arrival", "topk:sharded"])


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "dbrx-132b",
                                  "jamba-1.5-large-398b"])
def test_moe_archs_validate_and_train_through_the_cli(arch, capsys):
    """The MoE archs (jamba's mixers mamba and attention) validate for
    training, and the port's CLI trains each, reduced, for 2 rounds on
    the CPU with finite losses and router loss."""
    spec = _spec(top=dict(arch=arch))
    assert spec.validate() is spec
    flags = [arch if f == "qwen1.5-0.5b" else f for f in FLAGS]
    history = train.main(flags + ["--device", "cpu"]).history
    lines = [l for l in capsys.readouterr().out.splitlines()
             if LINE.match(l)]
    assert len(history) == len(lines) == 2
    for h in history:
        for key in ("loss_server", "loss_client", "aux"):
            assert np.isfinite(h[key]), (arch, key, h)
        assert h["aux"] > 0, (arch, h)
