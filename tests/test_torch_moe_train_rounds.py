"""MoE training in the PyTorch port against the reference, on the CPU:
rounds, the federation path, a hybrid and the CLIs (the split step's
cases, and the helpers shared here, are in ``test_torch_moe_train.py``).

* The split step on a mamba + MoE hybrid (``tiny_mamba_cfg`` with
  ``ffn_pattern=("moe",)``, capacity factor 0.5): losses and ``aux``
  within 1e-5 relative, every grad leaf within 1e-4 of its largest entry.
* One two-step ``make_round_runner`` round (SGD, weighted FedAvg, the
  tight capacity) in float32 at those bars, and one with ``param_dtype =
  "bfloat16"``: every entry of a bf16 leaf within one bf16 ulp of the
  reference's (``BF16_ULPS``; the SGD update is float32 rounded once, and
  FedAvg multiplies and sums in float32 and rounds once, as XLA does on
  a CPU: a float32 update near a rounding boundary may land one ulp
  apart; measured: none does), the float32 routers at the float32 bar.
* One masked round (uniform 0.5 of 4 slots, the reference's masks
  injected, two rounds), so the federation path carries the new
  cotangent: losses and ``aux`` a round, the params at the end.
* One spec written by the reference CLI's ``--dump-config`` (qwen3-moe
  reduced) runs through both CLIs' ``--config`` with the same per-round
  losses (1e-4 relative); the spec's model is the tiny MoE config at
  capacity factor 0.5 on both sides (``ExperimentSpec.model_config``
  patched), as the reference compiles its reduced qwen3-moe for minutes
  on a CPU.

Each port run asserts the nearest top-k router gap first
(``test_torch_moe_train._gaps_above``).
"""
import dataclasses
import importlib.util
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import tiny_moe_cfg
from repro import api as japi
from repro import checkpoint as jckpt
from repro import fed as jfed
from repro.configs.base import ScalaConfig as JScala
from repro.core import engine as jengine
from repro.core.scala import transformer_split_model as j_split_model
from repro.launch import train as jtrain
from repro.optim import optimizers as jopt
from repro_torch import api, convert
from repro_torch import fed as tfed
from repro_torch.configs.base import ScalaConfig as TScala
from repro_torch.core import engine
from repro_torch.core.scala import transformer_split_model
from repro_torch.launch import train
from repro_torch.optim import optimizers
from repro_torch.tree import leaves
from test_torch_moe_train import (_close, _close_tree, _gaps_above, _moe,
                                  _np, _port_cfg, _setup, _t, check_step)

torch.set_num_threads(1)
BF16_ULPS = 1


def test_hybrid_split_step_matches_reference():
    check_step("mamba-moe", 0.5, "lace", "fused", 0.01)


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_round_matches_reference(param_dtype):
    cfg, params, batches, sizes = _setup("moe", 0.5,
                                         param_dtype=param_dtype)
    pcfg = _port_cfg(cfg)
    scala = dict(num_clients=2, lr=0.05)
    jround = jax.jit(jengine.make_round_runner(
        j_split_model(cfg), JScala(**scala), backend="lace",
        optimizer=jopt.sgd(), aggregator=jfed.weighted(), unroll=True))
    s0 = jengine.init_train_state(jax.tree.map(jnp.asarray, params),
                                  jopt.sgd())
    s1, wm = jround(s0, jax.tree.map(jnp.asarray, batches),
                    jnp.asarray(sizes))
    tround = engine.make_round_runner(
        transformer_split_model(pcfg), TScala(**scala),
        optimizer=optimizers.sgd(), aggregator=tfed.weighted())
    t0 = convert.train_state_from_reference(_np(s0), pcfg)
    assert {a.dtype for a in leaves(t0.params)} == (
        {torch.float32} if param_dtype == "float32"
        else {torch.float32, torch.bfloat16})
    with _gaps_above():
        t1, tm = tround(t0, {k: _t(v) for k, v in batches.items()},
                        _t(sizes))
    for key in ("loss_server", "loss_client", "aux"):
        _close(tm[key], wm[key], key)
    want = convert.train_state_from_reference(_np(s1), pcfg)
    assert t1.step == want.step == 2
    for a, b in zip(leaves(t1.params), leaves(want.params)):
        assert a.dtype == b.dtype
    _close_tree(t1.params, want.params, "params",
                bf16_ulps=BF16_ULPS if param_dtype == "bfloat16" else None)
    for a in leaves(t1.params["client"]):        # FedAvg re-unified slots
        assert torch.equal(a[0], a[1])


def test_masked_round_matches_reference_with_injected_masks():
    C, rounds = 4, 2
    cfg, params, batches, sizes = _setup("moe", 0.5, C=C, Bk=1)
    pcfg = _port_cfg(cfg)
    jpart = jfed.uniform(C, 0.5)
    jfs = jfed.init_fed_state(jax.random.PRNGKey(7), jfed.weighted(), jpart)
    masks, sched = [], jfs["sched"]
    for _ in range(rounds):
        m, sched = jpart.sample(sched)
        masks.append(np.asarray(m))
    jround = jax.jit(jengine.make_round_runner(
        j_split_model(cfg), JScala(num_clients=C, lr=0.05), backend="lace",
        optimizer=jopt.sgd(), aggregator=jfed.weighted(),
        participation=jpart, unroll=True))
    tpart = _chip_smoke().recorded_scheduler(masks)
    tround = engine.make_round_runner(
        transformer_split_model(pcfg), TScala(num_clients=C, lr=0.05),
        optimizer=optimizers.sgd(), aggregator=tfed.weighted(),
        participation=tpart)
    js = jengine.init_train_state(jax.tree.map(jnp.asarray, params),
                                  jopt.sgd())
    ts = convert.train_state_from_reference(_np(js), pcfg)
    tfs = tfed.init_fed_state(0, tfed.weighted(), tpart)
    jb = jax.tree.map(jnp.asarray, batches)
    tb = {k: _t(v) for k, v in batches.items()}
    for r in range(rounds):
        js, jfs, jm = jround(js, jb, jnp.asarray(sizes), jfs)
        with _gaps_above():
            ts, tfs, tm = tround(ts, tb, _t(sizes), tfs)
        for key in ("loss_server", "loss_client", "aux"):
            _close(tm[key], jm[key], f"round {r} {key}")
    _close_tree(ts.params, convert.train_state_from_reference(
        _np(js), pcfg).params, "params")


def _chip_smoke():
    """``chip_smoke.py`` at the repo's root as a module (its scheduler of
    recorded masks)."""
    path = os.path.join(os.path.dirname(__file__), "..", "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


LINE = re.compile(r"^round +(\d+) loss_s=([\d.]+) loss_c=([\d.]+) \(")
FLAGS = ["--arch", "qwen3-moe-30b-a3b", "--reduced", "--rounds", "2",
         "--clients", "4", "--participation", "0.5", "--local-iters", "2",
         "--seq", "16", "--server-batch", "4", "--docs-per-client", "4",
         "--lr", "0.05"]


def test_dumped_config_same_losses_through_both_clis(tmp_path, capsys,
                                                        monkeypatch):
    cfg = dataclasses.replace(tiny_moe_cfg(vocab_size=512), moe=_moe(0.5))
    monkeypatch.setattr(japi.ExperimentSpec, "model_config",
                        lambda self: cfg)
    monkeypatch.setattr(api.ExperimentSpec, "model_config",
                        lambda self: _port_cfg(cfg))
    path = str(tmp_path / "run.json")
    jtrain.main(FLAGS + ["--dump-config", path])
    spec = japi.ExperimentSpec.from_json(open(path).read())
    assert spec.arch == "qwen3-moe-30b-a3b" and spec.reduced
    npz = jckpt.save(str(tmp_path / "init"), 0,
                     japi.build(spec).init().inner.params)
    capsys.readouterr()
    want = jtrain.main(["--config", path]).history
    ref_lines = [l for l in capsys.readouterr().out.splitlines()
                 if LINE.match(l)]
    with _gaps_above():
        got = train.main(["--config", path, "--device", "cpu",
                          "--init-params", npz]).history
    lines = [l for l in capsys.readouterr().out.splitlines() if LINE.match(l)]
    assert len(got) == len(want) == len(lines) == len(ref_lines) == 2
    for g, w in zip(got, want):
        for key in ("loss_server", "loss_client"):
            assert np.isfinite(g[key])
            assert abs(g[key] - w[key]) <= 1e-4 * abs(w[key]), (key, g, w)
