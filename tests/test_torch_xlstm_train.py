"""xLSTM training in the PyTorch port against the reference, on the CPU.

* The backward of the chunkwise mLSTM as K6's backward kernel computes it
  (``ref.mlstm_chunk_bwd_plain``: the states recomputed, m held
  constant, the chunks walked in reverse) against autograd of the plain
  forward and against ``jax.grad`` of the reference's
  ``xlstm.mlstm_chunk``: S = 32 in chunks of 8 (the reference's
  square-root remat then runs 2 segments) and a ragged S = 29 (the
  reference falls to chunks of 1; the port masks the last chunk), every
  input gradient within 1e-5 of its largest entry (float32 sums in
  another order; m carries rounding only, ref.py says why). From a
  nonzero initial state the state's gradient too, against autograd.
* ``split_step_grads`` on ``helpers.tiny_xlstm_cfg(num_layers=4,
  split_layer=1)`` (mLSTM, sLSTM, mLSTM, mLSTM, chunk 8) from the
  reference's params, fused and dual boundaries: losses within 1e-5
  relative, every grad leaf within 1e-4 of its largest entry (the
  engine tests' bar).
* The sLSTM scan's written-out backward against autograd of its loop.
* Group remat (``server_forward(remat=True)``) on a layout with a scan
  group: one round equals the round without it bitwise, and the mLSTM
  forward runs again on each backward pass through the group.
* One spec written by the reference CLI's ``--dump-config`` runs
  through both CLIs' ``--config`` from the same params, with the same
  per-round losses (1e-4 relative). The reference's reduced xlstm-1.3b
  compiles for over a minute on this CPU, so the spec's model is the
  tiny xLSTM config on both sides (``ExperimentSpec.model_config``
  patched), with one local step a round: the loss at the start and after
  one update. Past the first update the two runs part by float32
  rounding alone: the reference against itself from params perturbed by
  1e-7 relative moves the second step's loss by 4e-5 and its updates by
  3% of the largest entry (the gradient jumps where a token's
  denominator max(|q.n|, e^{-m}) changes branch).
"""
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from helpers import tiny_xlstm_cfg
from repro import api as japi
from repro import checkpoint as jckpt
from repro.configs.base import ScalaConfig as JScala
from repro.core import engine as jengine
from repro.core.scala import transformer_split_model as j_split_model
from repro.launch import train as jtrain
from repro.models import transformer as JT
from repro.models.layers import xlstm as jxlstm
from repro_torch import api, convert
from repro_torch.configs.base import ModelConfig as TModelConfig
from repro_torch.configs.base import ScalaConfig as TScala
from repro_torch.configs.base import XLSTMConfig as TXLSTMConfig
from repro_torch.core import engine
from repro_torch.core.scala import transformer_split_model
from repro_torch.kernels.mlstm import ops, ref
from repro_torch.launch import train
from repro_torch.optim import optimizers
from repro_torch.tree import leaves

torch.set_num_threads(1)
BWD_RTOL = 1e-5
LEAF_RTOL, LOSS_RTOL = 1e-4, 1e-5


def _port_cfg(cfg):
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
              if f.name not in ("moe", "mamba", "xlstm")}
    return TModelConfig(**fields, xlstm=TXLSTMConfig(
        **dataclasses.asdict(cfg.xlstm)))


def _rel(got, want):
    got, want = (np.asarray(x, np.float64) for x in (got, want))
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _mlstm_inputs(seed, B, S, H, dk, dv):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, dk), np.float32) * dk ** -0.5
    k = rng.standard_normal((B, S, H, dk), np.float32)
    v = rng.standard_normal((B, S, H, dv), np.float32)
    i_raw = rng.standard_normal((B, S, H), np.float32)
    f_log = np.asarray(F.logsigmoid(torch.from_numpy(
        rng.standard_normal((B, S, H), np.float32) + 2.0)))
    dh = rng.standard_normal((B, S, H, dv), np.float32)
    return q, k, v, i_raw, f_log, dh


@pytest.mark.parametrize("S", [32, 29])
def test_bwd_plain_matches_autograd_and_reference_grad(S):
    B, H, dk, dv, chunk = 2, 2, 16, 16, 8   # the reference has dk = dv
    q, k, v, i_raw, f_log, dh = _mlstm_inputs(S, B, S, H, dk, dv)
    got = ref.mlstm_chunk_bwd_plain(
        *map(torch.from_numpy, (q, k, v, i_raw, f_log, dh)), chunk=chunk)
    assert got[5] is None
    xs = [torch.from_numpy(a).requires_grad_() for a in (q, k, v, i_raw,
                                                         f_log)]
    h, _ = ref.mlstm_chunk_plain(*xs, chunk=chunk)
    autograd = torch.autograd.grad((h * torch.from_numpy(dh)).sum(), xs)
    zero = (jnp.zeros((B, H, dk, dv)), jnp.zeros((B, H, dk)),
            jnp.zeros((B, H)))

    def loss(q, k, v, i_raw, f_log):
        h, _ = jxlstm.mlstm_chunk(q, k, v, i_raw, f_log, zero, chunk)
        return (h * dh).sum()

    want = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(
        *map(jnp.asarray, (q, k, v, i_raw, f_log)))
    for name, g, a, w in zip(("dq", "dk", "dv", "di", "df"), got, autograd,
                             want):
        assert _rel(g, a.numpy()) <= BWD_RTOL, (name, "autograd")
        assert _rel(g, np.asarray(w)) <= BWD_RTOL, (name, "jax.grad")


def test_bwd_plain_initial_state_gradient():
    """From a nonzero (C, n, m): every input's and the initial state's
    gradient against autograd, through ``ops.mlstm_chunkwise`` (the
    autograd Function, which runs the plain backward on the CPU)."""
    B, S, H, dk, dv, chunk = 1, 21, 2, 8, 16, 8
    q, k, v, i_raw, f_log, dh = _mlstm_inputs(7, B, S, H, dk, dv)
    rng = np.random.default_rng(8)
    state = (0.1 * rng.standard_normal((B, H, dk, dv), np.float32),
             0.1 * np.abs(rng.standard_normal((B, H, dk), np.float32)),
             rng.standard_normal((B, H), np.float32))
    runs = []
    for fn in (ops.mlstm_chunkwise, ref.mlstm_chunk_plain):
        xs = [torch.from_numpy(a).requires_grad_()
              for a in (q, k, v, i_raw, f_log) + state]
        h, _ = fn(*xs[:5], tuple(xs[5:]), chunk=chunk)
        runs.append(torch.autograd.grad((h * torch.from_numpy(dh)).sum(),
                                        xs))
    for i, (g, w) in enumerate(zip(*runs)):
        assert _rel(g, w) <= BWD_RTOL, i


@pytest.mark.parametrize("shift", [0.0, -20.0])
def test_slstm_scan_backward_matches_autograd_of_the_loop(shift):
    """``xlstm.SLSTMScan`` (the sLSTM recurrence with its backward written
    out) against autograd of the same loop: h bitwise, the gradients of gx
    and of r_gates within 1e-5 of their largest entry (float32 sums in
    another order). shift -20 drives n below the 1e-6 clamp for some
    entries."""
    from repro_torch.models.layers import xlstm

    rng = np.random.default_rng(3)
    B, S, H, hd = 3, 40, 2, 8
    gx = torch.from_numpy(rng.standard_normal((B, S, 8 * hd), np.float32)
                          * (12.0 if shift else 2.0) + shift)
    r = torch.from_numpy(rng.standard_normal((4, H, hd, hd), np.float32)
                         * 0.5)
    dh = torch.from_numpy(rng.standard_normal((B, S, H * hd), np.float32))
    runs = []
    for scan in (lambda g, R: xlstm.SLSTMScan.apply(g, R)[0],
                 lambda g, R: xlstm._slstm_loop(g, R)[0]):
        g, rg = gx.clone().requires_grad_(), r.clone().requires_grad_()
        h = scan(g, xlstm._recurrent(rg))
        runs.append((h,) + torch.autograd.grad((h * dh).sum(), (g, rg)))
    (h1, *g1), (h2, *g2) = runs
    assert torch.equal(h1, h2)
    for a, b in zip(g1, g2):
        assert _rel(a.numpy(), b.numpy()) <= BWD_RTOL


def _step_setup(num_layers, split_layer, C=2, S=32, seed=0):
    cfg = tiny_xlstm_cfg(num_layers=num_layers, split_layer=split_layer)
    key = jax.random.PRNGKey(seed)
    params = jengine.init_scala_params(
        key, lambda k: JT.init_params(k, cfg)["client"],
        lambda k: JT.init_params(k, cfg)["server"], C)
    rng = np.random.default_rng(seed)
    params = jax.tree.map(lambda a: np.asarray(a) + 0.02 * rng.standard_normal(
        a.shape).astype(np.float32), params)
    toks = rng.integers(0, cfg.vocab_size, (2, C, 2, S + 1))
    weights = np.ones((2, C, 2, S), np.float32)
    weights[:, -1, -1, S // 2:] = 0.0            # an eq. 3 padding tail
    batches = {"tokens": toks[..., :-1].astype(np.int32),
               "labels": toks[..., 1:].astype(np.int32), "weights": weights}
    return cfg, params, batches


def _flat(tree):
    if isinstance(tree, dict):
        return [x for key in sorted(tree) for x in _flat(tree[key])]
    return [tree]


@pytest.mark.parametrize("boundary", ["fused", "dual"])
def test_split_step_matches_reference(boundary):
    cfg, params, batches = _step_setup(4, 1)
    pcfg = _port_cfg(cfg)
    batch = {key: a[0] for key, a in batches.items()}
    scala = dict(num_clients=2, tau=1.0)
    want, wm = jax.jit(lambda p, b: jengine.split_step_grads(
        j_split_model(cfg), p, b, JScala(**scala), backend="lace",
        boundary=boundary))(jax.tree.map(jnp.asarray, params),
                            jax.tree.map(jnp.asarray, batch))
    got, gm = engine.split_step_grads(
        transformer_split_model(pcfg),
        convert.train_params_from_reference(params, pcfg),
        {key: torch.from_numpy(a) for key, a in batch.items()},
        TScala(**scala), boundary=boundary)
    for key in ("loss_server", "loss_client"):
        assert abs(float(gm[key]) - float(wm[key])) <= LOSS_RTOL * abs(
            float(wm[key])), key
    want = convert.train_params_from_reference(
        jax.tree.map(np.asarray, want), pcfg)
    g, w = _flat(got), _flat(want)
    assert len(g) == len(w)
    for i, (a, b) in enumerate(zip(g, w)):
        assert _rel(a.detach().numpy(), b.numpy()) <= LEAF_RTOL, i


def test_group_remat_round_is_bitwise_and_recomputes(monkeypatch):
    """tiny_xlstm_cfg(num_layers=6, split_layer=1): client layer 0, the
    prologue 1-2, one scan group 3-5 (mLSTM, sLSTM, mLSTM). The server
    trunk is pulled back twice a step, so each of the group's mLSTM
    layers runs its forward three times a step with remat, once
    without."""
    cfg, params, batches = _step_setup(6, 1)
    pcfg = _port_cfg(cfg)
    calls = []
    plain = ref.mlstm_chunk_plain

    def counted(*args, **kw):
        calls.append(1)
        return plain(*args, **kw)

    monkeypatch.setattr(ref, "mlstm_chunk_plain", counted)
    sizes = torch.tensor([3.0, 1.0])
    out = {}
    for remat in (True, False):
        run = engine.make_round_runner(
            transformer_split_model(pcfg, remat=remat),
            TScala(num_clients=2, lr=0.05))
        state = engine.init_train_state(
            convert.train_params_from_reference(params, pcfg),
            optimizers.sgd())
        calls.clear()
        out[remat] = run(state, {key: torch.from_numpy(a) for key, a in
                                 batches.items()}, sizes)
        # per step: 2 clients x layer 0, prologue layer 2, group 3 and 5
        assert len(calls) == 2 * (2 + 1 + 2 * (3 if remat else 1)), remat
    (s1, m1), (s0, m0) = out[True], out[False]
    assert all(torch.equal(a, b) for a, b in zip(leaves(s1.params),
                                                 leaves(s0.params)))
    for key in ("loss_server", "loss_client"):
        assert torch.equal(torch.as_tensor(m1[key]), torch.as_tensor(m0[key]))


LINE = re.compile(r"^round +(\d+) loss_s=([\d.]+) loss_c=([\d.]+) \(")
FLAGS = ["--arch", "xlstm-1.3b", "--reduced", "--rounds", "2", "--clients",
         "4", "--participation", "0.5", "--local-iters", "1", "--seq", "16",
         "--server-batch", "4", "--docs-per-client", "4", "--lr", "0.05"]


def test_dumped_config_same_losses_through_both_clis(tmp_path, capsys,
                                                        monkeypatch):
    cfg = tiny_xlstm_cfg(num_layers=6, split_layer=1, vocab_size=512)
    monkeypatch.setattr(japi.ExperimentSpec, "model_config",
                        lambda self: cfg)
    monkeypatch.setattr(api.ExperimentSpec, "model_config",
                        lambda self: _port_cfg(cfg))
    path = str(tmp_path / "run.json")
    jtrain.main(FLAGS + ["--dump-config", path])
    spec = japi.ExperimentSpec.from_json(open(path).read())
    assert spec.arch == "xlstm-1.3b" and spec.reduced
    npz = jckpt.save(str(tmp_path / "init"), 0,
                     japi.build(spec).init().inner.params)
    capsys.readouterr()
    want = jtrain.main(["--config", path]).history
    ref_lines = [l for l in capsys.readouterr().out.splitlines()
                 if LINE.match(l)]
    got = train.main(["--config", path, "--device", "cpu", "--init-params",
                      npz]).history
    lines = [l for l in capsys.readouterr().out.splitlines() if LINE.match(l)]
    assert len(got) == len(want) == len(lines) == len(ref_lines) == 2
    for g, w in zip(got, want):
        for key in ("loss_server", "loss_client"):
            assert np.isfinite(g[key])
            assert abs(g[key] - w[key]) <= 1e-4 * abs(w[key]), (key, g, w)
