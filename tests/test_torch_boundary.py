"""The split boundary of the PyTorch port's engine on the CPU: both
backends (``logits``, ``lace``) and both boundaries (``fused``, ``dual``).

* Against the JAX reference: ``split_step_grads`` on the same numpy
  batch and the same params (the reference's init, converted; the client
  slots perturbed so they differ) -- AlexNet (width 0.125, s2) on
  ``logits``, qwen1.5-0.5b reduced on ``lace``, a tiny transformer on
  ``logits`` -- each boundary on its own: losses within 1e-5 relative,
  every grad leaf within 1e-4 of its largest entry (float32 sums in
  another order through a few layers), accuracy exact.
* Inside the port, the reference's contract: ``fused`` and ``dual`` give
  bit-identical float32 gradients and losses on the CPU, per backend,
  for each choice of adjusted sides, with a participation mask, and
  (through the dual schedule both take) with label smoothing.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ScalaConfig as JScala
from repro.core import engine as jengine
from repro.core.scala import alexnet_split_model as j_alexnet_model
from repro.core.scala import transformer_split_model as j_split_model
from repro.models import alexnet as JA
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.configs.base import ScalaConfig as TScala
from repro_torch.core import engine
from repro_torch.core.scala import alexnet_split_model, transformer_split_model
from repro_torch.kernels.lace import ops as lace_ops
from repro_torch.tree import leaves
from test_torch_engine import (_close, _close_tree, _np, _port_cfg, _setup,
                               _t)

torch.set_num_threads(1)


def _alexnet_setup(C=3, Bk=4, seed=1):
    full = JA.init_params(jax.random.PRNGKey(seed), num_classes=10,
                          width=0.125)
    wc, ws = JA.split_params(full, "s2")
    rng = np.random.default_rng(seed)
    params = {"client": jax.tree.map(
        lambda a: np.stack([np.asarray(a) + 0.01 * rng.standard_normal(
            a.shape).astype(np.float32) for _ in range(C)]), wc),
        "server": jax.tree.map(
            lambda a: np.asarray(a) + 0.01 * rng.standard_normal(
                a.shape).astype(np.float32), ws)}
    weights = np.ones((C, Bk), np.float32)
    weights[-1, -1] = 0.0                     # an eq. 3 padding row
    batch = {"x": rng.standard_normal((C, Bk, 32, 32, 3)).astype(np.float32),
             "labels": rng.integers(0, 10, (C, Bk)).astype(np.int32),
             "weights": weights}
    return params, batch


def _models(name):
    """(reference SplitModel, port SplitModel, port config, params, batch)
    of one setup, params and batch as numpy."""
    if name == "alexnet":
        params, batch = _alexnet_setup()
        return (j_alexnet_model("s2"), alexnet_split_model("s2"),
                get_config("alexnet-cifar"), params, batch)
    cfg, params, batches, _ = _setup(name, C=3)
    pcfg = _port_cfg(cfg)
    return (j_split_model(cfg), transformer_split_model(pcfg), pcfg, params,
            {k: v[0] for k, v in batches.items()})


@pytest.mark.parametrize("name,backend,boundary", [
    ("alexnet", "logits", "fused"), ("alexnet", "logits", "dual"),
    ("qwen-reduced", "lace", "fused"), ("qwen-reduced", "lace", "dual"),
    ("tiny", "logits", "fused"), ("tiny", "logits", "dual"),
])
def test_split_step_matches_reference(name, backend, boundary):
    jmodel, tmodel, pcfg, params, batch = _models(name)
    scala = dict(num_clients=3, tau=1.3)
    want, wm = jax.jit(lambda p, b: jengine.split_step_grads(
        jmodel, p, b, JScala(**scala), backend=backend, boundary=boundary))(
        jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, batch))
    before = (lace_ops.LAUNCHES_FWD1, lace_ops.LAUNCHES_BWD1)
    got, gm = engine.split_step_grads(
        tmodel, convert.train_params_from_reference(params, pcfg),
        {k: _t(v) for k, v in batch.items()}, TScala(**scala),
        backend=backend, boundary=boundary)
    assert before == (lace_ops.LAUNCHES_FWD1, lace_ops.LAUNCHES_BWD1)
    assert set(gm) == set(wm)
    _close(gm["loss_server"], wm["loss_server"], "loss_server")
    _close(gm["loss_client"], wm["loss_client"], "loss_client")
    if backend == "logits":
        assert float(gm["accuracy"]) == float(wm["accuracy"])
    _close_tree(got, convert.train_params_from_reference(_np(want), pcfg),
                "grads")


def _fused_and_dual(name, backend, sc, mask=None):
    _, tmodel, pcfg, params, batch = _models(name)
    p = convert.train_params_from_reference(params, pcfg)
    b = {k: _t(v) for k, v in batch.items()}
    return [engine.split_step_grads(tmodel, p, b, sc, backend=backend,
                                    boundary=boundary, mask=mask)
            for boundary in ("fused", "dual")]


def _bitwise(a, b, what):
    la, lb = leaves(a), leaves(b)
    assert len(la) == len(lb), what
    for i, (x, y) in enumerate(zip(la, lb)):
        assert torch.equal(x, y), (what, i, (x - y).abs().max().item())


@pytest.mark.parametrize("name,backend", [("alexnet", "logits"),
                                          ("tiny", "logits"),
                                          ("tiny", "lace")])
def test_fused_equals_dual_bitwise(name, backend):
    for adj in ((True, True), (True, False), (False, True)):
        sc = TScala(tau=1.3, adjust_server=adj[0], adjust_client=adj[1])
        (gf, mf), (gd, md) = _fused_and_dual(name, backend, sc)
        _bitwise(gf, gd, f"grads {adj}")
        assert list(mf) == list(md)
        _bitwise(mf, md, f"metrics {adj}")


def test_fused_equals_dual_bitwise_with_mask_and_smoothing():
    mask = torch.tensor([1.0, 0.0, 1.0])
    for name, backend in (("alexnet", "logits"), ("tiny", "lace")):
        (gf, mf), (gd, md) = _fused_and_dual(name, backend,
                                             TScala(tau=1.0), mask)
        _bitwise(gf, gd, f"{name} masked grads")
        _bitwise(mf, md, f"{name} masked metrics")
        assert all(float(g[1].abs().max()) == 0.0
                   for g in leaves(gf["client"]))
    # label smoothing: the fused request runs the dual schedule
    sc = dataclasses.replace(TScala(tau=1.0), label_smoothing=0.1)
    (gf, mf), (gd, md) = _fused_and_dual("alexnet", "logits", sc)
    _bitwise(gf, gd, "smoothed grads")
    _bitwise(mf, md, "smoothed metrics")
