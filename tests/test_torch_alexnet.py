"""AlexNet -- the paper's model -- on the PyTorch port, against the JAX
reference on the CPU.

* The model: logits of the full forward and of the split halves for
  every split point s1-s5, and the features, from the reference's params
  at width 0.125 converted by ``repro_torch.convert`` (conv weights HWIO
  -> OIHW, the NHWC flatten kept): within 1e-4 of the largest logit
  (float32 convolutions summed in another order).
* The Trainer: the paper's path (``ExperimentSpec`` -> ``build`` ->
  ``Trainer``, ``image_synthetic`` data, subset sampling, backend
  ``logits``, both boundaries) for two rounds from the same params (the
  host streams draw the same batches): per-round losses within 1e-4
  relative, and
  ``evaluate()``'s accuracy and class-balanced accuracy within one test
  image (an argmax may flip on a near-tie).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.configs.base import ScalaConfig as JScala
from repro.models import alexnet as JA
from repro_torch import api, convert
from repro_torch.configs import ScalaConfig
from repro_torch.models import alexnet as TA
from repro_torch.tree import leaves

torch.set_num_threads(1)


def _ref_params(seed=0, width=0.125):
    full = JA.init_params(jax.random.PRNGKey(seed), num_classes=10,
                          width=width)
    rng = np.random.default_rng(seed)
    # nonzero biases, so a misplaced bias or flatten order shows
    return jax.tree.map(lambda a: np.asarray(a) + 0.05 * rng.standard_normal(
        a.shape).astype(np.float32), full)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-6)


@pytest.mark.parametrize("split", ["s1", "s2", "s3", "s4", "s5"])
def test_logits_match_reference(split):
    params = _ref_params()
    tp = convert.alexnet_params_from_reference(params)
    assert tp["convs"][0]["w"].shape == (8, 3, 3, 3)      # OIHW
    x = np.random.default_rng(1).standard_normal((5, 32, 32, 3)).astype(
        np.float32)
    want = JA.forward(jax.tree.map(jnp.asarray, params), jnp.asarray(x),
                      split)
    xt = torch.from_numpy(x)
    assert _rel(TA.forward(tp, xt, split).numpy(), want) <= 1e-4
    wc, ws = TA.split_params(tp, split)
    acts = TA.client_forward_from_split(wc, xt, split)
    assert _rel(TA.server_forward_from_split(ws, acts, split).numpy(),
                want) <= 1e-4
    merged = TA.merge_params(wc, ws)
    assert all(a is b for a, b in zip(merged["convs"], tp["convs"]))
    jwc, _ = JA.split_params(params, split)
    want_acts = JA.client_forward_from_split(
        jax.tree.map(jnp.asarray, jwc), jnp.asarray(x), split)
    assert _rel(acts.permute(0, 2, 3, 1).numpy(), want_acts) <= 1e-4
    if split == "s2":
        assert _rel(TA.features(tp, xt).numpy(), JA.features(
            jax.tree.map(jnp.asarray, params), jnp.asarray(x))) <= 1e-4


def test_init_matches_reference_shapes():
    full = TA.init_params(torch.Generator().manual_seed(0), width=0.125)
    ref = convert.alexnet_params_from_reference(_ref_params())
    assert [a.shape for a in leaves(full)] == [a.shape for a in leaves(ref)]
    assert all(float(c["b"].abs().max()) == 0.0 for c in full["convs"])


def _specs(boundary):
    sc = dict(num_clients=6, participation=0.5, local_iters=2,
              server_batch=12, lr=0.05)
    jspec = japi.ExperimentSpec(
        arch="alexnet-cifar", split="s2", width=0.125, method="scala",
        rounds=2, seed=3, scala=JScala(**sc),
        execution=japi.ExecutionSpec(mode="subset", backend="logits",
                                     boundary=boundary, unroll=0),
        data=japi.DataSpec(kind="image_synthetic", n_train=240, n_test=60,
                           alpha=2))
    tspec = api.ExperimentSpec.from_dict(dict(
        jspec.to_dict(), scala=ScalaConfig(**dataclasses.asdict(
            jspec.scala))))
    return jspec, tspec


@pytest.mark.parametrize("boundary", ["fused", "dual"])
def test_trainer_matches_reference(boundary):
    jspec, tspec = _specs(boundary)
    tj = japi.Trainer(jspec)
    params = jax.tree.map(np.asarray, tj.state.inner.params)
    tt = api.Trainer(tspec, device="cpu", params=convert.
                     train_params_from_reference(params,
                                                 tspec.model_config()))
    assert tt.program.metadata["boundary"] == boundary
    want_hist, got_hist = tj.run(), tt.run()
    assert len(got_hist) == len(want_hist) == 2
    for r, (g, w) in enumerate(zip(got_hist, want_hist)):
        assert set(g) == set(w), (set(g), set(w))
        for key in ("loss_server", "loss_client"):
            assert np.isfinite(g[key]), (r, key)
            assert abs(g[key] - w[key]) <= 1e-4 * abs(w[key]), (r, key, g, w)
    got, want = tt.evaluate(), tj.evaluate()
    assert set(got) == set(want) == {"acc", "balanced_acc"}
    for key in want:
        assert abs(got[key] - want[key]) <= 1 / 60 + 1e-6, (key, got, want)
