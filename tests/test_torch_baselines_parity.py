"""The FL / SFL baselines on the PyTorch port against the JAX package, on
the CPU: AlexNet at width 0.125 (s2, 10 classes), the reference's own
initial state converted by ``repro_torch.convert``, the same host batch
stream (both Trainers draw from the same numpy PCG64 streams, padding
rows included).

* One round of every method (``make_fl_round`` / ``make_sfl_round``
  through ``build`` and ``Trainer``): every leaf of the round's update
  (the weights, FedDyn's ``h`` by slot, splitfed_v3's client halves by
  slot, sfl_localloss's aux head) within 1e-4 of that update's largest
  entry (float32 convolutions summed in another order). FedDecorr is
  held at 1e-3: it divides each feature by its std over the ~5 images of
  a local step plus 1e-5, so a nearly dead unit multiplies float32
  rounding by up to 1e5 in its gradient; at this setting the
  reference's own float32 update lies 4.6e-4 of its largest entry from
  the port's float64 run of the same round, so no float32 run can be
  held closer to it.
* Two rounds, Trainer against Trainer (fedavg, feddyn, splitfed_v2,
  sfl_localloss): ``evaluate()`` within one test image. The per-leaf
  update bound holds for the first round only: once the biases are no
  longer 0, the zero images of the padding rows (trained on, as in the
  reference) tie exactly in every max-pool window, and XLA and PyTorch
  send a tie's gradient to different positions (sfl_localloss's second
  round parts most).
* Two rounds with the padding rows filled by random images (fedavg,
  sfl_localloss): the second round's update also within 1e-4.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.configs.base import ScalaConfig as JScala
from repro_torch import api, convert
from repro_torch.configs import ScalaConfig
from repro_torch.core.baselines import FL_METHODS, SFL_METHODS
from repro_torch.tree import leaves

torch.set_num_threads(1)

N_TEST = 60
RTOL = {"feddecorr": 1e-3}


def _specs(method):
    jspec = japi.ExperimentSpec(
        arch="alexnet-cifar", split="s2", width=0.125, method=method,
        rounds=2, seed=3,
        scala=JScala(num_clients=6, participation=0.5, local_iters=2,
                     server_batch=12, lr=0.05),
        execution=japi.ExecutionSpec(mode="subset", backend="logits",
                                     unroll=0),
        data=japi.DataSpec(kind="image_synthetic", n_train=240,
                           n_test=N_TEST, alpha=2))
    tspec = api.ExperimentSpec.from_dict(dict(
        jspec.to_dict(), scala=ScalaConfig(**dataclasses.asdict(
            jspec.scala))))
    return jspec, tspec


def _port_state(state, method):
    """The reference program state -> the port's (inner, fed) leaves."""
    host = jax.tree.map(np.asarray, state)
    inner = convert.baseline_state_from_reference(host.inner, method)
    fed = (convert.baseline_state_from_reference(host.fed, method)
           if host.fed else {})
    return leaves(inner) + leaves(fed)


def _state(trainer):
    return leaves(trainer.state.inner) + leaves(trainer.state.fed)


def _worst_update(got, want, before):
    """The largest |got - want| of each leaf over the largest entry of
    the reference's update of it, worst leaf."""
    assert len(got) == len(want) == len(before)
    worst = 0.0
    for a, b, b0 in zip(got, want, before):
        assert a.shape == b.shape, (a.shape, b.shape)
        upd = (b - b0).abs().max().item()
        worst = max(worst, (a - b).abs().max().item() / max(upd, 1e-30))
    return worst


def _pair(method):
    jspec, tspec = _specs(method)
    tj = japi.Trainer(jspec)
    tt = api.Trainer(tspec, device="cpu", params=convert.
                     baseline_state_from_reference(jax.tree.map(
                         np.asarray, tj.state.inner), method))
    assert tt.program.metadata["client_major"]
    return tj, tt


@pytest.mark.parametrize("method", FL_METHODS + SFL_METHODS)
def test_round_matches_reference(method):
    tj, tt = _pair(method)
    before = _port_state(tj.state, method)
    assert all(torch.equal(a, b) for a, b in zip(_state(tt), before))
    assert tj.run(1) == tt.run(1) == [{}]
    worst = _worst_update(_state(tt), _port_state(tj.state, method), before)
    assert worst <= RTOL.get(method, 1e-4), (method, worst)


@pytest.mark.parametrize("method", ["fedavg", "feddyn", "splitfed_v2",
                                    "sfl_localloss"])
def test_trainer_matches_reference(method):
    tj, tt = _pair(method)
    assert tj.run(2) == tt.run(2) == [{}, {}]
    assert all(bool(torch.isfinite(a).all()) for a in _state(tt))
    got, want = tt.evaluate(), tj.evaluate()
    assert set(got) == set(want) == {"acc", "balanced_acc"}
    for key in want:
        assert abs(got[key] - want[key]) <= 1 / N_TEST + 1e-6, (key, got,
                                                                want)


@pytest.mark.parametrize("method", ["fedavg", "sfl_localloss"])
def test_second_round_matches_reference_without_tied_padding(method):
    """With the zero-weight padding rows filled by random images, so that
    no max-pool window ties, the second round also lies within 1e-4 of
    the reference's: what parts the two packages' later rounds is the
    tie of the zero images, not the round."""
    import jax.numpy as jnp

    tj, tt = _pair(method)
    rng = np.random.default_rng(11)
    padded = 0
    for rnd in range(2):
        batches, sizes = tj._next_round_batches()
        host = {k: np.asarray(v) for k, v in batches.items()}
        pad = host["weights"] == 0
        padded += int(pad.sum())
        host["x"] = np.where(pad[..., None, None, None], rng.standard_normal(
            host["x"].shape).astype(np.float32), host["x"])
        before = _port_state(tj.state, method)
        tj.state, _ = tj.program.step(
            tj.state, {k: jnp.asarray(v) for k, v in host.items()}, sizes)
        tt.state, _ = tt.program.step(
            tt.state, {k: torch.from_numpy(v.copy()) for k, v in host.items()},
            torch.from_numpy(np.asarray(sizes)))
    assert padded
    worst = _worst_update(_state(tt), _port_state(tj.state, method), before)
    assert worst <= 1e-4, (method, worst)
