"""Round-loop leg: the split step driven from Python against the
engine's round runner.

``benchmarks/round_loop.py`` on the port. Both variants run the same
SCALA math (``logits`` backend, plain SGD) on the width-scaled AlexNet
(s2, 10 classes); only the driving differs:

  python_loop   T :func:`repro_torch.core.engine.make_split_step` calls
                and a data-size weighted FedAvg per round, written out
                here (the reference's legacy round, without its
                deprecated ``core/scala.py:scala_round``, which the port
                does not carry)
  round_runner  one :func:`repro_torch.core.engine.make_round_runner`
                call per round

The reference's ``scan`` and ``scan_unrolled`` rows time a round compiled
into one XLA program, rolled or unrolled; an eager program compiles no
round, so they have no counterpart and no row stands in for them. Each
variant runs one warm-up round, then ``rounds`` rounds ended by a device
synchronize; steps/s counts the local steps, and ``max_param_drift`` the
round runner's largest distance from the Python loop's params (0: the
same rounds).

    PYTHONPATH=src python -m repro_torch.benchmarks.run --table round_loop \
        [--quick] [--device cpu] [--out round_loop.json]
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.configs import ScalaConfig
from repro_torch.core import engine
from repro_torch.core.scala import alexnet_split_model
from repro_torch.core.split import (normalize_client_weights,
                                    stack_client_params, weighted_mean)
from repro_torch.models import alexnet as A
from repro_torch.optim import optimizers
from repro_torch.tree import leaves


def _setup(C: int, Bk: int, T: int, device, width: float = 0.125,
           seed: int = 0):
    gen = torch.Generator(device)
    gen.manual_seed(seed)
    wc, ws = A.split_params(A.init_params(gen, num_classes=10, width=width),
                            "s2")
    params = {"client": stack_client_params(wc, C), "server": ws}
    rng = np.random.default_rng(seed)
    rb = {"x": rng.standard_normal((T, C, Bk, 32, 32, 3), np.float32),
          "labels": rng.integers(0, 10, (T, C, Bk)),
          "weights": np.ones((T, C, Bk), np.float32)}
    rb = {k: torch.from_numpy(v).to(device) for k, v in rb.items()}
    return (alexnet_split_model("s2", num_classes=10), params, rb,
            torch.ones(C, device=device))


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def python_loop_round(step, state, rb, sizes):
    """T split steps, then the weighted FedAvg of the client halves
    broadcast back to every slot (the server half and the moments
    carried)."""
    T = leaves(rb)[0].shape[0]
    metrics = None
    for t in range(T):
        state, metrics = step(state, {k: v[t] for k, v in rb.items()})
    pc = state.params["client"]
    C = leaves(pc)[0].shape[0]
    w = normalize_client_weights(sizes)
    params = {"client": stack_client_params(weighted_mean(pc, w), C),
              "server": state.params["server"]}
    return engine.TrainState(params=params, opt_state=state.opt_state,
                             step=state.step), metrics


def _timed(fn, state, rounds: int, device):
    state, _ = fn(state)                                         # warm-up
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(rounds):
        state, _ = fn(state)
    _sync(device)
    return state, time.perf_counter() - t0


def bench_round_loop(rounds: int = 20, C: int = 4, Bk: int = 16, T: int = 5,
                     lr: float = 0.05, device="cuda"):
    """{'python_loop', 'round_runner'}: seconds and steps/s of ``rounds``
    rounds each from one start, the runner's speedup over the loop and
    its largest param distance from it."""
    model, params, rb, sizes = _setup(C, Bk, T, device)
    sc = ScalaConfig(num_clients=C, participation=1.0, local_iters=T, lr=lr)
    opt = optimizers.sgd()
    step = engine.make_split_step(model, sc, backend="logits", optimizer=opt)
    state = engine.init_train_state(params, opt)
    s_loop, t_loop = _timed(
        lambda st: python_loop_round(step, st, rb, sizes), state, rounds,
        device)
    runner = engine.make_round_runner(model, sc, backend="logits",
                                      optimizer=opt)
    s_run, t_run = _timed(lambda st: runner(st, rb, sizes), state, rounds,
                          device)
    steps = rounds * T
    drift = max(float((a - b).abs().max()) for a, b in zip(
        leaves(s_loop.params), leaves(s_run.params)))
    return {"bench": "round_loop",
            "config": {"rounds": rounds, "clients": C,
                       "per_client_batch": Bk, "local_iters": T, "lr": lr,
                       "model": "alexnet-w0.125"},
            "python_loop": {"seconds": round(t_loop, 4),
                            "steps_per_sec": round(steps / t_loop, 2)},
            "round_runner": {"seconds": round(t_run, 4),
                             "steps_per_sec": round(steps / t_run, 2),
                             "speedup_vs_loop": round(t_loop / t_run, 3),
                             "max_param_drift": drift}}


def print_rows(res) -> None:
    """The reference runner's CSV rows of the leg."""
    for variant in ("python_loop", "round_runner"):
        print(f"round_loop,steps_per_sec,{variant},"
              f"{res[variant]['steps_per_sec']},,"
              f"{res[variant]['seconds']}", flush=True)
