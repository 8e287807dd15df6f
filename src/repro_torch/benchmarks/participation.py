"""Participation leg: rounds/s against the participation fraction.

``benchmarks/participation.py`` on the port. The masked round keeps all K
client slots and masks the round's subset, so it computes every slot
whatever the fraction; the sparse round gathers the scheduler's subset
into a dense axis first; the subset round re-stacks only the r K
participants on the host (no mask), the lower bound. For each fraction
r one round program (``make_round_runner`` with ``uniform(K, r)`` and
``fedavg``) is timed masked and sparse on the width-scaled AlexNet, and
the r = 0.5 subset re-stacked beside them. Each timing runs one warm-up
round, then ``rounds`` rounds ended by a device synchronize.

    PYTHONPATH=src python -m repro_torch.benchmarks.run --table \
        participation [--device cpu] [--width 1.0] [--out part.json]
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch import fed
from repro_torch.configs import ScalaConfig
from repro_torch.core import engine
from repro_torch.core.scala import alexnet_split_model
from repro_torch.core.split import stack_client_params
from repro_torch.models import alexnet as A
from repro_torch.optim import optimizers

FRACTIONS = (0.25, 0.5, 1.0)


def _setup(C: int, Bk: int, T: int, device, width: float, seed: int = 0):
    """AlexNet (s2, 10 classes) stacked over C slots, and one round's
    batches (T, C, Bk) from a seed."""
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


def _time_rounds(round_fn, state, rb, sizes, fed_state, rounds, device):
    """Seconds for ``rounds`` rounds after one warm-up round."""
    args = () if fed_state is None else (fed_state,)
    round_fn(state, rb, sizes, *args)
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(rounds):
        out = round_fn(state, rb, sizes, *args)
        state, args = out[0], out[1:-1]
    _sync(device)
    return time.perf_counter() - t0


def _entry(secs: float, rounds: int):
    return {"seconds": round(secs, 4),
            "rounds_per_sec": round(rounds / secs, 2)}


def bench_participation(rounds: int = 10, K: int = 8, Bk: int = 16,
                        T: int = 5, lr: float = 0.05, width: float = 0.125,
                        device="cuda"):
    """The result dict: per fraction the masked and the sparse round, and
    the r = 0.5 subset re-stacked."""
    model, params, rb, sizes = _setup(K, Bk, T, device, width)
    sc = ScalaConfig(num_clients=K, participation=1.0, local_iters=T, lr=lr)
    res = {"bench": "participation",
           "config": {"rounds": rounds, "clients": K, "per_client_batch": Bk,
                      "local_iters": T, "lr": lr,
                      "model": f"alexnet-w{width}"},
           "modes": {}}
    state = engine.init_train_state(params, optimizers.sgd())
    agg = fed.fedavg()
    for frac in FRACTIONS:
        part = fed.uniform(K, frac)
        entry = {}
        for mode in ("masked", "sparse"):
            round_fn = engine.make_round_runner(
                model, sc, backend="logits", aggregator=agg,
                participation=part, slot_gather=mode == "sparse")
            fs = fed.init_fed_state(1, agg, part, device=device)
            entry[mode] = _entry(_time_rounds(round_fn, state, rb, sizes, fs,
                                              rounds, device), rounds)
        res["modes"][f"frac={frac}"] = entry
    C = max(1, round(K * 0.5))
    model_s, params_s, rb_s, sizes_s = _setup(C, Bk, T, device, width)
    round_fn = engine.make_round_runner(model_s, sc, backend="logits")
    res["subset_restacked_frac=0.5"] = _entry(_time_rounds(
        round_fn, engine.init_train_state(params_s, optimizers.sgd()), rb_s,
        sizes_s, None, rounds, device), rounds)
    return res
