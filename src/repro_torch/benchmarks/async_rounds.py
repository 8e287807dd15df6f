"""Async leg: sparse-slot compute and event throughput.

``benchmarks/async_rounds.py`` on the port, two questions about the
round's execution path (no paper table):

1. sparse against masked: for each participation fraction one round
   masked (all K slots computed) and one sparse (the subset gathered),
   timed on the width-scaled AlexNet, with their ratio;
2. event throughput against the delay distribution: the async runner
   pops a fixed cohort per event, so its compute per event is the same
   whatever the delays; events/s should be flat across distributions
   while the mean cohort staleness grows with the tail.

    PYTHONPATH=src python -m repro_torch.benchmarks.run --table async \
        [--quick] [--device cpu] [--out async.json]
"""
from __future__ import annotations

import time

import numpy as np

from repro_torch import fed
from repro_torch.benchmarks.participation import (FRACTIONS, _entry, _setup,
                                                  _sync, _time_rounds)
from repro_torch.configs import ScalaConfig
from repro_torch.core import engine
from repro_torch.optim import optimizers

DELAY_SPECS = ("constant:1", "uniform:0.5:2", "lognormal:1:1.5")


def bench_async(rounds: int = 10, K: int = 8, Bk: int = 16, T: int = 5,
                lr: float = 0.05, cohort: int = 0, width: float = 0.125,
                device="cuda"):
    """The result dict: sparse against masked per fraction, and events/s
    and mean cohort staleness per delay spec."""
    model, params, rb, sizes = _setup(K, Bk, T, device, width)
    sc = ScalaConfig(num_clients=K, participation=1.0, local_iters=T, lr=lr)
    state = engine.init_train_state(params, optimizers.sgd())
    m = cohort if cohort > 0 else max(1, K // 4)
    res = {"bench": "async_rounds",
           "config": {"rounds": rounds, "clients": K, "per_client_batch": Bk,
                      "local_iters": T, "lr": lr, "cohort": m,
                      "model": f"alexnet-w{width}"},
           "sparse_vs_masked": {}, "async_events": {}}
    agg = fed.fedavg()
    for frac in FRACTIONS:
        part = fed.uniform(K, frac)
        entry = {}
        for name in ("masked", "sparse"):
            round_fn = engine.make_round_runner(
                model, sc, backend="logits", aggregator=agg,
                participation=part, slot_gather=name == "sparse")
            fs = fed.init_fed_state(1, agg, part, device=device)
            entry[name] = _entry(_time_rounds(round_fn, state, rb, sizes, fs,
                                              rounds, device), rounds)
        entry["sparse_over_masked"] = round(
            entry["sparse"]["seconds"] / entry["masked"]["seconds"], 3)
        res["sparse_vs_masked"][f"frac={frac}"] = entry
    for spec in DELAY_SPECS:
        dm = fed.make_delays(spec)
        event = fed.make_async_runner(model, sc, backend="logits", delays=dm,
                                      cohort=m, staleness_decay=0.5)

        def fresh():
            return (engine.init_train_state(params, optimizers.sgd()),
                    fed.init_async_state(2, params["client"], dm))

        s, af = fresh()
        event(s, af, rb, sizes)                      # warm-up
        s, af = fresh()
        _sync(device)
        stales = []
        t0 = time.perf_counter()
        for _ in range(rounds):
            s, af, mt = event(s, af, rb, sizes)
            stales.append(mt["staleness_mean"])
        _sync(device)
        secs = time.perf_counter() - t0
        res["async_events"][spec] = {
            "seconds": round(secs, 4),
            "events_per_sec": round(rounds / secs, 2),
            "local_steps_per_sec": round(rounds * T / secs, 2),
            "mean_cohort_staleness": round(float(np.mean(stales)), 3)}
    return res
