"""Scale leg: the client axis from 1e2 to 1e6 simulated clients.

``benchmarks/scale.py`` on the port. Event throughput at a fixed arrival
cohort should be flat in the client count K under ``snapshots="delta"``:
nothing an event touches is O(K) and param-sized (snapshots come from a
``ring_size``-deep ring, the cohort trains on cohort-sized batches), and
only the (K,) version / finish-time scalars, 8 bytes a client on the
host, grow with K. Dense snapshots hold a (K, ...) copy of the client
half (O(K x |w_c|) bytes), though the port's event writes only the
cohort's rows of it. Per K: events/s (median of ``reps``) and
:func:`repro_torch.fed.async_state_bytes`; dense is skipped above
``dense_max_k``.

:func:`bench_arrival` isolates the event's pop on the delta runner:
``sort`` (a host lexsort, O(K log K)) against ``topk`` (an O(K) host
selection, bit-identical) and ``topk:sharded`` (each client shard of a
grid pops its block, one all_gather of the candidates, one merge), on a
grid over the process group: the one the caller runs under (``torchrun``),
or a one-rank group set up here (gloo on the CPU, NCCL on a card), where
it measures the collective's overhead, not a gain (``shards`` in the
config says which).

    PYTHONPATH=src python -m repro_torch.benchmarks.run --table scale \
        [--quick] [--device cpu] [--out scale.json]
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch import fed
from repro_torch.benchmarks.participation import _sync
from repro_torch.configs import ScalaConfig
from repro_torch.core import engine
from repro_torch.core.scala import alexnet_split_model
from repro_torch.core.split import stack_client_params
from repro_torch.models import alexnet as A
from repro_torch.optim import optimizers

KS = (100, 10_000, 1_000_000)
DENSE_MAX_K = 100_000


def _setup_model(width: float, device, num_classes: int = 10):
    gen = torch.Generator(device)
    gen.manual_seed(0)
    wc, ws = A.split_params(A.init_params(gen, num_classes=num_classes,
                                          width=width), "s2")
    return alexnet_split_model("s2", num_classes=num_classes), wc, ws


def _cohort_batches(cohort: int, T: int, Bk: int, device,
                    num_classes: int = 10):
    """Cohort-sized batches (T, cohort, Bk, ...), never (T, K, ...): the
    arrivals consume them directly."""
    rng = np.random.default_rng(2)
    rb = {"x": rng.standard_normal((T, cohort, Bk, 32, 32, 3), np.float32),
          "labels": rng.integers(0, num_classes, (T, cohort, Bk)),
          "weights": np.ones((T, cohort, Bk), np.float32)}
    return {k: torch.from_numpy(v).to(device) for k, v in rb.items()}


def _mk_leg(model, wc, ws, *, K: int, cohort: int, snapshots: str,
            ring: int, arrival: str = "sort", mesh=None):
    dm = fed.make_delays("lognormal:1:1")
    event = fed.make_async_runner(
        model, ScalaConfig(lr=0.05), backend="logits", delays=dm,
        cohort=cohort, snapshots=snapshots, ring_size=ring, num_clients=K,
        emit_client_metrics=False, arrival=arrival, mesh=mesh)
    slots = 1 if snapshots == "delta" else K
    params = {"client": stack_client_params(wc, slots), "server": ws}
    afed = fed.init_async_state(1, params["client"], dm, snapshots=snapshots,
                                ring_size=ring, num_clients=K, mesh=mesh)
    return event, engine.init_train_state(params, optimizers.sgd()), afed


def _time_leg(event, state, afed, batches, events: int, reps: int, device):
    """One warm-up event, then ``events`` events (the state threaded),
    median of ``reps``."""
    state, afed, _ = event(state, afed, batches)
    _sync(device)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(events):
            state, afed, _ = event(state, afed, batches)
        _sync(device)
        times.append(time.perf_counter() - t0)
    secs = sorted(times)[len(times) // 2]
    return ({"seconds": round(secs, 4),
             "rounds_per_sec": round(events / secs, 2)}, afed)


def bench_scale(ks=KS, cohort: int = 8, T: int = 2, Bk: int = 4,
                events: int = 16, width: float = 0.03125, ring: int = 64,
                reps: int = 3, dense_max_k: int = DENSE_MAX_K,
                device="cuda"):
    """Events/s and state bytes per K, dense and delta."""
    model, wc, ws = _setup_model(width, device)
    batches = _cohort_batches(cohort, T, Bk, device)
    res = {"bench": "scale",
           "config": {"cohort": cohort, "local_iters": T,
                      "per_client_batch": Bk, "events": events,
                      "model": f"alexnet-w{width}", "ring_size": ring,
                      "delays": "lognormal:1:1", "dense_max_k": dense_max_k},
           "K": {}}
    for K in ks:
        entry = {}
        for snapshots in ("dense", "delta"):
            if snapshots == "dense" and K > dense_max_k:
                entry["dense"] = {"skipped": f"K={K} dense snapshots would "
                                             "materialize K x |w_c| bytes"}
                continue
            timing, afed = _time_leg(*_mk_leg(
                model, wc, ws, K=K, cohort=cohort, snapshots=snapshots,
                ring=ring), batches, events, reps, device)
            timing["state_bytes"] = fed.async_state_bytes(afed)
            entry[snapshots] = timing
        if "rounds_per_sec" in entry.get("dense", {}):
            entry["delta_speedup_vs_dense"] = round(
                entry["delta"]["rounds_per_sec"]
                / entry["dense"]["rounds_per_sec"], 3)
        res["K"][str(K)] = entry
    base = res["K"][str(ks[0])]["delta"]["rounds_per_sec"]
    res["delta_flatness"] = {
        str(K): round(base / res["K"][str(K)]["delta"]["rounds_per_sec"], 3)
        for K in ks}
    return res


def bench_arrival(ks=(10_000, 1_000_000), cohort: int = 8, T: int = 2,
                  Bk: int = 4, events: int = 16, width: float = 0.03125,
                  ring: int = 64, reps: int = 3, device="cuda"):
    """Events/s of the delta runner with the ``sort``, ``topk`` and
    ``topk:sharded`` pops (the training work per event is the same)."""
    import torch.distributed as dist

    from repro_torch.sharding import init_local_group, make_host_grid

    model, wc, ws = _setup_model(width, device)
    batches = _cohort_batches(cohort, T, Bk, device)
    made = init_local_group("nccl" if torch.device(device).type == "cuda"
                            else "gloo")
    try:
        grid = make_host_grid()
        res = {"config": {"cohort": cohort, "local_iters": T,
                          "per_client_batch": Bk, "events": events,
                          "model": f"alexnet-w{width}", "ring_size": ring,
                          "delays": "lognormal:1:1", "snapshots": "delta",
                          "shards": grid.n_client_shards,
                          "backend": grid.backend},
               "K": {}}
        for K in ks:
            entry = {}
            for arrival in ("sort", "topk", "topk:sharded"):
                entry[arrival], _ = _time_leg(*_mk_leg(
                    model, wc, ws, K=K, cohort=cohort, snapshots="delta",
                    ring=ring, arrival=arrival,
                    mesh=grid if arrival == "topk:sharded" else None),
                    batches, events, reps, device)
            entry["topk_speedup_vs_sort"] = round(
                entry["topk"]["rounds_per_sec"]
                / entry["sort"]["rounds_per_sec"], 3)
            res["K"][str(K)] = entry
    finally:
        if made:
            dist.destroy_process_group()
    return res
