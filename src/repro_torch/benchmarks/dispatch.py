"""Dispatch leg: rounds per call x donation x precision.

``benchmarks/dispatch.py`` on the port. The three knobs of
:class:`repro_torch.api.ExecutionSpec`, each through the ``api.build``
program every driver runs:

* ``rounds_per_call`` -- R whole rounds in one program call
  (:func:`repro_torch.api.build.fuse_rounds`). An eager program has no
  compiled chunk: the call runs the R rounds one after another, so what
  fusing can save is per call, not per round -- the Trainer's batch
  upload and its host copy of the metrics, once a chunk instead of once a
  round (this leg times ``step`` alone, with the batches on the device);
* ``donate`` -- the synchronous round overwrites the state it is given
  from its first local step on, the async event writes its cohort's rows
  in place;
* ``precision`` -- ``"bf16"`` runs the local steps in bfloat16 against
  float32 master params.

The config is the reference's micro one (K = 2 clients, 1 image, T = 1,
width 0.03125 AlexNet), so the per-round compute is close to the
per-call cost. For each mode (masked / sparse / async) the grid
``rounds_per_call x donate x precision`` is timed (the median of
``reps`` repetitions of ``rounds`` rounds after a warm-up call, ended by
a device synchronize); ``fused_speedup`` is rounds/s at the largest R
over R = 1 (donated, f32). The ``baseline_transpose_hoist`` leg times
the FL baseline's client-major transpose once per chunk (what
``build`` does) against once per round inside the chunk; on the port
both are views, so it measures the call structure only. The
reference's ``--smoke`` guard (fused >= unfused rounds/s) has no
counterpart: the eager chunk and the unfused rounds run the same work.

    PYTHONPATH=src python -m repro_torch.benchmarks.run --table dispatch \
        [--quick] [--device cpu] [--out dispatch.json]
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch import api
from repro_torch.configs import ScalaConfig

MODES = ("masked", "sparse", "async")
RPCS = (1, 4, 16)
PRECISIONS = ("f32", "bf16")


def _spec(mode: str, rpc: int, donate: bool, precision: str, *, K: int,
          T: int, server_batch: int, width: float) -> api.ExperimentSpec:
    fed = (api.FedSpec(participation="uniform:0.5")
           if mode in ("masked", "sparse") else api.FedSpec())
    return api.ExperimentSpec(
        arch="alexnet-cifar", width=width, method="scala", rounds=8, seed=0,
        scala=ScalaConfig(num_clients=K, participation=0.5, local_iters=T,
                          server_batch=server_batch, lr=0.05),
        fed=fed,
        execution=api.ExecutionSpec(mode=mode, rounds_per_call=rpc,
                                    donate=donate, precision=precision,
                                    cohort=1 if mode == "async" else 0),
        data=api.DataSpec(kind="image_synthetic", n_train=100,
                          num_classes=10, alpha=2))


def _round_batches(K: int, Bk: int, T: int, rpc: int, device, seed=0):
    """One call's synthetic batches, leaves (T, K, Bk, ...) or (rpc, T, K,
    Bk, ...) -- the same round repeated -- and the (K,) / (rpc, K)
    sizes, on ``device``."""
    rng = np.random.default_rng(seed)
    b = {"x": rng.standard_normal((T, K, Bk, 32, 32, 3), np.float32),
         "labels": rng.integers(0, 10, (T, K, Bk)),
         "weights": np.ones((T, K, Bk), np.float32)}
    sizes = np.full((K,), float(Bk), np.float32)
    if rpc > 1:
        b = {k: np.repeat(v[None], rpc, 0) for k, v in b.items()}
        sizes = np.repeat(sizes[None], rpc, 0)
    return ({k: torch.from_numpy(v).to(device) for k, v in b.items()},
            torch.from_numpy(sizes).to(device))


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _time_calls(step, state, batches, sizes, calls: int, rpc: int, device,
                reps: int = 3):
    """{'seconds', 'rounds_per_sec'}: the median of ``reps`` timings of
    ``calls`` calls after one warm-up call, the state threaded through."""
    state, _ = step(state, batches, sizes)
    _sync(device)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(calls):
            state, _ = step(state, batches, sizes)
        _sync(device)
        times.append(time.perf_counter() - t0)
    secs = sorted(times)[len(times) // 2]
    return {"seconds": round(secs, 4),
            "rounds_per_sec": round(calls * rpc / secs, 2)}


def _time_config(spec: api.ExperimentSpec, rounds: int, K: int, Bk: int,
                 T: int, device, reps: int = 3):
    rpc = spec.execution.rounds_per_call
    program = api.build(spec, device=device)
    batches, sizes = _round_batches(K, Bk, T, rpc, device)
    return _time_calls(program.step, program.init(), batches, sizes,
                       max(1, rounds // rpc), rpc, device, reps)


def bench_dispatch(rounds: int = 192, K: int = 2, Bk: int = 1, T: int = 1,
                   width: float = 0.03125, modes=MODES, rpcs=RPCS,
                   precisions=PRECISIONS, donates=(True, False),
                   device="cuda"):
    """The grid per mode, and each mode's ``fused_speedup``."""
    res = {"bench": "dispatch",
           "config": {"rounds": rounds, "clients": K, "per_client_batch": Bk,
                      "local_iters": T, "model": f"alexnet-w{width}",
                      "rpcs": list(rpcs), "precisions": list(precisions),
                      "donates": list(donates)},
           "modes": {}}
    for mode in modes:
        entry = {}
        for rpc in rpcs:
            for donate in donates:
                for prec in precisions:
                    spec = _spec(mode, rpc, donate, prec, K=K, T=T,
                                 server_batch=max(1, K * Bk // 2),
                                 width=width)
                    key = (f"rpc={rpc},donate="
                           f"{'on' if donate else 'off'},prec={prec}")
                    entry[key] = _time_config(spec, rounds, K, Bk, T, device)
        base = entry[f"rpc={rpcs[0]},donate=on,prec=f32"]
        top = entry[f"rpc={rpcs[-1]},donate=on,prec=f32"]
        entry["fused_speedup"] = round(
            top["rounds_per_sec"] / base["rounds_per_sec"], 3)
        res["modes"][mode] = entry
    return res


def _fl_spec(rpc: int, *, K: int, T: int, width: float) -> api.ExperimentSpec:
    return api.ExperimentSpec(
        arch="alexnet-cifar", width=width, method="fedavg", rounds=8, seed=0,
        scala=ScalaConfig(num_clients=K, participation=1.0, local_iters=T,
                          server_batch=K, lr=0.05),
        execution=api.ExecutionSpec(mode="subset", rounds_per_call=rpc),
        data=api.DataSpec(kind="image_synthetic", n_train=100,
                          num_classes=10, alpha=2))


def bench_baseline_hoist(rounds: int = 192, K: int = 2, Bk: int = 1,
                         T: int = 1, width: float = 0.03125, rpc: int = 16,
                         device="cuda"):
    """The FL baseline's chunk with its transpose once a call (``build``'s
    layout: axes 1 and 2 of the chunk) against the unfused program's step
    chained over the chunk (a transpose a round), and their ratio."""
    from repro_torch.api.build import fuse_rounds

    calls = max(1, rounds // rpc)
    entry = {"hoisted": _time_config(_fl_spec(rpc, K=K, T=T, width=width),
                                     rounds, K, Bk, T, device)}
    prog1 = api.build(_fl_spec(1, K=K, T=T, width=width), device=device)
    batches, sizes = _round_batches(K, Bk, T, rpc, device)
    entry["per_round_transpose"] = _time_calls(
        fuse_rounds(prog1.step), prog1.init(), batches, sizes, calls, rpc,
        device)
    entry["hoist_speedup"] = round(
        entry["hoisted"]["rounds_per_sec"]
        / entry["per_round_transpose"]["rounds_per_sec"], 3)
    return entry


def print_rows(res) -> None:
    """The reference runner's CSV rows of the leg."""
    for mode, entry in res["modes"].items():
        for key, row in entry.items():
            if key == "fused_speedup":
                print(f"dispatch,{mode},fused_speedup,{row},,", flush=True)
            else:
                print(f"dispatch,{mode},{key},{row['rounds_per_sec']},,"
                      f"{row['seconds']}", flush=True)
    hoist = res.get("baseline_transpose_hoist")
    if hoist is not None:
        for key in ("hoisted", "per_round_transpose"):
            print(f"dispatch,baseline_transpose,{key},"
                  f"{hoist[key]['rounds_per_sec']},,{hoist[key]['seconds']}",
                  flush=True)
        print(f"dispatch,baseline_transpose,hoist_speedup,"
              f"{hoist['hoist_speedup']},,", flush=True)
