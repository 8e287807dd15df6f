"""Faults leg: the cost of guarded aggregation, and a chaos run.

``benchmarks/faults.py`` on the port. The guards add to a round one
screen of the client updates (a norm and finiteness reduction per slot,
read in chunks), one host copy of the accept and clip vectors, and, only
when a participant is rejected, a second local phase over the survivors.
With zero faults nothing is rejected and the round is bitwise the
unguarded one (``tests/test_torch_faults.py``), so the cost of
always-on guards is the screen itself:

* ``guard_overhead``: guarded over unguarded median seconds a round at
  zero faults, for ``nonfinite`` and ``nonfinite,clip:10.0``, in the
  masked and async modes;
* the chaos leg: NaN corruption and drops at 10% of the slots under
  ``nonfinite`` guards, with the rejected count per round and the final
  loss (finite loss, shrinking cohort, a schedule that advances).

The model is the width-scaled AlexNet of the reference's leg; every row
is stamped with :func:`repro_torch.benchmarks.common.device_info`.

    PYTHONPATH=src python -m repro_torch.benchmarks.run --table faults \
        [--quick] [--device cpu] [--out faults.json]
    PYTHONPATH=src python -m repro_torch.benchmarks.faults --smoke \
        [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch import api
from repro_torch.benchmarks.common import device_info
from repro_torch.configs import ScalaConfig
from repro_torch.tree import leaves

CHAOS_FAULTS = "drop:0.1,corrupt:0.1:nan"
GUARDS = ("nonfinite", "nonfinite,clip:10.0")


def _trainer(K, rounds, mode, device, width, faults=None, guards=None):
    execution = (api.ExecutionSpec(mode="async", cohort=max(2, K // 4))
                 if mode == "async" else api.ExecutionSpec(mode=mode))
    spec = api.ExperimentSpec(
        arch="alexnet-cifar", method="scala", rounds=rounds, seed=0,
        width=width,
        scala=ScalaConfig(num_clients=K, participation=0.5, local_iters=2,
                          server_batch=48, lr=0.05),
        fed=api.FedSpec(faults=faults, guards=guards),
        execution=execution,
        data=api.DataSpec(kind="image_synthetic", n_train=60 * K, alpha=2))
    return api.Trainer(spec, device=device)


def _time_rounds(trainer, rounds, reps):
    """Median seconds of one round, the first (warm-up) excluded; the
    metrics' host copy waits for the device."""
    trainer.step()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(rounds):
            trainer.step()
        times.append((time.perf_counter() - t0) / rounds)
    return float(np.median(times))


def bench_faults(K: int = 8, rounds: int = 4, reps: int = 3, device="cuda",
                 width: float = 0.125) -> dict:
    """The result dict: per mode the unguarded and guarded seconds a
    round and their ratio, and the chaos leg."""
    res = {"bench": "faults", "K": K, "rounds_per_rep": rounds,
           "reps": reps, "model": f"alexnet-w{width}", "modes": {}}
    budget = 1 + rounds * reps
    for mode in ("masked", "async"):
        t_plain = _time_rounds(_trainer(K, budget, mode, device, width),
                               rounds, reps)
        row = {"unguarded_s_per_round": t_plain}
        for guards in GUARDS:
            t_g = _time_rounds(_trainer(K, budget, mode, device, width,
                                        guards=guards), rounds, reps)
            row[guards] = {"s_per_round": t_g,
                           "guard_overhead": t_g / t_plain}
        res["modes"][mode] = row
    chaos = _trainer(K, rounds + 1, "masked", device, width,
                     faults=CHAOS_FAULTS, guards="nonfinite")
    rejected, loss = [], None
    for _ in range(rounds + 1):
        m = chaos.step()
        rejected.append(m["guard_rejected"])
        loss = m["loss_server"]
    leaves_ok = all(bool(torch.isfinite(a).all())
                    for a in leaves(chaos.state.inner.params))
    res["chaos"] = {"faults": CHAOS_FAULTS, "final_loss": float(loss),
                    "finite": bool(np.isfinite(loss)) and leaves_ok,
                    "rounds": rounds + 1, "rejected_per_round": rejected,
                    "rejected_total": float(np.sum(rejected))}
    return res


def print_rows(res) -> None:
    """The reference runner's CSV rows of the leg."""
    for mode, entry in res["modes"].items():
        for guards, row in entry.items():
            if guards == "unguarded_s_per_round":
                print(f"faults,{mode},unguarded,,,{row}", flush=True)
            else:
                print(f"faults,{mode},{guards.replace(',', ';')},"
                      f"{row['guard_overhead']},,{row['s_per_round']}",
                      flush=True)
    ch = res["chaos"]
    print(f"faults,chaos={ch['faults'].replace(',', ';')},nonfinite,"
          f"{ch['final_loss']},{ch['rejected_total']},", flush=True)


def smoke_guard(device="cuda") -> dict:
    """The reference's CI guard: the chaos run ends finite, and guards at
    zero faults stay within 2x the unguarded round (wall-clock ratios at
    this size are noisy: a failing first measurement is measured once
    more)."""
    res = ov = None
    for attempt in (0, 1):
        res = bench_faults(K=4, rounds=2, reps=2, device=device)
        ov = max(res["modes"][m][g]["guard_overhead"]
                 for m in res["modes"] for g in GUARDS)
        print(f"max guard overhead (zero faults): {ov:.3f}x"
              + (" (retry)" if attempt else ""), flush=True)
        if ov < 2.0:
            break
    assert res["chaos"]["finite"], \
        f"chaos run diverged: loss={res['chaos']['final_loss']}"
    assert ov < 2.0, (f"guard screen overhead {ov}x the unguarded round "
                      "(expected < 2x; measured twice)")
    return res


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda unless given)")
    ap.add_argument("--width", type=float, default=0.125)
    ap.add_argument("--smoke", action="store_true",
                    help="tiny config; asserts a finite chaos run and a "
                         "bounded guard overhead")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    if args.smoke:
        res = smoke_guard(args.device)
    else:
        res = bench_faults(K=args.clients, rounds=args.rounds,
                           reps=args.reps, device=args.device,
                           width=args.width)
    res["device"] = device_info(args.device)
    print_rows(res)
    print(json.dumps(res), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=2)
    return res


if __name__ == "__main__":
    main()
