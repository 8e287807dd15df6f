"""Shared experiment runner for the paper-table benchmarks, on the port.

``benchmarks/common.py``'s protocol: CIFAR-shaped synthetic data and the
paper's AlexNet (width-scaled; ``width=1.0`` is the Appendix-E network),
K clients, participation r, T local iterations, server batch B, SGD,
quantity (alpha) or Dirichlet (beta) label skew. :func:`experiment_spec`
takes the reference's keywords and defaults, :func:`run_experiment`
runs the spec through :class:`repro_torch.api.Trainer` on ``device``
(the card unless the caller asks for the CPU), and :func:`device_info`
stamps what it ran on.
"""
from __future__ import annotations

import subprocess
import time
from typing import Dict, Optional

import torch

from repro_torch import api
from repro_torch.checkpoint.checkpoint import flatten_with_paths
from repro_torch.configs import ScalaConfig

SCALA_METHODS = api.SCALA_METHODS
ALL_METHODS = api.METHODS


def device_info(device="cuda") -> Dict:
    """The device a benchmark ran on: the card's name, count and
    ``nvidia-smi`` power limit, or the CPU."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return {"platform": "cpu", "device_count": 1, "kind": "cpu"}
    index = dev.index or 0
    try:
        limit = subprocess.run(
            ["nvidia-smi", "-i", str(index), "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip() or "unknown"
    except OSError:
        limit = "unknown"
    return {"platform": "gpu", "device_count": torch.cuda.device_count(),
            "kind": torch.cuda.get_device_name(index), "power_limit": limit}


def experiment_spec(method: str, *, alpha: Optional[int] = None,
                    beta: Optional[float] = None, K: int = 20, r: float = 0.2,
                    T: int = 5, rounds: int = 12, server_batch: int = 48,
                    lr: float = 0.05, width: float = 0.125,
                    num_classes: int = 10, n_train: int = 2000,
                    split: str = "s2", seed: int = 0,
                    aggregator: Optional[str] = None,
                    opt_state_policy: str = "carry",
                    execution: str = "subset",
                    server_optimizer: Optional[str] = None,
                    server_lr: float = 1.0, rounds_per_call: int = 1,
                    precision: str = "f32",
                    donate: bool = True) -> api.ExperimentSpec:
    """The paper-table keywords -> an ExperimentSpec, as the reference's.

    ``execution`` (SCALA methods): ``"subset"`` samples r K clients on
    the host; ``"masked"`` / ``"sparse"`` keep all K slots and pick the
    ``uniform:r`` subset in the program (all K slots computed, or the
    subset gathered), the participants' batch held to ``server_batch``
    (the Trainer splits ``server_batch / r`` over the K slots).
    ``server_optimizer``: an optimizer spec (``OptimSpec.parse``; e.g.
    ``"momentum"``: FedAvgM) for FedOpt on the server side at
    ``server_lr``. ``rounds_per_call`` / ``precision`` / ``donate``: the
    dispatch knobs of :class:`repro_torch.api.ExecutionSpec`
    (:mod:`repro_torch.benchmarks.dispatch`)."""
    in_program = execution in ("masked", "sparse")
    server_opt = (api.OptimSpec.parse(server_optimizer, default_lr=server_lr)
                  if server_optimizer else None)
    return api.ExperimentSpec(
        arch="alexnet-cifar", split=split, width=width,
        method=method, rounds=rounds, seed=seed,
        scala=ScalaConfig(num_clients=K, participation=r, local_iters=T,
                          server_batch=server_batch, lr=lr),
        fed=api.FedSpec(aggregator=aggregator or "weighted",
                        participation=f"uniform:{r}" if in_program else None,
                        opt_state_policy=opt_state_policy),
        execution=api.ExecutionSpec(mode=execution, backend="logits",
                                    server_optimizer=server_opt,
                                    rounds_per_call=rounds_per_call,
                                    precision=precision, donate=donate),
        data=api.DataSpec(kind="image_synthetic", n_train=n_train,
                          num_classes=num_classes, alpha=alpha, beta=beta))


def nonfinite_leaves(state) -> int:
    """The floating leaves of a program state that hold an inf or a NaN
    (a diverged run: its ``evaluate()`` still gives a finite accuracy,
    as argmax picks one class)."""
    return sum(1 for x in flatten_with_paths(state).values()
               if isinstance(x, torch.Tensor) and x.is_floating_point()
               and not bool(torch.isfinite(x).all()))


def run_experiment(method: str, *, device="cuda", on_round=None,
                   **kw) -> Dict:
    """{'acc', 'balanced_acc', 'seconds'} on the held-out test set after
    the spec's rounds (keywords of :func:`experiment_spec`), and
    'nonfinite_leaves' of the final state; ``on_round`` is
    :meth:`repro_torch.api.Trainer.run`'s."""
    t0 = time.time()
    trainer = api.Trainer(experiment_spec(method, **kw), device=device)
    trainer.run(on_round=on_round)
    res = trainer.evaluate()
    res["seconds"] = round(time.time() - t0, 1)
    res["nonfinite_leaves"] = nonfinite_leaves(trainer.state)
    return res
