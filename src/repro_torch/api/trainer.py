"""``Trainer`` -- runs a built experiment from the host, round by round.

It synthesizes the dataset from the spec's :class:`DataSpec`, assembles
each round's batches (eq. 3 sizing, :mod:`repro_torch.data.loader`),
moves them to the program's device and threads the program state
through :class:`RoundProgram.step`. The host numpy streams are the
reference's (``api/trainer.py``): the documents from ``spec.seed``, the
per-client document choice from ``seed + 1``, client sampling and batch
rows from ``default_rng(seed)``, so both trainers see the same batches.

    trainer = Trainer(spec, device="cuda")
    history = trainer.run()            # spec.rounds rounds

``save`` / ``resume`` wait for the checkpoint slice.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.api.build import build
from repro_torch.api.specs import ExperimentSpec


def build_lm_data(cfg, num_clients: int, docs_per_client: int, seq: int,
                  seed: int) -> List[np.ndarray]:
    """Domain-skewed synthetic token docs: client k prefers domain k % D."""
    from repro_torch.data.synthetic import token_stream

    docs, domains = token_stream(
        n_docs=num_clients * docs_per_client, doc_len=seq + 1,
        vocab=cfg.vocab_size, num_domains=max(2, num_clients // 2), seed=seed)
    rng = np.random.default_rng(seed + 1)
    by_client = []
    D = domains.max() + 1
    for k in range(num_clients):
        pref = k % D
        p = np.where(domains == pref, 8.0, 1.0)
        p = p / p.sum()
        idx = rng.choice(len(docs), size=docs_per_client, replace=False, p=p)
        by_client.append(docs[idx])
    return by_client


class Trainer:
    """Run a built experiment round by round on ``device``. ``params``
    (training layout, see :func:`repro_torch.api.build.build`) replaces
    the port's own init."""

    def __init__(self, spec: ExperimentSpec, *, device="cuda", params=None):
        self.spec = spec.validate()
        self.program = build(spec, device=device, params=params)
        self.device = torch.device(self.program.metadata["device"])
        self.state = self.program.init()
        self.history: List[Dict[str, float]] = []
        self.round = 0
        self._cfg = spec.model_config()
        self._data = build_lm_data(self._cfg, spec.scala.num_clients,
                                   spec.data.docs_per_client, spec.data.seq,
                                   spec.seed)
        self._rng = np.random.default_rng(spec.seed)

    def _next_round_batches(self):
        from repro_torch.data.loader import lm_round_batches, sample_clients

        sc = self.spec.scala
        selected = sample_clients(sc.num_clients, sc.clients_per_round,
                                  self._rng)
        rb = lm_round_batches(self._data, selected, sc.server_batch,
                              sc.local_iters, self._rng)
        sizes = torch.from_numpy(rb.pop("sizes")).to(self.device)
        return ({k: torch.from_numpy(v).to(self.device)
                 for k, v in rb.items()}, sizes)

    def step(self) -> Dict[str, float]:
        """One round; returns its (last local step's) scalar metrics."""
        batches, sizes = self._next_round_batches()
        self.state, metrics = self.program.step(self.state, batches, sizes)
        scalars = {k: float(v) for k, v in metrics.items() if v.dim() == 0}
        self.history.append(scalars)
        self.round += 1
        return scalars

    def run(self, rounds: Optional[int] = None, *,
            on_round: Optional[Callable[[int, Dict[str, float], float],
                                        Any]] = None):
        """Run ``rounds`` rounds (default ``spec.rounds``); returns the
        metric history. ``on_round(index, metrics, seconds)`` after each,
        with the round's wall time (the metrics' host copy waits for the
        device, so it covers the round's device work)."""
        n = self.spec.rounds if rounds is None else rounds
        for _ in range(n):
            t0 = time.perf_counter()
            metrics = self.step()
            dt = time.perf_counter() - t0
            if on_round is not None:
                on_round(self.round - 1, metrics, dt)
        return self.history

    def evaluate(self) -> Dict[str, float]:
        """Next-token loss and accuracy of the global model on a held-out
        document stream (seeded off the experiment seed, as the
        reference's)."""
        from repro_torch.core.losses import accuracy, softmax_xent
        from repro_torch.data.synthetic import token_stream

        docs, _ = token_stream(
            n_docs=32, doc_len=self.spec.data.seq + 1,
            vocab=self._cfg.vocab_size,
            num_domains=max(2, self.spec.scala.num_clients // 2),
            seed=self.spec.seed + 9973)
        docs = torch.from_numpy(docs).to(self.device)
        logits = self.program.predict(self.state, {"tokens": docs[:, :-1]})
        labels = docs[:, 1:]
        return {"eval_loss": float(softmax_xent(logits, labels)),
                "eval_accuracy": float(accuracy(logits, labels))}
