"""``Trainer`` -- runs a built experiment from the host, round by round.

It synthesizes the dataset from the spec's :class:`DataSpec`, assembles
each round's batches (eq. 3 sizing, :mod:`repro_torch.data.loader`),
moves them to the program's device and threads the program state
through :class:`RoundProgram.step`. The host numpy streams are the
reference's (``api/trainer.py``), so both trainers see the same batches:
for ``lm_synthetic`` the documents from ``spec.seed``, the per-client
document choice from ``seed + 1``, client sampling and batch rows from
``default_rng(seed)``; for ``image_synthetic`` the images and their
label-skew partition from ``spec.seed``, client sampling and batch rows
from ``default_rng(seed + 7)``.

    trainer = Trainer(spec, device="cuda")
    history = trainer.run()            # spec.rounds rounds
    trainer.save("state/")             # resume("state/") continues it

``save`` / ``resume`` checkpoint the whole run, bit for bit: the program
state and the host side (round, history, the numpy bit generator).
``resume`` also reads a directory that the reference ``Trainer.save``
wrote, for the subset-mode SCALA and baseline states, through
:mod:`repro_torch.convert`; its host streams are the reference's, so the
port continues the reference's own batches.
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.api.build import ProgramState, build
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


def build_image_data(spec: ExperimentSpec):
    """CIFAR-shaped gaussian images, label-skew partitioned per the
    spec's DataSpec. Returns (FederatedData, (x_test, y_test))."""
    from repro_torch.data.loader import FederatedData
    from repro_torch.data.partition import partition
    from repro_torch.data.synthetic import gaussian_images

    d = spec.data
    x, y = gaussian_images(d.n_train + d.n_test, num_classes=d.num_classes,
                           seed=spec.seed)
    x_train, y_train = x[:d.n_train], y[:d.n_train]
    parts = partition(y_train, spec.scala.num_clients, alpha=d.alpha,
                      beta=d.beta, num_classes=d.num_classes, seed=spec.seed)
    return (FederatedData.from_partition(x_train, y_train, parts),
            (x[d.n_train:], y[d.n_train:]))


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
        self._images = spec.data.kind == "image_synthetic"
        if self._images:
            self._data, self._test = build_image_data(spec)
            self._rng = np.random.default_rng(spec.seed + 7)
        else:
            self._data = build_lm_data(self._cfg, spec.scala.num_clients,
                                       spec.data.docs_per_client,
                                       spec.data.seq, spec.seed)
            self._rng = np.random.default_rng(spec.seed)

    def _next_round_batches(self):
        from repro_torch.data.loader import (lm_round_batches, round_batches,
                                             sample_clients)

        sc = self.spec.scala
        selected = sample_clients(sc.num_clients, sc.clients_per_round,
                                  self._rng)
        batches = round_batches if self._images else lm_round_batches
        rb = batches(self._data, selected, sc.server_batch, sc.local_iters,
                     self._rng)
        sizes = torch.from_numpy(rb.pop("sizes")).to(self.device)
        return ({k: torch.from_numpy(v).to(self.device)
                 for k, v in rb.items()}, sizes)

    def step(self) -> Dict[str, float]:
        """One round; returns its (last local step's) scalar metrics. A
        baseline round has none, so it waits for the device itself, as
        the metrics' host copy does for SCALA."""
        batches, sizes = self._next_round_batches()
        self.state, metrics = self.program.step(self.state, batches, sizes)
        if not metrics and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
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

    # ------------------------------------------------------------------
    # crash recovery
    # ------------------------------------------------------------------

    def save(self, directory: str) -> str:
        """Checkpoint the whole run: the ``.npz`` holds the
        :class:`ProgramState` (params, optimizer state, the baselines'
        state), ``meta_{round:08d}.json`` the round, the metric history
        and the numpy bit generator's state. Both writes are atomic;
        :meth:`resume` from the pair is bit-identical to never having
        stopped."""
        from repro_torch import checkpoint as C

        path = C.save(directory, self.round, self.state)
        C.write_json_atomic(
            os.path.join(directory, f"meta_{self.round:08d}.json"),
            {"round": self.round, "history": self.history,
             "rng_state": self._rng.bit_generator.state})
        return path

    def _restored_state(self, arrays) -> ProgramState:
        from repro_torch import checkpoint as C
        from repro_torch import convert

        if C.PORT_KEY in arrays:
            return C.restore_arrays(arrays, self.state)
        inner, fed = convert.program_state_from_reference(
            arrays, self.spec, self.device)
        return ProgramState(inner=inner, fed=fed)

    def resume(self, directory: str, step: Optional[int] = None) -> int:
        """Restore the newest complete checkpoint (the port's or the
        reference's); returns its round.

        A checkpoint counts only when both its ``.npz`` and its
        ``meta_{round}.json`` are readable: a torn pair is skipped and the
        next older step tried, unless ``step`` pins one (which raises).
        After resume, :meth:`run` / :meth:`step` continue the interrupted
        batch stream and program state exactly."""
        from repro_torch import checkpoint as C

        candidates = ([step] if step is not None
                      else C.all_steps(directory)[::-1])
        if not candidates:
            raise FileNotFoundError(f"no checkpoints in {directory}")
        for s in candidates:
            try:
                with open(os.path.join(directory,
                                       f"meta_{s:08d}.json")) as f:
                    meta = json.load(f)
                state = self._restored_state(
                    C.load_arrays(C.checkpoint_path(directory, s)))
            except C.CORRUPT_ERRORS + (AssertionError,):
                if step is not None:
                    raise
                continue
            break
        else:
            raise FileNotFoundError(
                f"no complete (npz + meta) checkpoint in {directory}")
        self.state = state
        self.round = int(meta["round"])
        self.history = list(meta["history"])
        self._rng.bit_generator.state = meta["rng_state"]
        return self.round

    def evaluate(self) -> Dict[str, float]:
        """The global model on held-out data: for ``image_synthetic`` the
        test set's accuracy and class-balanced accuracy (the paper-table
        metrics); for ``lm_synthetic`` next-token loss and accuracy on a
        document stream seeded off the experiment seed, as the
        reference's."""
        from repro_torch.core.losses import (accuracy, per_class_accuracy,
                                             softmax_xent)
        from repro_torch.data.synthetic import token_stream

        if self._images:
            x_test, y_test = self._test
            logits = self.program.predict(
                self.state, {"x": torch.from_numpy(x_test).to(self.device)})
            y = torch.from_numpy(y_test).to(self.device)
            return {"acc": float(accuracy(logits, y)),
                    "balanced_acc": float(per_class_accuracy(
                        logits, y, self.spec.data.num_classes))}

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
