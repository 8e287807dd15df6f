"""``Trainer`` -- runs a built experiment from the host, round by round.

It synthesizes the dataset from the spec's :class:`DataSpec`, assembles
each round's batches (eq. 3 sizing, :mod:`repro_torch.data.loader`; in
the ``masked`` and ``sparse`` modes over all K slots, the image budget
``round(server_batch / participation)``),
moves them to the program's device and threads the program state
through :class:`RoundProgram.step`. The host numpy streams are the
reference's (``api/trainer.py``), so both trainers see the same batches:
for ``lm_synthetic`` the documents from ``spec.seed``, the per-client
document choice from ``seed + 1``, client sampling and batch rows from
``default_rng(seed)``; for ``image_synthetic`` the images and their
label-skew partition from ``spec.seed``, client sampling and batch rows
from ``default_rng(seed + 7)``.

    trainer = Trainer(spec, device="cuda")
    history = trainer.run()            # spec.rounds rounds (or events)
    trainer.save("state/")             # resume("state/") continues it

In the ``async`` mode one ``step`` is one event: the batches cover all K
slots, of which the event computes its arrivals'.

With ``execution.rounds_per_call = R > 1`` one ``step`` runs ``min(R,
rounds)`` rounds in one program call: their batches are drawn on the
host in the order the unfused rounds draw them, stacked on a leading
axis and uploaded once; the metrics come back stacked on the device and
reach the host in one copy a chunk, one history entry a round. A chunk
equals its rounds run one by one, bit for bit.

``save`` / ``resume`` checkpoint the whole run, bit for bit: the program
state and the host side (round, history, the numpy bit generator).
``resume`` also reads a directory that the reference ``Trainer.save``
wrote, for the subset-mode SCALA and baseline states, through
:mod:`repro_torch.convert`; its host streams are the reference's, so the
port continues the reference's own batches. A reference masked or sparse
directory holds the JAX scheduler's ``jax.random`` key, which the port
cannot continue: ``resume`` refuses it (its params still start a run,
``--init-params``).
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

    def __init__(self, spec: ExperimentSpec, *, device="cuda", params=None,
                 mesh=None, batch_specs=None):
        self.spec = spec.validate()
        self.program = build(spec, device=device, params=params, mesh=mesh,
                             batch_specs=batch_specs)
        self.device = torch.device(self.program.metadata["device"])
        self.state = self.program.init()
        self.history: List[Dict[str, float]] = []
        self.round = 0
        self._rpc = self.program.metadata.get("rounds_per_call", 1)
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
        """One round's batches and data sizes, on the program's device."""
        rb, sizes = self._draw_round()
        return self._upload(rb), torch.from_numpy(sizes).to(self.device)

    def _upload(self, rb):
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in rb.items()}

    def _draw_round(self):
        """One round's host batches (numpy) and data sizes, from the host
        streams."""
        from repro_torch.data.loader import (lm_round_batches, round_batches,
                                             sample_clients)

        spec, sc = self.spec, self.spec.scala
        if spec.execution.in_program:
            selected = np.arange(sc.num_clients)  # the subset is in-program
        else:
            selected = sample_clients(sc.num_clients, sc.clients_per_round,
                                      self._rng)
        if self._images:
            # masked / sparse: the participants' share of a K-slot round
            # stays the subset mode's server batch
            budget = (round(sc.server_batch / sc.participation)
                      if spec.execution.mode in ("masked", "sparse")
                      else sc.server_batch)
            rb = round_batches(self._data, selected, budget, sc.local_iters,
                               self._rng)
        else:
            rb = lm_round_batches(self._data, selected, sc.server_batch,
                                  sc.local_iters, self._rng)
        sizes = rb.pop("sizes")
        return rb, sizes

    def _host_scalars(self, metrics, ndim: int):
        """The scalar metrics (``ndim`` 0 a round, 1 a chunk) on the host
        as float64 numpy, in their order: every device tensor among them
        comes over in ONE copy (its float32 values exactly); host values
        are read as they are. No metric at all (a baseline) waits for the
        device instead."""
        keys = [k for k, v in metrics.items() if np.ndim(v) == ndim]
        dev = [k for k in keys if isinstance(metrics[k], torch.Tensor)
               and metrics[k].device.type != "cpu"]
        host = {}
        if dev:
            flat = torch.stack([metrics[k].double() for k in dev]).cpu()
            host.update(zip(dev, flat.numpy()))
        elif not metrics and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return {k: host[k] if k in host else np.asarray(
            metrics[k].cpu() if isinstance(metrics[k], torch.Tensor)
            else metrics[k], np.float64) for k in keys}

    def step(self, rounds: Optional[int] = None) -> Dict[str, float]:
        """One program call: ``min(rounds_per_call, rounds)`` rounds (or
        async events), one by default. Returns the last round's (last
        local step's) scalar metrics, with an event's ``staleness_mean``,
        ``t_event``, ``server_version`` (and ``deadline_missed``); one
        history entry is appended per round. The metrics reach the host
        in one copy a call, which waits for the device; a baseline round
        has none, so the call waits for the device itself."""
        n = self._rpc if rounds is None else min(rounds, self._rpc)
        if self._rpc == 1:
            batches, sizes = self._next_round_batches()
            self.state, metrics = self.program.step(self.state, batches,
                                                    sizes)
            per_round = [{k: float(v) for k, v in
                          self._host_scalars(metrics, 0).items()}]
        else:
            # the chunk's rounds drawn in the unfused rounds' order
            drawn = [self._draw_round() for _ in range(n)]
            batches = self._upload({k: np.stack([rb[k] for rb, _ in drawn])
                                    for k in drawn[0][0]})
            sizes = torch.from_numpy(np.stack(
                [sz for _, sz in drawn])).to(self.device)
            self.state, metrics = self.program.step(self.state, batches,
                                                    sizes)
            stacked = self._host_scalars(metrics, 1)
            per_round = [{k: float(v[r]) for k, v in stacked.items()}
                         for r in range(n)]
        self.history.extend(per_round)
        self.round += n
        return per_round[-1]

    def run(self, rounds: Optional[int] = None, *,
            on_round: Optional[Callable[[int, Dict[str, float], float],
                                        Any]] = None):
        """Run ``rounds`` rounds (default ``spec.rounds``) in calls of
        ``rounds_per_call`` (the last one the remainder); returns the
        metric history. ``on_round(index, metrics, seconds)`` fires for
        every round after its call, with the call's wall time (its
        metrics' host copy waits for the device) divided over its
        rounds."""
        n = self.spec.rounds if rounds is None else rounds
        done = 0
        while done < n:
            k = min(self._rpc, n - done)
            t0 = time.perf_counter()
            self.step(k)
            dt = time.perf_counter() - t0
            done += k
            if on_round is not None:
                for j in range(k):
                    on_round(self.round - k + j,
                             self.history[len(self.history) - k + j], dt / k)
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
        if self.program.metadata.get("host_paged"):
            raise ValueError(
                "save/resume with opt_paging='host' is unsupported: the "
                "paged optimizer moments live in the host pager, outside "
                "ProgramState; keep optimizer state on device to "
                "checkpoint")
        self._single_program("save")
        from repro_torch import checkpoint as C

        path = C.save(directory, self.round, self.state)
        C.write_json_atomic(
            os.path.join(directory, f"meta_{self.round:08d}.json"),
            {"round": self.round, "history": self.history,
             "rng_state": self._rng.bit_generator.state})
        return path

    def _single_program(self, what: str):
        mesh = self.program.metadata.get("mesh")
        if mesh is not None and mesh.world > 1:
            raise NotImplementedError(
                f"{what} of a state split over {mesh.world} ranks is not "
                "ported (each rank holds its own client shard)")

    def _restored_state(self, arrays) -> ProgramState:
        from repro_torch import checkpoint as C
        from repro_torch import convert

        if C.PORT_KEY in arrays:
            return C.restore_arrays(arrays, self.state)
        inner, parts = convert.program_state_from_reference(
            arrays, self.spec, self.device)
        fed = dict(self.state.fed, **parts) if parts else self.state.fed
        return ProgramState(inner=inner, fed=fed)

    def resume(self, directory: str, step: Optional[int] = None) -> int:
        """Restore the newest complete checkpoint (the port's or the
        reference's); returns its round.

        A checkpoint counts only when both its ``.npz`` and its
        ``meta_{round}.json`` are readable: a torn pair is skipped and the
        next older step tried, unless ``step`` pins one (which raises).
        After resume, :meth:`run` / :meth:`step` continue the interrupted
        batch stream and program state exactly."""
        self._single_program("resume")
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
                arrays = C.load_arrays(C.checkpoint_path(directory, s))
            except C.CORRUPT_ERRORS:
                if step is not None:
                    raise
                continue
            break
        else:
            raise FileNotFoundError(
                f"no complete (npz + meta) checkpoint in {directory}")
        # a readable file whose state this run cannot take raises
        self.state = self._restored_state(arrays)
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
