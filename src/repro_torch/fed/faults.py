"""Deterministic failure injection for federated rounds.

Real fleets decide participation through failures, not schedulers:
clients crash mid-round, return NaN / Inf or garbage updates, or
straggle. The reference's fault model (``repro.fed.faults``), with the
same spec grammar (comma-joined clauses, as ``make_delays``)::

    drop:P              # the client never arrives this round (prob P)
    corrupt:P[:MODE[:SCALE]]
                        # the update is corrupted in transit; MODE in
                        # {nan, inf, noise}, SCALE only for noise
    stall:P[:FACTOR]    # finish time inflated by FACTOR (async) /
                        # the client is absent (sync)

e.g. ``"drop:0.1,corrupt:0.05:nan,stall:0.02"``.

Semantics per execution mode (the reference's):

- **sync** (masked / sparse): ``drop`` and ``stall`` fold into the
  participation mask before the local steps, so the eq. 14/15 priors and
  logit adjustments are those of the reduced subset; ``corrupt`` rewrites
  the trained client halves after the steps (the server half trained in
  the round is not poisoned).
- **async**: ``drop`` removes an arrival from the event's contribution
  mask, ``corrupt`` poisons the arriving update, ``stall`` multiplies the
  arrival's next delay by ``stall_factor``.

**The draws are the port's.** The reference splits a ``jax.random`` key
threaded through the fed state; the port draws on the host with numpy,
as its schedulers and delays do (:meth:`FaultModel.draw`): round (or
event) ``count`` of the stream ``seed`` draws from
``np.random.default_rng([seed, 0x5FA17, count])``. The tag mirrors the
reference's ``fold_in(key, 0x5FA17)`` and keeps the stream apart from
the participation scheduler's and the delays', both keyed ``[seed,
count]`` under the same seed, so faults are not correlated with who was
sampled or when it arrives. The three masks are always drawn, in the
order drop, corrupt, stall, whatever the probabilities, so changing one
probability never reshuffles the other streams. ``noise`` corruption
draws its Gaussian on the host for the firing rows only, from
``default_rng([seed, 0x5FA17, count, leaf_index])``, so a CPU run and a
card run add the same noise.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.tree import leaves, unflatten

CORRUPT_MODES = ("nan", "inf", "noise")

#: the fault stream's tag in its numpy seed sequence.
FAULT_TAG = 0x5FA17


@dataclasses.dataclass(frozen=True)
class FaultModel:
    """Per-round / per-arrival fault probabilities (all independent).

    ``table``: a recorded model's masks (:func:`recorded`); draw ``count``
    returns ``table[count]`` whatever the seed."""

    drop: float = 0.0
    corrupt: float = 0.0
    corrupt_mode: str = "nan"
    noise_scale: float = 10.0
    stall: float = 0.0
    stall_factor: float = 1000.0
    spec: str = ""
    table: Optional[Tuple[Dict[str, np.ndarray], ...]] = None

    @property
    def any_faults(self) -> bool:
        return (self.drop > 0) or (self.corrupt > 0) or (self.stall > 0)

    def draw(self, seed: int, count: int, n: int) -> Dict[str, np.ndarray]:
        """The float32 (n,) 0/1 masks ``{"drop", "corrupt", "stall"}`` of
        round (or event) ``count`` of the stream ``seed``; 1 means the
        fault fires for that slot or arrival."""
        if self.table is not None:
            masks = self.table[count]
            for name, m in masks.items():
                if m.shape != (n,):
                    raise ValueError(f"recorded {name} mask {count} has "
                                     f"shape {m.shape}; the runner asks "
                                     f"({n},)")
            return {k: v.copy() for k, v in masks.items()}
        rng = np.random.default_rng([int(seed), FAULT_TAG, int(count)])
        return {name: (rng.random(n) < p).astype(np.float32)
                for name, p in (("drop", self.drop),
                                ("corrupt", self.corrupt),
                                ("stall", self.stall))}


def make_faults(spec) -> Optional[FaultModel]:
    """Parse a fault spec string (see the module docstring for the
    grammar). ``None`` and already-parsed :class:`FaultModel`s pass
    through."""
    if spec is None or isinstance(spec, FaultModel):
        return spec
    kw: Dict[str, Any] = {"spec": spec}
    for clause in str(spec).split(","):
        clause = clause.strip()
        if not clause:
            continue
        parts = clause.split(":")
        name = parts[0].strip().lower()
        if name == "drop":
            if len(parts) != 2:
                raise ValueError(
                    f"drop clause needs one probability: {clause!r}")
            kw["drop"] = float(parts[1])
        elif name == "corrupt":
            if len(parts) < 2 or len(parts) > 4:
                raise ValueError(
                    f"corrupt clause is corrupt:P[:MODE[:SCALE]]: {clause!r}")
            kw["corrupt"] = float(parts[1])
            if len(parts) >= 3:
                mode = parts[2].strip().lower()
                if mode not in CORRUPT_MODES:
                    raise ValueError(
                        f"corrupt mode {mode!r} not in {CORRUPT_MODES}")
                kw["corrupt_mode"] = mode
            if len(parts) == 4:
                kw["noise_scale"] = float(parts[3])
        elif name == "stall":
            if len(parts) < 2 or len(parts) > 3:
                raise ValueError(
                    f"stall clause is stall:P[:FACTOR]: {clause!r}")
            kw["stall"] = float(parts[1])
            if len(parts) == 3:
                kw["stall_factor"] = float(parts[2])
        else:
            raise ValueError(
                f"unknown fault clause {name!r} (want drop/corrupt/stall)")
    if len(kw) == 1:                        # only the spec echo: no clauses
        raise ValueError(f"empty fault spec {spec!r}; want comma-joined "
                         "drop:P | corrupt:P[:MODE[:SCALE]] | "
                         "stall:P[:FACTOR]")
    fm = FaultModel(**kw)
    for p in (fm.drop, fm.corrupt, fm.stall):
        if not 0.0 <= p <= 1.0:
            raise ValueError(f"fault probabilities must be in [0,1]: {spec!r}")
    if fm.stall_factor < 1.0:
        raise ValueError("stall factor must be >= 1")
    return fm


def recorded(masks: Sequence[Dict[str, Any]], corrupt_mode: str = "nan",
             noise_scale: float = 10.0,
             stall_factor: float = 1000.0) -> FaultModel:
    """A fault model that replays ``masks``: round (or event) ``c`` gets
    ``masks[c]``, a dict of (n,) 0/1 arrays under any of ``"drop"``,
    ``"corrupt"``, ``"stall"`` (a missing one never fires), whatever the
    seed. The same masks on every device, or the reference's injected."""
    if corrupt_mode not in CORRUPT_MODES:
        raise ValueError(f"corrupt mode {corrupt_mode!r} not in "
                         f"{CORRUPT_MODES}")
    table = []
    for m in masks:
        n = len(next(iter(m.values())))
        table.append({k: np.asarray(m.get(k, np.zeros(n)), np.float32)
                      for k in ("drop", "corrupt", "stall")})
    any_ = {k: any(t[k].any() for t in table)
            for k in ("drop", "corrupt", "stall")}
    return FaultModel(drop=float(any_["drop"]),
                      corrupt=float(any_["corrupt"]),
                      corrupt_mode=corrupt_mode, noise_scale=noise_scale,
                      stall=float(any_["stall"]), stall_factor=stall_factor,
                      spec="recorded", table=tuple(table))


def init_state(seed: int):
    """The sync fault stream's state, ``[seed, count]`` (an int64 CPU
    tensor, as a scheduler's): the round count is the draw's index."""
    return torch.tensor([int(seed), 0], dtype=torch.int64)


def corrupt_update(fm: FaultModel, seed: int, count: int, stacked,
                   corrupt_mask, rows=slice(None)):
    """Corrupt rows of a stacked (C, ...) tree where ``corrupt_mask``
    ((C,) host 0/1) fires: NaN or Inf, or ``noise_scale`` times a
    Gaussian added, by ``fm.corrupt_mode``.

    ``rows``: the slice of the (C,) slots that ``stacked`` holds (a
    rank's client shard on a grid); each of its rows gets exactly what
    the unsharded call gives that slot (the noise is drawn for every
    firing slot, then sliced).

    The rows that fire are rewritten IN PLACE (``index_fill_`` /
    ``index_add_``): pass a tree the round owns, never one the
    round-start state shares."""
    fire = np.flatnonzero(np.asarray(corrupt_mask) > 0)
    start, stop, _ = rows.indices(len(corrupt_mask))
    here = (fire >= start) & (fire < stop)
    if not here.any():
        return stacked
    out = []
    for i, leaf in enumerate(leaves(stacked)):
        idx = torch.from_numpy((fire[here] - start).astype(np.int64)).to(
            leaf.device)
        if fm.corrupt_mode == "noise":
            rng = np.random.default_rng([int(seed), FAULT_TAG, int(count), i])
            noise = np.float32(fm.noise_scale) * rng.standard_normal(
                (fire.size,) + tuple(leaf.shape[1:]), dtype=np.float32)
            leaf.index_add_(0, idx, torch.from_numpy(noise[here]).to(
                leaf.device, leaf.dtype))
        else:
            leaf.index_fill_(0, idx, float("nan") if fm.corrupt_mode == "nan"
                             else float("inf"))
        out.append(leaf)
    return unflatten(stacked, out)
