"""Asynchronous split-federated execution on top of the split step.

The synchronous round (:func:`repro_torch.core.engine.make_round_runner`)
is a barrier: every participant trains from the same aggregated model.
Real fleets are asynchronous: clients finish at different times, and
their updates were computed against older global models. This module is
the reference's event runtime (``repro.fed.runtime``, GAS-style
staleness-aware delayed aggregation, arXiv:2409.01251):

1. Every client holds a **snapshot** of the global client half tagged with
   the server **version** it was taken at, and a **finish time** drawn
   from a :class:`repro_torch.fed.delays.DelayModel`.
2. One call of the runner is one **event**: the ``cohort`` earliest
   finishers arrive. Their T local steps run on a dense axis gathered
   from the K static slots (the sparse round's gather), with the label
   priors and logit adjustments recomputed over the arrival cohort.
3. The arrivals' client halves fold into the global model with weights
   decayed by ``staleness_decay ** age`` (age: server versions since the
   snapshot), renormalized over the cohort; the global client half moves
   ``mix_rate`` of the way to the cohort average. The server half trains
   in the steps as always, with an optional FedOpt ``server_optimizer``
   over its event delta.
4. The cohort re-snapshots the new global model at the new version and
   draws fresh delays; the clock moves to the cohort's latest arrival.

With ``delays=constant(0)`` and ``cohort=K`` every client arrives at
every event at staleness 0 and the event is the synchronous round.

**The schedule lives on the host.** ``finish_time`` ((K,) float32),
``version`` and ``retries`` ((K,) int32) are numpy arrays, and
``server_version`` and ``now`` host scalars: the pop, the staleness
ages, the ring lookup and the new delays are numpy operations (in
float32, as the reference's), so an event never waits for the device to
know who arrives. The pop (:func:`arrival_cohort`) orders by finish time,
then version (FIFO), then slot id; ``"sort"`` is a lexsort, ``"topk"``
an O(K) selection (``np.partition`` and a tie ladder), bit-identical.

Snapshot storage (``snapshots=``): ``"dense"`` keeps one client half per
slot, (K, ...) tensors of their own; ``"delta"`` keeps a ring of the
``ring_size`` most recent global client halves (slot ``v % ring_size``
holds global@v) and reconstructs a snapshot from its version tag
(:func:`ring_lookup`); a version older than the ring is clamped to the
oldest one kept. Delta stores no per-client optimizer state: it needs a
stateless optimizer, ``opt_state_policy="reset"``, or the host-paged
moment store (:class:`HostOptPager`).

**Memory.** A client half of qwen1.5-0.5b is ~0.73 GB, so 16 dense
snapshots and a momentum stack over 16 slots are ~11.7 GB each. With
``donate=True`` (the default, as the reference donates its event's
buffers) the event writes the cohort's rows into ``afed``'s snapshot
stack or ring and into ``state``'s client moment stack in place: the
caller gives both states up. ``donate=False`` keeps the event
functional (each write copies the whole stack).

**Faults and guards** (:mod:`repro_torch.fed.faults`,
:mod:`repro_torch.fed.guards`): the event that starts at server version
``v`` draws its arrivals' drop / corrupt / stall masks from
``default_rng([seed, 0x5FA17, v])`` (the delays keep ``[seed, v + 1]``).
A dropped arrival leaves the contribution mask before the steps, a
corrupted one's update is rewritten after them, a stalled one's next
delay is multiplied by ``stall_factor`` before the deadline's backoff.
The guards screen the cohort's updates against the gathered snapshots;
a rejection re-runs the cohort's steps from them over the survivors.

Not ported here: ``backend="lace_dp"``, ``arrival="topk:sharded"`` and
the sharded pop (the multi-device slice).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.configs.base import ScalaConfig
from repro_torch.core import engine
from repro_torch.core.split import (normalize_client_weights,
                                    stack_client_params, weighted_mean)
from repro_torch.fed import aggregators as _agg
from repro_torch.fed.delays import DelayModel
from repro_torch.optim import optimizers, schedules
from repro_torch.tree import leaves, tree_map

#: snapshot storage layouts for :class:`AsyncFedState`.
SNAPSHOT_MODES = ("dense", "delta")

#: arrival-pop implementations: ``"sort"`` (lexsort), ``"topk"`` (O(K)
#: selection, bit-identical) and ``"topk:sharded"`` (the multi-device
#: slice's).
ARRIVALS = ("sort", "topk", "topk:sharded")

#: per-arrival lr scaling policies (see :func:`make_async_runner`).
LR_SCALES = ("none", "cohort")

#: ring_versions tag for a slot that has never been written.
NO_VERSION = -(2 ** 30)

_MULTI_DEVICE = "the multi-device slice"


@dataclass(frozen=True)
class AsyncFedState:
    """Per-client dispatch state threaded through events.

    client_params: (K, ...) per-client snapshots of the global client
    half, tensors of their own (``()`` under ``snapshots="delta"``);
    version: (K,) int32 numpy, the server version of each snapshot;
    server_version: int, events applied so far;
    finish_time: (K,) float32 numpy, each client's completion time;
    now: np.float32, the event clock (the last cohort's latest arrival);
    seed: int, the delay stream's seed (:meth:`DelayModel.draw`);
    agg_state: the aggregator's carry (usually ``()``);
    server_opt: server-side FedOpt state (or ``()``);
    ring: (ring_size, ...) recent global client halves (delta only);
    ring_versions: (ring_size,) int32 numpy version tag per ring slot;
    retries: (K,) int32 numpy consecutive deadline misses per client;
    guard: the guards' running-median clip state (or ``()``).
    """

    client_params: Any
    version: Any
    server_version: int
    finish_time: Any
    now: Any
    seed: int
    agg_state: Any = ()
    server_opt: Any = ()
    ring: Any = ()
    ring_versions: Any = ()
    retries: Any = ()
    guard: Any = ()


def _own(tree):
    """Every leaf copied into dense memory of its own (a broadcast view
    over slots would alias every slot; a numpy-backed tensor the
    caller's array)."""
    return tree_map(lambda a: a.clone(memory_format=torch.contiguous_format),
                    tree)


def init_async_state(seed: int, client_params, delays: DelayModel, *,
                     aggregator=None, server_optimizer=None,
                     server_params=None, snapshots: str = "dense",
                     ring_size: int = 64,
                     num_clients: Optional[int] = None,
                     guards=None) -> AsyncFedState:
    """Dispatch all K clients at version 0, each with its first delay
    (draw 0 of the stream ``seed``).

    ``client_params`` is the stacked client half (every slot the same
    init); the dense snapshots are a copy of it. With ``snapshots=
    "delta"`` pass it stacked over one slot (row 0 is taken) and
    ``num_clients=K``: the state holds a ``ring_size``-deep ring of the
    global client half instead. Pass the runner's ``aggregator``,
    ``server_optimizer`` and ``guards`` so their state matches (a
    clipping policy's running median under ``guard``).
    """
    from repro_torch.fed import guards as _guards

    gp = _guards.make_guards(guards)
    if snapshots not in SNAPSHOT_MODES:
        raise ValueError(f"unknown snapshots mode {snapshots!r}; expected "
                         f"{SNAPSHOT_MODES}")
    lead = leaves(client_params)[0].shape[0]
    K = lead if num_clients is None else num_clients
    if snapshots == "dense" and num_clients is not None and lead != K:
        raise ValueError(f"dense snapshots need client_params stacked over "
                         f"all {K} clients, got {lead} slots")
    if server_optimizer is not None and server_params is None:
        raise ValueError("init_async_state needs server_params when a "
                         "server_optimizer is given")
    if snapshots == "delta":
        if ring_size < 1:
            raise ValueError(f"ring_size must be >= 1, got {ring_size}")
        snap = ()
        ring = _own(tree_map(
            lambda a: a[0][None].expand((ring_size,) + a.shape[1:]),
            client_params))
        ring_versions = np.full((ring_size,), NO_VERSION, np.int32)
        ring_versions[0] = 0
    else:
        snap, ring, ring_versions = _own(client_params), (), ()
    device = leaves(client_params)[0].device
    return AsyncFedState(
        client_params=snap,
        version=np.zeros((K,), np.int32),
        server_version=0,
        finish_time=delays.draw(seed, 0, (K,)),
        now=np.float32(0.0),
        seed=int(seed),
        agg_state=aggregator.init(K, device) if aggregator is not None
        else (),
        server_opt=(server_optimizer.init(server_params)
                    if server_optimizer is not None else ()),
        ring=ring,
        ring_versions=ring_versions,
        retries=np.zeros((K,), np.int32),
        guard=(_guards.init_state(device) if gp is not None and gp.stateful
               else ()))


def _pop_topk(finish_time, version, cohort: int):
    """The ``cohort`` minima of the composite key (finish_time, version,
    slot) in O(K): one ``np.partition`` per key component gives the
    boundary value b of the still-tied set; everything strictly below b
    is selected, the ties at b go on to the next component, and the ties
    left at the end are taken in slot order (the lexsort's stability)."""
    K = finish_time.shape[0]
    selected = np.zeros(K, bool)
    eligible = np.ones(K, bool)
    need = cohort
    for key in ([finish_time] if version is None
                else [finish_time, version]):
        b = np.partition(key[eligible], need - 1)[need - 1]
        strict = eligible & (key < b)
        selected |= strict
        need -= int(strict.sum())
        eligible &= key == b
    selected[np.flatnonzero(eligible)[:need]] = True
    return np.flatnonzero(selected)


def arrival_cohort(finish_time, cohort: int, version=None,
                   method: str = "sort"):
    """The event schedule's pop: the ``cohort`` earliest finishers.

    Returns (idx (cohort,) ascending int64 slot ids, mask (K,) 0/1
    float32, t_event: the cohort's latest finish time, np.float32), all
    numpy. Ties in finish time go to the lower ``version`` (the longest
    waiting client: without it, zero or tied delays with ``cohort < K``
    would re-arm the same slots and starve the rest), then to the lower
    slot id. ``"sort"`` is a stable lexsort, ``"topk"`` the O(K)
    :func:`_pop_topk`; their outputs are bit-identical.
    """
    finish_time = np.asarray(finish_time, np.float32)
    version = None if version is None else np.asarray(version, np.int32)
    if method == "topk":
        idx = _pop_topk(finish_time, version, cohort)
    elif method == "sort":
        order = (np.argsort(finish_time, kind="stable") if version is None
                 else np.lexsort((version, finish_time)))
        idx = np.sort(order[:cohort])
    elif method == "topk:sharded":
        raise NotImplementedError("arrival 'topk:sharded' is not ported "
                                  f"yet; it comes with {_MULTI_DEVICE}")
    else:
        raise ValueError(f"unknown arrival method {method!r}; expected "
                         "'sort' or 'topk'")
    idx = idx.astype(np.int64)
    mask = np.zeros(finish_time.shape[0], np.float32)
    mask[idx] = 1.0
    return idx, mask, finish_time[idx].max()


def make_arrival_pop(cohort: int, arrival: str = "sort"):
    """The configured pop as ``pop(finish_time, version) -> (idx, mask,
    t_event)``."""
    if arrival not in ARRIVALS:
        raise ValueError(f"unknown arrival {arrival!r}; expected {ARRIVALS}")
    if arrival == "topk:sharded":
        raise NotImplementedError("the sharded arrival pop is not ported "
                                  f"yet; it comes with {_MULTI_DEVICE}")
    return lambda ft, v: arrival_cohort(ft, cohort, v, method=arrival)


def ring_lookup(ring, versions, server_version: int, ring_size: int):
    """Snapshots for the slots with tags ``versions`` ((m,) int numpy)
    from the ring: (the snapshots with a leading (m,) axis, the effective
    versions). A version older than the ring is clamped to the oldest one
    kept, ``server_version - ring_size + 1`` (bounded-staleness
    eviction); ring slot ``v % ring_size`` holds global@v."""
    eff = np.maximum(np.asarray(versions, np.int32),
                     np.int32(server_version - ring_size + 1))
    slot = torch.from_numpy((eff % ring_size).astype(np.int64))
    return tree_map(lambda r: r.index_select(0, slot.to(r.device)),
                    ring), eff


def _nbytes(tree) -> int:
    total = 0
    for a in leaves(tree):
        if isinstance(a, torch.Tensor):
            total += a.numel() * a.element_size()
        elif isinstance(a, (np.ndarray, np.generic)):
            total += a.nbytes
    return int(total)


def async_state_bytes(afed: AsyncFedState) -> dict:
    """Resident bytes of an :class:`AsyncFedState`: ``snapshot_bytes``
    (the dense snapshots, O(K x |w_c|), or the ring, O(ring_size x
    |w_c|)), ``per_client_scalar_bytes`` (version and finish_time, 8 a
    client), ``other_bytes`` and ``total_bytes``."""
    snap = _nbytes(afed.client_params) + _nbytes(afed.ring)
    per_client = _nbytes(afed.version) + _nbytes(afed.finish_time)
    other = _nbytes((afed.ring_versions, np.int32(afed.server_version),
                     afed.now, afed.agg_state, afed.server_opt,
                     afed.retries))
    return {"snapshot_bytes": snap,
            "per_client_scalar_bytes": per_client,
            "other_bytes": other,
            "total_bytes": snap + per_client + other}


def _numpy_dtype(dtype: torch.dtype):
    return torch.empty((), dtype=dtype).numpy().dtype


class HostOptPager:
    """Host-paged per-client optimizer moments for ``snapshots="delta"``
    with ``opt_state_policy="carry"``.

    The cold (K, ...) moment stack lives in host memory (numpy); each
    event pages the arrival cohort's rows in (:meth:`gather`), feeds them
    to the steps as the cohort's carried moments, and pages the updated
    rows out (:meth:`scatter`). The device holds O(cohort) moments. The
    pop runs on the host, so the rows paged are the event's own arrivals
    (no prediction). One pager backs one live training state; call
    :meth:`reset` when re-initializing it.
    """

    def __init__(self, opt: optimizers.Optimizer, client_template,
                 num_clients: int):
        """``client_template``: ONE client's (unstacked) client half; the
        store holds ``num_clients`` zero rows of ``opt.init``'s shapes
        (the stacked init over identical snapshots)."""
        meta = tree_map(lambda a: torch.empty(a.shape, dtype=a.dtype,
                                              device="meta"),
                        client_template)
        self.num_clients = num_clients
        self._store = tree_map(
            lambda s: np.zeros((num_clients,) + tuple(s.shape),
                               _numpy_dtype(s.dtype)), opt.init(meta))
        self.seconds = {"page_in": 0.0, "page_out": 0.0}

    def reset(self):
        """Zero every moment row (a fresh ``opt.init`` for all K)."""
        for a in leaves(self._store):
            a.fill(0)

    def gather(self, idx, device="cpu"):
        """Page rows ``idx`` in: host (K, ...) -> ``device`` (cohort,
        ...)."""
        t0 = time.perf_counter()
        idx = np.asarray(idx)
        out = tree_map(lambda a: torch.from_numpy(a[idx]).to(device),
                       self._store)
        self.seconds["page_in"] += time.perf_counter() - t0
        return out

    def scatter(self, idx, cohort_opt):
        """Page the cohort's updated moments out to rows ``idx`` (waits
        for the device)."""
        t0 = time.perf_counter()
        idx = np.asarray(idx)

        def put(a, s):
            a[idx] = s.detach().cpu().numpy().astype(a.dtype, copy=False)

        tree_map(put, self._store, cohort_opt)
        self.seconds["page_out"] += time.perf_counter() - t0

    def nbytes(self) -> int:
        """Host-resident bytes of the cold moment stack."""
        return int(sum(a.nbytes for a in leaves(self._store)))


def _resolve_schedule(schedule, scala: ScalaConfig, lr_scale: str,
                      cohort: int, num_clients: Optional[int]):
    """The event schedule's lr policy. The global step ticks once per
    local iteration of whichever cohort arrived; ``"cohort"`` scales the
    lr by ``cohort / K`` (in float32; exactly 1.0 at cohort == K)."""
    if lr_scale not in LR_SCALES:
        raise ValueError(f"unknown lr_scale {lr_scale!r}; expected "
                         f"{LR_SCALES}")
    sched = schedule if schedule is not None else schedules.constant(scala.lr)
    if lr_scale == "none":
        return sched
    if num_clients is None:
        raise ValueError("lr_scale='cohort' needs num_clients= (the factor "
                         "is cohort / K)")
    factor = np.float32(cohort / num_clients)
    return lambda step: float(np.float32(sched(step)) * factor)


def _write_rows(full_tree, sub_tree, rows, donate: bool):
    """``full_tree`` with rows ``rows`` (a tensor) set to ``sub_tree``'s
    rows: in place into dense leaves when ``donate``, else a copy."""

    def put(f, s):
        s = s.to(f.dtype)
        if donate and f.is_contiguous():
            return f.index_copy_(0, rows.to(f.device), s)
        return f.index_copy(0, rows.to(f.device), s)

    return tree_map(put, full_tree, sub_tree)


def make_async_runner(model: engine.SplitModel, scala: ScalaConfig, *,
                      delays: DelayModel,
                      cohort: int,
                      backend: str = "logits",
                      boundary: str = "fused",
                      optimizer: Optional[optimizers.Optimizer] = None,
                      schedule: Optional[Callable] = None,
                      ce_chunk: Optional[int] = None,
                      staleness_decay: float = 0.5,
                      mix_rate: float = 1.0,
                      aggregator=None,
                      server_optimizer: Optional[optimizers.Optimizer] = None,
                      server_lr: float = 1.0,
                      opt_state_policy: str = "carry",
                      precision: str = "f32",
                      snapshots: str = "dense",
                      ring_size: int = 64,
                      lr_scale: str = "none",
                      num_clients: Optional[int] = None,
                      emit_client_metrics: bool = True,
                      arrival: str = "sort",
                      paged_opt: bool = False,
                      deadline: Optional[float] = None,
                      backoff: float = 2.0,
                      donate: bool = True,
                      faults=None, guards=None):
    """Build the event: ``async_fn(state, afed, round_batches,
    data_sizes=None, cohort_opt=None) -> (state, afed, metrics)``.

    ``round_batches`` leaves are (T, K, Bk, ...), one schedule for every
    static slot, of which only the arrivals' columns are computed; or
    (T, cohort, Bk, ...), consumed by the arrivals directly (a
    prior-free aggregator only). The keywords are the reference's:

    * ``delays`` / ``cohort``: the completion delays and the arrivals an
      event waits for (``cohort=K`` is a full barrier).
    * ``staleness_decay`` / ``mix_rate``: an arrival ``a`` versions old
      weighs ``staleness_decay ** a`` in the cohort weights; the global
      client half moves ``mix_rate`` toward the cohort average.
    * ``aggregator``: the base weights (default data-size ``weighted``).
    * ``server_optimizer`` / ``server_lr``: FedOpt on the server half's
      event delta (state in ``afed.server_opt``).
    * ``opt_state_policy``: the cohort's moments at the event boundary:
      ``carry`` writes them back to their slots, ``reset`` zeroes them,
      ``average`` gives each the cohort-weighted mean.
    * ``snapshots`` / ``ring_size``: dense or delta storage (module
      docstring); delta builds ``state.params["client"]`` over ONE slot.
    * ``lr_scale``: ``"cohort"`` multiplies the schedule by
      ``cohort / num_clients``.
    * ``emit_client_metrics``: the (K,) ``arrival_mask`` / ``staleness``
      numpy vectors in the metrics.
    * ``arrival``: the pop, ``"sort"`` or ``"topk"``.
    * ``paged_opt``: host-paged moments (:class:`HostOptPager`; delta and
      carry only): the event takes the cohort's paged-in moments as
      ``cohort_opt`` and returns the updated ones as a FOURTH output.
    * ``deadline`` / ``backoff``: the event fires at ``min(cohort-th
      finish, first finish + deadline)``; arrivals past the cut are masked
      out of the steps (the priors cover only the present ones), keep
      their snapshot, moments and version, and are requeued at ``t_event
      + delay * backoff ** retries``. Their rows are still computed.
    * ``donate``: write the cohort's rows into ``afed``'s and ``state``'s
      stacks in place (module docstring).
    * ``faults`` / ``guards``: per-arrival drop / corrupt / stall, and the
      screen with the survivor re-run (module docstring); a clipping
      guard keeps its median in ``afed.guard`` (``init_async_state(...,
      guards=)``). Not with ``paged_opt``, as the reference.

    ``state.params["client"]`` holds the current global client half
    broadcast over the K slots (one slot under delta). Metrics: the last
    step's, plus ``staleness_mean`` over the cohort, ``t_event``,
    ``server_version``, with a deadline ``deadline_missed`` and with
    guards ``guard_accept``, ``guard_norm`` (over the cohort) and
    ``guard_rejected``.
    """
    if opt_state_policy not in engine.OPT_STATE_POLICIES:
        raise ValueError(f"unknown opt_state_policy {opt_state_policy!r}; "
                         f"expected {engine.OPT_STATE_POLICIES}")
    if snapshots not in SNAPSHOT_MODES:
        raise ValueError(f"unknown snapshots mode {snapshots!r}; expected "
                         f"{SNAPSHOT_MODES}")
    if snapshots == "delta" and opt_state_policy == "average":
        raise ValueError(
            "snapshots='delta' stores no per-client optimizer state to "
            "average; use opt_state_policy 'reset' (or 'carry' with a "
            "stateless optimizer)")
    if cohort < 1:
        raise ValueError(f"cohort must be >= 1, got {cohort}")
    if arrival not in ARRIVALS:
        raise ValueError(f"unknown arrival {arrival!r}; expected {ARRIVALS}")
    if paged_opt and (snapshots != "delta" or opt_state_policy != "carry"):
        raise ValueError(
            "paged_opt pages per-client moments for snapshots='delta' + "
            "opt_state_policy='carry' (dense snapshots already store them "
            f"on device); got snapshots={snapshots!r}, "
            f"opt_state_policy={opt_state_policy!r}")
    from repro_torch.fed import faults as _faults
    from repro_torch.fed import guards as _guards

    faults = _faults.make_faults(faults)
    guards = _guards.make_guards(guards)
    if deadline is not None and deadline <= 0:
        raise ValueError(f"deadline must be > 0, got {deadline}")
    if backoff < 1.0:
        raise ValueError(f"backoff must be >= 1, got {backoff}")
    robust = (deadline is not None) or (faults is not None) \
        or (guards is not None)
    if robust and backend == "lace_dp":
        raise ValueError(
            "deadline/faults/guards are not supported on the lace_dp event "
            "(its pop and FL phase run inside shard_map); use a single-host "
            "backend")
    if robust and paged_opt:
        raise ValueError(
            "deadline/faults/guards are not supported with host-paged "
            "optimizer moments (the pager's arrival prediction does not "
            "model partial cohorts)")
    if backend == "lace_dp" or arrival == "topk:sharded":
        raise NotImplementedError(
            "the lace_dp event and the sharded arrival pop are not ported "
            f"yet; they come with {_MULTI_DEVICE}")
    delta = snapshots == "delta"
    opt = optimizer if optimizer is not None else optimizers.sgd()
    agg = aggregator if aggregator is not None else _agg.weighted()
    sched = _resolve_schedule(schedule, scala, lr_scale, cohort, num_clients)
    pop = make_arrival_pop(cohort, arrival)
    step = engine.make_split_step(model, scala, backend=backend,
                                  boundary=boundary, optimizer=opt,
                                  schedule=sched, ce_chunk=ce_chunk,
                                  precision=precision)
    decay_base = np.float32(staleness_decay)
    mu = float(mix_rate)

    def async_fn(state: engine.TrainState, afed: AsyncFedState,
                 round_batches, data_sizes=None, cohort_opt=None):
        K = afed.version.shape[0]
        if cohort > K:
            raise ValueError(f"cohort {cohort} exceeds the {K} client slots")
        if paged_opt and cohort_opt is None:
            raise ValueError(
                "the paged event needs cohort_opt= (the arrival cohort's "
                "paged-in moments: HostOptPager.gather over the event's "
                "arrivals, make_arrival_pop)")
        if delta and not paged_opt and opt_state_policy == "carry" \
                and leaves(state.opt_state["client"]):
            raise ValueError(
                "snapshots='delta' cannot carry per-client optimizer "
                "moments (none are stored); use a stateless optimizer "
                "(plain sgd), opt_state_policy='reset', or the host-paged "
                "moment store (paged_opt=True + HostOptPager)")
        device = leaves(state.params["server"])[0].device
        if guards is not None and guards.clip > 0 and afed.guard == ():
            raise ValueError(
                "guard norm clipping needs afed.guard (running median) -- "
                "build the state with init_async_state(..., guards=...)")

        # --- the pop, on the host: who arrives, and when ---
        idx, arrival_mask, t_event = pop(afed.finish_time, afed.version)
        present = None
        if deadline is not None:
            # the cohort barrier degrades gracefully: arrivals past
            # first finish + deadline miss the event and back off
            ft_sub = afed.finish_time[idx]
            t_event = np.minimum(t_event, ft_sub.min() + np.float32(deadline))
            present = (ft_sub <= t_event).astype(np.float32)
            arrival_mask = np.zeros((K,), np.float32)
            arrival_mask[idx] = present
        staleness = (np.int32(afed.server_version)
                     - afed.version).astype(np.float32)
        idx_t = torch.from_numpy(idx).to(device)

        # --- fault injection: per-arrival drop / corrupt / stall ---
        contrib = present
        corrupt_sub = stall_sub = None
        if faults is not None:
            fmasks = faults.draw(afed.seed, afed.server_version, cohort)
            alive = 1.0 - fmasks["drop"]
            contrib = alive if contrib is None else contrib * alive
            corrupt_sub = fmasks["corrupt"] * contrib
            stall_sub = fmasks["stall"]

        # --- the cohort's state: gathered from the dense snapshots, or
        # rebuilt from the ring (delta) ---
        if delta:
            snap_c, _ = ring_lookup(afed.ring, afed.version[idx],
                                    afed.server_version, ring_size)
            opt_sub = (cohort_opt if paged_opt
                       else engine._client_opt_init(opt, snap_c))
        else:
            snap_c = engine.gather_rows(afed.client_params, idx_t)
            opt_sub = engine.gather_rows(state.opt_state["client"], idx_t)
        # the pre-step cohort state: the screen's reference and the
        # re-run's start (the first step never overwrites it)
        sub0 = engine.TrainState(
            params={"client": snap_c, "server": state.params["server"]},
            opt_state={"client": opt_sub,
                       "server": state.opt_state["server"]},
            step=state.step)
        b_lead = leaves(round_batches)[0].shape[1]
        if b_lead == K:
            pick = lambda v: v.index_select(0, idx_t)        # noqa: E731
        elif b_lead == cohort:
            if agg.needs_priors:
                raise ValueError(
                    f"aggregator {agg.name!r} needs (K,)-indexed aggregation "
                    "priors, which cohort-sized round_batches cannot "
                    "provide; pass full (T, K, ...) batches")
            pick = lambda v: v                               # noqa: E731
        else:
            raise ValueError(
                f"round_batches client axis is {b_lead}; expected the {K} "
                f"static slots or the {cohort}-sized arrival cohort")
        T = leaves(round_batches)[0].shape[0]

        def run_local(m_np, again=False):
            """The cohort's T steps from ``sub0``, the priors and logit
            adjustments over the arrivals (masked down to ``m_np``, a
            (cohort,) host mask, when given), then the corruption in
            transit: (state, metrics, None), as
            :func:`repro_torch.fed.guards.guarded` calls it (the mask is
            always passed, so a re-run, ``again``, is no different)."""
            mask_t = None if m_np is None else torch.from_numpy(
                np.asarray(m_np, np.float32)).to(device)
            sub, metrics = sub0, {}
            for t in range(T):
                # from the second step on the cohort's state is the
                # event's own: its update may overwrite it
                sub, metrics = step(sub, {k: pick(v[t]) for k, v in
                                          round_batches.items()}, mask_t,
                                    donate=t > 0)
            if corrupt_sub is not None:
                _faults.corrupt_update(faults, afed.seed,
                                       afed.server_version,
                                       sub.params["client"], corrupt_sub)
            return sub, metrics, None

        # --- guarded aggregation: screen the arriving updates, re-run
        # the cohort's steps over the survivors after a rejection ---
        screened = None
        new_guard = afed.guard
        if guards is not None:
            sub, metrics, _, screened = _guards.guarded(
                guards, afed.guard, snap_c, contrib, cohort, run_local)
            contrib, new_guard = screened.survivors, screened.state
        else:
            sub, metrics, _ = run_local(contrib)

        mask_eff_np = arrival_mask
        if contrib is not None:
            mask_eff_np = np.zeros((K,), np.float32)
            mask_eff_np[idx] = contrib

        # --- staleness-weighted delayed aggregation ---
        mask_eff = torch.from_numpy(mask_eff_np).to(device)
        p_k = p_global = None
        if agg.needs_priors:
            p_k, p_global = _agg.aggregation_priors(
                model.num_classes, round_batches["labels"],
                round_batches.get("weights"), client_axis=1)
        ctx = _agg.AggContext(num_clients=K, mask=mask_eff,
                              data_sizes=data_sizes, p_k=p_k,
                              p_global=p_global)
        w_base, agg_state = agg.client_weights(ctx, afed.agg_state)
        decay = torch.from_numpy(np.power(decay_base, staleness)).to(device)
        r_hat = normalize_client_weights(w_base * decay, mask_eff)
        pc_sub = sub.params["client"]
        if screened is not None:
            # in place: the cohort's trained rows are the event's own
            screened.apply_(snap_c, pc_sub)
        cohort_avg = weighted_mean(pc_sub, r_hat.index_select(0, idx_t))
        new_global = tree_map(
            lambda g, c: ((1.0 - mu) * engine.at_least_f32(g[0])
                          + mu * engine.at_least_f32(c)).to(g.dtype),
            state.params["client"], cohort_avg)

        # --- the server half: its steps' result, then optional FedOpt ---
        new_ws = sub.params["server"]
        server_opt_state = afed.server_opt
        if server_optimizer is not None:
            ws_delta = tree_map(
                lambda a, b: engine.at_least_f32(a) - engine.at_least_f32(b),
                state.params["server"], new_ws)
            new_ws, server_opt_state = server_optimizer.update(
                ws_delta, server_opt_state, state.params["server"],
                server_lr)

        # --- the rows the event writes: every arrival, or only the
        # present ones (a missed arrival never delivered; a dropped or
        # rejected one that was present restarts from the new version) ---
        if present is None:
            rows, rows_t, pos_t = idx, idx_t, None
        else:
            pos = np.flatnonzero(present > 0)
            rows = idx[pos]
            rows_t = torch.from_numpy(rows).to(device)
            pos_t = torch.from_numpy(pos).to(device)
        take = (lambda a: a) if pos_t is None else \
            (lambda a: a.index_select(0, pos_t))             # noqa: E731

        # --- the cohort's moments at the event boundary ---
        if delta:
            new_client = stack_client_params(new_global, 1)
            opt_c = engine._client_opt_init(opt, new_client)
        else:
            sub_opt_c = sub.opt_state["client"]
            if opt_state_policy == "reset":
                sub_opt_c = engine._client_opt_init(opt,
                                                    sub.params["client"])
            elif opt_state_policy == "average":
                r_sub = r_hat.index_select(0, idx_t)

                def avg(a):
                    wb = r_sub.reshape((-1,) + (1,) * (a.dim() - 1)).float()
                    m = (a.float() * wb).sum(0).to(a.dtype)
                    return m[None].expand(a.shape)

                sub_opt_c = tree_map(avg, sub_opt_c)
            opt_c = _write_rows(state.opt_state["client"],
                                tree_map(take, sub_opt_c), rows_t, donate)
            new_client = stack_client_params(new_global, K)

        # --- re-dispatch the cohort at the new version ---
        new_version = afed.server_version + 1
        new_delays = delays.draw(afed.seed, new_version, (cohort,))
        eff_delays = new_delays
        if stall_sub is not None:
            # a stalled arrival straggles for stall_factor x its delay;
            # the deadline's backoff later rescues the schedule
            eff_delays = np.where(stall_sub > 0, eff_delays * np.float32(
                faults.stall_factor), eff_delays).astype(np.float32)
        version = afed.version.copy()
        retries = afed.retries.copy()
        if present is not None:
            retries_sub = afed.retries[idx]
            boff = np.power(np.float32(backoff),
                            retries_sub.astype(np.float32))
            eff_delays = np.where(present > 0, eff_delays, new_delays * boff)
            retries[idx] = np.where(present > 0, 0, retries_sub + 1)
        version[rows] = new_version
        finish_time = afed.finish_time.copy()
        finish_time[idx] = t_event + eff_delays
        if delta:
            slot = new_version % ring_size
            snap = afed.client_params
            ring = _write_rows(afed.ring, tree_map(lambda g: g[None],
                                                   new_global),
                               torch.tensor([slot], device=device), donate)
            ring_versions = afed.ring_versions.copy()
            ring_versions[slot] = new_version
        else:
            snap = _write_rows(afed.client_params, tree_map(
                lambda g: g[None].expand((len(rows),) + g.shape),
                new_global), rows_t, donate)
            ring, ring_versions = afed.ring, afed.ring_versions
        new_afed = AsyncFedState(
            client_params=snap, version=version,
            server_version=new_version, finish_time=finish_time,
            now=np.float32(t_event), seed=afed.seed, agg_state=agg_state,
            server_opt=server_opt_state, ring=ring,
            ring_versions=ring_versions, retries=retries, guard=new_guard)
        new_state = engine.TrainState(
            params={"client": new_client, "server": new_ws},
            opt_state={"client": opt_c, "server": sub.opt_state["server"]},
            step=sub.step)
        metrics = dict(metrics)
        if emit_client_metrics:
            metrics.update(
                arrival_mask=arrival_mask, staleness=staleness,
                staleness_mean=np.float32(
                    (staleness * arrival_mask).sum()
                    / max(arrival_mask.sum(), np.float32(1.0))))
        else:
            metrics.update(staleness_mean=np.float32(staleness[idx].mean()))
        metrics.update(t_event=np.float32(t_event),
                       server_version=new_version)
        if screened is not None:
            metrics.update(screened.metrics)
        if present is not None:
            metrics.update(deadline_missed=np.float32(cohort)
                           - present.sum())
        if paged_opt:
            return new_state, new_afed, metrics, sub.opt_state["client"]
        return new_state, new_afed, metrics

    return async_fn
