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

**On a grid of ranks** (:class:`repro_torch.sharding.Grid`, ``mesh=``):
``init_async_state(mesh=)`` keeps each rank's block of the (K,)
``version`` / ``finish_time`` / ``retries`` (split over the client
shards, as the reference's ``client_scalar_spec`` lays them out), and
``arrival="topk:sharded"`` pops with :func:`sharded_arrival_cohort`: a
local top-``cohort`` per shard, ONE all_gather of the candidate triples,
one lexsort merge, bitwise the single pop. ``backend="lace_dp"`` runs
the whole event per rank (:func:`_make_async_runner_dp`): each client
shard pops ``cohort / n_shards`` of its own finishers, trains them
through the ``lace_dp`` step, and folds them into the global client half
with the aggregator's ``shard_local`` weights and one sum over the
shards; its state is the rank's (the snapshots and moments of its
client shard; the server half and, under delta, the ring replicated),
its round batches and data sizes global.
"""
from __future__ import annotations

import functools
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
#: selection, bit-identical) and ``"topk:sharded"`` (per client shard,
#: merged: :func:`sharded_arrival_cohort`).
ARRIVALS = ("sort", "topk", "topk:sharded")

#: per-arrival lr scaling policies (see :func:`make_async_runner`).
LR_SCALES = ("none", "cohort")

#: ring_versions tag for a slot that has never been written.
NO_VERSION = -(2 ** 30)


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
                     guards=None, mesh=None) -> AsyncFedState:
    """Dispatch all K clients at version 0, each with its first delay
    (draw 0 of the stream ``seed``).

    ``mesh`` (a Grid): the (K,) ``version``, ``finish_time`` and
    ``retries`` hold this rank's client-shard block (the whole vector
    when K does not divide over the shards), the delays its block of the
    unsharded draw (:meth:`DelayModel.sample_sharded`). Dense snapshots
    may then be this rank's rows (the ``lace_dp`` event's state) or all
    K (a single-program event with the sharded pop).

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
    n_blocks = 1
    if mesh is not None:
        from repro_torch.sharding import client_scalar_spec

        n_blocks = mesh.n_client_shards if client_scalar_spec(mesh, K) \
            else 1
    if snapshots == "dense" and num_clients is not None and lead != K \
            and not (mesh is not None and lead * mesh.n_client_shards == K):
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
    K_l = K // n_blocks
    return AsyncFedState(
        client_params=snap,
        version=np.zeros((K_l,), np.int32),
        server_version=0,
        finish_time=(delays.draw(seed, 0, (K,)) if n_blocks == 1 else
                     delays.sample_sharded(seed, 0, K, n_blocks,
                                           mesh.client_index)),
        now=np.float32(0.0),
        seed=int(seed),
        agg_state=aggregator.init(K, device) if aggregator is not None
        else (),
        server_opt=(server_optimizer.init(server_params)
                    if server_optimizer is not None else ()),
        ring=ring,
        ring_versions=ring_versions,
        retries=np.zeros((K_l,), np.int32),
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
    else:
        raise ValueError(f"unknown arrival method {method!r}; expected "
                         "'sort' or 'topk' (sharded_arrival_cohort pops "
                         "'topk:sharded')")
    idx = idx.astype(np.int64)
    mask = np.zeros(finish_time.shape[0], np.float32)
    mask[idx] = 1.0
    return idx, mask, finish_time[idx].max()


def _pop_sharded(finish_time, cohort: int, version, mesh):
    """:func:`sharded_arrival_cohort`, plus the arrivals' versions and
    finish times (the merge has them)."""
    n = mesh.n_client_shards
    finish_time = np.asarray(finish_time, np.float32)
    version = np.asarray(version, np.int32)
    K_l = finish_time.shape[0]
    if cohort > K_l * n:
        raise ValueError(f"cohort {cohort} exceeds the {K_l * n} client "
                         "slots")
    base = mesh.client_index * K_l
    local = _pop_topk(finish_time, version, min(cohort, K_l))
    # the candidate triples, exact in float64 (f32 times, i32 versions,
    # slot ids far below 2^53), gathered in shard order in ONE collective
    cand = np.stack([finish_time[local].astype(np.float64),
                     version[local].astype(np.float64),
                     (local + base).astype(np.float64)], 1)
    cand = mesh.all_gather_host(cand, "client")
    ft_c, v_c, g_c = cand[:, 0], cand[:, 1], cand[:, 2]
    order = np.lexsort((g_c, v_c, ft_c))[:cohort]
    sel = order[np.argsort(g_c[order], kind="stable")]
    idx = g_c[sel].astype(np.int64)
    loc = idx - base
    mask = np.zeros((K_l,), np.float32)
    mask[loc[(loc >= 0) & (loc < K_l)]] = 1.0
    return (idx, mask, np.float32(ft_c[order].max()),
            v_c[sel].astype(np.int32), ft_c[sel].astype(np.float32))


def sharded_arrival_cohort(finish_time, cohort: int, version, *, mesh):
    """The pop with the (K,) schedule scalars split over the client
    shards of ``mesh``: ``finish_time`` / ``version`` are this rank's
    block (:func:`init_async_state` with ``mesh=``). Bitwise the single
    pop, ties included.

    Each shard pops its local top ``min(cohort, K / S)`` under the same
    composite (finish_time, version, slot) order (:func:`_pop_topk`):
    the global top-``cohort`` lies in their union, since a globally
    selected slot has fewer than ``cohort`` predecessors globally, hence
    fewer in its own shard. ONE all_gather of the ``S x min(cohort, K /
    S)`` candidate triples and one small lexsort (slot id the last key:
    a total order) merge them. Every rank of a client group gets the
    same answer.

    Returns (idx (cohort,) global slot ids ascending, the same on every
    rank; mask (K / S,) float32, this rank's block; t_event)."""
    return _pop_sharded(finish_time, cohort, version, mesh)[:3]


def make_arrival_pop(cohort: int, arrival: str = "sort", *, mesh=None):
    """The configured pop as ``pop(finish_time, version) -> (idx, mask,
    t_event)``; ``"topk:sharded"`` needs ``mesh`` (the client shards the
    schedule splits over) and takes this rank's block."""
    if arrival not in ARRIVALS:
        raise ValueError(f"unknown arrival {arrival!r}; expected {ARRIVALS}")
    if arrival == "topk:sharded":
        if mesh is None:
            raise ValueError("arrival='topk:sharded' needs mesh= (the "
                             "client axes the schedule scalars shard over)")
        return lambda ft, v: sharded_arrival_cohort(ft, cohort, v,
                                                    mesh=mesh)
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
                      faults=None, guards=None, mesh=None,
                      batch_specs=None):
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
    * ``arrival``: the pop, ``"sort"``, ``"topk"`` or ``"topk:sharded"``
      (with ``mesh``: ``afed``'s schedule holds this rank's block, see
      :func:`init_async_state`; the event runs whole on every rank, and
      ``arrival_mask`` / ``staleness`` are the rank's blocks).
    * ``mesh`` / ``batch_specs``: ``backend="lace_dp"`` runs the event
      per rank (:func:`_make_async_runner_dp`).
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
            "(its pop and FL phase run per client shard); use a "
            "single-program backend")
    if robust and paged_opt:
        raise ValueError(
            "deadline/faults/guards are not supported with host-paged "
            "optimizer moments (the pager's arrival prediction does not "
            "model partial cohorts)")
    sharded = arrival == "topk:sharded"
    if sharded and backend != "lace_dp" and mesh is None:
        raise ValueError("arrival='topk:sharded' needs mesh= (the client "
                         "axes the schedule scalars shard over)")
    delta = snapshots == "delta"
    opt = optimizer if optimizer is not None else optimizers.sgd()
    agg = aggregator if aggregator is not None else _agg.weighted()
    sched = _resolve_schedule(schedule, scala, lr_scale, cohort, num_clients)
    if backend == "lace_dp":
        if mesh is None or batch_specs is None:
            raise ValueError("backend 'lace_dp' needs mesh= and "
                             "batch_specs=")
        if sharded:
            raise ValueError(
                "arrival 'topk:sharded' is redundant under backend "
                "'lace_dp': the event already pops per client shard; use "
                "arrival 'topk' (applied per shard)")
        if paged_opt:
            raise ValueError("paged_opt is not supported on the lace_dp "
                             "event (it pops per shard inside the event)")
        return _make_async_runner_dp(
            model, scala, boundary=boundary, delays=delays, cohort=cohort,
            opt=opt, sched=sched, ce_chunk=ce_chunk,
            staleness_decay=staleness_decay, mix_rate=mix_rate, agg=agg,
            server_optimizer=server_optimizer, server_lr=server_lr,
            opt_state_policy=opt_state_policy, precision=precision,
            delta=delta, ring_size=ring_size,
            emit_client_metrics=emit_client_metrics, arrival=arrival,
            mesh=mesh, batch_specs=batch_specs, donate=donate)
    n_blocks = mesh.n_client_shards if sharded else 1
    pop = (functools.partial(_pop_sharded, cohort=cohort, mesh=mesh)
           if sharded else make_arrival_pop(cohort, arrival))
    step = engine.make_split_step(model, scala, backend=backend,
                                  boundary=boundary, optimizer=opt,
                                  schedule=sched, ce_chunk=ce_chunk,
                                  precision=precision)
    decay_base = np.float32(staleness_decay)
    mu = float(mix_rate)

    def async_fn(state: engine.TrainState, afed: AsyncFedState,
                 round_batches, data_sizes=None, cohort_opt=None):
        # K: every slot; the schedule arrays hold K / n_blocks of them
        K = afed.version.shape[0] * n_blocks
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

        # --- the pop, on the host: who arrives, and when; the arrivals'
        # versions and finish times, and which of them this rank's
        # schedule block holds (pos_l: their places in idx, loc: rows) ---
        if sharded:
            idx, _, t_event, v_idx, ft_idx = pop(afed.finish_time,
                                                 version=afed.version)
            arrival_mask = np.zeros((K,), np.float32)
            arrival_mask[idx] = 1.0
            loc = idx - mesh.client_index * afed.version.shape[0]
            pos_l = np.flatnonzero((loc >= 0)
                                   & (loc < afed.version.shape[0]))
            loc = loc[pos_l]
        else:
            idx, arrival_mask, t_event = pop(afed.finish_time, afed.version)
            v_idx, ft_idx = afed.version[idx], afed.finish_time[idx]
            pos_l, loc = np.arange(len(idx)), idx
        present = None
        if deadline is not None:
            # the cohort barrier degrades gracefully: arrivals past
            # first finish + deadline miss the event and back off
            t_event = np.minimum(t_event, ft_idx.min() + np.float32(deadline))
            present = (ft_idx <= t_event).astype(np.float32)
            arrival_mask = np.zeros((K,), np.float32)
            arrival_mask[idx] = present
        staleness = (np.int32(afed.server_version)
                     - afed.version).astype(np.float32)
        stale_k = staleness
        if sharded:
            stale_k = np.zeros((K,), np.float32)
            stale_k[idx] = np.int32(afed.server_version) - v_idx
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
        decay = torch.from_numpy(np.power(decay_base, stale_k)).to(device)
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
        wrote = np.ones(len(idx), bool) if present is None else present > 0
        if present is not None:
            retries_sub = np.zeros(len(idx), np.int32)
            retries_sub[pos_l] = afed.retries[loc]
            if sharded:       # every arrival's count, from its shard
                retries_sub = mesh.all_reduce_host(
                    retries_sub, "client").astype(np.int32)
            boff = np.power(np.float32(backoff),
                            retries_sub.astype(np.float32))
            eff_delays = np.where(present > 0, eff_delays, new_delays * boff)
            retries[loc] = np.where(present > 0, 0, retries_sub + 1)[pos_l]
        version[loc[wrote[pos_l]]] = new_version
        finish_time = afed.finish_time.copy()
        finish_time[loc] = (t_event + eff_delays)[pos_l]
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
            blk = mesh.client_slice(K) if sharded else slice(None)
            metrics.update(
                arrival_mask=arrival_mask[blk], staleness=staleness,
                staleness_mean=np.float32(
                    (stale_k * arrival_mask).sum()
                    / max(arrival_mask.sum(), np.float32(1.0))))
        else:
            metrics.update(staleness_mean=np.float32(stale_k[idx].mean()))
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


# ---------------------------------------------------------------------------
# the lace_dp event: the whole event per rank
# ---------------------------------------------------------------------------


def _make_async_runner_dp(model, scala, *, boundary, delays, cohort, opt,
                          sched, ce_chunk, staleness_decay, mix_rate, agg,
                          server_optimizer, server_lr, opt_state_policy,
                          precision, delta, ring_size, emit_client_metrics,
                          arrival, mesh, batch_specs, donate):
    """The event of :func:`make_async_runner` on backend ``lace_dp``: the
    same ``async_fn(state, afed, round_batches, data_sizes=None)``, run by
    every rank of ``mesh`` on its client shard (the reference's
    ``shard_map``-ed event).

    ``state`` holds the rank's client rows (one slot under delta) and the
    replicated server half; ``afed`` the rank's snapshots and schedule
    block (:func:`init_async_state` with ``mesh=``), the ring replicated;
    ``round_batches`` (T, K, ...) and ``data_sizes`` (K,) are global.
    Each client shard pops ``cohort / n_shards`` of its own finishers
    (the balanced two-tier schedule; the clock is the latest of the
    shards' cohorts, one max over ``client``), trains them through the
    ``lace_dp`` step, weighs them with the aggregator's ``shard_local``
    and ``staleness_decay ** age`` (normalized by one sum over the
    shards) and folds the cohort average in with one more sum over the
    shards. The re-dispatch delays are the rank's block of the
    single-program event's ``(cohort,)`` draw
    (:meth:`DelayModel.sample_sharded`)."""
    from repro_torch.sharding import round_specs

    grid = mesh
    n_shards = grid.n_client_shards
    if cohort % n_shards:
        raise ValueError(f"cohort {cohort} must divide over the {n_shards} "
                         "client shards (per-shard balanced pop)")
    if agg.shard_local is None:
        raise ValueError(
            f"aggregator {agg.name!r} is not shard-decomposable "
            "(Aggregator.shard_local is None); the lace_dp event needs "
            "fedavg / weighted / hierarchical")
    if agg.stateful:
        raise ValueError(f"aggregator {agg.name!r} is stateful; the lace_dp "
                         "async event supports stateless aggregators only")
    if opt_state_policy == "average":
        raise ValueError("opt_state_policy 'average' is not supported on "
                         "the lace_dp async event; use 'carry' or 'reset'")
    cohort_l = cohort // n_shards
    rb_specs = round_specs(batch_specs)
    engine._check("lace_dp", boundary, precision, model, grid)
    step = engine._local_step_fn(model, scala, "lace_dp", boundary, opt,
                                 sched, ce_chunk, precision, grid)
    decay_base = np.float32(staleness_decay)
    mu = float(mix_rate)

    def reduce(t):
        return grid.all_reduce(t.reshape(-1).clone(), "client")

    def async_fn(state: engine.TrainState, afed: AsyncFedState,
                 round_batches, data_sizes=None):
        K_l = afed.version.shape[0]
        K = K_l * n_shards
        if delta and opt_state_policy == "carry" \
                and leaves(state.opt_state["client"]):
            raise ValueError(
                "snapshots='delta' cannot carry per-client optimizer "
                "moments; use a stateless optimizer or "
                "opt_state_policy='reset'")
        if leaves(round_batches)[0].shape[1] != K:
            raise ValueError("the lace_dp async event needs full (T, K, ...)"
                             " round_batches (cut over the client shards)")
        device = leaves(state.params["server"])[0].device
        cs = grid.client_slice(K)
        sizes = (torch.ones(K, dtype=torch.float32) if data_sizes is None
                 else data_sizes)
        sizes_l = sizes[cs].to(device).float()
        rb = engine.shard_batch(grid, round_batches, rb_specs)

        # --- the shard's pop of its local cohort; the clock is the
        # latest of the shards' cohorts ---
        idx, a_mask_l, t_l = arrival_cohort(afed.finish_time, cohort_l,
                                            afed.version, method=arrival)
        t_event = np.float32(grid.all_reduce_host(
            np.array([t_l], np.float32), "client", "max")[0])
        stal_l = (np.int32(afed.server_version)
                  - afed.version).astype(np.float32)
        idx_t = torch.from_numpy(idx).to(device)

        # --- the local arrivals' snapshots ---
        if delta:
            snap_c, _ = ring_lookup(afed.ring, afed.version[idx],
                                    afed.server_version, ring_size)
            opt_sub = engine._client_opt_init(opt, snap_c)
        else:
            snap_c = engine.gather_rows(afed.client_params, idx_t)
            opt_sub = engine.gather_rows(state.opt_state["client"], idx_t)
        sub = engine.TrainState(
            params={"client": snap_c, "server": state.params["server"]},
            opt_state={"client": opt_sub,
                       "server": state.opt_state["server"]},
            step=state.step)
        metrics = {}
        for t in range(leaves(rb)[0].shape[0]):
            sub, metrics = step(sub, {k: v[t].index_select(0, idx_t)
                                      for k, v in rb.items()}, None,
                                donate=t > 0)

        # --- two-tier delayed aggregation: each shard (edge) folds its
        # cohort, one sum over the shards folds the edges ---
        m_l = torch.from_numpy(a_mask_l).to(device)
        w_base_l = agg.shard_local(m_l, sizes_l, lambda t: reduce(t)[0],
                                   n_shards)
        decay_l = torch.from_numpy(np.power(decay_base, stal_l)).to(device)
        raw_l = w_base_l * decay_l * m_l
        r_l = raw_l / torch.clamp(reduce(raw_l.sum())[0], min=1e-8)
        cohort_avg = engine._shard_mean(grid, sub.params["client"],
                                        r_l.index_select(0, idx_t))
        new_global = tree_map(
            lambda g, c: ((1.0 - mu) * engine.at_least_f32(g[0])
                          + mu * engine.at_least_f32(c)).to(g.dtype),
            state.params["client"], cohort_avg)

        # --- the server half (replicated: the same on every rank) ---
        new_ws = sub.params["server"]
        so_state = afed.server_opt
        if server_optimizer is not None:
            ws_delta = tree_map(
                lambda a, b: engine.at_least_f32(a) - engine.at_least_f32(b),
                state.params["server"], new_ws)
            new_ws, so_state = server_optimizer.update(
                ws_delta, so_state, state.params["server"], server_lr)

        # --- the local slots' moments and re-dispatch ---
        new_version = afed.server_version + 1
        new_delays = delays.sample_sharded(afed.seed, new_version, cohort,
                                           n_shards, grid.client_index)
        if delta:
            new_client = stack_client_params(new_global, 1)
            opt_c = engine._client_opt_init(opt, new_client)
            slot = new_version % ring_size
            snap = afed.client_params
            ring = _write_rows(afed.ring, tree_map(lambda g: g[None],
                                                   new_global),
                               torch.tensor([slot], device=device), donate)
            ring_versions = afed.ring_versions.copy()
            ring_versions[slot] = new_version
        else:
            sub_opt_c = sub.opt_state["client"]
            if opt_state_policy == "reset":
                sub_opt_c = engine._client_opt_init(opt,
                                                    sub.params["client"])
            opt_c = _write_rows(state.opt_state["client"], sub_opt_c, idx_t,
                                donate)
            new_client = stack_client_params(new_global, K_l)
            snap = _write_rows(afed.client_params, tree_map(
                lambda g: g[None].expand((cohort_l,) + g.shape),
                new_global), idx_t, donate)
            ring, ring_versions = afed.ring, afed.ring_versions
        version = afed.version.copy()
        version[idx] = new_version
        finish_time = afed.finish_time.copy()
        finish_time[idx] = t_event + new_delays
        new_afed = AsyncFedState(
            client_params=snap, version=version, server_version=new_version,
            finish_time=finish_time, now=t_event, seed=afed.seed,
            agg_state=afed.agg_state, server_opt=so_state, ring=ring,
            ring_versions=ring_versions, retries=afed.retries,
            guard=afed.guard)
        new_state = engine.TrainState(
            params={"client": new_client, "server": new_ws},
            opt_state={"client": opt_c, "server": sub.opt_state["server"]},
            step=sub.step)
        s_sum, s_cnt = grid.all_reduce_host(np.array(
            [(stal_l * a_mask_l).sum(), a_mask_l.sum()], np.float32),
            "client")
        metrics = dict(metrics)
        if emit_client_metrics:
            metrics.update(arrival_mask=a_mask_l, staleness=stal_l)
        metrics.update(staleness_mean=np.float32(s_sum / max(s_cnt, 1.0)),
                       t_event=t_event, server_version=new_version)
        return new_state, new_afed, metrics

    return async_fn
