"""The declarative experiment spec tree, the JSON schema of
``repro.api.specs`` field for field.

One experiment is one frozen :class:`ExperimentSpec`: the model (by
registry name), the SCALA protocol (:class:`ScalaConfig`), the local
optimizer (:class:`OptimSpec`), the federation layer (:class:`FedSpec`),
the execution mode (:class:`ExecutionSpec`) and the data
(:class:`DataSpec`). It round-trips through JSON, so the reference
CLI's ``--dump-config`` output runs verbatim here.

:meth:`ExperimentSpec.validate` accepts what the port runs -- SCALA on a
text arch (``lm_synthetic``, backends ``lace`` or ``logits``) or on the
CNN family (``image_synthetic``, backend ``logits``) in the synchronous
modes ``subset`` (host-side sampling), ``masked`` and ``sparse`` (an
in-program participation scheduler over all K slots) and the ``async``
event runtime (delays, arrival cohorts, dense or delta snapshots,
host-paged moments, deadlines), fault injection and guarded aggregation
in the ``masked``, ``sparse`` and ``async`` modes, both boundaries, both
compute policies (``precision`` f32 or bf16), any ``rounds_per_call``,
donation, every aggregator, server-side FedOpt, and the FL / SFL
baselines on the CNN family in ``subset`` mode, the multi-device
backend ``lace_dp`` (full, masked, sparse with the in-shard gather, async)
and ``arrival="topk:sharded"`` on a grid of ranks
(``build(spec, mesh=, batch_specs=)``), with faults and guards wherever
the reference takes them -- and raises ``ValueError`` for every
combination the reference rejects (an unknown precision,
``rounds_per_call < 1``, host paging with ``rounds_per_call > 1``, a
non-decomposable aggregator on ``lace_dp`` sparse / async, ...).
``unroll`` has nothing to act on in an eager program: a fused chunk is
its rounds one after another, whatever it says. ``donate`` gives up
the state passed to ``step``: the synchronous round overwrites it from
its first local step on, and the async event writes its cohort's rows
into its own stacks (:mod:`repro_torch.api.build`).
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

from repro_torch.configs import ScalaConfig, get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core.baselines import FL_METHODS, SFL_METHODS
from repro_torch.core.engine import (BACKENDS, BOUNDARIES,
                                     OPT_STATE_POLICIES, PRECISIONS)
from repro_torch.fed.runtime import ARRIVALS, LR_SCALES, SNAPSHOT_MODES

EXECUTION_MODES = ("subset", "masked", "sparse", "async")
OPTIMIZERS = ("sgd", "momentum", "adamw")
OPTIMIZER_ALIASES = {"fedavgm": "momentum", "fedadam": "adamw"}

SCALA_METHODS = ("scala", "scala_noadj")
METHODS = SCALA_METHODS + FL_METHODS + SFL_METHODS


def _one_of(kind: str, value, allowed) -> None:
    if value not in allowed:
        raise ValueError(f"unknown {kind} {value!r}; expected {allowed}")


@dataclass(frozen=True)
class OptimSpec:
    """A local optimizer and lr schedule. ``lr=None`` defers to
    ``scala.lr``."""

    name: str = "sgd"
    lr: Optional[float] = None
    momentum: float = 0.9
    weight_decay: float = 0.0
    schedule: str = "constant"         # constant | cosine
    warmup: int = 0

    def __post_init__(self):
        _one_of("optimizer", self.name, OPTIMIZERS)
        _one_of("schedule", self.schedule, ("constant", "cosine"))

    @classmethod
    def parse(cls, spec: str, *, default_lr: Optional[float] = None,
              **overrides) -> "OptimSpec":
        """``"sgd[:LR]"`` | ``"momentum[:LR[:BETA]]"`` |
        ``"adamw[:LR[:WD]]"``, plus the FedOpt aliases ``fedavgm`` /
        ``fedadam`` (momentum / adamw); ``default_lr`` when no LR."""
        usage = "NAME[:LR[:ARG]] with NAME in " + repr(
            OPTIMIZERS + tuple(sorted(OPTIMIZER_ALIASES)))
        bad = ValueError(f"bad optimizer spec {spec!r}; usage: {usage}")
        parts = spec.split(":")
        name = OPTIMIZER_ALIASES.get(parts[0], parts[0])
        if name not in OPTIMIZERS or len(parts) > 3 or (
                len(parts) == 3 and name == "sgd"):
            raise bad
        kw: Dict[str, Any] = dict(name=name, lr=default_lr)
        try:
            if len(parts) >= 2:
                kw["lr"] = float(parts[1])
            if len(parts) == 3:
                kw["momentum" if name == "momentum" else "weight_decay"] = \
                    float(parts[2])
        except ValueError:
            raise bad from None
        kw.update(overrides)
        return cls(**kw)

    @property
    def spec(self) -> str:
        """The canonical compact string (the schedule fields left out; an
        unset lr renders as the bare name)."""
        if self.lr is None:
            return self.name
        if self.name == "momentum":
            return f"momentum:{self.lr}:{self.momentum}"
        if self.name == "adamw":
            return f"adamw:{self.lr}:{self.weight_decay}"
        return f"sgd:{self.lr}"

    def resolve_lr(self, default_lr: float) -> float:
        """The effective base lr (``scala.lr`` unless overridden here)."""
        return default_lr if self.lr is None else self.lr

    def make(self):
        from repro_torch.optim import make_optimizer

        return make_optimizer(self.name, momentum=self.momentum,
                              weight_decay=self.weight_decay)

    def make_schedule(self, total_steps: int, *,
                      default_lr: Optional[float] = None):
        from repro_torch.optim import schedules

        lr = self.lr if self.lr is not None else default_lr
        if lr is None:
            raise ValueError("OptimSpec.lr is unset and no default_lr "
                             "(scala.lr) was provided")
        if self.schedule == "cosine":
            return schedules.linear_warmup_cosine(lr, self.warmup,
                                                  total_steps)
        return schedules.constant(lr)


@dataclass(frozen=True)
class FedSpec:
    """Aggregation, participation and the client opt-state policy, plus
    the fault-tolerance specs (compact strings, as in the reference)."""

    aggregator: str = "weighted"
    participation: Optional[str] = None
    opt_state_policy: str = "carry"
    faults: Optional[str] = None
    guards: Optional[str] = None

    def __post_init__(self):
        self.make_aggregator()                       # structural validation
        if self.participation is not None:
            self.make_participation(2)               # structural validation
        _one_of("opt_state_policy", self.opt_state_policy,
                OPT_STATE_POLICIES)
        self.make_faults()                           # structural validation
        self.make_guards()                           # structural validation

    def make_aggregator(self):
        from repro_torch.fed import make_aggregator

        return make_aggregator(self.aggregator)

    def make_participation(self, num_clients: int):
        """The scheduler over ``num_clients`` slots, or None."""
        from repro_torch.fed import make_participation

        if self.participation is None:
            return None
        return make_participation(self.participation, num_clients)

    def make_faults(self):
        """The :class:`repro_torch.fed.FaultModel`, or None."""
        from repro_torch.fed import make_faults

        if self.faults is None:
            return None
        return make_faults(self.faults)

    def make_guards(self):
        """The :class:`repro_torch.fed.GuardPolicy`, or None."""
        from repro_torch.fed import make_guards

        if self.guards is None:
            return None
        return make_guards(self.guards)


@dataclass(frozen=True)
class ExecutionSpec:
    """How the round program runs (see ``repro.api.specs.ExecutionSpec``
    for every field's meaning)."""

    mode: str = "masked"
    backend: str = "logits"
    boundary: str = "fused"
    delay: str = "lognormal:1:1"
    cohort: int = 0
    staleness_decay: float = 0.5
    mix_rate: float = 1.0
    server_optimizer: Optional[OptimSpec] = None
    unroll: int = -1
    precision: str = "f32"
    rounds_per_call: int = 1
    donate: bool = True
    snapshots: str = "dense"
    ring_size: int = 64
    lr_scale: str = "none"
    arrival: str = "sort"
    opt_paging: str = "none"
    deadline: Optional[float] = None
    backoff: float = 2.0

    def __post_init__(self):
        _one_of("execution mode", self.mode, EXECUTION_MODES)
        _one_of("backend", self.backend, BACKENDS)
        _one_of("boundary", self.boundary, BOUNDARIES)
        _one_of("precision", self.precision, PRECISIONS)
        _one_of("snapshots mode", self.snapshots, SNAPSHOT_MODES)
        _one_of("lr_scale", self.lr_scale, LR_SCALES)
        _one_of("arrival", self.arrival, ARRIVALS)
        _one_of("opt_paging", self.opt_paging, ("none", "host"))
        if self.rounds_per_call < 1:
            raise ValueError(f"rounds_per_call must be >= 1, got "
                             f"{self.rounds_per_call}")
        self.make_delays()                           # structural validation
        if self.cohort < 0:
            raise ValueError(f"cohort must be >= 0, got {self.cohort}")
        if self.ring_size < 1:
            raise ValueError(f"ring_size must be >= 1, got {self.ring_size}")
        if self.deadline is not None and self.deadline <= 0:
            raise ValueError(f"deadline must be > 0, got {self.deadline}")
        if self.backoff < 1.0:
            raise ValueError(f"backoff must be >= 1, got {self.backoff}")

    @property
    def in_program(self) -> bool:
        return self.mode in ("masked", "sparse", "async")

    def make_delays(self):
        from repro_torch.fed.delays import make_delays

        return make_delays(self.delay)

    def resolve_cohort(self, num_clients: int) -> int:
        """The arrivals per event: ``cohort``, or a quarter of the
        clients (at least 1) when it is 0."""
        return self.cohort if self.cohort > 0 else max(1, num_clients // 4)


@dataclass(frozen=True)
class DataSpec:
    """``lm_synthetic``: domain-skewed synthetic token documents of
    length ``seq`` + 1 (the LM training CLI's data). ``image_synthetic``:
    CIFAR-shaped gaussian class images, ``n_train`` + ``n_test`` of
    ``num_classes`` classes, the training set label-skew partitioned over
    the clients by ``alpha`` (classes per client) or ``beta`` (Dirichlet
    concentration) -- the CNN family's data."""

    kind: str = "lm_synthetic"
    seq: int = 128
    docs_per_client: int = 32
    n_train: int = 2000
    n_test: int = 1000
    num_classes: int = 10
    alpha: Optional[int] = None
    beta: Optional[float] = None

    def __post_init__(self):
        _one_of("data kind", self.kind, ("lm_synthetic", "image_synthetic"))


@dataclass(frozen=True)
class ExperimentSpec:
    """The whole experiment, declaratively (the reference's fields)."""

    arch: str = "qwen1.5-0.5b"
    reduced: bool = False
    split: str = "s2"
    width: float = 0.125
    method: str = "scala"
    rounds: int = 20
    seed: int = 0
    scala: ScalaConfig = field(default_factory=ScalaConfig)
    optim: OptimSpec = field(default_factory=OptimSpec)
    fed: FedSpec = field(default_factory=FedSpec)
    execution: ExecutionSpec = field(default_factory=ExecutionSpec)
    data: DataSpec = field(default_factory=DataSpec)

    def model_config(self) -> ModelConfig:
        cfg = get_config(self.arch)
        return cfg.reduced() if self.reduced else cfg

    @property
    def num_clients(self) -> int:
        return self.scala.num_clients

    @property
    def slots(self) -> int:
        """The stacked client-slot count of a round."""
        if self.execution.in_program:
            return self.scala.num_clients
        return self.scala.clients_per_round

    def validate(self) -> "ExperimentSpec":
        """Reject what the reference rejects (ValueError). Returns
        self."""
        ex, fd = self.execution, self.fed
        cfg = self.model_config()
        _one_of("method", self.method, METHODS)
        agg = fd.make_aggregator()
        # --- backend coherence (the reference's rules) ---
        if ex.backend == "lace_dp" and ex.mode in ("sparse", "async"):
            # the in-shard sparse round and the per-shard event fold the
            # aggregation per client shard (a local edge fold + a sum),
            # which rules out stateful / prior-dependent aggregators and
            # the cross-slot "average" policy; the grid-dependent
            # divisibility is checked at build time
            if agg.shard_local is None or agg.stateful or agg.needs_priors:
                raise ValueError(
                    f"backend 'lace_dp' with mode {ex.mode!r} needs a "
                    "stateless, prior-free, shard-decomposable aggregator "
                    "(fedavg / weighted / hierarchical); got "
                    f"{agg.name!r}")
            if fd.opt_state_policy == "average":
                raise ValueError(
                    "backend 'lace_dp' with mode 'sparse'/'async' does not "
                    "support opt_state_policy 'average'; use 'carry' or "
                    "'reset'")
        if ex.backend != "logits" and cfg.family == "cnn":
            raise ValueError(
                f"backend {ex.backend!r} needs a trunk/head split; the CNN "
                "(AlexNet) family only supports backend 'logits'")
        # --- participation / mode coherence ---
        if ex.mode == "sparse" and fd.participation is None:
            raise ValueError(
                "mode 'sparse' needs a participation spec (the static "
                "K_active comes from the scheduler's subset_size); set "
                "fed.participation to 'uniform:FRAC' or "
                "'dirichlet:FRAC[:ALPHA]'")
        if ex.mode == "async" and fd.participation is not None:
            raise ValueError(
                "mode 'async' replaces participation scheduling (the "
                "arrival cohort IS the participating subset); drop "
                "fed.participation")
        if ex.mode == "subset" and fd.participation is not None:
            raise ValueError(
                "mode 'subset' samples clients host-side; a participation "
                "spec needs an in-program mode ('masked' or 'sparse')")
        # --- stateful aggregators need stable client identities ---
        if agg.stateful:
            if ex.mode == "async":
                raise ValueError(
                    f"aggregator {agg.name!r} double-decays under mode "
                    "'async' (the runtime applies staleness_decay itself); "
                    "use a stateless aggregator")
            if ex.mode == "subset" or fd.participation is None:
                raise ValueError(
                    f"aggregator {agg.name!r} is stateful and needs stable "
                    "client identities: use mode 'masked'/'sparse' with a "
                    "participation spec (host-side subset re-stacking has "
                    "no slot -> client correspondence)")
        # --- the async knobs ---
        if ex.mode == "async" and ex.cohort > self.scala.num_clients:
            raise ValueError(f"cohort {ex.cohort} exceeds the "
                             f"{self.scala.num_clients} client slots")
        if ex.snapshots == "delta":
            if ex.mode != "async":
                raise ValueError(
                    "snapshots='delta' is an async-runtime storage layout; "
                    f"mode {ex.mode!r} has no per-client snapshots")
            if fd.opt_state_policy == "average":
                raise ValueError(
                    "snapshots='delta' stores no per-client optimizer "
                    "state to average; use opt_state_policy 'reset' (or "
                    "'carry' with a stateless optimizer)")
            if fd.opt_state_policy == "carry" and self.optim.name != "sgd" \
                    and ex.opt_paging != "host":
                raise ValueError(
                    f"snapshots='delta' cannot carry {self.optim.name!r} "
                    "per-client moments (no per-client state is stored); "
                    "use optim 'sgd', fed.opt_state_policy='reset', or "
                    "execution.opt_paging='host' (host-paged moment store)")
        if ex.lr_scale != "none" and ex.mode != "async":
            raise ValueError("lr_scale applies to mode 'async' only (the "
                             "cohort/K factor is an event-schedule knob)")
        if ex.arrival != "sort" and ex.mode != "async":
            raise ValueError(
                f"arrival {ex.arrival!r} applies to mode 'async' only (the "
                "cohort pop is an event-schedule op); mode "
                f"{ex.mode!r} has no arrival schedule")
        if ex.arrival == "topk:sharded" and ex.backend == "lace_dp":
            raise ValueError(
                "arrival 'topk:sharded' is redundant under backend "
                "'lace_dp': the shard_map event already pops per client "
                "shard; use arrival 'topk' (applied per shard)")
        if ex.opt_paging == "host":
            if ex.mode != "async":
                raise ValueError(
                    "opt_paging='host' pages the async runtime's per-client "
                    f"moments; mode {ex.mode!r} has none")
            if ex.snapshots != "delta" or fd.opt_state_policy != "carry":
                raise ValueError(
                    "opt_paging='host' exists to carry per-client moments "
                    "outside the delta snapshot state; it requires "
                    "snapshots='delta' and fed.opt_state_policy='carry' "
                    f"(got snapshots={ex.snapshots!r}, "
                    f"opt_state_policy={fd.opt_state_policy!r})")
            if ex.rounds_per_call != 1:
                raise ValueError(
                    "opt_paging='host' steps one event per host "
                    "pop/gather/scatter round-trip; rounds_per_call must "
                    f"be 1, got {ex.rounds_per_call}")
            if ex.backend == "lace_dp":
                raise ValueError(
                    "opt_paging='host' predicts the arrival pop outside the "
                    "compiled event; backend 'lace_dp' pops per shard "
                    "inside its shard_map and is not supported")
        robust = fd.faults is not None or fd.guards is not None
        if ex.deadline is not None and ex.mode != "async":
            raise ValueError(
                "deadline bounds the async cohort barrier; mode "
                f"{ex.mode!r} has no arrival schedule")
        if robust and ex.mode == "subset":
            raise ValueError(
                "faults/guards are in-program federation features; mode "
                "'subset' re-stacks clients host-side — use 'masked', "
                "'sparse', or 'async'")
        if robust or ex.deadline is not None:
            if ex.backend == "lace_dp" and ex.mode in ("sparse", "async"):
                raise ValueError(
                    "faults/guards/deadline are not supported on the "
                    "in-shard lace_dp sparse/async programs (their FL "
                    "phase runs inside shard_map); use backend "
                    "'logits'/'lace', or lace_dp with mode 'masked'")
            if ex.opt_paging == "host":
                raise ValueError(
                    "faults/guards/deadline are not supported with "
                    "opt_paging='host' (the pager's arrival prediction "
                    "does not model partial cohorts)")
        # --- baselines ---
        if self.method not in SCALA_METHODS:
            if ex.mode != "subset":
                raise ValueError(
                    f"method {self.method!r} (a baseline) only supports "
                    "mode 'subset' (host-side sampling); the in-program "
                    "modes are SCALA engine programs")
            if cfg.family != "cnn":
                raise ValueError(
                    f"method {self.method!r} needs the CNN (AlexNet) "
                    f"family; arch {self.arch!r} is {cfg.family!r}")
            if self.method in SFL_METHODS and ex.server_optimizer is not None:
                raise ValueError(
                    "server_optimizer (FedOpt) is not supported by the SFL "
                    "baselines; use an FL method or SCALA")
        if ex.server_optimizer is not None and ex.server_optimizer.lr is None:
            raise ValueError(
                "execution.server_optimizer needs its lr (the server lr: "
                "OptimSpec.parse(spec, default_lr=...))")
        # --- data / model coherence (the reference's rules) ---
        if self.data.kind == "image_synthetic" and cfg.family != "cnn":
            raise ValueError(
                f"data kind 'image_synthetic' needs the CNN family; arch "
                f"{self.arch!r} is {cfg.family!r}")
        if self.data.kind == "lm_synthetic" and (cfg.family == "cnn"
                                                 or cfg.frontend is not None):
            raise ValueError(
                f"data kind 'lm_synthetic' needs a text arch; "
                f"{self.arch!r} has family {cfg.family!r} / frontend "
                f"{cfg.frontend!r}")
        if self.data.kind == "image_synthetic" \
                and self.data.alpha is not None and self.data.beta is not None:
            raise ValueError("set at most one of data.alpha (quantity skew) "
                             "and data.beta (Dirichlet skew)")
        return self

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def to_json(self, **kw) -> str:
        kw.setdefault("indent", 2)
        return json.dumps(self.to_dict(), **kw)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ExperimentSpec":
        d = dict(d)
        if isinstance(d.get("scala"), dict):
            d["scala"] = ScalaConfig(**d["scala"])
        if isinstance(d.get("optim"), dict):
            d["optim"] = OptimSpec(**d["optim"])
        if isinstance(d.get("fed"), dict):
            d["fed"] = FedSpec(**d["fed"])
        if isinstance(d.get("execution"), dict):
            ex = dict(d["execution"])
            if isinstance(ex.get("server_optimizer"), dict):
                ex["server_optimizer"] = OptimSpec(**ex["server_optimizer"])
            d["execution"] = ExecutionSpec(**ex)
        if isinstance(d.get("data"), dict):
            d["data"] = DataSpec(**d["data"])
        return cls(**d)

    @classmethod
    def from_json(cls, s: str) -> "ExperimentSpec":
        return cls.from_dict(json.loads(s))
