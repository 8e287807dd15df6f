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
CNN family (``image_synthetic``, backend ``logits``), the host-side
``subset`` mode, both boundaries (``fused``, ``dual``), f32 policy, one
round per call, the ``fedavg`` / ``weighted`` aggregators, and the FL /
SFL baselines on the CNN family in ``subset`` mode -- and raises
``NotImplementedError`` naming the missing piece for the rest (masked /
sparse / async, ``lace_dp``, faults and guards, server-side FedOpt,
``precision="bf16"``, ``rounds_per_call > 1`` and training the xLSTM
family), and ``ValueError`` for combinations the reference rejects too. ``unroll`` and ``donate`` are accepted and have
nothing to act on in an eager program.
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

EXECUTION_MODES = ("subset", "masked", "sparse", "async")
OPTIMIZERS = ("sgd", "momentum", "adamw")
OPTIMIZER_ALIASES = {"fedavgm": "momentum", "fedadam": "adamw"}
AGGREGATORS = ("fedavg", "weighted", "bias_compensated",
               "staleness_weighted", "staleness", "hierarchical")
SNAPSHOT_MODES = ("dense", "delta")
LR_SCALES = ("none", "cohort")
ARRIVALS = ("sort", "topk", "topk:sharded")

SCALA_METHODS = ("scala", "scala_noadj")
METHODS = SCALA_METHODS + FL_METHODS + SFL_METHODS


def _one_of(kind: str, value, allowed) -> None:
    if value not in allowed:
        raise ValueError(f"unknown {kind} {value!r}; expected {allowed}")


def _not_ported(what: str, slice_: str):
    return NotImplementedError(f"{what} is not ported yet; it comes with "
                               f"{slice_}")


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
        _one_of("aggregator", self.aggregator.split(":")[0], AGGREGATORS)
        _one_of("opt_state_policy", self.opt_state_policy,
                OPT_STATE_POLICIES)

    def make_aggregator(self):
        from repro_torch.fed import make_aggregator

        return make_aggregator(self.aggregator)


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

    @property
    def in_program(self) -> bool:
        return self.mode in ("masked", "sparse", "async")


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
        """Reject what the port does not run (NotImplementedError, naming
        it) and what the reference rejects too (ValueError). Returns
        self."""
        ex, fd = self.execution, self.fed
        cfg = self.model_config()
        _one_of("method", self.method, METHODS)
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
        if ex.mode != "subset":
            raise _not_ported(f"execution mode {ex.mode!r}",
                              "the federation slice (masked) or the "
                              "sparse/async slice")
        if fd.participation is not None:
            raise ValueError(
                "mode 'subset' samples clients host-side; a participation "
                "spec needs an in-program mode ('masked' or 'sparse')")
        if ex.backend == "lace_dp":
            raise _not_ported("backend 'lace_dp'", "the multi-device slice")
        if ex.backend != "logits" and cfg.family == "cnn":
            raise ValueError(
                f"backend {ex.backend!r} needs a trunk/head split; the CNN "
                "(AlexNet) family only supports backend 'logits'")
        if any(spec.mixer in ("mlstm", "slstm") for spec in cfg.block_specs):
            raise _not_ported(f"training arch {self.arch!r} (mLSTM/sLSTM "
                              "blocks)", "the xLSTM training slice (the "
                              "chunkwise mLSTM kernel's backward)")
        if ex.precision == "bf16":
            raise _not_ported("precision 'bf16'", "the dispatch-knob slice")
        if ex.rounds_per_call > 1:
            raise _not_ported("rounds_per_call > 1",
                              "the dispatch-knob slice")
        if ex.server_optimizer is not None:
            raise _not_ported("execution.server_optimizer (FedOpt)",
                              "the federation slice")
        if fd.faults is not None or fd.guards is not None:
            raise _not_ported("faults/guards", "the fault-tolerance slice")
        fd.make_aggregator()     # NotImplementedError for unported ones
        for name, value, default in (
                ("snapshots", ex.snapshots, "dense"),
                ("lr_scale", ex.lr_scale, "none"),
                ("arrival", ex.arrival, "sort"),
                ("opt_paging", ex.opt_paging, "none"),
                ("deadline", ex.deadline, None)):
            if value != default:
                raise ValueError(f"{name}={value!r} applies to mode 'async' "
                                 "only")
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
