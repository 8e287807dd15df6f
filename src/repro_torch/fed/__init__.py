"""The federation layer: client-model aggregation
(:mod:`repro_torch.fed.aggregators`), participation scheduling
(:mod:`repro_torch.fed.participation`), composed by
:func:`repro_torch.core.engine.make_round_runner`, and the asynchronous
event runtime (:mod:`repro_torch.fed.runtime`, :func:`make_async_runner`)
with its completion-delay models (:mod:`repro_torch.fed.delays`); both
runners take the fault model (:mod:`repro_torch.fed.faults`) and the
guarded aggregation (:mod:`repro_torch.fed.guards`).

The round-level state the sync runner threads (scheduler state,
aggregator ages, server-optimizer state, the fault stream's state, the
guards' running median) is a plain dict ``{"sched": ..., "agg": ...[,
"server_opt": ...][, "faults": ...][, "guard": ...]}`` built by
:func:`init_fed_state`; the async runner threads an
:class:`AsyncFedState` built by :func:`init_async_state`.
"""
from __future__ import annotations

from typing import Any, Optional

from repro_torch.fed.aggregators import (  # noqa: F401
    AGGREGATORS,
    AggContext,
    Aggregator,
    aggregation_priors,
    bias_compensated,
    fedavg,
    hierarchical,
    make_aggregator,
    staleness_weighted,
    weighted,
)
from repro_torch.fed import delays  # noqa: F401
from repro_torch.fed.delays import (  # noqa: F401
    DELAY_MODELS,
    DelayModel,
    make_delays,
)
from repro_torch.fed.faults import (  # noqa: F401
    CORRUPT_MODES,
    FaultModel,
    make_faults,
)
from repro_torch.fed.guards import (  # noqa: F401
    GuardPolicy,
    make_guards,
)
from repro_torch.fed.participation import (  # noqa: F401
    SCHEDULERS,
    ParticipationScheduler,
    dirichlet,
    full,
    make_participation,
    uniform,
)
from repro_torch.fed.runtime import (  # noqa: F401
    ARRIVALS,
    LR_SCALES,
    SNAPSHOT_MODES,
    AsyncFedState,
    HostOptPager,
    arrival_cohort,
    async_state_bytes,
    init_async_state,
    make_arrival_pop,
    make_async_runner,
    ring_lookup,
    sharded_arrival_cohort,
)


def is_stateful(aggregator: Optional[Aggregator],
                participation: Optional[ParticipationScheduler]) -> bool:
    """True iff the runner must thread a fed state across rounds."""
    return ((aggregator is not None and aggregator.stateful)
            or (participation is not None and participation.stateful))


def init_fed_state(seed: int, aggregator: Optional[Aggregator] = None,
                   participation: Optional[ParticipationScheduler] = None,
                   num_clients: Optional[int] = None,
                   server_optimizer=None, server_params=None,
                   faults=None, guards=None, device="cpu") -> dict:
    """The federation state threaded through sync rounds: the scheduler's
    state from ``seed`` (a CPU tensor: masks are drawn on the host), the
    aggregator's on ``device`` and, with ``server_optimizer``, its state
    over ``server_params`` (the server half) under ``"server_opt"``.

    ``faults`` (a :class:`FaultModel` or spec string): the fault stream's
    state ``[seed, 0]`` under ``"faults"`` (round ``c`` draws from
    ``default_rng([seed, 0x5FA17, c])``, apart from the scheduler's
    ``[seed, c]``). ``guards`` (a :class:`GuardPolicy` or spec string):
    the running-median clip state on ``device`` under ``"guard"`` when
    the policy clips, else ``()``."""
    from repro_torch.fed import faults as _faults
    from repro_torch.fed import guards as _guards

    if num_clients is None:
        if participation is not None:
            num_clients = participation.num_clients
        elif aggregator is not None:
            raise ValueError("init_fed_state needs num_clients when no "
                             "participation scheduler is given")
    sched: Any = participation.init(seed) if participation is not None \
        else ()
    agg: Any = (aggregator.init(num_clients, device)
                if aggregator is not None else ())
    state = {"sched": sched, "agg": agg}
    if server_optimizer is not None:
        if server_params is None:
            raise ValueError("init_fed_state needs server_params when a "
                             "server_optimizer is given")
        state["server_opt"] = server_optimizer.init(server_params)
    if faults is not None:
        _faults.make_faults(faults)                  # validate the spec
        state["faults"] = _faults.init_state(seed)
    if guards is not None:
        gp = _guards.make_guards(guards)
        state["guard"] = _guards.init_state(device) if gp.stateful else ()
    return state
