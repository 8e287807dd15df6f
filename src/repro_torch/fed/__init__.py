"""The federation layer: client-model aggregation
(:mod:`repro_torch.fed.aggregators`), composed by
:func:`repro_torch.core.engine.make_round_runner`. Participation
schedulers, delays, the async runtime, faults and guards wait for the
federation slice."""
from repro_torch.fed.aggregators import (  # noqa: F401
    AGGREGATORS,
    AggContext,
    Aggregator,
    fedavg,
    make_aggregator,
    weighted,
)
