"""The port's tooling layer: H100 roofline constants and terms
(:mod:`.roofline`), op-by-op counting of a step (:mod:`.count`) and the
dry run's tables (:mod:`.report`)."""
from repro_torch.perf.roofline import (  # noqa: F401
    HBM_BW,
    HBM_BYTES,
    LINK_BW,
    PEAK_BY_KIND,
    PEAK_FLOPS,
    Work,
    collectives_from_calls,
    count_params,
    model_flops,
    roofline_terms,
    work_bound,
)
