"""repro_torch.api -- the declarative layer.

Training: :class:`ExperimentSpec` (the reference's JSON schema) ->
:func:`build` -> :class:`RoundProgram`, driven round by round by
:class:`Trainer`. Serving: :class:`ServeSpec` / :func:`build_serve`
restore a federated training checkpoint (or initialise from a seed),
merge it into the global model and return a :class:`ServeProgram`
around the continuous-batching :class:`repro_torch.serve.ServeEngine`.
"""
from repro_torch.api.build import (  # noqa: F401
    ProgramState,
    RoundProgram,
    build,
    text_split_init,
)
from repro_torch.api.serving import (  # noqa: F401
    ADMISSION_MODES,
    ServeProgram,
    ServeSpec,
    build_serve,
    restore_global_params,
)
from repro_torch.api.specs import (  # noqa: F401
    FL_METHODS,
    METHODS,
    OPTIMIZER_ALIASES,
    SCALA_METHODS,
    SFL_METHODS,
    DataSpec,
    ExecutionSpec,
    ExperimentSpec,
    FedSpec,
    OptimSpec,
)
from repro_torch.api.trainer import (  # noqa: F401
    Trainer,
    build_image_data,
    build_lm_data,
)

__all__ = ["ADMISSION_MODES", "DataSpec", "ExecutionSpec", "ExperimentSpec",
           "FL_METHODS", "FedSpec", "METHODS", "OPTIMIZER_ALIASES",
           "OptimSpec", "ProgramState", "SCALA_METHODS", "SFL_METHODS",
           "RoundProgram", "ServeProgram", "ServeSpec", "Trainer", "build",
           "build_image_data", "build_lm_data", "build_serve",
           "restore_global_params", "text_split_init"]
