"""repro_torch.api -- the declarative serving layer.

:class:`ServeSpec` / :func:`build_serve` restore a federated training
checkpoint (or initialise from a seed), merge it into the global model
and return a :class:`ServeProgram` around the continuous-batching
:class:`repro_torch.serve.ServeEngine`.
"""
from repro_torch.api.serving import (  # noqa: F401
    ADMISSION_MODES,
    ServeProgram,
    ServeSpec,
    build_serve,
    restore_global_params,
)

__all__ = ["ADMISSION_MODES", "ServeProgram", "ServeSpec", "build_serve",
           "restore_global_params"]
