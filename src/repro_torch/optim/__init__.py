"""Optimizers and learning-rate schedules of the split step."""
from repro_torch.optim.optimizers import (  # noqa: F401
    Optimizer,
    adamw,
    make_optimizer,
    momentum,
    sgd,
)
