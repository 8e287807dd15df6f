"""Crash-safe checkpoints of the port's trees (``repro.checkpoint``'s
file format): :func:`save` / :func:`restore` and their helpers."""
from repro_torch.checkpoint.checkpoint import (  # noqa: F401
    CORRUPT_ERRORS,
    PORT_KEY,
    all_steps,
    checkpoint_path,
    expanded_arrays,
    latest_step,
    load_arrays,
    restore,
    restore_arrays,
    save,
    write_json_atomic,
)
