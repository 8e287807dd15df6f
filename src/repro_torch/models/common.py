"""Shared helpers for the functional model library.

Every layer module follows the convention of :mod:`repro.models`:
``init(generator, cfg, ...) -> params`` (a dict of tensors made on the
generator's device) and ``apply(params, x, ...) -> y`` on tensors.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
    "int32": torch.int32,
}


def dtype_of(name: str) -> torch.dtype:
    return DTYPES[name]


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device on a machine
    without a card raises instead of falling back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but no CUDA device is "
            "available; pass device='cpu' to run on the CPU")
    return dev


def dense_init(gen: torch.Generator, shape, in_axis_size: int,
               dtype: torch.dtype) -> torch.Tensor:
    """Truncated-normal fan-in initializer (LeCun-style)."""
    t = torch.empty(shape, dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    # scaled in place: a (16, 8192, 24576) expert stack holds one float32
    # copy at a time, not two
    return t.mul_(1.0 / math.sqrt(max(1, in_axis_size))).to(dtype)


def embed_init(gen: torch.Generator, shape, dtype: torch.dtype) -> torch.Tensor:
    t = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (t * 0.02).to(dtype)


def gelu(x):
    return F.gelu(x, approximate="tanh")


ACTIVATIONS = {
    "silu": F.silu,
    "gelu": gelu,
    "gelu_mlp": gelu,
    "relu": F.relu,
}
