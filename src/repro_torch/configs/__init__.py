"""Config registry: ``get_config(name)`` / ``list_configs()``.

The 10 assigned architectures + the paper's own AlexNet.
"""
from __future__ import annotations

from typing import Dict, List

from repro_torch.configs.base import (
    INPUT_SHAPES,
    BlockSpec,
    InputShape,
    MambaConfig,
    ModelConfig,
    MoEConfig,
    ScalaConfig,
    TrainConfig,
    XLSTMConfig,
)

from repro_torch.configs import (  # noqa: E402
    alexnet_cifar,
    dbrx_132b,
    gemma3_12b,
    granite_3_8b,
    h2o_danube_3_4b,
    internvl2_26b,
    jamba_1_5_large_398b,
    qwen1_5_0_5b,
    qwen3_moe_30b_a3b,
    whisper_tiny,
    xlstm_1_3b,
)

_REGISTRY: Dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (
        internvl2_26b,
        qwen3_moe_30b_a3b,
        qwen1_5_0_5b,
        jamba_1_5_large_398b,
        whisper_tiny,
        h2o_danube_3_4b,
        gemma3_12b,
        dbrx_132b,
        xlstm_1_3b,
        granite_3_8b,
        alexnet_cifar,
    )
}

ASSIGNED_ARCHS: List[str] = [n for n in _REGISTRY if n != "alexnet-cifar"]


def get_config(name: str) -> ModelConfig:
    try:
        cfg = _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown architecture {name!r}; available: {sorted(_REGISTRY)}"
        ) from None
    cfg.validate()
    return cfg


def list_configs() -> List[str]:
    return sorted(_REGISTRY)


def get_shape(name: str) -> InputShape:
    try:
        return INPUT_SHAPES[name]
    except KeyError:
        raise KeyError(
            f"unknown input shape {name!r}; available: {sorted(INPUT_SHAPES)}"
        ) from None


__all__ = [
    "ASSIGNED_ARCHS",
    "BlockSpec",
    "INPUT_SHAPES",
    "InputShape",
    "MambaConfig",
    "ModelConfig",
    "MoEConfig",
    "ScalaConfig",
    "TrainConfig",
    "XLSTMConfig",
    "get_config",
    "get_shape",
    "list_configs",
]
