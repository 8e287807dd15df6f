"""H2O-Danube-3-4B — llama/mistral-style dense decoder with sliding-window.

[arXiv:2401.16818]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-3-4b",
    family="dense",
    source="arXiv:2401.16818 (H2O-Danube 4B)",
    num_layers=24,
    d_model=3840,
    num_heads=32,
    num_kv_heads=8,
    head_dim=120,
    d_ff=10240,
    vocab_size=32000,
    window_pattern=(4096,),          # mistral-style SWA on every layer
    rope_theta=10_000.0,
    split_layer=2,
    # 4B: ZeRO/FSDP over all chips beats TP on the collective
    # roofline term (EXPERIMENTS.md §Perf-beyond)
    sharding_profile="fsdp",
)
