"""Gemma3-12B — 5:1 local:global attention, 128k context, 262k vocab.

[hf:google/gemma-3-1b-pt family, scaled to the 12B variant]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-12b",
    family="dense",
    source="hf:google/gemma-3-12b-pt",
    num_layers=48,
    d_model=3840,
    num_heads=16,
    num_kv_heads=8,
    head_dim=256,
    d_ff=15360,
    vocab_size=262144,
    # 5 local (1024-token sliding window) : 1 global
    window_pattern=(1024, 1024, 1024, 1024, 1024, None),
    qk_norm=True,
    rope_theta=1_000_000.0,
    act="gelu",
    tied_embeddings=True,
    split_layer=2,
    param_dtype="bfloat16",
    # 12B: ZeRO/FSDP over all chips beats TP on the collective
    # roofline term (EXPERIMENTS.md §Perf-beyond)
    sharding_profile="fsdp",
)
