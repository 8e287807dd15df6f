"""Granite-3.0-8B — dense GQA decoder.

[hf:ibm-granite/granite-3.0-8b-base (family card: granite-3.0-2b-base)]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-8b",
    family="dense",
    source="hf:ibm-granite/granite-3.0-8b-base",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=12800,
    vocab_size=49155,
    rope_theta=10_000.0,
    tied_embeddings=True,
    split_layer=2,
    # 8B does not replicate (32GB f32) but ZeRO/FSDP over all 256 chips
    # removes every TP activation collective (EXPERIMENTS.md §Perf-beyond)
    sharding_profile="fsdp",
)
