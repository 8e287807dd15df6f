"""Qwen1.5-0.5B — small dense decoder with QKV bias and tied embeddings.

[hf:Qwen/Qwen1.5-0.5B]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-0.5b",
    family="dense",
    source="hf:Qwen/Qwen1.5-0.5B",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=2816,
    vocab_size=151936,
    qkv_bias=True,
    tied_embeddings=True,
    rope_theta=1_000_000.0,
    split_layer=2,
    # 0.5B params fit per-chip HBM with room to spare: pure client/data
    # parallelism beats 16-way TP by ~40x on the collective roofline term
    # (EXPERIMENTS.md §Perf iteration 2)
    sharding_profile="dp",
)
