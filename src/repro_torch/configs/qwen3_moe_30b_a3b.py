"""Qwen3-30B-A3B — 128-expert top-8 MoE, GQA kv=4, QK-norm.

[hf:Qwen/Qwen3-30B-A3B]
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    source="hf:Qwen/Qwen3-30B-A3B",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=768,                       # per-expert hidden dim
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    ffn_pattern=("moe",),
    moe=MoEConfig(num_experts=128, top_k=8, d_expert=768),
    split_layer=2,
    param_dtype="bfloat16",
    # 30B MoE: ZeRO/FSDP over all chips beats TP on the collective
    # roofline term (EXPERIMENTS.md §Perf-beyond)
    sharding_profile="fsdp",
)
