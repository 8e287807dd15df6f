"""DBRX-base (132B) — fine-grained 16-expert top-4 MoE.

[hf:databricks/dbrx-base]
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    family="moe",
    source="hf:databricks/dbrx-base",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=10752,
    vocab_size=100352,
    rope_theta=500_000.0,
    ffn_pattern=("moe",),
    moe=MoEConfig(num_experts=16, top_k=4, d_expert=10752),
    split_layer=2,
    param_dtype="bfloat16",
    # 132B MoE: "fsdp" measured 1.3x better on collectives but the
    # per-layer gathered expert weights blow HBM (peak 30.5GB) — stays on
    # TP+FSDP (EXPERIMENTS.md §Perf-beyond)
)
