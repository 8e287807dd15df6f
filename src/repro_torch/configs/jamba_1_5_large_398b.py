"""Jamba-1.5-Large (398B) — Mamba+attention 1:7 interleave with MoE 16e top-2.

[arXiv:2403.19887] — period-8 layer pattern: one attention layer per 7
Mamba layers; every second layer uses the 16-expert MoE FFN.
"""
from repro_torch.configs.base import MambaConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    source="arXiv:2403.19887 (Jamba-1.5-Large)",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=65536,
    # attn at layer 4 of each 8-layer period (matches Jamba's placement)
    mixer_pattern=("mamba", "mamba", "mamba", "mamba",
                   "attn", "mamba", "mamba", "mamba"),
    # MoE every other layer
    ffn_pattern=("dense", "moe"),
    pos_embed="none",                # Jamba uses no explicit positional encoding
    moe=MoEConfig(num_experts=16, top_k=2, d_expert=24576),
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2),
    split_layer=2,
    param_dtype="bfloat16",
)
