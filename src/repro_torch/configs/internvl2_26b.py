"""InternVL2-26B language backbone (InternLM2-20B) + stub InternViT frontend.

[arXiv:2404.16821] — vision encoder (InternViT-6B) and MLP projector are
stubbed per the brief: ``input_specs`` supplies pre-computed patch
embeddings of shape (batch, num_prefix_tokens, frontend_dim) which the
projector maps into d_model.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b",
    family="vlm",
    source="arXiv:2404.16821 (InternVL2-26B; InternLM2-20B backbone)",
    num_layers=48,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=92553,
    rope_theta=1_000_000.0,
    act="silu",
    frontend="vision",
    num_prefix_tokens=256,       # 256 patch tokens per image tile
    frontend_dim=3200,           # InternViT-6B output width
    split_layer=2,
    param_dtype="bfloat16",
    # 26B: ZeRO/FSDP over all chips beats TP on the collective
    # roofline term (EXPERIMENTS.md §Perf-beyond)
    sharding_profile="fsdp",
)
