"""Whisper-tiny decoder backbone with stub audio-encoder memory.

[arXiv:2212.04356] — the mel-spectrogram + conv frontend and the audio
encoder are stubbed per the brief: ``input_specs`` supplies encoder
memory embeddings (batch, num_prefix_tokens=1500, d_model) which every
decoder layer cross-attends.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="audio",
    source="arXiv:2212.04356 (Whisper tiny, decoder)",
    num_layers=4,
    d_model=384,
    num_heads=6,
    num_kv_heads=6,
    head_dim=64,
    d_ff=1536,
    vocab_size=51865,
    cross_attn=True,
    pos_embed="learned",
    max_position=32768,
    act="gelu",
    tied_embeddings=True,
    frontend="audio",
    num_prefix_tokens=1500,      # encoder output frames (30s @ 50Hz)
    frontend_dim=384,
    split_layer=1,
    # 39M params: tensor-parallelism is pure overhead at this size — pure
    # client/data parallelism (see EXPERIMENTS.md §Perf)
    sharding_profile="dp",
)
