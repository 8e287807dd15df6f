"""xLSTM-1.3B — sLSTM + mLSTM block stack (attention-free).

[arXiv:2405.04517] — xLSTM[7:1]: one sLSTM block per 7 mLSTM blocks.
d_ff=0: all FFN capacity lives inside the block up/down projections.
"""
from repro_torch.configs.base import ModelConfig, XLSTMConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    family="ssm",
    source="arXiv:2405.04517 (xLSTM 1.3B)",
    num_layers=48,
    d_model=2048,
    num_heads=4,
    num_kv_heads=4,
    head_dim=512,
    d_ff=0,
    vocab_size=50304,
    mixer_pattern=("mlstm", "mlstm", "mlstm", "slstm",
                   "mlstm", "mlstm", "mlstm", "mlstm"),
    ffn_pattern=("none",),
    pos_embed="none",
    xlstm=XLSTMConfig(),
    split_layer=2,
    # 1.3B params replicate comfortably; the mLSTM chunkwise scan emits
    # thousands of tiny TP collectives under the "tp" profile (25k+ ARs
    # per step) — pure client/data parallelism removes all of them
    # (EXPERIMENTS.md §Perf)
    sharding_profile="dp",
)
