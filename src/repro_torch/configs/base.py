"""Config dataclasses for the SCALA framework.

Every assigned architecture is expressed as a :class:`ModelConfig`; the
per-layer structure (attention vs. SSM mixers, dense vs. MoE FFNs,
sliding-window patterns) is described by cyclic patterns that the model
assembler expands into per-layer :class:`BlockSpec`s and groups into a
scan-friendly super-block.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Optional, Tuple


# ---------------------------------------------------------------------------
# Sub-configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts FFN configuration."""

    num_experts: int
    top_k: int
    d_expert: int                      # hidden dim of each expert FFN
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01    # load-balance auxiliary loss weight
    router_dtype: str = "float32"


@dataclass(frozen=True)
class MambaConfig:
    """Mamba-1 selective SSM mixer configuration (Jamba-style)."""

    d_state: int = 16
    d_conv: int = 4
    expand: int = 2

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model


@dataclass(frozen=True)
class XLSTMConfig:
    """xLSTM block configuration (mLSTM matrix memory / sLSTM scalar)."""

    proj_factor_mlstm: float = 2.0     # up-projection inside mLSTM blocks
    proj_factor_slstm: float = 4.0 / 3.0
    conv_kernel: int = 4
    chunk_size: int = 64               # chunkwise-parallel training chunk


@dataclass(frozen=True)
class BlockSpec:
    """Fully-resolved structure of one layer of the stack."""

    mixer: str                 # 'attn' | 'mamba' | 'mlstm' | 'slstm'
    ffn: str                   # 'dense' | 'moe' | 'none'
    window: Optional[int]      # sliding-window size for attn (None = global)
    cross_attn: bool = False   # insert a cross-attention sublayer (whisper)


# ---------------------------------------------------------------------------
# Model config
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                        # dense|moe|hybrid|ssm|vlm|audio|cnn
    source: str                        # citation for the config numbers

    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # --- layer structure patterns (cycled over layer index) ---
    mixer_pattern: Tuple[str, ...] = ("attn",)
    ffn_pattern: Tuple[str, ...] = ("dense",)
    window_pattern: Tuple[Optional[int], ...] = (None,)
    cross_attn: bool = False           # every attn layer also cross-attends

    # --- attention details ---
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    pos_embed: str = "rope"            # rope|learned|none
    max_position: int = 524_288
    attn_logit_softcap: Optional[float] = None

    # --- embeddings / head ---
    tied_embeddings: bool = False
    norm_eps: float = 1e-6
    act: str = "silu"                  # mlp activation: silu (gated) | gelu

    # --- sub-configs ---
    moe: Optional[MoEConfig] = None
    mamba: Optional[MambaConfig] = None
    xlstm: Optional[XLSTMConfig] = None

    # --- modality frontend (stubbed per the brief) ---
    frontend: Optional[str] = None     # None | 'vision' | 'audio'
    num_prefix_tokens: int = 0         # patch tokens (vlm) / enc memory (audio)
    frontend_dim: int = 0              # raw embedding dim before projector

    # --- SCALA split ---
    split_layer: int = 2               # client-side = embed + blocks[:split_layer]

    # --- distribution policy (§Perf iteration 2) ---
    # "tp": weights tensor/expert-parallel over `model`, FSDP over `data`.
    # "dp": weights replicated, batch over every mesh axis (client over
    #       data, per-client batch over model) — zero activation
    #       collectives; right when params fit per-chip HBM.
    sharding_profile: str = "tp"

    # --- numerics ---
    dtype: str = "bfloat16"            # activation/compute dtype
    param_dtype: str = "float32"       # parameter storage dtype

    # ------------------------------------------------------------------
    def block_spec(self, layer: int) -> BlockSpec:
        mixer = self.mixer_pattern[layer % len(self.mixer_pattern)]
        ffn = self.ffn_pattern[layer % len(self.ffn_pattern)]
        window = self.window_pattern[layer % len(self.window_pattern)]
        return BlockSpec(
            mixer=mixer,
            ffn=ffn,
            window=window if mixer == "attn" else None,
            cross_attn=self.cross_attn and mixer == "attn",
        )

    @property
    def block_specs(self) -> Tuple[BlockSpec, ...]:
        return tuple(self.block_spec(l) for l in range(self.num_layers))

    @property
    def group_size(self) -> int:
        """Smallest period of the layer pattern that divides num_layers.

        The transformer assembler stacks params of one *group* of layers
        and scans over ``num_layers // group_size`` groups, keeping the
        HLO small for the 48-72 layer archs.
        """
        period = math.lcm(
            len(self.mixer_pattern), len(self.ffn_pattern), len(self.window_pattern)
        )
        while self.num_layers % period != 0:
            period += period
            if period > self.num_layers:
                return self.num_layers
        return period

    @property
    def num_groups(self) -> int:
        return self.num_layers // self.group_size

    @property
    def uses_attention(self) -> bool:
        return any(s.mixer == "attn" for s in self.block_specs)

    @property
    def pure_full_attention(self) -> bool:
        """True iff every mixer is global (non-windowed) attention."""
        return all(s.mixer == "attn" and s.window is None for s in self.block_specs)

    @property
    def supports_long_decode(self) -> bool:
        """long_500k eligibility per the brief: SSM / hybrid / windowed."""
        return not self.pure_full_attention and self.family != "audio"

    @property
    def is_decoder(self) -> bool:
        return self.family != "cnn"

    def validate(self) -> None:
        assert self.num_heads % self.num_kv_heads == 0, self.name
        assert 0 < self.split_layer < self.num_layers, self.name
        if "moe" in self.ffn_pattern:
            assert self.moe is not None, self.name
        if "mamba" in self.mixer_pattern:
            assert self.mamba is not None, self.name
        if {"mlstm", "slstm"} & set(self.mixer_pattern):
            assert self.xlstm is not None, self.name

    def reduced(self, **overrides) -> "ModelConfig":
        """A CPU-smoke-test variant of the same family (<=2 groups,
        d_model<=512, <=4 experts)."""
        gs = self.group_size
        num_layers = min(self.num_layers, 4 if gs == 1 else 2 * gs)
        d_model = min(self.d_model, 256)
        num_heads = min(self.num_heads, 4)
        num_kv = max(1, min(self.num_kv_heads, num_heads, 2))
        while num_heads % num_kv:
            num_kv -= 1
        head_dim = max(8, d_model // num_heads)
        moe = None
        if self.moe is not None:
            moe = dataclasses.replace(
                self.moe,
                num_experts=min(4, self.moe.num_experts),
                top_k=min(2, self.moe.top_k),
                d_expert=min(128, self.moe.d_expert),
            )
        window = tuple(
            (None if w is None else min(w, 64)) for w in self.window_pattern
        )
        base = dataclasses.replace(
            self,
            name=self.name + "-smoke",
            num_layers=num_layers,
            d_model=d_model,
            num_heads=num_heads,
            num_kv_heads=num_kv,
            head_dim=head_dim,
            d_ff=min(self.d_ff, 512),
            vocab_size=min(self.vocab_size, 512),
            moe=moe,
            window_pattern=window,
            num_prefix_tokens=min(self.num_prefix_tokens, 8),
            frontend_dim=min(self.frontend_dim, 64) if self.frontend_dim else 0,
            split_layer=max(1, min(self.split_layer, num_layers - 1)),
            param_dtype="float32",
            dtype="float32",
        )
        return dataclasses.replace(base, **overrides) if overrides else base


# ---------------------------------------------------------------------------
# Input shapes (assigned grid)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    mode: str                          # 'train' | 'prefill' | 'decode'


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


# ---------------------------------------------------------------------------
# SCALA / training configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ScalaConfig:
    """Hyper-parameters of the SCALA algorithm (paper §5.1 defaults)."""

    num_clients: int = 100             # K, total client population
    participation: float = 0.10        # r, fraction sampled per round
    local_iters: int = 5               # T
    server_batch: int = 320            # B (concatenated minibatch size)
    lr: float = 0.01                   # eta (plain SGD, paper default)
    tau: float = 1.0                   # logit-adjustment temperature
    adjust_server: bool = True         # eq. (14)
    adjust_client: bool = True         # eq. (15)
    label_smoothing: float = 0.0
    prior_eps: float = 1e-8            # numerical floor for log P(y)
    # dtype for cross-device gradient reductions in the manual-SPMD ("dp")
    # step; bf16 halves the only remaining wire traffic (and its buffers)
    # at the usual DDP-compression numerics cost. None = reduce in the
    # gradient's native dtype (exact).
    grad_reduce_dtype: Optional[str] = "bfloat16"

    @property
    def clients_per_round(self) -> int:
        return max(1, round(self.num_clients * self.participation))


@dataclass(frozen=True)
class TrainConfig:
    """End-to-end training-run config (examples / benchmarks scale)."""

    rounds: int = 50                   # I, global iterations
    seed: int = 0
    optimizer: str = "sgd"             # sgd | momentum | adamw
    momentum: float = 0.0
    weight_decay: float = 0.0
    eval_every: int = 10
    log_every: int = 10
    checkpoint_every: int = 0          # 0 = disabled
    checkpoint_dir: str = ""
