"""AlexNet adapted for CIFAR-shaped 32x32 inputs — the paper's own model.

[SCALA paper, Appendix E, Figure 6] — 6 client-side layers / 8 server-side
layers at the default split (paper §5.1), with the Appendix H split points
s1..s5 selectable.

This config is consumed by :mod:`repro.models.alexnet` (a CNN, not the
transformer assembler); it reuses :class:`ModelConfig` fields loosely:
``d_model`` is the classifier width and ``vocab_size`` the class count.
"""
from repro_torch.configs.base import ModelConfig

# Conv stack (paper Fig. 6, CIFAR variant): channels per conv layer.
CONV_CHANNELS = (64, 192, 384, 256, 256)
FC_WIDTHS = (4096, 4096)

# Appendix H split points: number of *conv* layers kept on the client.
SPLIT_POINTS = {"s1": 1, "s2": 2, "s3": 3, "s4": 4, "s5": 5}

CONFIG = ModelConfig(
    name="alexnet-cifar",
    family="cnn",
    source="SCALA (2024) Appendix E Fig.6",
    num_layers=len(CONV_CHANNELS) + len(FC_WIDTHS) + 1,
    d_model=FC_WIDTHS[0],
    num_heads=1,
    num_kv_heads=1,
    head_dim=1,
    d_ff=FC_WIDTHS[0],
    vocab_size=10,                  # num classes (CIFAR10 default)
    mixer_pattern=("attn",),        # unused by the CNN path
    split_layer=2,                  # paper default == s2
    dtype="float32",
    param_dtype="float32",
)
