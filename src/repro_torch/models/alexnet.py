"""AlexNet adapted for 32x32 inputs -- the paper's own model (Appendix E).

Conv stack (5 convs + pools) + 2 FC layers + classifier. The split point
``s1..s5`` (Appendix H) selects how many conv layers stay on the client;
the paper's default (§5.1, "first 6 layers client / last 8 server") is
s2.

Layout. Images come in NHWC, as the data and the reference give them;
the convolutions run NCHW with OIHW weights (``F.conv2d``), so the
activations that cross the split are (B, C, H, W). The reference
flattens NHWC activations before the first FC layer, so the port
permutes back to NHWC before its flatten: ``fcs[0].w`` keeps the
reference's row order, and only the conv weights change layout in
:mod:`repro_torch.convert` (HWIO -> OIHW). ``convs`` and ``fcs`` are
tuples (the port's trees have no lists).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.alexnet_cifar import (CONV_CHANNELS, FC_WIDTHS,
                                               SPLIT_POINTS)
from repro_torch.models.common import dense_init

# (kernel, stride, pool_after) per conv layer; pools are 2x2 max, VALID.
_CONV_SPECS = [(3, 1, True), (3, 1, True), (3, 1, False), (3, 1, False),
               (3, 1, True)]


def _flat_dim(channels, in_hw: int = 32) -> int:
    hw = in_hw
    for _, _, pool in _CONV_SPECS:
        if pool:
            hw //= 2
    return hw * hw * channels[-1]


def init_params(gen: torch.Generator, num_classes: int = 10,
                in_channels: int = 3, width: float = 1.0):
    """The port's own init on ``gen``'s device: truncated-normal fan-in
    weights, zero biases, float32. ``width < 1`` scales the channels and
    FC widths as the reference does (the paper's model is width 1.0)."""
    channels = [max(8, int(c * width)) for c in CONV_CHANNELS]
    fc_widths = [max(32, int(f * width)) for f in FC_WIDTHS]
    f32 = torch.float32
    zeros = lambda n: torch.zeros(n, dtype=f32, device=gen.device)
    convs, cin = [], in_channels
    for i, cout in enumerate(channels):
        k = _CONV_SPECS[i][0]
        convs.append({"w": dense_init(gen, (cout, cin, k, k), k * k * cin,
                                      f32), "b": zeros(cout)})
        cin = cout
    fcs, din = [], _flat_dim(channels)
    for f in fc_widths:
        fcs.append({"w": dense_init(gen, (din, f), din, f32), "b": zeros(f)})
        din = f
    head = {"w": dense_init(gen, (din, num_classes), din, f32),
            "b": zeros(num_classes)}
    return {"convs": tuple(convs), "fcs": tuple(fcs), "head": head}


def _conv_apply(p, x, pool):
    y = F.relu(F.conv2d(x, p["w"], p["b"], padding=p["w"].shape[-1] // 2))
    return F.max_pool2d(y, 2) if pool else y


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _fcs(params, x):
    """Flatten (B, C, H, W) in the reference's NHWC order, then the FC
    layers."""
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
    for fc in params["fcs"]:
        x = F.relu(x @ fc["w"] + fc["b"])
    return x


def _head(params, x):
    return _fcs(params, x) @ params["head"]["w"] + params["head"]["b"]


def client_forward(params, x, split: str = "s2"):
    """x (B, 32, 32, 3) NHWC -> activations (B, C, H, W) after ``split``
    conv layers."""
    x = _nchw(x)
    for i in range(SPLIT_POINTS[split]):
        x = _conv_apply(params["convs"][i], x, _CONV_SPECS[i][2])
    return x


def server_forward(params, acts, split: str = "s2"):
    """The remaining convs, the FCs and the classifier: logits (B,
    classes)."""
    x = acts
    for i in range(SPLIT_POINTS[split], len(params["convs"])):
        x = _conv_apply(params["convs"][i], x, _CONV_SPECS[i][2])
    return _head(params, x)


def forward(params, x, split: str = "s2"):
    return server_forward(params, client_forward(params, x, split), split)


def features(params, x):
    """The representation before the classifier head (the last FC's
    activation)."""
    x = _nchw(x)
    for i, p in enumerate(params["convs"]):
        x = _conv_apply(p, x, _CONV_SPECS[i][2])
    return _fcs(params, x)


def split_params(params, split: str = "s2"):
    """(client half, server half) of a full tree."""
    n = SPLIT_POINTS[split]
    client = {"convs": params["convs"][:n]}
    server = {"convs": params["convs"][n:], "fcs": params["fcs"],
              "head": params["head"]}
    return client, server


def merge_params(client, server):
    return {"convs": client["convs"] + server["convs"],
            "fcs": server["fcs"], "head": server["head"]}


def client_forward_from_split(client_params, x, split: str = "s2"):
    """The client half alone (params already split)."""
    x = _nchw(x)
    for i, p in enumerate(client_params["convs"]):
        x = _conv_apply(p, x, _CONV_SPECS[i][2])
    return x


def server_forward_from_split(server_params, acts, split: str = "s2"):
    """The server half alone: logits (B, classes)."""
    offset = SPLIT_POINTS[split]
    x = acts
    for i, p in enumerate(server_params["convs"]):
        x = _conv_apply(p, x, _CONV_SPECS[offset + i][2])
    return _head(server_params, x)
