"""The depthwise causal convolution of :mod:`repro.models.layers.mamba`.

Only :func:`_causal_conv` is ported so far: the mLSTM block of xLSTM
runs it before its q/k projections. The rest of mamba comes with the
jamba slice.
"""
from __future__ import annotations

import torch


def _causal_conv(x, w, b, prev=None):
    """Depthwise causal conv. x: (B, S, di); w: (dc, di); b: (di,);
    prev: (B, dc-1, di), the inputs before x (zeros when None). Returns
    (y (B, S, di), the last dc-1 inputs: the next call's ``prev``)."""
    dc = w.shape[0]
    if prev is None:
        prev = x.new_zeros((x.shape[0], dc - 1, x.shape[2]))
    xp = torch.cat([prev.to(x.dtype), x], dim=1)
    S = x.shape[1]
    y = sum(xp[:, k:k + S] * w[k].to(x.dtype) for k in range(dc))
    return y + b.to(x.dtype), xp[:, -(dc - 1):]
