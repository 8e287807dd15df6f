"""Model adapters: a model's two halves as a :class:`SplitModel`."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.core.engine import SplitModel


def transformer_split_model(cfg: ModelConfig) -> SplitModel:
    """The transformer's client half (embedding + ``split_layer``
    blocks) and server half (the rest + final norm + head). The
    reference's ``dp_loss`` (the loss reduced over a device mesh) has no
    counterpart on one card."""
    from repro_torch.models import transformer as T

    def client_fwd(wc, batch):
        return T.client_forward(wc, batch, cfg)

    def server_fwd(ws, acts):
        return T.server_forward(ws, acts, cfg)

    def server_trunk(ws, acts):
        return T.server_forward(ws, acts, cfg, head_mode="feats")

    def head_weight(ws):
        return ws["head"]["out"]

    def head_grad_merge(d_ws, g_w):
        d_ws = dict(d_ws)
        d_ws["head"] = {"out": d_ws["head"]["out"] + g_w.to(
            d_ws["head"]["out"].dtype)}
        return d_ws

    return SplitModel(client_fwd=client_fwd, server_fwd=server_fwd,
                      num_classes=cfg.vocab_size, server_trunk=server_trunk,
                      head_weight=head_weight,
                      head_grad_merge=head_grad_merge)
