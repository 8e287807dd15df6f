"""Mixture-of-experts FFN: top-k routing with per-row capacity drops.

The semantics are :mod:`repro.models.layers.moe`'s: routing in float32
(softmax, top-k, the top-k weights renormalized), the Switch load-balance
loss, each batch row one dispatch group with its own capacity, and a
stable sort of a row's (token, k) pairs by expert that keeps earlier
tokens (then lower k) first, so the pairs past an expert's capacity are
the reference's. The reference scatters every row into a dense (groups,
experts, capacity, d) buffer; at the dropless capacity of a serving
prefill (capacity = tokens x top_k) nearly all of it is empty rows. Here
only the kept pairs are laid out, expert by expert across the groups,
into an (experts, rows, d) buffer trimmed to the most rows one expert
takes, and the gated expert FFN is three batched products over it. A
decode step (one token a row) reads nothing back to the host.
"""
from __future__ import annotations

import torch

from repro_torch.models.common import ACTIVATIONS, dense_init, dtype_of

# The most rows an expert's slab may take without reading the exact
# count back to the host. At full width (d 2048, f 768) the batched
# products stay bound by reading every expert's weights up to ~147 rows
# an expert on an H100, so a bound of 128 rows costs no more time than
# the exact count and spares a device-to-host sync (a decode step's bound
# is its batch rows x capacity 1).
STATIC_ROWS = 128


def moe_init(gen: torch.Generator, cfg):
    m = cfg.moe
    pd = dtype_of(cfg.param_dtype)
    d, e, f = cfg.d_model, m.num_experts, m.d_expert
    return {
        "router": dense_init(gen, (d, e), d, torch.float32),
        "gate": dense_init(gen, (e, d, f), d, pd),
        "up": dense_init(gen, (e, d, f), d, pd),
        "down": dense_init(gen, (e, f, d), f, pd),
    }


def moe_axes(cfg):
    return {
        "router": ("embed", "experts_router"),
        "gate": ("experts", "embed", "expert_ffn"),
        "up": ("experts", "embed", "expert_ffn"),
        "down": ("experts", "expert_ffn", "embed"),
    }


def capacity(tokens_per_group: int, m) -> int:
    cap = int(tokens_per_group * m.top_k * m.capacity_factor / m.num_experts)
    return max(1, cap)


def route(params, x, m):
    """float32 routing of x (G, n, d): (gates (G, n, E), the top-k
    weights renormalized and the expert ids, each (G, n, K)). Ties go to
    the lower expert id, as ``jax.lax.top_k`` breaks them."""
    logits = x.float() @ params["router"].float()
    gates = torch.softmax(logits, dim=-1)
    top_w, top_i = gates.sort(dim=-1, descending=True, stable=True)
    top_w, top_i = top_w[..., :m.top_k], top_i[..., :m.top_k]
    top_w = top_w / top_w.sum(-1, keepdim=True).clamp_min(1e-9)
    return gates, top_w, top_i


def moe_apply(params, x, cfg):
    """x: (..., seq, d_model). Returns (y, aux_loss)."""
    m = cfg.moe
    act = ACTIVATIONS[cfg.act]
    shape = x.shape
    n, d = shape[-2], shape[-1]
    x = x.reshape(-1, n, d)
    G, E, K = x.shape[0], m.num_experts, m.top_k
    cap = capacity(n, m)
    dev = x.device

    gates, top_w, top_i = route(params, x, m)

    # each pair's rank among its row's earlier pairs of the same expert, in
    # the (token, k) order: its place in the reference's stable sort by
    # expert, counted by a running one-hot sum (no sort, no host sync),
    # laid out (G, E, pairs) so that the sum runs along the last axis
    flat_e = top_i.reshape(G, n * K)
    seen = torch.zeros((G, E, n * K), dtype=torch.long, device=dev).scatter_(
        1, flat_e[:, None], 1).cumsum(2)
    pos = seen.gather(1, flat_e[:, None])[:, 0] - 1              # (G, nK)
    counts = seen[..., -1]                                       # (G, E)
    keep = pos < cap

    # load-balance aux (Switch): E * <gates_e> . <frac_routed_e>
    me = gates.mean(dim=(0, 1))
    ce = counts.sum(0).float() / (G * n * K)
    aux = m.router_aux_weight * E * (me * ce).sum()

    # the kept pairs' rows in the experts' slabs: expert e's rows are its
    # kept pairs of row 0, then of row 1, ...
    kept = counts.clamp(max=cap)
    offset = kept.cumsum(0) - kept                               # (G, E)
    bound = G * min(cap, n)
    # on meta (a dry run) nothing can be read back: the static bound, as
    # the reference's compiled program sizes its slab
    rows = (bound if bound <= STATIC_ROWS or dev.type == "meta"
            else max(1, int(kept.sum(0).max())))
    slot = flat_e * rows + offset.gather(1, flat_e) + pos
    slot = torch.where(keep, slot, E * rows).reshape(-1)          # dump row
    buf = x.new_zeros((E * rows + 1, d))
    buf.index_copy_(0, slot, x.reshape(G * n, 1, d).expand(
        G * n, K, d).reshape(G * n * K, d))
    buf = buf[:E * rows].view(E, rows, d)

    # the gated expert FFN, in x's dtype
    h = act(torch.bmm(buf, params["gate"].to(x.dtype))) * torch.bmm(
        buf, params["up"].to(x.dtype))
    out = torch.bmm(h, params["down"].to(x.dtype)).view(E * rows, d)

    # back to (token, k), dropped pairs zero; combine in x's dtype
    out = torch.cat([out, out.new_zeros((1, d))])
    y = (out[slot].view(G, n, K, d)
         * top_w.to(x.dtype)[..., None]).sum(dim=2)
    return y.reshape(shape), aux
