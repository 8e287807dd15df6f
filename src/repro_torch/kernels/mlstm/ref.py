"""Plain PyTorch versions of the chunkwise mLSTM (K6).

* :func:`mlstm_ref` -- the step-by-step oracle,
  ``repro/kernels/mlstm/ref.py:mlstm_ref``: one head, zero state, the
  exact stabilized recurrence one token at a time;
* :func:`mlstm_chunk_plain` -- the chunkwise form the kernel computes,
  ``repro/models/layers/xlstm.py:mlstm_chunk`` over (B, S, H): within a
  chunk an (L, L) gate-decay matrix times ``q k^T``, across chunks the
  carried (C, n, m) state. Where the reference shrinks the chunk until it
  divides S (to L = 1 for an odd S), a ragged last chunk is padded here
  with i = -inf, f = 0 and zero q, k, v: such a row adds nothing to the
  state and changes no real row, so h and the final state are the same
  function of the real tokens.

Both compute in float32 (a bfloat16 q, k or v is exact in float32).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

NEG_INF = float("-inf")


def mlstm_ref(q, k, v, i_raw, f_log):
    """q, k: (S, dk); v: (S, dv); i_raw, f_log: (S,). Returns h (S, dv)."""
    q, k, v, i_raw, f_log = (t.float() for t in (q, k, v, i_raw, f_log))
    C = q.new_zeros((q.shape[1], v.shape[1]))
    n = q.new_zeros((q.shape[1],))
    m = q.new_zeros(())
    hs = []
    for t in range(q.shape[0]):
        m_new = torch.maximum(f_log[t] + m, i_raw[t])
        wf = torch.exp(f_log[t] + m - m_new)
        wi = torch.exp(i_raw[t] - m_new)
        C = wf * C + wi * torch.outer(k[t], v[t])
        n = wf * n + wi * k[t]
        den = torch.maximum(torch.abs(q[t] @ n), torch.exp(-m_new))
        hs.append(q[t] @ C / den)
        m = m_new
    return torch.stack(hs)


def zero_state(B, H, dk, dv, device):
    """The (C, n, m) every caller starts from."""
    return (torch.zeros((B, H, dk, dv), dtype=torch.float32, device=device),
            torch.zeros((B, H, dk), dtype=torch.float32, device=device),
            torch.zeros((B, H), dtype=torch.float32, device=device))


def mlstm_chunk_plain(q, k, v, i_raw, f_log, state=None, *, chunk: int = 64):
    """q, k: (B, S, H, dk); v: (B, S, H, dv); i_raw, f_log: (B, S, H);
    state: (C (B, H, dk, dv), n (B, H, dk), m (B, H)) float32, zeros when
    None. Returns (h (B, S, H, dv), (C, n, m)). h is float32 for float32 or
    bfloat16 inputs, as the kernel returns it: the one caller with bf16 q,
    k, v is the served model's prefill (``models/layers/xlstm.py``), which
    passes them uncast; float64 inputs keep float64."""
    B, S, H, dk = q.shape
    dv = v.shape[-1]
    C, n, m = state if state is not None else zero_state(B, H, dk, dv,
                                                         q.device)
    L = min(chunk, S)
    nc = -(-S // L)
    pad = nc * L - S

    def chunks(t, value=0.0):
        t = t.float()
        if pad:
            t = F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad), value=value)
        return t.reshape((B, nc, L) + t.shape[2:])

    qs, ks, vs = chunks(q), chunks(k), chunks(v)
    is_, fs = chunks(i_raw, NEG_INF), chunks(f_log)
    causal = torch.ones((L, L), dtype=torch.bool, device=q.device).tril()
    hs = []
    for c in range(nc):
        qi, ki, vi, ii = qs[:, c], ks[:, c], vs[:, c], is_[:, c]
        b = torch.cumsum(fs[:, c], dim=1)                     # (B, L, H)
        a_max = torch.cummax(ii - b, dim=1).values
        m_t = torch.maximum(m[:, None] + b, b + a_max)
        w0 = torch.exp(m[:, None] + b - m_t)
        h_inter = torch.einsum("blhd,bhde->blhe", qi, C) * w0[..., None]
        d_inter = torch.einsum("blhd,bhd->blh", qi, n) * w0
        Dlog = b[:, :, None] - b[:, None, :] + ii[:, None, :, :]
        Dlog = torch.where(causal[None, :, :, None], Dlog - m_t[:, :, None],
                           NEG_INF)
        scores = torch.einsum("blhd,bshd->blsh", qi, ki) * torch.exp(Dlog)
        h_intra = torch.einsum("blsh,bshd->blhd", scores, vi)
        denom = torch.maximum(torch.abs(d_inter + scores.sum(dim=2)),
                              torch.exp(-m_t))
        hs.append((h_inter + h_intra) / denom[..., None])
        Fc = b[:, -1]
        m_new = torch.maximum(m + Fc, Fc + a_max[:, -1])
        wC0 = torch.exp(m + Fc - m_new)
        kw = ki * torch.exp(Fc[:, None] - b + ii - m_new[:, None])[..., None]
        C = C * wC0[..., None, None] + torch.einsum("blhd,blhe->bhde", kw, vi)
        n = n * wC0[..., None] + kw.sum(dim=1)
        m = m_new
    h = torch.cat(hs, dim=1)[:, :S]
    return h.to(torch.promote_types(q.dtype, torch.float32)), (C, n, m)
