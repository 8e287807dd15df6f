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


def mlstm_chunk_bwd_plain(q, k, v, i_raw, f_log, dh, state=None, *,
                          chunk: int = 64):
    """The backward of :func:`mlstm_chunk_plain` at the chunk level: the
    plain version and oracle of K6's backward kernel (``csrc/mlstm_bwd.cu``,
    which computes the same function over all pairs of tokens in
    512-token blocks).

    dh: (B, S, H, dv), the cotangent of h; the final state's is taken as
    zero (training reads h only). Returns (dq, dk, dv, d i_raw, d f_log)
    in the inputs' dtypes and, when ``state`` is given, (dC0, dn0, dm0)
    of the initial one (else None).

    * The states are recomputed: the forward's gate pass and state walk
      give every chunk's start (C, n) and the per-token m. The chunks are
      then walked in reverse, carrying (dC, dn).
    * The stabilizer m is held constant. h does not depend on it: m
      cancels between the numerator and either branch of max(|q.n|,
      e^{-m}), whose test is |q.n_true| >= 1. So holding every m fixed
      gives the exact gradient; autograd of the forward carries only
      rounding through m.
    * The scale of a chunk's start state: with Phi_c = <C_c, dC_c> + <n_c,
      dn_c>, the gradient of F = b_{L-1} (through e^{m0+F-m'} and every
      e^{F-b_s+i_s-m'}) is Phi_{c+1}, and Phi_c = Phi_{c+1} - sum_s wk_s
      dwk_s + sum_t w0_t dw0_t, from Phi_nc = 0. So no state is read in the
      reverse walk, and dm0 = Phi_0 (the true initial state is e^{m0}
      times the stabilized one).
    * A ragged last chunk is padded as the forward pads it: i = -inf,
      f = 0 and zero q, k, v, dh rows, which add nothing.

    Float32 throughout, as the forward (a bf16 q, k or v is exact in it).
    """
    B, S, H, dk = q.shape
    dv = v.shape[-1]
    dev = q.device
    C, n, m = (zero_state(B, H, dk, dv, dev) if state is None
               else tuple(t.float() for t in state))
    L = min(chunk, S)
    nc = -(-S // L)
    pad = nc * L - S

    def chunks(t, value=0.0):
        t = t.float()
        if pad:
            t = F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad), value=value)
        return t.reshape((B, nc, L) + t.shape[2:])

    qs, ks, vs, gs = chunks(q), chunks(k), chunks(v), chunks(dh)
    is_, fs = chunks(i_raw, NEG_INF), chunks(f_log)
    causal = torch.ones((L, L), dtype=torch.bool, device=dev).tril()

    # the forward's gates and state walk, each chunk's start state kept
    walk = []
    for c in range(nc):
        ki, ii = ks[:, c], is_[:, c]
        b = torch.cumsum(fs[:, c], dim=1)                     # (B, L, H)
        a_max = torch.cummax(ii - b, dim=1).values
        m_t = torch.maximum(m[:, None] + b, b + a_max)
        w0 = torch.exp(m[:, None] + b - m_t)
        Fc = b[:, -1]
        m_new = torch.maximum(m + Fc, Fc + a_max[:, -1])
        wC0 = torch.exp(m + Fc - m_new)
        wk = torch.exp(Fc[:, None] - b + ii - m_new[:, None])
        walk.append((C, n, b, m_t, w0, wk, wC0))
        if c + 1 < nc:
            kw = ki * wk[..., None]
            C = C * wC0[..., None, None] + torch.einsum("blhd,blhe->bhde",
                                                        kw, vs[:, c])
            n = n * wC0[..., None] + kw.sum(dim=1)
            m = m_new

    dC, dn = torch.zeros_like(C), torch.zeros_like(n)
    phi = torch.zeros_like(m)                                   # (B, H)
    grads = [[None] * nc for _ in range(5)]
    for c in reversed(range(nc)):
        C0, n0, b, m_t, w0, wk, wC0 = walk[c]
        qi, ki, vi, gi, ii = qs[:, c], ks[:, c], vs[:, c], gs[:, c], is_[:, c]
        Dlog = b[:, :, None] - b[:, None, :] + ii[:, None, :, :]
        Dlog = torch.where(causal[None, :, :, None], Dlog - m_t[:, :, None],
                           NEG_INF)
        D = torch.exp(Dlog)                                   # (B, t, s, H)
        S_ = torch.einsum("blhd,bshd->blsh", qi, ki) * D
        qn = torch.einsum("blhd,bhd->blh", qi, n0)
        d = w0 * qn + S_.sum(dim=2)
        den = torch.maximum(d.abs(), torch.exp(-m_t))
        # C0 g_t, whose q-dot gives both g.(w0 q C0) and q.(C0 dnum)
        Y = torch.einsum("blhe,bhde->blhd", gi, C0)
        z = (qi * Y).sum(dim=-1)
        Gr = torch.einsum("blhe,bshe->blsh", gi, vi)          # g_t . v_s
        gnum = w0 * z + (S_ * Gr).sum(dim=2)                  # g_t . num_t
        dd = torch.where(d.abs() >= torch.exp(-m_t),
                         torch.sign(d) * (-gnum / den ** 2), 0.0)
        dw0 = z / den + qn * dd
        dS = torch.where(causal[None, :, :, None],
                         Gr / den[:, :, None] + dd[:, :, None], 0.0)
        dP = dS * D
        E = dS * S_                                # the gradient of log D
        # the carried (dC, dn) are the end state's: the update's terms
        U = torch.einsum("blhe,bhde->blhd", vi, dC)           # dC v_s + dn
        W = torch.einsum("blhd,bhde->blhe", ki, dC)           # dC^T k_s
        U = U + dn[:, None]                       # the update's dk / wk
        dwk = (ki * U).sum(dim=-1)
        r1, r2 = w0 / den, w0 * dd
        grads[0][c] = (r1[..., None] * Y + r2[..., None] * n0[:, None]
                       + torch.einsum("blsh,bshd->blhd", dP, ki))
        grads[1][c] = (torch.einsum("blsh,blhd->bshd", dP, qi)
                       + wk[..., None] * U)
        grads[2][c] = (torch.einsum("blsh,blhe->bshe", S_ / den[:, :, None],
                                    gi) + wk[..., None] * W)
        grads[3][c] = E.sum(dim=1) + wk * dwk
        db = E.sum(dim=2) - E.sum(dim=1) + w0 * dw0 - wk * dwk
        db[:, -1] = db[:, -1] + phi                           # dF
        grads[4][c] = torch.flip(torch.cumsum(torch.flip(db, (1,)), dim=1),
                                 (1,))
        phi = phi - (wk * dwk).sum(dim=1) + (w0 * dw0).sum(dim=1)
        dC = dC * wC0[..., None, None] + torch.einsum(
            "blhd,blhe->bhde", qi * r1[..., None], gi)
        dn = dn * wC0[..., None] + torch.einsum("blhd,blh->bhd", qi, r2)
    out = tuple(torch.cat(g, dim=1)[:, :S].to(x.dtype) for g, x in
                zip(grads, (q, k, v, i_raw, f_log)))
    return out + (None if state is None else (dC, dn, phi),)
