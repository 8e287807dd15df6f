"""LACE, the logit-adjusted cross-entropy at the split boundary, without
materializing the (tokens, V) logits.

* :func:`lace2_grads` -- the fused dual-prior boundary: both SCALA
  losses (eq. 14 with the concatenated prior P_s, eq. 15 with the
  per-client priors P_k) and their gradients from one ``feats @ w_head``
  product; the engine's ``boundary="fused"``. On CUDA: K1 then K2.
* :func:`lace_loss` / :func:`lace_nll_sum` / :func:`lace_loss_flat` --
  one adjusted loss (weighted mean, or raw weighted sum) as a
  ``torch.autograd.Function``; the engine's ``boundary="dual"`` takes two,
  one per prior. On CUDA: K4 forward (saving the log-sum-exp), K5
  backward, whose dW pass is skipped when ``w_head`` needs no gradient.
* :func:`lace2_loss` / :func:`lace2_nll_sum` -- both adjusted losses
  (means or raw sums) as one ``torch.autograd.Function``, whose backward
  folds both cotangents into one df and one dW. On CUDA: K1 forward, one
  K2 backward over the tokens stacked twice (once per side's prior and
  cotangent scale), so K2's server-side dW is the folded one.
* :func:`lace_loss_dp` / :func:`lace2_grads_dp` -- the same over a
  :class:`repro_torch.sharding.Grid`: each rank takes raw sums over its
  own tokens, one scalar all_reduce gives the losses and the weight
  denominator, and the head gradient is all_reduced once.

A CPU tensor gets the plain chunked version -- the reference's
``repro/kernels/lace/ops.py`` on torch ops: the token axis scanned in
chunks of ``chunk``, padded with zero-weight tokens to a chunk multiple,
so no more than (G, chunk, V) logits are live. The fused and the
single-prior plain versions share their per-chunk ops, so on the CPU
``boundary="fused"`` and ``"dual"`` agree bitwise in float32. A CUDA
tensor gets the kernels (:mod:`repro_torch.kernels.lace.kernel`) or an
exception, never the plain version. ``LAUNCHES_FWD`` / ``LAUNCHES_BWD``
count K1 / K2 launches, ``LAUNCHES_FWD1`` / ``LAUNCHES_BWD1`` K4 / K5.

Shapes: feats (G, N, d) -- G groups (SCALA clients), N tokens each;
w_head (d, V); labels / weights (G, N); prior_rows (K, V) with prior_ids
(G,) picking each group's row (None: row 0 for every group).

Dtypes: feats and w_head each float32 or bfloat16 (the bf16 compute
policy hands a bf16 head). The plain versions read w_head's float32
copy, as the reference's ops upcast per chunk; the kernels take a bf16
operand as one exact TF32 term. Values are float32, feature cotangents
come in feats' dtype and dW in w_head's: a bf16 head's gradient is the
float32 sum rounded to bf16 once.

A ``meta`` tensor gets the kernels' shape functions (outputs and, through
the autograd functions, gradients on ``meta``; no launch counted), as
:mod:`repro_torch.kernels.route` sets out, and every call charges its
kernels' :func:`work` to an active :class:`repro_torch.perf.count.
StepCount`.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.lace import kernel
from repro_torch.kernels.route import device_kind
from repro_torch.perf.count import kernel_site
from repro_torch.perf.roofline import Work

LAUNCHES_FWD = 0     # K1
LAUNCHES_BWD = 0     # K2
LAUNCHES_FWD1 = 0    # K4
LAUNCHES_BWD1 = 0    # K5
#: launches with ``mean=False`` (raw sums), a subset of the counts above
LAUNCHES_RAW = {"K1": 0, "K2": 0, "K4": 0, "K5": 0}


def work(name: str, M: int, d: int, V: int, feats_dtype, w_dtype, *,
         table_rows: int, id_arrays: int, want_dw: bool = True) -> Work:
    """The work of one LACE kernel call over M tokens of width d against
    a (d, V) head: its passes, each a 2 M d V product at the fastest
    tensor-core rate for its operands (bf16 x bf16 at the bf16 rate,
    anything with an f32 operand at TF32's) -- z = feats W; df = g W^T
    per side; dW = feats^T g (g is f32) -- and its bytes: feats, W, the
    int32 labels, ``id_arrays`` int32 per-token prior-row ids and
    ``table_rows`` float32 prior rows read, then

    * K1 (``lace2_fwd``): z; both sides' NLL and lse written;
    * K2 (``lace2_bwd``): z, df twice, dW; both lse and both token
      scales read, both df and dW written in float32;
    * K4 (``lace_fwd``): z; the NLL and lse written;
    * K5 (``lace_bwd``): z, df (and dW with ``want_dw``); the lse and the
      token scales read, df (and dW) written in float32."""
    f32 = torch.float32
    z, df, dw = (feats_dtype, w_dtype), (f32, w_dtype), (feats_dtype, f32)
    passes = {"K1": [z], "K2": [z, df, df, dw], "K4": [z],
              "K5": [z, df] + [dw] * want_dw}[name]
    el = lambda dt: torch.empty((), dtype=dt).element_size()  # noqa: E731
    nbytes = (el(feats_dtype) * M * d + el(w_dtype) * d * V
              + 4 * M * (1 + id_arrays) + 4 * table_rows * V)
    nbytes += {"K1": 16 * M, "K2": 16 * M + 4 * (2 * M * d + d * V),
               "K4": 8 * M,
               "K5": 8 * M + 4 * M * d + 4 * d * V * want_dw}[name]
    flops: dict = {}
    for a, b in passes:
        kind = "bf16" if a == b == torch.bfloat16 else "tf32"
        flops[kind] = flops.get(kind, 0) + 2 * M * d * V
    return Work(flops, nbytes)


def _shape_args(feats, w_head, sides):
    """:func:`work`'s arguments for a call on feats (G, N, d) and the
    ``sides`` ((prior_rows, prior_ids), ...) its prior tables come from."""
    G, N, d = feats.shape
    rows = sum(r.shape[0] for r, _ in sides if r is not None)
    ids = sum(r is not None and i is not None for r, i in sides)
    return (G * N, d, w_head.shape[1], feats.dtype, w_head.dtype, rows, ids)


def _work(name, args, want_dw=True):
    M, d, V, fd, wd, rows, ids = args
    return lambda: work(name, M, d, V, fd, wd, table_rows=rows,
                        id_arrays=ids, want_dw=want_dw)


def _pick_chunk(n: int, target: int) -> int:
    """The chunk along the token axis: ``min(n, target)``; a ragged tail
    is padded (:func:`_pad_tokens`), never a smaller chunk."""
    return min(n, target)


def _pad_tokens(c, feats, labels, weights):
    """Pad the token axis to a multiple of ``c`` with weight-0, label-0
    tokens, which add exactly zero to every sum and gradient. Returns
    (feats, labels, weights, n_orig) with ``weights`` materialized."""
    G, N, _ = feats.shape
    if weights is None:
        weights = torch.ones((G, N), dtype=torch.float32, device=feats.device)
    pad = (-N) % c
    if pad:
        feats = F.pad(feats, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad))
        weights = F.pad(weights, (0, pad))
    return feats, labels, weights, N


def _check_args(feats, w_head, labels, prior_rows, prior_ids, weights):
    """Shape validation: a group-axis mismatch (e.g. K-sized prior_ids
    against a cohort of feats) would otherwise broadcast silently."""
    if feats.dim() != 3:
        raise ValueError(f"feats must be (G, N, d), got {tuple(feats.shape)}")
    G, N, d = feats.shape
    if w_head.dim() != 2 or w_head.shape[0] != d:
        raise ValueError(f"w_head must be (d={d}, V), got "
                         f"{tuple(w_head.shape)}")
    if tuple(labels.shape) != (G, N):
        raise ValueError(f"labels must be (G, N)=({G}, {N}), got "
                         f"{tuple(labels.shape)}")
    if weights is not None and tuple(weights.shape) != (G, N):
        raise ValueError(f"weights must be (G, N)=({G}, {N}), got "
                         f"{tuple(weights.shape)}")
    if prior_ids is not None:
        if prior_rows is None:
            raise ValueError("prior_ids given without prior_rows")
        if tuple(prior_ids.shape) != (G,):
            raise ValueError(
                f"prior_ids must be (G,)=({G},), got "
                f"{tuple(prior_ids.shape)} -- gathered-group callers must "
                "gather the prior ids (or rows) alongside the feats")
    if prior_rows is not None and prior_rows.shape[-1] != w_head.shape[1]:
        raise ValueError(f"prior_rows vocab dim {prior_rows.shape[-1]} != "
                         f"head vocab dim {w_head.shape[1]}")


def _check_args2(feats, w_head, labels, prior_rows_s, prior_ids_s,
                 prior_rows_k, prior_ids_k, weights):
    _check_args(feats, w_head, labels, prior_rows_s, prior_ids_s, weights)
    _check_args(feats, w_head, labels, prior_rows_k, prior_ids_k, weights)


def _log_prior(prior_rows, eps):
    return torch.log(prior_rows.float() + eps)


def _prep(feats, prior_rows, prior_ids, weights, eps):
    """(weights, per-group log prior (G, 1, V) or None)."""
    G = feats.shape[0]
    if weights is None:
        weights = torch.ones(feats.shape[:2], dtype=torch.float32,
                             device=feats.device)
    if prior_rows is None:
        return weights, None
    lp_rows = _log_prior(prior_rows, eps)
    lp = (lp_rows[:1].expand(G, -1) if prior_ids is None
          else lp_rows[prior_ids.long()])
    return weights, lp[:, None, :]


def _nll_stats(z, l_c):
    """(nll, exp(z - max), sumexp, label index) of one side's adjusted
    logits z (G, c, V), in the reference's op order: max shift, exp, sum,
    log."""
    m = z.amax(dim=-1, keepdim=True)
    ez = torch.exp(z - m)
    se = ez.sum(dim=-1)
    lse = torch.log(se) + m[..., 0]
    idx = l_c.long()[..., None]
    nll = lse - z.gather(-1, idx)[..., 0]
    return nll, ez, se, idx


def _side_stats(z, l_c):
    """(nll, softmax - onehot) of one side's adjusted logits z (G, c, V)."""
    nll, ez, se, idx = _nll_stats(z, l_c)
    g = ez / se[..., None]
    g.scatter_add_(-1, idx, torch.full_like(idx, -1, dtype=g.dtype))
    return nll, g


def _w_sum(w, c):
    """The weight sum, chunk-ordered as the reference scans it."""
    w_sum = torch.zeros((), dtype=torch.float32, device=w.device)
    for i in range(0, w.shape[1], c):
        w_sum = w_sum + w[:, i:i + c].sum()
    return w_sum


@torch.no_grad()
def lace2_grads_plain(feats, w_head, labels, prior_rows_s, prior_ids_s,
                      prior_rows_k, prior_ids_k, weights, tau, eps, chunk,
                      mean, scale):
    """The plain version of :func:`lace2_grads` on torch ops, on any
    device: what a CPU tensor gets, and the kernels' yardstick."""
    G, N0, d = feats.shape
    V = w_head.shape[1]
    c = _pick_chunk(N0, chunk)
    feats_p, labels_p, weights_p, _ = _pad_tokens(c, feats, labels, weights)
    N = feats_p.shape[1]
    w, lp_s = _prep(feats_p, prior_rows_s, prior_ids_s, weights_p, eps)
    _, lp_k = _prep(feats_p, prior_rows_k, prior_ids_k, weights_p, eps)
    chunks = range(0, N, c)
    w_sum = _w_sum(w, c)
    if scale is None:
        one = torch.ones((), dtype=torch.float32, device=feats.device)
        scale = one / torch.clamp(w_sum, min=1e-8) if mean else one
    w32 = w_head.float()
    nll_s_sum = torch.zeros((), dtype=torch.float32, device=feats.device)
    nll_k_sum = nll_s_sum.clone()
    dw = torch.zeros((d, V), dtype=torch.float32, device=feats.device)
    df_s, df_k = [], []
    for i in chunks:
        f_c = feats_p[:, i:i + c].float()
        l_c = labels_p[:, i:i + c]
        w_c = w[:, i:i + c]
        z = f_c @ w32                            # ONE product per chunk
        nll_s, g_s = _side_stats(z if lp_s is None else z + tau * lp_s, l_c)
        nll_k, g_k = _side_stats(z if lp_k is None else z + tau * lp_k, l_c)
        g_s = g_s * (w_c * scale)[..., None]
        g_k = g_k * (w_c * scale)[..., None]
        df_s.append(g_s @ w32.T)
        df_k.append(g_k @ w32.T)
        dw = dw + torch.einsum("gcd,gcv->dv", f_c, g_s)
        nll_s_sum = nll_s_sum + (nll_s * w_c).sum()
        nll_k_sum = nll_k_sum + (nll_k * w_c).sum()
    unchunk = lambda parts: torch.cat(parts, 1)[:, :N0].to(feats.dtype)
    if mean:
        den = torch.clamp(w_sum, min=1e-8)
        out_s, out_k = nll_s_sum / den, nll_k_sum / den
    else:
        out_s, out_k = nll_s_sum, nll_k_sum
    return (out_s, out_k, unchunk(df_s), unchunk(df_k),
            dw.to(w_head.dtype), w_sum)


def _side_table(prior_rows, prior_ids, tau, eps, G, N):
    """A side's (rows, V) table of tau * log(P + eps) and its per-token
    row ids (None: row 0), for the kernels."""
    if prior_rows is None:
        return None, None
    adj = (tau * _log_prior(prior_rows, eps)).contiguous()
    if prior_ids is None:
        return adj, None
    return adj, prior_ids.to(torch.int32).repeat_interleave(N).contiguous()


def _lace2_grads_cuda(feats, w_head, labels, prior_rows_s, prior_ids_s,
                      prior_rows_k, prior_ids_k, weights, tau, eps, mean,
                      scale):
    global LAUNCHES_FWD, LAUNCHES_BWD
    G, N, d = feats.shape
    f2 = feats.reshape(G * N, d)
    lab = labels.reshape(-1).to(torch.int32).contiguous()
    w = (torch.ones(G * N, dtype=torch.float32, device=feats.device)
         if weights is None else weights.reshape(-1).float())
    adj_s, ids_s = _side_table(prior_rows_s, prior_ids_s, tau, eps, G, N)
    adj_k, ids_k = _side_table(prior_rows_k, prior_ids_k, tau, eps, G, N)
    w_sum = w.sum()
    if scale is None:
        one = torch.ones((), dtype=torch.float32, device=feats.device)
        scale = one / torch.clamp(w_sum, min=1e-8) if mean else one
    nll_s, nll_k, lse_s, lse_k = kernel.lace2_fwd_cuda(
        f2, w_head, lab, adj_s, ids_s, adj_k, ids_k)
    LAUNCHES_FWD += 1
    ts = (w * scale).contiguous()
    df_s, df_k, dw = kernel.lace2_bwd_cuda(f2, w_head, lab, adj_s, ids_s,
                                           adj_k, ids_k, lse_s, lse_k, ts,
                                           ts)
    LAUNCHES_BWD += 1
    if not mean:
        LAUNCHES_RAW["K1"] += 1
        LAUNCHES_RAW["K2"] += 1
    out_s, out_k = (nll_s * w).sum(), (nll_k * w).sum()
    if mean:
        den = torch.clamp(w_sum, min=1e-8)
        out_s, out_k = out_s / den, out_k / den
    return (out_s, out_k, df_s.view(G, N, d).to(feats.dtype),
            df_k.view(G, N, d).to(feats.dtype), dw.to(w_head.dtype), w_sum)


@torch.no_grad()
def lace2_grads(feats, w_head, labels, prior_rows_s, prior_ids_s,
                prior_rows_k, prior_ids_k, weights,
                tau: float = 1.0, eps: float = 1e-8, chunk: int = 4096,
                mean: bool = True, scale: Optional[torch.Tensor] = None):
    """Values and gradients of the split boundary in one pass.

    Returns ``(out_s, out_k, df_s, df_k, dw_s, w_sum)``: the eq. 14 /
    eq. 15 losses (weighted means, or raw weighted sums with
    ``mean=False``), d out_side / d feats (in feats' dtype), d out_s /
    d w_head (server side only; in w_head's dtype) and the weight sum.
    With ``mean=True`` the per-token scale is ``1 / max(w_sum, 1e-8)``;
    ``scale`` overrides it for both sides. Either prior may be None
    (plain CE on that side). ``chunk`` bounds the plain version's live
    logits; the kernels tile on their own.
    """
    _check_args2(feats, w_head, labels, prior_rows_s, prior_ids_s,
                 prior_rows_k, prior_ids_k, weights)
    kind = device_kind("lace2_grads", (feats, w_head, labels))
    args = _shape_args(feats, w_head, ((prior_rows_s, prior_ids_s),
                                       (prior_rows_k, prior_ids_k)))
    k1, k2 = _work("K1", args), _work("K2", args)
    with kernel_site("K1+K2", lambda: k1() + k2()):
        if kind == "cpu":
            return lace2_grads_plain(feats, w_head, labels, prior_rows_s,
                                      prior_ids_s, prior_rows_k, prior_ids_k,
                                      weights, tau, eps, chunk, mean, scale)
        if kind == "meta":
            scalar = lambda: feats.new_empty((), dtype=torch.float32)  # noqa
            return (scalar(), scalar(), feats.new_empty(feats.shape),
                    feats.new_empty(feats.shape),
                    w_head.new_empty(w_head.shape), scalar())
        return _lace2_grads_cuda(feats, w_head, labels, prior_rows_s,
                                 prior_ids_s, prior_rows_k, prior_ids_k,
                                 weights, tau, eps, mean, scale)


# ---------------------------------------------------------------------------
# one adjusted loss per call: the dual boundary (K4 forward, K5 backward)
# ---------------------------------------------------------------------------


def _fwd_plain(feats, w_head, labels, prior_rows, prior_ids, weights, tau,
               eps, chunk):
    """The reference's ``_fwd_impl`` on torch ops: (weighted NLL sum,
    weight sum), both scanned chunk by chunk."""
    c = _pick_chunk(feats.shape[1], chunk)
    feats_p, labels_p, weights_p, _ = _pad_tokens(c, feats, labels, weights)
    w, lp = _prep(feats_p, prior_rows, prior_ids, weights_p, eps)
    w32 = w_head.float()
    nll_sum = torch.zeros((), dtype=torch.float32, device=feats.device)
    for i in range(0, feats_p.shape[1], c):
        z = feats_p[:, i:i + c].float() @ w32
        nll, _, _, _ = _nll_stats(z if lp is None else z + tau * lp,
                                  labels_p[:, i:i + c])
        nll_sum = nll_sum + (nll * w[:, i:i + c]).sum()
    return nll_sum, _w_sum(w, c)


def _bwd_plain(feats, w_head, labels, prior_rows, prior_ids, weights, tau,
               eps, chunk, scale, want_dw):
    """The reference's ``_bwd_impl`` on torch ops: d(loss)/d feats (in
    feats' dtype) and d(loss)/d w_head (in w_head's dtype, or None),
    every token's cotangent scaled by ``weight * scale``."""
    G, N0, d = feats.shape
    c = _pick_chunk(N0, chunk)
    feats_p, labels_p, weights_p, _ = _pad_tokens(c, feats, labels, weights)
    w, lp = _prep(feats_p, prior_rows, prior_ids, weights_p, eps)
    w32 = w_head.float()
    dw = (torch.zeros(w32.shape, dtype=torch.float32, device=feats.device)
          if want_dw else None)
    df = []
    for i in range(0, feats_p.shape[1], c):
        f_c = feats_p[:, i:i + c].float()
        z = f_c @ w32
        _, g = _side_stats(z if lp is None else z + tau * lp,
                           labels_p[:, i:i + c])
        g = g * (w[:, i:i + c] * scale)[..., None]
        df.append(g @ w32.T)
        if want_dw:
            dw = dw + torch.einsum("gcd,gcv->dv", f_c, g)
    dfeats = torch.cat(df, 1)[:, :N0].to(feats.dtype)
    return dfeats, None if dw is None else dw.to(w_head.dtype)


def _kernel_args(feats, labels, prior_rows, prior_ids, weights, tau, eps):
    """The kernels' flat arguments: feats (G*N, d), int32 labels, the
    weights (G*N,) float32 and the prior table with per-token row ids."""
    G, N, d = feats.shape
    f2 = feats.reshape(G * N, d)
    lab = labels.reshape(-1).to(torch.int32).contiguous()
    w = (torch.ones(G * N, dtype=torch.float32, device=feats.device)
         if weights is None else weights.reshape(-1).float().contiguous())
    adj, ids = _side_table(prior_rows, prior_ids, tau, eps, G, N)
    return f2, lab, w, adj, ids


class _LaceLoss(torch.autograd.Function):
    """The weighted mean (``mean``) or sum of one side's adjusted NLLs;
    gradients for feats and w_head."""

    @staticmethod
    def forward(ctx, feats, w_head, labels, prior_rows, prior_ids, weights,
                tau, eps, chunk, mean):
        global LAUNCHES_FWD1
        ctx.conf = (tau, eps, chunk, mean)
        ctx.shape = _shape_args(feats, w_head, ((prior_rows, prior_ids),))
        kind = feats.device.type
        with kernel_site("K4", _work("K4", ctx.shape)):
            if kind == "cpu":
                nll_sum, w_sum = _fwd_plain(feats, w_head, labels,
                                            prior_rows, prior_ids, weights,
                                            tau, eps, chunk)
            elif kind == "meta":
                nll_sum, w_sum = (feats.new_empty((), dtype=torch.float32)
                                  for _ in range(2))
            else:
                f2, lab, w, adj, ids = _kernel_args(
                    feats, labels, prior_rows, prior_ids, weights, tau, eps)
                nll, lse = kernel.lace_fwd_cuda(f2, w_head, lab, adj, ids)
                LAUNCHES_FWD1 += 1
                LAUNCHES_RAW["K4"] += not mean
                nll_sum, w_sum = (nll * w).sum(), w.sum()
                ctx.save_for_backward(feats, w_head, lab, adj, ids, w,
                                      w_sum, lse)
        if kind != "cuda":
            ctx.save_for_backward(feats, w_head, labels, prior_rows,
                                  prior_ids, weights, w_sum)
        return nll_sum / torch.clamp(w_sum, min=1e-8) if mean else nll_sum

    @staticmethod
    def backward(ctx, g):
        global LAUNCHES_BWD1
        tau, eps, chunk, mean = ctx.conf
        saved = ctx.saved_tensors
        w_sum = saved[6]
        scale = g / torch.clamp(w_sum, min=1e-8) if mean else g
        want_dw = ctx.needs_input_grad[1]
        feats, w_head = saved[0], saved[1]
        kind = feats.device.type
        with kernel_site("K5", _work("K5", ctx.shape, want_dw)):
            if kind == "cpu":
                _, _, labels, prior_rows, prior_ids, weights, _ = saved
                df, dw = _bwd_plain(feats, w_head, labels, prior_rows,
                                    prior_ids, weights, tau, eps, chunk,
                                    scale, want_dw)
            elif kind == "meta":
                df = feats.new_empty(feats.shape)
                dw = w_head.new_empty(w_head.shape) if want_dw else None
            else:
                _, _, lab, adj, ids, w, _, lse = saved
                G, N, d = feats.shape
                df, dw = kernel.lace_bwd_cuda(
                    feats.reshape(G * N, d), w_head, lab, adj, ids, lse,
                    (w * scale).contiguous(), want_dw)
                LAUNCHES_BWD1 += 1
                LAUNCHES_RAW["K5"] += not mean
                df = df.view(G, N, d).to(feats.dtype)
                dw = None if dw is None else dw.to(w_head.dtype)
        return df, dw, None, None, None, None, None, None, None, None


def _lace(feats, w_head, labels, prior_rows, prior_ids, weights, tau, eps,
          chunk, mean):
    _check_args(feats, w_head, labels, prior_rows, prior_ids, weights)
    device_kind("lace_loss", (feats, w_head, labels))
    return _LaceLoss.apply(feats, w_head, labels, prior_rows, prior_ids,
                           weights, tau, eps, chunk, mean)


def lace_loss(feats, w_head, labels, prior_rows, prior_ids, weights,
              tau: float = 1.0, eps: float = 1e-8, chunk: int = 4096):
    """The weighted-mean adjusted NLL of (G, N) tokens, differentiable
    in ``feats`` and ``w_head`` (float32 scalar)."""
    return _lace(feats, w_head, labels, prior_rows, prior_ids, weights,
                 tau, eps, chunk, True)


def lace_nll_sum(feats, w_head, labels, prior_rows, prior_ids, weights,
                 tau: float = 1.0, eps: float = 1e-8, chunk: int = 4096):
    """The weighted *sum* of adjusted NLLs (no normalization)."""
    return _lace(feats, w_head, labels, prior_rows, prior_ids, weights,
                 tau, eps, chunk, False)


def lace_loss_flat(feats, w_head, labels, *, prior_rows=None,
                   prior_ids=None, weights=None, tau: float = 1.0,
                   eps: float = 1e-8, chunk: int = 4096):
    """:func:`lace_loss` of one group: feats (N, d), labels (N,), weights
    (N,) or None, prior_ids a scalar row id or None."""
    return lace_loss(feats[None], w_head, labels[None], prior_rows,
                     None if prior_ids is None else prior_ids[None],
                     None if weights is None else weights[None], tau, eps,
                     chunk)


# ---------------------------------------------------------------------------
# both adjusted losses from one pass, differentiable: the pair ops
# ---------------------------------------------------------------------------


def _fwd2_plain(feats, w_head, labels, prior_rows_s, prior_ids_s,
                prior_rows_k, prior_ids_k, weights, tau, eps, chunk):
    """Both sides' weighted NLL sums and the weight sum, one product per
    chunk (the reference's ``_fwd2_impl`` on torch ops)."""
    c = _pick_chunk(feats.shape[1], chunk)
    feats_p, labels_p, weights_p, _ = _pad_tokens(c, feats, labels, weights)
    w, lp_s = _prep(feats_p, prior_rows_s, prior_ids_s, weights_p, eps)
    _, lp_k = _prep(feats_p, prior_rows_k, prior_ids_k, weights_p, eps)
    w32 = w_head.float()
    sums = [torch.zeros((), dtype=torch.float32, device=feats.device)
            for _ in range(2)]
    for i in range(0, feats_p.shape[1], c):
        z = feats_p[:, i:i + c].float() @ w32
        for j, lp in enumerate((lp_s, lp_k)):
            nll, _, _, _ = _nll_stats(z if lp is None else z + tau * lp,
                                      labels_p[:, i:i + c])
            sums[j] = sums[j] + (nll * w[:, i:i + c]).sum()
    return sums[0], sums[1], _w_sum(w, c)


def _bwd2_plain(feats, w_head, labels, prior_rows_s, prior_ids_s,
                prior_rows_k, prior_ids_k, weights, tau, eps, chunk, scale_s,
                scale_k, want_dw):
    """The folded backward (the reference's ``_bwd2_impl``): every token's
    cotangent row ``(p_s - onehot) w scale_s + (p_k - onehot) w scale_k``
    through one df and one dW product per chunk."""
    G, N0, d = feats.shape
    c = _pick_chunk(N0, chunk)
    feats_p, labels_p, weights_p, _ = _pad_tokens(c, feats, labels, weights)
    w, lp_s = _prep(feats_p, prior_rows_s, prior_ids_s, weights_p, eps)
    _, lp_k = _prep(feats_p, prior_rows_k, prior_ids_k, weights_p, eps)
    w32 = w_head.float()
    dw = (torch.zeros(w32.shape, dtype=torch.float32, device=feats.device)
          if want_dw else None)
    df = []
    for i in range(0, feats_p.shape[1], c):
        f_c = feats_p[:, i:i + c].float()
        l_c, w_c = labels_p[:, i:i + c], w[:, i:i + c]
        z = f_c @ w32
        _, g_s = _side_stats(z if lp_s is None else z + tau * lp_s, l_c)
        _, g_k = _side_stats(z if lp_k is None else z + tau * lp_k, l_c)
        gi = (g_s * (w_c * scale_s)[..., None]
              + g_k * (w_c * scale_k)[..., None])
        df.append(gi @ w32.T)
        if want_dw:
            dw = dw + torch.einsum("gcd,gcv->dv", f_c, gi)
    dfeats = torch.cat(df, 1)[:, :N0].to(feats.dtype)
    return dfeats, None if dw is None else dw.to(w_head.dtype)


def _stacked_sides(adj_s, ids_s, adj_k, ids_k, M, V, device):
    """One prior table for the tokens stacked twice: the first M rows
    read side s's table, the next M side k's (a side with no prior reads
    a zero row, and z + 0 is z)."""
    tables, ids, base = [], [], 0
    for adj, row_ids in ((adj_s, ids_s), (adj_k, ids_k)):
        if adj is None:
            adj = torch.zeros((1, V), dtype=torch.float32, device=device)
        tables.append(adj)
        ids.append(base + (torch.zeros(M, dtype=torch.int32, device=device)
                           if row_ids is None else row_ids))
        base += adj.shape[0]
    return torch.cat(tables).contiguous(), torch.cat(ids).contiguous()


class _Lace2Loss(torch.autograd.Function):
    """Both sides' weighted means (``mean``) or sums of adjusted NLLs;
    gradients for feats and w_head with the two cotangents folded."""

    @staticmethod
    def forward(ctx, feats, w_head, labels, prior_rows_s, prior_ids_s,
                prior_rows_k, prior_ids_k, weights, tau, eps, chunk, mean):
        global LAUNCHES_FWD
        ctx.conf = (tau, eps, chunk, mean)
        sides = ((prior_rows_s, prior_ids_s), (prior_rows_k, prior_ids_k))
        ctx.shape = _shape_args(feats, w_head, sides)
        ctx.rows2 = sum(1 if r is None else r.shape[0]
                        for r, _ in sides)
        kind = feats.device.type
        with kernel_site("K1", _work("K1", ctx.shape)):
            if kind == "cpu":
                out_s, out_k, w_sum = _fwd2_plain(
                    feats, w_head, labels, prior_rows_s, prior_ids_s,
                    prior_rows_k, prior_ids_k, weights, tau, eps, chunk)
            elif kind == "meta":
                out_s, out_k, w_sum = (
                    feats.new_empty((), dtype=torch.float32)
                    for _ in range(3))
            else:
                G, N, d = feats.shape
                f2, lab, w, adj_s, ids_s = _kernel_args(
                    feats, labels, prior_rows_s, prior_ids_s, weights, tau,
                    eps)
                adj_k, ids_k = _side_table(prior_rows_k, prior_ids_k, tau,
                                           eps, G, N)
                nll_s, nll_k, lse_s, lse_k = kernel.lace2_fwd_cuda(
                    f2, w_head, lab, adj_s, ids_s, adj_k, ids_k)
                LAUNCHES_FWD += 1
                LAUNCHES_RAW["K1"] += not mean
                out_s, out_k, w_sum = (nll_s * w).sum(), (nll_k * w).sum(), \
                    w.sum()
                ctx.sides = (adj_s, ids_s, adj_k, ids_k)
                ctx.save_for_backward(feats, w_head, lab, w, lse_s, lse_k,
                                      w_sum)
        if kind != "cuda":
            ctx.save_for_backward(feats, w_head, labels, prior_rows_s,
                                  prior_ids_s, prior_rows_k, prior_ids_k,
                                  weights, w_sum)
        if mean:
            den = torch.clamp(w_sum, min=1e-8)
            return out_s / den, out_k / den
        return out_s, out_k

    @staticmethod
    def backward(ctx, g_s, g_k):
        global LAUNCHES_BWD
        tau, eps, chunk, mean = ctx.conf
        saved = ctx.saved_tensors
        w_sum = saved[-1]
        den = torch.clamp(w_sum, min=1e-8)
        scale_s, scale_k = (g_s / den, g_k / den) if mean else (g_s, g_k)
        want_dw = ctx.needs_input_grad[1]
        feats, w_head = saved[0], saved[1]
        kind = feats.device.type
        # K2 runs on the tokens stacked twice against one table of both
        # sides' rows (a side without a prior reads one zero row), the
        # table and the ids passed for both of its sides
        M, d, V, fd, wd, _, _ = ctx.shape
        with kernel_site("K2", lambda: work(
                "K2", 2 * M, d, V, fd, wd, table_rows=2 * ctx.rows2,
                id_arrays=2)):
            if kind == "cpu":
                df, dw = _bwd2_plain(*saved[:8], tau, eps, chunk, scale_s,
                                     scale_k, want_dw)
            elif kind == "meta":
                df = feats.new_empty(feats.shape)
                dw = w_head.new_empty(w_head.shape) if want_dw else None
            else:
                _, _, lab, w, lse_s, lse_k, _ = saved
                G, N, d = feats.shape
                M, V = G * N, w_head.shape[1]
                f2 = feats.reshape(M, d)
                adj, ids = _stacked_sides(*ctx.sides, M, V, feats.device)
                ts = torch.cat([w * scale_s, w * scale_k]).contiguous()
                lse = torch.cat([lse_s, lse_k]).contiguous()
                # the k side of this call is the s side again at scale 0:
                # its df is zero and unused
                df2, _, dw = kernel.lace2_bwd_cuda(
                    torch.cat([f2, f2]), w_head, torch.cat([lab, lab]), adj,
                    ids, adj, ids, lse, lse, ts, torch.zeros_like(ts))
                LAUNCHES_BWD += 1
                LAUNCHES_RAW["K2"] += not mean
                df = (df2[:M] + df2[M:]).view(G, N, d).to(feats.dtype)
                dw = dw.to(w_head.dtype) if want_dw else None
        return (df, dw) + (None,) * 10


def _lace2(feats, w_head, labels, prior_rows_s, prior_ids_s, prior_rows_k,
           prior_ids_k, weights, tau, eps, chunk, mean):
    _check_args2(feats, w_head, labels, prior_rows_s, prior_ids_s,
                 prior_rows_k, prior_ids_k, weights)
    device_kind("lace2_loss", (feats, w_head, labels))
    return _Lace2Loss.apply(feats, w_head, labels, prior_rows_s, prior_ids_s,
                            prior_rows_k, prior_ids_k, weights, tau, eps,
                            chunk, mean)


def lace2_loss(feats, w_head, labels, prior_rows_s, prior_ids_s,
               prior_rows_k, prior_ids_k, weights, tau: float = 1.0,
               eps: float = 1e-8, chunk: int = 4096):
    """``(loss_s, loss_k)``: the eq. 14 (prior ``_s``) and eq. 15 (prior
    ``_k``) weighted-mean adjusted NLLs of the same tokens from one
    product per chunk, differentiable in ``feats`` and ``w_head``; the
    backward folds both cotangents into one df and one dW. Either prior
    may be None (plain CE on that side)."""
    return _lace2(feats, w_head, labels, prior_rows_s, prior_ids_s,
                  prior_rows_k, prior_ids_k, weights, tau, eps, chunk, True)


def lace2_nll_sum(feats, w_head, labels, prior_rows_s, prior_ids_s,
                  prior_rows_k, prior_ids_k, weights, tau: float = 1.0,
                  eps: float = 1e-8, chunk: int = 4096):
    """:func:`lace2_loss` as raw weighted sums (no normalization): the
    local pair a sharded caller combines."""
    return _lace2(feats, w_head, labels, prior_rows_s, prior_ids_s,
                  prior_rows_k, prior_ids_k, weights, tau, eps, chunk, False)


# ---------------------------------------------------------------------------
# over a grid of ranks: local raw sums, scalar all_reduces, one dW
# all_reduce (the reference's shard_map-wrapped ``*_dp`` ops)
# ---------------------------------------------------------------------------


class _GridSum(torch.autograd.Function):
    """A tensor summed over a grid group. Its backward passes the
    cotangent through unchanged: every rank's local term sees the global
    loss's cotangent (the transpose of a psum under a replicated
    cotangent)."""

    @staticmethod
    def forward(ctx, x, grid, group):
        return grid.all_reduce(x.detach().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _ReplicatedGrad(torch.autograd.Function):
    """The identity on a replicated weight whose gradient is the sum of
    every rank's partial: one all_reduce (in float32) in the backward."""

    @staticmethod
    def forward(ctx, w, grid, group):
        ctx.grid, ctx.group = grid, group
        return w.view_as(w)

    @staticmethod
    def backward(ctx, g):
        g32 = g.float().contiguous()
        ctx.grid.all_reduce(g32, ctx.group)
        return g32.to(g.dtype), None, None


def lace_loss_dp(feats, w_head, labels, prior_rows, prior_ids, weights,
                 tau: float = 1.0, eps: float = 1e-8, chunk: int = 4096,
                 grid=None, group: str = "all"):
    """:func:`lace_loss` over a :class:`repro_torch.sharding.Grid`: every
    input is this rank's block (feats (G_l, N_l, d) with its labels,
    weights and ``prior_ids`` into ``prior_rows``), ``w_head`` is
    replicated. The rank's :func:`lace_nll_sum` (K4 / K5 on a card) and
    weight sum are summed over ``group`` by one all_reduce each; the
    backward scales the local cotangents by the global ``1 / W`` and
    all_reduces the head gradient once. ``grid=None`` is the
    single-program :func:`lace_loss`."""
    if grid is None:
        return lace_loss(feats, w_head, labels, prior_rows, prior_ids,
                         weights, tau, eps, chunk)
    nll = lace_nll_sum(feats, _ReplicatedGrad.apply(w_head, grid, group),
                       labels, prior_rows, prior_ids, weights, tau, eps,
                       chunk)
    wsum = (weights.float().sum() if weights is not None else torch.tensor(
        float(labels.numel()), dtype=torch.float32, device=feats.device))
    den = torch.clamp(grid.all_reduce(wsum.reshape(1), group)[0], min=1e-8)
    return _GridSum.apply(nll, grid, group) / den


@torch.no_grad()
def lace2_grads_dp(feats, w_head, labels, prior_rows_s, prior_ids_s,
                   prior_rows_k, prior_ids_k, weights, tau: float = 1.0,
                   eps: float = 1e-8, chunk: int = 4096, grid=None,
                   group: str = "all"):
    """:func:`lace2_grads` over a grid: this rank's blocks in, the raw
    sums of :func:`lace2_grads` (``mean=False``: K1 / K2 on a card) out,
    the weight denominator and then both losses all_reduced as scalars,
    the unit-cotangent gradients rescaled to the global mean, dW_s
    all_reduced once (in float32). Returns ``(loss_s, loss_k, df_s,
    df_k, dw_s)``; df stays local. ``grid=None`` is the single-program
    op's first five outputs."""
    if grid is None:
        return lace2_grads(feats, w_head, labels, prior_rows_s, prior_ids_s,
                           prior_rows_k, prior_ids_k, weights, tau, eps,
                           chunk)[:5]
    nll_s, nll_k, df_s, df_k, dw_s, ws_l = lace2_grads(
        feats, w_head, labels, prior_rows_s, prior_ids_s, prior_rows_k,
        prior_ids_k, weights, tau, eps, chunk, mean=False)
    den = torch.clamp(grid.all_reduce(ws_l.float().reshape(1), group)[0],
                      min=1e-8)
    inv = torch.ones((), dtype=torch.float32, device=den.device) / den
    losses = grid.all_reduce(torch.stack([nll_s, nll_k]).float(), group)
    rescale = lambda a: (a.float() * inv).to(a.dtype)        # noqa: E731
    dw = grid.all_reduce(rescale(dw_s).float().contiguous(), group)
    return (losses[0] * inv, losses[1] * inv, rescale(df_s), rescale(df_k),
            dw.to(dw_s.dtype))
