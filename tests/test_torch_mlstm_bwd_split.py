"""K6 backward's split-TF32 route and summation order, emulated in numpy.

The Hopper kernel (``src/repro_torch/kernels/csrc/mlstm_bwd.cu``) takes
all pairs of tokens in blocks of LB: alpha_t = Bg_t - m_t and beta_s =
i_s - Bg_s in float64 (Bg the cumsum of f over the sequence, from the
gate pass's chunk-local sums and the chunks' totals), D_ts =
e^{alpha_t + beta_s}, the products P = Q K^T and G V^T, one token pass
over full rows, the products dq = (dS . D) K, dk = (dS . D)^T Q, dv = (S
/ den)^T G, and past one block (or from a given state) the state walk
between blocks. Every product runs on the tensor cores with TF32
operands (a bf16 operand one term, an f32 one hi + lo; per 8-deep step
hi.hi, then hi.lo, then lo.hi), each BK-deep stage a fresh chain whose
instructions round toward zero (``test_torch_mlstm_split.py`` models
them), added into an f32 accumulator; the token pass sums each lane's
columns l + 32 i in order and then across the warp's butterfly; the
column sums go by warp rows, then warps, then row blocks, in order; d f
is a reversed scan of 32 lanes at a time with a carry.

LB, RB, BK, CHAIN and KSTEP are read from the source. Held against a
float64 autograd of the all-pairs function at the served width (dk = dv
= 1024, S = 512, one block: every gradient within 1e-4 of its largest
entry, bf16 dq, dk, dv within 1e-4 + 2^-8, the kernel's tolerances), and
at small widths against ``jax.grad`` of the reference's
``xlstm.mlstm_chunk`` (the same bars), from the zero state and from a
constant one, in one block and past it (S > LB, a ragged last chunk).
"""
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.layers import xlstm as jxlstm
from test_torch_mlstm_split import F32, bf16, chain, fma, gates, planes, rel

SRC = (pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch"
       / "kernels" / "csrc" / "mlstm_bwd.cu")
CONST = dict((name, int(value)) for name, value in re.findall(
    r"constexpr int (\w+) = (\d+);", SRC.read_text()))
LB, RB, BK = CONST["LB"], CONST["RB"], CONST["BK"]
CHAIN, KSTEP = CONST["CHAIN"], CONST["KSTEP"]
LANES = 32
TOL = 1e-4                       # of the largest entry: every gradient
BF16_TOL = TOL + 2.0 ** -8       # bf16 dq, dk, dv: rounded once


def gemm(A, B, split_a, split_b):
    """A (M, K) B (K, N) as the product kernel takes it: TF32 terms (bf16
    values exact, one term), every BK-deep stage a fresh chain of 8-deep
    truncating steps, the stages added into an f32 accumulator in order.
    Masked entries are zeros: a stage of zeros adds nothing."""
    assert BK == CHAIN
    K = A.shape[1]
    pad = -K % BK
    A = np.pad(np.asarray(A, F32), ((0, 0), (0, pad)))
    B = np.pad(np.asarray(B, F32), ((0, pad), (0, 0)))
    pa, pb = planes(A, not split_a), planes(B, not split_b)
    acc = np.zeros((A.shape[0], B.shape[1]), F32)
    for k0 in range(0, K + pad, BK):
        part = np.zeros_like(acc)
        for kk in range(k0, k0 + BK, KSTEP):
            part = chain(part, pa, pb, slice(kk, kk + KSTEP))
        acc = acc + part
    return acc


def butterfly(v):
    """A warp's xor-shuffle sum over the last axis (32 lanes), f32."""
    idx = np.arange(LANES)
    for off in (16, 8, 4, 2, 1):
        v = (v + v[..., idx ^ off]).astype(F32)
    return v[..., 0]


def lane_dot(x, y):
    """Rows of x dotted with y (rows, or one vector) as a warp takes them:
    lane l sums columns l + 32 i by fmaf in order, then the butterfly."""
    x = np.asarray(x, F32)
    y = np.broadcast_to(np.asarray(y, F32), x.shape)
    acc = np.zeros(x.shape[:-1] + (LANES,), F32)
    for i in range(x.shape[-1] // LANES):
        cols = slice(LANES * i, LANES * (i + 1))
        acc = fma(x[..., cols], y[..., cols], acc)
    return butterfly(acc)


def logd(i_raw, f_log, m0, chunk):
    """The gate pass (chunk-local b, m_t in f32) and the per-token alpha,
    beta (float64), e^{-m_t}; each block's w0, wk and wC."""
    S = len(i_raw)
    alpha, beta = np.zeros(S), np.zeros(S)
    flr = np.zeros(S, F32)
    m, Fpre = F32(0 if m0 is None else m0), 0.0
    for t0 in range(0, S, chunk):
        Lc = min(chunk, S - t0)
        b, _, mt, _, _, _, m = gates(i_raw[t0:t0 + Lc], f_log[t0:t0 + Lc],
                                     m, Lc)
        Bg = Fpre + b[:Lc].astype(np.float64)
        alpha[t0:t0 + Lc] = Bg - mt[:Lc].astype(np.float64)
        beta[t0:t0 + Lc] = i_raw[t0:t0 + Lc].astype(np.float64) - Bg
        flr[t0:t0 + Lc] = np.exp(-mt[:Lc])
        Fpre += np.float64(b[-1])
    nb = -(-S // LB)
    w0, wk, wc = np.zeros(S, F32), np.zeros(S, F32), np.zeros(nb, F32)
    for j in range(nb):
        t0, e = j * LB, min((j + 1) * LB, S) - 1
        gam = (0.0 if m0 is None else float(m0)) if j == 0 else -alpha[t0 - 1]
        blk = slice(t0, e + 1)
        if j > 0 or m0 is not None:
            w0[blk] = np.exp((gam + alpha[blk]).astype(F32))
        if j + 1 < nb:
            wk[blk] = np.exp((alpha[e] + beta[blk]).astype(F32))
        wc[j] = np.exp(F32(gam + alpha[e]))
    return alpha, beta, flr, w0, wk, wc


def token_pass(Pm, Gm, alpha, beta, w0, flr, qn, z):
    """One block's token pass: dS . D and S / den (zero above the
    diagonal), r1, r2, a0 = w0 dw0, the rows' and the columns' sums of E
    (columns by warp rows, warps, row blocks, each in order)."""
    L = Pm.shape[0]
    t, s = np.arange(L)[:, None], np.arange(L)[None, :]
    on = s <= t
    with np.errstate(over="ignore", invalid="ignore"):
        D = np.where(on, np.exp((alpha[:, None] + beta[None, :]).astype(F32)),
                     F32(0)).astype(F32)
    Sv = np.where(on, Pm * D, F32(0)).astype(F32)
    Gv = np.where(on, Gm, F32(0)).astype(F32)
    cols = LB // LANES

    def lanes(x):                       # (L, L) -> (L, cols, 32)
        return np.pad(x, ((0, 0), (0, LB - L))).reshape(L, cols, LANES)

    Sl, Gl = lanes(Sv), lanes(Gv)
    rs = np.zeros((L, LANES), F32)
    sg = np.zeros((L, LANES), F32)
    for i in range(cols):
        rs = rs + Sl[:, i]
        sg = fma(Sl[:, i], Gl[:, i], sg)
    rs, sg = butterfly(rs), butterfly(sg)
    d = fma(w0, qn, rs)
    den = np.maximum(np.abs(d), flr)
    gnum = fma(w0, z, sg)
    dd = np.where(np.abs(d) >= flr, -np.sign(d) * gnum / (den * den),
                  F32(0)).astype(F32)
    inv = (F32(1) / den).astype(F32)
    dS = np.where(on, fma(Gv, inv[:, None], dd[:, None]), F32(0))
    E = (dS * Sv).astype(F32)
    El = lanes(E)
    rowE = np.zeros((L, LANES), F32)
    for i in range(cols):
        rowE = rowE + El[:, i]
    rowE = butterfly(rowE)
    # columns: a warp's eight rows in order, the warps in order: a row
    # block's partial; gategrad sums the row blocks in order
    parts = []
    for r0 in range(0, L, RB):
        warps = []
        for w0_ in range(r0, min(r0 + RB, L), 8):
            acc = np.zeros(L, F32)
            for r in range(w0_, min(w0_ + 8, L)):
                acc = acc + E[r]
            warps.append(acc)
        tot = np.zeros(L, F32)
        for acc in warps:
            tot = tot + acc
        parts.append(np.where(np.arange(L) < min(r0 + RB, L), tot, F32(0)))
    dP = (dS * D).astype(F32)
    Sd = np.where(on, Sv * inv[:, None], F32(0)).astype(F32)
    a0 = (w0 * fma(z, inv, (qn * dd).astype(F32))).astype(F32)
    return (dP, Sd, (w0 * inv).astype(F32), (w0 * dd).astype(F32), a0, rowE,
            parts)


def emulate(q, k, v, i_raw, f_log, dh, state, chunk, exact):
    """K6's backward on one head in the kernel's order: (dq, dk, dv) in
    float32 before the rounding to q's dtype, di, df. q, k, v are f32
    arrays (bf16 values when ``exact``); state (C0, n0, m0) or None."""
    S, dk = q.shape
    dv = v.shape[1]
    sp = not exact                      # q, k, v split like dh
    C0, n0, m0 = state if state is not None else (None, None, None)
    has0 = state is not None
    alpha, beta, flr, w0, wk, wc = logd(i_raw, f_log, m0, chunk)
    nb = -(-S // LB)
    blocks = [slice(j * LB, min((j + 1) * LB, S)) for j in range(nb)]
    walk = has0 or nb > 1
    Y, U, W = (np.zeros((S, n), F32) for n in (dk, dk, dv))
    nst = np.zeros((nb, dk), F32)
    if walk:
        n = np.zeros(dk, F32) if n0 is None else np.asarray(n0, F32)
        C = None if C0 is None else np.asarray(C0, F32)
        for j, blk in enumerate(blocks):
            nst[j] = n
            if j > 0 or has0:
                Y[blk] = gemm(dh[blk], C.T, True, True)
            if j + 1 < nb:
                acc = np.zeros(dk, F32)
                for s in range(blk.start, blk.stop):
                    acc = fma(wk[s], k[s], acc)
                upd = gemm((k[blk] * wk[blk, None]).astype(F32).T, v[blk],
                           True, sp)
                state_on = j > 0 or has0
                n = fma(wc[j], n, acc) if state_on else acc
                C = fma(wc[j], C, upd) if state_on else upd
    r1, r2, a0, rowE, ak = (np.zeros(S, F32) for _ in range(5))
    cole = np.zeros(S, F32)
    mats = []
    for j, blk in enumerate(blocks):
        Pm = gemm(q[blk], k[blk].T, sp, sp)
        Gm = gemm(dh[blk], v[blk].T, True, sp)
        if j > 0 or has0:
            qn, z = lane_dot(q[blk], nst[j]), lane_dot(q[blk], Y[blk])
        else:
            qn = z = np.zeros(blk.stop - blk.start, F32)
        dP, Sd, r1[blk], r2[blk], a0[blk], rowE[blk], parts = token_pass(
            Pm, Gm, alpha[blk], beta[blk], w0[blk], flr[blk], qn, z)
        L = blk.stop - blk.start
        col = np.zeros(L, F32)
        for s in range(L):                 # row blocks s // RB .. in order
            for p in parts[s // RB:]:
                col[s] = col[s] + p[s]
        cole[blk] = col
        mats.append((dP, Sd))
    if nb > 1:
        dnE = np.zeros((nb, dk), F32)
        dn = np.zeros(dk, F32)
        for j in range(nb - 1, -1, -1):
            dnE[j] = dn
            if j == 0:
                break
            acc = np.zeros(dk, F32)
            for t in range(blocks[j].start, blocks[j].stop):
                acc = fma(r2[t], q[t], acc)
            dn = fma(wc[j], dn, acc)
        dC = None
        for j in range(nb - 1, 0, -1):
            blk, prev = blocks[j], blocks[j - 1]
            new = gemm((q[blk] * r1[blk, None]).astype(F32).T, dh[blk],
                       True, True)
            dC = new if j + 1 == nb else fma(wc[j], dC, new)
            U[prev] = gemm(v[prev], dC.T, sp, True) + dnE[j - 1]
            W[prev] = gemm(k[prev], dC, sp, True)
        last = blocks[-1].start
        ak[:last] = (wk[:last] * lane_dot(k[:last], U[:last])).astype(F32)
    dq, dk_, dv_ = (np.zeros((S, n), F32) for n in (dk, dk, dv))
    for j, (blk, (dP, Sd)) in enumerate(zip(blocks, mats)):
        x = gemm(dP, k[blk], True, sp)
        if j > 0 or has0:
            x = fma(r2[blk, None], nst[j], fma(r1[blk, None], Y[blk], x))
        dq[blk] = x
        x, y = gemm(dP.T, q[blk], True, sp), gemm(Sd.T, dh[blk], True, True)
        if j + 1 < nb:
            x = fma(wk[blk, None], U[blk], x)
            y = fma(wk[blk, None], W[blk], y)
        dk_[blk], dv_[blk] = x, y
    # gate gradients: 32 tokens at a time from the end, reversed scan
    di = (cole + ak).astype(F32)
    db = (((rowE - cole).astype(F32) + a0).astype(F32) - ak).astype(F32)
    df = np.zeros(S, F32)
    carry = F32(0)
    for g0 in range((S - 1) // LANES * LANES, -1, -LANES):
        inc = np.zeros(LANES, F32)
        n = min(LANES, S - g0)
        inc[:n] = db[g0:g0 + n]
        for off in (1, 2, 4, 8, 16):
            inc = (inc + np.concatenate([inc[off:],
                                         np.zeros(off, F32)])).astype(F32)
        df[g0:g0 + n] = (inc[:n] + carry).astype(F32)
        carry = F32(carry + inc[0])
    out = [dq, dk_, dv_]
    if exact:
        out = [bf16(x) for x in out]
    return out + [di, df]


def exact_f64(q, k, v, i_raw, f_log, dh, state=None):
    """The gradients of sum(h . dh) in float64: the all-pairs function
    with the stabilizer held constant (h does not depend on it)."""
    q, k, v, i_raw, f_log = (torch.tensor(np.asarray(x, np.float64),
                                          requires_grad=True)
                             for x in (q, k, v, i_raw, f_log))
    g = torch.tensor(np.asarray(dh, np.float64))
    S = q.shape[0]
    if state is None:
        C0 = torch.zeros((q.shape[1], v.shape[1]), dtype=torch.float64)
        n0 = torch.zeros(q.shape[1], dtype=torch.float64)
        m0 = 0.0
    else:
        C0, n0 = (torch.tensor(np.asarray(x, np.float64)) for x in state[:2])
        m0 = float(state[2])
    Bg = torch.cumsum(f_log, 0)
    causal = torch.ones((S, S), dtype=torch.bool).tril()
    logD = torch.where(causal, Bg[:, None] - Bg[None, :] + i_raw[None, :],
                       torch.tensor(float("-inf"), dtype=torch.float64))
    m = torch.maximum(m0 + Bg, logD.max(dim=1).values).detach()
    D = torch.exp(logD - m[:, None])
    Sc = (q @ k.T) * D
    w0 = torch.exp(m0 + Bg - m)
    num = Sc @ v + w0[:, None] * (q @ C0)
    den = torch.maximum((Sc.sum(1) + w0 * (q @ n0)).abs(), torch.exp(-m))
    h = num / den[:, None]
    return [x.numpy() for x in torch.autograd.grad((h * g).sum(),
                                                   (q, k, v, i_raw, f_log))]


def inputs(seed, S, dk, dv, dtype, with_state=False):
    """q scaled as the model scales it, forget gates near 1, dh normal; q,
    k, v rounded to bf16 when asked; a constant initial state if asked."""
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((S, dk)) * dk ** -0.5).astype(F32)
    k = rng.standard_normal((S, dk)).astype(F32)
    v = rng.standard_normal((S, dv)).astype(F32)
    if dtype == "bf16":
        q, k, v = bf16(q), bf16(k), bf16(v)
    i_raw = rng.standard_normal(S).astype(F32)
    f_log = (-np.log1p(np.exp(-(rng.standard_normal(S) + 2.0)))).astype(F32)
    dh = rng.standard_normal((S, dv)).astype(F32)
    state = None
    if with_state:
        state = ((0.1 * rng.standard_normal((dk, dv))).astype(F32),
                 (0.1 * np.abs(rng.standard_normal(dk))).astype(F32),
                 F32(rng.standard_normal()))
    return q, k, v, i_raw, f_log, dh, state


def check(got, want, dtype):
    errs = {}
    for name, g, w in zip(("dq", "dk", "dv", "di", "df"), got, want):
        errs[name] = rel(g, w)
        tol = BF16_TOL if dtype == "bf16" and name in ("dq", "dk", "dv") \
            else TOL
        assert errs[name] <= tol, (name, errs)
    return errs


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_served_width_meets_the_tolerance(dtype):
    """The training call's width (dk = dv = 1024, one 512-token block,
    from the zero state), emulated, against float64: every gradient
    within the kernel's tolerances."""
    q, k, v, i_raw, f_log, dh, _ = inputs(23, LB, 1024, 1024, dtype)
    got = emulate(q, k, v, i_raw, f_log, dh, None, 64, dtype == "bf16")
    check(got, exact_f64(q, k, v, i_raw, f_log, dh), dtype)


@pytest.mark.parametrize("S,dk,dv,chunk,dtype,with_state", [
    (100, 64, 64, 64, "f32", False),     # one block, ragged chunk
    (77, 128, 128, 16, "bf16", False),   # bf16 operands, short chunks
    (130, 64, 64, 64, "f32", True),      # a constant initial state
    (LB + 88, 64, 64, 64, "f32", False),  # S > LB: the walk between blocks
    (LB + 37, 64, 64, 64, "bf16", True),  # both, bf16, ragged last chunk
])
def test_small_width_matches_reference_grad(S, dk, dv, chunk, dtype,
                                            with_state):
    """The emulated route against ``jax.grad`` of the reference's
    ``xlstm.mlstm_chunk`` on the same inputs (bf16 ones as their float32
    values): every gradient within 1e-4 of its largest entry, bf16 dq, dk,
    dv within 1e-4 + 2^-8."""
    q, k, v, i_raw, f_log, dh, state = inputs(S + dk, S, dk, dv, dtype,
                                              with_state)
    got = emulate(q, k, v, i_raw, f_log, dh, state, chunk, dtype == "bf16")
    if state is None:
        st = (jnp.zeros((1, 1, dk, dv)), jnp.zeros((1, 1, dk)),
              jnp.zeros((1, 1)))
    else:
        st = (jnp.asarray(state[0])[None, None],
              jnp.asarray(state[1])[None, None],
              jnp.asarray(state[2]).reshape(1, 1))
    g = jnp.asarray(dh)[None, :, None]

    def loss(q, k, v, i_raw, f_log):
        h, _ = jxlstm.mlstm_chunk(q, k, v, i_raw, f_log, st, 64)
        return (h * g).sum()

    seq = lambda x: jnp.asarray(x)[None, :, None]  # noqa: E731
    want = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(
        *map(seq, (q, k, v, i_raw, f_log)))
    check(got, [np.asarray(w)[0, :, 0] for w in want], dtype)


def test_past_one_block_against_float64():
    """S > LB from a constant state, f32 at dk = dv = 128: the state walk
    between blocks, against float64."""
    q, k, v, i_raw, f_log, dh, state = inputs(5, LB + 200, 128, 128, "f32",
                                              True)
    got = emulate(q, k, v, i_raw, f_log, dh, state, 64, False)
    check(got, exact_f64(q, k, v, i_raw, f_log, dh, state), "f32")
