"""K6's split-TF32 products and summation order, emulated in numpy.

The Hopper kernel (``src/repro_torch/kernels/csrc/mlstm.cu``) runs every
product on the tensor cores with TF32 operands and f32 accumulators: a
bf16 operand is exact in TF32 and is one term, an f32 one splits into hi
= tf32(x) and lo = tf32(x - hi), and f32 x f32 takes hi.hi + hi.lo +
lo.hi. Every mma instruction adds 8 products and rounds its result toward
zero (the tensor cores' accumulation truncates; the model keeps the
products and their sum exact before that one rounding), so each chain of
at most CHAIN products is a fresh partial, added into an f32 accumulator
rounding to nearest. The emulation follows the kernel's order:

* the gates: one warp's scans, two rows a lane (f32);
* q k^T: dk split over blocks as the kernel's grid splits it, each block's
  slices in chains of CHAIN, the partials summed in order, then the decay
  and the row sums;
* the state walk: the warp pair qr owns rows 16 qr .. 16 qr + 15 of every
  DKT-row slice of dk; its share of q C0 takes each slice's 16 products as
  a fresh partial, added into its f32 accumulator; the update C = wC0 C +
  k^T (wk v) takes two interleaved chains of 32 over the chunk's tokens
  (wk v rounded to f32 and split once a chunk); n and q.n0 on the CUDA
  cores in the lanes' order; at the chunk's end each pair's tile times w0
  plus its 16-deep share of scores . v, and the four tiles summed as (0 +
  1) + (2 + 3).

LC, DKT, NT, CHAIN, KSTEP and SPLIT_BLOCKS are read from the source.
Held against float64 at the served width (dk = dv = 1024, three chunks of
64, the last one ragged): h, C, n and m within 1e-4 of each one's largest
entry (the kernel's tolerance against the plain version), q C0 of the
carried state within it too; one truncating chain over all of dk lands
further from float64 than the staged order. At small widths the emulation
also matches the port's plain version (``mlstm_chunk_plain``).
"""
import pathlib
import re

import numpy as np
import pytest
import torch

from repro_torch.kernels.mlstm import ref

SRC = (pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch"
       / "kernels" / "csrc" / "mlstm.cu")
CONST = dict((name, int(value)) for name, value in re.findall(
    r"constexpr int (\w+) = (\d+);", SRC.read_text()))
LC, DKT = CONST["LC"], CONST["DKT"]
PAIRS = CONST["NT"] // 64       # warp pairs of a state block
CHAIN, KSTEP = CONST["CHAIN"], CONST["KSTEP"]
SPLIT_BLOCKS = CONST["SPLIT_BLOCKS"]
TOL = 1e-4                      # of the largest entry: h, C, n, m
# float64 bits kept by rounding toward zero to float32's 24-bit significand
TRUNC = np.uint64(0xFFFFFFFFE0000000)
F32 = np.float32


def tf32(x):
    """float32 rounded to TF32 (cvt.rna.tf32.f32: to nearest, ties away
    from zero; the low 13 bits cleared)."""
    bits = np.ascontiguousarray(x, F32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(F32)


def bf16(x):
    """float32 rounded to bfloat16 (to nearest, ties to even), as float32."""
    bits = np.ascontiguousarray(x, F32).view(np.uint32)
    bits = bits + np.uint32(0x7FFF) + ((bits >> 16) & np.uint32(1))
    return (bits & np.uint32(0xFFFF0000)).view(F32)


def trunc(x):
    """float64 rounded toward zero to float32 (normal range)."""
    return (np.ascontiguousarray(x, np.float64).view(np.uint64)
            & TRUNC).view(np.float64).astype(F32)


def fma(a, b, c):
    """fmaf: a b + c rounded once to float32."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(F32)


def planes(x, exact):
    """An operand's TF32 terms: a bf16 one as itself, an f32 one split."""
    x = np.asarray(x, F32)
    if exact:
        assert np.array_equal(tf32(x), x)        # bf16 is exact in TF32
        return [x.astype(np.float64)]
    hi = tf32(x)
    return [hi.astype(np.float64), tf32(x - hi).astype(np.float64)]


def pairs(pa, pb):
    """hi.hi, then hi.lo, then lo.hi, of the terms there are."""
    return [(0, 0)] + [(0, 1)] * (len(pb) == 2) + [(1, 0)] * (len(pa) == 2)


def chain(part, pa, pb, ks, order=None):
    """One k step (8 products) of a tensor-core chain: part (M, N) plus
    A[:, ks] B[ks, :], one truncating instruction a term pair."""
    for i, j in order or pairs(pa, pb):
        part = trunc(part + pa[i][:, ks] @ pb[j][ks, :])
    return part


def gates(i_raw, f_log, m, Lc):
    """One chunk's gates as the gate kernel's warp takes them (f32, two
    rows a lane): b, i, m_t, w0, wk over LC rows, wC0 and the next m."""
    f = np.zeros(LC, F32)
    i = np.full(LC, -np.inf, F32)
    f[:Lc], i[:Lc] = f_log, i_raw
    f0, f1 = f[0::2], f[1::2]
    inc = f0 + f1
    for off in (1, 2, 4, 8, 16):
        inc = np.concatenate([inc[:off], inc[off:] + inc[:-off]])
    exc = np.concatenate([[F32(0)], inc[:-1]])
    b0 = exc + f0
    b = np.stack([b0, b0 + f1], 1).reshape(-1)
    with np.errstate(invalid="ignore"):
        a = i - b
    cm = np.maximum.accumulate(a)
    mt = np.maximum(m + b, b + cm)
    F, A = b[-1], cm[-1]
    mn = np.maximum(m + F, F + A)
    w0 = np.exp(m + b - mt)
    wk = np.exp(F - b + i - mn)
    return b, i, mt, w0, wk, np.exp(m + F - mn), mn


def splits(tiles, dk):
    """The scores pass's splits of dk (the kernel's Work)."""
    ns = dk // DKT
    return next((p for p in range(1, ns + 1)
                 if ns % p == 0 and tiles * p >= SPLIT_BLOCKS), ns)


def scores(q, k, g, Lc, exact, P):
    """The decayed scores and row sums of a chunk: q k^T over P splits of
    dk, each in chains of CHAIN, the partials summed in order."""
    pq, pk = planes(q, exact), planes(k.T, exact)
    dks = q.shape[1] // P
    G = None
    for p in range(P):
        acc = np.zeros((LC, LC), F32)
        for c0 in range(p * dks, (p + 1) * dks, CHAIN):
            part = np.zeros((LC, LC), F32)
            for kk in range(c0, c0 + CHAIN, KSTEP):
                part = chain(part, pq, pk, slice(kk, kk + KSTEP))
            acc = acc + part
        G = acc if G is None else G + acc
    b, i, mt = g[:3]
    t, s = np.arange(LC)[:, None], np.arange(LC)[None, :]
    with np.errstate(invalid="ignore", over="ignore"):
        D = np.exp(b[:, None] - b[None, :] + i[None, :] - mt[:, None])
        Sc = np.where((s <= t) & (t < Lc), G * D, F32(0)).astype(F32)
    quarters = [np.cumsum(Sc[:, 16 * q4:16 * q4 + 16], 1, dtype=F32)[:, -1]
                for q4 in range(4)]
    rs = (quarters[0] + quarters[1]) + (quarters[2] + quarters[3])
    return Sc, rs


def qc0_pair(q, C, exact_q, qr):
    """Warp pair qr's share of q C0: its 16 rows of every slice, each
    slice's products a fresh partial added into an f32 accumulator."""
    pq, pc = planes(q, exact_q), planes(C, False)
    acc = np.zeros((q.shape[0], C.shape[1]), F32)
    for d0 in range(16 * qr, q.shape[1], DKT):
        part = np.zeros_like(acc)
        for kk in (d0, d0 + KSTEP):
            part = chain(part, pq, pc, slice(kk, kk + KSTEP))
        acc = acc + part
    return acc


def reduce_pairs(tiles):
    """The pairs' tiles summed as (0 + 1) + (2 + 3)."""
    assert len(tiles) == 4
    return (tiles[0] + tiles[1]) + (tiles[2] + tiles[3])


def update(C, n, k, v, wk, wC0, exact):
    """C = wC0 C + k^T (wk v), two chains over the tokens (32 each)
    interleaved; n = wC0 n + k^T wk in the lanes' order (f32)."""
    W = (wk[:, None] * v).astype(F32)
    pw, pk = planes(W, False), planes(k.T, exact)
    half = LC // 2
    ups = []
    for c0 in (0, half):
        part = np.zeros(C.shape, F32)
        for kk in range(c0, c0 + half, KSTEP):
            part = chain(part, pk, pw, slice(kk, kk + KSTEP))
        ups.append(part)
    C = fma(C, wC0, ups[0] + ups[1])
    # lane t of row d sums tokens s = t (mod 4), k steps in the kernel's order
    nu = np.zeros((4, k.shape[1]), F32)
    for kk in range(LC // KSTEP // 2):
        for ch in range(2):
            for t in range(4):
                s = (kk + ch * LC // KSTEP // 2) * KSTEP + t
                nu[t] = fma(k[s + 4], wk[s + 4], fma(k[s], wk[s], nu[t]))
    n = fma(n, wC0, (nu[0] + nu[1]) + (nu[2] + nu[3]))
    return C, n


def qn0(q, n):
    """q.n0 of every row, as the lanes and warp pairs take it."""
    dk = q.shape[1]
    lanes = np.zeros((PAIRS, 4, q.shape[0]), F32)
    for sl in range(dk // DKT):
        for qr in range(PAIRS):
            for kk in range(2):
                d0 = sl * DKT + 16 * qr + KSTEP * kk
                for t in range(4):
                    x = fma(q[:, d0 + t], n[d0 + t], lanes[qr, t])
                    lanes[qr, t] = fma(q[:, d0 + t + 4], n[d0 + t + 4], x)
    per_pair = (lanes[:, 0] + lanes[:, 1]) + (lanes[:, 2] + lanes[:, 3])
    out = per_pair[0]
    for qr in range(1, PAIRS):
        out = out + per_pair[qr]
    return out


def emulate(q, k, v, i_raw, f_log, state, chunk, exact):
    """K6 on one head: h (S, dv) and the final (C, n, m), in the kernel's
    order. q, k, v f32 arrays (bf16 values when ``exact``)."""
    S, dk = q.shape
    C, n, m = state
    nc = -(-S // chunk)
    P = splits(nc, dk)
    hs = []
    for c in range(nc):
        t0 = c * chunk
        Lc = min(chunk, S - t0)
        pad = ((0, LC - Lc), (0, 0))
        qc, kc, vc = (np.pad(x[t0:t0 + Lc], pad) for x in (q, k, v))
        g = gates(i_raw[t0:t0 + Lc], f_log[t0:t0 + Lc], m, Lc)
        b, i, mt, w0, wk, wC0, m = g
        Sc, rs = scores(qc, kc, g, Lc, exact, P)
        dint = qn0(qc, n)
        pv, psc = planes(vc, exact), planes(Sc, False)
        tiles = []
        for qr in range(PAIRS):
            acc = qc0_pair(qc, C, exact, qr) * w0[:, None]
            part = np.zeros_like(acc)
            for s0 in (16 * qr, 16 * qr + KSTEP):
                part = chain(part, psc, pv, slice(s0, s0 + KSTEP))
            tiles.append(acc + part)
        den = np.maximum(np.abs(fma(dint, w0, rs)), np.exp(-mt))
        hs.append((reduce_pairs(tiles) * (F32(1) / den)[:, None])[:Lc])
        C, n = update(C, n, kc, vc, wk, wC0, exact)
    return np.concatenate(hs), (C, n, m)


def exact_f64(q, k, v, i_raw, f_log, state, chunk):
    """The chunkwise function in float64."""
    q, k, v, i_raw, f_log = (np.asarray(x, np.float64)
                             for x in (q, k, v, i_raw, f_log))
    C, n, m = (np.asarray(x, np.float64) for x in state)
    hs, qc0s = [], []
    for t0 in range(0, q.shape[0], chunk):
        sl = slice(t0, t0 + chunk)
        qc, kc, vc, ii, ff = q[sl], k[sl], v[sl], i_raw[sl], f_log[sl]
        L = qc.shape[0]
        b = np.cumsum(ff)
        a = np.maximum.accumulate(ii - b)
        mt = np.maximum(m + b, b + a)
        w0 = np.exp(m + b - mt)
        D = np.where(np.tril(np.ones((L, L), bool)),
                     np.exp(b[:, None] - b[None, :] + ii[None, :]
                            - mt[:, None]), 0.0)
        Sc = (qc @ kc.T) * D
        qc0s.append(qc @ C)
        den = np.maximum(np.abs((qc @ n) * w0 + Sc.sum(1)), np.exp(-mt))
        hs.append((qc0s[-1] * w0[:, None] + Sc @ vc) / den[:, None])
        F = b[-1]
        mn = max(m + F, F + a[-1])
        wk = np.exp(F - b + ii - mn)
        C = C * np.exp(m + F - mn) + kc.T @ (wk[:, None] * vc)
        n = n * np.exp(m + F - mn) + kc.T @ wk
        m = mn
    return np.concatenate(hs), (C, n, m), qc0s


def inputs(seed, S, dk, dv, dtype):
    """q scaled as the model scales it, forget gates near 1, a nonzero
    initial state; q, k, v rounded to bf16 when asked."""
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((S, dk)) * dk ** -0.5).astype(F32)
    k = rng.standard_normal((S, dk)).astype(F32)
    v = rng.standard_normal((S, dv)).astype(F32)
    if dtype == "bf16":
        q, k, v = bf16(q), bf16(k), bf16(v)
    i_raw = rng.standard_normal(S).astype(F32)
    f_log = (-np.log1p(np.exp(-(rng.standard_normal(S) + 2.0)))).astype(F32)
    state = (rng.standard_normal((dk, dv)).astype(F32),
             rng.standard_normal(dk).astype(F32),
             F32(rng.standard_normal()))
    return q, k, v, i_raw, f_log, state


def rel(got, want):
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / max(np.abs(want).max(), 1e-30))


@pytest.fixture(scope="module", params=["f32", "bf16"])
def served(request):
    """The served width (dk = dv = 1024), three chunks of 64 (the last 37
    rows), emulated and in float64."""
    S, dk, dv, chunk = 2 * LC + 37, 1024, 1024, LC
    args = inputs(17, S, dk, dv, request.param)
    got = emulate(*args, chunk, exact=request.param == "bf16")
    return args, got, exact_f64(*args, chunk)


def test_served_width_meets_the_tolerance(served):
    """h and the final C, n, m against float64: within 1e-4 of each one's
    largest entry, with f32 and with bf16 q, k, v."""
    _, (h, (C, n, m)), (want_h, (wC, wn, wm), _) = served
    errs = {"h": rel(h, want_h), "C": rel(C, wC), "n": rel(n, wn),
            "m": rel(m, wm)}
    assert max(errs.values()) <= TOL, errs


def test_q_c0_of_the_carried_state(served):
    """q C0 of every chunk, C0 the state carried from the chunks before
    (in float64), in the kernel's order: within 1e-4 of the largest entry
    of the float64 product, and a tenth of that in fact."""
    (q, k, v, i_raw, f_log, state), _, (_, _, qc0s) = served
    exact = np.array_equal(bf16(q), q)
    for c, want in enumerate(qc0s):
        rows = slice(c * LC, c * LC + want.shape[0])
        C = _state_before(q, k, v, i_raw, f_log, state, c)
        got = reduce_pairs([qc0_pair(q[rows], C.astype(F32), exact, qr)
                            for qr in range(PAIRS)])
        assert rel(got, want) <= TOL / 10, (c, rel(got, want))


def _state_before(q, k, v, i_raw, f_log, state, c):
    """The float64 C that chunk c starts from."""
    if c == 0:
        return np.asarray(state[0], np.float64)
    _, (C, _, _), _ = exact_f64(q[:c * LC], k[:c * LC], v[:c * LC],
                                i_raw[:c * LC], f_log[:c * LC], state, LC)
    return C


def test_one_truncating_chain_over_dk_does_worse(served):
    """The same q C0 products summed as one tensor-core chain over all of
    dk (no fresh partial, no split over warp pairs): every instruction's
    truncation adds the same way, and the result lands further from
    float64 than the kernel's staged order."""
    (q, k, v, i_raw, f_log, state), _, _ = served
    exact = np.array_equal(bf16(q), q)
    C = _state_before(q, k, v, i_raw, f_log, state, 1)
    qc = q[LC:2 * LC]
    want = qc.astype(np.float64) @ C
    Cf = C.astype(F32)
    staged = rel(reduce_pairs([qc0_pair(qc, Cf, exact, qr)
                               for qr in range(PAIRS)]), want)
    pq, pc = planes(qc, exact), planes(Cf, False)
    one = np.zeros(want.shape, F32)
    for d in range(0, q.shape[1], KSTEP):
        one = chain(one, pq, pc, slice(d, d + KSTEP))
    single = rel(one, want)
    assert single > 2 * staged, (single, staged)


@pytest.mark.parametrize("S,dk,dv,chunk,dtype", [
    (37, 128, 64, 16, "f32"),      # ragged last chunk, short chunks
    (100, 64, 32, 64, "f32"),      # one slice of dk
    (77, 256, 96, 64, "bf16"),     # bf16 operands, a split scores pass
])
def test_emulation_matches_the_plain_version(S, dk, dv, chunk, dtype):
    """At small widths the emulated kernel computes the port's plain
    chunkwise function: h and the final C, n, m within 1e-4 of the
    largest entry."""
    q, k, v, i_raw, f_log, state = inputs(S + dk, S, dk, dv, dtype)
    h, (C, n, m) = emulate(q, k, v, i_raw, f_log, state, chunk,
                           exact=dtype == "bf16")
    t = lambda x: torch.from_numpy(np.asarray(x))[None, :, None]  # noqa: E731
    st = tuple(torch.from_numpy(np.asarray(x))[None, None]
               for x in state)
    want_h, (wC, wn, wm) = ref.mlstm_chunk_plain(
        t(q), t(k), t(v), t(i_raw), t(f_log), st, chunk=chunk)
    errs = {"h": rel(h, want_h[0, :, 0]), "C": rel(C, wC[0, 0]),
            "n": rel(n, wn[0, 0]), "m": rel(m, wm[0, 0])}
    assert max(errs.values()) <= TOL, errs


def test_tf32_rounding_is_nearest_ties_away():
    """The emulated cvt.rna.tf32.f32 keeps 10 explicit bits, rounds to
    nearest and ties away from zero, and leaves TF32 values alone."""
    ulp = F32(2.0 ** -10)
    x = np.array([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 4, 1 + 3 * ulp / 4],
                 F32)
    np.testing.assert_array_equal(
        tf32(x), np.array([1 + ulp, -(1 + ulp), 1, 1 + ulp], F32))
    assert np.array_equal(tf32(tf32(x)), tf32(x))
