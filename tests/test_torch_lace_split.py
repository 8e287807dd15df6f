"""The split-TF32 products of the Hopper LACE kernels, emulated in numpy.

The kernels (``src/repro_torch/kernels/csrc/lace_common.cuh``) run every
product on the tensor cores with TF32 operands and f32 accumulators. A
bf16 operand is exact in TF32 and enters as one term; an f32 operand x is
split into hi = tf32(x) and lo = tf32(x - hi), and the products are
a.hi (+ a.lo) for bf16 x f32 (2 products) and hi.hi + hi.lo + lo.hi for
f32 x f32 (3). The emulation takes the sums in the kernels' order: each
output sums its K products in segments of KSEG; within a segment each
BK-deep stage is a fresh chain of mma instructions, 8 products deep, the
terms interleaved per 8, every instruction's result rounded toward zero
in f32 (the tensor cores' accumulation truncates; the model keeps the
products and their sum exact before that one rounding); each stage's
partial is added into the segment's accumulator, and each segment into
the output, rounding to nearest. BK and KSEG are read from the kernels'
header. Held against float64 at the training width (d = 1024): z, the
lse, df and dW meet the kernels' tolerances; a single TF32 product, or
one truncating chain over a whole segment, does not meet df's.
"""
import pathlib
import re

import numpy as np
import pytest

HEADER = (pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch"
          / "kernels" / "csrc" / "lace_common.cuh")
CONST = dict((name, int(value)) for name, value in re.findall(
    r"constexpr int (\w+) = (\d+);", HEADER.read_text()))
BK = CONST["BK"]         # products per tensor-core chain (one stage)
KSEG = CONST["KSEG"]     # products per accumulator segment
MMA_K = 8                # products per m16n8k8 instruction
D, V, N, G = 1024, 4096, 64, 4
TOL_Z = TOL_DF = TOL_DW = 1e-5   # of the largest entry, against float64
TOL_LSE = 1e-4
# float64 bits kept by rounding toward zero to float32's 24-bit significand
TRUNC = np.uint64(0xFFFFFFFFE0000000)


def tf32(x):
    """float32 rounded to TF32 (cvt.rna.tf32.f32: to nearest, ties away
    from zero; the low 13 bits cleared)."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def bf16(x):
    """float32 rounded to bfloat16 (to nearest, ties to even), as float32."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    bits = bits + np.uint32(0x7FFF) + ((bits >> 16) & np.uint32(1))
    return (bits & np.uint32(0xFFFF0000)).view(np.float32)


def planes(x, is_bf16):
    """The operand's TF32 planes: a bf16 one as itself, an f32 one split."""
    if is_bf16:
        assert np.array_equal(tf32(x), x)      # bf16 is exact in TF32
        return [x]
    hi = tf32(x)
    return [hi, tf32(x - hi)]


def trunc(x):
    """float64 rounded toward zero to float32 (normal range)."""
    return (np.ascontiguousarray(x, np.float64).view(np.uint64)
            & TRUNC).view(np.float64).astype(np.float32)


def product(a, b, a_bf16, b_bf16, terms=None, stage=BK):
    """a (M, K) @ b (K, N) as the kernels take it (module docstring): per
    KSEG segment, per ``stage``-deep chain, one truncating instruction a
    term for each 8 products. ``terms`` overrides which (a plane, b plane)
    pairs enter (default hi.hi, hi.lo, lo.hi of the planes there are);
    ``stage`` = KSEG makes the whole segment one chain."""
    pa, pb = planes(a, a_bf16), planes(b, b_bf16)
    if terms is None:
        terms = [(0, 0)] + [(0, 1)] * (len(pb) == 2) + [(1, 0)] * (
            len(pa) == 2)
    pa = [x.astype(np.float64) for x in pa]
    pb = [x.astype(np.float64) for x in pb]
    K = a.shape[1]
    out = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for k0 in range(0, K, KSEG):
        end = min(k0 + KSEG, K)
        acc = np.zeros_like(out)
        for s0 in range(k0, end, stage):
            part = np.zeros_like(out)
            for k in range(s0, min(s0 + stage, end), MMA_K):
                for i, j in terms:
                    part = trunc(part + pa[i][:, k:k + MMA_K]
                                 @ pb[j][k:k + MMA_K])
            acc += part
        out += acc
    return out


def rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.fixture(scope="module")
def boundary():
    """Seeded boundary inputs at the training width: feats, w_head f32,
    labels, per-client prior tables (tau 1) picked per token, weights with
    padded rows, and the float64 z, lse and softmax cotangent g."""
    rng = np.random.default_rng(16)
    feats = rng.standard_normal((N, D)).astype(np.float32)
    w = (rng.standard_normal((D, V)) * D ** -0.5).astype(np.float32)
    labels = rng.integers(0, V, N)
    p = rng.dirichlet(np.ones(V) * 0.3, size=G)
    adj = np.log(p + 1e-8)[np.arange(N) * G // N]
    weights = np.ones(N)
    weights[-N // 8:] = 0.0
    ts = weights / weights.sum()
    return feats, w, labels, adj, ts


def exact(feats, w, labels, adj, ts):
    z = feats.astype(np.float64) @ w.astype(np.float64)
    za = z + adj
    lse = np.log(np.exp(za - za.max(-1, keepdims=True)).sum(-1)) \
        + za.max(-1)
    g = np.exp(za - lse[:, None])
    g[np.arange(N), labels] -= 1.0
    g *= ts[:, None]
    return z, lse, g


@pytest.mark.parametrize("feats_dtype", ["bf16", "f32"])
def test_split_tf32_meets_the_kernels_tolerances(boundary, feats_dtype):
    """z (2 products with bf16 feats, 3 with f32), the adjusted lse, df =
    g W^T (3: g and W are f32) and dW = feats^T g (2 or 3) against float64:
    within the kernels' tolerances, and about as close as plain float32
    products summed in the same segments."""
    feats, w, labels, adj, ts = boundary
    is_bf16 = feats_dtype == "bf16"
    if is_bf16:
        feats = bf16(feats)
    z64, lse64, g64 = exact(feats, w, labels, adj, ts)
    z = product(feats, w, is_bf16, False)
    assert rel(z, z64) <= TOL_Z
    za = z.astype(np.float64) + adj
    lse = np.log(np.exp(za - za.max(-1, keepdims=True)).sum(-1)) \
        + za.max(-1)
    assert rel(lse, lse64) <= TOL_LSE
    g = g64.astype(np.float32)
    df = product(g, np.ascontiguousarray(w.T), False, False)
    df64 = g64 @ w.T.astype(np.float64)
    assert rel(df, df64) <= TOL_DF
    dw = product(np.ascontiguousarray(feats.T), g, is_bf16, False)
    dw64 = feats.T.astype(np.float64) @ g64
    assert rel(dw, dw64) <= TOL_DW
    assert np.all(df[ts == 0] == 0)             # padded rows: exactly 0
    df_f32 = np.zeros_like(df)
    for k in range(0, V, KSEG):
        df_f32 += g[:, k:k + KSEG] @ np.ascontiguousarray(w.T)[k:k + KSEG]
    assert rel(df, df64) <= 2 * rel(df_f32, df64)


@pytest.mark.parametrize("quantity", ["z", "df"])
def test_one_truncating_chain_misses_the_tolerance(boundary, quantity):
    """The same products summed as one tensor-core chain over each
    1024-deep segment (no fresh partial a stage): every instruction's
    truncation adds the same way, and z with f32 feats and df land
    ~1e-5 of the largest entry from float64, outside the kernels'
    tolerance that the staged chains meet with a tenth of it."""
    feats, w, labels, adj, ts = boundary
    z64, _, g64 = exact(feats, w, labels, adj, ts)
    if quantity == "z":
        a, b, want = feats, w, z64
    else:
        a, b = g64.astype(np.float32), np.ascontiguousarray(w.T)
        want = g64 @ w.T.astype(np.float64)
    staged = rel(product(a, b, False, False), want)
    chain = rel(product(a, b, False, False, stage=KSEG), want)
    assert staged <= TOL_DF / 10, staged
    assert chain > TOL_DF, chain


@pytest.mark.parametrize("quantity", ["z", "df"])
def test_one_tf32_product_misses_the_tolerance(boundary, quantity):
    """A single TF32 product (both operands rounded to TF32 once) lands
    ~1e-4 of the largest entry from float64: 20-40x outside the 1e-5 that
    the kernels meet, so one term cannot replace the split."""
    feats, w, labels, adj, ts = boundary
    feats = bf16(feats)
    z64, _, g64 = exact(feats, w, labels, adj, ts)
    if quantity == "z":
        err = rel(product(feats, w, True, False, terms=[(0, 0)]), z64)
        assert err > TOL_Z, err
    else:
        df = product(g64.astype(np.float32), np.ascontiguousarray(w.T),
                     False, False, terms=[(0, 0)])
        err = rel(df, g64 @ w.T.astype(np.float64))
        assert err > TOL_DF, err


def test_f32_product_needs_the_lo_hi_term(boundary):
    """f32 x f32 (df) without lo.hi, hi.(hi + lo) only, misses df's
    tolerance: the third product is what keeps g's own low bits."""
    feats, w, labels, adj, ts = boundary
    _, _, g64 = exact(bf16(feats), w, labels, adj, ts)
    df = product(g64.astype(np.float32), np.ascontiguousarray(w.T), False,
                 False, terms=[(0, 0), (0, 1)])
    err = rel(df, g64 @ w.T.astype(np.float64))
    assert err > TOL_DF, err


def test_tf32_rounding_is_nearest_ties_away():
    """The emulated cvt.rna.tf32.f32 keeps 10 explicit bits, rounds to
    nearest and ties away from zero, and leaves TF32 values alone."""
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)
    x = np.array([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 4, 1 + 3 * ulp / 4,
                  1 + ulp], np.float32)
    np.testing.assert_array_equal(
        tf32(x), np.array([1 + ulp, -(1 + ulp), one, 1 + ulp, 1 + ulp],
                          np.float32))
    hi = tf32(x)
    assert np.array_equal(tf32(hi), hi)
