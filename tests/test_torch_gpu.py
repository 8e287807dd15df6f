"""The port's CUDA kernels against their plain versions, on a card.

Marked ``gpu``: without a CUDA device every test skips (the kernels have
no CPU mode). Imports only torch and the port, so it runs on a machine
without JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import importlib.util
import os

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attn import kernel, ops, ref
from repro_torch.kernels.lace import kernel as lace_kernel
from repro_torch.kernels.lace import ops as lace_ops
from repro_torch.kernels.mlstm import kernel as mlstm_kernel
from repro_torch.kernels.mlstm import ops as mlstm_ops
from repro_torch.kernels.mlstm import ref as mlstm_ref


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False


def _qkv(seed, B, S, H, KV, hd, dtype):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(shape, np.float32))
                 .to("cuda", dtype)
                 for shape in ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd)))


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,H,KV,hd,window,dtype", [
    (1, 128, 16, 16, 64, None, torch.bfloat16),
    (1, 777, 16, 16, 64, None, torch.float32),
    (1, 333, 16, 2, 64, None, torch.bfloat16),      # GQA
    (1, 1024, 16, 16, 64, 256, torch.bfloat16),     # sliding window
    (2, 200, 3, 3, 32, 7, torch.bfloat16),          # odd window, ragged S
    (2, 96, 2, 1, 16, None, torch.bfloat16),
    (1, 64, 2, 2, 8, None, torch.bfloat16),         # hd 8: CUDA-core body
    (2, 200, 3, 3, 16, 7, torch.float32),
    # the tile edges of the tensor-core body: 64- and 128-row query tiles,
    # 64-key tiles
    (1, 1, 2, 2, 64, None, torch.bfloat16),         # S = 1
    (2, 63, 4, 4, 64, None, torch.bfloat16),
    (2, 65, 4, 4, 64, None, torch.bfloat16),
    (1, 127, 4, 4, 64, None, torch.bfloat16),
    (1, 129, 4, 4, 64, None, torch.bfloat16),
    (1, 200, 4, 4, 64, 5, torch.bfloat16),          # window below a key tile
    (1, 300, 8, 1, 64, None, torch.bfloat16),       # GQA, 8 heads a kv head
    (1, 333, 4, 2, 128, None, torch.bfloat16),      # hd 128
    (1, 130, 2, 2, 128, 37, torch.bfloat16),
    (1, 257, 2, 2, 128, None, torch.bfloat16),
    (2, 127, 4, 2, 64, None, torch.bfloat16),
    (1, 129, 8, 1, 64, 5, torch.bfloat16),
    (1, 300, 2, 1, 16, 70, torch.bfloat16),
    # the served qwen3-moe-30b-a3b's longest prompt: hd 128, 32 heads on 4
    # KV heads
    (1, 777, 32, 4, 128, None, torch.bfloat16),
    # the served jamba-1.5-large-398b's: hd 128, 64 heads on 8 KV heads
    (1, 777, 64, 8, 128, None, torch.bfloat16),
])
def test_flash_kernel_matches_plain(B, S, H, KV, hd, window, dtype):
    _needs_card()
    # bf16: the output is rounded to bf16; f32: sums in another order
    tol = {torch.float32: 1e-4, torch.bfloat16: 3e-2}[dtype]
    q, k, v = _qkv(S + hd, B, S, H, KV, hd, dtype)
    before = ops.LAUNCHES
    got = ops.flash_attention(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    assert ops.LAUNCHES == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    want = ref.mha_ref(q, k, v, causal=True, window=window)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol, err


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,H,KV,hd,window,dtype", [
    (2, 200, 4, 4, 64, None, torch.bfloat16),       # ragged S
    (1, 130, 4, 2, 64, None, torch.float32),        # GQA
    (1, 300, 2, 2, 64, 37, torch.bfloat16),         # sliding window
    (2, 70, 4, 1, 16, 9, torch.float32),
    (1, 96, 2, 2, 128, None, torch.bfloat16),
    (1, 40, 2, 2, 8, None, torch.float32),
    # the tile edges of the tensor-core backward: 64-key dk/dv tiles,
    # 64-row query steps (32 at hd 128), 64-row dq tiles
    (1, 1, 2, 2, 64, None, torch.bfloat16),         # S = 1
    (2, 63, 4, 4, 64, None, torch.bfloat16),
    (1, 65, 4, 4, 64, None, torch.bfloat16),
    (1, 129, 8, 1, 64, None, torch.bfloat16),       # GQA, 8 heads a kv head
    (1, 200, 2, 2, 64, 5, torch.bfloat16),          # window below a key tile
    (1, 97, 2, 2, 32, None, torch.bfloat16),
    (1, 33, 2, 2, 128, 9, torch.bfloat16),
    (1, 40, 2, 2, 8, None, torch.bfloat16),         # hd 8: CUDA-core body
    # qwen3-moe-30b-a3b's training: the server's 16 x 512 and a client's
    # 4 x 512, 32 heads of 128 on 4 KV heads
    (16, 512, 32, 4, 128, None, torch.bfloat16),
    (4, 512, 32, 4, 128, None, torch.bfloat16),
])
def test_flash_backward_matches_autograd_of_plain(B, S, H, KV, hd, window,
                                                  dtype):
    """K3's forward (with lse) and backward through the autograd Function:
    the gradients reach q, k and v and match autograd of the plain
    version. bf16: inputs and grads rounded to bf16 (2^-8 relative);
    f32: sums in another order."""
    _needs_card()
    q, k, v = (t.requires_grad_() for t in _qkv(hd + S, B, S, H, KV, hd,
                                                  dtype))
    gout = torch.randn(q.shape, generator=torch.Generator("cuda").manual_seed(
        3), device="cuda").to(dtype)
    before = (ops.LAUNCHES, ops.LAUNCHES_BWD)
    out = ops.flash_attention(q, k, v, causal=True, window=window)
    assert out.grad_fn is not None
    dq, dk, dv = torch.autograd.grad(out, (q, k, v), gout)
    torch.cuda.synchronize()
    assert (ops.LAUNCHES, ops.LAUNCHES_BWD) == (before[0] + 1, before[1] + 1)
    want = ref.mha_ref(q, k, v, causal=True, window=window)
    wq, wk, wv = torch.autograd.grad(want, (q, k, v), gout)
    rtol = {torch.float32: 1e-4, torch.bfloat16: 3e-2}[dtype]
    for name, got, exp in (("out", out, want), ("dq", dq, wq), ("dk", dk, wk),
                           ("dv", dv, wv)):
        assert got is not None and got.shape == exp.shape, name
        err = (got.float() - exp.float()).abs().max().item()
        scale = exp.float().abs().max().item()
        assert err <= rtol * max(scale, 1.0), (name, err, scale)

    _, lse = kernel.flash_attention_cuda(q.detach(), k.detach(), v.detach(),
                                         causal=True, window=window,
                                         return_lse=True)
    qf, kf = q.detach().float(), k.detach().float()
    reps = H // KV
    kf = kf.repeat_interleave(reps, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * hd ** -0.5
    i = torch.arange(S, device="cuda")
    mask = i[None, :] <= i[:, None]
    if window is not None:
        mask &= (i[:, None] - i[None, :]) < window
    want_lse = s.masked_fill(~mask, float("-inf")).logsumexp(-1)
    assert (lse - want_lse).abs().max().item() <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,Skv,H,KV,hd,dtype", [
    # whisper-tiny's cross-attention: a training step's 16 x 448 text
    # queries and a decode step's 8 x 1 on 1500 audio frames, 6 heads of 64
    (16, 448, 1500, 6, 6, 64, torch.bfloat16),
    (8, 1, 1500, 6, 6, 64, torch.bfloat16),
    # ragged key counts against the 64-key tiles (under a decode step's
    # single queries too), more queries than keys, GQA, hd 128, float32
    (2, 9, 130, 4, 2, 64, torch.float32),
    (1, 200, 65, 4, 4, 64, torch.bfloat16),
    (8, 1, 65, 6, 6, 64, torch.bfloat16),
    (1, 100, 257, 4, 4, 128, torch.bfloat16),
    (2, 33, 1, 2, 1, 16, torch.float32),
])
def test_flash_noncausal_matches_plain(B, S, Skv, H, KV, hd, dtype):
    """K3's non-causal mode over Skv != S keys (cross-attention): the
    forward and, through the autograd Function, the backward against the
    plain version and autograd of it, each relative to the plain side's
    largest entry (the output bf16 1e-2, ~1 bf16 ulp of it, since over
    1500 keys that entry is ~0.3 and an absolute bound would pass a key
    tile dropped or left unmasked past Skv; the gradients bf16 3e-2; f32
    1e-4); a second backward is bitwise equal."""
    _needs_card()
    rng = np.random.default_rng(S + Skv + hd)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape, np.float32))
               .to("cuda", dtype).requires_grad_()
               for shape in ((B, S, H, hd), (B, Skv, KV, hd),
                             (B, Skv, KV, hd)))
    gout = torch.from_numpy(rng.standard_normal((B, S, H, hd), np.float32)
                            ).to("cuda", dtype)
    before = (ops.LAUNCHES, ops.LAUNCHES_BWD)
    out = ops.flash_attention(q, k, v, causal=False)
    grads = torch.autograd.grad(out, (q, k, v), gout)
    torch.cuda.synchronize()
    assert (ops.LAUNCHES, ops.LAUNCHES_BWD) == (before[0] + 1, before[1] + 1)
    want = ref.mha_ref(q, k, v, causal=False)
    wgrads = torch.autograd.grad(want, (q, k, v), gout)
    for name, got, exp in zip(("out", "dq", "dk", "dv"), (out,) + grads,
                              (want,) + wgrads):
        assert got.shape == exp.shape, name
        rtol = {torch.float32: 1e-4,
                torch.bfloat16: 1e-2 if name == "out" else 3e-2}[dtype]
        err = (got.float() - exp.float()).abs().max().item()
        scale = exp.float().abs().max().item()
        if Skv == 1:    # softmax over one key: dq and dk vanish exactly
            scale = max(scale, 1.0)
        assert err <= rtol * scale, (name, err, scale)
    again = torch.autograd.grad(ops.flash_attention(q, k, v, causal=False),
                                (q, k, v), gout)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_strided_views_match_plain(dtype):
    """q, k, v as head slices of one fused (B, S, H + 2 KV, hd) projection
    (strided, the last axis contiguous, 16-byte aligned for bf16): the
    output and the gradient of the fused buffer match the plain version's
    (bf16 3e-2, f32 1e-4 of the largest entry)."""
    _needs_card()
    B, S, H, KV, hd = 2, 150, 4, 2, 64
    rng = np.random.default_rng(11)
    qkv = torch.from_numpy(rng.standard_normal((B, S, H + 2 * KV, hd),
                                               np.float32)).to("cuda", dtype)
    gout = torch.from_numpy(rng.standard_normal((B, S, H, hd), np.float32)
                            ).to("cuda", dtype)
    rtol = {torch.float32: 1e-4, torch.bfloat16: 3e-2}[dtype]
    grads = []
    for attend in (ops.flash_attention, ref.mha_ref):
        x = qkv.clone().requires_grad_()
        q, k, v = x.split([H, KV, KV], dim=2)
        assert q.stride() == k.stride() and not q.is_contiguous()
        out = attend(q, k, v, causal=True, window=None)
        grads.append((out, torch.autograd.grad(out, x, gout)[0]))
    torch.cuda.synchronize()
    for got, exp in zip(grads[0], grads[1]):
        err = (got.float() - exp.float()).abs().max().item()
        assert err <= rtol * max(exp.float().abs().max().item(), 1.0), err


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,H,KV,hd,window,dtype", [
    (2, 300, 8, 2, 64, None, torch.bfloat16),
    (1, 517, 4, 4, 64, 100, torch.bfloat16),
    (1, 200, 2, 2, 128, None, torch.bfloat16),
    (1, 130, 4, 2, 64, None, torch.float32),
    (4, 512, 32, 4, 128, None, torch.bfloat16),     # qwen3-moe's client
])
def test_flash_backward_is_deterministic(B, S, H, KV, hd, window, dtype):
    """The backward sums every gradient in one order, with no atomics:
    two calls on the same inputs give bitwise-equal dq, dk and dv."""
    _needs_card()
    q, k, v = _qkv(S + 5, B, S, H, KV, hd, dtype)
    out, lse = kernel.flash_attention_cuda(q, k, v, causal=True,
                                           window=window, return_lse=True)
    gout = torch.randn(q.shape, generator=torch.Generator("cuda").manual_seed(
        7), device="cuda").to(dtype)
    first = kernel.flash_attention_bwd_cuda(q, k, v, out, lse, gout,
                                            causal=True, window=window)
    second = kernel.flash_attention_bwd_cuda(q, k, v, out, lse, gout,
                                             causal=True, window=window)
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(a, b), name


@pytest.mark.gpu
def test_flash_refuses_misaligned_bf16():
    """A bf16 tensor that breaks the 16-byte rule (a start 2 bytes past a
    boundary, or a row stride not a multiple of 8 elements) raises
    ValueError in the forward and the backward launcher alike."""
    _needs_card()
    B, S, H, hd = 1, 64, 2, 64
    q, k, v = _qkv(1, B, S, H, H, hd, torch.bfloat16)
    flat = torch.zeros(q.numel() + 8, dtype=torch.bfloat16, device="cuda")
    shifted = flat[1:1 + q.numel()].view(q.shape)           # start + 2 bytes
    wide = torch.zeros((B, S, H, hd + 4), dtype=torch.bfloat16,
                       device="cuda")[..., :hd]             # stride hd + 4
    out, lse = kernel.flash_attention_cuda(q, k, v, return_lse=True)
    for bad in (shifted, wide):
        assert not kernel.aligned(bad)
        with pytest.raises(ValueError, match="16-byte"):
            kernel.flash_attention_cuda(bad, k, v)
        with pytest.raises(ValueError, match="16-byte"):
            kernel.flash_attention_cuda(q, bad, v)
        with pytest.raises(ValueError, match="16-byte"):
            kernel.flash_attention_bwd_cuda(q, k, v, out, lse, bad)
        with pytest.raises(ValueError, match="16-byte"):
            kernel.flash_attention_bwd_cuda(q, k, bad, out, lse, out)


def _lace_inputs(seed, G, N, d, V, feats_dtype, zero_rows=True):
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(a).to("cuda")
    feats = t(rng.standard_normal((G, N, d), np.float32)).to(feats_dtype)
    w_head = t(rng.standard_normal((d, V), np.float32) * d ** -0.5)
    labels = t(rng.integers(0, V, (G, N)).astype(np.int64))
    weights = np.ones((G, N), np.float32)
    if zero_rows:
        weights[:, -N // 5:] = 0.0               # padded, weight-0 rows
    p_s = rng.dirichlet(np.ones(V))[None].astype(np.float32)
    p_k = rng.dirichlet(np.ones(V) * 0.3, size=G).astype(np.float32)
    p_k[:, : V // 7] = 0.0                       # labels a client never saw
    return feats, w_head, labels, t(weights), t(p_s), t(p_k)


@pytest.mark.gpu
@pytest.mark.parametrize("G,N,d,V,feats_dtype,tau,vchunk", [
    (2, 100, 64, 1000, torch.float32, 1.0, None),      # ragged N and V
    (4, 64, 128, 777, torch.bfloat16, 1.0, None),
    (1, 300, 96, 515, torch.float32, 0.0, None),       # tau = 0
    (2, 128, 64, 256, torch.bfloat16, 0.5, None),
    # sums longer than one 1024-product chain: dW over 1200 tokens, df
    # over vocab chunks of 256 columns (10 chunks), then over 3000 columns
    (3, 400, 64, 2500, torch.float32, 1.0, 256),
    (2, 700, 32, 3000, torch.bfloat16, 1.0, None),
    # d not a multiple of 8: the masked depth edge of the product tiles
    (2, 150, 100, 1200, torch.bfloat16, 1.0, None),
])
def test_lace_kernels_match_plain(G, N, d, V, feats_dtype, tau, vchunk,
                                  monkeypatch):
    """K1 + K2 against the plain chunked version on the same inputs: the
    losses at rel 1e-4, df and dW at 1e-5 of their largest entry (f32 on
    the tensor cores in split TF32, sums in another order); weight-0 rows
    get exactly zero gradient. ``vchunk`` shrinks K2's workspace to that many vocab
    columns per chunk."""
    _needs_card()
    if vchunk is not None:
        monkeypatch.setattr(lace_kernel, "WORKSPACE_BYTES", 8 * G * N * vchunk)
        assert lace_kernel.bwd_chunk(G * N, V) == vchunk
    feats, w_head, labels, weights, p_s, p_k = _lace_inputs(
        G + N + V, G, N, d, V, feats_dtype)
    ids = torch.arange(G, device="cuda")
    args = (feats, w_head, labels, p_s, None, p_k, ids, weights, tau, 1e-8)
    before = (lace_ops.LAUNCHES_FWD, lace_ops.LAUNCHES_BWD)
    got = lace_ops.lace2_grads(*args, chunk=64)
    torch.cuda.synchronize()
    assert (lace_ops.LAUNCHES_FWD, lace_ops.LAUNCHES_BWD) == (
        before[0] + 1, before[1] + 1)
    want = lace_ops.lace2_grads_plain(*args, 64, True, None)
    for name, a, b in zip(("loss_s", "loss_k"), got[:2], want[:2]):
        assert abs(a.item() - b.item()) <= 1e-4 * abs(b.item()), name
    for name, a, b in zip(("df_s", "df_k", "dW_s"), got[2:5], want[2:5]):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        err = (a.float() - b.float()).abs().max().item()
        tol = 1e-5 * b.float().abs().max().item()
        if feats_dtype == torch.bfloat16 and name != "dW_s":
            tol = 1e-2 * b.float().abs().max().item()   # rounded to bf16
        assert err <= tol, (name, err, tol)
    zero = weights == 0
    assert torch.all(got[2][zero] == 0) and torch.all(got[3][zero] == 0)
    assert got[5].item() == weights.sum().item()


@pytest.mark.gpu
@pytest.mark.parametrize("feats_dtype", [torch.bfloat16, torch.float32])
def test_lace_kernels_are_deterministic(feats_dtype, monkeypatch):
    """K1, K2, K4 and K5 (server side with dW, client side without), each
    run twice on the same inputs: bitwise equal (no atomics, every sum in
    one fixed order). The backward walks the vocab in chunks of 1024
    columns (2048 for one side), so df sums across chunks."""
    _needs_card()
    G, N, d, V = 4, 1100, 96, 3000
    monkeypatch.setattr(lace_kernel, "WORKSPACE_BYTES", 8 * N * 1024)
    feats, w_head, labels, weights, p_s, p_k = _lace_inputs(
        7, G, N // G, d, V, feats_dtype)
    feats = feats.reshape(N, d)
    labels = labels.reshape(N).to(torch.int32).contiguous()
    adj_s = torch.log(p_s + 1e-8).contiguous()
    adj_k = torch.log(p_k + 1e-8).contiguous()
    ids = torch.arange(N, device="cuda", dtype=torch.int32) * G // N
    ts = (weights.reshape(N) / weights.sum()).contiguous()
    fwd = lace_kernel.lace2_fwd_cuda(feats, w_head, labels, adj_s, None,
                                     adj_k, ids)
    runs = {
        "K1": lambda: lace_kernel.lace2_fwd_cuda(
            feats, w_head, labels, adj_s, None, adj_k, ids),
        "K2": lambda: lace_kernel.lace2_bwd_cuda(
            feats, w_head, labels, adj_s, None, adj_k, ids, fwd[2], fwd[3],
            ts, ts),
        "K4": lambda: lace_kernel.lace_fwd_cuda(feats, w_head, labels,
                                                adj_k, ids),
        "K5 server": lambda: lace_kernel.lace_bwd_cuda(
            feats, w_head, labels, adj_s, None, fwd[2], ts, True),
        "K5 client": lambda: lace_kernel.lace_bwd_cuda(
            feats, w_head, labels, adj_k, ids, fwd[3], ts, False),
    }
    for name, run in runs.items():
        first, second = run(), run()
        for a, b in zip(first, second):
            assert (a is None) == (b is None), name
            assert a is None or torch.equal(a, b), name


@pytest.mark.gpu
@pytest.mark.parametrize("N,d,V,head_dtype", [
    (256, 384, 51865, torch.float32),       # whisper-tiny: f32 params
    (256, 6144, 92553, torch.bfloat16),     # internvl2-26b: bf16 params
])
def test_lace_kernels_at_odd_vocab(N, d, V, head_dtype):
    """K1 + K2 at the frontend archs' odd vocabularies, whose head rows do
    not start on 16-byte boundaries (the operands' plain-copy path),
    against the plain version under the tolerances above, bf16 feats; a
    second run bitwise equal."""
    _needs_card()
    feats, w_head, labels, weights, p_s, p_k = _lace_inputs(
        V, 2, N // 2, d, V, torch.bfloat16)
    w_head = w_head.to(head_dtype)
    ids = torch.arange(2, device="cuda")
    args = (feats, w_head, labels, p_s, None, p_k, ids, weights, 1.0, 1e-8)
    got = lace_ops.lace2_grads(*args, chunk=64)
    again = lace_ops.lace2_grads(*args, chunk=64)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got[:5], again[:5]))
    want = lace_ops.lace2_grads_plain(*args, 64, True, None)
    for name, a, b in zip(("loss_s", "loss_k"), got[:2], want[:2]):
        assert abs(a.item() - b.item()) <= 1e-4 * abs(b.item()), name
    for name, a, b in zip(("df_s", "df_k", "dW_s"), got[2:5], want[2:5]):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        err = (a.float() - b.float()).abs().max().item()
        tol = 1e-5 * b.float().abs().max().item()
        if name != "dW_s" or head_dtype == torch.bfloat16:
            tol = 1e-2 * b.float().abs().max().item()   # rounded to bf16
        assert err <= tol, (name, err, tol)


@pytest.mark.gpu
def test_lace_absent_side_and_raw_sums():
    """A side without a prior (plain CE) and ``mean=False`` raw sums."""
    _needs_card()
    feats, w_head, labels, weights, p_s, p_k = _lace_inputs(
        5, 2, 90, 64, 700, torch.float32)
    args = (feats, w_head, labels, None, None, p_k, torch.arange(
        2, device="cuda"), weights, 1.0, 1e-8)
    got = lace_ops.lace2_grads(*args, chunk=32, mean=False)
    want = lace_ops.lace2_grads_plain(*args, 32, False, None)
    for a, b in zip(got[:5], want[:5]):
        err = (a.float() - b.float()).abs().max().item()
        assert err <= 1e-4 * max(1.0, b.float().abs().max().item()), err


@pytest.mark.gpu
@pytest.mark.parametrize("mean", [True, False])
def test_lace_pair_ops_on_card_match_cpu(mean):
    """``lace2_loss`` / ``lace2_nll_sum`` (the pair ops: K1 forward, one K2
    over the tokens stacked twice in the backward) through autograd on a
    card against the same calls on the CPU (the plain versions): values
    at 1e-5 relative, the folded df and dW at 1e-5 of their largest
    entry; one K1 and one K2 launch, counted raw with ``mean=False``."""
    _needs_card()
    feats, w_head, labels, weights, p_s, p_k = _lace_inputs(
        13, 3, 120, 64, 900, torch.float32)
    ids = torch.arange(3, device="cuda")
    op = lace_ops.lace2_loss if mean else lace_ops.lace2_nll_sum
    res = {}
    for dev in ("cuda", "cpu"):
        f = feats.to(dev).requires_grad_()
        wh = w_head.to(dev).requires_grad_()
        before = (lace_ops.LAUNCHES_FWD, lace_ops.LAUNCHES_BWD,
                  lace_ops.LAUNCHES_RAW["K1"], lace_ops.LAUNCHES_RAW["K2"])
        out_s, out_k = op(f, wh, labels.to(dev), p_s.to(dev), None,
                          p_k.to(dev), ids.to(dev), weights.to(dev), 1.0,
                          1e-8, 64)
        df, dw = torch.autograd.grad(0.7 * out_s - 1.3 * out_k, (f, wh))
        after = (lace_ops.LAUNCHES_FWD, lace_ops.LAUNCHES_BWD,
                 lace_ops.LAUNCHES_RAW["K1"], lace_ops.LAUNCHES_RAW["K2"])
        launched = tuple(a - b for a, b in zip(after, before))
        want = ((1, 1) + ((0, 0) if mean else (1, 1)) if dev == "cuda"
                else (0, 0, 0, 0))
        assert launched == want, launched
        res[dev] = (out_s.item(), out_k.item(), df.cpu(), dw.cpu())
    for a, b in zip(res["cuda"][:2], res["cpu"][:2]):
        assert abs(a - b) <= 1e-5 * abs(b)
    for a, b in zip(res["cuda"][2:], res["cpu"][2:]):
        assert (a - b).abs().max().item() <= 1e-5 * b.abs().max().item()


@pytest.mark.gpu
def test_lace_dp_ops_on_a_one_rank_nccl_grid_match_single_program(tmp_path):
    """``lace2_grads_dp`` and ``lace_loss_dp`` on a card over a one-rank
    NCCL grid (raw sums through K1 / K2 and K4 / K5, one scalar and one
    dW all_reduce each) against the single-program ops on the card: 1e-5
    of each output's largest entry."""
    _needs_card()
    import torch.distributed as dist

    from repro_torch.sharding import init_local_group, make_host_grid

    made = init_local_group("nccl")
    try:
        grid = make_host_grid()
        feats, w_head, labels, weights, p_s, p_k = _lace_inputs(
            17, 2, 96, 64, 700, torch.float32)
        ids = torch.arange(2, device="cuda")
        args = (feats, w_head, labels, p_s, None, p_k, ids, weights, 1.0,
                1e-8, 64)
        got = lace_ops.lace2_grads_dp(*args, grid=grid)
        want = lace_ops.lace2_grads(*args)[:5]
        for a, b in zip(got, want):
            err = (a.float() - b.float()).abs().max().item()
            assert err <= 1e-5 * max(1e-6, b.float().abs().max().item())
        res = []
        for g in (grid, None):
            f = feats.clone().requires_grad_()
            wh = w_head.clone().requires_grad_()
            loss = lace_ops.lace_loss_dp(f, wh, labels, p_k, ids, weights,
                                         1.0, 1e-8, 64, grid=g)
            res.append((loss.detach(),) + torch.autograd.grad(loss, (f, wh)))
        for a, b in zip(*res):
            err = (a - b).abs().max().item()
            assert err <= 1e-5 * max(1e-6, b.abs().max().item())
    finally:
        if made:
            dist.destroy_process_group()


@pytest.mark.gpu
def test_split_step_on_card_matches_cpu():
    """One SCALA split step of reduced qwen1.5-0.5b in float32 through the
    kernels (K1, K2, K3 forward and backward) against the same step on the
    CPU (the plain versions): losses at 1e-5 relative, every grad leaf at
    1e-4 of its largest entry (float32 sums in other orders). The step
    launches each kernel as often as the layout says: the client blocks
    once forward and once back per client, the server blocks once forward
    and twice back (one pullback per prior), K1 and K2 once."""
    _needs_card()
    from repro_torch.configs import ScalaConfig, get_config
    from repro_torch.core import engine
    from repro_torch.core.scala import transformer_split_model
    from repro_torch.core.split import stack_client_params
    from repro_torch.models import transformer
    from repro_torch.tree import leaves, tree_map

    cfg = get_config("qwen1.5-0.5b").reduced()
    C, S = 3, 24
    full = transformer.init_params(torch.Generator().manual_seed(0), cfg)
    params = {"client": stack_client_params(full["client"], C),
              "server": full["server"]}
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (C, 2, S + 1))
    weights = np.ones((C, 2, S), np.float32)
    weights[-1, 1] = 0.0                         # a padded row
    batch = {"tokens": toks[..., :-1], "labels": toks[..., 1:],
             "weights": weights}
    model = transformer_split_model(cfg)
    sc = ScalaConfig(num_clients=C)

    def counts():
        return (ops.LAUNCHES, ops.LAUNCHES_BWD, lace_ops.LAUNCHES_FWD,
                lace_ops.LAUNCHES_BWD)

    res = {}
    for dev in ("cuda", "cpu"):
        before = counts()
        res[dev] = engine.split_step_grads(
            model, tree_map(lambda a: a.to(dev), params),
            {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}, sc)
        launched = tuple(a - b for a, b in zip(counts(), before))
        n_client = cfg.split_layer
        n_server = cfg.num_layers - cfg.split_layer
        want = ((C * n_client + n_server, C * n_client + 2 * n_server, 1, 1)
                if dev == "cuda" else (0, 0, 0, 0))
        assert launched == want, (dev, launched, want)
    (g_dev, m_dev), (g_cpu, m_cpu) = res["cuda"], res["cpu"]
    for key in ("loss_server", "loss_client"):
        a, b = float(m_dev[key]), float(m_cpu[key])
        assert abs(a - b) <= 1e-5 * abs(b), (key, a, b)
    for a, b in zip(leaves(g_dev), leaves(g_cpu)):
        err = (a.cpu() - b).abs().max().item()
        assert err <= 1e-4 * max(b.abs().max().item(), 1e-30), err


@pytest.mark.gpu
@pytest.mark.parametrize("N,d,V,feats_dtype,tau,side,vchunk", [
    (200, 64, 1000, torch.float32, 1.0, "server", None),    # ragged N, V
    (333, 96, 777, torch.bfloat16, 1.0, "client", None),
    (300, 96, 515, torch.float32, 0.0, "server", None),     # tau = 0
    (128, 64, 256, torch.bfloat16, 0.5, "client", None),
    (1201, 64, 2500, torch.float32, 1.0, "server", 256),    # long sums
    (700, 32, 3000, torch.bfloat16, 1.0, "none", None),     # plain CE
    (300, 100, 1200, torch.float32, 1.0, "server", None),   # d % 8 != 0
])
def test_lace_single_kernels_match_plain(N, d, V, feats_dtype, tau, side,
                                         vchunk, monkeypatch):
    """K4 and K5 against their plain versions on the same arguments: the
    server side (one prior row, dW) and the client side (4 rows picked
    per token, no dW), or no prior. nll and lse within 1e-4 of their
    largest entry, df and dW within 1e-5 (split TF32 at f32 accuracy,
    sums in the same 1024-product slices); weight-0 rows get exactly zero df.
    ``vchunk`` shrinks K5's workspace to that many vocab columns per
    chunk, so df sums over several chunks."""
    _needs_card()
    from repro_torch.kernels.lace import ref as lace_ref

    if vchunk is not None:
        monkeypatch.setattr(lace_kernel, "WORKSPACE_BYTES", 4 * N * vchunk)
        assert lace_kernel.bwd_chunk(N, V, sides=1) == vchunk
    feats, w_head, labels, weights, p_s, p_k = _lace_inputs(
        N + V, 4, N // 4 + 1, d, V, feats_dtype)
    feats = feats.reshape(-1, d)[:N]
    labels = labels.reshape(-1)[:N].to(torch.int32).contiguous()
    weights = weights.reshape(-1)[:N].contiguous()
    rows = {"server": p_s, "client": p_k, "none": None}[side]
    adj = None if rows is None else (tau * torch.log(rows + 1e-8)).contiguous()
    ids = (torch.arange(N, device="cuda", dtype=torch.int32) * 4 // N
           if side == "client" else None)
    want_dw = side != "client"
    before = (lace_ops.LAUNCHES_FWD1, lace_ops.LAUNCHES_BWD1)
    nll, lse = lace_kernel.lace_fwd_cuda(feats, w_head, labels, adj, ids)
    torch.cuda.synchronize()
    want = lace_ref.lace_fwd_plain(feats, w_head, labels, adj, ids)
    for name, a, b in (("nll", nll, want[0]), ("lse", lse, want[1])):
        err = (a - b).abs().max().item()
        assert err <= 1e-4 * b.abs().max().item(), (name, err)
    ts = (weights / weights.sum()).contiguous()
    df, dw = lace_kernel.lace_bwd_cuda(feats, w_head, labels, adj, ids, lse,
                                       ts, want_dw)
    torch.cuda.synchronize()
    wdf, wdw = lace_ref.lace_bwd_plain(feats, w_head, labels, adj, ids, lse,
                                       ts, want_dw)
    assert (dw is None) == (wdw is None) == (not want_dw)
    for name, a, b in (("df", df, wdf), ("dW", dw, wdw)):
        if b is None:
            continue
        err = (a - b).abs().max().item()
        assert err <= 1e-5 * b.abs().max().item(), (name, err)
    assert torch.all(df[weights == 0] == 0)
    # the wrappers count nothing; the autograd ops do
    assert (lace_ops.LAUNCHES_FWD1, lace_ops.LAUNCHES_BWD1) == before


@pytest.mark.gpu
def test_lace_loss_on_card_matches_cpu():
    """``lace_loss`` through autograd on a card (K4 forward, K5 backward,
    dW skipped when w_head needs no gradient) against the same call on
    the CPU (the plain chunked version): value at 1e-5 relative, df and
    dW at 1e-5 of their largest entry; one K4 and one K5 launch each."""
    _needs_card()
    feats, w_head, labels, weights, p_s, p_k = _lace_inputs(
        9, 3, 150, 64, 900, torch.float32)
    ids = torch.arange(3, device="cuda")
    res = {}
    for dev in ("cuda", "cpu"):
        f = feats.to(dev).requires_grad_()
        wh = w_head.to(dev).requires_grad_()
        before = (lace_ops.LAUNCHES_FWD1, lace_ops.LAUNCHES_BWD1)
        loss = lace_ops.lace_loss(f, wh, labels.to(dev), p_k.to(dev),
                                  ids.to(dev), weights.to(dev), 1.0, 1e-8,
                                  64)
        df, dw = torch.autograd.grad(loss, (f, wh))
        loss_c = lace_ops.lace_loss(f, wh.detach(), labels.to(dev),
                                    p_k.to(dev), ids.to(dev),
                                    weights.to(dev), 1.0, 1e-8, 64)
        (df_c,) = torch.autograd.grad(loss_c, f)
        launched = (lace_ops.LAUNCHES_FWD1 - before[0],
                    lace_ops.LAUNCHES_BWD1 - before[1])
        assert launched == ((2, 2) if dev == "cuda" else (0, 0)), launched
        assert torch.equal(df_c, df)
        res[dev] = (loss.item(), df.cpu(), dw.cpu())
    (lg, dfg, dwg), (lc, dfc, dwc) = res["cuda"], res["cpu"]
    assert abs(lg - lc) <= 1e-5 * abs(lc)
    for a, b in ((dfg, dfc), (dwg, dwc)):
        assert (a - b).abs().max().item() <= 1e-5 * b.abs().max().item()


def _step_on_card_and_cpu(model, params, batch, sc, backend, boundary):
    """One split step on the card and on the CPU from the same params and
    batch, with each kernel's launches during the card's step."""
    from repro_torch.core import engine
    from repro_torch.tree import tree_map

    def counts():
        return (ops.LAUNCHES, ops.LAUNCHES_BWD, lace_ops.LAUNCHES_FWD,
                lace_ops.LAUNCHES_BWD, lace_ops.LAUNCHES_FWD1,
                lace_ops.LAUNCHES_BWD1)

    res, launched = {}, None
    for dev in ("cuda", "cpu"):
        before = counts()
        res[dev] = engine.split_step_grads(
            model, tree_map(lambda a: a.to(dev), params),
            {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}, sc,
            backend=backend, boundary=boundary)
        got = tuple(a - b for a, b in zip(counts(), before))
        if dev == "cuda":
            launched = got
        else:
            assert got == (0,) * 6, got
    return res["cuda"], res["cpu"], launched


def _assert_step_close(dev_res, cpu_res):
    """losses at 1e-5 relative, every grad leaf at 1e-4 of its largest
    entry (float32 sums in other orders)."""
    from repro_torch.tree import leaves

    (g_dev, m_dev), (g_cpu, m_cpu) = dev_res, cpu_res
    for key in ("loss_server", "loss_client"):
        a, b = float(m_dev[key]), float(m_cpu[key])
        assert abs(a - b) <= 1e-5 * abs(b), (key, a, b)
    for a, b in zip(leaves(g_dev), leaves(g_cpu)):
        err = (a.cpu() - b).abs().max().item()
        assert err <= 1e-4 * max(b.abs().max().item(), 1e-30), err


@pytest.mark.gpu
def test_dual_split_step_on_card_matches_cpu():
    """The dual boundary of reduced qwen1.5-0.5b in float32 on the card
    (K4 + K5 twice: eq. 14 with dW, eq. 15 without; K3 forward and
    backward in the trunk; no K1/K2) against the same step on the CPU."""
    _needs_card()
    from repro_torch.configs import ScalaConfig, get_config
    from repro_torch.core.scala import transformer_split_model
    from repro_torch.core.split import stack_client_params
    from repro_torch.models import transformer

    cfg = get_config("qwen1.5-0.5b").reduced()
    C, S = 3, 24
    full = transformer.init_params(torch.Generator().manual_seed(1), cfg)
    params = {"client": stack_client_params(full["client"], C),
              "server": full["server"]}
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (C, 2, S + 1))
    weights = np.ones((C, 2, S), np.float32)
    weights[-1, 1] = 0.0
    batch = {"tokens": toks[..., :-1], "labels": toks[..., 1:],
             "weights": weights}
    dev_res, cpu_res, launched = _step_on_card_and_cpu(
        transformer_split_model(cfg), params, batch, ScalaConfig(
            num_clients=C), "lace", "dual")
    n_client = cfg.split_layer
    n_server = cfg.num_layers - cfg.split_layer
    assert launched == (C * n_client + n_server,
                        C * n_client + 2 * n_server, 0, 0, 2, 2), launched
    _assert_step_close(dev_res, cpu_res)


@pytest.mark.gpu
@pytest.mark.parametrize("boundary", ["fused", "dual"])
def test_alexnet_split_step_on_card_matches_cpu(boundary):
    """One AlexNet split step (width 0.25, s2, backend ``logits``) in
    float32 with TF32 off on the card against the CPU; no kernel of the
    port launches (the logits backend has none)."""
    _needs_card()
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.configs import ScalaConfig
    from repro_torch.core.scala import alexnet_split_model
    from repro_torch.core.split import stack_client_params
    from repro_torch.models import alexnet

    C, B = 3, 6
    full = alexnet.init_params(torch.Generator().manual_seed(2), width=0.25)
    wc, ws = alexnet.split_params(full, "s2")
    params = {"client": stack_client_params(wc, C), "server": ws}
    rng = np.random.default_rng(2)
    batch = {"x": rng.standard_normal((C, B, 32, 32, 3)).astype(np.float32),
             "labels": rng.integers(0, 10, (C, B)),
             "weights": np.ones((C, B), np.float32)}
    dev_res, cpu_res, launched = _step_on_card_and_cpu(
        alexnet_split_model("s2"), params, batch, ScalaConfig(num_clients=C),
        "logits", boundary)
    assert launched == (0,) * 6, launched
    _assert_step_close(dev_res, cpu_res)


def _mlstm_inputs(seed, B, S, H, dk, dv, zero_state):
    """q, k, v, gates and a state on the card; q scaled as the model
    scales it (q.k of order 1), forget gates log-sigmoid(N(2, 1))."""
    rng = np.random.default_rng(seed)

    def n(*shape, scale=1.0):
        return torch.from_numpy(rng.standard_normal(shape, np.float32)
                                * np.float32(scale)).cuda()

    q, k, v = n(B, S, H, dk, scale=dk ** -0.5), n(B, S, H, dk), \
        n(B, S, H, dv)
    i_raw = n(B, S, H)
    f_log = torch.nn.functional.logsigmoid(n(B, S, H) + 2.0)
    state = None if zero_state else (n(B, H, dk, dv), n(B, H, dk), n(B, H))
    return q, k, v, i_raw, f_log, state


def _rel(got, want):
    return ((got - want).abs().max()
            / want.abs().max().clamp(min=1e-30)).item()


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,H,dk,dv,chunk,zero_state,dtype", [
    (1, 777, 4, 1024, 1024, 64, True, torch.float32),  # the served prefill
    (1, 128, 4, 1024, 1024, 64, True, torch.float32),
    (1, 37, 4, 1024, 1024, 64, False, torch.float32),  # odd S below the chunk
    (2, 200, 3, 64, 64, 64, False, torch.float32),     # ragged last chunk
    (1, 13, 2, 128, 96, 8, False, torch.float32),  # short chunks, dv not 64k
    (2, 100, 2, 256, 512, 16, True, torch.float32),
    (1, 64, 1, 512, 32, 64, False, torch.float32),     # exactly one chunk
    # bf16 q, k, v, as the served model passes them
    (1, 777, 4, 1024, 1024, 64, False, torch.bfloat16),
    (1, 128, 4, 1024, 1024, 64, False, torch.bfloat16),
    (2, 200, 3, 64, 64, 64, False, torch.bfloat16),    # ragged last chunk
    (1, 13, 2, 128, 96, 8, False, torch.bfloat16),     # short chunks
])
def test_mlstm_kernel_matches_plain(B, S, H, dk, dv, chunk, zero_state,
                                    dtype):
    """K6 against the plain chunkwise version on the same values in
    float32 (bf16 q, k, v: their float32 copies): h in float32 and the
    final (C, n, m) within 1e-4 of each one's largest entry (float32 sums
    in another order)."""
    _needs_card()
    q, k, v, i_raw, f_log, state = _mlstm_inputs(S + dk, B, S, H, dk, dv,
                                                 zero_state)
    q, k, v = (t.to(dtype) for t in (q, k, v))
    before = mlstm_ops.LAUNCHES
    h, got = mlstm_ops.mlstm_chunkwise(q, k, v, i_raw, f_log, state,
                                       chunk=chunk)
    torch.cuda.synchronize()
    assert mlstm_ops.LAUNCHES == before + 1
    assert h.shape == (B, S, H, dv) and h.dtype == torch.float32
    want_h, want = mlstm_ref.mlstm_chunk_plain(q.float(), k.float(),
                                               v.float(), i_raw, f_log,
                                               state, chunk=chunk)
    assert _rel(h, want_h) <= 1e-4, _rel(h, want_h)
    for name, a, b in zip("Cnm", got, want):
        assert a.shape == b.shape
        assert _rel(a, b) <= 1e-4, (name, _rel(a, b))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mlstm_kernel_strided_views_match_plain(dtype):
    """q, k, v as views: (B, H, S, d) storage seen as (B, S, H, d), and rows
    that start 4 bytes past a 16-byte boundary (the kernel's plain copies
    instead of cp.async), against the plain version on the same values."""
    _needs_card()
    B, S, H, dk, dv = 2, 150, 3, 128, 64
    rng = np.random.default_rng(5)

    def n(*shape):
        return torch.from_numpy(rng.standard_normal(shape, np.float32)).cuda()

    q = (n(B, H, S, dk) * dk ** -0.5).to(dtype).transpose(1, 2)
    k = n(B, S, H, dk + 1).to(dtype)[..., 1:]
    v = n(B, H, S, dv + 2).to(dtype)[..., 2:].transpose(1, 2)
    i_raw = n(B, S, H)
    f_log = torch.nn.functional.logsigmoid(n(B, S, H) + 2.0)
    h, got = mlstm_ops.mlstm_chunkwise(q, k, v, i_raw, f_log, chunk=64)
    torch.cuda.synchronize()
    want_h, want = mlstm_ref.mlstm_chunk_plain(q.float(), k.float(),
                                               v.float(), i_raw, f_log,
                                               chunk=64)
    assert _rel(h, want_h) <= 1e-4, _rel(h, want_h)
    for name, a, b in zip("Cnm", got, want):
        assert _rel(a, b) <= 1e-4, (name, _rel(a, b))


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,H,dk,dv,chunk,dtype", [
    (1, 777, 4, 1024, 1024, 64, torch.float32),    # the served shape
    (1, 777, 4, 1024, 1024, 64, torch.bfloat16),
    (2, 200, 3, 64, 64, 64, torch.float32),        # ragged last chunk
    (1, 13, 2, 128, 96, 8, torch.bfloat16),
])
def test_mlstm_kernel_is_deterministic(B, S, H, dk, dv, chunk, dtype):
    """Two calls on the same inputs give bitwise equal h, C, n and m: the
    kernel sums every split and every warp's share in a fixed order, with
    no atomics."""
    _needs_card()
    q, k, v, i_raw, f_log, state = _mlstm_inputs(S + 2 * dk, B, S, H, dk,
                                                 dv, False)
    q, k, v = (t.to(dtype) for t in (q, k, v))
    h1, s1 = mlstm_ops.mlstm_chunkwise(q, k, v, i_raw, f_log, state,
                                       chunk=chunk)
    h2, s2 = mlstm_ops.mlstm_chunkwise(q, k, v, i_raw, f_log, state,
                                       chunk=chunk)
    torch.cuda.synchronize()
    assert torch.equal(h1, h2)
    for name, a, b in zip("Cnm", s1, s2):
        assert torch.equal(a, b), name


@pytest.mark.gpu
def test_mlstm_kernel_refuses_grad_and_bad_shapes():
    """No silent zero gradient: a CUDA call whose initial state requires a
    gradient raises before a launch (the backward kernel takes the
    initial state as a constant), and so does a cotangent of the final
    state; what the kernel does not take raises before a launch."""
    _needs_card()
    q, k, v, i_raw, f_log, state = _mlstm_inputs(0, 1, 16, 2, 64, 64, False)
    before = mlstm_ops.LAUNCHES
    with pytest.raises(NotImplementedError, match="initial state"):
        mlstm_ops.mlstm_chunkwise(q, k, v, i_raw, f_log,
                                  (state[0].requires_grad_(), *state[1:]))
    assert mlstm_ops.LAUNCHES == before
    h, (C, _, _) = mlstm_ops.mlstm_chunkwise(q.requires_grad_(), k, v, i_raw,
                                             f_log)
    with pytest.raises(NotImplementedError, match="final state"):
        (h.sum() + C.sum()).backward()
    q = q.detach()
    with torch.no_grad():
        mlstm_ops.mlstm_chunkwise(q, k, v, i_raw, f_log)
    assert mlstm_ops.LAUNCHES == before + 2
    q = q.detach()
    with pytest.raises(TypeError, match="float32"):
        mlstm_kernel.mlstm_chunk_cuda(q.bfloat16(), k, v, i_raw, f_log)
    with pytest.raises(ValueError, match="multiple of 64"):
        mlstm_kernel.mlstm_chunk_cuda(q[..., :32], k[..., :32], v, i_raw,
                                      f_log)
    with pytest.raises(ValueError, match="chunk"):
        mlstm_kernel.mlstm_chunk_cuda(q, k, v, i_raw, f_log, chunk=128)


def _mlstm_bwd_case(seed, B, S, H, dk, dv, dtype):
    q, k, v, i_raw, f_log, _ = _mlstm_inputs(seed, B, S, H, dk, dv, True)
    q, k, v = (x.to(dtype) for x in (q, k, v))
    dh = torch.from_numpy(np.random.default_rng(seed + 1).standard_normal(
        (B, S, H, dv), np.float32)).cuda()
    return q, k, v, i_raw, f_log, dh


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,H,dk,dv,chunk,dtype,with_state", [
    (2, 512, 4, 1024, 1024, 64, torch.float32, False),  # a client's call
    (2, 200, 3, 64, 64, 64, torch.float32, False),      # ragged last chunk
    (1, 13, 2, 128, 96, 8, torch.float32, False),  # short chunks, dv not 64k
    (2, 100, 2, 256, 512, 16, torch.float32, False),
    (2, 512, 4, 1024, 1024, 64, torch.bfloat16, False),
    (2, 200, 3, 64, 64, 64, torch.bfloat16, False),
    # a constant initial state; past one 512-token block (the state walk
    # between blocks), ragged; both, with short chunks
    *[(*shape, dtype, with_state)
      for shape, with_state in (((2, 512, 4, 1024, 1024, 64), True),
                                ((1, 1000, 2, 256, 256, 64), False),
                                ((2, 600, 2, 128, 64, 16), True))
      for dtype in (torch.float32, torch.bfloat16)],
])
def test_mlstm_backward_matches_plain(B, S, H, dk, dv, chunk, dtype,
                                      with_state):
    """K6's backward against the plain backward (the same function) and
    against autograd of the plain forward (a given initial state held
    constant), on the same values in float32 (bf16 q, k, v: their float32
    copies), every gradient within 1e-4 of its largest entry (float32
    sums in another order); bf16 dq, dk, dv are the float32 values
    rounded once, so within 1e-4 plus bf16's rounding (half an ulp: 2^-8
    of the entry at most) of the largest entry."""
    _needs_card()
    q, k, v, i_raw, f_log, dh = _mlstm_bwd_case(S + dk, B, S, H, dk, dv,
                                                dtype)
    state = None
    if with_state:
        rng = np.random.default_rng(S)
        state = tuple(torch.from_numpy(x.astype(np.float32)).cuda() for x in (
            0.1 * rng.standard_normal((B, H, dk, dv)),
            0.1 * np.abs(rng.standard_normal((B, H, dk))),
            rng.standard_normal((B, H))))
    got = mlstm_kernel.mlstm_chunk_bwd_cuda(q, k, v, i_raw, f_log, dh, state,
                                            chunk=chunk)
    torch.cuda.synchronize()
    xs = [x.float() for x in (q, k, v)] + [i_raw, f_log]
    want = mlstm_ref.mlstm_chunk_bwd_plain(*xs, dh, state, chunk=chunk)[:5]
    xs = [x.clone().requires_grad_() for x in xs]
    h, _ = mlstm_ref.mlstm_chunk_plain(*xs, state, chunk=chunk)
    auto = torch.autograd.grad((h * dh).sum(), xs)
    for name, g, w, a in zip(("dq", "dk", "dv", "di", "df"), got, want,
                             auto):
        rounded = name in ("dq", "dk", "dv")
        assert g.dtype == (dtype if rounded else torch.float32), name
        tol = 1e-4 + (2 ** -8 if rounded and dtype == torch.bfloat16
                      else 0.0)
        assert _rel(g.float(), w) <= tol, (name, "plain", _rel(g.float(), w))
        assert _rel(g.float(), a) <= tol, (name, "autograd")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mlstm_backward_is_deterministic(dtype):
    _needs_card()
    args = _mlstm_bwd_case(5, 2, 200, 4, 256, 256, dtype)
    a = mlstm_kernel.mlstm_chunk_bwd_cuda(*args, chunk=64)
    b = mlstm_kernel.mlstm_chunk_bwd_cuda(*args, chunk=64)
    torch.cuda.synchronize()
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.gpu
def test_mlstm_gradient_launches_the_backward_once():
    """A CUDA gradient through ``mlstm_chunkwise``: one forward and one
    backward launch, and the gradients the backward kernel gives."""
    _needs_card()
    q, k, v, i_raw, f_log, dh = _mlstm_bwd_case(9, 1, 130, 2, 128, 64,
                                                torch.float32)
    xs = [x.clone().requires_grad_() for x in (q, k, v, i_raw, f_log)]
    fwd, bwd = mlstm_ops.LAUNCHES, mlstm_ops.LAUNCHES_BWD
    h, _ = mlstm_ops.mlstm_chunkwise(*xs, chunk=64)
    got = torch.autograd.grad((h * dh).sum(), xs)
    torch.cuda.synchronize()
    assert (mlstm_ops.LAUNCHES, mlstm_ops.LAUNCHES_BWD) == (fwd + 1, bwd + 1)
    want = mlstm_kernel.mlstm_chunk_bwd_cuda(q, k, v, i_raw, f_log, dh,
                                             chunk=64)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.gpu
def test_xlstm_prefill_on_card_matches_cpu():
    """Reduced xlstm-1.3b in float32 on one period of its layer pattern
    (8 layers: 7 mLSTM, 1 sLSTM; deeper random stacks amplify float32
    rounding layer by layer, see PERF.md): the fused prefill on the card
    (K6 once per mLSTM layer) against the CPU (the plain version): logits
    and every cache leaf within 1e-4 of its largest entry."""
    _needs_card()
    from repro_torch.configs import get_config
    from repro_torch.models import transformer
    from repro_torch.tree import tree_map

    cfg = get_config("xlstm-1.3b").reduced(num_layers=8)
    params = transformer.init_params(torch.Generator().manual_seed(3), cfg)
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (1, 77)))
    before = mlstm_ops.LAUNCHES
    with torch.no_grad():
        lg, cache = transformer.forward_prefill_cached(
            tree_map(lambda a: a.cuda(), params), {"tokens": toks.cuda()},
            cfg, 96)
        torch.cuda.synchronize()
        n_mlstm = sum(s.mixer == "mlstm" for s in cfg.block_specs)
        assert mlstm_ops.LAUNCHES == before + n_mlstm
        want_lg, want = transformer.forward_prefill_cached(
            params, {"tokens": toks}, cfg, 96)
    errs = {"logits": _rel(lg.cpu(), want_lg)}
    for layer, leaves in want.items():
        for key, b in leaves.items():
            errs[f"{layer}/{key}"] = _rel(cache[layer][key].cpu(), b)
    assert max(errs.values()) <= 1e-4, errs


@pytest.mark.gpu
def test_moe_prefill_on_card_matches_loop():
    """Reduced-width qwen3-moe-30b-a3b in float32 on the card: the fused
    prefill (K3 once per attention layer, the MoE FFN dropless) against
    the token-by-token decode loop (no kernel, the MoE FFN at its
    configured capacity): the last position's logits and every cache
    leaf within 1e-4 of their largest entry."""
    _needs_card()
    from repro_torch.configs import get_config
    from repro_torch.models import transformer

    cfg = get_config("qwen3-moe-30b-a3b").reduced()
    gen = torch.Generator("cuda")
    gen.manual_seed(4)
    params = transformer.init_params(gen, cfg)
    P, max_len = 77, 96
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (1, P))).cuda()
    before = ops.LAUNCHES
    with torch.no_grad():
        lg, cache = transformer.forward_prefill_cached(
            params, {"tokens": toks}, cfg, max_len)
        torch.cuda.synchronize()
        assert ops.LAUNCHES == before + cfg.num_layers
        loop = transformer.init_decode_cache(cfg, 1, max_len, device="cuda")
        for i in range(P):
            want_lg, loop = transformer.decode_step(
                params, {"tokens": toks[:, i:i + 1]}, loop, i, cfg)
    errs = {"logits": _rel(lg, want_lg)}
    for layer, leaves in loop.items():
        for key, b in leaves.items():
            errs[f"{layer}/{key}"] = _rel(cache[layer][key], b)
    assert max(errs.values()) <= 1e-4, errs


@pytest.mark.gpu
def test_jamba_engine_on_card_matches_cpu():
    """Reduced jamba-1.5-large-398b in float32 (mamba, attention, MoE):
    the engine on the card (K3 once per attention layer and admit) and
    on the CPU (the plain attention) serve the same greedy tokens, each
    step's logits within 1e-4 of their largest entry."""
    _needs_card()
    from repro_torch.configs import get_config
    from repro_torch.models import transformer
    from repro_torch.serve import Request, ServeEngine

    cfg = get_config("jamba-1.5-large-398b").reduced()
    params = transformer.init_params(torch.Generator().manual_seed(5), cfg)
    rng = np.random.default_rng(5)
    reqs = [(i, rng.integers(0, cfg.vocab_size, P), n)
            for i, (P, n) in enumerate([(77, 6), (9, 4), (64, 5), (130, 3)])]
    out = {}
    for device in ("cuda", "cpu"):
        eng = ServeEngine(params, cfg, slots=2, max_len=160,
                          record_logits=True, device=device)
        before = ops.LAUNCHES
        out[device] = eng.serve([Request(i, t, n) for i, t, n in reqs],
                                wall_clock=False)
        if device == "cuda":
            n_attn = sum(s.mixer == "attn" for s in cfg.block_specs)
            assert ops.LAUNCHES == before + len(reqs) * n_attn
    for i, _, n in reqs:
        got, want = out["cuda"][i], out["cpu"][i]
        np.testing.assert_array_equal(got.tokens, want.tokens)
        for a, b in zip(got.logits, want.logits):
            err = np.abs(a - b).max() / np.abs(b).max()
            assert err <= 1e-4, (i, err)


def _baseline_spec(method, rounds=1, width=0.25, local_iters=5):
    """The paper-table AlexNet experiment (s2, 10 classes) at ``width``:
    20 clients, 4 a round, ``local_iters`` local steps of 48 images in
    all."""
    from repro_torch import api
    from repro_torch.configs import ScalaConfig

    return api.ExperimentSpec(
        arch="alexnet-cifar", width=width, method=method, rounds=rounds,
        seed=0, scala=ScalaConfig(num_clients=20, participation=0.2,
                                  local_iters=local_iters, server_batch=48,
                                  lr=0.05),
        execution=api.ExecutionSpec(mode="subset", backend="logits"),
        data=api.DataSpec(kind="image_synthetic", n_train=2000, alpha=2))


def _flat(state):
    from repro_torch.checkpoint.checkpoint import flatten_with_paths
    return flatten_with_paths(state)


def _baseline_round_gaps(method, local_iters, card_dtype):
    """One round of a baseline from the same state and batches on the
    card in ``card_dtype`` (cuDNN off) and on the CPU in float64: {leaf:
    its largest error over its update's largest entry}."""
    from repro_torch import api
    from repro_torch.tree import tree_map

    spec = _baseline_spec(method, local_iters=local_iters)
    host = api.Trainer(spec, device="cpu")
    batches, sizes = host._next_round_batches()
    out = []
    for dev, dtype in (("cuda", card_dtype), ("cpu", torch.float64)):
        program = api.build(spec, device=dev, params=tree_map(
            lambda a: a.to(dtype), host.state.inner))
        state = program.init()
        b = {k: v.to(dev, dtype if k == "x" else v.dtype)
             for k, v in batches.items()}
        prev = torch.backends.cudnn.enabled
        torch.backends.cudnn.enabled = False
        try:
            new, metrics = program.step(state, b, sizes.to(dev))
        finally:
            torch.backends.cudnn.enabled = prev
        assert metrics == {}
        out.append((_flat(state), _flat(new)))
    (_, got), (old, want) = out
    assert got.keys() == want.keys()
    return {key: (got[key].cpu().double() - b).abs().max().item()
            / max((b - old[key]).abs().max().item(), 1e-30)
            for key, b in want.items()}


@pytest.mark.gpu
@pytest.mark.parametrize("method", ["fedavg", "feddyn", "splitfed_v2",
                                    "sfl_localloss"])
def test_baseline_round_on_card_matches_cpu(method):
    """One round (5 local steps) of a baseline on the card and on the
    CPU, both in float64 (in float32 a ReLU or max-pool input within
    rounding of its switch point may flip from the second local step on;
    PERF.md §6): every leaf's update within 1e-3 of its largest entry."""
    _needs_card()
    gaps = _baseline_round_gaps(method, 5, torch.float64)
    assert max(gaps.values()) <= 1e-3, (method, gaps)


@pytest.mark.gpu
@pytest.mark.parametrize("method", ["fedavg", "feddyn", "splitfed_v2",
                                    "sfl_localloss"])
def test_baseline_one_step_float32_on_card_matches_cpu_float64(method):
    """One round of one local step of a baseline, the card in float32
    (cuDNN off) against the CPU in float64: every leaf's update within
    1e-3 of its largest entry. sfl_localloss's server half trains on the
    activations recomputed after the client's update, a second forward
    where a ReLU may flip, so its leaves are left out."""
    _needs_card()
    gaps = _baseline_round_gaps(method, 1, torch.float32)
    held = {k: g for k, g in gaps.items()
            if not (method == "sfl_localloss" and k.startswith(".inner/ws/"))}
    assert held and max(held.values()) <= 1e-3, (method, gaps)


@pytest.mark.gpu
@pytest.mark.parametrize("method", ["scala", "feddyn", "splitfed_v1",
                                    "sfl_localloss"])
def test_resume_on_card_is_bitwise(method, tmp_path):
    """Trainer.save -> a fresh Trainer -> resume, on the card: 2 rounds, a
    save and 1 more round equal 3 rounds uninterrupted in every leaf and
    in the history (cuDNN deterministic)."""
    _needs_card()
    from repro_torch import api

    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        spec = _baseline_spec(method, rounds=3)
        straight = api.Trainer(spec, device="cuda")
        straight.run(3)
        first = api.Trainer(spec, device="cuda")
        first.run(2)
        first.save(str(tmp_path))
        resumed = api.Trainer(spec, device="cuda")
        assert resumed.resume(str(tmp_path)) == 2
        resumed.run(1)
    finally:
        torch.backends.cudnn.deterministic = prev
    got, want = _flat(resumed.state), _flat(straight.state)
    assert got.keys() == want.keys()
    assert all(bool(torch.isfinite(a).all()) for a in want.values()
               if isinstance(a, torch.Tensor) and a.is_floating_point())
    for key, a in want.items():
        if isinstance(a, torch.Tensor):
            assert got[key].device == a.device and torch.equal(got[key], a), \
                key
        else:
            assert got[key] == a, key
    assert resumed.history == straight.history


def _chip_smoke():
    """``chip_smoke.py`` at the repo's root as a module: its federation
    checks, run here at a reduced size, in the smoke run at full width."""
    path = os.path.join(os.path.dirname(__file__), "..", "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.gpu
def test_masked_round_on_card_matches_cpu():
    """chip_smoke's fed-check (c), masked, on reduced qwen1.5-0.5b: one
    masked round (injected mask, bias_compensated, momentum, server adamw
    at eps 1e-3) on the card (K1, K2, K3, their launches checked) and on
    the CPU; losses within 1e-4 relative, every param (the server half
    also before its FedOpt step) within 3 ulps plus 1e-3 of its leaf's
    largest update, every other float leaf within 1e-3 of its largest
    entry, and on each device the server optimizer's state and server
    half bit for bit Adam's first step on that device's own delta."""
    _needs_card()
    _chip_smoke().fed_check_masked("cuda", reduced=True, S=32)


@pytest.mark.gpu
def test_sparse_round_on_card_matches_masked():
    """chip_smoke's fed-check (c), sparse, on reduced qwen1.5-0.5b: sparse
    == masked on the card (SGD, the same mask), losses within 1e-5
    relative, params within 1e-4 of the leaf's largest entry."""
    _needs_card()
    _chip_smoke().fed_check_sparse("cuda", reduced=True, S=32)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["masked", "sparse"])
def test_fed_resume_on_card_is_bitwise(mode, tmp_path):
    """Trainer.save -> resume on the card with federation state (the
    scheduler's, staleness ages, server adamw moments): 2 rounds, save, 1
    more == 3 rounds, every leaf and the history."""
    _needs_card()
    from repro_torch import api
    from repro_torch.configs import ScalaConfig

    spec = api.ExperimentSpec(
        arch="qwen1.5-0.5b", reduced=True, rounds=3, seed=1,
        scala=ScalaConfig(num_clients=8, local_iters=2, server_batch=8,
                          lr=0.05),
        optim=api.OptimSpec(name="momentum"),
        fed=api.FedSpec(participation="uniform:0.25",
                        aggregator="staleness_weighted"),
        execution=api.ExecutionSpec(mode=mode, backend="lace",
                                    server_optimizer=api.OptimSpec.parse(
                                        "fedadam:0.001")),
        data=api.DataSpec(kind="lm_synthetic", seq=64, docs_per_client=4))
    straight = api.Trainer(spec, device="cuda")
    straight.run(3)
    first = api.Trainer(spec, device="cuda")
    first.run(2)
    first.save(str(tmp_path))
    resumed = api.Trainer(spec, device="cuda")
    assert resumed.resume(str(tmp_path)) == 2
    resumed.run(1)
    got, want = _flat(resumed.state), _flat(straight.state)
    assert got.keys() == want.keys()
    for key, a in want.items():
        if isinstance(a, torch.Tensor):
            assert got[key].device == a.device and torch.equal(got[key], a), \
                key
        else:
            assert got[key] == a, key
    assert resumed.history == straight.history


@pytest.mark.gpu
def test_guarded_round_on_card_equals_survivor_round():
    """chip_smoke's fault-check (c)(2) on reduced qwen1.5-0.5b: a recorded
    NaN corruption of one participant on the card (K1, K2, K3) is
    rejected, the round re-runs over the survivors and equals, bit for
    bit in params and loss_server, the clean round whose recorded
    scheduler mask is the survivors."""
    _needs_card()
    cs = _chip_smoke()
    _, model, params, batches, sizes, masks = cs.fed_check_inputs(
        "cuda", True, 4, 32, 2)
    cs.fault_survivor_check("cuda", model, params, batches, sizes, masks)


@pytest.mark.gpu
@pytest.mark.parametrize("kernel_pair", ["K1/K2", "K4/K5 server",
                                         "K4/K5 client"])
def test_lace_kernels_bf16_head_match_plain(kernel_pair):
    """The bf16-head build (bf16 feats and a bf16 W, as the bf16 compute
    policy hands the boundary) against the plain version on the same
    bf16 values (which reads W's float32 copy): nll and lse within 1e-4
    of their largest entry, df and dW within 1e-5 (a bf16 operand is one
    exact TF32 term); two runs bitwise equal."""
    _needs_card()
    from repro_torch.kernels.lace import ref as lace_ref

    G, Nc, d, V = 4, 300, 96, 2500
    feats, w_head, labels, weights, p_s, p_k = _lace_inputs(
        11, G, Nc, d, V, torch.bfloat16)
    w16 = w_head.to(torch.bfloat16)
    N = G * Nc
    feats = feats.reshape(N, d)
    labels = labels.reshape(N).to(torch.int32).contiguous()
    ts = (weights.reshape(N) / weights.sum()).contiguous()
    adj_s = torch.log(p_s + 1e-8).contiguous()
    adj_k = torch.log(p_k + 1e-8).contiguous()
    ids = torch.arange(N, device="cuda", dtype=torch.int32) * G // N

    def close(got, want, rtol):
        for a, b in zip(got, want):
            if b is None:
                assert a is None
                continue
            err = (a - b).abs().max().item()
            assert err <= rtol * b.abs().max().item(), err

    if kernel_pair == "K1/K2":
        fwd = lambda: lace_kernel.lace2_fwd_cuda(                 # noqa
            feats, w16, labels, adj_s, None, adj_k, ids)
        got = fwd()
        close(got, lace_ref.lace2_fwd_plain(feats, w16, labels, adj_s, None,
                                            adj_k, ids), 1e-4)
        bargs = (feats, w16, labels, adj_s, None, adj_k, ids, got[2],
                 got[3], ts, ts)
        bwd = lambda: lace_kernel.lace2_bwd_cuda(*bargs)          # noqa
        gb = bwd()
        close(gb, lace_ref.lace2_bwd_plain(*bargs), 1e-5)
    else:
        side = kernel_pair.split()[-1]
        adj, rows = (adj_s, None) if side == "server" else (adj_k, ids)
        want_dw = side == "server"
        fwd = lambda: lace_kernel.lace_fwd_cuda(feats, w16, labels, adj,
                                                rows)            # noqa
        got = fwd()
        close(got, lace_ref.lace_fwd_plain(feats, w16, labels, adj, rows),
              1e-4)
        bargs = (feats, w16, labels, adj, rows, got[1], ts, want_dw)
        bwd = lambda: lace_kernel.lace_bwd_cuda(*bargs)           # noqa
        gb = bwd()
        close(gb, lace_ref.lace_bwd_plain(*bargs), 1e-5)
    torch.cuda.synchronize()
    for a, b in zip(got + gb, fwd() + bwd()):
        assert (a is None) == (b is None)
        assert a is None or torch.equal(a, b)


@pytest.mark.gpu
def test_chunked_qwen_rounds_on_card_equal_sequential():
    """Reduced qwen1.5-0.5b (K1, K2, K3 forward and backward) in bf16 on
    the card: 2 rounds in one call equal 2 calls of one round, bit for
    bit in every state leaf and in the history."""
    _needs_card()
    from repro_torch import api
    from repro_torch.launch import train

    flags = ["--arch", "qwen1.5-0.5b", "--reduced", "--clients", "4",
             "--participation", "0.5", "--local-iters", "2", "--seq", "32",
             "--server-batch", "4", "--docs-per-client", "3", "--rounds", "2",
             "--precision", "bf16"]
    runs = []
    for rpc in ("1", "2"):
        spec = train.spec_from_args(train.build_parser().parse_args(
            flags + ["--rounds-per-call", rpc]))
        t = api.Trainer(spec, device="cuda")
        t.run()
        runs.append(t)
    a, b = runs
    assert a.history == b.history and len(a.history) == 2
    fa, fb = _flat(a.state), _flat(b.state)
    assert fa.keys() == fb.keys()
    for key, x in fa.items():
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, fb[key]), key
        else:
            assert np.array_equal(np.asarray(x), np.asarray(fb[key])), key


@pytest.mark.gpu
def test_lace_kernels_at_moe_boundary():
    """K1 and K2 at qwen3-moe-30b-a3b's boundary (8192 tokens, d 2048, V
    151936, bf16 feats and head) through chip_smoke's kernel phase: the
    losses and lse within 1e-4, df and dW within 1e-5 of their largest
    entry against the plain version, df of 256 tokens within 1e-5 of
    float64, and two runs bitwise equal."""
    _needs_card()
    cs = _chip_smoke()
    rows, _ = cs.phase_lace([cs.LACE_MOE])
    assert {kind for _, kind in rows} == {"fwd", "bwd"}


@pytest.mark.gpu
def test_moe_train_step_on_card_matches_cpu():
    """qwen3-moe-30b-a3b at full width and 3 layers (one server MoE
    layer) in float32: chip_smoke's check-moe-train step and round, the
    card (K1, K2, K3) against the CPU (the plain versions): losses and
    aux within 1e-4 relative, every grad leaf (the routers too) within
    1e-3 of its largest entry, the round's client params and server
    routers within 1e-3 of the leaf's largest update beyond 3 ulps, and
    the step's launches against the layout."""
    _needs_card()
    cs = _chip_smoke()
    cs.phase_train_check("cuda", C=2, S=64, T=2, arch=cs.MOE,
                         layers=cs.MOE_TRAIN_CHECK_LAYERS,
                         phase="check-moe-train")


@pytest.mark.gpu
def test_moe_bf16_train_step_repeats_bitwise():
    """One split step of qwen3-moe-30b-a3b in bf16 at full width and 3
    layers, 2 clients x 4 x 512 tokens (the slabs' exact counts read
    back, pairs dropped), run twice: every gradient and metric bitwise
    equal."""
    _needs_card()
    _chip_smoke().moe_step_repeat("cuda")


@pytest.mark.gpu
def test_boundary_leg_qwen_cell_fused_matches_dual():
    """The boundary leg's qwen1.5-0.5b cell (d 1024, V 151936, 4 x 2048
    tokens): fused (K1 + K2) against dual (K4 + K5 twice). Each kernel is
    within its stated tolerance of the plain version (K1 / K4 1e-4, K2 /
    K5 1e-5 of the largest entry), so the two routes agree within twice
    that."""
    _needs_card()
    from repro_torch.benchmarks import boundary as bb

    dual, fused = bb.lace_pair(1024, 2048, 2048, classes=bb.QWEN_CLASSES,
                               device="cuda")
    before = (lace_ops.LAUNCHES_FWD, lace_ops.LAUNCHES_FWD1)
    got, want = fused(), dual()
    torch.cuda.synchronize()
    assert lace_ops.LAUNCHES_FWD == before[0] + 1
    assert lace_ops.LAUNCHES_FWD1 == before[1] + 2
    for a, b in zip(got[:2], want[:2]):
        assert abs(float(a) - float(b)) <= 2e-4 * abs(float(b))
    for a, b in zip(got[2:], want[2:]):
        err = (a.float() - b.float()).abs().max().item()
        assert err <= 2e-5 * b.float().abs().max().item(), err


@pytest.mark.gpu
def test_dryrun_argument_bytes_match_card_step():
    """The dry run of a reduced qwen1.5-0.5b local step on ``meta``
    against the same step's tensors on the card: the argument bytes
    equal exactly, the step runs (finite losses) through K1, K2 and K3,
    and the dry run's peak is printed beside ``max_memory_allocated``."""
    _needs_card()
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.launch.dryrun import build_step, count_step, realize
    from repro_torch.models import transformer as T
    from repro_torch.tree import leaves, tree_map

    cfg = get_config("qwen1.5-0.5b").reduced()
    C = 2
    step, args, _, cfg = build_step(
        "qwen1.5-0.5b", "s", cfg=cfg, shape=InputShape("s", 64, 4, "train"),
        num_clients=C)
    _, dry = count_step(step, args)
    gen = torch.Generator("cuda").manual_seed(0)
    params = T.init_params(gen, cfg)
    params["client"] = tree_map(
        lambda t: t.expand((C,) + tuple(t.shape)).clone(), params["client"])
    batch = realize(args[1], cfg.vocab_size, "cuda")
    assert sum(t.nbytes for t in leaves((params, batch))) == \
        dry["memory"]["argument_bytes"]
    torch.cuda.reset_peak_memory_stats()
    before = (lace_ops.LAUNCHES_FWD, ops.LAUNCHES, ops.LAUNCHES_BWD)
    _, metrics = step(params, batch)
    torch.cuda.synchronize()
    assert np.isfinite(float(metrics["loss_server"]))
    assert lace_ops.LAUNCHES_FWD == before[0] + 1
    assert ops.LAUNCHES > before[1] and ops.LAUNCHES_BWD > before[2]
    print(f"dry-run peak {dry['memory']['peak_bytes']}, card "
          f"{torch.cuda.max_memory_allocated()}")
