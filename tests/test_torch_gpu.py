"""The port's CUDA kernels against their plain versions, on a card.

Marked ``gpu``: without a CUDA device every test skips (the kernels have
no CPU mode). Imports only torch and the port, so it runs on a machine
without JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attn import kernel, ops, ref
from repro_torch.kernels.lace import kernel as lace_kernel
from repro_torch.kernels.lace import ops as lace_ops


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
])
def test_lace_kernels_match_plain(G, N, d, V, feats_dtype, tau, vchunk,
                                  monkeypatch):
    """K1 + K2 against the plain chunked version on the same inputs: the
    losses at rel 1e-4, df and dW at 1e-5 of their largest entry (f32 on
    the CUDA cores, sums in another order); weight-0 rows get exactly
    zero gradient. ``vchunk`` shrinks K2's workspace to that many vocab
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
